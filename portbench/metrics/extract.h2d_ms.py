"""Device time of the host-to-device copies per batch, ms: the wire
batches' trip from pageable host memory."""


def read(view):
    n = view.counts.get("batches", 0)
    ops = [o for o in view.timeline.ops if o[0].startswith("Memcpy HtoD")]
    if not n or not ops:
        return None
    return view.timeline.device_s(ops) * 1e3 / n
