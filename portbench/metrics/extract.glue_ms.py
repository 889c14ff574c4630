"""Device time per batch of everything but the MiT kernels and the
host copies, ms: the graph's plain PyTorch glue (patch embeds, prompt
cascade, the per-block prompt adds, LN1 and the key/value path, the flow
encoder, the cross-attentions, the head). The MiT kernels are the device
operations launched inside the benchmark's spans around the kernel
entries."""

KERNEL_SPANS = ("mit_block", "mit_stage", "mit_packed2")


def read(view):
    n = view.counts.get("batches", 0)
    tl = view.timeline
    ops = [o for o in tl.ops if not o[0].startswith(("Memcpy HtoD", "Memcpy DtoH"))
           and not any(tl.in_span(s, o[3]) for s in KERNEL_SPANS)]
    if not n or not ops:
        return None
    return tl.device_s(ops) * 1e3 / n
