"""The selective scan's share of its roofline, %: ``scan_work`` of every
call at its shapes, at the card's peaks, over the device time of the
operations launched inside the benchmark's span around the scan entry."""


def read(view):
    ops = view.timeline.ops_under(("scan",))
    t = view.timeline.device_s(ops)
    least = view.bounds.get("scan", 0.0)
    if not ops or t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
