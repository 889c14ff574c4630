"""The MiT kernels' share of their roofline, %: the least time of every
call at the card's peaks (``block_work`` / ``stage_work`` at the call's
shapes) over the device time of the operations launched inside the
benchmark's spans around the kernel entries."""

KERNEL_SPANS = ("mit_block", "mit_stage", "mit_packed2")


def read(view):
    ops = view.timeline.ops_under(KERNEL_SPANS)
    t = view.timeline.device_s(ops)
    least = sum(view.bounds.get(s, 0.0) for s in KERNEL_SPANS)
    if not ops or t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
