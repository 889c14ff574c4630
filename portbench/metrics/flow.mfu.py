"""The whole flow batch's share of the card's fp32 peak, %: the reference's
FLOPs for the pairs of the window's untraced rest (counted once at set-up on
the reference, on meta tensors), at the peak of the dtype the configuration
states, over that rest's wall time. The traced stretch is left out: the
profiler slows the host's issue."""


def read(view):
    if view.untraced_least_s <= 0 or view.untraced_s <= 0:
        return None
    return 100.0 * view.untraced_least_s / view.untraced_s
