"""The whole training step's (forward and backward) share of the card's peak, %: the reference's FLOPs for
the frames of the window's untraced rest (counted once at set-up on the
reference, whatever implements a layer), at the peak of the dtype the
configuration states, over that rest's wall time. The traced stretch is
left out: the profiler slows the host's issue."""


def read(view):
    if view.untraced_least_s <= 0 or view.untraced_s <= 0:
        return None
    return 100.0 * view.untraced_least_s / view.untraced_s
