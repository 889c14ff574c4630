"""Device operations (kernels, copies, memsets) per video, from the
profiler's trace of the stretch."""


def read(view):
    n = view.counts.get("videos", 0)
    if not n or not view.timeline.ops:
        return None
    return len(view.timeline.ops) / n
