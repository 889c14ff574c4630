"""Device operations (kernels, copies, memsets) per optimizer step, from the
profiler's trace of the stretch."""


def read(view):
    n = view.counts.get("steps", 0)
    if not n or not view.timeline.ops:
        return None
    return len(view.timeline.ops) / n
