"""The device's idle share of the traced stretch, %: one minus the union
of the device operations' intervals over the stretch's wall time."""


def read(view):
    if not view.timeline.ops or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.timeline.busy_s() / view.window_s)
