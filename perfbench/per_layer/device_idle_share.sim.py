"""device_idle_share.sim: 1 - the union of the device's kernel, copy and
set intervals over the wall time of the traced slice, both from the same
slice (%)."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0.0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
