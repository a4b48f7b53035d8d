"""``device_idle.train``, layer ``device``.

1 minus the union of the device operations' intervals inside the traced
window, over the window's wall (the profiler's own timeline). In %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
