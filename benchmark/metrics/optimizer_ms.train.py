"""``optimizer_ms.train``, layer ``optim`` (``optim/optimizers.py``, with the
clip and the guard of ``Trainer._apply_update``).

Device milliseconds an update of the kernels launched inside the program's
``w2l/optimizer`` range, over the traced updates."""


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s = ctx.trace.under_s("w2l/optimizer")
    return None if s is None else 1e3 * s / len(ctx.traced)
