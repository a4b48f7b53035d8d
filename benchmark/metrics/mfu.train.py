"""``mfu.train``, layer ``runtime step`` (``runtime/train.py::Trainer.train_step``).

The model's FLOPs of the updates the untraced window completed, counted from
the arch and each batch's padded shape (``core/shapes.py::model_flops``: the
convolutions', the linears' and attention's products, forward and backward),
over the window's wall time and the bf16 peak (989 TFLOP/s). In %."""

from benchmark.core import peaks, shapes


def read(ctx):
    if not ctx.window or ctx.window_s <= 0:
        return None
    flops = sum(shapes.model_flops(ctx.calls(s), train=True) for s in ctx.window)
    return 100.0 * flops / ctx.window_s / peaks.BF16_FLOPS
