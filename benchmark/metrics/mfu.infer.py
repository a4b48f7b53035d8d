"""``mfu.infer``, layer ``runtime step`` (``runtime/test.py::Evaluator``).

The model's forward FLOPs of the batches the untraced window served, counted
from the arch and each batch's padded shape (``core/shapes.py::model_flops``),
over the window's wall time and the bf16 peak (989 TFLOP/s). In %."""

from benchmark.core import peaks, shapes


def read(ctx):
    if not ctx.window or ctx.window_s <= 0:
        return None
    flops = sum(shapes.model_flops(ctx.calls(s), train=False) for s in ctx.window)
    return 100.0 * flops / ctx.window_s / peaks.BF16_FLOPS
