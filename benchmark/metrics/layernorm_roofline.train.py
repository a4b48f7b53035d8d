"""``layernorm_roofline.train``, layer ``models, post-LN`` (K3, K3b:
``kernels/layernorm.py``).

The least time for the residual LayerNorms' work in the traced updates
(TDS blocks' and post-LN TR layers'), over the device time of the kernels
that did it (names holding ``residual_ln``; a library's: ``layer_norm``).
Work of a site of (rows, D) in the compute dtype: forward reads x and y and
writes LN(x + y); backward reads the output's gradient, x and y and writes
the sum's gradient once (x and y share it); gains and biases are scalars.
Bounded by bytes (HBM 3.35 TB/s). In %."""

from benchmark.core import peaks

FAMILY = ("residual_ln", "layer_norm", "layernorm")


def work(c, itemsize):
    n = c["rows"] * c["D"]
    return [(8.0 * n, 3 * n * itemsize), (12.0 * n, 4 * n * itemsize)]


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.family_s(FAMILY)
    if t <= 0:
        return None
    least = sum(peaks.least_s(f, b) for s in ctx.traced
                for c in ctx.calls(s)["ln"] for f, b in work(c, ctx.itemsize))
    return 100.0 * least / t
