"""``ctc_roofline.train``, layer ``criterions`` (K5, K5b: ``criterions/ctc.py``,
``kernels/ctc.py``).

The least time for the CTC loss and its gradient in the traced updates, over
the device time of the kernels that did it (names holding ``ctc``, the
library's ``ctc_loss`` kernels among them). Work of a batch of emissions
(B, T', N) in the compute dtype, of which each row's frames below its length
are valid, and targets (B, U) int32, as ``chip_smoke.py::_ctc_bytes`` counts
it less the method's own tables (log-sum-exps, alphas), which are neither
input nor output: the loss reads the valid frames and the integers once and
writes B losses; the gradient reads them again and writes (B, T', N) whole.
Bounded by bytes (HBM 3.35 TB/s). In %."""

import math

from benchmark.core import peaks

FAMILY = ("ctc",)


def valid_frames(shape, T_out: int) -> int:
    """The emission frames below each row's length: ceil(flen / T * T')."""
    flen = [max(0, 1 + (int(s) - 400) // 160) for s in shape.samples]
    return sum(min(T_out, math.ceil(f / shape.frames * T_out)) for f in flen)


def work(c, shape, itemsize):
    B, T, N = c["B"], c["T"], c["N"]
    x = valid_frames(shape, T) * N * itemsize
    ints = (B * shape.max_tokens + 2 * B) * 4 + 8 * B
    return [(5.0 * x / itemsize, x + ints), (5.0 * x / itemsize, x + ints + B * T * N * itemsize)]


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.family_s(FAMILY)
    if t <= 0:
        return None
    least = sum(peaks.least_s(f, b) for s in ctx.traced
                for c in ctx.calls(s)["ctc"] for f, b in work(c, s, ctx.itemsize))
    return 100.0 * least / t
