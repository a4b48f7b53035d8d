"""``attention_roofline.infer``, layer ``models, attention`` (K4:
``models/transformer.py``, ``kernels/attention.py``).

The least time for self-attention's forward work in the traced batches, over
the device time of the kernels that did it (names holding ``mhsa``; a
library's attention: ``fmha``, ``flash``, ``sdpa``). Work of a layer (B, T,
H, Dh), Pwin the 2T - 1 rows of the relative-position table: 2 B H Dh (T^2 +
T (2T - 1) + T^2) flops (q.k, q.Pwin, p.v); reads q, k, v (bf16), Pwin, the
key mask (fp32); writes the output. Bounded by operations at these shapes
(bf16 peak 989 TFLOP/s). In %."""

from benchmark.core import peaks

FAMILY = ("mhsa", "fmha", "flash", "sdpa")


def work(c, itemsize):
    B, T, H, Dh = c["B"], c["T"], c["H"], c["Dh"]
    d, win = H * Dh, (2 * T - 1) * Dh
    return (2.0 * B * H * Dh * (2 * T * T + T * (2 * T - 1)),
            4 * B * T * d * itemsize + win * itemsize + B * T * 4)


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.family_s(FAMILY)
    if t <= 0:
        return None
    least = sum(peaks.least_s(*work(c, ctx.itemsize)) for s in ctx.traced
                for c in ctx.calls(s)["attention"])
    return 100.0 * least / t
