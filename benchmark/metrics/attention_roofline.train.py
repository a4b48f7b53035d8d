"""``attention_roofline.train``, layer ``models, attention`` (K4, K4b:
``models/transformer.py``, ``kernels/attention.py``).

The least time the chip needs for self-attention's work in the traced
updates, over the device time of the kernels that did it (names holding
``mhsa``; a library's attention: ``fmha``, ``flash``, ``sdpa``). Work of a
layer (B, T, H, Dh), Pwin the 2T - 1 rows of the relative-position table:
  forward  2 B H Dh (T^2 + T (2T - 1) + T^2) flops (q.k, q.Pwin, p.v); reads
           q, k, v (bf16), Pwin, the key mask (fp32); writes the output;
  backward 2 B H Dh (4 T^2 + 2 T (2T - 1)) flops (dv, dp, dq and dk from
           dp, and q's and Pwin's parts of the positions); reads q, k, v,
           dO, Pwin, the mask; writes dq, dk, dv and dPwin (fp32).
The probabilities are not counted twice: the least time keeps them on chip.
Bounded by operations at these shapes (bf16 peak 989 TFLOP/s). In %."""

from benchmark.core import peaks

FAMILY = ("mhsa", "fmha", "flash", "sdpa")


def work(c, itemsize):
    B, T, H, Dh = c["B"], c["T"], c["H"], c["Dh"]
    d, win = H * Dh, (2 * T - 1) * Dh
    fwd = (2.0 * B * H * Dh * (2 * T * T + T * (2 * T - 1)),
           4 * B * T * d * itemsize + win * itemsize + B * T * 4)
    bwd = (2.0 * B * H * Dh * (4 * T * T + 2 * T * (2 * T - 1)),
           7 * B * T * d * itemsize + win * (itemsize + 4) + B * T * 4)
    return [fwd, bwd]


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.family_s(FAMILY)
    if t <= 0:
        return None
    least = sum(peaks.least_s(f, b) for s in ctx.traced
                for c in ctx.calls(s)["attention"] for f, b in work(c, ctx.itemsize))
    return 100.0 * least / t
