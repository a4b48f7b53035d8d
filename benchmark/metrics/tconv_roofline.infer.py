"""``tconv_roofline.infer``, layer ``models, time convs`` (K2: ``models/layers.py``,
``kernels/tconv.py``).

The least time for the time convolutions' forward work in the traced
batches (the C2 and TDS convs), over the device time of the kernels that
did it (names holding ``tconv``; a library's convolution: ``fprop``,
``convolve``, ``conv2d``, ``cudnn``). Work of a conv (B, T in, T out, F, C,
CO, K) in the compute dtype: 2 B Tout F C CO K flops; reads the input and the
weights, writes the output. Bounded by bytes at these channel counts (HBM
3.35 TB/s). In %."""

from benchmark.core import peaks

FAMILY = ("tconv", "fprop", "convolve", "conv2d", "cudnn")


def work(c, itemsize):
    flops = 2.0 * c["B"] * c["Tout"] * c["F"] * c["C"] * c["CO"] * c["K"]
    nbytes = (c["B"] * c["F"] * (c["Tin"] * c["C"] + c["Tout"] * c["CO"]) * itemsize
              + c["K"] * c["C"] * c["CO"] * itemsize + c["CO"] * 4)
    return flops, nbytes


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.family_s(FAMILY)
    if t <= 0:
        return None
    least = sum(peaks.least_s(*work(c, ctx.itemsize)) for s in ctx.traced
                for c in ctx.calls(s)["tconv"])
    return 100.0 * least / t
