"""``frontend_roofline.infer``, layer ``features, K1`` (``features/frontend.py``,
``kernels/mfsc.py``).

The least time for the MFSC work of the traced batches, over the device
time of the kernels that did it (names holding ``mfsc``). Work of a batch
(B, S samples, T frames, M mels), 400-sample frames, a 512-point DFT's 257
bins: 2 * 2 * 400 * 257 flops a frame for the two DFT products, 2 * 257 * M
for the mel product; reads the pre-emphasized audio (fp32), writes (B, T, M)
fp32. The products are float32; their peak here is the TF32 tensor cores'
published 495 TFLOP/s (K1 runs them as three TF32 products). Bounded by
operations at these shapes. In %."""

from benchmark.core import peaks

FAMILY = ("mfsc",)


def work(c):
    frames = c["B"] * c["T"]
    flops = frames * (4.0 * 400 * 257 + 2.0 * 257 * c["mels"])
    return flops, c["B"] * c["S"] * 4 + frames * c["mels"] * 4


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.family_s(FAMILY)
    if t <= 0:
        return None
    least = sum(peaks.least_s(*work(c), peak=peaks.TF32_FLOPS) for s in ctx.traced
                for c in ctx.calls(s)["frontend"])
    return 100.0 * least / t
