"""K2: time-only convolution in the (B, T, F*C) f-major chain layout —
wrapper and plain version. The kernel is ``csrc/tconv.cu``; it replaces the
TPU kernel ``wav2letter_tpu/ops/pallas/tconv.py::time_conv`` (forward)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

# Shared memory the wrapper lets one block use for its window of input
# frames, on top of the weights (which take at most 37.6 KB at the flagship's
# widths). Sets the block's frequency extent Fb.
_WINDOW_BYTES = 48 * 1024
_MAX_FB = 16


def out_frames(T: int, K: int, stride: int, pads: Tuple[int, int]) -> int:
    return (pads[0] + T + pads[1] - K) // stride + 1


def time_conv_plain(x: torch.Tensor, w: torch.Tensor, F: int, stride: int = 1,
                    pads: Tuple[int, int] = (0, 0),
                    bias: Optional[torch.Tensor] = None,
                    relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`time_conv`: the sum over taps of
    ``tconv.py::time_conv_reference``, accumulated in fp32."""
    _build.disable_tf32()
    B, T, D = x.shape
    K, C, CO = w.shape
    xp = torch.nn.functional.pad(x, (0, 0, pads[0], pads[1])).reshape(B, -1, F, C)
    Tout = (xp.shape[1] - K) // stride + 1
    wf = w.float()
    out = torch.zeros((B, Tout, F, CO), dtype=torch.float32, device=x.device)
    span = (Tout - 1) * stride + 1
    for k in range(K):
        out += torch.einsum("btfc,cd->btfd", xp[:, k:k + span:stride].float(), wf[k])
    if bias is not None:
        out += bias.float()
    if relu:
        out = torch.relu(out)
    return out.reshape(B, Tout, F * CO).to(x.dtype)


def time_conv(x: torch.Tensor, w: torch.Tensor, F: int, stride: int = 1,
              pads: Tuple[int, int] = (0, 0),
              bias: Optional[torch.Tensor] = None,
              relu: bool = False) -> torch.Tensor:
    """Time convolution with in-kernel zero padding and optional bias + ReLU.

    x (B, T, F*C) f-major (element f*C + c of a frame is channel c at
    frequency f); w (K, C, CO) of x's dtype, shared over f; bias (CO,) float32
    or None. Returns (B, Tout, F*CO) of x's dtype with
    ``y[b, t, f, co] = sum_{k,c} xpad[b, t*stride + k, f, c] * w[k, c, co]``,
    xpad = x with pads[0] zero frames before and pads[1] after.
    """
    if x.device.type == "cpu":
        return time_conv_plain(x, w, F, stride, pads, bias, relu)
    tensors = (x, w) if bias is None else (x, w, bias)
    _build.require_cuda("time_conv", *tensors)
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"time_conv: x {x.dtype} and w {w.dtype} must be one of "
                        "float32, bfloat16")
    if bias is not None and (bias.dtype != torch.float32 or bias.dim() != 1):
        raise TypeError("time_conv: bias must be a float32 vector")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("time_conv: x must be (B, T, F*C) and w (K, C, CO)")
    B, T, D = x.shape
    K, C, CO = w.shape
    lp, rp = pads
    if D != F * C or lp < 0 or rp < 0 or stride < 1:
        raise ValueError(f"time_conv: bad shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, F={F}, stride={stride}, pads={pads}")
    if bias is not None and bias.shape[0] != CO:
        raise ValueError(f"time_conv: bias has {bias.shape[0]} entries, CO={CO}")
    Tout = out_frames(T, K, stride, pads)
    if Tout < 1:
        raise ValueError(f"time_conv: no output frames for T={T}, K={K}, pads={pads}")
    lib = _build.library()
    rows = (lib.w2l_time_conv_tile() - 1) * stride + K
    fb = max(1, min(F, _MAX_FB, _WINDOW_BYTES // (rows * (C | 1) * 4)))
    y = torch.empty((B, Tout, F * CO), dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    rc = lib.w2l_time_conv(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), _build.DTYPE_CODES[x.dtype], B, T, F, C, CO, K, stride, lp,
        Tout, fb, int(relu), _build.stream_ptr(x))
    _build.check(rc, "time_conv")
    _build.LAUNCHES["time_conv"] += 1
    return y
