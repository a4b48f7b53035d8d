"""K2 and K2b: time-only convolution in the (B, T, F*C) f-major chain layout
and its gradients — wrappers, the autograd function and plain versions.

The forward kernel is ``csrc/tconv.cu``; it replaces the TPU kernel
``wav2letter_tpu/ops/pallas/tconv.py::time_conv`` (``_fwd``). The gradient
with respect to x (dgrad) is the same kernel on the tap-flipped, transposed
weight, as ``tconv.py::_time_conv_bwd_rule`` does it; the gradient with
respect to w is K2b, ``csrc/tconv_wgrad.cu``, which replaces ``_wgrad``.

On a CPU tensor every wrapper takes its plain version, which is
differentiable PyTorch code. On a CUDA tensor ``time_conv`` launches K2 and,
where a gradient is wanted, records :class:`_TimeConvFn`, whose backward
launches K2 (dgrad) and K2b."""

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


def time_conv_dgrad_plain(dy: torch.Tensor, w: torch.Tensor, F: int, T: int,
                          stride: int = 1, pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch version of :func:`time_conv_dgrad`, by the recipe of
    ``tconv.py::_time_conv_bwd_rule``: dy zero-stuffed to stride 1, correlated
    with the flipped weight (K, CO, C) under pads (K-1-lp, enough to reach T
    frames), then cut to T."""
    K, C, CO = w.shape
    lp = pads[0]
    B, Tout, _ = dy.shape
    dyd = dy
    if stride > 1:
        dyd = dy.new_zeros((B, (Tout - 1) * stride + 1, dy.shape[2]))
        dyd[:, ::stride] = dy
    front = K - 1 - lp
    if front < 0:  # more left pad than taps: the first -front frames of dyd touch no x
        dyd, front = dyd[:, -front:], 0
    back = max(T + K - 1 - front - dyd.shape[1], 0)
    wt = w.flip(0).transpose(1, 2).contiguous()
    return time_conv_plain(dyd, wt, F, 1, (front, back))[:, :T]


def time_conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, K: int, F: int,
                          stride: int = 1, pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain PyTorch version of :func:`time_conv_wgrad`: (K, C, CO) float32,
    one einsum per tap, accumulated in fp32."""
    _build.disable_tf32()
    B, T, D = x.shape
    C = D // F
    Tout = dy.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, pads[0], pads[1])).reshape(B, -1, F, C).float()
    g = dy.reshape(B, Tout, F, -1).float()
    span = (Tout - 1) * stride + 1
    return torch.stack([torch.einsum("btfc,btfd->cd", xp[:, k:k + span:stride], g)
                        for k in range(K)])


def _check(name: str, x: torch.Tensor, w_shape, F: int, stride: int) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: {x.dtype} is not one of float32, bfloat16")
    K, C, CO = w_shape
    if x.dim() != 3 or x.shape[2] != F * C or stride < 1 or min(K, C, CO) < 1:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, w {tuple(w_shape)}, "
                         f"F={F}, stride={stride}")


def _launch_conv(x, w, bias, F, stride, lp, Tout, relu, dil) -> torch.Tensor:
    """K2 on checked CUDA tensors: output frame t reads the frames
    t*stride - lp + k of x dilated by ``dil``; frames outside are zero."""
    B, T, _ = x.shape
    K, C, CO = w.shape
    lib = _build.library()
    rows = (lib.w2l_time_conv_tile() - 1) * stride + K
    fb = max(1, min(F, _MAX_FB, _WINDOW_BYTES // (rows * (C | 1) * 4)))
    y = torch.empty((B, Tout, F * CO), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = lib.w2l_time_conv(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), _build.DTYPE_CODES[x.dtype], B, T, F, C, CO, K, stride, lp,
        Tout, fb, int(relu), dil, _build.stream_ptr(x))
    _build.check(rc, "time_conv")
    _build.LAUNCHES["time_conv"] += 1
    return y


def time_conv_dgrad(dy: torch.Tensor, w: torch.Tensor, F: int, T: int, stride: int = 1,
                    pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Gradient of :func:`time_conv` (without bias and ReLU) with respect to
    x: ``dx[b, u, f, c] = sum_{k,co} dy[b, (u + lp - k) / stride, f, co] *
    w[k, c, co]`` over the taps where the division is exact.

    dy (B, Tout, F*CO) and w (K, C, CO) of one dtype; returns (B, T, F*C).
    It is K2 itself with stride 1 on the flipped weight (K, CO, C), left pad
    K-1-lp and dy dilated by ``stride`` inside the kernel, and counts as a
    ``time_conv`` launch."""
    if dy.device.type == "cpu":
        return time_conv_dgrad_plain(dy, w, F, T, stride, pads)
    _build.require_cuda("time_conv_dgrad", dy, w)
    K, C, CO = w.shape
    _check("time_conv_dgrad", dy, (K, CO, C), F, stride)
    if w.dtype != dy.dtype:
        raise TypeError(f"time_conv_dgrad: dy {dy.dtype} and w {w.dtype} differ")
    wt = w.flip(0).transpose(1, 2).contiguous()
    return _launch_conv(dy, wt, None, F, 1, K - 1 - pads[0], T, False, stride)


def time_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, K: int, F: int, stride: int = 1,
                    pads: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Gradient of :func:`time_conv` with respect to w, in float32:
    ``dw[k, c, co] = sum_{b,t,f} xpad[b, t*stride + k, f, c] * dy[b, t, f, co]``.

    x (B, T, F*C) and dy (B, Tout, F*CO) of one dtype. The sum is taken in two
    ordered passes without atomics, so equal inputs give equal bits."""
    if x.device.type == "cpu":
        return time_conv_wgrad_plain(x, dy, K, F, stride, pads)
    _build.require_cuda("time_conv_wgrad", x, dy)
    if dy.dtype != x.dtype or dy.dim() != 3 or dy.shape[0] != x.shape[0] \
            or x.shape[2] % F or dy.shape[2] % F:
        raise ValueError(f"time_conv_wgrad: x {tuple(x.shape)} {x.dtype} and dy "
                         f"{tuple(dy.shape)} {dy.dtype} do not fit F={F}")
    B, T, D = x.shape
    C, CO, Tout = D // F, dy.shape[2] // F, dy.shape[1]
    _check("time_conv_wgrad", x, (K, C, CO), F, stride)
    if Tout != out_frames(T, K, stride, pads):
        raise ValueError(f"time_conv_wgrad: dy has {Tout} frames, the conv gives "
                         f"{out_frames(T, K, stride, pads)}")
    dw = torch.empty((K, C, CO), dtype=torch.float32, device=x.device)
    if B == 0:
        return dw.zero_()
    lib = _build.library()
    fb = max(1, min(F, _MAX_FB,
                    _WINDOW_BYTES // (4 * lib.w2l_time_conv_wgrad_window(C, CO, K, stride))))
    tt = lib.w2l_time_conv_wgrad_tile()
    tiles = B * -(-Tout // tt) * -(-F // fb)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb = min(tiles, 2 * sms)
    partial = torch.empty((nb, K * C * CO), dtype=torch.float32, device=x.device)
    rc = lib.w2l_time_conv_wgrad(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        _build.DTYPE_CODES[x.dtype], B, T, F, C, CO, K, stride, pads[0], Tout, fb, nb,
        _build.stream_ptr(x))
    _build.check(rc, "time_conv_wgrad")
    _build.LAUNCHES["time_conv_wgrad"] += 1
    return dw


class _TimeConvFn(torch.autograd.Function):
    """K2 forward; backward = ReLU mask, K2 as dgrad (skipped where x needs
    no gradient), K2b, and the bias gradient as a float32 sum."""

    @staticmethod
    def forward(ctx, x, w, bias, F, stride, pads, relu):
        Tout = out_frames(x.shape[1], w.shape[0], stride, pads)
        y = _launch_conv(x, w, bias, F, stride, pads[0], Tout, relu, 1)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.conv = (F, stride, pads, bias is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        F, stride, pads, has_bias = ctx.conv
        dy = dy.contiguous()  # arrives as a permuted view from the stored layout
        if y is not None:
            dy = dy * (y > 0)
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = time_conv_dgrad(dy, w, F, x.shape[1], stride, pads)
        if ctx.needs_input_grad[1]:
            dw = time_conv_wgrad(x, dy, w.shape[0], F, stride, pads).to(w.dtype)
        if has_bias and ctx.needs_input_grad[2]:
            dbias = dy.reshape(-1, w.shape[2]).sum(0, dtype=torch.float32)
        return dx, dw, dbias, None, None, None, None


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _TimeConvFn.apply(x, w, bias, F, stride, pads, relu)
    return _launch_conv(x, w, bias, F, stride, lp, Tout, relu, 1)
