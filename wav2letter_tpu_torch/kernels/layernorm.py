"""K3 and K3b: residual add + per-row LayerNorm with a scalar affine, and its
backward — wrappers, the autograd function and plain versions. The kernels
are in ``csrc/layernorm.cu``; they replace the TPU kernels
``wav2letter_tpu/ops/pallas/layernorm.py::fused_residual_ln`` (``_fwd``) and
``_bwd``.

On a CPU tensor ``residual_ln`` takes its plain version, which is
differentiable PyTorch code. On a CUDA tensor it launches K3 and, where a
gradient is wanted, records :class:`_ResidualLNFn`, whose backward launches
K3b. The forward saves x and y, not z = x + y: K3b forms z in fp32 again,
which moves as many bytes in all as writing z would and leaves the forward
as serving runs it."""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

EPS = 1e-5


def residual_ln_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`residual_ln`, fp32 statistics."""
    _build.disable_tf32()
    z = x.float() + y.float()
    mu = z.mean(dim=-1, keepdim=True)
    d = z - mu
    rsig = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + EPS)
    out = d * rsig * w.float() + b.float()
    return out.to(x.dtype), mu.squeeze(-1), rsig.squeeze(-1)


def residual_ln_bwd_plain(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                          mu: torch.Tensor, rsig: torch.Tensor, w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`residual_ln_bwd`, in fp32."""
    g32 = g.float()
    zhat = (x.float() + y.float() - mu[:, None]) * rsig[:, None]
    ghat = g32 * w.float()
    m1 = ghat.mean(dim=-1, keepdim=True)
    m2 = (ghat * zhat).mean(dim=-1, keepdim=True)
    dz = rsig[:, None] * (ghat - m1 - zhat * m2)
    return dz.to(g.dtype), g32.sum(dim=-1), (g32 * zhat).sum(dim=-1)


def residual_ln_bwd(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mu: torch.Tensor,
                    rsig: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`residual_ln` for the output gradient g (R, D).

    With ``zhat = (x + y - mu) * rsig`` and ``ghat = g * w`` it returns
    ``dz = rsig * (ghat - mean(ghat) - zhat * mean(ghat * zhat))`` of g's
    dtype, the gradient of both x and y, and the fp32 row sums ``sum(g)`` and
    ``sum(g * zhat)`` (R,), whose totals are the gradients of b and w."""
    if g.device.type == "cpu":
        return residual_ln_bwd_plain(g, x, y, mu, rsig, w)
    _build.require_cuda("residual_ln_bwd", g, x, y, mu, rsig, w)
    if g.dtype not in _build.DTYPE_CODES or x.dtype != g.dtype or y.dtype != g.dtype:
        raise TypeError(f"residual_ln_bwd: g {g.dtype}, x {x.dtype}, y {y.dtype} must be "
                        "one of float32, bfloat16, alike")
    if g.dim() != 2 or x.shape != g.shape or y.shape != g.shape or w.numel() != 1:
        raise ValueError(f"residual_ln_bwd: g, x, y must be (R, D) alike and w a scalar; "
                         f"got {tuple(g.shape)}, {tuple(x.shape)}, {tuple(y.shape)}")
    R, D = g.shape
    if mu.shape != (R,) or rsig.shape != (R,) or mu.dtype != torch.float32 \
            or rsig.dtype != torch.float32:
        raise ValueError("residual_ln_bwd: mu and rsig must be float32 (R,)")
    w32 = w.reshape(1).float()
    dz = torch.empty_like(g)
    row_g = torch.empty((R,), dtype=torch.float32, device=g.device)
    row_gz = torch.empty((R,), dtype=torch.float32, device=g.device)
    if R == 0:
        return dz, row_g, row_gz
    lib = _build.library()
    rc = lib.w2l_residual_ln_bwd(
        g.data_ptr(), x.data_ptr(), y.data_ptr(), mu.data_ptr(), rsig.data_ptr(),
        w32.data_ptr(), dz.data_ptr(), row_g.data_ptr(), row_gz.data_ptr(),
        _build.DTYPE_CODES[g.dtype], R, D, _build.stream_ptr(g))
    _build.check(rc, "residual_ln_bwd")
    _build.LAUNCHES["residual_ln_bwd"] += 1
    return dz, row_g, row_gz


def _launch_ln(x, y, w, b):
    """K3 on checked CUDA tensors."""
    R, D = x.shape
    w32 = w.reshape(1).float()
    b32 = b.reshape(1).float()
    out = torch.empty_like(x)
    mu = torch.empty((R,), dtype=torch.float32, device=x.device)
    rsig = torch.empty((R,), dtype=torch.float32, device=x.device)
    if R == 0:
        return out, mu, rsig
    lib = _build.library()
    rc = lib.w2l_residual_ln(
        x.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(), out.data_ptr(),
        mu.data_ptr(), rsig.data_ptr(), _build.DTYPE_CODES[x.dtype], R, D, EPS,
        _build.stream_ptr(x))
    _build.check(rc, "residual_ln")
    _build.LAUNCHES["residual_ln"] += 1
    return out, mu, rsig


class _ResidualLNFn(torch.autograd.Function):
    """K3 forward; backward = K3b, then the totals of its row sums for the
    scalar weight and bias. mu and rsig carry no gradient."""

    @staticmethod
    def forward(ctx, x, y, w, b):
        out, mu, rsig = _launch_ln(x, y, w, b)
        ctx.save_for_backward(x, y, w, mu, rsig)
        ctx.mark_non_differentiable(mu, rsig)
        return out, mu, rsig

    @staticmethod
    def backward(ctx, g, _gmu, _grsig):
        x, y, w, mu, rsig = ctx.saved_tensors
        dz, row_g, row_gz = residual_ln_bwd(g.contiguous(), x, y, mu, rsig, w)
        dw = row_gz.sum().to(w.dtype).reshape(w.shape) if ctx.needs_input_grad[2] else None
        db = row_g.sum().to(w.dtype).reshape(w.shape) if ctx.needs_input_grad[3] else None
        return dz, dz, dw, db


def residual_ln(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``out = LayerNorm(x + y) * w + b`` per row.

    x, y (R, D) of one dtype; w, b (1,) scalars. Returns out (R, D) of x's
    dtype and the fp32 statistics mu, rsig (R,) for the backward pass. The
    variance is the mean of (z - mu)^2, eps 1e-5.
    """
    if x.device.type == "cpu":
        return residual_ln_plain(x, y, w, b)
    _build.require_cuda("residual_ln", x, y, w, b)
    if x.dtype not in _build.DTYPE_CODES or y.dtype != x.dtype:
        raise TypeError(f"residual_ln: x {x.dtype} and y {y.dtype} must be one of "
                        "float32, bfloat16")
    if x.dim() != 2 or y.shape != x.shape or w.numel() != 1 or b.numel() != 1:
        raise ValueError(f"residual_ln: x, y must be (R, D) alike and w, b scalars; "
                         f"got {tuple(x.shape)}, {tuple(y.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, y, w, b)):
        return _ResidualLNFn.apply(x, y, w, b)
    return _launch_ln(x, y, w, b)
