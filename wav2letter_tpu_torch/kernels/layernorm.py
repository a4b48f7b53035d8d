"""K3: residual add + per-row LayerNorm with a scalar affine — wrapper and
plain version. The kernel is ``csrc/layernorm.cu``; it replaces the TPU kernel
``wav2letter_tpu/ops/pallas/layernorm.py::fused_residual_ln`` (forward)."""

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
