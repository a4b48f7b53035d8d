"""Precision of the reference, and its lower-precision control.

The reference computes in float32 with TF32 off. The control is the same
reference with every product and convolution computed on float8, as float8
training computes them: the forward's operands in e4m3, the gradient that
the backward's products take in e5m2, one scale per tensor, sums in float32.
That is the step below the bfloat16 that the configurations state, the one a
later change might be tempted to take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0  # largest finite float8_e4m3fn
E5M2_MAX = 57344.0  # largest finite float8_e5m2


def no_tf32() -> None:
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """A product's operand rounded to float8 e4m3 (one scale per tensor);
    the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    """A product's result, unchanged; the gradient that reaches it is
    rounded to float8 e5m2 (one scale per tensor) before the product's
    backward takes it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """Where the reference multiplies: exactly in float32, or (``fp8``)
    on float8 operands and gradients, the control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _product(self, f, a, b):
        if not self.fp8:
            return f(a, b)
        return _Result.apply(f(_Operand.apply(a), _Operand.apply(b)))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._product(torch.matmul, a, b)

    def conv2d(self, x, w, bias=None, stride=1, padding=0):
        y = self._product(lambda u, v: F.conv2d(u, v, stride=stride, padding=padding), x, w)
        return y if bias is None else y + bias.view(1, -1, 1, 1)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._product(lambda u, v: torch.einsum(eq, u, v), a, b)


EXACT = Precision(False)
