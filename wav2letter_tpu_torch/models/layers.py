"""Layers of the `.arch` DSL that the ported recipes use (streaming convnets,
transformer and conformer CTC) — the port of ``wav2letter_tpu/models/layers.py``;
the transformer and conformer layers are in ``transformer.py``.

Coordinate convention, as in the JAX package: the reference's column-major
ArrayFire tensor with dims (d0, d1, d2, d3) is stored row-major with its axes
reversed, ``stored.shape == (d3, d2, d1, d0)``. So AF ``View`` is a row-major
reshape of the reversed target dims, AF ``Reorder`` a permute with the
reversed permutation, an op on AF dim k an op on stored axis 3-k, and speech
enters as stored (B, 1, C, T).

Parameters keep the JAX names and shapes (Conv2D ``weight`` OIHW, Linear
``weight`` (in, out), LayerNorm scalar ``weight``/``bias``), so a flax param
tree converts by renaming paths (``runtime/checkpoint.py``). Any re-indexing a
kernel layout needs happens in ``forward``; without autograd its result, cast
to the activations' dtype, is kept until the params change (``_derived``).

The time convolutions run kernel K2 and the residual LayerNorms of a TDS block
kernel K3, both in the (B, T, F*C) f-major chain layout. A conv or TDS block
returns its output as a permuted view of that layout, so the next one finds
its input already f-major and ``.contiguous()`` copies nothing. Under
autograd the same calls record the kernels' backward (K2 as dgrad, K2b, K3b),
and the gradients flow through the re-indexing back to the stored params.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..features.specaug import SpecAugment
from ..kernels import KERNELS
from ..kernels.tconv import time_conv_takes

Pads = Union[int, Tuple[int, int]]


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the slices of the PyTorch port so far (training and serving "
        "the streaming-convnets, transformer and conformer CTC recipes); it comes in a "
        "later slice")


def _derived(module: nn.Module, dtype: torch.dtype, build):
    """``build()``: the module's params re-indexed and cast to ``dtype``.

    Without autograd the result is kept on the module and rebuilt only when a
    param changes (new storage after ``.to()``, or an in-place write such as
    ``load_state_dict``), so serving does no per-forward weight copies. Under
    autograd it is built each call, so gradients reach the stored params.
    """
    if torch.is_grad_enabled():
        return build()
    key = (dtype,) + tuple((p.data_ptr(), p._version) for p in module.parameters())
    cached = module.__dict__.get("_derived_cache")
    if cached is None or cached[0] != key:
        cached = (key, build())
        module.__dict__["_derived_cache"] = cached
    return cached[1]


# ---------------------------------------------------------------------------
# shape-only transforms
# ---------------------------------------------------------------------------
class View(nn.Module):
    """AF View: column-major reshape; -1 infer, 0 keep input dim size."""

    def __init__(self, dims: Tuple[int, int, int, int]):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        af_in = tuple(reversed(x.shape))
        tgt = [(af_in[i] if i < len(af_in) else 1) if d == 0 else d
               for i, d in enumerate(self.dims)]
        known = math.prod(d for d in tgt if d != -1)
        tgt = [x.numel() // known if d == -1 else d for d in tgt]
        return x.reshape(tuple(reversed(tgt)))


class Identity(nn.Module):
    """Placeholder that keeps layer indices (and so parameter names) stable
    where a layer was folded into its neighbour."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Reorder(nn.Module):
    def __init__(self, perm: Tuple[int, int, int, int]):
        super().__init__()
        # AF: out dim i = in dim perm[i]; stored axis j = 3-i takes 3-perm[i]
        self.stored_perm = tuple(3 - perm[3 - j] for j in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.stored_perm)


class Padding(nn.Module):
    def __init__(self, value: float, pads: Tuple[Tuple[int, int], ...]):
        super().__init__()
        self.value = value
        self.pads = pads  # per AF dim (before, after)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F.pad lists pads from the last stored axis, which is AF dim 0
        flat = [p for af_dim, ba in enumerate(self.pads) if af_dim < x.dim() for p in ba]
        return F.pad(x, flat, value=self.value)


# ---------------------------------------------------------------------------
# parametric layers
# ---------------------------------------------------------------------------
class Linear(nn.Module):
    """AF Linear: dense on the last stored axis, weight (in, out) as in JAX."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim).uniform_(-bound, bound))
        self.bias = (nn.Parameter(torch.empty(out_dim).uniform_(-bound, bound))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = _derived(self, x.dtype, lambda: (
            self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype)))
        y = x @ w
        if b is not None:
            y = y + b
        return y


def _same_pads(n: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    out = -(-n // s)
    total = max(0, (out - 1) * s + (k - 1) * d + 1 - n)
    return total // 2, total - total // 2


def _kco(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW (out, in, 1, K) conv weight -> the (K, in, out) kernel layout."""
    return weight[:, :, 0, :].permute(2, 1, 0).contiguous().to(dtype)


def to_chain(x: torch.Tensor) -> torch.Tensor:
    """Stored (B, C, F, T) -> contiguous f-major (B, T, F*C). A no-op copy
    when x is the view ``from_chain`` returned."""
    B, C, Fq, T = x.shape
    return x.permute(0, 3, 2, 1).contiguous().view(B, T, Fq * C)


def from_chain(y: torch.Tensor, C: int) -> torch.Tensor:
    """f-major (B, T, F*C) -> stored (B, C, F, T) as a view (no copy)."""
    B, T, D = y.shape
    return y.view(B, T, D // C, C).permute(0, 3, 2, 1)


# K2 keeps all K*C*CO weights of a conv in shared memory beside its input
# tile; wider convs (the 768- and 1536-channel frontends of the transformer
# recipes) go to the general path, and so do narrower ones whose window the
# kernels cannot stage (``kernels.tconv.time_conv_takes``).
K2_MAX_WEIGHT_BYTES = 64 * 1024


class Conv2D(nn.Module):
    """AF Conv2D on the stored NCHW layout (N=d3, C=d2, H=d1, W=d0=time),
    weight OIHW (out, in/groups, wy, wx) as in JAX. ``px``/``py`` are a
    symmetric pad or -1 for SAME; ``px`` may also be a (left, right) pair, the
    form a folded ``PD`` line leaves. With ``wn_dim >= 0`` the weight is
    ``g * v / sqrt(sum(v^2) + 1e-12)`` per output channel (params ``v``, ``g``).

    The time-only narrow form (wy=1, sy=1, py=0, no dilation, groups or weight
    norm, weights within ``K2_MAX_WEIGHT_BYTES``, a shape the kernels take)
    runs kernel K2 in the f-major chain layout. Every other form is one
    ``F.conv2d``, as the JAX package leaves it to ``lax.conv_general_dilated``."""

    def __init__(self, in_ch: int, out_ch: int, wx: int, wy: int = 1, sx: int = 1,
                 sy: int = 1, px: Pads = 0, py: int = 0, dx: int = 1, dy: int = 1,
                 groups: int = 1, use_bias: bool = True, wn_dim: int = -1,
                 ops: SimpleNamespace = KERNELS):
        super().__init__()
        self.in_ch, self.out_ch, self.wx, self.wy = in_ch, out_ch, wx, wy
        self.sx, self.sy, self.px, self.py, self.dx, self.dy = sx, sy, px, py, dx, dy
        self.groups, self.wn_dim = groups, wn_dim
        self.ops = ops
        self.time_only = (
            (wy, sy, py, dx, dy, groups) == (1, 1, 0, 1, 1, 1) and wn_dim < 0
            and 4 * wx * in_ch * out_ch <= K2_MAX_WEIGHT_BYTES
            and time_conv_takes(wx, in_ch, out_ch, sx))
        fan_in = wx * wy * in_ch // groups
        w = torch.randn(out_ch, in_ch // groups, wy, wx) * math.sqrt(2.0 / max(1, fan_in))
        if wn_dim >= 0:
            self.v = nn.Parameter(w)
            self.g = nn.Parameter(w.reshape(out_ch, -1).norm(dim=1).reshape(out_ch, 1, 1, 1))
        else:
            self.weight = nn.Parameter(w)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = (nn.Parameter(torch.empty(out_ch).uniform_(-bound, bound))
                     if use_bias else None)

    def pads(self, T: int) -> Tuple[int, int]:
        if isinstance(self.px, tuple):
            return self.px
        if self.px == -1:
            return _same_pads(T, self.wx, self.sx, self.dx)
        return self.px, self.px

    def _oihw(self, dtype: torch.dtype) -> torch.Tensor:
        if self.wn_dim < 0:
            return self.weight.to(dtype)
        norm = torch.sqrt((self.v * self.v).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
        return (self.g * self.v / norm).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.time_only:
            z = to_chain(x)
            w, bias = _derived(self, z.dtype, lambda: (
                _kco(self.weight, z.dtype), None if self.bias is None else self.bias.float()))
            y = self.ops.time_conv(z, w, x.shape[2], self.sx, self.pads(x.shape[3]), bias)
            return from_chain(y, self.out_ch)
        w, bias = _derived(self, x.dtype, lambda: (
            self._oihw(x.dtype), None if self.bias is None else self.bias.to(x.dtype)))
        pw = self.pads(x.shape[3])
        ph = (_same_pads(x.shape[2], self.wy, self.sy, self.dy) if self.py == -1
              else (self.py, self.py))
        if pw[0] != pw[1] or ph[0] != ph[1]:
            x = F.pad(x, (*pw, *ph))
            pw = ph = (0, 0)
        return F.conv2d(x, w, bias, stride=(self.sy, self.sx), padding=(ph[0], pw[0]),
                        dilation=(self.dy, self.dx), groups=self.groups)


class LayerNorm(nn.Module):
    """flashlight LayerNorm over the given AF dims, scalar affine, population
    variance, eps 1e-5, statistics in fp32."""

    def __init__(self, feat_af_dims: Tuple[int, ...]):
        super().__init__()
        self.feat_af_dims = feat_af_dims
        self.weight = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(x.dim() - 1 - d for d in self.feat_af_dims if d < x.dim())
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        return (self.weight * y + self.bias).to(x.dtype)


class Activation(nn.Module):
    """The parameter-free activations: R, R6, ELU, LG, HT, T, SH (swish with
    ``beta``), and GLU / LSM over AF dim ``dim``."""

    KINDS = ("R", "R6", "ELU", "LG", "HT", "T", "SH", "GLU", "LSM")

    def __init__(self, kind: str, dim: int = 0, beta: float = 1.0):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"unknown activation {kind!r}")
        self.kind, self.dim, self.beta = kind, dim, beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kind
        if k == "R":
            return torch.relu(x)
        if k == "R6":
            return x.clamp(0, 6)
        if k == "ELU":
            return F.elu(x)
        if k == "LG":
            return torch.log(x)
        if k == "HT":
            return x.clamp(-1, 1)
        if k == "T":
            return torch.tanh(x)
        if k == "SH":
            return x * torch.sigmoid(self.beta * x)
        ax = x.dim() - 1 - self.dim
        if k == "GLU":
            a, b = x.chunk(2, dim=ax)
            return a * torch.sigmoid(b)
        return F.log_softmax(x, dim=ax)


class Pool2D(nn.Module):
    """AF Pool2D over (d0 = time, d1) of the stored NCHW layout: max, or the
    average that counts the padding."""

    def __init__(self, wx: int, wy: int, sx: int, sy: int, px: int = 0, py: int = 0,
                 mode: str = "max"):
        super().__init__()
        self.window, self.stride, self.pad, self.mode = (wy, wx), (sy, sx), (py, px), mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.window == (1, 1) and self.pad == (0, 0):  # a strided subsample
            return x[..., ::self.stride[0], ::self.stride[1]]
        if self.mode == "max":
            return F.max_pool2d(x, self.window, self.stride, self.pad)
        return F.avg_pool2d(x, self.window, self.stride, self.pad, count_include_pad=True)


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.rate, self.training)


class SpecAugmentLayer(nn.Module):
    """SAUG F mF T p mT nrep: identity when not training. In training it
    masks the stored (B, 1, C, T) features over their whole padded length, as
    the JAX layer does, drawing from ``generator`` (set by ``ArchModel`` for
    each forward; None takes the global generator)."""

    def __init__(self, f: int, mf: int, t: int, p: float, mt: int):
        super().__init__()
        self.cfg = (f, mf, t, p, mt)
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        f, mf, t, p, mt = self.cfg
        sa = SpecAugment(n_freq_masks=mf, freq_mask_f=f, n_time_masks=mt, time_mask_t=t,
                         time_mask_p=p)
        shp = x.shape
        feats = x.reshape(shp[0], shp[-2], shp[-1]).transpose(1, 2)  # (B, T, C)
        return sa(feats, self.generator).transpose(1, 2).reshape(shp)


# ---------------------------------------------------------------------------
# TDS block
# ---------------------------------------------------------------------------
class _ScalarAffine(nn.Module):
    """Holds a LayerNorm's scalar weight/bias for kernel K3."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))


class _TimeConvParams(nn.Module):
    """Holds a TDS block's conv weight (C, C, 1, K) and bias (C,)."""

    def __init__(self, c: int, w: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(c, c, 1, w) * math.sqrt(2.0 / (c * w)))
        bound = 1.0 / math.sqrt(c * w)
        self.bias = nn.Parameter(torch.empty(c).uniform_(-bound, bound))


class TDSBlock(nn.Module):
    """Time-Depth-Separable block (Hannun et al. 2019; reference ``TDS``).

    Input stored (B, C, F, T):
      x = LN1(x + DO(ReLU(Conv_time(x))))        conv kernel (w x 1): K2
      x = LN2(x + DO(W2 DO(ReLU(W1 x))))         per-frame LNs: K3
    ``right_pad >= 0`` makes the time conv asymmetric: pads (w-1-rp, rp).
    Only the per-frame LN form (``lnorm_include_time=0``) is in this slice.

    The block works in the (B, T, F*C) f-major layout; ``lin1``/``lin2`` keep
    their C-major (c*F+f) params, re-indexed here to f-major rows/columns as
    the JAX ``in_swap``/``out_swap`` do (``layers.py:128-166``).
    """

    def __init__(self, channels: int, kernel_width: int, freq_dim: int,
                 dropout: float = 0.0, inner_linear_dim: int = 0, right_pad: int = -1,
                 lnorm_include_time: bool = True, ops: SimpleNamespace = KERNELS):
        super().__init__()
        if lnorm_include_time:
            raise _later("TDS with a LayerNorm over time (lnorm_include_time=1)")
        c, f, w = channels, freq_dim, kernel_width
        self.c, self.f, self.w, self.rate = c, f, w, dropout
        self.ops = ops
        if right_pad >= 0:
            self.time_pads = (w - 1 - right_pad, right_pad)
        else:
            self.time_pads = ((w - 1) // 2, w - 1 - (w - 1) // 2)
        inner = inner_linear_dim or c * f
        self.conv = _TimeConvParams(c, w)
        self.ln1 = _ScalarAffine()
        self.lin1 = Linear(c * f, inner)
        self.lin2 = Linear(inner, c * f)
        self.ln2 = _ScalarAffine()

    def _weights(self, dt: torch.dtype):
        """K2's (K, C, C) conv weight and fp32 bias, and the linears' weights
        and biases in dtype ``dt``, re-indexed from their C-major params to
        f-major: row f*C+c of w1 is C-major row c*F+f."""
        c, f, D = self.c, self.f, self.c * self.f
        inner = self.lin1.weight.shape[1]
        w1 = self.lin1.weight.view(c, f, inner).transpose(0, 1).reshape(D, inner)
        w2 = self.lin2.weight.view(inner, c, f).transpose(1, 2).reshape(inner, D)
        b2 = self.lin2.bias.view(c, f).t().reshape(D)
        return (_kco(self.conv.weight, dt), self.conv.bias.float(), w1.to(dt),
                self.lin1.bias.to(dt), w2.to(dt), b2.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, Fq, T = x.shape
        c, f = self.c, self.f
        if (C, Fq) != (c, f):
            raise ValueError(f"TDS({c}, {f}) got input {tuple(x.shape)}")
        z = to_chain(x)
        kco, cb, w1, b1, w2, b2 = _derived(self, z.dtype, lambda: self._weights(z.dtype))
        y = self.ops.time_conv(z, kco, f, 1, self.time_pads, cb, relu=True)
        y = F.dropout(y, self.rate, self.training)
        D = c * f
        z = self.ops.residual_ln(z.view(-1, D), y.view(-1, D), self.ln1.weight,
                                 self.ln1.bias)[0]
        h = torch.relu(z @ w1 + b1)
        h = F.dropout(h, self.rate, self.training)
        h = h @ w2 + b2
        h = F.dropout(h, self.rate, self.training)
        z = self.ops.residual_ln(z, h, self.ln2.weight, self.ln2.bias)[0]
        return from_chain(z.view(B, T, D), c)
