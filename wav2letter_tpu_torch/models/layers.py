"""Layers of the `.arch` DSL that the ported recipes use (streaming convnets,
transformer and conformer CTC, the ResNet, conv-GLU, TIMIT and learnable-frontend
recipes) — the port of ``wav2letter_tpu/models/layers.py`` (and of its
``arch.py::WNLinear``); the transformer and conformer layers are in
``transformer.py``.

Coordinate convention, as in the JAX package: the reference's column-major
ArrayFire tensor with dims (d0, d1, d2, d3) is stored row-major with its axes
reversed, ``stored.shape == (d3, d2, d1, d0)``. So AF ``View`` is a row-major
reshape of the reversed target dims, AF ``Reorder`` a permute with the
reversed permutation, an op on AF dim k an op on stored axis 3-k, and speech
enters as stored (B, 1, C, T).

Parameters keep the JAX names and shapes (Conv2D ``weight`` OIHW, Linear
``weight`` (in, out), WNLinear ``v`` (in, out) and ``g``, LayerNorm scalar
``weight``/``bias``, PReLU ``weight``), so a flax param tree converts by
renaming paths (``runtime/checkpoint.py``). Any re-indexing a
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

import contextlib
import math
from collections import OrderedDict
from types import SimpleNamespace
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..criterions.seq2seq import Dense, GRUCell
from ..features.specaug import SpecAugment
from ..kernels import KERNELS
from ..kernels.tconv import time_conv_takes
from ..parallel.mesh import current_mesh
from ..parallel.sharding import (column_parallel, enter_model_region, gather_columns,
                                 reduce_from_model)

Pads = Union[int, Tuple[int, int]]


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
    """AF Linear: dense on the last stored axis, weight (in, out) as in JAX.

    Under tensor parallelism (``tp``, set by ``parallel.shard_params``) the
    weight holds this rank's output columns; the product is gathered over the
    model group, and the bias, which stays whole, is added after."""

    TP_PARAMS = ("weight",)
    tp = None

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.weight = nn.Parameter(torch.empty(in_dim, out_dim).uniform_(-bound, bound))
        self.bias = (nn.Parameter(torch.empty(out_dim).uniform_(-bound, bound))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = _derived(self, x.dtype, lambda: (
            self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype)))
        y = column_parallel(x, w, self.tp)
        if b is not None:
            y = y + b
        return y


class WNLinear(nn.Module):
    """Weight-normalized Linear (arch ``WN wn_dim L in out``), as the JAX
    ``arch.py::WNLinear``: stored ``v`` (in, out) and ``g``, the weight
    ``v / sqrt(sum(v^2) + 1e-12) * g`` with the norm over inputs (``WN 0``,
    ``g`` (out,)) or over outputs (``WN 1``, ``g`` (in,)).

    Under tensor parallelism (``tp``) ``v`` holds this rank's output columns:
    ``WN 0`` takes the matching entries of ``g``, ``WN 1`` sums its norm over
    the model group; the product is gathered as ``Linear``'s."""

    TP_PARAMS = ("v",)
    tp = None

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, wn_dim: int = 0):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.norm_axis = 0 if wn_dim == 0 else 1
        v = torch.empty(in_dim, out_dim).uniform_(-bound, bound)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(v.norm(dim=self.norm_axis))
        self.bias = (nn.Parameter(torch.empty(out_dim).uniform_(-bound, bound))
                     if use_bias else None)

    def _weight(self, dtype: torch.dtype) -> torch.Tensor:
        v, g, mesh = self.v, self.g, self.tp
        ss = (v * v).sum(dim=self.norm_axis, keepdim=True)
        if mesh is not None:
            g = enter_model_region(g, mesh)
            if self.norm_axis == 0:
                n = v.shape[1]
                g = g[mesh.model_index * n:(mesh.model_index + 1) * n]
            else:
                ss = enter_model_region(reduce_from_model(ss, mesh), mesh)
        nrm = torch.sqrt(ss + 1e-12)
        g = g[None, :] if self.norm_axis == 0 else g[:, None]
        return (v / nrm * g).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = _derived(self, x.dtype, lambda: (
            self._weight(x.dtype), None if self.bias is None else self.bias.to(x.dtype)))
        y = column_parallel(x, w, self.tp)
        return y if b is None else y + b


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
    ``F.conv2d``, as the JAX package leaves it to ``lax.conv_general_dilated``.

    Under tensor parallelism (``tp``) the weight (or ``v``) holds this rank's
    share of the time taps, the last axis of OIHW, which is the one JAX
    splits: the rank convolves its taps over the input shifted by their
    offset, and the partial outputs are summed over the model group
    (``_tap_parallel``); a weight norm sums its squares over the group."""

    TP_PARAMS = ("weight", "v")
    tp = None

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
        ss, g = (self.v * self.v).sum(dim=(1, 2, 3), keepdim=True), self.g
        if self.tp is not None:  # the norm spans every rank's taps
            ss = enter_model_region(reduce_from_model(ss, self.tp), self.tp)
            g = enter_model_region(g, self.tp)
        return (g * self.v / torch.sqrt(ss + 1e-12)).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.time_only and self.tp is None:
            y = self.chain(to_chain(x), x.shape[2], self.pads(x.shape[3]))
            return from_chain(y, self.out_ch)
        return self.general(x, self.pads(x.shape[3]))

    def chain(self, z: torch.Tensor, freq: int, pads: Tuple[int, int]) -> torch.Tensor:
        """The time-only form on the f-major (B, T, freq*in_ch): kernel K2
        with the time pads ``pads``; returns (B, Tout, freq*out_ch)."""
        w, bias = _derived(self, z.dtype, lambda: (
            _kco(self.weight, z.dtype), None if self.bias is None else self.bias.float()))
        return self.ops.time_conv(z, w, freq, self.sx, pads, bias)

    def general(self, x: torch.Tensor, pw: Tuple[int, int]) -> torch.Tensor:
        """Any form on the stored (B, C, H, T), time pads ``pw``: ``F.conv2d``."""
        w, bias = _derived(self, x.dtype, lambda: (
            self._oihw(x.dtype), None if self.bias is None else self.bias.to(x.dtype)))
        ph = (_same_pads(x.shape[2], self.wy, self.sy, self.dy) if self.py == -1
              else (self.py, self.py))
        if self.tp is not None:
            return self._tap_parallel(x, w, bias, pw, ph)
        if pw[0] != pw[1] or ph[0] != ph[1]:
            x = F.pad(x, (*pw, *ph))
            pw = ph = (0, 0)
        return F.conv2d(x, w, bias, stride=(self.sy, self.sx), padding=(ph[0], pw[0]),
                        dilation=(self.dy, self.dx), groups=self.groups)

    def _tap_parallel(self, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                      pw: Tuple[int, int], ph: Tuple[int, int]) -> torch.Tensor:
        """``general`` with this rank's taps ``[k0, k0 + n)`` of the kernel:
        ``y[t] = sum_k w[k] xpad[t*sx + k*dx]`` restricted to them is the conv
        of ``w`` over ``xpad`` from ``k0*dx`` on, cut to the full output's
        length; the model group sums the parts, then the bias is added."""
        mesh = self.tp
        x = F.pad(enter_model_region(x, mesh), (*pw, *ph))
        t_out = (x.shape[3] - (self.wx - 1) * self.dx - 1) // self.sx + 1
        k0 = mesh.model_index * w.shape[3]
        y = F.conv2d(x[..., k0 * self.dx:], w, None, stride=(self.sy, self.sx),
                     dilation=(self.dy, self.dx), groups=self.groups)
        y = reduce_from_model(y[..., :t_out].contiguous(), mesh)
        return y if bias is None else y + bias[:, None, None]


class AsymmetricConv1D(nn.Module):
    """Future-context-limited 1-D conv (reference ``AC``; JAX
    ``layers.py::AsymmetricConv1D``): of the pad, a ``future_px`` share goes
    to the right. With ``px == -1`` the pad is (wx-1)*dx in all, right
    ``round(future_px * total)``; else 2*px in all, right
    ``round(future_px * px)``. The conv is a ``Conv2D`` named ``conv``
    with that (left, right) pair, so the params are ``conv.weight`` (or
    ``conv.v``/``conv.g``) and ``conv.bias``, as in JAX."""

    def __init__(self, in_ch: int, out_ch: int, wx: int, sx: int = 1, px: int = 0,
                 future_px: float = 1.0, dx: int = 1, wn_dim: int = -1,
                 ops: SimpleNamespace = KERNELS):
        super().__init__()
        self.time_pads = asymmetric_pads(wx, px, future_px, dx)
        self.conv = Conv2D(in_ch, out_ch, wx, 1, sx, 1, self.time_pads, 0, dx, 1,
                           wn_dim=wn_dim, ops=ops)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def asymmetric_pads(wx: int, px: int, future_px: float, dx: int = 1) -> Tuple[int, int]:
    """(left, right) time pads of an ``AC`` layer, as JAX computes them."""
    if px == -1:
        total = (wx - 1) * dx
        right = int(round(future_px * total))
    else:
        total = 2 * px
        right = int(round(future_px * total / 2.0))
    return total - right, right


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


class PReLU(nn.Module):
    """Arch ``PR [n_params] [init]``: ``where(x >= 0, x, a * x)`` with ``a``
    the learnt ``weight`` (one value, or ``n_params`` along the last stored
    axis), as JAX writes it. ``F.prelu`` takes the ``a * g`` side of the
    gradient at ``x == 0``, where dropout leaves exact zeros; this the ``g``."""

    def __init__(self, n_params: int = 1, init_val: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n_params,), float(init_val)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight[0] if self.weight.numel() == 1 else self.weight
        return torch.where(x >= 0, x, a.to(x.dtype) * x)


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
    """Dropout in training mode: from ``generator`` where one is set (the LM
    trainer sets a seeded generator of the device, ``set_generator``), else
    from the device's global generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training, self.generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if not training or rate <= 0.0:
        return x
    if generator is None:
        return F.dropout(x, rate, True)
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Point every dropout (and SpecAugment) layer under ``module`` at
    ``generator``."""
    for m in module.modules():
        if isinstance(m, (Dropout, SpecAugmentLayer)):
            m.generator = generator


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
# residual scaffold (RES/SKIP/SKIPL)
# ---------------------------------------------------------------------------
class ResidualBlock(nn.Module):
    """Reference Residual container (``SequentialBuilder.cpp:525-599``; JAX
    ``layers.py::ResidualBlock``): layers ``l{k}`` plus shortcuts (from,
    to), each with an optional projection sequence ``s{i}`` (children
    ``p{k}``), and scales by target index. Indices are 1-based: 0 is the
    block's input, ``n + 1`` adds to its output. The input of layer i is the
    previous output plus the shortcuts into i, that sum times ``scales[i]``."""

    def __init__(self, layers, shortcuts, scales=None):
        super().__init__()
        for k, layer in enumerate(layers):
            self.add_module(f"l{k}", layer)
        self.n_layers = len(layers)
        self.shortcuts = []  # (from, to, projection name or None)
        for si, (f, t, proj) in enumerate(shortcuts):
            name = None
            if proj is not None:
                name = f"s{si}"
                self.add_module(name, nn.Sequential(
                    OrderedDict((f"p{k}", m) for k, m in enumerate(proj))))
            self.shortcuts.append((f, t, name))
        self.scales = dict(scales or {})

    def _into(self, outputs, i):
        add = None
        for f, t, proj in self.shortcuts:
            if t == i:
                src = outputs[f] if proj is None else getattr(self, proj)(outputs[f])
                add = src if add is None else add + src
        return add

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outputs = [x]
        n = self.n_layers
        for i in range(1, n + 2):
            inp = outputs[i - 1]
            add = self._into(outputs, i)
            if add is not None:
                inp = inp + add
                if i in self.scales:
                    inp = inp * self.scales[i]
            outputs.append(getattr(self, f"l{i - 1}")(inp) if i <= n else inp)
        return outputs[n + 1]


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
    With ``lnorm_include_time`` (the arch's default, as in
    ``recipes/seq2seq_tds``) each LN takes its statistics over a sample's
    frames, padding included, and channels (flashlight's LayerNorm over AF
    dims 0-2, the JAX non-fused path): K3's per-frame fusion does not apply,
    so the residual add and that LN are plain; the conv is still K2.
    ``chain``, the stream's step, always normalizes per frame, as the JAX
    stream does for either form.

    The block works in the (B, T, F*C) f-major layout; ``lin1``/``lin2`` keep
    their C-major (c*F+f) params, re-indexed here to f-major rows/columns as
    the JAX ``in_swap``/``out_swap`` do (``layers.py:128-166``). Under tensor
    parallelism each linear holds its rank's columns (``Linear.tp``): w1's
    rows are still re-indexed; w2's C-major columns are multiplied as they
    are and the gathered product is re-indexed instead.
    """

    def __init__(self, channels: int, kernel_width: int, freq_dim: int,
                 dropout: float = 0.0, inner_linear_dim: int = 0, right_pad: int = -1,
                 lnorm_include_time: bool = True, ops: SimpleNamespace = KERNELS):
        super().__init__()
        c, f, w = channels, freq_dim, kernel_width
        self.c, self.f, self.w, self.rate = c, f, w, dropout
        self.ln_over_time = lnorm_include_time
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
        w1 = self.lin1.weight.view(c, f, -1).transpose(0, 1).reshape(D, -1)
        w2 = self.lin2.weight
        if self.lin2.tp is None:
            w2 = w2.view(-1, c, f).transpose(1, 2).reshape(-1, D)
        b2 = self.lin2.bias.view(c, f).t().reshape(D)
        return (_kco(self.conv.weight, dt), self.conv.bias.float(), w1.to(dt),
                self.lin1.bias.to(dt), w2.to(dt), b2.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, C, Fq, _ = x.shape
        c, f = self.c, self.f
        if (C, Fq) != (c, f):
            raise ValueError(f"TDS({c}, {f}) got input {tuple(x.shape)}")
        z = to_chain(x)
        return from_chain(self.chain(z, self.time_pads, z, self.ln_over_time), c)

    def _ln(self, x: torch.Tensor, y: torch.Tensor, ln: nn.Module,
            over_time: bool) -> torch.Tensor:
        """LN(x + y) on (B, T, D): per frame (K3), or over each sample's T*D
        values (statistics in fp32, population variance, eps 1e-5)."""
        B, T, D = y.shape
        if not over_time:
            return self.ops.residual_ln(x.reshape(-1, D), y.reshape(-1, D), ln.weight,
                                        ln.bias)[0].view(B, T, D)
        s = (x.reshape(B, T, D) + y).float()
        mean = s.mean(dim=(1, 2), keepdim=True)
        var = s.var(dim=(1, 2), keepdim=True, unbiased=False)
        return (ln.weight * ((s - mean) * torch.rsqrt(var + 1e-5)) + ln.bias).to(y.dtype)

    def chain(self, z: torch.Tensor, pads: Tuple[int, int], res: torch.Tensor,
              over_time: bool = False) -> torch.Tensor:
        """The block on the f-major (B, T, F*C): K2 with time pads ``pads``,
        then the residual ``res`` (B, Tout, F*C), the frames of z that the
        conv's outputs align with; returns (B, Tout, F*C). ``over_time``: the
        LNs over each sample's frames (the batch forward of a block built
        with ``lnorm_include_time``)."""
        kco, cb, w1, b1, w2, b2 = _derived(self, z.dtype, lambda: self._weights(z.dtype))
        y = self.ops.time_conv(z, kco, self.f, 1, pads, cb, relu=True)
        y = F.dropout(y, self.rate, self.training)
        B, T, D = y.shape
        z = self._ln(res, y, self.ln1, over_time).view(-1, D)
        h = torch.relu(column_parallel(z, w1, self.lin1.tp) + b1)
        h = F.dropout(h, self.rate, self.training)
        h = column_parallel(h, w2, self.lin2.tp)
        if self.lin2.tp is not None:  # gathered C-major columns -> f-major
            h = h.view(-1, self.c, self.f).transpose(1, 2).reshape(-1, D)
        h = h + b2
        h = F.dropout(h, self.rate, self.training)
        return self._ln(z, h.view(B, T, D), self.ln2, over_time)


# ---------------------------------------------------------------------------
# embeddings (the LM archs' first layer)
# ---------------------------------------------------------------------------
def _af_ids(x: torch.Tensor, what: str) -> torch.Tensor:
    """Token ids of the AF (d0, d1, d2, 1) layout: stored (1, d2, d1, d0)
    -> (d2, d1, d0)."""
    ids = x.long()
    if ids.dim() == 4:
        if ids.shape[0] != 1:
            raise ValueError(f"{what} needs AF d3 == 1, got stored shape {tuple(ids.shape)}")
        ids = ids[0]
    return ids


class Embedding(nn.Module):
    """Arch ``E emb n_tokens`` (JAX ``layers.py::Embedding``): AF (d0, d1,
    d2, 1) ids -> (emb, d0, d1, d2), stored (d2, d1, d0, emb); ``weight``
    (n_tokens, emb), normal * 0.1. Under tensor parallelism (``tp``) the
    weight holds this rank's feature columns, gathered after the lookup."""

    TP_PARAMS = ("weight",)
    tp = None

    def __init__(self, emb_dim: int, n_tokens: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(n_tokens, emb_dim) * 0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.embedding(_af_ids(x, "Embedding"), self.weight.float())
        return y if self.tp is None else gather_columns(y, self.tp)


class AdaptiveEmbedding(nn.Module):
    """Arch ``ADAPTIVEE emb c1,c2,...`` (Baevski & Auli 2018; JAX
    ``layers.py::AdaptiveEmbedding``): cluster i = ids in [c_{i-1}, c_i) has
    an embedding ``emb{i}`` of width emb / 4^i, projected up to emb by
    ``proj{i}`` where the widths differ; the clusters' rows are summed under
    their masks. The AF layout is Embedding's."""

    def __init__(self, emb_dim: int, cutoffs: Tuple[int, ...]):
        super().__init__()
        self.emb_dim, self.cutoffs = emb_dim, tuple(cutoffs)
        lo = 0
        for i, hi in enumerate(self.cutoffs):
            dim = max(1, emb_dim // (4 ** i))
            self.register_parameter(f"emb{i}", nn.Parameter(torch.randn(hi - lo, dim) * 0.02))
            if dim != emb_dim:
                self.register_parameter(
                    f"proj{i}", nn.Parameter(torch.randn(dim, emb_dim) / math.sqrt(dim)))
            lo = hi

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ids = _af_ids(x, "AdaptiveEmbedding")
        out = torch.zeros(ids.shape + (self.emb_dim,), device=ids.device)
        lo = 0
        for i, hi in enumerate(self.cutoffs):
            vec = F.embedding((ids - lo).clamp(0, hi - lo - 1), getattr(self, f"emb{i}"))
            proj = getattr(self, f"proj{i}", None)
            if proj is not None:
                vec = vec @ proj
            in_cluster = (ids >= lo) & (ids < hi)
            out = out + torch.where(in_cluster[..., None], vec, torch.zeros((), device=ids.device))
            lo = hi
        return out


# ---------------------------------------------------------------------------
# position embeddings, precision cast
# ---------------------------------------------------------------------------
class PositionEmbedding(nn.Module):
    """Arch ``POSEMB dim context [dropout]`` (JAX ``layers.py::
    PositionEmbedding``): a learnt ``embedding`` (context, dim), normal *
    0.1, added to the (..., T, C) input, then dropout (``do``)."""

    def __init__(self, layer_dim: int, context_size: int, dropout: float = 0.0):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(context_size, layer_dim) * 0.1)
        self.do = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.do(x + self.embedding[: x.shape[-2]].to(x.dtype))


def sinusoid_table(T: int, C: int) -> np.ndarray:
    """The (T, C) float32 table of ``SINPOSEMB``, built in numpy as JAX
    builds it (odd C included)."""
    pos = np.arange(T)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, C, 2) * (-math.log(10000.0) / C)).astype(np.float32)
    pe = np.zeros((T, C), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: (C // 2) + (C % 2)][: pe[:, 1::2].shape[1]])
    return pe


class SinusoidalPositionEmbedding(nn.Module):
    """Arch ``SINPOSEMB dim [scale]``: ``x * scale + table``, the table of
    the input's (T, C) (``sinusoid_table``), kept per shape and device."""

    def __init__(self, layer_dim: int, input_scale: float = 1.0):
        super().__init__()
        self.input_scale = input_scale
        self._tables = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, C = x.shape[-2], x.shape[-1]
        key = (T, C, x.dtype, str(x.device))
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(sinusoid_table(T, C)).to(x.device, x.dtype)
        return x * self.input_scale + self._tables[key]


PC_DTYPES = {"f16": torch.float16, "f32": torch.float32, "f64": torch.float64,
             "b8": torch.bfloat16, "bf16": torch.bfloat16}


class PrecisionCast(nn.Module):
    """Arch ``PC dtype`` (``PC_DTYPES``: f16, f32, f64, b8 or bf16): a cast."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
_STATISTICS_FROZEN = [False]


@contextlib.contextmanager
def statistics_frozen():
    """Running statistics stay where they are inside: the recompute of a
    checkpointed forward moves them no second time (``jax.checkpoint`` of the
    pure forward moves them once)."""
    _STATISTICS_FROZEN[0] = True
    try:
        yield
    finally:
        _STATISTICS_FROZEN[0] = False


class _DataSum(torch.autograd.Function):
    """Forward: the sum over the data group of each rank's partial sum.
    Backward: the sum over the data group of the ranks' gradients of it, since
    each rank's loss reaches the shared sum through its own rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous().clone()
        dist.all_reduce(x, group=mesh.data_group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.data_group)
        return g, None


def _data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    return _DataSum.apply(x, mesh)


class BatchNorm(nn.Module):
    """Arch ``BN size dims...`` (JAX ``layers.py::BatchNorm``): statistics
    over every stored axis but the AF feature dims, in fp32, the biased
    variance, eps 1e-5, per-feature ``weight`` and ``bias``. Training
    normalizes by the batch's statistics and moves the running ones as flax
    does, ``ra = 0.9 ra + 0.1 batch`` (torch's ``momentum`` is the other
    share); eval normalizes by the running ones. The buffers ``mean`` and
    ``var`` take JAX's keepdims shape of a 4-d input where one feature dim
    fixes it (flat otherwise, reshaped on load).

    On several data ranks (the current mesh's data axis) the batch statistics
    are those of the global batch, padded rows included, as under JAX's
    ``pjit``: the count, the sum and then the centred sum of squares are
    summed over the data group inside autograd (``_data_sum``), so every rank
    normalizes alike and moves the running statistics alike. Inside a
    ``--remat`` recompute (``statistics_frozen``) they do not move again."""

    def __init__(self, feat_af_dims: Tuple[int, ...], feat_size: int,
                 momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.feat_af_dims, self.momentum, self.epsilon = tuple(feat_af_dims), momentum, epsilon
        self.weight = nn.Parameter(torch.ones(feat_size))
        self.bias = nn.Parameter(torch.zeros(feat_size))
        shape = (feat_size,)
        if len(self.feat_af_dims) == 1:
            shape = [1] * 4
            shape[3 - self.feat_af_dims[0]] = feat_size
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("var", torch.ones(shape))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("mean", "var"):
            t = state_dict.get(prefix + name)
            if t is not None and t.shape != getattr(self, name).shape \
                    and t.numel() == getattr(self, name).numel():
                state_dict[prefix + name] = t.reshape(getattr(self, name).shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = sorted(x.dim() - 1 - d for d in self.feat_af_dims)
        red = tuple(a for a in range(x.dim()) if a not in feat)
        shape = tuple(x.shape[a] if a in feat else 1 for a in range(x.dim()))
        xf = x.float()
        mesh = current_mesh()
        if not self.training:
            mean, var = self.mean.view(shape), self.var.view(shape)
        elif mesh is not None and mesh.distributed and mesh.spec.n_data > 1:
            n = xf.new_tensor(float(xf.numel() // math.prod(shape)))
            dist.all_reduce(n, group=mesh.data_group)
            mean = _data_sum(xf.sum(dim=red, keepdim=True), mesh) / n
            var = _data_sum(((xf - mean) ** 2).sum(dim=red, keepdim=True), mesh) / n
        else:
            mean = xf.mean(dim=red, keepdim=True)
            var = xf.var(dim=red, keepdim=True, unbiased=False)
        if self.training and not _STATISTICS_FROZEN[0]:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_((m * self.mean.view(shape) + (1 - m) * mean).view_as(self.mean))
                self.var.copy_((m * self.var.view(shape) + (1 - m) * var).view_as(self.var))
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


# ---------------------------------------------------------------------------
# RNNs
# ---------------------------------------------------------------------------
class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell``: input parts ``ii if ig io`` without a
    bias, hidden parts ``hi hf hg ho`` with one; ``c' = f c + i g``,
    ``h' = o tanh(c')``, gates sigmoid but g (tanh)."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        for g in self.GATES:
            self.add_module(f"i{g}", Dense(in_dim, hidden, use_bias=False))
            self.add_module(f"h{g}", Dense(hidden, hidden, init="orthogonal"))
        self.hidden = hidden

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The input parts of every step at once: (..., T, 4 * hidden)."""
        w = torch.cat([getattr(self, f"i{g}").kernel for g in self.GATES], dim=1)
        return x @ w.to(x.dtype)

    def step(self, carry, xi: torch.Tensor):
        c, h = carry
        w = torch.cat([getattr(self, f"h{g}").kernel for g in self.GATES], dim=1)
        b = torch.cat([getattr(self, f"h{g}").bias for g in self.GATES])
        i, f, g, o = (xi + h @ w.to(h.dtype) + b.to(h.dtype)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def zeros(self, x: torch.Tensor):
        z = x.new_zeros(x.shape[:-2] + (self.hidden,))
        return (z, z)


class GRUStepCell(GRUCell):
    """flax ``nn.GRUCell`` (the seq2seq criterion's six dense parts), stepped
    with its input parts computed for every step at once."""

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.ir(x), self.iz(x), getattr(self, "in")(x)], dim=-1)

    def step(self, h, xi: torch.Tensor):
        xr, xz, xn = xi.chunk(3, dim=-1)
        r = torch.sigmoid(xr + self.hr(h))
        z = torch.sigmoid(xz + self.hz(h))
        n = torch.tanh(xn + r * self.hn(h))
        h = (1.0 - z) * n + z * h
        return h, h

    def zeros(self, x: torch.Tensor):
        return x.new_zeros(x.shape[:-2] + (self.hn.kernel.shape[0],))


class SimpleReluCell(nn.Module):
    """JAX ``layers.py::SimpleReluCell``: ``h' = relu(i(x) + h(h))``, ``i``
    with a bias, ``h`` without."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.i = Dense(in_dim, hidden)
        self.h = Dense(hidden, hidden, use_bias=False)
        self.hidden = hidden

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        return self.i(x)

    def step(self, h, xi: torch.Tensor):
        h = torch.relu(xi + self.h(h))
        return h, h

    def zeros(self, x: torch.Tensor):
        return x.new_zeros(x.shape[:-2] + (self.hidden,))


class RNN(nn.Module):
    """Arch ``RNN|GRU|LSTM in hidden [layers [bidir [dropout]]]`` (JAX
    ``layers.py::RNN``) over the stored (..., T, C) input: cells
    ``l{layer}d{direction}`` under flax's parameter names, a loop over the
    whole padded time axis (no lengths, as flax's ``nn.RNN`` runs it), the
    backward direction over the reversed axis and its outputs put back in
    order (``keep_order``), the directions concatenated, dropout ``do{k}``
    between layers."""

    CELLS = {"lstm": LSTMCell, "gru": GRUStepCell, "relu": SimpleReluCell}

    def __init__(self, in_dim: int, hidden: int, n_layers: int = 1, mode: str = "lstm",
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        self.n_layers, self.n_dirs = n_layers, 2 if bidirectional else 1
        d = in_dim
        for li in range(n_layers):
            for di in range(self.n_dirs):
                self.add_module(f"l{li}d{di}", self.CELLS[mode](d, hidden))
            if dropout > 0 and li < n_layers - 1:
                self.add_module(f"do{li}", Dropout(dropout))
            d = hidden * self.n_dirs

    @staticmethod
    def _run(cell, h: torch.Tensor, reverse: bool) -> torch.Tensor:
        xi = cell.inputs(h)
        carry, T = cell.zeros(h), h.shape[-2]
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            carry, outs[t] = cell.step(carry, xi[..., t, :])
        return torch.stack(outs, dim=-2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, (T, C) = x.shape[:-2], x.shape[-2:]
        h = x.reshape(-1, T, C)
        for li in range(self.n_layers):
            outs = [self._run(getattr(self, f"l{li}d{di}"), h, di == 1)
                    for di in range(self.n_dirs)]
            h = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
            if hasattr(self, f"do{li}"):
                h = getattr(self, f"do{li}")(h)
        return h.reshape(lead + h.shape[1:])
