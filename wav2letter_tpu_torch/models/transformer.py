"""Transformer and Conformer encoder layers (arch mnemonics ``TR``/``CFR``) —
the port of ``wav2letter_tpu/models/transformer.py``.

Semantics, as there (the reference's ``TransformerCPC.cpp``):
  * wq/wk/wv: modelDim -> headDim*nHeads, init U(+-0.707*sqrt(6/(in+out)));
    q scaled by 1/sqrt(headDim).
  * relative position embedding: a (2*bptt, headDim) table added to the
    attention scores, bias[i, j] = q_i . P[(j - i) + bptt], zero beyond
    +-bptt.
  * pad mask over keys; layerdrop as a whole-layer scale f in {0, 1}.
  * preLN variant: h = f*LN1(attn(x)) + x; out = f*LN2(mlp(h)) + h (the LN on
    the sublayer's output). postLN: h = LN1(f*attn(x) + x); out = LN2(f*mlp(h) + h).
  * MLP: w2(relu(w1(x))); LayerNorm over the feature axis, scalar affine.

Layers work on stored (..., T, C) activations; archs reach them as
(1, B, T, C). Parameters keep the JAX names and shapes, so a flax param tree
converts by renaming paths.

Attention inside the gate of the JAX package (not causal, a relative-position
table, T <= bptt, batched input) is the fused function ``ops.mhsa``: kernel
K4, and K4b under autograd, on the card; its plain version on the CPU.
Outside the gate it is the unfused PyTorch path below. The post-LN residuals
``LN(f*a + x)`` go through ``ops.residual_ln`` (K3, K3b) where the LayerNorm's
AF dims (0, 3) reduce to the row.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import KERNELS
from ..kernels.attention import mhsa_takes
from .layers import LayerNorm, Linear

NEG = -1e30


class TFLinear(Linear):
    """Dense layer with the transformer's inits: weight (in, out)
    U(+-gain*sqrt(6/(in+out))), bias U(+-sqrt(1/in)) or zero."""

    def __init__(self, in_dim: int, out_dim: int, gain: float = 1.0, zero_bias: bool = False):
        super().__init__(in_dim, out_dim)
        std = gain * math.sqrt(6.0 / (in_dim + out_dim))
        with torch.no_grad():
            self.weight.uniform_(-std, std)
            if zero_bias:
                self.bias.zero_()


def _rel_position_bias(q: torch.Tensor, pos_emb: torch.Tensor, bptt: int) -> torch.Tensor:
    """q (..., H, T, Dh), pos_emb (2*bptt, Dh) -> bias (..., H, T, T) with
    bias[i, j] = q_i . pos_emb[(j - i) + bptt] for j - i in [-bptt, bptt - 1]
    and zero outside that window. For T <= bptt only the reachable rows of
    the table are multiplied."""
    T = q.shape[-2]
    ar = torch.arange(T, device=q.device)
    rel = ar[None, :] - ar[:, None]  # j - i
    if T <= bptt:
        win = pos_emb[bptt - T + 1: bptt + T].to(q.dtype)  # offsets -(T-1)..T-1
        qp = torch.einsum("...td,rd->...tr", q, win)
        return qp.gather(-1, (rel + T - 1).expand(qp.shape[:-1] + (T,)))
    qp = torch.einsum("...td,rd->...tr", q, pos_emb.to(q.dtype))  # (..., T, 2*bptt)
    valid = (rel >= -bptt) & (rel <= bptt - 1)
    idx = (rel + bptt).clamp(0, 2 * bptt - 1)
    out = qp.gather(-1, idx.expand(qp.shape[:-1] + (T,)))
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _use_kernel(B: int, T: int, H: int, Dh: int, dtype: torch.dtype, device_type: str,
                backward: bool) -> bool:
    """Inside the JAX gate, whether attention takes the fused function. On
    the CPU it always does (its plain version takes any shape). On the card
    only where K4, and K4b when a gradient is wanted, take the shape; past
    their limits the unfused path computes the same function (in training
    with another dropout draw). A dispatch on the shape, so the wrappers
    keep raising on what their kernels do not take."""
    return device_type != "cuda" or mhsa_takes(B, T, H, Dh, dtype, backward)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, model_dim: int, head_dim: int, n_heads: int, bptt: int = 0,
                 dropout: float = 0.0, causal: bool = False, ops: SimpleNamespace = KERNELS):
        super().__init__()
        self.head_dim, self.n_heads, self.bptt = head_dim, n_heads, bptt
        self.dropout, self.causal, self.ops = dropout, causal, ops
        inner = n_heads * head_dim
        self.wq = TFLinear(model_dim, inner, 0.707)
        self.wk = TFLinear(model_dim, inner, 0.707)
        self.wv = TFLinear(model_dim, inner, 0.707)
        self.wf = TFLinear(inner, model_dim, 1.0, True)
        if bptt > 0:
            self.pos_emb = nn.Parameter(torch.empty(2 * bptt, head_dim).uniform_(-0.1, 0.1))
        else:
            self.pos_emb = None

    def fused(self, x: torch.Tensor) -> bool:
        """The gate of the fused function, as in the JAX package; on the card
        also whether the kernels take the shape (:func:`_use_kernel`)."""
        if self.causal or self.pos_emb is None or x.shape[-2] > self.bptt or x.dim() < 3:
            return False
        backward = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        return _use_kernel(math.prod(x.shape[:-2]), x.shape[-2], self.n_heads, self.head_dim,
                           x.dtype, x.device.type, backward)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (..., T, C); pad_mask (..., T) bool, True = valid."""
        H, Dh = self.n_heads, self.head_dim
        T = x.shape[-2]
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        rate = self.dropout if self.training else 0.0

        if self.fused(x):
            # the seed comes from the host's generator: no device round trip
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,))) if rate > 0.0 else 0
            win = self.pos_emb[self.bptt - T + 1: self.bptt + T]
            if pad_mask is not None:
                mask_bias = ((~pad_mask).float() * NEG).expand(x.shape[:-1])
            else:
                mask_bias = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
            nb = math.prod(x.shape[:-2])  # leading dims flattened: archs reach TR 4-d
            out = self.ops.mhsa(
                (q / math.sqrt(Dh)).reshape(nb, T, H * Dh), k.reshape(nb, T, H * Dh),
                v.reshape(nb, T, H * Dh), win, mask_bias.reshape(nb, T).contiguous(), H,
                rate, seed)
            return self.wf(out.reshape(x.shape[:-1] + (H * Dh,)))

        def split(a):  # (..., T, H*Dh) -> (..., H, T, Dh)
            return a.reshape(a.shape[:-1] + (H, Dh)).transpose(-2, -3)

        q, k, v = split(q) / math.sqrt(Dh), split(k), split(v)
        scores = q @ k.transpose(-1, -2)  # (..., H, T, T)
        if self.pos_emb is not None:
            scores = scores + _rel_position_bias(q, self.pos_emb, self.bptt)
        if self.causal and T > 1:
            cm = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~cm, NEG)
        if pad_mask is not None:
            scores = scores.masked_fill(~pad_mask[..., None, None, :], NEG)
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        attn = F.dropout(attn, self.dropout, self.training)
        out = (attn @ v).transpose(-2, -3).reshape(x.shape[:-1] + (H * Dh,))
        return self.wf(out)


def _layerdrop_scale(x: torch.Tensor, rate: float, training: bool):
    """1, or in training a 0/1 tensor on x's device: 0 with probability
    ``rate``. The layer still runs; its branch is scaled."""
    if not training or rate <= 0:
        return 1.0
    return (torch.rand((), device=x.device) >= rate).to(x.dtype)


def _residual_ln(ops: SimpleNamespace, ln: LayerNorm, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """``ln(x + y)`` for a LayerNorm over AF dims (0, 3): the fused residual
    LayerNorm where those dims reduce to the row, i.e. the stored leading
    axis of a 4-d input is 1."""
    if x.dim() == 4 and x.shape[0] != 1:
        return ln(x + y)
    C = x.shape[-1]
    out = ops.residual_ln(x.reshape(-1, C).contiguous(), y.reshape(-1, C).contiguous(),
                          ln.weight, ln.bias)[0]
    return out.view(x.shape)


class TransformerLayer(nn.Module):
    """Arch ``TR modelDim mlpDim nHead csz pDrop [pLayerdrop] [preLN] [futureMask]``."""

    needs_mask = True

    def __init__(self, model_dim: int, mlp_dim: int, n_heads: int, bptt: int,
                 dropout: float = 0.0, layerdrop: float = 0.0, pre_ln: bool = False,
                 causal: bool = False, ops: SimpleNamespace = KERNELS):
        super().__init__()
        self.dropout, self.layerdrop, self.pre_ln, self.ops = dropout, layerdrop, pre_ln, ops
        self.attn = MultiHeadSelfAttention(
            model_dim, model_dim // n_heads, n_heads, bptt, dropout, causal, ops)
        self.norm1 = LayerNorm((0, 3))
        self.norm2 = LayerNorm((0, 3))
        self.w1 = TFLinear(model_dim, mlp_dim)
        self.w2 = TFLinear(mlp_dim, model_dim)

    def _do(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.dropout, self.training)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        f = _layerdrop_scale(x, self.layerdrop, self.training)
        a = self._do(self.attn(x, mask))
        if self.pre_ln:
            h = f * self.norm1(a) + x
            m = self._do(self.w2(torch.relu(self.w1(h))))
            return f * self.norm2(m) + h
        h = _residual_ln(self.ops, self.norm1, x, f * a)
        m = self._do(self.w2(torch.relu(self.w1(h))))
        return _residual_ln(self.ops, self.norm2, h, f * m)


class ConformerLayer(nn.Module):
    """Arch ``CFR modelDim mlpDim nHead csz kernel pDrop [pLayerdrop] [LN|BN]``:
    macaron feed-forward halves with swish, self-attention with the relative
    bias, and the conv module (pointwise, GLU, depthwise conv over time, a norm,
    swish, pointwise). The conv module's norm is a LayerNorm (safe under
    padding) or a BatchNorm over the valid (batch, time) positions, whose
    running statistics are the buffers ``conv_bn_mean``/``conv_bn_var``."""

    needs_mask = True

    def __init__(self, model_dim: int, mlp_dim: int, n_heads: int, bptt: int,
                 conv_kernel: int, dropout: float = 0.0, layerdrop: float = 0.0,
                 conv_norm: str = "layernorm", ops: SimpleNamespace = KERNELS):
        super().__init__()
        C = model_dim
        self.dropout, self.layerdrop, self.conv_norm = dropout, layerdrop, conv_norm
        self.conv_kernel = conv_kernel
        for name in ("ffn1", "ffn2"):
            setattr(self, f"{name}_ln", LayerNorm((0, 3)))
            setattr(self, f"{name}_w1", TFLinear(C, mlp_dim))
            setattr(self, f"{name}_w2", TFLinear(mlp_dim, C))
        self.attn_ln = LayerNorm((0, 3))
        self.attn = MultiHeadSelfAttention(C, C // n_heads, n_heads, bptt, dropout, ops=ops)
        self.conv_ln = LayerNorm((0, 3))
        self.conv_pw1 = TFLinear(C, 2 * C)
        self.conv_dw = nn.Parameter(torch.randn(conv_kernel, C) * math.sqrt(2.0 / conv_kernel))
        if conv_norm == "batchnorm":
            self.conv_bn_weight = nn.Parameter(torch.ones(C))
            self.conv_bn_bias = nn.Parameter(torch.zeros(C))
            self.register_buffer("conv_bn_mean", torch.zeros(C))
            self.register_buffer("conv_bn_var", torch.ones(C))
        else:
            self.conv_bn = LayerNorm((0, 3))
        self.conv_pw2 = TFLinear(C, C)
        self.final_ln = LayerNorm((0, 3))

    def _do(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.dropout, self.training)

    def _ffn(self, h: torch.Tensor, name: str) -> torch.Tensor:
        h = getattr(self, f"{name}_w1")(getattr(self, f"{name}_ln")(h))
        h = self._do(h * torch.sigmoid(h))  # swish
        return self._do(getattr(self, f"{name}_w2")(h))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        f = _layerdrop_scale(x, self.layerdrop, self.training)
        x = x + f * 0.5 * self._ffn(x, "ffn1")
        x = x + f * self._do(self.attn(self.attn_ln(x), mask))
        x = x + f * self._conv_module(x, mask)
        x = x + f * 0.5 * self._ffn(x, "ffn2")
        return self.final_ln(x)

    def _conv_module(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        K = self.conv_kernel
        h = self.conv_ln(x)
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        a, b = self.conv_pw1(h).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)  # GLU
        # depthwise conv over time on (N, C, T), SAME pads
        T, C = h.shape[-2:]
        hh = F.pad(h.reshape(-1, T, C).transpose(1, 2), ((K - 1) // 2, K - 1 - (K - 1) // 2))
        y = F.conv1d(hh, self.conv_dw.to(h.dtype).t()[:, None, :], groups=C)
        h = y.transpose(1, 2).reshape(h.shape)
        if self.conv_norm == "batchnorm":
            h = self._masked_batchnorm(h, mask)
        else:
            h = self.conv_bn(h)
        h = h * torch.sigmoid(h)
        return self._do(self.conv_pw2(h))

    def _masked_batchnorm(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                          momentum: float = 0.9, eps: float = 1e-5) -> torch.Tensor:
        """Per-channel BatchNorm over the valid (batch, time) positions only,
        so padded frames do not enter the batch statistics."""
        hf = h.float()
        red = tuple(range(h.dim() - 1))
        if self.training:
            if mask is not None:
                m = mask[..., None].float().expand(h.shape[:-1] + (1,))
                cnt = m.sum(dim=red).clamp(min=1.0)
                mean = (hf * m).sum(dim=red) / cnt
                var = ((hf - mean).square() * m).sum(dim=red) / cnt
            else:
                mean = hf.mean(dim=red)
                var = hf.var(dim=red, unbiased=False)
            with torch.no_grad():
                self.conv_bn_mean.mul_(momentum).add_((1 - momentum) * mean)
                self.conv_bn_var.mul_(momentum).add_((1 - momentum) * var)
        else:
            mean, var = self.conv_bn_mean, self.conv_bn_var
        y = (hf - mean) * torch.rsqrt(var + eps) * self.conv_bn_weight + self.conv_bn_bias
        return y.to(h.dtype)
