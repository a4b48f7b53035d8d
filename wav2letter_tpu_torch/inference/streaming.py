"""Chunked streaming inference (wav2letter@anywhere) — the port of
``wav2letter_tpu/inference/streaming.py``.

The reference streams audio through stateful modules with a
``start/run/finish`` protocol: ``start`` applies left padding, ``run``
consumes whole frames and keeps remainders, ``finish`` flushes right padding.
Here each layer's state is the tail of its input it still needs, and a step
is the batch layer's own computation on the window ``state ⧺ chunk`` with no
pads, because the state carries them: the same parameters, the same
re-indexing (``TDSBlock._weights``, kept by ``_derived``) and the same route
(K2 where ``Conv2D.time_only`` says so, else ``F.conv2d``; K3 for the TDS
LayerNorms). A stream therefore gives the batch forward's emissions.

Activations are (B, n, F, C) and contiguous, which is the f-major chain
layout (B, n, F*C) of the batch model. Streaming runs in fp32 with TF32 off,
as the JAX package pins ``Precision.HIGHEST``: reduced-precision error depends
on the shapes, and chunked steps would part from the batch forward.

Layers: PD+C2/C/AC (a time conv), TDS, LN (per frame), L, R; V, RO, DO and
SAUG are skipped (``convert.py``). The frontend is K1 on each chunk with
pre-emphasis carried across chunks and a running local CMVN.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..features.frontend import FeatureParams, Featurizer
from ..kernels import disable_tf32
from ..models.layers import Conv2D, TDSBlock, from_chain, to_chain
from ..runtime.test import resolve_device


# ---------------------------------------------------------------------------
# streaming featurizer
# ---------------------------------------------------------------------------
class StreamingFeaturizer:
    """Buffers raw samples and emits whole MFSC frames per chunk (reference
    ``LogMelFeature::run`` consumes numFrames*stride samples and keeps the
    tail). Pre-emphasis is applied on arrival, continuous across chunks; K1
    runs through a ``Featurizer`` with pre-emphasis and local norm off; then
    a running local CMVN over ``local_norm_left`` frames of history
    (reference ``LocalNorm``), in float64 on the device.

    A ``local_norm_right`` context would need frames that have not arrived;
    it raises."""

    def __init__(self, params: FeatureParams, device: str = "cuda"):
        if params.local_norm_right > 0:
            raise ValueError(
                f"streaming local norm takes left context only; local_norm_right="
                f"{params.local_norm_right} needs future frames")
        self.p = params
        self.device = resolve_device(device)
        disable_tf32()
        self.featurizer = Featurizer(dataclasses.replace(
            params, preem_coef=0.0, local_norm_left=0, local_norm_right=0)).to(self.device)

    def start(self) -> Dict[str, Any]:
        state = {"samples": np.zeros((0,), np.float32), "last_sample": np.float32(0.0),
                 "first": True}
        if self.p.local_norm_left > 0:
            state["ln_hist"] = torch.zeros((0, self.p.n_filterbanks), dtype=torch.float64,
                                           device=self.device)
        return state

    @torch.no_grad()
    def run(self, state: Dict[str, Any], samples: np.ndarray
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """samples: 1-d float audio. Returns (state, feats (n, n_filterbanks)
        float32 on the device), n >= 0."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if len(samples):
            prev = np.concatenate([[state["last_sample"]], samples[:-1]])
            pre = samples - self.p.preem_coef * prev
            if state["first"]:
                pre[0] = samples[0]  # the reference keeps x[0] unchanged
                state["first"] = False
            state["last_sample"] = samples[-1]
            samples = pre
        buf = np.concatenate([state["samples"], samples])
        fs, ss = self.p.frame_samples, self.p.stride_samples
        n_frames = 1 + (len(buf) - fs) // ss if len(buf) >= fs else 0
        if n_frames == 0:
            state["samples"] = buf
            return state, torch.zeros((0, self.p.n_filterbanks), device=self.device)
        used = fs + (n_frames - 1) * ss
        audio = torch.from_numpy(buf[:used]).to(self.device)
        feats = self.featurizer(audio[None])[0][0]
        state["samples"] = buf[n_frames * ss:]
        if self.p.local_norm_left > 0:
            feats = self._local_norm(state, feats)
        return state, feats

    def finish(self, state: Dict[str, Any]) -> Tuple[Dict[str, Any], torch.Tensor]:
        return state, torch.zeros((0, self.p.n_filterbanks), device=self.device)

    def _local_norm(self, state: Dict[str, Any], feats: torch.Tensor) -> torch.Tensor:
        """Frame j of ``history ⧺ feats`` over frames max(0, j-ctx)..j, as
        the JAX loop: E[x^2] - E[x]^2 in float64, then sqrt(var + 1e-10);
        here one pass of cumulative sums over the window."""
        ctx = self.p.local_norm_left
        hist = torch.cat([state["ln_hist"], feats.double()])
        h, n = len(state["ln_hist"]), len(feats)
        zero = hist.new_zeros((1, hist.shape[1]))
        cs = torch.cat([zero, hist.cumsum(0)])
        cs2 = torch.cat([zero, (hist * hist).cumsum(0)])
        hi = torch.arange(h + 1, h + n + 1, device=hist.device)
        lo = torch.clamp(hi - 1 - ctx, min=0)
        cnt = (hi - lo).double()[:, None]
        mean = (cs[hi] - cs[lo]) / cnt
        var = torch.clamp((cs2[hi] - cs2[lo]) / cnt - mean * mean, min=0.0)
        state["ln_hist"] = hist[-ctx:]
        return ((hist[h:] - mean) / torch.sqrt(var + 1e-10)).float()


# ---------------------------------------------------------------------------
# streaming layers
# ---------------------------------------------------------------------------
class StreamLayer:
    """Base: ``start(batch)`` -> state; ``step(state, x (B, n, F, C))`` ->
    (state, y); ``flush_frames`` zero frames of right padding at finish.
    ``module`` holds the batch layer whose parameters the step uses."""

    name: str = ""
    module: Optional[nn.Module] = None

    def start(self, batch: int, device: torch.device) -> Optional[torch.Tensor]:
        return None

    def out_frames(self, state_frames: int, in_frames: int) -> Tuple[int, int]:
        """(output frames, state frames after) for these frame counts."""
        return in_frames, state_frames

    def step(self, state, x: torch.Tensor):
        return state, x

    def flush_frames(self) -> int:
        return 0

    def load(self, params: Dict[str, Any]) -> List[str]:
        """Copy this layer's entries of the flat param dict into ``module``;
        returns the keys it took."""
        return []


def _copy(param: torch.Tensor, value: Any) -> None:
    v = value if torch.is_tensor(value) else torch.from_numpy(np.array(value, np.float32))
    if tuple(v.shape) != tuple(param.shape):
        raise ValueError(f"param of shape {tuple(param.shape)} got {tuple(v.shape)}")
    param.data.copy_(v)


def _window(state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``state ⧺ x`` along time, contiguous."""
    return torch.cat([state, x], dim=1) if x.shape[1] else state.contiguous()


class StreamConv(StreamLayer):
    """A time convolution (PD+C2, C, AC) whose left pad is the initial state
    and whose right pad is flushed at finish (reference ``Conv1dFbGemm``).
    Input (B, n, H, in_ch), H the frequency extent; the step is ``conv``'s
    K2 (``Conv2D.chain``) where it is time-only, else ``Conv2D.general``
    (``F.conv2d``), both with no time pads."""

    def __init__(self, name: str, conv: Conv2D, pad_left: int, pad_right: int,
                 freq_dim: int):
        self.name, self.module = name, conv
        self.pad_left, self.pad_right, self.freq_dim = pad_left, pad_right, freq_dim
        self.kw, self.stride = conv.wx, conv.sx

    def start(self, batch, device):
        return torch.zeros((batch, self.pad_left, self.freq_dim, self.module.in_ch),
                           device=device)

    def out_frames(self, state_frames, in_frames):
        m = state_frames + in_frames
        if m < self.kw:
            return 0, m
        n_out = (m - self.kw) // self.stride + 1
        return n_out, m - n_out * self.stride

    def step(self, state, x):
        buf = _window(state, x)
        B, m, H, C = buf.shape
        n_out, _ = self.out_frames(m, 0)
        conv = self.module
        if n_out == 0:
            return buf, buf.new_zeros((B, 0, self._out_h(), conv.out_ch))
        if conv.time_only:
            y = conv.chain(buf.view(B, m, H * C), H, (0, 0)).view(B, n_out, H, conv.out_ch)
        else:
            y = conv.general(buf.permute(0, 3, 2, 1), (0, 0)).permute(0, 3, 2, 1).contiguous()
        return buf[:, n_out * self.stride:], y

    def _out_h(self) -> int:
        c = self.module
        return (self.freq_dim + 2 * c.py - c.wy) // c.sy + 1

    def flush_frames(self):
        return self.pad_right

    def load(self, params):
        keys = [f"{self.name}_w"] + ([f"{self.name}_b"] if self.module.bias is not None else [])
        _copy(self.module.weight, params[keys[0]])
        if len(keys) > 1:
            _copy(self.module.bias, params[keys[1]])
        return keys


class StreamTDS(StreamLayer):
    """A TDS block (reference ``TDSBlock``): only its conv needs carry state.
    The state holds raw inputs, so the step runs ``TDSBlock.chain`` on the
    window with no pads and the residual on the input frames the outputs
    align with, ``buf[:, pad_left:pad_left + n_out]``. The LayerNorms are
    per frame over (F, C), K3 on rows of F*C."""

    PARAMS = (("conv_w", "conv.weight"), ("conv_b", "conv.bias"), ("ln1_w", "ln1.weight"),
              ("ln1_b", "ln1.bias"), ("lin1_w", "lin1.weight"), ("lin1_b", "lin1.bias"),
              ("lin2_w", "lin2.weight"), ("lin2_b", "lin2.bias"), ("ln2_w", "ln2.weight"),
              ("ln2_b", "ln2.bias"))

    def __init__(self, name: str, block: TDSBlock):
        self.name, self.module = name, block
        self.pad_left, self.pad_right = block.time_pads
        self.kernel = block.w

    def start(self, batch, device):
        b = self.module
        return torch.zeros((batch, self.pad_left, b.f, b.c), device=device)

    def out_frames(self, state_frames, in_frames):
        m = state_frames + in_frames
        if m < self.kernel:
            return 0, m
        n_out = m - self.kernel + 1
        return n_out, m - n_out

    def step(self, state, x):
        buf = _window(state, x)
        B, m, Fq, C = buf.shape
        n_out, _ = self.out_frames(m, 0)
        if n_out == 0:
            return buf, buf.new_zeros((B, 0, Fq, C))
        z = buf.view(B, m, Fq * C)
        y = self.module.chain(z, (0, 0), z[:, self.pad_left:self.pad_left + n_out])
        return buf[:, n_out:], y.view(B, n_out, Fq, C)

    def flush_frames(self):
        return self.pad_right

    def load(self, params):
        mod = dict(self.module.named_parameters())
        for key, attr in self.PARAMS:
            _copy(mod[attr], params[f"{self.name}_{key}"])
        return [f"{self.name}_{key}" for key, _ in self.PARAMS]


class StreamPointwise(StreamLayer):
    """Stateless per-frame ops: ``relu``; ``ln``, a batch ``LayerNorm`` over
    AF dims 1 and 2 (per frame over (F, C)); ``linear``, a batch ``Linear``
    on the flattened F*C (f-major, as the batch model's ``RO 2 1 0 3`` and
    ``V`` leave it), output (B, n, 1, out); ``reshape`` to ``out_shape``."""

    def __init__(self, name: str, kind: str, module: Optional[nn.Module] = None,
                 out_shape: Optional[Tuple[int, int]] = None):
        self.name, self.kind, self.module = name, kind, module  # kind: relu|ln|linear|reshape
        self.out_shape = out_shape  # (F, C) after reshape

    def step(self, state, x):
        B, n, Fq, C = x.shape
        if n == 0 and self.kind == "linear":
            return state, x.new_zeros((B, 0, 1, self.module.weight.shape[1]))
        if n == 0 and self.kind in ("relu", "ln"):
            return state, x
        if self.kind == "relu":
            return state, torch.relu(x)
        if self.kind == "ln":
            return state, to_chain(self.module(from_chain(x.reshape(B, n, Fq * C), C))
                                   ).view(x.shape)
        if self.kind == "linear":
            return state, self.module(x.reshape(B, n, Fq * C))[:, :, None, :]
        if self.kind == "reshape":
            return state, x.reshape((B, n) + tuple(self.out_shape))
        raise ValueError(self.kind)

    def load(self, params):
        if self.module is None:
            return []
        keys = [f"{self.name}_w"]
        _copy(self.module.weight, params[keys[0]])
        if self.module.bias is not None:
            keys.append(f"{self.name}_b")
            _copy(self.module.bias, params[keys[1]])
        return keys


# ---------------------------------------------------------------------------
# the streaming network
# ---------------------------------------------------------------------------
class StreamingNetwork:
    """Composes stream layers; ``start/run/finish`` as the reference.

    ``params`` is the flat dict of the JAX streaming params (``map_params``:
    OIHW conv weights with weight norm folded, C-major TDS linears, scalar
    LayerNorm affines), arrays or tensors; every entry is copied into the
    layers' modules, on ``device`` in fp32, and every parameter must be
    covered. Each step runs eagerly, without autograd."""

    def __init__(self, layers: Sequence[StreamLayer], params: Dict[str, Any],
                 device: str = "cuda"):
        self.device = resolve_device(device)
        disable_tf32()
        self.layers = list(layers)
        taken = set()
        for layer in self.layers:
            if layer.module is not None:
                layer.module.to_empty(device=self.device).float().eval()
                layer.module.requires_grad_(False)
            taken.update(layer.load(params))
        extra = sorted(set(params) - taken)
        if extra:
            raise KeyError(f"streaming params not used by any layer: {extra}")

    def start(self, batch: int = 1) -> List[Optional[torch.Tensor]]:
        return [layer.start(batch, self.device) for layer in self.layers]

    @torch.no_grad()
    def run(self, states: List[Optional[torch.Tensor]], chunk
            ) -> Tuple[List[Optional[torch.Tensor]], torch.Tensor]:
        """chunk (B, n, F, C), array or tensor. Returns (states, out (B,
        n_out, F', C') on the device)."""
        x = torch.as_tensor(chunk, dtype=torch.float32).to(self.device)
        states = list(states)
        for i, layer in enumerate(self.layers):
            states[i], x = layer.step(states[i], x)
        return states, x

    @torch.no_grad()
    def finish(self, states: List[Optional[torch.Tensor]]
               ) -> Tuple[List[Optional[torch.Tensor]], Optional[torch.Tensor]]:
        """Flush each layer's right pad as zero frames at its input and push
        the result through the layers after it, layer by layer (reference
        finish). Returns (states, out or None when no frame came out)."""
        states = list(states)
        B = next((s.shape[0] for s in states if s is not None), 1)
        outs = []
        for i, layer in enumerate(self.layers):
            f = layer.flush_frames()
            if f == 0:
                continue
            st = states[i]
            states[i], y = layer.step(st, st.new_zeros((B, f) + tuple(st.shape[2:])))
            for j in range(i + 1, len(self.layers)):
                states[j], y = self.layers[j].step(states[j], y)
            if y.shape[1] > 0:
                outs.append(y)
        return states, (torch.cat(outs, dim=1) if outs else None)
