"""Seq2seq criterions: the GRU attention decoder (``--criterion=seq2seq``) and
the transformer decoder (``--criterion=transformer``), the port of
``wav2letter_tpu/criterions/seq2seq.py``.

Both take the encoder's states (``--encoderdim`` wide, or twice that for
``--attention=keyvalue``), the targets and their lengths, and return the
per-sample losses of the teacher-forced decoder: label smoothing over all
classes, the eos step scored, ``scale_losses(..., target_len + 1)``.
``decode_step`` advances a batch of hypotheses by one token (the beam's step,
``decoder/seq2seq_beam.py``), ``greedy_path`` decodes greedily (the train- and
test-time Viterbi).

Parameters keep flax's names and layouts, so a JAX criterion's param tree
converts by renaming its paths (``runtime/checkpoint.py``): ``Dense`` holds
``kernel`` (in, out) and ``bias``, ``Embed`` its ``embedding`` (N, hidden),
``LayerNorm`` ``scale`` and ``bias`` (eps 1e-6). The GRU cell is flax's six
dense parts ``ir``, ``iz``, ``in`` (with a bias), ``hr``, ``hz`` (without) and
``hn`` (with): ``nn.GRUCell`` would add biases that flax does not have.

The masks are JAX's finite -1e30, and a row that the window leaves with no
allowed frame allows every frame. The decoders' attentions are plain
products and softmax, as in JAX (no Pallas kernel there, so none here).
Random draws (scheduled sampling, ``--decoderdropout``, the transformer's
dropout and layerdrop) come from the device's global generator, which the
trainer seeds for each update.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import column_parallel
from .base import CriterionScaleMode, get_scale_mode, scale_losses

NEG = -1e30


def _sinusoid(L: int, C: int) -> np.ndarray:
    """The (L, C) sinusoid position table, built in float64 as in JAX."""
    pos = np.arange(L)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, C, 2) * (-math.log(10000.0) / C))
    pe = np.zeros((L, C))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe


@dataclasses.dataclass(frozen=True)
class S2SConfig:
    n_classes: int
    eos_idx: int
    pad_idx: int
    hidden: int = 256
    n_layers: int = 1
    n_rounds: int = 1  # --decoderattnround: chained (GRU stack + attention) rounds
    attention: str = "content"  # content|keyvalue|neural
    attn_window: str = "no"
    train_with_window: bool = False
    pretrain_window: int = 0
    pct_teacher_forcing: float = 100.0
    sampling_strategy: str = "rand"
    gumbel_temperature: float = 1.0
    label_smooth: float = 0.0
    dropout: float = 0.0
    max_decoder_output_len: int = 200
    window_left: int = 50
    window_right: int = 50
    softw_offset: float = 10.0
    softw_rate: float = 5.0
    softw_std: float = 5.0

    @classmethod
    def from_flags(cls, cfg, n_classes: int) -> "S2SConfig":
        return cls(
            n_classes=n_classes,
            eos_idx=n_classes - 2,
            pad_idx=n_classes - 1,
            hidden=cfg.encoderdim or 256,
            n_layers=max(1, cfg.decoderrnnlayer),
            n_rounds=max(1, cfg.decoderattnround),
            attention={"content": "content", "keyvalue": "keyvalue"}.get(
                cfg.attention, "neural"),
            attn_window=cfg.attnWindow,
            train_with_window=cfg.trainWithWindow,
            pretrain_window=cfg.pretrainWindow,
            pct_teacher_forcing=cfg.pctteacherforcing,
            sampling_strategy=cfg.samplingstrategy,
            gumbel_temperature=cfg.gumbeltemperature or 1.0,
            label_smooth=cfg.labelsmooth,
            dropout=cfg.decoderdropout,
            max_decoder_output_len=cfg.maxdecoderoutputlen,
            window_left=cfg.leftWindowSize,
            window_right=cfg.rightWindowSize,
            softw_offset=cfg.softwoffset,
            softw_rate=cfg.softwrate,
            softw_std=cfg.softwstd,
        )


def window_mask(kind: str, step_idx, T: int, prev_peak: torch.Tensor,
                c: S2SConfig) -> Optional[torch.Tensor]:
    """The frames an output step may attend to, (B or U, T) bool, or None
    where ``kind`` sets no window. ``step_idx`` is an int or a (U, 1) tensor;
    ``prev_peak`` (B,) the last step's attention peak (``median`` only)."""
    t_idx = torch.arange(T, device=prev_peak.device)[None, :]
    if kind == "median":
        lo = prev_peak[:, None] - c.window_left
        hi = prev_peak[:, None] + c.window_right
        return (t_idx >= lo) & (t_idx <= hi)
    if kind == "step":
        lo = step_idx * c.softw_rate - c.softw_offset
        hi = step_idx * c.softw_rate + c.softw_offset
        return (t_idx >= lo) & (t_idx <= hi)
    if kind in ("soft", "softPretrain"):
        center = c.softw_offset + step_idx * c.softw_rate
        w = torch.exp(-((t_idx - center) ** 2) / (2 * c.softw_std * c.softw_std))
        return w > 1e-4
    return None


def _lecun_normal(in_dim: int, out_dim: int) -> torch.Tensor:
    """flax's default kernel init: a normal of variance 1/fan_in truncated at
    two standard deviations."""
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(in_dim, out_dim), std=std, a=-2 * std, b=2 * std)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel (in, out). Under
    tensor parallelism (``tp``, set by ``parallel.shard_params``) the kernel
    holds this rank's output columns, as ``models.layers.Linear``'s weight."""

    TP_PARAMS = ("kernel",)
    tp = None

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 init: str = "lecun"):
        super().__init__()
        if init == "zeros":
            w = torch.zeros(in_dim, out_dim)
        elif init == "orthogonal":
            w = nn.init.orthogonal_(torch.empty(in_dim, out_dim))
        else:
            w = _lecun_normal(in_dim, out_dim)
        self.kernel = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            y = column_parallel(x, self.kernel.to(x.dtype), self.tp)
            return y if self.bias is None else y + self.bias.to(x.dtype)
        # one GEMM with the bias in its epilogue: a decoder step is launch-bound
        return F.linear(x, self.kernel.to(x.dtype).t(),
                        None if self.bias is None else self.bias.to(x.dtype))


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding`` (N, hidden)."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(n, dim) / math.sqrt(dim))

    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        return F.embedding(tok.long(), self.embedding)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``scale``, ``bias``, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale.to(x.dtype), self.bias.to(x.dtype),
                            eps=1e-6)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell`` from its six dense parts:
    ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``,
    ``n = tanh(in(x) + r·hn(h))``, ``h' = (1 - z)·n + z·h``."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(in_dim, hidden))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, Dense(hidden, hidden, use_bias=bias, init="orthogonal"))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


def _nll(c: S2SConfig, scale_mode: CriterionScaleMode, logits: torch.Tensor,
         tgt_in: torch.Tensor, target_len: torch.Tensor,
         emis_len: torch.Tensor) -> torch.Tensor:
    """Per-sample teacher-forced losses: the targets then eos scored, label
    smoothing over all classes, scaled by ``target_len + 1``."""
    B, U1, _ = logits.shape
    u_idx = torch.arange(U1, device=logits.device)[None, :]
    pad = torch.full((B, 1), c.pad_idx, dtype=tgt_in.dtype, device=tgt_in.device)
    gold = torch.cat([tgt_in, pad], dim=1)[:, :U1]
    tl = target_len.to(logits.device)[:, None]
    gold = torch.where(u_idx == tl, torch.full_like(gold, c.eos_idx), gold)
    valid = u_idx <= tl
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, gold[..., None].long())[..., 0]
    if c.label_smooth > 0:
        nll = (1 - c.label_smooth) * nll + c.label_smooth * (-logp.mean(-1))
    losses = torch.where(valid, nll, torch.zeros_like(nll)).sum(dim=1)
    return scale_losses(losses, scale_mode, emis_len, target_len + 1)


def _prepare(c: S2SConfig, emissions, targets, emis_len):
    """The encoder mask (B, T), the targets with pad for -1, and the decoder's
    input: eos, then the targets (B, U + 1)."""
    B, T, _ = emissions.shape
    dev = emissions.device
    enc_mask = torch.arange(T, device=dev)[None, :] < emis_len.to(dev)[:, None]
    targets = targets.to(dev).long()
    tgt_in = torch.where(targets < 0, torch.full_like(targets, c.pad_idx), targets)
    sos = torch.full((B, 1), c.eos_idx, dtype=torch.long, device=dev)
    return enc_mask, tgt_in, torch.cat([sos, tgt_in], dim=1)


def _greedy(crit, emissions: torch.Tensor, emis_len: torch.Tensor,
            check_every: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode to ``max_decoder_output_len`` steps through
    ``crit.decode_step``: tokens (B, L) and lengths (B,). It stops once every
    row has emitted eos (checked every ``check_every`` steps, one host sync
    each) and fills the rest with pad, which is what the fixed-length scan of
    JAX emits there."""
    c = crit.cfg
    B, T, _ = emissions.shape
    dev = emissions.device
    enc_mask = torch.arange(T, device=dev)[None, :] < emis_len.to(dev)[:, None]
    L = c.max_decoder_output_len
    state = crit.init_state(B, emissions.dtype, dev)
    prev = torch.full((B,), c.eos_idx, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    toks = torch.full((B, L), c.pad_idx, dtype=torch.long, device=dev)
    for u in range(L):
        state, logits = crit.decode_step(state, prev, emissions, enc_mask, u)
        tok = torch.where(done, torch.full_like(prev, c.pad_idx), logits.argmax(-1))
        done = done | (tok == c.eos_idx)
        toks[:, u] = tok
        prev = tok
        if (u + 1) % check_every == 0 and bool(done.all()):
            break
    is_end = (toks == c.eos_idx) | (toks == c.pad_idx)
    lengths = torch.where(is_end.any(dim=1), is_end.int().argmax(dim=1),
                          torch.full((B,), L, device=dev))
    return toks.int(), lengths.int()


class Seq2SeqCriterion(nn.Module):
    """The GRU attention decoder (flashlight's Seq2SeqCriterion)."""

    def __init__(self, cfg: S2SConfig,
                 scale_mode: CriterionScaleMode = CriterionScaleMode.NONE):
        super().__init__()
        c = self.cfg = cfg
        self.scale_mode = scale_mode
        self.embedding = Embed(c.n_classes, c.hidden)
        # one GRU stack and one attention a round; round 0 keeps flax's names
        self.cell_names = [f"gru{i}" if r == 0 else f"gru_r{r}_{i}"
                           for r in range(c.n_rounds) for i in range(c.n_layers)]
        for name in self.cell_names:
            self.add_module(name, GRUCell(c.hidden, c.hidden))
        self.out = Dense(c.hidden, c.n_classes)
        if c.attention == "neural":
            for r in range(c.n_rounds):
                sfx = "" if r == 0 else f"_r{r}"
                self.add_module("attn_w" + sfx, Dense(2 * c.hidden, c.hidden))
                self.add_module("attn_v" + sfx, Dense(c.hidden, 1))

    @classmethod
    def from_config(cls, cfg, n_classes: int) -> "Seq2SeqCriterion":
        return cls(S2SConfig.from_flags(cfg, n_classes),
                   get_scale_mode(cfg.onorm, cfg.sqnorm))

    # -- attention ---------------------------------------------------------
    def _attend(self, query, enc, mask, rnd: int = 0):
        c = self.cfg
        if c.attention == "neural":
            sfx = "" if rnd == 0 else f"_r{rnd}"
            q = query[:, None].expand(-1, enc.shape[1], -1)
            h = torch.tanh(getattr(self, "attn_w" + sfx)(torch.cat([q, enc], dim=-1)))
            scores = getattr(self, "attn_v" + sfx)(h)[..., 0]
            values = enc
        else:
            if c.attention == "keyvalue":
                keys, values = torch.chunk(enc, 2, dim=-1)
            else:
                keys = values = enc
            if keys.shape[-1] != query.shape[-1]:
                raise ValueError(
                    f"{c.attention} attention: keys of {keys.shape[-1]} channels (of the "
                    f"encoder's {enc.shape[-1]}) against a query of hidden = --encoderdim = "
                    f"{query.shape[-1]}; a keyvalue arch must end in 2 x --encoderdim")
            scores = torch.einsum("bh,bth->bt", query, keys) / math.sqrt(keys.shape[-1])
        scores = torch.where(mask, scores, NEG)
        attn = torch.softmax(scores, dim=-1)
        return torch.einsum("bt,bth->bh", attn, values), attn

    # -- one decoder step --------------------------------------------------
    def decode_step(self, state, tok, enc, enc_mask, step_idx, windowed=False,
                    dropout=False):
        """``state`` = (hiddens tuple [n_rounds * n_layers], previous peak);
        returns (state, logits). Per round: the round's GRU stack, then its
        attention summary added to x; the logits from the shared ``out``."""
        state, x = self.decode_step_core(state, tok, enc, enc_mask, step_idx, windowed,
                                         dropout)
        return state, self.out(x)

    def decode_step_core(self, state, tok, enc, enc_mask, step_idx, windowed=False,
                         dropout=False):
        """``decode_step`` without the output projection: (state, x), x the
        pre-logit hidden, so that the teacher-forced loop does the projection
        once for all steps. ``dropout``: ``--decoderdropout`` on each round's
        GRU output (training)."""
        c = self.cfg
        hiddens, prev_peak = state
        x = self.embedding(tok)
        mask = enc_mask
        if windowed and c.attn_window != "no":
            wm = window_mask(c.attn_window, step_idx, enc.shape[1], prev_peak, c)
            if wm is not None:
                mask = mask & wm
        mask = mask | ~mask.any(dim=-1, keepdim=True)
        new_h = []
        a = None
        for r in range(c.n_rounds):
            for i in range(c.n_layers):
                k = r * c.n_layers + i
                x = getattr(self, self.cell_names[k])(hiddens[k], x)
                new_h.append(x)
            if dropout and c.dropout > 0:
                keep = 1.0 - c.dropout
                m = torch.rand(x.shape, device=x.device) < keep
                x = torch.where(m, x / keep, torch.zeros_like(x))
            summary, a = self._attend(x, enc, mask, rnd=r)
            x = summary + x
        peak = a.argmax(dim=-1).int()
        return (tuple(new_h), peak), x

    def init_state(self, batch: int, dtype=torch.float32, device=None):
        c = self.cfg
        device = device if device is not None else self.out.kernel.device
        hiddens = tuple(torch.zeros(batch, c.hidden, dtype=dtype, device=device)
                        for _ in range(c.n_rounds * c.n_layers))
        return hiddens, torch.zeros(batch, dtype=torch.int32, device=device)

    # -- training loss -----------------------------------------------------
    def forward(self, emissions, targets, emis_len, target_len,
                train: Optional[bool] = None, window: bool = False):
        """Per-sample losses (B,). ``train`` (default: the module's mode)
        enables scheduled sampling and dropout; ``window``: the attention
        window is on for this update (the trainer's gate)."""
        logits, tgt_in = self.teacher_forced(emissions, targets, emis_len, train, window)
        return _nll(self.cfg, self.scale_mode, logits, tgt_in, target_len, emis_len)

    def teacher_forced(self, emissions, targets, emis_len, train: Optional[bool] = None,
                       window: bool = False):
        """The decoder's logits (B, U + 1, N) on eos then the targets, and
        the targets with pad for -1 (B, U)."""
        c = self.cfg
        train = self.training if train is None else train
        B = emissions.shape[0]
        U = targets.shape[1]
        enc_mask, tgt_in, dec_in = _prepare(c, emissions, targets, emis_len)
        use_window = window and train and c.attn_window not in ("no", "")
        drop = train and c.dropout > 0
        # pure teacher forcing: the hidden -> vocab projection leaves the loop
        # as one (B*(U+1), hidden) product; scheduled sampling needs the
        # logits in the loop (the sampled token feeds the next step)
        sample = train and c.pct_teacher_forcing < 100.0
        step = self.decode_step if sample else self.decode_step_core
        state = self.init_state(B, emissions.dtype, emissions.device)
        prev = dec_in[:, 0]
        ys = []
        for u in range(U + 1):
            state, y = step(state, prev, emissions, enc_mask, u, windowed=use_window,
                            dropout=drop)
            prev = dec_in[:, min(u + 1, U)]
            if sample:
                use_tf = torch.rand(B, device=y.device) < c.pct_teacher_forcing / 100.0
                if c.sampling_strategy == "model":
                    sampled = y.argmax(dim=-1)
                elif c.sampling_strategy == "gumbel":
                    g = -torch.log(-torch.log(torch.rand(y.shape, device=y.device)
                                              .clamp(min=1e-20)))
                    sampled = (y.float() / c.gumbel_temperature + g).argmax(dim=-1)
                else:
                    sampled = torch.randint(0, c.n_classes, (B,), device=y.device)
                prev = torch.where(use_tf, prev, sampled)
            ys.append(y)
        ys = torch.stack(ys, dim=1)  # (B, U+1, hidden | N)
        return (ys if sample else self.out(ys)), tgt_in

    # -- greedy ("viterbi") decode ----------------------------------------
    def greedy_path(self, emissions, emis_len):
        return _greedy(self, emissions, emis_len)


class TransformerS2SCriterion(nn.Module):
    """The transformer attention decoder (flashlight's TransformerCriterion;
    ``--am_decoder_tr_layers`` layers of 4 heads). It takes encoder states
    ``enc_dim`` wide (0: ``hidden``, ``--encoderdim``): flax sizes ``ck``/``cv``
    from the first input it sees, the port from the arch's output width
    (``models.arch.output_width``), which the runtimes pass."""

    def __init__(self, cfg: S2SConfig,
                 scale_mode: CriterionScaleMode = CriterionScaleMode.NONE,
                 n_tr_layers: int = 2, n_heads: int = 4, tr_dropout: float = 0.0,
                 tr_layerdrop: float = 0.0, enc_dim: int = 0):
        super().__init__()
        c = self.cfg = cfg
        self.scale_mode = scale_mode
        self.n_tr_layers, self.n_heads = n_tr_layers, n_heads
        self.tr_dropout, self.tr_layerdrop = tr_dropout, tr_layerdrop
        D = c.hidden
        E = enc_dim or D
        self.embedding = Embed(c.n_classes, D)
        self.out = Dense(D, c.n_classes)
        # the residual branches' output projections start at zero: the decoder
        # starts as out(emb + pos)
        for i in range(n_tr_layers):
            for name, in_dim, init in (("sq", D, "lecun"), ("sk", D, "lecun"),
                                       ("sv", D, "lecun"), ("so", D, "zeros"),
                                       ("cq", D, "lecun"), ("ck", E, "lecun"),
                                       ("cv", E, "lecun"), ("co", D, "zeros")):
                self.add_module(f"{name}{i}", Dense(in_dim, D, init=init))
            for name in ("ln1", "ln2", "ln3"):
                self.add_module(f"{name}_{i}", LayerNorm(D))
            self.add_module(f"ff1_{i}", Dense(D, 4 * D))
            self.add_module(f"ff2_{i}", Dense(4 * D, D, init="zeros"))
        self._pe = {}

    @classmethod
    def from_config(cls, cfg, n_classes: int, enc_dim: int = 0) -> "TransformerS2SCriterion":
        return cls(S2SConfig.from_flags(cfg, n_classes),
                   get_scale_mode(cfg.onorm, cfg.sqnorm),
                   n_tr_layers=max(1, cfg.am_decoder_tr_layers),
                   tr_dropout=cfg.am_decoder_tr_dropout,
                   tr_layerdrop=cfg.am_decoder_tr_layerdrop, enc_dim=enc_dim)

    def _layer(self, i: int) -> SimpleNamespace:
        """Layer ``i``'s modules under their names without the index."""
        names = ("sq", "sk", "sv", "so", "cq", "ck", "cv", "co")
        return SimpleNamespace(**{n: getattr(self, f"{n}{i}") for n in names},
                               **{n: getattr(self, f"{n}_{i}")
                                  for n in ("ln1", "ln2", "ln3", "ff1", "ff2")})

    def _pos(self, L: int, dtype, device) -> torch.Tensor:
        key = (L, dtype, str(device))
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(_sinusoid(L, self.cfg.hidden)).to(
                device=device, dtype=dtype)
        return self._pe[key]

    def _heads(self, a: torch.Tensor) -> torch.Tensor:
        B, L, D = a.shape
        return a.reshape(B, L, self.n_heads, D // self.n_heads).transpose(1, 2)

    def _attend(self, q, k, v, mask, o_proj):
        """q (B, Lq, D), k and v (B, Lk, D), mask broadcastable to (B, 1, Lq, Lk)."""
        dh = q.shape[-1] // self.n_heads
        qh, kh, vh = self._heads(q), self._heads(k), self._heads(v)
        s = qh @ kh.transpose(-1, -2) / math.sqrt(dh)
        s = torch.where(mask, s, NEG)
        a = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = a @ vh
        B, H, Lq, _ = o.shape
        return o_proj(o.transpose(1, 2).reshape(B, Lq, H * dh))

    def _drop(self, x, train):
        """``--am_decoder_tr_dropout`` on the residual branches (training)."""
        if not train or self.tr_dropout <= 0:
            return x
        keep = 1.0 - self.tr_dropout
        m = torch.rand(x.shape, device=x.device) < keep
        return torch.where(m, x / keep, torch.zeros_like(x))

    def _layer_scale(self, train, device):
        """``--am_decoder_tr_layerdrop``: the whole layer's branches scaled by
        0 with that probability (a device scalar: no host sync)."""
        if not train or self.tr_layerdrop <= 0:
            return 1.0
        return (torch.rand((), device=device) >= self.tr_layerdrop).float()

    def _decode_all(self, dec_in, enc, enc_mask, train=False, window=False):
        c = self.cfg
        U1 = dec_in.shape[1]
        dev = enc.device
        x = self.embedding(dec_in).to(enc.dtype) + self._pos(U1, enc.dtype, dev)[None]
        causal = torch.tril(torch.ones(U1, U1, dtype=torch.bool, device=dev))[None, None]
        cmask = enc_mask[:, None, None, :]
        if window and train and c.attn_window in ("soft", "softPretrain", "step"):
            # each output step's window on the cross-attention (``median``
            # needs the sequential peak: the GRU criterion's only)
            wm = window_mask(c.attn_window, torch.arange(U1, device=dev)[:, None],
                             enc.shape[1], torch.zeros(1, dtype=torch.int32, device=dev), c)
            cmask = cmask & wm[None, None]
            cmask = cmask | ~cmask.any(dim=-1, keepdim=True)
        for i in range(self.n_tr_layers):
            m = self._layer(i)
            f = self._layer_scale(train, dev)
            h = m.ln1(x)
            x = x + f * self._drop(self._attend(m.sq(h), m.sk(h), m.sv(h), causal, m.so),
                                   train)
            h = m.ln2(x)
            x = x + f * self._drop(self._attend(m.cq(h), m.ck(enc), m.cv(enc), cmask, m.co),
                                   train)
            h = m.ln3(x)
            x = x + f * self._drop(m.ff2(F.gelu(m.ff1(h), approximate="tanh")), train)
        return self.out(x)

    # -- incremental decoding (KV cache) -----------------------------------
    def init_state(self, batch: int, dtype=torch.float32, device=None):
        c = self.cfg
        device = device if device is not None else self.out.kernel.device
        Lmax = c.max_decoder_output_len + 1
        L = self.n_tr_layers
        # the hypothesis axis leads every leaf, so that a beam gathers rows
        return {
            "k": torch.zeros(batch, L, Lmax, c.hidden, dtype=dtype, device=device),
            "v": torch.zeros(batch, L, Lmax, c.hidden, dtype=dtype, device=device),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        }

    def decode_step(self, state, tok, enc, enc_mask, step_idx, windowed=False):
        """One token with the self-attention KV cache; the cross-attention's K
        and V from ``enc`` at every step, as in JAX. The step writes this
        position's keys and values into ``state``'s caches in place (a beam
        passes a gathered copy) and returns them in the new state."""
        pos = state["pos"][:1].long()  # the beams advance in lockstep
        kc, vc = state["k"], state["v"]
        Lmax = kc.shape[2]
        x = self.embedding(tok).to(enc.dtype)[:, None]  # (B, 1, D)
        x = x + self._pos(Lmax, x.dtype, x.device).index_select(0, pos)[None]
        valid = (torch.arange(Lmax, device=x.device)[None, :] <= pos[:, None])[:, None, None, :]
        cmask = enc_mask[:, None, None, :]
        for i in range(self.n_tr_layers):
            m = self._layer(i)
            h = m.ln1(x)
            kc[:, i].index_copy_(1, pos, m.sk(h).to(kc.dtype))
            vc[:, i].index_copy_(1, pos, m.sv(h).to(vc.dtype))
            x = x + self._attend(m.sq(h), kc[:, i], vc[:, i], valid, m.so)
            h = m.ln2(x)
            x = x + self._attend(m.cq(h), m.ck(enc), m.cv(enc), cmask, m.co)
            h = m.ln3(x)
            x = x + m.ff2(F.gelu(m.ff1(h), approximate="tanh"))
        logits = self.out(x[:, 0])
        return {"k": kc, "v": vc, "pos": state["pos"] + 1}, logits

    def forward(self, emissions, targets, emis_len, target_len,
                train: Optional[bool] = None, window: bool = False):
        logits, tgt_in = self.teacher_forced(emissions, targets, emis_len, train, window)
        return _nll(self.cfg, self.scale_mode, logits, tgt_in, target_len, emis_len)

    def teacher_forced(self, emissions, targets, emis_len, train: Optional[bool] = None,
                       window: bool = False):
        """As ``Seq2SeqCriterion.teacher_forced``: (logits, targets with pad)."""
        train = self.training if train is None else train
        enc_mask, tgt_in, dec_in = _prepare(self.cfg, emissions, targets, emis_len)
        return self._decode_all(dec_in, emissions, enc_mask, train=train,
                                window=window), tgt_in

    def greedy_path(self, emissions, emis_len):
        """Greedy decode through the KV-cached step."""
        return _greedy(self, emissions, emis_len)
