"""Neural LMs from arch files (GCNN ConvLMs): the port of
``wav2letter_tpu/models/lm.py``.

The reference's LM archs (``recipes/sota/2019/lm/*.arch``) take their input
in the AF layout ``(L, B, 1, 1)`` and embed it with ``E``: ``LMArchModel``
puts (B, L) token ids in that layout, runs the arch's layers and returns
(B, L, vocab) logits, through a ``vocab_proj`` dense layer where the arch
ends narrower or wider than the vocabulary. ``cli/train_lm.py`` trains such
a model, ``tools/convlm_import.py`` maps a torch state dict onto it and
``decoder/convlm.py`` scores beam hypotheses with it.

Parameter names are the flax tree's (``seq.NN_KIND...``, ``vocab_proj.
kernel`` (in, out) and ``bias``; ``AdaptiveSoftmax``'s ``head`` and
``tails_{i}.layers_{0,1}``), so ``runtime/checkpoint.py::convert_jax_params``
carries JAX weights over by a rename.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..criterions.seq2seq import Dense
from ..kernels import PLAIN
from .arch import ArchSequential, parse_arch_file, parse_arch_lines
from .layers import set_generator


class LMArchModel(nn.Module):
    """(B, L) token ids -> ((B, L, vocab) logits, lengths)."""

    def __init__(self, specs, vocab_size: int, out_dim: int):
        super().__init__()
        self.vocab_size, self.out_dim = vocab_size, out_dim
        self.seq = ArchSequential(specs)
        # flax sizes vocab_proj from the arch's actual output width (``out_dim``,
        # the last L line's, is a field only): a forward on the meta device
        # gives it here
        with torch.device("meta"):
            width = ArchSequential(specs, PLAIN)(torch.zeros(1, 1, 1, 8, dtype=torch.long))
        width = width.numel() // 8
        if width != vocab_size:
            self.vocab_proj = Dense(width, vocab_size)

    def forward(self, ids: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``generator`` feeds the dropout layers in training mode (None: the
        device's global generator)."""
        set_generator(self, generator)
        B, L = ids.shape
        # AF (L, B, 1, 1) == stored (1, 1, B, L)
        y = self.seq(ids.reshape(1, 1, B, L))
        # the arch's output AF (D, L, B, 1) == stored (1, B, L, D); archs
        # that skip the last reorder leave other shapes of that size
        y = y.reshape(B, L, y.numel() // (B * L))
        if y.shape[-1] != self.vocab_size:
            y = self.vocab_proj(y.float())
        return y, lengths


def build_lm_model(arch_path: str, vocab_size: int) -> LMArchModel:
    """The LM of ``arch_path`` (NFEAT and NLABEL both read ``vocab_size``);
    its output width read, best effort, from the last ``L``/``WN .. L``
    line."""
    lines = parse_arch_file(arch_path, n_feat=vocab_size, n_label=vocab_size)
    specs = parse_arch_lines(lines)
    out_dim = vocab_size
    for line in reversed(lines):
        t = line.split()
        if t[0] in ("L", "WN") and "L" in t[:3]:
            out_dim = int(t[-1])
            break
    return LMArchModel(specs, vocab_size, out_dim)


class AdaptiveSoftmax(nn.Module):
    """Adaptive softmax head (Grave et al.): a head over the first cluster
    ``[0, c0)`` and one gate per tail cluster; tail i projects down to
    ``in_dim // 4^(i+1)`` and then to its ``c[i+1] - c[i]`` words.
    ``log_probs`` gives the full vocabulary's log-probs (what ConvLM decoding
    reads)."""

    def __init__(self, in_dim: int, cutoffs: Sequence[int]):
        super().__init__()
        c = self.cutoffs = list(cutoffs)
        n_tails = len(c) - 1
        self.head = Dense(in_dim, c[0] + n_tails)
        for i in range(n_tails):
            mid = max(1, in_dim // (4 ** (i + 1)))
            self.add_module(f"tails_{i}", nn.Sequential())
            tail = getattr(self, f"tails_{i}")
            tail.add_module("layers_0", Dense(in_dim, mid))
            tail.add_module("layers_1", Dense(mid, c[i + 1] - c[i]))

    def log_probs(self, h: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V)."""
        c = self.cutoffs
        head = F.log_softmax(self.head(h).float(), dim=-1)
        parts = [head[..., : c[0]]]
        for i in range(len(c) - 1):
            gate = head[..., c[0] + i: c[0] + i + 1]
            parts.append(gate + F.log_softmax(getattr(self, f"tails_{i}")(h).float(), dim=-1))
        return torch.cat(parts, dim=-1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.log_probs(h)


def lm_cross_entropy(logits: torch.Tensor, ids: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy of each row, summed over positions: logits
    (B, L, V) at positions 0..L-2 predict ids 1..L-1 (fp32 log-softmax);
    ``lengths`` masks positions at or past ``lengths - 1``."""
    B, L, V = logits.shape
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, ids[:, 1:, None].long())[..., 0]
    if lengths is not None:
        valid = torch.arange(L - 1, device=logits.device)[None, :] < (lengths[:, None] - 1)
        nll = torch.where(valid, nll, torch.zeros((), device=logits.device))
    return nll.sum(dim=-1)
