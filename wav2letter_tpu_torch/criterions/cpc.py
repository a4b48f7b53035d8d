"""CPC / wav2vec2-style masked contrastive criterion — the port of
``wav2letter_tpu/criterions/cpc.py`` (reference ``cpc/CPCCriterion.{h,cpp}``:
mask generation ``:87-130``, negative sampling ``:139-171``, InfoNCE forward
``:177-223``).

  * a learned mask embedding (dim ``n_encoder``, U(-1, 1) at init) replaces
    the masked frames;
  * masks: ``max(1, int(mask_prob * T))`` random span starts a row, each
    extended to ``mask_length`` frames, then exactly K = ``min(T, starts *
    mask_length)`` positions a row (the masked ones first, by random scores
    plus 1 for a masked frame, top K);
  * loss: for each masked position the anchor is the L2-normed ``mutual_ctx``
    of the context, the positive the L2-normed ``mutual_enc`` of the encoder
    output, and the negatives ``n_negative`` other masked positions of the
    same row outside a ``n_buffer`` window; InfoNCE at ``temperature``.

JAX draws with ``jax.random``; here every draw comes from a
``torch.Generator`` the caller gives, and ``forward`` also takes the integers
of the negative sampling (``r``) from the caller, so that a step can be held
to JAX's on the same draws. The negatives' logits are read from the (B, K, K)
matrix of anchor-positive products, where JAX gathers a (B, K, n, M) tensor
of negatives first: the same dot products, a K·n·M-fold smaller tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .seq2seq import _lecun_normal


@dataclasses.dataclass(frozen=True)
class CPCConfig:
    n_encoder: int = 256  # codedim
    n_context: int = 256  # contextdim
    n_mutual: int = 256  # mutualdim
    n_negative: int = 100
    temperature: float = 0.1
    mask_prob: float = 0.065
    mask_length: int = 10
    n_buffer: int = 1  # exclusion window around the anchor position

    @classmethod
    def from_flags(cls, cfg) -> "CPCConfig":
        return cls(
            n_encoder=cfg.get("codedim", 256),
            n_context=cfg.get("contextdim", 256),
            n_mutual=cfg.get("mutualdim", 256),
            n_negative=cfg.get("nnegativesamples", 100),
            temperature=cfg.get("temperature", 0.1),
            mask_prob=cfg.get("maskprob", 0.065),
            mask_length=cfg.get("masklength", 10),
        )


def _linear(in_dim: int, out_dim: int) -> nn.Linear:
    """``nn.Linear`` initialized as flax's ``Dense`` (lecun normal, zero bias)."""
    lin = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        lin.weight.copy_(_lecun_normal(in_dim, out_dim).t())
        lin.bias.zero_()
    return lin


def n_masked(cfg: CPCConfig, T: int) -> int:
    """K, the masked positions a row of T frames gets."""
    return min(T, max(1, int(cfg.mask_prob * T)) * cfg.mask_length)


class CPCCriterion(nn.Module):
    def __init__(self, cfg: CPCConfig):
        super().__init__()
        self.cfg = cfg
        self.mask_embedding = nn.Parameter(torch.empty(cfg.n_encoder).uniform_(-1.0, 1.0))
        self.mutual_enc = _linear(cfg.n_encoder, cfg.n_mutual)
        self.mutual_ctx = _linear(cfg.n_context, cfg.n_mutual)

    def make_mask(self, B: int, T: int, generator: Optional[torch.Generator] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mask (B, T) bool, mask_idx (B, K) int64): exactly K masked
        positions a row. Rows with fewer than K masked frames are filled with
        unmasked ones (still valid anchors)."""
        c = self.cfg
        device = device if device is not None else self.mask_embedding.device
        n_starts = max(1, int(c.mask_prob * T))
        starts = torch.randint(0, T, (B, n_starts), generator=generator, device=device)
        t_idx = torch.arange(T, device=device)[None, None, :]
        span = (t_idx >= starts[..., None]) & (t_idx < starts[..., None] + c.mask_length)
        mask = span.any(dim=1)
        K = n_masked(c, T)
        scores = torch.rand((B, T), generator=generator, device=device) + mask.float()
        idx = torch.topk(scores, K, dim=1).indices
        sel = torch.zeros((B, T), dtype=torch.bool, device=device).scatter_(1, idx, True)
        return sel, idx

    def apply_mask(self, features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Masked frames of ``features`` (B, T, C_enc) replaced by the embedding."""
        emb = self.mask_embedding.to(features.dtype)
        return torch.where(mask[..., None], emb[None, None, :], features)

    def negative_draws(self, B: int, K: int, generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
        """The integers ``r`` (B, K, n) of the negative sampling, in [0, 2**30)."""
        device = device if device is not None else self.mask_embedding.device
        nneg = min(self.cfg.n_negative, K)
        return torch.randint(0, 1 << 30, (B, K, nneg), generator=generator, device=device)

    def forward(self, enc_out: torch.Tensor, context: torch.Tensor, mask_idx: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                r: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-utterance InfoNCE loss (B,), the mean over the masked positions.
        ``enc_out`` (B, T, C_enc) is the unmasked encoder output (the
        targets), ``context`` (B, T, C_ctx) the context of the masked input,
        ``mask_idx`` (B, K); ``r`` as ``negative_draws`` gives, else drawn
        from ``generator``."""
        c = self.cfg
        B = enc_out.shape[0]
        K = mask_idx.shape[1]
        idx = mask_idx.long()

        def take(x):
            return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

        anchor = self.mutual_ctx(take(context).float())  # (B, K, M)
        pos = self.mutual_enc(take(enc_out).float())
        anchor = anchor / (torch.linalg.vector_norm(anchor, dim=-1, keepdim=True) + 1e-8)
        pos = pos / (torch.linalg.vector_norm(pos, dim=-1, keepdim=True) + 1e-8)

        # negatives: for each (b, k), other positions of this row's masked
        # set outside a +-n_buffer window around k (CPCCriterion.cpp:150-158)
        kk = torch.arange(K, device=idx.device)
        lo = torch.clamp(1 + c.n_buffer + kk, max=K)
        hi = torch.clamp(K - c.n_buffer + kk, min=K)
        span = (hi - lo)[None, :, None]
        if r is None:
            r = self.negative_draws(B, K, generator, idx.device)
        r = r.to(device=idx.device, dtype=torch.int64)
        # XLA's integer remainder by 0 is the dividend
        off = torch.where(span > 0, torch.remainder(r, span.clamp(min=1)), r)
        neg_pos = (lo[None, :, None] + off) % K  # (B, K, n)

        pos_logit = (anchor * pos).sum(-1, keepdim=True) / c.temperature
        sim = torch.bmm(anchor, pos.transpose(1, 2))  # (B, K, K)
        neg_logit = torch.gather(sim, 2, neg_pos) / c.temperature
        logits = torch.cat([pos_logit, neg_logit], dim=-1)  # (B, K, 1 + n)
        return -F.log_softmax(logits, dim=-1)[..., 0].mean(dim=-1)


class MTLLoss(nn.Module):
    """Language-ID auxiliary classifier loss, keyed by a per-sample language
    id (reference ``cpc/MTLLoss.{h,cpp}``): context features mean-pooled over
    the valid frames -> ``lid_head`` -> cross entropy; a row with id -1 has
    no label and loss 0."""

    def __init__(self, n_langs: int, in_dim: int):
        super().__init__()
        self.n_langs, self.in_dim = n_langs, in_dim
        self.lid_head = _linear(in_dim, n_langs)

    def forward(self, context: torch.Tensor, ctx_len: torch.Tensor,
                lang_ids: torch.Tensor) -> torch.Tensor:
        t_idx = torch.arange(context.shape[1], device=context.device)[None, :, None]
        m = (t_idx < ctx_len[:, None, None]).to(context.dtype)
        pooled = (context * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        logp = F.log_softmax(self.lid_head(pooled.float()), dim=-1)
        lang_ids = lang_ids.long()
        safe = torch.where(lang_ids < 0, torch.zeros_like(lang_ids), lang_ids)
        nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
        return torch.where(lang_ids < 0, torch.zeros_like(nll), nll)
