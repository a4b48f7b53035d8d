"""SpecAugment on the features' device — the port of
``wav2letter_tpu/features/specaug.py``.

Semantics as there (arch-level ``SAUG F mF T p mT`` and the ``--saug_*``
flags): for each utterance ``n_freq_masks`` frequency masks of width
U{0..F} starting at U{0..max(1, C - w) - 1}, and ``n_time_masks`` time masks
of width U{0..min(T_mask, floor(p * len))} starting at U{0..max(1, len - w) -
1}; masked cells become ``mask_value`` (zero).

All draws of a call come from one ``torch.rand`` on the explicit generator,
one row per utterance, so the same generator state gives the same masks on
any device. The bits differ from the JAX PRNG's; the distributions do not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _randint(u: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Uniform integer in [0, high) from u ~ U[0, 1), elementwise; high >= 1."""
    return torch.minimum((u * high).floor(), high - 1).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class SpecAugment:
    n_freq_masks: int = 2
    freq_mask_f: int = 27
    n_time_masks: int = 2
    time_mask_t: int = 100
    time_mask_p: float = 1.0
    mask_value: float = 0.0

    def __call__(self, feats: torch.Tensor, generator: Optional[torch.Generator] = None,
                 feat_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats (B, T, C); feat_len (B,) valid frames (default T)."""
        B, T, C = feats.shape
        dev = feats.device
        n = self.n_freq_masks + self.n_time_masks
        if n == 0:
            return feats
        gdev = generator.device if generator is not None else torch.device("cpu")
        # float64: floor(u * high) must not round up to high
        u = torch.rand((B, 2 * n), generator=generator, device=gdev,
                       dtype=torch.float64).to(dev)
        if feat_len is None:
            length = torch.full((B,), T, dtype=torch.float64, device=dev)
        else:
            length = feat_len.to(device=dev, dtype=torch.float64)
        one = torch.ones((), dtype=torch.float64, device=dev)
        keep = torch.ones((B, T, C), dtype=torch.bool, device=dev)
        c_idx = torch.arange(C, device=dev)[None, :]
        t_idx = torch.arange(T, device=dev)[None, :]
        col = 0
        for _ in range(self.n_freq_masks):
            w = _randint(u[:, col], one * (self.freq_mask_f + 1))
            start = _randint(u[:, col + 1], torch.maximum(one, C - w.double()))
            col += 2
            m = (c_idx >= start[:, None]) & (c_idx < (start + w)[:, None])
            keep &= ~m[:, None, :]
        max_t = torch.clamp((self.time_mask_p * length).floor(), max=self.time_mask_t)
        for _ in range(self.n_time_masks):
            w = _randint(u[:, col], torch.maximum(one, max_t + 1))
            start = _randint(u[:, col + 1], torch.maximum(one, length - w.double()))
            col += 2
            m = (t_idx >= start[:, None]) & (t_idx < (start + w)[:, None])
            keep &= ~m[:, :, None]
        return torch.where(keep, feats, torch.as_tensor(self.mask_value, dtype=feats.dtype,
                                                        device=dev))
