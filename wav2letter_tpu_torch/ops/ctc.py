"""Connectionist Temporal Classification — the port of
``wav2letter_tpu/ops/ctc.py``: the forward loss, greedy viterbi and collapse.

Conventions as in the JAX package (reference ``CTCLoss``/``viterbiPath``):
the blank is the LAST class, targets are (B, U) padded with -1, and the loss
takes raw logits and normalizes them itself. The JAX loss is a ``lax.scan``
over time, not a TPU kernel; here the same log-space recursion is
``torch.nn.functional.ctc_loss`` with ``blank=N-1``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def ctc_loss(logits: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
             target_len: torch.Tensor, blank: Optional[int] = None) -> torch.Tensor:
    """Per-sample CTC negative log likelihood (B,), computed in float32."""
    B, T, N = logits.shape
    if blank is not None and blank != N - 1:
        raise ValueError("reference convention requires blank == N-1")
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, N)
    return F.ctc_loss(log_probs, targets.long().clamp(min=0), logit_len.long(),
                      target_len.long(), blank=N - 1, reduction="none",
                      zero_infinity=False)


def ctc_viterbi(logits: torch.Tensor, logit_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy per-frame argmax (B, T); frames past logit_len are the blank."""
    B, T, N = logits.shape
    path = torch.argmax(logits, dim=-1).to(torch.int32)
    if logit_len is not None:
        t_idx = torch.arange(T, device=logits.device)[None, :]
        path = torch.where(t_idx < logit_len[:, None], path,
                           torch.full_like(path, N - 1))
    return path


def ctc_collapse(path, blank: int):
    """Host-side: collapse repeats then remove blanks. A list per row."""
    path = np.asarray(path)
    out = []
    for row in path:
        toks = []
        prev = None
        for t in row:
            if t != prev:
                if t != blank:
                    toks.append(int(t))
                prev = t
        out.append(toks)
    return out
