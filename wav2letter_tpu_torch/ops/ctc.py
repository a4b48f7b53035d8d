"""Connectionist Temporal Classification — the port of
``wav2letter_tpu/ops/ctc.py``: the loss with its gradient, greedy viterbi and
collapse.

Conventions as in the JAX package (reference ``CTCLoss``/``viterbiPath``):
the blank is the LAST class, targets are (B, U) padded with -1, and the loss
takes raw logits and normalizes them itself. The JAX loss is a ``lax.scan``
over time with an analytic VJP, not a TPU kernel; here the same log-space
recursion is ``torch.nn.functional.ctc_loss`` with ``blank=N-1`` behind
``log_softmax``, whose gradient with respect to the raw logits is the JAX
VJP's ``softmax - posterior`` on valid frames and zero on frames past
``logit_len``.

A row with no valid alignment (more labels, counting one blank between
equal neighbours, than frames) is where the two differ by themselves: the JAX
recursion works with a finite -1e30 in place of -inf, so its loss is 1e30,
finite, and the trainer's non-finite guard lets the update through; PyTorch
gives inf and a NaN gradient. Here such a row's loss is 1e30 as in JAX and
its gradient is zero (JAX's is finite but carries no information: the
posterior of a path set that is empty).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


INFEASIBLE_LOSS = 1e30  # the JAX package's -NEG_INF


def ctc_feasible(targets: torch.Tensor, logit_len: torch.Tensor,
                 target_len: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the row has a valid alignment, i.e. at least as many frames
    as labels plus one blank between each pair of equal neighbours."""
    U = targets.shape[1]
    inside = torch.arange(1, U, device=targets.device)[None, :] < target_len[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & inside).sum(dim=1)
    return target_len + repeats <= logit_len


def ctc_loss(logits: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
             target_len: torch.Tensor, blank: Optional[int] = None) -> torch.Tensor:
    """Per-sample CTC negative log likelihood (B,), computed in float32.
    Differentiable with respect to ``logits``."""
    B, T, N = logits.shape
    if blank is not None and blank != N - 1:
        raise ValueError("reference convention requires blank == N-1")
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, N)
    logit_len, target_len = logit_len.long(), target_len.long()
    losses = F.ctc_loss(log_probs, targets.long().clamp(min=0), logit_len, target_len,
                        blank=N - 1, reduction="none", zero_infinity=True)
    feasible = ctc_feasible(targets, logit_len, target_len)
    return torch.where(feasible, losses, losses.new_tensor(INFEASIBLE_LOSS))


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
