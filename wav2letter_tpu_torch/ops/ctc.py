"""Connectionist Temporal Classification — the port of
``wav2letter_tpu/ops/ctc.py``: the loss with its gradient, greedy viterbi and
collapse.

Conventions as in the JAX package (reference ``CTCLoss``/``viterbiPath``):
the blank is the LAST class, targets are (B, U) padded with -1, and the loss
takes raw logits and normalizes them itself. The JAX loss is a ``lax.scan``
over time with an analytic VJP, not a TPU kernel; here it is the same
recursion on the same finite -1e30, with the same analytic gradient
(``softmax - posterior`` on valid frames, zero past ``logit_len``): on the
card the hand-written kernels K5 (forward) and K5b (backward), whose sums
have one order, so an update replays in bits; on the CPU their plain version
(``kernels/ctc.py``). A row with no valid alignment (more labels, counting
one blank between equal neighbours, than frames) needs no case of its own:
its loss is 1e30, finite, as in JAX, and its gradient JAX's.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..kernels import KERNELS


def ctc_loss(logits: torch.Tensor, targets: torch.Tensor, logit_len: torch.Tensor,
             target_len: torch.Tensor, blank: Optional[int] = None,
             ops: SimpleNamespace = KERNELS) -> torch.Tensor:
    """Per-sample CTC negative log likelihood (B,), computed in float32 from
    logits of float32 or bfloat16 (read as they are). Differentiable with
    respect to ``logits``; the gradient has their dtype. ``ops``:
    ``kernels.KERNELS`` (K5/K5b on the card) or ``kernels.PLAIN``."""
    B, T, N = logits.shape
    if blank is not None and blank != N - 1:
        raise ValueError("reference convention requires blank == N-1")
    return ops.ctc_loss(logits, targets, logit_len, target_len)


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
