"""The CTC loss (Graves et al. 2006), blank the last class, on raw
emissions: the negative log likelihood of the target under the
log-softmax of the emissions, summed over alignments; float64. Every target
the benchmark makes has an alignment."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_nll(em: torch.Tensor, elen: torch.Tensor, target: torch.Tensor,
            target_len: torch.Tensor) -> torch.Tensor:
    """em (b, T, N) emissions, elen (b,), target (b, U) padded with -1,
    target_len (b,) -> (b,) losses, differentiable in ``em``."""
    lp = torch.log_softmax(em.double(), dim=-1)
    tgt = target.long().clamp(min=0)
    return F.ctc_loss(lp.transpose(0, 1), tgt, elen.long(), target_len.long(),
                      blank=em.shape[-1] - 1, reduction="none", zero_infinity=False)


def scaled(losses: torch.Tensor, target_len: torch.Tensor, mode: str, sqrt: bool):
    """wav2letter's ``--onorm``: each loss over its target length (``target``),
    or its square root with ``--sqnorm``."""
    if mode == "none":
        return losses
    if mode != "target":
        raise ValueError(f"onorm {mode!r} is not in the reference")
    tl = target_len.double().clamp(min=1.0)
    return losses / (torch.sqrt(tl) if sqrt else tl)
