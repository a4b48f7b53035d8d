"""ASG criterion module — the port of ``wav2letter_tpu/criterions/asg.py``.
The criterion owns the N×N transition matrix as its one parameter,
``transitions`` (reference: ``StreamingTDSModelConverter.cpp:310-324`` reads
``criterion->param(0)`` as transitions; the name of the JAX ``crit_params``
and of ``inference/convert.py``), zero plus ``--transdiag`` on the diagonal
at init (``recipes/conv_glu/train.cfg``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.asg import asg_loss, asg_viterbi
from .base import CriterionScaleMode, scale_losses


class ASGCriterion(nn.Module):
    """Per-sample scaled ASG losses (B,)."""

    def __init__(self, n_classes: int,
                 scale_mode: CriterionScaleMode = CriterionScaleMode.NONE,
                 transdiag: float = 0.0, replabel: int = 0):
        super().__init__()
        self.n_classes = n_classes
        self.scale_mode = scale_mode
        self.replabel = replabel
        self.transitions = nn.Parameter(transdiag * torch.eye(n_classes))

    def forward(self, emissions: torch.Tensor, targets: torch.Tensor,
                emis_len: torch.Tensor, target_len: torch.Tensor) -> torch.Tensor:
        losses = asg_loss(emissions, self.transitions, targets, emis_len, target_len)
        return scale_losses(losses, self.scale_mode, emis_len, target_len)

    def viterbi_path(self, emissions: torch.Tensor,
                     emis_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        return asg_viterbi(emissions, self.transitions, emis_len)
