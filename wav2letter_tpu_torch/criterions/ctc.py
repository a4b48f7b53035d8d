"""CTC criterion module — the port of ``wav2letter_tpu/criterions/ctc.py``
(reference ``CTCLoss(scalemode)``; blank appended last)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.ctc import ctc_loss, ctc_viterbi
from .base import CriterionScaleMode, scale_losses


class CTCCriterion(nn.Module):
    """Per-sample scaled CTC losses (B,). It has no parameters."""

    def __init__(self, n_classes: int,
                 scale_mode: CriterionScaleMode = CriterionScaleMode.NONE):
        super().__init__()
        self.n_classes = n_classes
        self.scale_mode = scale_mode

    def forward(self, emissions: torch.Tensor, targets: torch.Tensor,
                emis_len: torch.Tensor, target_len: torch.Tensor) -> torch.Tensor:
        losses = ctc_loss(emissions, targets, emis_len, target_len)
        return scale_losses(losses, self.scale_mode, emis_len, target_len)

    def viterbi_path(self, emissions: torch.Tensor,
                     emis_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ctc_viterbi(emissions, emis_len)

    @property
    def blank_idx(self) -> int:
        return self.n_classes - 1
