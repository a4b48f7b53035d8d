"""CTC criterion module — the port of ``wav2letter_tpu/criterions/ctc.py``
(reference ``CTCLoss(scalemode)``; blank appended last)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels import KERNELS
from ..ops.ctc import ctc_loss, ctc_viterbi
from .base import CriterionScaleMode, scale_losses


class CTCCriterion(nn.Module):
    """Per-sample scaled CTC losses (B,). It has no parameters. ``ops``:
    ``kernels.KERNELS`` (K5/K5b on the card) or ``kernels.PLAIN``. It takes
    the emissions in the compute dtype (``fp32_emissions``): its kernels read
    bf16 as it is and write the gradient in bf16, rounded once from fp32, as
    the backward of a cast to fp32 would."""

    ops = KERNELS
    fp32_emissions = False

    def __init__(self, n_classes: int,
                 scale_mode: CriterionScaleMode = CriterionScaleMode.NONE):
        super().__init__()
        self.n_classes = n_classes
        self.scale_mode = scale_mode

    def forward(self, emissions: torch.Tensor, targets: torch.Tensor,
                emis_len: torch.Tensor, target_len: torch.Tensor) -> torch.Tensor:
        losses = ctc_loss(emissions, targets, emis_len, target_len, ops=self.ops)
        return scale_losses(losses, self.scale_mode, emis_len, target_len)

    def viterbi_path(self, emissions: torch.Tensor,
                     emis_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ctc_viterbi(emissions, emis_len)

    @property
    def blank_idx(self) -> int:
        return self.n_classes - 1
