"""Criterion scale modes — the port of ``wav2letter_tpu/criterions/base.py``
(reference ``getCriterionScaleMode(onorm, sqnorm)``; flags ``--onorm
none|target|input --sqnorm``)."""

from __future__ import annotations

import enum

import torch


class CriterionScaleMode(enum.Enum):
    NONE = "none"
    TARGET_SZ = "target"
    TARGET_SZ_SQRT = "target_sqrt"
    INPUT_SZ = "input"
    INPUT_SZ_SQRT = "input_sqrt"


def get_scale_mode(onorm: str, sqnorm: bool) -> CriterionScaleMode:
    if onorm == "none":
        return CriterionScaleMode.NONE
    if onorm == "target":
        return CriterionScaleMode.TARGET_SZ_SQRT if sqnorm else CriterionScaleMode.TARGET_SZ
    if onorm == "input":
        return CriterionScaleMode.INPUT_SZ_SQRT if sqnorm else CriterionScaleMode.INPUT_SZ
    raise ValueError(f"unknown onorm: {onorm}")


def scale_losses(losses: torch.Tensor, mode: CriterionScaleMode, input_len: torch.Tensor,
                 target_len: torch.Tensor) -> torch.Tensor:
    tl = target_len.float().clamp(min=1.0)
    il = input_len.float().clamp(min=1.0)
    if mode == CriterionScaleMode.NONE:
        return losses
    if mode == CriterionScaleMode.TARGET_SZ:
        return losses / tl
    if mode == CriterionScaleMode.TARGET_SZ_SQRT:
        return losses / torch.sqrt(tl)
    if mode == CriterionScaleMode.INPUT_SZ:
        return losses / il
    if mode == CriterionScaleMode.INPUT_SZ_SQRT:
        return losses / torch.sqrt(il)
    raise ValueError(mode)
