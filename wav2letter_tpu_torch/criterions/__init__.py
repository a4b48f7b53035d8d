from .base import CriterionScaleMode, get_scale_mode, scale_losses
from .asg import ASGCriterion
from .ctc import CTCCriterion

__all__ = ["CriterionScaleMode", "get_scale_mode", "scale_losses", "ASGCriterion",
           "CTCCriterion", "make_criterion"]

_LATER = {
    "seq2seq": "the seq2seq slice (M11)",
    "transformer": "the seq2seq slice (M11)",
}


def make_criterion(cfg, n_classes: int):
    """Build the criterion named by --criterion (reference Train.cpp:524-541)."""
    mode = get_scale_mode(cfg.onorm, cfg.sqnorm)
    if cfg.criterion == "ctc":
        return CTCCriterion(n_classes, mode)
    if cfg.criterion == "asg":
        return ASGCriterion(n_classes, mode, cfg.transdiag, cfg.replabel)
    if cfg.criterion in _LATER:
        raise NotImplementedError(
            f"criterion {cfg.criterion!r} is not in the slices of the PyTorch port so "
            f"far (ctc and asg); it comes with {_LATER[cfg.criterion]}")
    raise ValueError(f"unknown criterion: {cfg.criterion}")
