from .base import CriterionScaleMode, get_scale_mode, scale_losses
from .asg import ASGCriterion
from .ctc import CTCCriterion
from .seq2seq import S2SConfig, Seq2SeqCriterion, TransformerS2SCriterion

__all__ = ["CriterionScaleMode", "get_scale_mode", "scale_losses", "ASGCriterion",
           "CTCCriterion", "S2SConfig", "Seq2SeqCriterion", "TransformerS2SCriterion",
           "make_criterion"]


def make_criterion(cfg, n_classes: int, enc_dim: int = 0):
    """Build the criterion named by --criterion (reference Train.cpp:524-541).
    ``enc_dim``: the width of the encoder states the transformer decoder's
    cross-attention takes (0: ``--encoderdim``)."""
    mode = get_scale_mode(cfg.onorm, cfg.sqnorm)
    if cfg.criterion == "ctc":
        return CTCCriterion(n_classes, mode)
    if cfg.criterion == "asg":
        return ASGCriterion(n_classes, mode, cfg.transdiag, cfg.replabel)
    if cfg.criterion == "seq2seq":
        return Seq2SeqCriterion.from_config(cfg, n_classes)
    if cfg.criterion == "transformer":
        return TransformerS2SCriterion.from_config(cfg, n_classes, enc_dim)
    raise ValueError(f"unknown criterion: {cfg.criterion}")
