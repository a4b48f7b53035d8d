from .frontend import (
    FeatureParams,
    Featurizer,
    local_normalize,
    mel_filterbank,
    n_fft_for,
)
from .specaug import SpecAugment

__all__ = [
    "FeatureParams",
    "Featurizer",
    "SpecAugment",
    "local_normalize",
    "mel_filterbank",
    "n_fft_for",
]
