from .frontend import (
    FeatureParams,
    Featurizer,
    HostFeaturizer,
    local_normalize,
    mel_filterbank,
    n_fft_for,
)
from .specaug import SpecAugment

__all__ = [
    "FeatureParams",
    "Featurizer",
    "HostFeaturizer",
    "SpecAugment",
    "local_normalize",
    "mel_filterbank",
    "n_fft_for",
]
