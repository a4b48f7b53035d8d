from .frontend import (
    FeatureParams,
    Featurizer,
    local_normalize,
    mel_filterbank,
    n_fft_for,
)

__all__ = [
    "FeatureParams",
    "Featurizer",
    "local_normalize",
    "mel_filterbank",
    "n_fft_for",
]
