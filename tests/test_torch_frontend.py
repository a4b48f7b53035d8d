"""The PyTorch port's Featurizer against the JAX Featurizer on the CPU: MFSC
with local CMVN (the flagship's ``localnrmlleftctx``), MFSC with deltas, and
MFCC. Audio comes from a numpy seed and reaches both as numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2letter_tpu.features.frontend import FeatureParams as JaxParams
from wav2letter_tpu.features.frontend import Featurizer as JaxFeaturizer
from wav2letter_tpu_torch.features import FeatureParams, Featurizer

CASES = {
    "mfsc_local_norm": dict(n_filterbanks=40, local_norm_left=30),
    "mfsc_deltas": dict(n_filterbanks=24, delta_window=2),
    "mfsc_deltas_local_norm": dict(n_filterbanks=16, delta_window=1, local_norm_left=12),
    "mfcc": dict(n_filterbanks=24, feature_type="mfcc"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_featurizer_matches_jax(case):
    kw = CASES[case]
    rng = np.random.RandomState(len(case))
    audio = (rng.randn(3, 12000) * 0.2).astype(np.float32)
    audio_len = np.asarray([12000, 9000, 4000], np.int32)
    want, want_len = JaxFeaturizer(JaxParams(**kw))(jnp.asarray(audio),
                                                    jnp.asarray(audio_len))
    got, got_len = Featurizer(FeatureParams(**kw))(torch.from_numpy(audio),
                                                   torch.from_numpy(audio_len))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    got, want = got.numpy(), np.asarray(want)
    # fp32 frontends that sum in another order: log-mel agrees to ~1e-5 and
    # the local CMVN keeps that within 2e-4. Its first frames are the
    # exception: their windows hold 1-8 frames, whose std can be small, and
    # dividing by it amplifies the rounding of the cumulative sums (XLA scans
    # associatively, torch sequentially) to ~1.5e-3.
    head = 8 if kw.get("local_norm_left") else 0
    np.testing.assert_allclose(got[:, head:], want[:, head:], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[:, :head], want[:, :head], atol=5e-3)


def test_feature_lengths_and_short_audio():
    """Frame counts follow 1 + (S - 400) // 160, clamped at 0."""
    p = FeatureParams(n_filterbanks=16)
    audio = torch.zeros(2, 399 + 160 * 3)
    feats, flen = Featurizer(p)(audio, torch.tensor([399, 400 + 160 * 2]))
    assert feats.shape == (2, 3, 16)
    assert flen.tolist() == [0, 3]
