"""The port's CUDA kernels against their plain PyTorch versions on the card.
Marked ``cuda``; each test decides inside the ``cuda`` fixture whether a card
is present and skips without one. Run them on a machine with a card; there
``tests/conftest.py`` (which imports JAX for the JAX package's tests) is
skipped, since the port's machine need not have JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from wav2letter_tpu_torch import kernels
from wav2letter_tpu_torch.features import FeatureParams, Featurizer
from wav2letter_tpu_torch.models import build_arch_from_lines

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.disable_tf32()
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32, scale=1.0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.parametrize("B,S", [(2, 16000), (1, 7000), (3, 64000)])
def test_mfsc_kernel(cuda, B, S):
    f = Featurizer(FeatureParams(n_filterbanks=80)).to(cuda)
    pre = _randn((B, S), S, cuda, scale=0.3)
    args = (pre, f.cos_mat, f.sin_mat, f.mel_fb, 400, 160, 1.0)
    before = kernels.LAUNCHES["mfsc"]
    got = kernels.mfsc(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mfsc"] == before + 1
    # fp32 400-term sums in another order; log-mel features O(1-10)
    torch.testing.assert_close(got, kernels.mfsc_plain(*args), rtol=1e-4, atol=1e-4)


# (B, T, F, C, CO, K, stride, lp, rp): the flagship's C2 and TDS convs at a
# short T, plus small odd shapes
TCONV = [
    (2, 100, 80, 1, 16, 9, 2, 6, 2),
    (2, 50, 80, 16, 20, 11, 2, 8, 2),
    (2, 40, 80, 24, 28, 12, 1, 11, 0),
    (2, 45, 80, 20, 20, 9, 1, 7, 1),
    (2, 37, 80, 28, 28, 11, 1, 10, 0),
    (1, 29, 3, 5, 7, 10, 2, 7, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", TCONV)
def test_time_conv_kernel(cuda, dtype, B, T, F, C, CO, K, s, lp, rp):
    x = _randn((B, T, F * C), T, cuda, dtype)
    w = _randn((K, C, CO), K, cuda, dtype, scale=0.1)
    bias = _randn((CO,), CO, cuda)
    got = kernels.time_conv(x, w, F, s, (lp, rp), bias, relu=True)
    torch.cuda.synchronize()
    want = kernels.time_conv_plain(x, w, F, s, (lp, rp), bias, relu=True)
    # fp32 accumulation both sides; bf16 output rounding is 2^-8 relative
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(3000, 1280), (187, 2240), (70, 96)])
def test_residual_ln_kernel(cuda, dtype, R, D):
    x = _randn((R, D), R, cuda, dtype)
    y = _randn((R, D), D, cuda, dtype)
    w = torch.tensor([1.3], device=cuda)
    b = torch.tensor([-0.2], device=cuda)
    out, mu, rsig = kernels.residual_ln(x, y, w, b)
    torch.cuda.synchronize()
    want, wmu, wrsig = kernels.residual_ln_plain(x, y, w, b)
    tol = 1e-5 if dtype == torch.float32 else 2e-2  # bf16 output rounding
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mu, wmu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rsig, wrsig, rtol=1e-5, atol=1e-5)


NARROW = [
    "V -1 80 1 0", "PD 0 6 2", "C2 1 4 9 1 2 1 0 0", "R", "LN 1 2",
    "TDS 4 9 80 0.1 0 1 0", "TDS 4 9 80 0.1 0 1 0", "PD 0 11 0",
    "C2 4 6 12 1 1 1 0 0", "R", "LN 1 2", "TDS 6 11 80 0.1 0 0 0",
    "RO 2 1 0 3", "V 480 -1 1 0", "L 480 30", "V 30 0 -1 1",
]


def test_model_kernels_match_plain(cuda):
    torch.manual_seed(0)
    model = build_arch_from_lines(NARROW, 30).to(cuda).eval()
    plain = build_arch_from_lines(NARROW, 30, ops=kernels.PLAIN).to(cuda).eval()
    plain.load_state_dict(model.state_dict())
    feats = _randn((3, 200, 80), 1, cuda)
    flen = torch.tensor([200, 150, 90], device=cuda, dtype=torch.int32)
    kernels.reset_launches()
    with torch.no_grad():
        got, glen = model(feats, flen)
        want, wlen = plain(feats, flen)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"mfsc": 0, "time_conv": 5, "residual_ln": 6}
    assert torch.equal(glen, wlen)
    # fp32 end to end through 2 convs, 3 TDS blocks and per-frame LNs
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
