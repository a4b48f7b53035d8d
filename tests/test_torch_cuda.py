"""The port's CUDA kernels, forward and backward, and the autograd functions
built on them, against their plain PyTorch versions on the card.
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


# K1 at its edges, (sample rate, mels, stride ms, B, S): a ragged last tile
# (T = 98, 16-frame tiles), S < frame (T = 0), 8 kHz with S % 4 != 0 (4-byte
# audio copies), 40 mels, a stride of 100 samples (the CUDA-core route), the
# serving row (48-frame tiles), 32-frame tiles (B = 4, T = 1000), and B = 16
K1_CASES = [(16000, 80, 10.0, 2, 16000), (16000, 80, 10.0, 2, 300),
            (8000, 40, 10.0, 3, 12345), (16000, 40, 10.0, 2, 16000),
            (16000, 80, 6.25, 2, 16000), (16000, 80, 10.0, 4, 246000),
            (16000, 80, 10.0, 4, 160240), (16000, 80, 10.0, 16, 48000)]


@pytest.mark.parametrize("rate,n_mels,stride_ms,B,S", K1_CASES)
def test_mfsc_kernel_routes(cuda, rate, n_mels, stride_ms, B, S):
    from wav2letter_tpu_torch.kernels.mfsc import route, tile_frames

    p = FeatureParams(sample_rate=rate, n_filterbanks=n_mels, frame_stride_ms=stride_ms)
    f = Featurizer(p).to(cuda)
    pre = _randn((B, S), S + rate, cuda, scale=0.3)
    args = (pre, f.cos_mat, f.sin_mat, f.mel_fb, p.frame_samples, p.stride_samples,
            p.mel_floor)
    T = 1 + (S - p.frame_samples) // p.stride_samples if S >= p.frame_samples else 0
    assert route(p.frame_samples, p.stride_samples, f.mel_fb.shape[0], n_mels) == \
        ("tensor cores" if p.stride_samples % 8 == 0 else "CUDA cores")
    if (B, T) in ((2, 98), (4, 1536), (4, 1000)):
        assert tile_frames(B, T) == {98: 16, 1536: 48, 1000: 32}[T]
    before = kernels.LAUNCHES["mfsc"]
    got = kernels.mfsc(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, T, n_mels)
    assert kernels.LAUNCHES["mfsc"] == before + (T > 0)
    # fp32 sums (3xTF32 on the tensor cores) in another order; log-mel O(1-10)
    torch.testing.assert_close(got, kernels.mfsc_plain(*args), rtol=1e-4, atol=1e-4)


def test_mfsc_kernel_unaligned_audio_and_refusals(cuda):
    """Audio rows that do not start 16-byte aligned take 4-byte copies on the
    tensor-core route; a shape neither route takes raises."""
    f = Featurizer(FeatureParams(n_filterbanks=80)).to(cuda)
    full = _randn((1, 16001), 5, cuda, scale=0.3)
    pre = full[:, 1:]  # 4 bytes past an aligned start, still contiguous
    assert pre.is_contiguous() and pre.data_ptr() % 16 == 4
    args = (pre, f.cos_mat, f.sin_mat, f.mel_fb, 400, 160, 1.0)
    got = kernels.mfsc(*args)
    torch.testing.assert_close(got, kernels.mfsc_plain(*args), rtol=1e-4, atol=1e-4)
    wide = torch.zeros((400, 321), device=cuda)
    with pytest.raises(ValueError, match="CUDA-core kernel"):
        kernels.mfsc(pre, wide, wide, torch.zeros((321, 80), device=cuda), 400, 160, 1.0)


def test_mfsc_layout_twins_match(cuda):
    """The C twins of K1's layout (shared memory, route, tile) against the
    Python helpers the wrapper asks."""
    import importlib

    from wav2letter_tpu_torch.kernels import _build

    # the module, not the wrapper function that kernels/__init__.py exports
    K1 = importlib.import_module("wav2letter_tpu_torch.kernels.mfsc")
    lib = kernels.library()
    assert lib.w2l_mfsc_cc_max_bins() == K1.CC_MAX_BINS
    for frame, stride, nb, nm in [(400, 160, 257, 80), (200, 80, 129, 40), (400, 100, 257, 80),
                                  (40000, 8, 257, 80), (400, 160, 320, 80),
                                  (400, 160, 321, 80), (401, 160, 3, 1), (7, 8, 1, 200)]:
        for tt in K1.TC_TILES:
            assert lib.w2l_mfsc_tc_smem_bytes(tt, frame, stride, nb) == \
                K1.tc_smem_bytes(tt, frame, stride, nb)
        assert bool(lib.w2l_mfsc_tc_takes(frame, stride, nb, nm, _build.MAX_SMEM_BYTES)) == \
            K1.tc_takes(frame, stride, nb, nm)
    for B in range(1, 33):
        for T in (1, 15, 16, 17, 98, 500, 1536, 3000):
            for sms in (132, 114):
                assert lib.w2l_mfsc_tile_frames(B, T, sms) == K1.tile_frames(B, T, sms)


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


# K3 at its edges, (R, D): D not a multiple of 8 (bf16 to shared memory,
# fp32 to registers), D = 1, D past the register route (8192 bf16, 4096
# fp32), R = 1, the flagship's and the transformer's rows, the register
# route's widest rows
LN_EDGES = [(64, 100), (64, 1), (64, 9000), (1, 1280), (3000, 1280), (187, 2240),
            (768, 768), (5, 4096), (5, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", LN_EDGES)
def test_residual_ln_kernel_routes(cuda, dtype, R, D):
    from wav2letter_tpu_torch.kernels.layernorm import route

    x = _randn((R, D), R + 1, cuda, dtype)
    y = _randn((R, D), D + 1, cuda, dtype)
    w = torch.tensor([0.7], device=cuda)
    b = torch.tensor([0.3], device=cuda)
    n = 16 // x.element_size()
    assert (route(D, x.element_size()) == "registers") == (D % n == 0 and D <= 1024 * n)
    before = kernels.LAUNCHES["residual_ln"]
    out, mu, rsig = kernels.residual_ln(x, y, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["residual_ln"] == before + 1
    want, wmu, wrsig = kernels.residual_ln_plain(x, y, w, b)
    tol = 1e-5 if dtype == torch.float32 else 2e-2  # bf16 output rounding
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mu, wmu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rsig, wrsig, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_ln_kernel_unaligned_view(cuda, dtype):
    """Rows of a view that starts one element past an aligned address go
    through shared memory."""
    from wav2letter_tpu_torch.kernels.layernorm import route

    R, D = 50, 1280
    buf = _randn((R * D + 1,), 3, cuda, dtype)
    x = buf[1:].view(R, D)
    y = _randn((R, D), 4, cuda, dtype)
    w, b = torch.tensor([1.1], device=cuda), torch.tensor([0.1], device=cuda)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert route(D, x.element_size(), aligned=False) == "shared memory"
    out, mu, rsig = kernels.residual_ln(x, y, w, b)
    torch.cuda.synchronize()
    want, wmu, wrsig = kernels.residual_ln_plain(x, y, w, b)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mu, wmu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rsig, wrsig, rtol=1e-5, atol=1e-5)


def test_residual_ln_layout_twins_match(cuda):
    """The C twin of K3's register layout against the Python helper."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.layernorm import warps_per_row

    lib = kernels.library()
    for dtype, code in _build.DTYPE_CODES.items():
        item = torch.tensor([], dtype=dtype).element_size()
        for D in list(range(1, 8400, 3)) + [768, 1280, 1600, 1920, 2240, 4096, 8192, 8200]:
            assert lib.w2l_residual_ln_warps(D, code) == warps_per_row(D, item), (D, dtype)


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
    assert kernels.LAUNCHES == {"mfsc": 0, "time_conv": 5, "time_conv_wgrad": 0,
                                "residual_ln": 6, "residual_ln_bwd": 0, "mhsa": 0,
                                "mhsa_bwd": 0}
    assert torch.equal(glen, wlen)
    # fp32 end to end through 2 convs, 3 TDS blocks and per-frame LNs
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# backward kernels: K2 as dgrad, K2b (wgrad), K3b, and the autograd functions
# ---------------------------------------------------------------------------
def _conv_case(cuda, dtype, B, T, F, C, CO, K, s, lp, rp):
    x = _randn((B, T, F * C), T, cuda, dtype)
    w = _randn((K, C, CO), K, cuda, dtype, scale=0.1)
    Tout = (lp + T + rp - K) // s + 1
    dy = _randn((B, Tout, F * CO), Tout, cuda, dtype)
    return x, w, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", TCONV + [(1, 20, 3, 2, 3, 4, 1, 6, 0)])
def test_time_conv_dgrad_kernel(cuda, dtype, B, T, F, C, CO, K, s, lp, rp):
    _, w, dy = _conv_case(cuda, dtype, B, T, F, C, CO, K, s, lp, rp)
    before = dict(kernels.LAUNCHES)
    got = kernels.time_conv_dgrad(dy, w, F, T, s, (lp, rp))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["time_conv"] == before["time_conv"] + 1
    want = kernels.time_conv_dgrad_plain(dy, w, F, T, s, (lp, rp))
    assert got.shape == (B, T, F * C)
    # fp32 sums of <= K*CO = 336 products both sides; one bf16 output rounding
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", TCONV)
def test_time_conv_wgrad_kernel(cuda, dtype, B, T, F, C, CO, K, s, lp, rp):
    x, _, dy = _conv_case(cuda, dtype, B, T, F, C, CO, K, s, lp, rp)
    before = kernels.LAUNCHES["time_conv_wgrad"]
    got = kernels.time_conv_wgrad(x, dy, K, F, s, (lp, rp))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["time_conv_wgrad"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (K, C, CO)
    want = kernels.time_conv_wgrad_plain(x, dy, K, F, s, (lp, rp))
    # both sum <= B*Tout*F = 8000 exact products of O(1) values in fp32, in
    # another order: entries are O(100), fp32 rounding of the sum ~1e-4
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)
    again = kernels.time_conv_wgrad(x, dy, K, F, s, (lp, rp))
    assert torch.equal(got, again)  # two ordered passes, no atomics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(3000, 1280), (187, 2240), (70, 96)])
def test_residual_ln_bwd_kernel(cuda, dtype, R, D):
    x = _randn((R, D), R, cuda, dtype)
    y = _randn((R, D), D, cuda, dtype)
    g = _randn((R, D), R + D, cuda, dtype)
    w = torch.tensor([1.3], device=cuda)
    b = torch.tensor([-0.2], device=cuda)
    _, mu, rsig = kernels.residual_ln(x, y, w, b)
    before = kernels.LAUNCHES["residual_ln_bwd"]
    dz, row_g, row_gz = kernels.residual_ln_bwd(g, x, y, mu, rsig, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["residual_ln_bwd"] == before + 1
    wdz, wg, wgz = kernels.residual_ln_bwd_plain(g, x, y, mu, rsig, w)
    tol = 1e-5 if dtype == torch.float32 else 2e-2  # bf16 output rounding
    torch.testing.assert_close(dz.float(), wdz.float(), rtol=tol, atol=tol)
    # fp32 row sums of <= 2240 O(1) terms
    torch.testing.assert_close(row_g, wg, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(row_gz, wgz, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", TCONV[1:])
def test_time_conv_function_grads(cuda, dtype, B, T, F, C, CO, K, s, lp, rp):
    """The autograd function (K2, then mask + K2 dgrad + K2b) against autograd
    of the plain forward, with bias and ReLU."""
    x, w, dy = _conv_case(cuda, dtype, B, T, F, C, CO, K, s, lp, rp)
    bias = _randn((CO,), CO, cuda)
    grads = {}
    for name, fn in (("kernel", kernels.time_conv), ("plain", kernels.time_conv_plain)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        before = dict(kernels.LAUNCHES)
        out = fn(leaves[0], leaves[1], F, s, (lp, rp), leaves[2], relu=True)
        assert out.grad_fn is not None
        grads[name] = torch.autograd.grad(out, leaves, dy)
        if name == "kernel":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["time_conv"] == before["time_conv"] + 2
            assert kernels.LAUNCHES["time_conv_wgrad"] == before["time_conv_wgrad"] + 1
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want, scale in zip(grads["kernel"], grads["plain"], (1, 100, 100)):
        assert got.dtype == want.dtype and got.shape == want.shape
        # dw and dbias are sums of up to 8000 terms: O(100) entries
        err = (got.float() - want.float()).abs()
        bad = err > tol * scale + 10 * tol * want.float().abs()
        if dtype == torch.float32:
            assert not bad.any(), err.max().item()
        else:
            # in bf16 the two forwards round a few y of ~0 to different sides of
            # 0, so their ReLU masks differ there: one dy term (|dy*w| < 1) more
            # or less in under 0.1% of the entries
            assert bad.float().mean().item() <= 1e-3 and err.max().item() < 1.0


# Edge shapes of the bf16 tensor-core route, (B, T, F, C, CO, K, stride,
# lp, rp): C = 1 with two 16-tap steps; stride 2 with a ragged last tile
# (Tout = 25); F not a multiple of the block's 16 positions (40, 6); the
# largest weight the route admits (12 x 36 x 36, 62 KB in fp32); a block
# walking several tiles (Tout = 690); C = 2 (4-byte copies); CO odd; C = 20
# (8-byte copies and a k8 step)
TCONV_EDGE = [
    (1, 90, 24, 1, 8, 20, 1, 10, 9),
    (2, 51, 80, 16, 20, 11, 2, 8, 1),
    (2, 37, 40, 20, 24, 11, 1, 5, 5),
    (1, 33, 6, 8, 8, 3, 1, 1, 1),
    (1, 40, 80, 36, 36, 12, 1, 6, 5),
    (4, 700, 80, 28, 28, 11, 1, 10, 0),
    (1, 50, 80, 2, 6, 5, 1, 2, 2),
    (1, 29, 16, 4, 7, 10, 2, 7, 1),
    (3, 64, 80, 20, 20, 9, 1, 4, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", TCONV_EDGE)
def test_time_conv_edge_shapes(cuda, dtype, B, T, F, C, CO, K, s, lp, rp):
    """K2, K2 as dgrad and K2b at the edges of the tensor-core route, against
    their plain versions; K2b twice for equal bits."""
    x, w, dy = _conv_case(cuda, dtype, B, T, F, C, CO, K, s, lp, rp)
    bias = _randn((CO,), CO, cuda)
    tol = 1e-4 if dtype == torch.float32 else 1e-2  # fp32 sums; one bf16 output rounding
    got = kernels.time_conv(x, w, F, s, (lp, rp), bias, relu=True)
    want = kernels.time_conv_plain(x, w, F, s, (lp, rp), bias, relu=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    got = kernels.time_conv_dgrad(dy, w, F, T, s, (lp, rp))
    want = kernels.time_conv_dgrad_plain(dy, w, F, T, s, (lp, rp))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    got = kernels.time_conv_wgrad(x, dy, K, F, s, (lp, rp))
    want = kernels.time_conv_wgrad_plain(x, dy, K, F, s, (lp, rp))
    torch.cuda.synchronize()
    # as test_time_conv_wgrad_kernel: fp32 sums of exact products, another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)
    assert torch.equal(got, kernels.time_conv_wgrad(x, dy, K, F, s, (lp, rp)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_conv_wgrad_first_conv_equal_bits(cuda, dtype):
    """K2b at the flagship's first conv (C = 1, K = 9, stride 2) at B = 16:
    equal inputs, equal bits."""
    x, _, dy = _conv_case(cuda, dtype, 16, 600, 80, 1, 16, 9, 2, 6, 2)
    runs = [kernels.time_conv_wgrad(x, dy, 9, 80, 2, (6, 2)) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    torch.testing.assert_close(runs[0], kernels.time_conv_wgrad_plain(x, dy, 9, 80, 2, (6, 2)),
                               rtol=1e-4, atol=2e-2)


def test_time_conv_smem_formulas_match_the_kernels(cuda):
    """The Python mirrors the route and the wrappers evaluate without a card
    against the C layouts of the tensor-core K2 and K2b."""
    from wav2letter_tpu_torch.kernels import tconv

    lib = kernels.library()
    for C, CO, K, s in ((1, 16, 9, 2), (16, 20, 11, 2), (20, 24, 11, 2), (24, 28, 12, 1),
                        (28, 28, 11, 1), (36, 36, 12, 1), (2, 6, 5, 1), (1, 8, 20, 1),
                        (4, 7, 10, 2)):
        assert lib.w2l_time_conv_tc_smem_bytes(C, CO, K, s) == tconv.tc_smem_bytes(C, CO, K, s)
        assert lib.w2l_time_conv_wgrad_tc_smem_bytes(C, CO, K, s) == \
            tconv.tc_wgrad_smem_bytes(C, CO, K, s)
        assert lib.w2l_time_conv_wgrad_tc_reps(C, K) == tconv.tc_wgrad_units(C, K)[1]
        assert lib.w2l_time_conv_wgrad_window(C, CO, K, s) * 4 == \
            tconv.cc_wgrad_smem_bytes(C, CO, K, s, 1) - 4 * (-(-K * C * CO // 4) * 4)
    assert lib.w2l_time_conv_tile() == lib.w2l_time_conv_wgrad_tile() == tconv.CC_TT


def test_time_conv_function_skips_dgrad_without_input_grad(cuda):
    x, w, dy = _conv_case(cuda, torch.float32, 2, 40, 80, 1, 16, 9, 2, 6, 2)
    w.requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    out = kernels.time_conv(x, w, 80, 2, (6, 2))
    out.backward(dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["time_conv"] == before["time_conv"] + 1  # no dgrad
    assert kernels.LAUNCHES["time_conv_wgrad"] == before["time_conv_wgrad"] + 1
    assert x.grad is None and w.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_ln_function_grads(cuda, dtype):
    R, D = 187, 2240
    x, y, g = (_randn((R, D), s, cuda, dtype) for s in (1, 2, 3))
    w = torch.tensor([1.3], device=cuda)
    b = torch.tensor([-0.2], device=cuda)
    grads = {}
    for name, fn in (("kernel", kernels.residual_ln), ("plain", kernels.residual_ln_plain)):
        leaves = [t.clone().requires_grad_(True) for t in (x, y, w, b)]
        before = kernels.LAUNCHES["residual_ln_bwd"]
        out, mu, rsig = fn(*leaves)
        assert out.grad_fn is not None
        if name == "kernel":
            assert not mu.requires_grad and not rsig.requires_grad
        grads[name] = torch.autograd.grad(out, leaves, g)
        if name == "kernel":
            assert kernels.LAUNCHES["residual_ln_bwd"] == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for i, (got, want) in enumerate(zip(grads["kernel"], grads["plain"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        # dw, db: fp32 sums over R*D = 4e5 terms, O(1000); the plain bf16 path
        # rounds zhat*g to bf16 before summing, the kernel does not
        rt, at = (tol, tol) if i < 2 else ((1e-4, 0.1) if dtype == torch.float32 else (2e-2, 5.0))
        torch.testing.assert_close(got.float(), want.float(), rtol=rt, atol=at)


def _fd_check(fn, leaves, n_probe, eps, tol):
    """Central differences of L = sum(fn(*leaves) * r) at a few coordinates of
    each leaf against the gradients autograd returns for it, in fp32."""
    out = fn(*leaves)
    r = _randn(tuple(out.shape), 9, out.device)
    grads = torch.autograd.grad((out * r).sum(), leaves)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for leaf, grad in zip(leaves, grads):
            flat, gflat = leaf.view(-1), grad.reshape(-1)
            for i in rng.choice(flat.numel(), min(n_probe, flat.numel()), replace=False):
                old = flat[i].item()
                flat[i] = old + eps
                up = (fn(*leaves) * r).sum().item()
                flat[i] = old - eps
                down = (fn(*leaves) * r).sum().item()
                flat[i] = old
                assert abs((up - down) / (2 * eps) - gflat[i].item()) <= tol, \
                    (tuple(leaf.shape), int(i))


def test_time_conv_function_finite_differences(cuda):
    """The conv is linear in x, w and bias, so central differences are exact
    up to fp32 rounding of L (|L| ~ 30, eps 0.05: ~1e-4)."""
    B, T, F, C, CO, K, s, lp, rp = 1, 13, 3, 2, 3, 4, 2, 2, 1
    leaves = [_randn((B, T, F * C), 1, cuda).requires_grad_(True),
              _randn((K, C, CO), 2, cuda).requires_grad_(True),
              _randn((CO,), 3, cuda).requires_grad_(True)]
    _fd_check(lambda x, w, b: kernels.time_conv(x, w, F, s, (lp, rp), b), leaves,
              n_probe=12, eps=0.05, tol=2e-3)


def test_residual_ln_function_finite_differences(cuda):
    leaves = [_randn((5, 24), 1, cuda).requires_grad_(True),
              _randn((5, 24), 2, cuda).requires_grad_(True),
              torch.tensor([1.3], device=cuda, requires_grad=True),
              torch.tensor([-0.2], device=cuda, requires_grad=True)]
    # eps 1e-2: truncation ~1e-4, fp32 rounding of L (~10) / eps ~1e-3
    _fd_check(lambda x, y, w, b: kernels.residual_ln(x, y, w, b)[0], leaves,
              n_probe=10, eps=1e-2, tol=5e-3)


def test_wrappers_keep_the_graph(cuda):
    """A wrapper given a CUDA tensor that requires grad never returns a
    tensor without ``grad_fn``; without autograd it records nothing."""
    x = _randn((2, 30, 80 * 4), 1, cuda).requires_grad_(True)
    w = _randn((9, 4, 4), 2, cuda, scale=0.1)
    y = kernels.time_conv(x, w, 80, 1, (7, 1))
    assert y.grad_fn is not None
    out, _, _ = kernels.residual_ln(x.view(-1, 320), y.view(-1, 320),
                                    torch.ones(1, device=cuda), torch.zeros(1, device=cuda))
    assert out.grad_fn is not None
    with torch.no_grad():
        assert kernels.time_conv(x, w, 80, 1, (7, 1)).grad_fn is None


def test_model_training_grads_match_plain(cuda):
    """Loss and every parameter gradient of the narrow model in training mode
    (dropout 0), kernel path against plain path, fp32; and the launches of one
    forward + backward: 5 K2 + 4 dgrad (the first conv's input needs none),
    5 K2b, 6 K3, 6 K3b."""
    arch = [l.replace(" 0.1 ", " 0 ") for l in NARROW]
    torch.manual_seed(0)
    model = build_arch_from_lines(arch, 30).to(cuda).train()
    plain = build_arch_from_lines(arch, 30, ops=kernels.PLAIN).to(cuda).train()
    plain.load_state_dict(model.state_dict())
    feats = _randn((3, 200, 80), 1, cuda)
    flen = torch.tensor([200, 150, 90], device=cuda, dtype=torch.int32)
    kernels.reset_launches()
    losses = []
    for m in (model, plain):
        em, _ = m(feats, flen)
        loss = (em * _randn(tuple(em.shape), 2, cuda)).sum()
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"mfsc": 0, "time_conv": 9, "time_conv_wgrad": 5,
                                "residual_ln": 6, "residual_ln_bwd": 6, "mhsa": 0,
                                "mhsa_bwd": 0}
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        scale = q.grad.abs().max().item()
        # fp32 through 2 convs and 3 TDS blocks: 1e-3 of the leaf's largest entry
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-3, atol=1e-3 * scale, msg=name)


# ---------------------------------------------------------------------------
# K4 and K4b: fused attention with the relative-position bias
# ---------------------------------------------------------------------------
def _attn_inputs(B, T, H, Dh, masked, device, dtype):
    rng = np.random.RandomState(B * 100 + T)
    q, k, v, g = (torch.from_numpy(rng.randn(B, T, H * Dh).astype(np.float32) * 0.5)
                  .to(device=device, dtype=dtype) for _ in range(4))
    pos = torch.from_numpy(rng.randn(2 * T - 1, Dh).astype(np.float32) * 0.1)
    pos = pos.to(device=device, dtype=dtype)
    mb = np.zeros((B, T), np.float32)
    if masked:
        lens = rng.randint(max(1, T // 2), T + 1, B)
        mb = np.where(np.arange(T)[None] < lens[:, None], 0.0, -1e30).astype(np.float32)
    return q, k, v, pos, torch.from_numpy(mb).to(device), g


ATTN_SHAPES = [(2, 16, 2, 128, False), (2, 13, 2, 128, True), (1, 40, 4, 64, True),
               (3, 17, 1, 136, True), (2, 75, 4, 192, True), (1, 1, 2, 8, False)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,T,H,Dh,masked", ATTN_SHAPES)
def test_mhsa_kernel(cuda, B, T, H, Dh, masked, rate):
    q, k, v, pos, mb, _ = _attn_inputs(B, T, H, Dh, masked, cuda, torch.float32)
    before = kernels.LAUNCHES["mhsa"]
    got = kernels.mhsa(q, k, v, pos, mb, H, rate, 77)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mhsa"] == before + 1
    want = kernels.mhsa_plain(q, k, v, pos, mb, H, rate, 77)
    # fp32 sums of <= 192 + T terms in another order; the same keep mask
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,T,H,Dh,masked", ATTN_SHAPES)
def test_mhsa_kernel_bf16_shapes(cuda, B, T, H, Dh, masked, rate):
    q, k, v, pos, mb, _ = _attn_inputs(B, T, H, Dh, masked, cuda, torch.bfloat16)
    before = kernels.LAUNCHES["mhsa"]
    got = kernels.mhsa(q, k, v, pos, mb, H, rate, 77)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mhsa"] == before + 1
    want = kernels.mhsa_plain(q, k, v, pos, mb, H, rate, 77)
    # one bf16 rounding of the output, and of p where the fp32 sums differ
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=1e-2)


# T that cut K4's tiles of 16, 32 and 64 query rows and its chunks of 32 keys
# raggedly; the transformer's gate edge and the conformer's head; B = 1
K4_RAGGED = [(2, T, 2, 64, True) for T in (15, 16, 17, 31, 33, 63, 65, 129)] + [
    (2, 460, 4, 192, True), (2, 240, 4, 128, True), (1, 50, 3, 72, False)]
K4_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,T,H,Dh,masked", K4_RAGGED)
def test_mhsa_kernel_ragged_tiles(cuda, B, T, H, Dh, masked, rate, dtype):
    """Every tile height K4 can take (the picked one and each that fits)
    against the plain version, one launch per call."""
    from wav2letter_tpu_torch.kernels import attention

    q, k, v, pos, mb, _ = _attn_inputs(B, T, H, Dh, masked, cuda, dtype)
    want = kernels.mhsa_plain(q, k, v, pos, mb, H, rate, 77).float()
    rtol, atol = K4_TOL[dtype]
    for rows in (None,) + attention.FWD_ROWS:
        if rows and attention.fwd_smem_bytes(rows, T, Dh, q.element_size()) > \
                kernels._build.MAX_SMEM_BYTES:
            continue
        before = kernels.LAUNCHES["mhsa"]
        got = attention._launch_fwd(q, k, v, pos, mb, H, rate, 77, rows)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["mhsa"] == before + 1
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol, msg=f"rows {rows}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mhsa_kernel_is_reproducible(cuda, dtype):
    """No atomics: K4 twice on the same inputs gives the same bits."""
    q, k, v, pos, mb, _ = _attn_inputs(2, 75, 4, 192, True, cuda, dtype)
    a = kernels.mhsa(q, k, v, pos, mb, 4, 0.2, 5)
    b = kernels.mhsa(q, k, v, pos, mb, 4, 0.2, 5)
    assert torch.equal(a, b)


def test_mhsa_smem_formula_matches_the_kernel(cuda):
    from wav2letter_tpu_torch.kernels import attention

    lib = kernels.library()
    for dtype, item in ((0, 4), (1, 2)):
        for rows in attention.FWD_ROWS:
            for T, Dh in ((1, 8), (17, 136), (192, 192), (460, 192), (2048, 256)):
                assert lib.w2l_mhsa_fwd_smem_bytes(rows, T, Dh, dtype) == \
                    attention.fwd_smem_bytes(rows, T, Dh, item)


def test_mhsa_bwd_limits_match_the_kernel(cuda):
    """The Python mirrors that ``mhsa_takes`` evaluates without a card
    against the C formulas of K4b's limits."""
    from wav2letter_tpu_torch.kernels import attention

    lib = kernels.library()
    for dtype, item in ((0, 4), (1, 2)):
        assert lib.w2l_mhsa_max_head_dim(dtype, kernels._build.MAX_SMEM_BYTES) == \
            attention.bwd_max_head_dim(item)
        for rows in attention.FWD_ROWS:
            for T, Dh in ((1, 8), (17, 136), (192, 192), (2648, 192), (2729, 192),
                          (2048, 256)):
                assert lib.w2l_mhsa_bwd_smem_bytes(rows, T, Dh, dtype) == \
                    attention.bwd_smem_bytes(rows, T, Dh, item)


# K4b at the long-context transformer's shape (phase 9 of chip_smoke.py) and at
# the last T it takes there
K4B_LONG = [(2, 1712, 4, 192), (1, 2648, 1, 192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,Dh", K4B_LONG)
def test_mhsa_bwd_kernel_long_context(cuda, B, T, H, Dh, dtype):
    """K4b past the old limit of T + Dh <= 1816, dropout on, against its plain
    version; twice for equal bits."""
    q, k, v, pos, mb, g = _attn_inputs(B, T, H, Dh, True, cuda, dtype)
    got = kernels.mhsa_bwd(q, k, v, pos, mb, g, H, 0.2, 77)
    torch.cuda.synchronize()
    want = kernels.mhsa_bwd_plain(q, k, v, pos, mb, g, H, 0.2, 77)
    # each output against its largest entry: fp32 sums of up to B*H*T terms;
    # in bf16 p and ds are rounded before their products
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("dq", "dk", "dv", "dpos"), got, want):
        top = b.float().abs().max().item()
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=rtol * max(1.0, top),
                                   msg=name)
    again = kernels.mhsa_bwd(q, k, v, pos, mb, g, H, 0.2, 77)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,T,H,Dh,masked", ATTN_SHAPES)
def test_mhsa_bwd_kernel(cuda, B, T, H, Dh, masked, rate):
    q, k, v, pos, mb, g = _attn_inputs(B, T, H, Dh, masked, cuda, torch.float32)
    before = kernels.LAUNCHES["mhsa_bwd"]
    got = kernels.mhsa_bwd(q, k, v, pos, mb, g, H, rate, 77)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mhsa_bwd"] == before + 1
    want = kernels.mhsa_bwd_plain(q, k, v, pos, mb, g, H, rate, 77)
    for name, a, b in zip(("dq", "dk", "dv", "dpos"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)
    again = kernels.mhsa_bwd(q, k, v, pos, mb, g, H, rate, 77)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # ordered sums


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_mhsa_kernel_bf16(cuda, rate):
    q, k, v, pos, mb, g = _attn_inputs(2, 50, 4, 64, True, cuda, torch.bfloat16)
    got = kernels.mhsa(q, k, v, pos, mb, 4, rate, 5)
    want = kernels.mhsa_plain(q, k, v, pos, mb, 4, rate, 5)
    # one bf16 rounding of the output, and of p where the fp32 sums differ
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=1e-2)
    gb = kernels.mhsa_bwd(q, k, v, pos, mb, g, 4, rate, 5)
    wb = kernels.mhsa_bwd_plain(q, k, v, pos, mb, g, 4, rate, 5)
    for name, a, b in zip(("dq", "dk", "dv", "dpos"), gb, wb):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=1e-2, msg=name)


def test_mhsa_function_gradients(cuda):
    """The autograd function records K4b: a wrapper that returned a tensor
    without grad_fn would train nothing."""
    q, k, v, pos, mb, g = _attn_inputs(2, 21, 2, 32, True, cuda, torch.float32)
    grads = {}
    for side, fn in (("kernel", kernels.mhsa), ("plain", kernels.mhsa_plain)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pos)]
        before = dict(kernels.LAUNCHES)
        out = fn(*leaves, mb, 2, 0.25, 9)
        assert out.grad_fn is not None
        grads[side] = torch.autograd.grad(out, leaves, g)
        if side == "kernel":
            assert kernels.LAUNCHES["mhsa"] == before["mhsa"] + 1
            assert kernels.LAUNCHES["mhsa_bwd"] == before["mhsa_bwd"] + 1
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_mhsa_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, pos, mb, _ = _attn_inputs(1, 8, 2, 12, False, cuda, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.mhsa(q, k, v, pos, mb, 2)
    q, k, v, pos, mb, _ = _attn_inputs(1, 8, 2, 16, False, cuda, torch.float32)
    with pytest.raises(TypeError):
        kernels.mhsa(q.half(), k.half(), v.half(), pos.half(), mb, 2)
    with pytest.raises(ValueError):
        kernels.mhsa(q, k, v, pos[:-1], mb, 2)


# recipes/transformer_ctc/network.arch at width 64 and recipes/conformer_ctc at
# width 32: head width 16 and 8, relative-position tables of 40 and 60 frames
TRANSFORMER_NARROW = [
    "V -1 1 80 0", "WN 3 C 80 64 3 1 -1", "GLU 2", "M 1 1 2 1", "WN 3 C 32 128 3 1 -1",
    "GLU 2", "M 1 1 2 1", "RO 2 0 3 1", "TR 64 128 4 40 0.2 0.1", "TR 64 128 4 40 0.2 0.1",
    "L 64 30",
]
CONFORMER_NARROW = [
    "V -1 1 80 0", "C 80 32 7 3 3", "R", "RO 2 0 3 1", "CFR 32 64 4 60 7 0.1 0.05",
    "CFR 32 64 4 60 7 0.1 0.05", "L 32 30",
]


@pytest.mark.parametrize("arch,k4,k3", [(TRANSFORMER_NARROW, 2, 4), (CONFORMER_NARROW, 2, 0)])
def test_attention_model_kernels_match_plain(cuda, arch, k4, k3):
    """Forward in eval mode and, with the layers in eval mode but autograd on,
    every parameter gradient: kernel path (K4, K4b, K3, K3b) against plain
    path, fp32; and the launches of one forward + backward."""
    torch.manual_seed(0)
    model = build_arch_from_lines(arch, 30).to(cuda).eval()
    plain = build_arch_from_lines(arch, 30, ops=kernels.PLAIN).to(cuda).eval()
    plain.load_state_dict(model.state_dict())
    feats = _randn((3, 150, 80), 1, cuda)
    flen = torch.tensor([150, 120, 70], device=cuda, dtype=torch.int32)
    kernels.reset_launches()
    losses = []
    for m in (model, plain):
        em, _ = m(feats, flen)
        loss = (em * _randn(tuple(em.shape), 2, cuda)).sum()
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"mfsc": 0, "time_conv": 0, "time_conv_wgrad": 0,
                                "residual_ln": k3, "residual_ln_bwd": k3, "mhsa": k4,
                                "mhsa_bwd": k4}
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    top = max(q.grad.abs().max().item() for q in plain.parameters())
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        # against the leaf's largest entry, but not less than 1% of the whole
        # gradient's: a bias on the keys (softmax ignores it) and a LayerNorm
        # bias that the next LayerNorm removes have no true gradient, only rounding
        scale = max(q.grad.abs().max().item(), 1e-2 * top)
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-3, atol=1e-3 * scale, msg=name)


def test_attention_beyond_the_table_takes_the_unfused_path(cuda):
    torch.manual_seed(0)
    model = build_arch_from_lines(TRANSFORMER_NARROW, 30).to(cuda).eval()
    kernels.reset_launches()
    with torch.no_grad():
        em, _ = model(_randn((2, 400, 80), 3, cuda), None)  # 100 frames > 40
    assert em.shape == (2, 100, 30) and torch.isfinite(em).all()
    assert kernels.LAUNCHES["mhsa"] == 0 and kernels.LAUNCHES["residual_ln"] == 4


def test_attention_training_mode_on_the_card(cuda):
    """Dropout, attention dropout and layerdrop on: the kernel path and the
    plain path draw the same seeds from the same ``torch.manual_seed`` and
    the same keep mask from them, so they still agree."""
    torch.manual_seed(0)
    arch = [l.replace("DO 0.1", "DO 0") for l in TRANSFORMER_NARROW]
    model = build_arch_from_lines(arch, 30).to(cuda).train()
    plain = build_arch_from_lines(arch, 30, ops=kernels.PLAIN).to(cuda).train()
    plain.load_state_dict(model.state_dict())
    feats = _randn((3, 150, 80), 1, cuda)
    flen = torch.tensor([150, 120, 70], device=cuda, dtype=torch.int32)
    outs = []
    for m in (model, plain, model):
        torch.manual_seed(11)
        outs.append(m(feats, flen)[0])
    assert torch.equal(outs[0], outs[2])
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_past_k4b_limit_trains_unfused(cuda, dtype):
    """A TR layer whose table reaches past K4b's limit, which is K4's (Dh = 8:
    T <= 3072): at T = 3072 an update takes K4 and K4b; at T = 3076 serving
    and an update take the unfused path, with no error; each agrees with the
    plain path."""
    from wav2letter_tpu_torch.models.transformer import MultiHeadSelfAttention

    torch.manual_seed(0)
    m = MultiHeadSelfAttention(16, 8, 2, 3080).to(cuda).eval()
    plain = MultiHeadSelfAttention(16, 8, 2, 3080, ops=kernels.PLAIN).to(cuda).eval()
    plain.load_state_dict(m.state_dict())
    tol = 1e-4 if dtype == torch.float32 else 3e-2  # 3076-term sums; bf16 rounding of p
    for T, fused in ((3072, 1), (3076, 0)):
        x = _randn((1, 2, T, 16), 4, cuda, dtype)
        kernels.reset_launches()
        with torch.no_grad():
            served = m(x)
        assert kernels.LAUNCHES["mhsa"] == fused
        out = m(x)
        out.float().square().sum().backward()
        assert kernels.LAUNCHES["mhsa"] == 2 * fused and kernels.LAUNCHES["mhsa_bwd"] == fused
        assert all(torch.isfinite(p.grad).all() for p in m.parameters())
        m.zero_grad()
        with torch.no_grad():
            want = plain(x)
        for got in (served, out.detach()):
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_past_the_limit_drops_as_the_fused_function(cuda, dtype, monkeypatch):
    """Just past K4's limit (Dh = 8: T = 3076), an update at attention
    dropout 0.2: the unfused path draws the fused function's hash keep mask
    from the same seed, so its output and gradients agree with the fused
    plain path (``mhsa_plain``). Its peak memory over the update is printed
    beside that of the path it replaced there, ``F.dropout`` on the same
    probabilities (the gate switched off), and exceeds it by no more than the
    keep mask's int64 block temporaries."""
    from wav2letter_tpu_torch.models import transformer as TM

    torch.manual_seed(0)
    m = TM.MultiHeadSelfAttention(16, 8, 2, 3080, 0.2).to(cuda).train()
    plain = TM.MultiHeadSelfAttention(16, 8, 2, 3080, 0.2, ops=kernels.PLAIN).to(cuda).train()
    plain.load_state_dict(m.state_dict())
    x = _randn((1, 2, 3076, 16), 4, cuda, dtype)
    g = _randn((1, 2, 3076, 16), 5, cuda)

    def update(mod):
        mod.zero_grad()
        xx = x.clone().requires_grad_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(7)
        out = mod(xx)
        (out.float() * g).sum().backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        return [out.detach(), xx.grad] + [p.grad.clone() for p in mod.parameters()], peak

    assert m.in_gate(x) and not m.fused(x)
    kernels.reset_launches()
    got, peak = update(m)
    assert kernels.LAUNCHES["mhsa"] == 0 and kernels.LAUNCHES["mhsa_bwd"] == 0
    with monkeypatch.context() as mp:
        mp.setattr(TM.MultiHeadSelfAttention, "in_gate", lambda self, x: False)
        _, parent_peak = update(m)
    print(f"\n[peak] {dtype}: hash dropout {peak / 2**20:.1f} MiB, "
          f"F.dropout {parent_peak / 2**20:.1f} MiB")
    # at most a few blocks of 2^22 int64 counters (32 MiB each); the mask
    # hashed whole adds int64 copies of all 37.8M counters (357 MiB in fp32
    # on an H100 80GB HBM3)
    assert peak <= parent_peak + 4 * 32 * 2**20
    monkeypatch.setattr(TM, "_use_kernel", lambda *a: True)  # the fused plain path
    want, _ = update(plain)
    # 3076-term sums; in bf16 also the rounding of p (before the scale here,
    # after it in the plain version) and bf16 products in the unfused backward
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        top = b.float().abs().max().item()
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol * max(1.0, top))


def test_emissions_topk_on_the_card(cuda, tmp_path):
    """``Evaluator.emissions_topk`` on the card: exactly ``torch.topk`` of its
    own emissions, and the top-k of the CPU's emissions (plain versions) where
    a frame's k-th and (k+1)-th values lie apart by more than twice the fp32
    emission tolerance of ``test_model_kernels_match_plain``."""
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.checkpoint import Checkpoint, save_checkpoint
    from wav2letter_tpu_torch.runtime.test import Evaluator

    arch, tokens, am = tmp_path / "narrow.arch", tmp_path / "tokens.txt", tmp_path / "m.pt"
    arch.write_text("\n".join(NARROW) + "\n")
    tokens.write_text("|\n" + "\n".join(f"t{i}" for i in range(28)) + "\n")
    torch.manual_seed(0)
    model = build_arch_from_lines(NARROW, 30)
    cfg = Config(arch=str(arch), tokens=str(tokens), criterion="ctc", mfsc=True,
                 filterbanks=80, compute_dtype="float32")
    save_checkpoint(str(am), Checkpoint(cfg.serialize(), 0, 0, model.state_dict()))
    audio = np.random.RandomState(3).randn(3, 32000).astype(np.float32) * 0.5
    batch = {"audio": audio, "audio_len": np.asarray([32000, 24000, 15000], np.int32)}
    k = 5
    ev = Evaluator(Config(am=str(am)), device="cuda")
    vals, idx, elen = ev.emissions_topk(batch, k)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    em, elen2 = ev.emissions(batch)
    want_v, want_i = torch.topk(em, k, dim=-1)
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i.int())
    assert torch.equal(elen, elen2)
    cpu_em, cpu_len = Evaluator(Config(am=str(am)), device="cpu").emissions(batch)
    assert torch.equal(elen.cpu(), cpu_len)
    srt = cpu_em.sort(dim=-1, descending=True).values
    apart = (srt[..., k - 1] - srt[..., k]) > 2e-3
    assert apart.float().mean() > 0.9
    cv, ci = torch.topk(cpu_em, k, dim=-1)
    got_sets = idx.cpu().sort(dim=-1).values
    assert torch.equal(got_sets[apart], ci.int().sort(dim=-1).values[apart])
    torch.testing.assert_close(vals.cpu(), cv, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# streaming: the flagship's structure narrowed, chunk by chunk on the card
# ---------------------------------------------------------------------------
def _narrow_flagship():
    """``recipes/streaming_convnets/network.arch`` without SAUG, its TDS
    frequency width and NFEAT at 16, 30 labels (as
    ``tests/test_torch_streaming.py``)."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "recipes/streaming_convnets/network.arch")) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    return [l.replace(" 80 ", " 16 ").replace("2240", "448").replace("NFEAT", "16")
            .replace("NLABEL", "30") for l in lines if not l.startswith("SAUG")]


def _stream_launches(net, states, n_in):
    """(K2, K3) launches of pushing n_in frames through ``net`` from these
    states: one K2 for each time-only conv and TDS block that emits frames,
    two K3 for each such block (``out_frames`` of each layer)."""
    from wav2letter_tpu_torch.inference.streaming import StreamConv, StreamTDS

    k2 = k3 = 0
    n = n_in
    for layer, st in zip(net.layers, states):
        if isinstance(layer, (StreamConv, StreamTDS)):
            n, _ = layer.out_frames(st.shape[1], n)
            if n and (isinstance(layer, StreamTDS) or layer.module.time_only):
                k2 += 1
                k3 += 2 * isinstance(layer, StreamTDS)
    return k2, k3


@pytest.mark.parametrize("chunk", [8, 37, 50])
def test_stream_on_the_card_matches_the_cpu(cuda, chunk):
    """The stream through K2 and K3 on the card against the same stream on
    the CPU through their plain versions, chunk by chunk, with the launches
    of each step counted against ``out_frames``."""
    from wav2letter_tpu_torch.inference import StreamingNetwork
    from wav2letter_tpu_torch.inference.convert import build_streaming_layers, map_params

    lines = _narrow_flagship()
    torch.manual_seed(0)
    sd = build_arch_from_lines(lines, 30).state_dict()
    params = map_params(build_streaming_layers(lines, 16)[1], sd)
    nets = {d: StreamingNetwork(build_streaming_layers(lines, 16)[0], params, device=d)
            for d in ("cuda", "cpu")}
    feats = np.random.RandomState(2).randn(1, 200, 16, 1).astype(np.float32)
    states = {d: n.start(1) for d, n in nets.items()}
    outs = {"cuda": [], "cpu": []}
    for s in range(0, 200, chunk):
        want_k2, want_k3 = _stream_launches(nets["cuda"], states["cuda"],
                                            feats[:, s:s + chunk].shape[1])
        kernels.reset_launches()
        for d, net in nets.items():
            states[d], y = net.run(states[d], feats[:, s:s + chunk])
            outs[d].append(y.cpu())
        torch.cuda.synchronize()
        assert (kernels.LAUNCHES["time_conv"], kernels.LAUNCHES["residual_ln"]) == \
            (want_k2, want_k3)
    for d, net in nets.items():
        states[d], y = net.finish(states[d])
        outs[d].append(y.cpu())
    got, want = torch.cat(outs["cuda"], 1), torch.cat(outs["cpu"], 1)
    assert got.shape == want.shape == (1, 25, 1, 30)
    # fp32 through 4 convs and 11 TDS blocks, as test_model_kernels_match_plain
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


def test_streaming_featurizer_on_the_card(cuda):
    """K1 on 500 ms chunks with the running local CMVN on the card against
    the CPU's plain K1; the first frames' short CMVN windows amplify the
    rounding (``tests/test_torch_streaming.py``)."""
    from wav2letter_tpu_torch.inference import StreamingFeaturizer

    p = FeatureParams(n_filterbanks=80, local_norm_left=300)
    audio = (0.4 * np.random.RandomState(6).randn(3 * 16000 + 123)).astype(np.float32)
    outs = {}
    for d in ("cuda", "cpu"):
        sf = StreamingFeaturizer(p, device=d)
        st, got = sf.start(), []
        for s in range(0, len(audio), 8000):
            kernels.reset_launches()
            st, f = sf.run(st, audio[s:s + 8000])
            assert kernels.LAUNCHES["mfsc"] == (d == "cuda" and len(f) > 0)
            got.append(f.cpu())
        outs[d] = torch.cat(got)
    torch.testing.assert_close(outs["cuda"][8:], outs["cpu"][8:], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outs["cuda"][:8], outs["cpu"][:8], rtol=2e-3, atol=2e-3)


# K2 on one-output windows at B = 1, the shapes a stream's last steps give:
# (F, C, CO, K, stride) of the flagship's convs and TDS blocks
STREAM_CONVS = [(80, 1, 16, 9, 2), (80, 16, 20, 11, 2), (80, 20, 24, 11, 2),
                (80, 24, 28, 12, 1), (80, 16, 16, 9, 1), (80, 28, 28, 11, 1)]


@pytest.mark.parametrize("F,C,CO,K,s", STREAM_CONVS)
@pytest.mark.parametrize("extra", [0, 1])
def test_time_conv_stream_windows(cuda, F, C, CO, K, s, extra):
    """A window of K + extra frames, no pads: Tout = 1 (extra < stride, or
    2 at stride 1 with one extra frame), bias and ReLU as a TDS block."""
    x = _randn((1, K + extra, F * C), K + C, cuda)
    w = _randn((K, C, CO), K, cuda, scale=0.1)
    bias = _randn((CO,), CO, cuda)
    for relu in (False, True):
        args = (x, w, F, s, (0, 0), bias, relu)
        got = kernels.time_conv(*args)
        assert got.shape == (1, extra // s + 1, F * CO)
        torch.testing.assert_close(got, kernels.time_conv_plain(*args), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("R", [1, 2, 7, 25])
@pytest.mark.parametrize("D", [1280, 1600, 1920, 2240])
def test_residual_ln_stream_rows(cuda, R, D):
    """K3 on the few rows of a streaming step, x a time slice of a window
    (the residual's aligned frames) as the stream passes it."""
    win = _randn((R + 3, D), R + D, cuda)
    x, y = win[2:2 + R], _randn((R, D), D, cuda)
    w, b = torch.tensor([1.3], device=cuda), torch.tensor([-0.2], device=cuda)
    got = kernels.residual_ln(x, y, w, b)
    want = kernels.residual_ln_plain(x, y, w, b)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fp32 K2, dgrad and K2b on the tensor cores (3xTF32)
# ---------------------------------------------------------------------------
# (T, F, C, CO, K, stride) of the stream's batch-1 windows (16-60 frames, no
# pads): the first C2, the first and the last TDS conv, and the C2s between
TF32_STREAM = [(58, 80, 1, 16, 9, 2), (33, 80, 16, 16, 9, 1), (16, 80, 28, 28, 11, 1),
               (60, 80, 16, 20, 11, 2), (44, 80, 20, 24, 11, 2), (27, 80, 24, 28, 12, 1)]


@pytest.mark.parametrize("T,F,C,CO,K,s", TF32_STREAM)
def test_time_conv_fp32_stream_windows(cuda, T, F, C, CO, K, s):
    """fp32 K2, its dgrad and K2b at B = 1 windows route to the tensor cores
    (the split-tap or one-frame-a-warp schedule) and hold their plain
    versions; K2b twice for equal bits."""
    from wav2letter_tpu_torch.kernels import tconv

    x, w, dy = _conv_case(cuda, torch.float32, 1, T, F, C, CO, K, s, 0, 0)
    bias = _randn((CO,), CO, cuda)
    for kind in ("conv", "dgrad", "wgrad"):
        assert tconv.route(torch.float32, C, CO, K, s, F, kind) == "tensor cores"
    Tout = dy.shape[1]
    plan = tconv.tf32_plan(1, Tout, F, C, CO, K, s, torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    assert plan[3] == 1 and (plan[2] > 1 or C == 1)  # one frame a block, or C = 1
    got = kernels.time_conv(x, w, F, s, (0, 0), bias, relu=True)
    torch.testing.assert_close(got, kernels.time_conv_plain(x, w, F, s, (0, 0), bias, True),
                               rtol=1e-4, atol=1e-4)
    got = kernels.time_conv_dgrad(dy, w, F, T, s, (0, 0))
    torch.testing.assert_close(got, kernels.time_conv_dgrad_plain(dy, w, F, T, s, (0, 0)),
                               rtol=1e-4, atol=1e-4)
    got = kernels.time_conv_wgrad(x, dy, K, F, s, (0, 0))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kernels.time_conv_wgrad_plain(x, dy, K, F, s, (0, 0)),
                               rtol=1e-4, atol=2e-3)
    assert torch.equal(got, kernels.time_conv_wgrad(x, dy, K, F, s, (0, 0)))


@pytest.mark.parametrize("case", [(2, 51, 80, 16, 20, 11, 2, 8, 1),
                                  (1, 45, 40, 20, 24, 11, 2, 3, 4),
                                  (3, 70, 80, 28, 28, 11, 1, 10, 0)])
def test_time_conv_fp32_ragged_strided_tiles(cuda, case):
    """fp32 K2, dgrad and K2b where the last tile is ragged (Tout not a
    multiple of the tile), strided, F not a multiple of 16; the fp32 route
    is the tensor cores'."""
    from wav2letter_tpu_torch.kernels import tconv

    B, T, F, C, CO, K, s, lp, rp = case
    x, w, dy = _conv_case(cuda, torch.float32, *case)
    bias = _randn((CO,), CO, cuda)
    assert all(tconv.route(torch.float32, C, CO, K, s, F, k) == "tensor cores"
               for k in ("conv", "dgrad", "wgrad"))
    got = kernels.time_conv(x, w, F, s, (lp, rp), bias, relu=True)
    torch.testing.assert_close(got, kernels.time_conv_plain(x, w, F, s, (lp, rp), bias, True),
                               rtol=1e-4, atol=1e-4)
    got = kernels.time_conv_dgrad(dy, w, F, T, s, (lp, rp))
    torch.testing.assert_close(got, kernels.time_conv_dgrad_plain(dy, w, F, T, s, (lp, rp)),
                               rtol=1e-4, atol=1e-4)
    got = kernels.time_conv_wgrad(x, dy, K, F, s, (lp, rp))
    torch.testing.assert_close(got, kernels.time_conv_wgrad_plain(x, dy, K, F, s, (lp, rp)),
                               rtol=1e-4, atol=2e-3)
    assert torch.equal(got, kernels.time_conv_wgrad(x, dy, K, F, s, (lp, rp)))


def test_time_conv_fp32_twins_match_the_kernels(cuda):
    """The fp32 route's Python shared-memory formulas and schedule against
    their C twins."""
    import ctypes

    from wav2letter_tpu_torch.kernels import tconv

    lib = kernels.library()
    shapes = [(1, 16, 9, 2), (16, 16, 9, 1), (16, 20, 11, 2), (20, 20, 9, 1), (20, 24, 11, 2),
              (24, 24, 11, 1), (24, 28, 12, 1), (28, 28, 11, 1), (36, 36, 12, 1), (2, 6, 5, 1),
              (1, 8, 20, 1), (4, 7, 10, 2), (5, 3, 3, 1), (8, 1, 4, 1)]
    for C, CO, K, s in shapes:
        for mw, mt, ks in ((8, 2, 1), (8, 1, 1), (4, 1, 1), (1, 1, 4), (1, 1, 2)):
            assert lib.w2l_time_conv_tf32_smem_bytes(C, CO, K, s, mw, mt, ks) == \
                tconv.tf32_smem_bytes(C, CO, K, s, mw, mt, ks)
        assert lib.w2l_time_conv_wgrad_tf32_smem_bytes(C, CO, K, s) == \
            tconv.tf32_wgrad_smem_bytes(C, CO, K, s)
        for B, Tout, F in ((1, 25, 80), (1, 6, 80), (4, 768, 80), (16, 192, 80), (4, 50, 40),
                           (16, 768, 80), (2, 3, 24)):
            for sms in (132, 114):
                plan = (ctypes.c_int * 5)()
                assert lib.w2l_time_conv_tf32_plan(B, Tout, F, C, CO, K, s, sms, plan) == 0
                assert tuple(plan) == tconv.tf32_plan(B, Tout, F, C, CO, K, s, sms)


# ---------------------------------------------------------------------------
# data and tensor parallelism across cards: NCCL, one rank a card
# ---------------------------------------------------------------------------
CARDS_BATCH, CARDS_UPDATES = 16, 4  # global batch and updates of every run


def _cli_train(args, nproc, timeout=900):
    """``cli.train`` in one process, or under torchrun on ``nproc`` ranks;
    returns its standard output (rank 0's log lines)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable]
    if nproc > 1:
        cmd += ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}"]
    cmd += ["-m", "wav2letter_tpu_torch.cli.train", "train"] + args
    if nproc > 1:
        cmd += ["--enable_distributed", f"--world_size={nproc}"]
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def ranks_against_one_process(root, arch_src, nproc, device_flags=()):
    """The flagship (or ``arch_src``) with dropout 0 and no SAUG trained
    ``CARDS_UPDATES`` updates at global batch ``CARDS_BATCH``: in one
    process, on ``nproc`` ranks (data parallel) and, for an even ``nproc``,
    on (nproc/2) x 2 ranks (tensor parallel). Returns each run's distance to
    the one process relative to the distance it moved, and rank 0's last
    status line."""
    import os
    import re

    import chip_smoke as cs
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    lst, tokens, lexicon, _ = cs.synth_dataset(os.path.join(root, "data"), 7, CARDS_BATCH,
                                               "train", dur=(4.0, 8.0))
    arch = cs._cut_arch(arch_src, os.path.join(root, "do0.arch"))
    base = [f"--train={lst}", f"--tokens={tokens}", f"--lexicon={lexicon}",
            f"--rundir={root}", f"--arch={arch}", "--criterion=ctc", "--mfsc=true",
            f"--filterbanks={cs.N_FEAT}", "--localnrmlleftctx=300", "--onorm=target",
            "--sqnorm=true", "--netoptim=sgd", "--lr=0.05", "--momentum=0.9",
            "--maxgradnorm=0.5", f"--iter={CARDS_UPDATES}", f"--reportiters={CARDS_UPDATES}",
            "--compute_dtype=float32", "--nthread=2", "--seed=0", *device_flags]
    runs = {"one": (1, CARDS_BATCH, [])}
    runs[f"dp{nproc}"] = (nproc, CARDS_BATCH // nproc, [])
    if nproc % 2 == 0:
        runs[f"dp{nproc // 2}xmp2"] = (nproc, 2 * CARDS_BATCH // nproc, ["--mp_axis=2"])
    out, params = {}, {}
    for name, (n, batch, extra) in runs.items():
        log = _cli_train(base + [f"--runname={name}", f"--batchsize={batch}"] + extra, n)
        status = [l for l in log.splitlines() if l.startswith("epoch:")][-1]
        phases = re.findall(r"(?<!-)\b(bch|fwd|bwd|optim)\(ms\): ([\d.]+)", status)
        out[name] = dict(ranks=n, batch=batch, status=status,
                         **{k: float(v) for k, v in phases})
        ckpt = load_checkpoint(os.path.join(root, name, "model_last.bin"))
        assert ckpt.updates == CARDS_UPDATES
        params[name] = ckpt.state_dict
    torch.manual_seed(0)  # the trainers' seed: their starting weights
    p0 = build_arch_module(arch, cs.N_FEAT, cs.N_TOKENS + 1).state_dict()
    moved = torch.sqrt(sum((params["one"][k] - p0[k]).double().pow(2).sum() for k in p0))
    for name in runs:
        diff = torch.sqrt(sum((params[name][k] - params["one"][k]).double().pow(2).sum()
                              for k in p0))
        out[name]["rel_to_one_process"] = (diff / moved).item()
    return out


def test_ranks_across_cards(cuda, tmp_path):
    """N cards (NCCL, torchrun) equal one card on the same global batch:
    data parallel, and tensor parallel over pairs of cards (TDS linears and
    the output layer split), each within ``chip_smoke.DP_TOL`` of the
    distance the one process moved. Needs two cards or more."""
    import json

    import chip_smoke as cs

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    out = ranks_against_one_process(str(tmp_path), cs.ARCH, n)
    print(json.dumps({"cards": n, "device": torch.cuda.get_device_name(0), "runs": out}))
    for name, r in out.items():
        assert r["rel_to_one_process"] <= cs.DP_TOL["float32"][1], (name, r)


# ---------------------------------------------------------------------------
# ASG, forced alignment and the ASG and ResNet recipes (plain PyTorch on the
# card: no kernel of their own; the recipes' features go through K1)
# ---------------------------------------------------------------------------
def _asg_inputs(device, B=4, T=300, N=31, U=60, seed=0):
    rng = np.random.RandomState(seed)
    em = torch.from_numpy((3.0 * rng.randn(B, T, N)).astype(np.float32))
    trans = torch.from_numpy((0.5 * rng.randn(N, N) + 4.0 * np.eye(N)).astype(np.float32))
    emis_len = torch.tensor([T, T - 37, T // 2, 11], dtype=torch.int32)
    target_len = torch.tensor([U, U // 2, 17, 20], dtype=torch.int32)  # row 3 cannot fit
    targets = torch.full((B, U), -1, dtype=torch.int32)
    for i in range(B):
        targets[i, : target_len[i]] = torch.from_numpy(rng.randint(0, N, int(target_len[i])))
    return [a.to(device) for a in (em, trans, targets, emis_len, target_len)]


def _path_score(em, trans, path, emis_len):
    """(B,) the max-product score of each row's frame path on its frames."""
    path = path.long()
    e = em.gather(2, path[..., None])[..., 0]
    tr = trans[path[:, 1:], path[:, :-1]]
    t = torch.arange(em.shape[1], device=em.device)[None, :]
    valid = t < emis_len[:, None].long()
    return (e * valid).sum(1) + (tr * valid[:, 1:]).sum(1)


def test_asg_loss_on_the_card_matches_the_cpu(cuda):
    from wav2letter_tpu_torch.ops.asg import asg_loss

    out = []
    for dev in ("cpu", cuda):
        em, trans, targets, emis_len, target_len = _asg_inputs(dev)
        em.requires_grad_(True)
        trans.requires_grad_(True)
        loss = asg_loss(em, trans, targets, emis_len, target_len)
        w = torch.arange(1, 5, device=em.device, dtype=torch.float32)
        (loss.clamp(max=1e6) * w).sum().backward()
        out.append([t.detach().cpu() for t in (loss, em.grad, trans.grad)])
    (lc, gec, gtc), (lg, geg, gtg) = out
    assert lc[3] == lg[3] == 1e30  # the row that cannot fit: JAX's finite loss
    # T-step fp32 log-space recursions in another order: 1e-4 relative
    torch.testing.assert_close(lg[:3], lc[:3], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(geg, gec, rtol=1e-4, atol=1e-4 * gec.abs().max().item())
    torch.testing.assert_close(gtg, gtc, rtol=1e-4, atol=1e-4 * gtc.abs().max().item())


def test_asg_viterbi_on_the_card_matches_the_cpu(cuda):
    from wav2letter_tpu_torch.ops.asg import asg_viterbi

    em, trans, _, emis_len, _ = _asg_inputs("cpu", seed=1)
    want = asg_viterbi(em, trans, emis_len)
    got = asg_viterbi(em.to(cuda), trans.to(cuda), emis_len.to(cuda)).cpu()
    differ = (got != want).any(dim=1)
    # paths equal, or as good a max-product score where one differs
    torch.testing.assert_close(_path_score(em, trans, got, emis_len)[differ],
                               _path_score(em, trans, want, emis_len)[differ],
                               rtol=1e-4, atol=1e-4)
    assert int(differ.sum()) <= 1


@pytest.mark.parametrize("kind", ["ctc", "asg"])
def test_forced_align_on_the_card_matches_the_cpu(cuda, kind):
    from wav2letter_tpu_torch.ops.align import asg_forced_align, ctc_forced_align

    em, trans, targets, emis_len, target_len = _asg_inputs("cpu", seed=2)
    target_len[3] = 5  # every row fits
    targets[3, 5:] = -1
    targets = torch.where(targets == em.shape[-1] - 1, torch.zeros_like(targets), targets)

    def run(dev):
        args = [a.to(dev) for a in (em, trans, targets, emis_len, target_len)]
        if kind == "ctc":
            return ctc_forced_align(args[0], *args[2:])
        return asg_forced_align(*args)

    (pc, sc), (pg, sg) = run("cpu"), [t.cpu() for t in run(cuda)]
    torch.testing.assert_close(sg, sc, rtol=1e-4, atol=1e-4)
    assert int((pg != pc).any(dim=1).sum()) <= 1


RECIPE_FEATS = {"timit": 40, "conv_glu": 40, "learnable_frontend": 40, "resnet_ctc": 80}


@pytest.mark.parametrize("name", sorted(RECIPE_FEATS))
def test_recipe_forward_on_the_card_matches_the_cpu(cuda, name):
    """Each of the four recipes at full width, seeded weights, eval mode:
    fp32 emissions on the card against the same model on the CPU."""
    import os

    from wav2letter_tpu_torch.models import build_arch_module

    n_feat = RECIPE_FEATS[name]
    path = os.path.join(os.path.dirname(__file__), "..", "recipes", name, "network.arch")
    torch.manual_seed(0)
    model = build_arch_module(path, n_feat, 31).eval()
    feats = _randn((2, 160, n_feat), 3, "cpu")
    flen = torch.tensor([160, 121], dtype=torch.int32)
    with torch.no_grad():
        want, wlen = model(feats, flen)
        got, glen = model.to(cuda)(feats.to(cuda), flen.to(cuda))
    assert torch.equal(glen.cpu(), wlen)
    scale = want.abs().max().item()
    # fp32 convs and GEMMs (no TF32) in another summation order
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * max(1.0, scale))


def test_output_lengths_on_the_card_equal_the_cpu(cuda):
    """``ceil(feat_len / T * T_out)`` on the card as on the CPU for every
    feat_len <= T, at T = 4 T_out whose reciprocal is inexact: where
    feat_len / 4 is whole, a divisor on the host would make the card multiply
    by 1/T and land a frame higher."""
    from wav2letter_tpu_torch.models import build_arch_from_lines

    model = build_arch_from_lines(["V -1 1 4 0", "M 4 1 4 1", "RO 2 0 3 1", "L 4 6"],
                                  6).eval()
    for T in (640, 980, 1000, 1280):
        flen = torch.arange(1, T + 1, dtype=torch.int32)
        feats = torch.zeros(T, T, 4)
        with torch.no_grad():
            _, want = model(feats, flen)
            _, got = model.to(cuda)(feats.to(cuda), flen.to(cuda))
        model.cpu()
        assert torch.equal(got.cpu(), want), T


# ---------------------------------------------------------------------------
# the seq2seq criterions and their beam step
# ---------------------------------------------------------------------------
# recipes/seq2seq_tds's time convs at T = 100: its three C2 (C 1 -> 10 -> 14
# -> 18, 11 taps, stride 2, the PD's pads folded) and its TDS convs at C =
# 10, 14, 18 (9 taps), W = 80
S2S_TDS_CONVS = [(2, 100, 80, 1, 10, 11, 2, 4, 5), (2, 50, 80, 10, 14, 11, 2, 4, 5),
                 (2, 25, 80, 14, 18, 11, 2, 4, 5), (2, 46, 80, 10, 10, 9, 1, 4, 4),
                 (2, 23, 80, 14, 14, 9, 1, 4, 4), (2, 12, 80, 18, 18, 9, 1, 4, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", S2S_TDS_CONVS)
def test_time_conv_kernels_at_seq2seq_tds_channels(cuda, dtype, B, T, F, C, CO, K, s, lp, rp):
    """K2, its dgrad and K2b at channel counts no other recipe runs."""
    x, w, dy = _conv_case(cuda, dtype, B, T, F, C, CO, K, s, lp, rp)
    bias = _randn((CO,), CO, cuda)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    got = kernels.time_conv(x, w, F, s, (lp, rp), bias, relu=True)
    want = kernels.time_conv_plain(x, w, F, s, (lp, rp), bias, relu=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    got = kernels.time_conv_dgrad(dy, w, F, T, s, (lp, rp))
    want = kernels.time_conv_dgrad_plain(dy, w, F, T, s, (lp, rp))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    got = kernels.time_conv_wgrad(x, dy, K, F, s, (lp, rp))
    want = kernels.time_conv_wgrad_plain(x, dy, K, F, s, (lp, rp))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)


def _s2s_criterion(kind, seed=0, N=30, H=64):
    from wav2letter_tpu_torch.criterions import (S2SConfig, Seq2SeqCriterion,
                                                 TransformerS2SCriterion)

    cfg = S2SConfig(n_classes=N, eos_idx=N - 2, pad_idx=N - 1, hidden=H, attention="keyvalue",
                    label_smooth=0.05, attn_window="softPretrain", softw_std=4.0,
                    max_decoder_output_len=20)
    torch.manual_seed(seed)
    crit = (Seq2SeqCriterion(cfg) if kind == "seq2seq"
            else TransformerS2SCriterion(cfg, n_tr_layers=2))
    with torch.no_grad():  # the zero-initialized branches carry signal
        for p in crit.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return crit


def _s2s_batch(kind, B=4, T=60, U=12, N=30, H=64):
    E = 2 * H if kind == "seq2seq" else H
    em = _randn((B, T, E), 1, "cpu")
    rng = np.random.RandomState(2)
    tlen = torch.from_numpy(rng.randint(3, U + 1, size=B).astype(np.int32))
    tg = torch.full((B, U), -1, dtype=torch.int32)
    for i in range(B):
        tg[i, : tlen[i]] = torch.from_numpy(rng.randint(0, N - 2, size=int(tlen[i])))
    elen = torch.tensor([T, T - 7, T - 20, T - 3], dtype=torch.int32)[:B]
    return em, tg, elen, tlen


@pytest.mark.parametrize("kind", ["seq2seq", "transformer"])
def test_s2s_criterion_on_the_card_matches_the_cpu(cuda, kind):
    """Losses (the window on) and every gradient, fp32 on the card (no TF32)
    against the CPU; the greedy tokens equal."""
    crit = _s2s_criterion(kind)
    em, tg, elen, tlen = _s2s_batch(kind)
    out = []
    for dev in ("cpu", cuda):
        crit.zero_grad()  # before the move, which would carry the CPU's grads along
        crit.to(dev)
        e = em.detach().to(dev).requires_grad_(True)  # a leaf on either device
        loss = crit(e, tg.to(dev), elen.to(dev), tlen.to(dev), train=True, window=True)
        loss.sum().backward()
        with torch.no_grad():
            toks, lens = crit.greedy_path(em.to(dev), elen.to(dev))
        out.append((loss.detach().cpu(), e.grad.cpu(),
                    {n: p.grad.cpu().clone() for n, p in crit.named_parameters()},
                    toks.cpu(), lens.cpu()))
    (lc, ec, gc, tc, nc), (lg, eg, gg, tg_, ng) = out
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(eg, ec, rtol=1e-4, atol=1e-6)
    scale = max(g.abs().max().item() for g in gc.values())
    for n, g in gc.items():
        torch.testing.assert_close(gg[n], g, rtol=1e-4, atol=1e-5 * scale, msg=n)
    assert torch.equal(tg_, tc) and torch.equal(ng, nc)


@pytest.mark.parametrize("kind", ["seq2seq", "transformer"])
def test_s2s_beam_step_on_the_card_matches_the_cpu(cuda, kind):
    """One step of the beam's decoder call at K = 8 hypotheses, state
    gathered from the step before: log-probs, peaks and state."""
    from wav2letter_tpu_torch.decoder.seq2seq_beam import _gather_state, make_s2s_update_fn

    crit = _s2s_criterion(kind)
    em = _randn((37, 128 if kind == "seq2seq" else 64), 4, "cpu").numpy()
    toks = np.arange(8, dtype=np.int32) % 28
    rows = np.asarray([0, 0, 1, 2, 3, 3, 5, 7])
    out = []
    for dev in ("cpu", cuda):
        step, init = make_s2s_update_fn(crit.to(dev), em, 30)
        state, _, _ = step(init(8), np.full(8, 28, np.int32))
        state, logp, peaks = step(_gather_state(state, rows), toks)
        out.append((logp, peaks))
    (want, want_peaks), (got, got_peaks) = out
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kind == "seq2seq":
        np.testing.assert_array_equal(got_peaks, want_peaks)
    else:
        assert got_peaks is None and want_peaks is None


# the layers the LM slice adds, forward and backward on the card against the
# CPU: (C in, arch lines from (B, 1, C, T)), output width 7
NEW_LAYERS = {
    "bn": (16, ["V -1 1 16 0", "BN 16 2", "RO 2 0 3 1", "L 16 7"]),
    "lstm_bi": (16, ["V -1 1 16 0", "RO 2 0 3 1", "LSTM 16 32 2 1", "L 64 7"]),
    "gru_bi": (16, ["V -1 1 16 0", "RO 2 0 3 1", "GRU 16 32 2 1", "L 64 7"]),
    "rnn": (16, ["V -1 1 16 0", "RO 2 0 3 1", "RNN 16 32 2 0", "L 32 7"]),
    "posemb_sin_pc": (16, ["V -1 1 16 0", "RO 2 0 3 1", "POSEMB 16 64 0.0", "SINPOSEMB 16",
                           "PC bf16", "PC f32", "L 16 7"]),
}


@pytest.mark.parametrize("name", sorted(NEW_LAYERS))
@pytest.mark.parametrize("train", [False, True])
def test_new_layers_on_the_card_match_the_cpu(cuda, name, train):
    c, lines = NEW_LAYERS[name]
    torch.manual_seed(0)
    cpu = build_arch_from_lines(lines, 7)
    card = build_arch_from_lines(lines, 7)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    feats = _randn((3, 40, c), 1, "cpu")
    flen = torch.tensor([40, 31, 22])
    outs = []
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        m.train(train)
        y, _ = m(feats.to(dev), flen.to(dev))
        (y * torch.arange(y.numel(), device=dev).reshape(y.shape).sin()).sum().backward()
        outs.append((y.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()},
                     {k: b.cpu() for k, b in m.named_buffers()}))
    (y0, g0, b0), (y1, g1, b1) = outs
    # fp32 (TF32 off), sums over <= 40 steps in another order
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-5)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-4 * g0[k].abs().max() + 1e-6)
    for k in b0:  # BatchNorm's running statistics, moved in training
        torch.testing.assert_close(b1[k], b0[k], rtol=1e-5, atol=1e-6)


def test_lm_and_convlm_on_the_card_match_the_cpu(cuda):
    """A GCNN-14B at 1/16 of its widths: logits and every gradient of the LM
    loss, and the ConvLM's deferred scores (log10), card against CPU."""
    from chip_smoke import gcnn_lines
    from wav2letter_tpu_torch.decoder.convlm import ConvLM
    from wav2letter_tpu_torch.models.arch import parse_arch_lines
    from wav2letter_tpu_torch.models.lm import LMArchModel, lm_cross_entropy

    V = 50
    torch.manual_seed(0)
    cpu = LMArchModel(parse_arch_lines(gcnn_lines(V, div=16)), V, V).eval()
    card = LMArchModel(parse_arch_lines(gcnn_lines(V, div=16)), V, V)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda).eval()
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, V, (4, 32)))
    res = []
    for m, dev in ((cpu, "cpu"), (card, cuda)):
        logits, _ = m(ids.to(dev))
        lm_cross_entropy(logits, ids.to(dev)).sum().backward()
        res.append((logits.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()}))
    torch.testing.assert_close(res[1][0], res[0][0], rtol=1e-4, atol=1e-4)
    for k, g in res[0][1].items():
        torch.testing.assert_close(res[1][1][k], g, rtol=1e-4, atol=1e-4 * g.abs().max())
    vocab = [f"w{i}" for i in range(V - 2)] + ["</s>", "<unk>"]
    rng = np.random.RandomState(3)
    lens = rng.randint(1, 49, size=100).astype(np.int32)
    hists = rng.randint(0, V, size=(100, 48)).astype(np.int32)
    words = rng.randint(0, V, size=100).astype(np.int32)
    got = ConvLM(card, vocab).score_batch(hists, lens, words)
    want = ConvLM(cpu, vocab).score_batch(hists, lens, words)
    np.testing.assert_allclose(got, want, atol=1e-5)


# a narrow streaming-convnets stage, commented as the recipe's arch is
FL_ARCH = ("# a narrow streaming stage\nV -1 NFEAT 1 0\nPD 0 6 2\nC2 1 4 9 1 2 1 0 0\nR\n"
           "LN 1 2\n# its TDS block\nTDS 4 9 16 0.0 0 1 0\nRO 2 1 0 3\nV 64 -1 1 0\n"
           "L 64 NLABEL\nV NLABEL 0 -1 1\n")


def test_flashlight_checkpoint_on_the_card(cuda, tmp_path):
    """``load_checkpoint`` of a forged flashlight file, moved to the card,
    gives emissions equal in bits to those of the port's own checkpoint of
    the same weights, through K2 and K3."""
    import importlib.util
    import os

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import (Checkpoint, load_checkpoint,
                                                         save_checkpoint)

    # the forger beside this file, by path: a machine may have a `tests`
    # package of its own on the path
    spec = importlib.util.spec_from_file_location(
        "util_torch_flashlight", os.path.join(os.path.dirname(__file__),
                                              "util_torch_flashlight.py"))
    util = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(util)
    arch = tmp_path / "fl.arch"
    arch.write_text(FL_ARCH)
    torch.manual_seed(0)
    state = build_arch_module(str(arch), 16, 10).state_dict()
    save_checkpoint(str(tmp_path / "own.bin"), Checkpoint(
        config=Config().serialize(), epoch=0, updates=0, state_dict=state))
    util.forge_flashlight(tmp_path / "fl.bin", state, str(arch),
                     f"--criterion=ctc\n--arch={arch}\n--filterbanks=16\n")
    x = _randn((2, 200, 16), 7, cuda)
    xl = torch.tensor([200, 150], device=cuda)
    ems = []
    for name in ("own.bin", "fl.bin"):
        model = build_arch_module(str(arch), 16, 10)
        model.load_state_dict(load_checkpoint(str(tmp_path / name)).state_dict, strict=True)
        model.to(cuda).eval()
        before = dict(kernels.LAUNCHES)
        with torch.no_grad():
            ems.append(model(x, xl)[0])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["time_conv"] == before["time_conv"] + 2
        assert kernels.LAUNCHES["residual_ln"] > before["residual_ln"]
    assert torch.equal(ems[0], ems[1])
