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
