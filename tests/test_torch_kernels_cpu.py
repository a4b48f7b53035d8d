"""The PyTorch port's kernel plain versions (K1 MFSC, K2 time conv with its
dgrad recipe, K2b time-conv weight gradient, K3 residual LayerNorm, K3b its
backward) against the JAX package's Pallas kernels, run as the JAX package's
own tests run them on the CPU (interpret mode). Inputs come from a
numpy seed and reach both frameworks as numpy arrays.

On the card the same functions are the CUDA kernels; those comparisons are
the ``cuda``-marked tests in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wav2letter_tpu.features.frontend import FeatureParams, Featurizer
from wav2letter_tpu.ops.pallas import tconv as jax_tconv
from wav2letter_tpu.ops.pallas.layernorm import fused_residual_ln
from wav2letter_tpu.ops.pallas.mel import pallas_mfsc
from wav2letter_tpu_torch import kernels


def _pre(audio, coef):
    return np.concatenate([audio[..., :1], audio[..., 1:] - coef * audio[..., :-1]], -1)


# K1: S=16000 gives 98 frames (one ragged 128-frame tile on the TPU, a
# ragged 32-frame tile on the card); S=7000 gives 42.
@pytest.mark.parametrize("n_mels,S,B", [(40, 16000, 2), (24, 7000, 1)])
def test_mfsc_plain_matches_pallas(n_mels, S, B):
    p = FeatureParams(n_filterbanks=n_mels)
    f = Featurizer(p)
    audio = (np.random.RandomState(n_mels).randn(B, S) * 0.1).astype(np.float32)
    pre = _pre(audio, p.preem_coef).astype(np.float32)
    frames = f.frame_signal(jnp.asarray(pre))
    want = np.asarray(pallas_mfsc(frames, f.cos_mat, f.sin_mat, f.mel_fb,
                                  mel_floor=p.mel_floor, interpret=True))
    got = kernels.mfsc(torch.from_numpy(pre), torch.from_numpy(np.array(f.cos_mat)),
                       torch.from_numpy(np.array(f.sin_mat)),
                       torch.from_numpy(np.array(f.mel_fb)),
                       p.frame_samples, p.stride_samples, p.mel_floor)
    assert got.shape == want.shape
    # fp32 products of 400-long sums in another order; log features ~O(1-10):
    # the JAX tests hold the kernel to its oracle at 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def _interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


# (B, T, F, C, CO, K, stride, lp, rp): strides 1/2, asymmetric pads, C=1
TCONV_CASES = [
    (2, 37, 8, 5, 7, 9, 1, 4, 4),
    (1, 41, 4, 3, 3, 5, 1, 0, 4),
    (2, 50, 8, 5, 7, 10, 2, 5, 3),
    (1, 33, 4, 3, 5, 10, 2, 7, 1),
    (2, 40, 6, 1, 4, 9, 2, 6, 2),
    (1, 29, 3, 4, 4, 11, 1, 10, 0),
]


@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", TCONV_CASES)
def test_time_conv_plain_matches_pallas(_interpret, B, T, F, C, CO, K, s, lp, rp):
    rng = np.random.RandomState(T + K)
    x = rng.randn(B, T, F * C).astype(np.float32)
    w = (rng.randn(K, C, CO) * 0.3).astype(np.float32)
    want = np.asarray(jax_tconv.time_conv(jnp.asarray(x), jnp.asarray(w), F, s, (lp, rp)))
    got = kernels.time_conv(torch.from_numpy(x), torch.from_numpy(w), F, s, (lp, rp))
    assert got.shape == want.shape
    # fp32 sums of K*C <= 60 products of O(1) values: 1e-4 as the JAX test
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_time_conv_plain_bias_relu_epilogue():
    """The fused epilogue equals bias + ReLU applied after the conv."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 30, 12).astype(np.float32))
    w = torch.from_numpy(rng.randn(9, 3, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(5).astype(np.float32))
    plain = kernels.time_conv(x, w, 4, 2, (6, 2))
    fused = kernels.time_conv(x, w, 4, 2, (6, 2), bias=b, relu=True)
    want = torch.relu(plain.view(2, -1, 4, 5) + b).view_as(plain)
    np.testing.assert_allclose(fused.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("R,D", [(70, 96), (33, 160)])
def test_residual_ln_plain_matches_pallas(R, D):
    rng = np.random.RandomState(R)
    x = rng.randn(R, D).astype(np.float32)
    y = rng.randn(R, D).astype(np.float32)
    w = np.asarray([1.3], np.float32)
    b = np.asarray([-0.2], np.float32)
    want = np.asarray(fused_residual_ln(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                        jnp.asarray(b), True))
    out, mu, rsig = kernels.residual_ln(*(torch.from_numpy(a) for a in (x, y, w, b)))
    # fp32 row statistics over <= 160 values: 1e-5 as the JAX test
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    z = (x + y).astype(np.float64)
    np.testing.assert_allclose(mu.numpy(), z.mean(-1), atol=1e-5)
    np.testing.assert_allclose(rsig.numpy(), 1 / np.sqrt(z.var(-1) + 1e-5), rtol=1e-5)


def test_kernel_wrappers_count_only_launches():
    """On CPU tensors the wrappers take the plain versions, which never
    count as launches."""
    kernels.reset_launches()
    x = torch.zeros(1, 20, 8)
    kernels.time_conv(x, torch.zeros(3, 2, 2), 4, 1, (1, 1))
    kernels.residual_ln(x[0], x[0], torch.ones(1), torch.zeros(1))
    kernels.time_conv_wgrad(x, torch.zeros(1, 20, 8), 3, 4, 1, (1, 1))
    kernels.time_conv_dgrad(x, torch.zeros(3, 2, 2), 4, 20, 1, (1, 1))
    kernels.residual_ln_bwd(x[0], x[0], x[0], torch.zeros(20), torch.ones(20), torch.ones(1))
    q = torch.zeros(1, 4, 16)
    pos, mask = torch.zeros(7, 8), torch.zeros(1, 4)
    kernels.mhsa(q, q, q, pos, mask, 2)
    kernels.mhsa_bwd(q, q, q, pos, mask, q, 2)
    assert kernels.LAUNCHES == {"mfsc": 0, "time_conv": 0, "time_conv_wgrad": 0,
                                "residual_ln": 0, "residual_ln_bwd": 0, "mhsa": 0,
                                "mhsa_bwd": 0}


# ---------------------------------------------------------------------------
# backward: the JAX custom VJPs (Pallas dgrad through _fwd, _wgrad, _bwd) in
# interpret mode against the port's plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", TCONV_CASES)
def test_time_conv_backward_plain_matches_pallas(_interpret, B, T, F, C, CO, K, s, lp, rp):
    rng = np.random.RandomState(T + K + 1)
    x = rng.randn(B, T, F * C).astype(np.float32)
    w = (rng.randn(K, C, CO) * 0.3).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jax_tconv.time_conv(a, b, F, s, (lp, rp)),
                     jnp.asarray(x), jnp.asarray(w))
    dy = rng.randn(*y.shape).astype(np.float32)
    want_dx, want_dw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    tdy, tw = torch.from_numpy(dy), torch.from_numpy(w)
    got_dx = kernels.time_conv_dgrad(tdy, tw, F, T, s, (lp, rp))
    got_dw = kernels.time_conv_wgrad(torch.from_numpy(x), tdy, K, F, s, (lp, rp))
    assert got_dx.shape == want_dx.shape and got_dw.shape == want_dw.shape
    assert got_dw.dtype == torch.float32
    # dx: fp32 sums of K*CO <= 70 products; dw: of B*Tout*F <= 600, O(10) entries
    np.testing.assert_allclose(got_dx.numpy(), want_dx, atol=1e-4)
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=1e-4, rtol=1e-5)
    # autograd through the plain forward is the same function
    tx = torch.from_numpy(x).requires_grad_(True)
    tw.requires_grad_(True)
    kernels.time_conv(tx, tw, F, s, (lp, rp)).backward(tdy)
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), want_dw, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("B,T,F,C,CO,K,s,lp,rp", [TCONV_CASES[2], TCONV_CASES[4]])
def test_time_conv_backward_with_bias_relu(_interpret, B, T, F, C, CO, K, s, lp, rp):
    """The port fuses bias + ReLU into K2; its gradients (mask dy by y > 0, then
    dgrad, wgrad and the bias sum) against JAX's through the unfused ops."""
    rng = np.random.RandomState(T)
    x = rng.randn(B, T, F * C).astype(np.float32)
    w = (rng.randn(K, C, CO) * 0.3).astype(np.float32)
    b = rng.randn(CO).astype(np.float32)

    def jfn(a, ww, bb):
        y = jax_tconv.time_conv(a, ww, F, s, (lp, rp))
        return jax.nn.relu(y.reshape(B, -1, F, CO) + bb).reshape(y.shape)

    y, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dy = rng.randn(*y.shape).astype(np.float32)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    out = kernels.time_conv(leaves[0], leaves[1], F, s, (lp, rp), leaves[2], relu=True)
    out.backward(torch.from_numpy(dy))
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=1e-4, rtol=1e-5)
    # the same from the pieces the CUDA autograd function is made of
    dym = torch.from_numpy(dy) * (out.detach() > 0)
    np.testing.assert_allclose(
        kernels.time_conv_dgrad(dym, leaves[1].detach(), F, T, s, (lp, rp)).numpy(),
        want[0], atol=1e-4)
    np.testing.assert_allclose(
        kernels.time_conv_wgrad(leaves[0].detach(), dym, K, F, s, (lp, rp)).numpy(),
        want[1], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dym.reshape(-1, CO).sum(0).numpy(), want[2],
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("R,D", [(70, 96), (33, 160)])
def test_residual_ln_bwd_plain_matches_pallas(R, D):
    rng = np.random.RandomState(R + 1)
    x, y, g = (rng.randn(R, D).astype(np.float32) for _ in range(3))
    w = np.asarray([1.3], np.float32)
    b = np.asarray([-0.2], np.float32)
    _, vjp = jax.vjp(lambda *a: fused_residual_ln(*a, True),
                     *(jnp.asarray(a) for a in (x, y, w, b)))
    want_dx, want_dy, want_dw, want_db = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    tx, ty, tg, tw, tb = (torch.from_numpy(a) for a in (x, y, g, w, b))
    _, mu, rsig = kernels.residual_ln(tx, ty, tw, tb)
    dz, row_g, row_gz = kernels.residual_ln_bwd(tg, tx, ty, mu, rsig, tw)
    # fp32 row statistics over <= 160 values: 1e-5 as the forward
    np.testing.assert_allclose(dz.numpy(), want_dx, atol=1e-5)
    np.testing.assert_allclose(dz.numpy(), want_dy, atol=1e-5)
    # scalar gradients: sums over R*D <= 6720 terms, O(100)
    np.testing.assert_allclose(row_gz.sum().numpy(), want_dw[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(row_g.sum().numpy(), want_db[0], rtol=1e-5, atol=1e-4)
    # autograd through the plain forward is the same function
    leaves = [t.clone().requires_grad_(True) for t in (tx, ty, tw, tb)]
    kernels.residual_ln(*leaves)[0].backward(tg)
    for leaf, want in zip(leaves, (want_dx, want_dy, want_dw, want_db)):
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-5, atol=1e-4)
