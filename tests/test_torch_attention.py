"""The port's attention function (the plain versions of kernels K4 and K4b,
which the CPU path and the on-card comparisons use) against the JAX package's
Pallas kernel in interpret mode: forward, all four gradients through
``jax.grad`` (the custom VJP, i.e. the Pallas backward kernel), and dropout
with a fixed seed, whose keep mask must be the same bits on both sides.
Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2letter_tpu.ops.pallas.attention import _dropout_keep, fused_mhsa
from wav2letter_tpu_torch import kernels
from wav2letter_tpu_torch.kernels.attention import dropout_keep, hash_rows

# (B, T, H, Dh, masked): aligned, ragged T, a narrow head, an odd head width,
# and one T > 32
SHAPES = [(2, 16, 2, 128, False), (2, 13, 2, 128, True), (1, 40, 4, 64, True),
          (3, 17, 1, 130, True)]
SEED = 1234


def _inputs(B, T, H, Dh, masked):
    rng = np.random.RandomState(B * 100 + T)
    q, k, v, g = (rng.randn(B, T, H * Dh).astype(np.float32) * 0.5 for _ in range(4))
    pos = rng.randn(2 * T - 1, Dh).astype(np.float32) * 0.1
    mb = np.zeros((B, T), np.float32)
    if masked:
        lens = rng.randint(max(1, T // 2), T + 1, B)
        mb = np.where(np.arange(T)[None] < lens[:, None], 0.0, -1e30).astype(np.float32)
    return q, k, v, pos, mb, g


def _jax_fn(mb, H, rate):
    seed = jnp.asarray([SEED], jnp.int32)
    return lambda q, k, v, pos: fused_mhsa(q, k, v, pos, jnp.asarray(mb), H, rate, seed,
                                           interpret=True)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,T,H,Dh,masked", SHAPES)
def test_forward_matches_pallas(B, T, H, Dh, masked, rate):
    q, k, v, pos, mb, _ = _inputs(B, T, H, Dh, masked)
    want = _jax_fn(mb, H, rate)(q, k, v, pos)
    tq, tk, tv, tp, tm = (torch.from_numpy(a) for a in (q, k, v, pos, mb))
    for fn in (kernels.mhsa_plain, kernels.mhsa):  # on the CPU the wrapper is the plain one
        got = fn(tq, tk, tv, tp, tm, H, rate, SEED)
        # fp32 both sides, sums of <= 130 + 40 terms in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,T,H,Dh,masked", SHAPES)
def test_gradients_match_pallas(B, T, H, Dh, masked, rate):
    q, k, v, pos, mb, g = _inputs(B, T, H, Dh, masked)
    f = _jax_fn(mb, H, rate)
    want = jax.grad(lambda *a: jnp.sum(f(*a) * g), argnums=(0, 1, 2, 3))(q, k, v, pos)
    tq, tk, tv, tp, tm, tg = (torch.from_numpy(a) for a in (q, k, v, pos, mb, g))
    explicit = kernels.mhsa_bwd_plain(tq, tk, tv, tp, tm, tg, H, rate, SEED)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv, tp)]
    out = kernels.mhsa(*leaves, tm, H, rate, SEED)
    assert out.grad_fn is not None
    auto = torch.autograd.grad(out, leaves, tg)
    for name, w, e, a in zip(("dq", "dk", "dv", "dpos"), want, explicit, auto):
        np.testing.assert_allclose(e.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert explicit[3].dtype == torch.float32


@pytest.mark.parametrize("B,H,T,rate,seed", [
    (2, 3, 13, 0.3, 0), (1, 4, 40, 0.2, SEED), (3, 1, 17, 0.5, 2 ** 31 - 2),
    (2, 2, 192, 0.2, 987654321)])
def test_keep_mask_is_the_same_bits(B, H, T, rate, seed):
    """The hash, uint32 wrap-around included, per (batch, head) program."""
    Tp = hash_rows(T)
    got = dropout_keep(seed, B, H, T, rate, torch.device("cpu")).numpy()
    for prog in range(B * H):
        want = _dropout_keep(jnp.asarray(seed, jnp.int32), jnp.asarray(prog, jnp.int32),
                             (Tp, Tp), rate)
        np.testing.assert_array_equal(got[prog // H, prog % H], np.asarray(want)[:T, :T])
    assert abs(got.mean() - (1 - rate)) < 0.02


def test_bf16_inputs_round_like_the_kernel():
    """bf16 in: fp32 sums, p rounded to bf16 before p.v, output bf16; ds
    rounded to bf16 before its products, dPwin left in fp32."""
    q, k, v, pos, mb, g = (torch.from_numpy(a) for a in _inputs(2, 24, 2, 16, True))
    b16 = [t.bfloat16() for t in (q, k, v, pos)]
    out = kernels.mhsa_plain(*b16, mb, 2, 0.2, 3)
    assert out.dtype == torch.bfloat16
    ref = kernels.mhsa_plain(*(t.float() for t in b16), mb, 2, 0.2, 3)
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    dq, dk, dv, dpos = kernels.mhsa_bwd_plain(*b16, mb, g.bfloat16(), 2, 0.2, 3)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16} and dpos.dtype == torch.float32
    want = kernels.mhsa_bwd_plain(*(t.float() for t in b16), mb, g.bfloat16().float(), 2, 0.2, 3)
    for a, b in zip((dq, dk, dv, dpos), want):
        torch.testing.assert_close(a.float(), b, rtol=3e-2, atol=3e-2)
