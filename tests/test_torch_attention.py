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


@pytest.mark.parametrize("block", [1, 50, 2 * 3 * 40 + 1])
def test_keep_mask_in_row_blocks(monkeypatch, block):
    """The mask hashed a block of rows at a time (one row, a part of a row
    over all programs, several rows with a ragged last block) has JAX's bits,
    also when written into a view of a larger mask."""
    from wav2letter_tpu_torch.kernels import attention as A

    B, H, T, rate, seed = 2, 3, 40, 0.2, 987654321
    monkeypatch.setattr(A, "KEEP_BLOCK", block)
    got = dropout_keep(seed, B, H, T, rate, torch.device("cpu")).numpy()
    Tp = hash_rows(T)
    for prog in range(B * H):
        want = _dropout_keep(jnp.asarray(seed, jnp.int32), jnp.asarray(prog, jnp.int32),
                             (Tp, Tp), rate)
        np.testing.assert_array_equal(got[prog // H, prog % H], np.asarray(want)[:T, :T])
    wide = torch.zeros((B, H + 2, T, T), dtype=torch.bool)
    dropout_keep(seed, B, H, T, rate, torch.device("cpu"), out=wide[:, 1:H + 1])
    assert np.array_equal(wide[:, 1:H + 1].numpy(), got)
    assert not wide[:, 0].any() and not wide[:, H + 1].any()


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


@pytest.mark.parametrize("itemsize", [4, 2])
def test_k4_tile_rows_fit_every_shape_the_kernel_took(itemsize):
    """K4's rows per block, picked in Python from the shape: one of 16, 32 and
    64, within the shared memory a block can get, for every T and Dh that the
    16-row fp32-pipe kernel before it took (16 x (Dh + T) fp32 a block)."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.attention import FWD_ROWS, fwd_smem_bytes, fwd_tile_rows

    limit = _build.MAX_SMEM_BYTES
    picked = set()
    for T in range(1, 2049):
        for Dh in range(8, 257, 8):
            if 4 * 16 * (Dh + T) > limit:
                continue
            for B, H in ((1, 1), (4, 4), (64, 16)):
                rows = fwd_tile_rows(B, H, T, Dh, itemsize)
                assert rows in FWD_ROWS and fwd_smem_bytes(rows, T, Dh, itemsize) <= limit
                picked.add(rows)
    assert picked == set(FWD_ROWS)


def test_k4_tile_rows_fill_the_card_with_the_fewest_bytes():
    """One block a SM where the shape allows (the most blocks that still fit
    one a SM), else the tallest tile: the transformer's serving (B=4) and
    training (B=8) shapes, its gate's edge and the conformer's."""
    from wav2letter_tpu_torch.kernels.attention import fwd_tile_rows

    assert fwd_tile_rows(4, 4, 192, 192, 2) == 32  # 96 blocks; 16 rows: 192
    assert fwd_tile_rows(8, 4, 192, 192, 2) == 64  # 96 blocks
    assert fwd_tile_rows(2, 4, 460, 192, 2) == 32  # 120 blocks
    assert fwd_tile_rows(8, 4, 240, 128, 2) == 64  # 128 blocks
    assert fwd_tile_rows(2, 4, 17, 192, 4) == 16
    assert fwd_tile_rows(64, 16, 460, 192, 2) == 64  # more blocks than SMs at any height
    assert fwd_tile_rows(64, 16, 2048, 256, 4) == 16  # the only height that fits


def test_k4_trace_finds_its_anchors_in_the_kernel_source():
    """``kernels/trace_k4.py`` stamps K4's chunk loop by editing a copy of
    the source at fixed anchors; it must find each of them once."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k4 import _instrument

    src = (_build.CSRC / "attention.cu").read_text()
    traced = _instrument(src)
    assert traced.count("clock64()") == 5 and "w2l_k4_stamps" in traced
    assert traced.replace("g_k4_stamps", "").count("st[") == 5


def test_k4b_trace_finds_its_anchors_in_the_kernel_source():
    """``kernels/trace_k4b.py`` stamps the chunk loop of K4b's first launch
    by editing a copy of the source at fixed anchors; it must find each of
    them once, and stamp nothing else."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k4b import _instrument

    src = (_build.CSRC / "attention.cu").read_text()
    traced = _instrument(src)
    assert traced.count("clock64()") == 5 and "w2l_k4b_stamps" in traced
    assert traced.replace("g_k4b_stamps", "").count("st[") == 5
    first, second = traced.index("// K4b, launch 1"), traced.index("// K4b, launch 2")
    assert traced[first:second].count("clock64()") == 5  # K4 and the other launches untouched


# The last T each kernel takes: K4 by its smallest tile's shared memory, and
# K4b by the same, since its first launch has K4's layout
@pytest.mark.parametrize("dtype,backward,Dh,last", [
    (torch.bfloat16, False, 192, 2728), (torch.float32, False, 192, 2648),
    (torch.bfloat16, True, 192, 2728), (torch.float32, True, 192, 2648),
    (torch.bfloat16, True, 128, 3016), (torch.float32, False, 128, 2952),
    (torch.float32, True, 8, 3072)])
def test_mhsa_takes_stops_at_the_kernels_limits(dtype, backward, Dh, last):
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.attention import (bwd_smem_bytes, fwd_smem_bytes,
                                                        mhsa_takes)

    assert mhsa_takes(4, last, 4, Dh, dtype, backward)
    assert not mhsa_takes(4, last + 1, 4, Dh, dtype, backward)
    item = 2 if dtype == torch.bfloat16 else 4
    over = (bwd_smem_bytes(16, last + 1, Dh, item) if backward
            else fwd_smem_bytes(16, last + 1, Dh, item))
    assert over > _build.MAX_SMEM_BYTES  # refused for its shared memory, nothing else
    if backward:  # K4b's limit is K4's: the forward refuses the shape as well
        assert not mhsa_takes(4, last + 1, 4, Dh, dtype, False)


def test_mhsa_takes_refuses_head_widths():
    from wav2letter_tpu_torch.kernels.attention import bwd_max_head_dim, mhsa_takes

    assert bwd_max_head_dim(4) == 720 and bwd_max_head_dim(2) == 784
    assert not mhsa_takes(1, 16, 1, 12, torch.float32)  # not a multiple of 8
    assert not mhsa_takes(1, 16, 1, 16, torch.float16)
    assert mhsa_takes(1, 16, 1, 264, torch.float32, backward=True)
    assert not mhsa_takes(1, 1, 1, 728, torch.float32, backward=True)
    assert mhsa_takes(1, 1, 1, 720, torch.float32, backward=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_dispatch_asks_the_kernels(dtype):
    """Inside the JAX gate: the kernel for a card tensor the kernels take,
    the unfused path past their limit (K4b's is K4's), with a gradient wanted
    or not; the plain fused function for any CPU tensor."""
    from wav2letter_tpu_torch.models.transformer import _use_kernel

    last = 2728 if dtype == torch.bfloat16 else 2648
    assert _use_kernel(8, last, 4, 192, dtype, "cuda", True)
    assert not _use_kernel(8, last + 1, 4, 192, dtype, "cuda", True)
    assert _use_kernel(8, last, 4, 192, dtype, "cuda", False)
    assert not _use_kernel(8, last + 1, 4, 192, dtype, "cuda", False)
    assert _use_kernel(8, 2000, 4, 192, dtype, "cuda", True)
    assert _use_kernel(8, last + 1, 4, 192, dtype, "cpu", True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_context_shape_takes_k4b(dtype):
    """The long-context transformer's update (B=2, T=1712, H=4, Dh=192)
    trains through K4 and K4b on the card."""
    from wav2letter_tpu_torch.models.transformer import _use_kernel

    assert _use_kernel(2, 1712, 4, 192, dtype, "cuda", True)


def test_attention_past_k4b_limit_matches_jax(monkeypatch):
    """A module whose bptt lets T past K4b's limit, which is K4's (Dh = 8:
    T <= 3072): on the CPU the fused function, and the unfused path that the
    card takes with a gradient wanted or not (the dispatch evaluated as for a
    card tensor), both match the JAX module. The recipes' gates (bptt 460,
    240) stay inside."""
    from wav2letter_tpu.models import transformer as JT
    from wav2letter_tpu_torch.models import transformer as T
    from wav2letter_tpu_torch.runtime.checkpoint import convert_jax_params

    B, Tn, C, H, bptt = 1, 3076, 16, 2, 3080  # Dh = 8: K4 and K4b take T <= 3072
    rng = np.random.RandomState(5)
    x = rng.randn(1, B, Tn, C).astype(np.float32)
    mask = np.ones((1, B, Tn), bool)
    mask[..., Tn - 100:] = False
    jm = JT.MultiHeadSelfAttention(C, C // H, H, bptt, 0.1, False)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(mask))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    m = T.MultiHeadSelfAttention(C, C // H, H, bptt, 0.1, False)
    m.load_state_dict(convert_jax_params(jax.device_get(variables["params"])), strict=True)
    m.eval()
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    assert m.fused(tx)
    with torch.no_grad():
        fused = m(tx, tm)
    real = T._use_kernel
    monkeypatch.setattr(T, "_use_kernel", lambda *a: real(*a[:5], "cuda", a[6]))
    assert not m.fused(tx)  # parameters need a gradient: K4b refuses the shape
    with torch.no_grad():
        assert not m.fused(tx)  # serving: K4 refuses it too
    unfused = m(tx, tm)
    assert unfused.requires_grad
    # fp32, sums of 8 and 3076 terms in another order
    for got in (fused, unfused.detach()):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
