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


@pytest.fixture(autouse=True)
def _jax_on_the_cpu_in_fp32():
    """The JAX side of every comparison here on the CPU, its dots at full
    fp32, whatever JAX's platform in the process. ``tests/conftest.py`` pins
    JAX to the CPU; run without it (``--noconftest``, as the ``cuda`` tests
    are run on a card machine) in one process with this file, JAX takes the
    card, where the Pallas kernels' interpret-mode dots at their default
    precision are not full fp32 (K1's log features then move by ~1.5e-4)."""
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield


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


# (B, T, F, C, CO, K, stride, lp, rp): strides 1/2, asymmetric pads, C=1;
# the last is CPC's first conv on raw audio (stride 5, 10 taps) at 128
# channels, a shape of the wide route
TCONV_CASES = [
    (2, 37, 8, 5, 7, 9, 1, 4, 4),
    (1, 41, 4, 3, 3, 5, 1, 0, 4),
    (2, 50, 8, 5, 7, 10, 2, 5, 3),
    (1, 33, 4, 3, 5, 10, 2, 7, 1),
    (2, 40, 6, 1, 4, 9, 2, 6, 2),
    (1, 29, 3, 4, 4, 11, 1, 10, 0),
    (1, 400, 1, 1, 128, 10, 5, 3, 3),
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
    assert (kernels.tconv.route(torch.float32, C, CO, K, s, F) == "wide") == (CO > 64)


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
    logits = torch.zeros(2, 5, 4, requires_grad=True)
    ints = (torch.tensor([[0, 1], [2, -1]], dtype=torch.int32),
            torch.tensor([5, 3], dtype=torch.int32), torch.tensor([2, 1], dtype=torch.int32))
    kernels.ctc_loss(logits, *ints).sum().backward()
    saved = kernels.ctc_fwd(logits.detach(), *ints)
    kernels.ctc_bwd(torch.ones(2), logits.detach(), *ints, *saved[1:])
    assert kernels.LAUNCHES == {"mfsc": 0, "time_conv": 0, "time_conv_wgrad": 0,
                                "residual_ln": 0, "residual_ln_bwd": 0, "mhsa": 0,
                                "mhsa_bwd": 0, "ctc": 0, "ctc_bwd": 0}


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
    # dx: fp32 sums of K*CO <= 1280 products, O(10); dw: of B*Tout*F <= 600,
    # O(10) entries
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


# ---------------------------------------------------------------------------
# the K2 route and the bf16 tensor-core kernels' shapes, in Python
# ---------------------------------------------------------------------------
# (C, CO, K, stride) of the flagship's 15 convs and of recipes/streaming_
# convnets_librispeech's C2 and TDS layers
RECIPE_CONVS = [(1, 16, 9, 2), (16, 16, 9, 1), (16, 20, 11, 2), (20, 20, 9, 1),
                (20, 24, 11, 2), (24, 24, 11, 1), (24, 28, 12, 1), (28, 28, 11, 1),
                (1, 10, 11, 2), (10, 14, 11, 2), (14, 18, 11, 2), (10, 10, 9, 1),
                (14, 14, 9, 1), (18, 18, 9, 1)]


def test_conv_route_admits_only_what_the_kernels_take():
    """Every time-only conv up to the 64 KB edge of fp32 weights that
    ``Conv2D.time_only`` admits is one the kernels take: the CUDA-core K2,
    its dgrad and K2b fit their shared memory at any F (so both types run),
    and where bf16 goes to the tensor cores their layouts fit too. Shapes the
    kernels cannot stage go to ``F.conv2d``."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels import tconv as T
    from wav2letter_tpu_torch.models.layers import K2_MAX_WEIGHT_BYTES, Conv2D

    limit = _build.MAX_SMEM_BYTES
    widths = (1, 2, 3, 7, 8, 16, 20, 28, 36, 48, 64, 96, 128, 512, 2048, 16384)
    admitted = refused = 0
    for K in (1, 2, 5, 9, 12, 16, 33):
        for C in widths:
            for CO in widths:
                if 4 * K * C * CO > K2_MAX_WEIGHT_BYTES:
                    continue
                for s in (1, 2):
                    with torch.device("meta"):
                        conv = Conv2D(C, CO, K, 1, s)
                    takes = T.time_conv_takes(K, C, CO, s)
                    assert conv.time_only == takes, (K, C, CO, s)
                    if not takes:
                        refused += 1
                        continue
                    admitted += 1
                    for F in (1, 3, 80, 1000):
                        assert T.cc_smem_bytes(C, CO, K, s, F) <= limit
                        assert T.cc_smem_bytes(CO, C, K, 1, F) <= limit  # dgrad
                        fb = T.cc_wgrad_fb(C, CO, K, s, F)
                        assert T.cc_wgrad_smem_bytes(C, CO, K, s, fb) <= limit
                        if T.tc_takes(C, CO, K, s, F):
                            assert T.tc_smem_bytes(C, CO, K, s) <= limit
                        if T.tc_wgrad_takes(C, CO, K, s, F):
                            assert T.tc_wgrad_smem_bytes(C, CO, K, s) <= limit
    assert admitted > 1000 and refused > 0
    # the fault the route had: a 1-tap conv of 16384 channels admitted by
    # weight bytes alone, whose window no block can stage
    assert not T.time_conv_takes(1, 16384, 1, 1)
    with torch.device("meta"):
        assert not Conv2D(16384, 1, 1).time_only
        assert Conv2D(36, 36, 12).time_only  # the largest weight admitted: 62 KB


@pytest.mark.parametrize("C,CO,K,s", RECIPE_CONVS)
def test_recipe_convs_take_the_tensor_cores_in_bf16(C, CO, K, s):
    """At F = 80 every recipe conv runs forward, dgrad and K2b on the tensor
    cores in bf16 (the first conv, C = 1, by its taps), and in fp32 too
    (3xTF32)."""
    from wav2letter_tpu_torch.kernels import tconv as T

    for kind in ("conv", "dgrad", "wgrad"):
        assert T.route(torch.bfloat16, C, CO, K, s, 80, kind) == "tensor cores"
        assert T.route(torch.float32, C, CO, K, s, 80, kind) == "tensor cores"
    assert T.time_conv_takes(K, C, CO, s)


def test_tensor_core_layouts_and_picks():
    """The Python mirrors of the tensor-core kernels' shapes: copy granule,
    shared memory, K2b's units and warps a unit, tiles a block walks."""
    from wav2letter_tpu_torch.kernels import tconv as T

    assert [T.tc_granule(C, F) for C, F in ((16, 80), (20, 80), (28, 80), (2, 80), (1, 80),
                                             (1, 6), (1, 3), (5, 3), (28, 3))] == \
        [16, 8, 8, 4, 16, 4, 0, 0, 8]
    # C = 28, CO = 28, K = 11: weight 11 x 32 rows of 40; ring 42 rows of 16 x
    # 40; table
    assert T.tc_smem_bytes(28, 28, 11, 1) == 2 * 352 * 40 + 2 * 42 * 640 + 32 * 28
    # C = 1, K = 9, stride 2: 16 tap rows of 24; ring (15 * 2 + 9) + 32 rows
    # of 24, rounded up to an even 72
    assert T.tc_smem_bytes(1, 16, 9, 2) == 2 * 16 * 24 + 2 * 72 * 24 + 32
    assert T.tc_wgrad_units(28, 11) == (22, 1)  # 22 items: 3 a warp at most
    assert T.tc_wgrad_units(1, 9) == (1, 8)
    assert T.tc_wgrad_units(16, 9) == (9, 2)  # 18 items, not 2 units on one warp of 8
    assert T.tc_wgrad_units(8, 3) == (3, 8)
    assert T.tc_wgrad_units(2, 5) == (5, 4)
    assert not T.tc_wgrad_takes(36, 36, 12, 1, 80)  # 36 units: the CUDA cores
    assert T.tc_takes(36, 36, 12, 1, 80)
    assert not T.tc_takes(5, 7, 10, 2, 3)  # odd C
    assert not T.tc_takes(16, 72, 3, 1, 80)  # CO past 64
    # blocks an SM: two up to 113 KB of shared memory each
    assert T.tc_blocks_per_sm(T.tc_smem_bytes(28, 28, 11, 1)) == 2
    assert T.tc_blocks_per_sm(T.tc_wgrad_smem_bytes(20, 24, 11, 2)) == 2
    assert T.tc_blocks_per_sm(T.tc_smem_bytes(64, 64, 16, 2)) == 1
    # serving's first TDS (B=4, Tout=768, 20 pairs of batch row and 16
    # positions) on 264 slots: 13 runs a pair, 4 of 48 tiles each, 240
    # blocks in one wave; the last (Tout=192): one tile a block; training
    # (B=16, 80 pairs): 3 runs of 16 tiles, or one run on 132 slots
    assert T.tc_tiles_per_block(4, 768, 80, 264) == 4
    assert T.tc_tiles_per_block(4, 192, 80, 264) == 1
    assert T.tc_tiles_per_block(16, 768, 80, 264) == 16
    assert T.tc_tiles_per_block(16, 768, 80, 132) == 48
    # (tiles a block, blocks): the serving TDS conv fits two blocks an SM
    assert T.tc_schedule(4, 768, 80, T.tc_smem_bytes(16, 16, 9, 1), 132) == (4, 240)
    assert T.tc_schedule(16, 190, 80, T.tc_wgrad_smem_bytes(28, 28, 11, 1), 132) == (4, 240)


# the time-only convs of the recipes a route test covers, as (path or
# "mls", features): a frequency axis of 80 filterbanks, or CPC's raw audio
RECIPE_ARCHS = [("recipes/streaming_convnets/network.arch", 80),
                ("recipes/transformer_ctc/network.arch", 80),
                ("recipes/seq2seq_tds/network.arch", 80), ("mls", 80),
                ("recipes/cpc/encoder.arch", 1)]


def _time_convs(arch, nfeat):
    """(C, CO, K, stride, F) of every K2 conv of a recipe's model: the
    time-only ``Conv2D`` layers (at the F their input has) and the TDS
    blocks' convs."""
    import os

    from wav2letter_tpu_torch.models import build_arch_from_lines, build_arch_module
    from wav2letter_tpu_torch.models.layers import Conv2D, TDSBlock
    from wav2letter_tpu_torch.plugins.mling import ENCODER_LINES

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with torch.device("meta"):
        if arch == "mls":
            model = build_arch_from_lines([l.format(nfeat=nfeat) for l in ENCODER_LINES], 30)
        else:
            model = build_arch_module(os.path.join(repo, arch), nfeat, 30)
    out = set()
    for m in model.modules():
        if isinstance(m, Conv2D) and m.time_only:
            out.add((m.in_ch, m.out_ch, m.wx, m.sx, nfeat))
        elif isinstance(m, TDSBlock):
            out.add((m.c, m.c, m.w, 1, m.f))
    return sorted(out)


@pytest.mark.parametrize("arch,nfeat", RECIPE_ARCHS)
def test_recipe_conv_routes(arch, nfeat):
    """The flagship's and seq2seq_tds's K2 convs keep the tensor cores in both
    types, forward, dgrad and K2b; the transformer's and mls's have none
    (weight-normed convs through ``F.conv2d``); CPC's first conv, C 1 -> 512,
    takes the wide route forward and for K2b in both types (its dgrad, never
    launched on raw audio, the CUDA cores)."""
    from wav2letter_tpu_torch.kernels import tconv as T

    convs = _time_convs(arch, nfeat)
    if "transformer" in arch or arch == "mls":
        assert convs == []
    elif "cpc" in arch:
        assert convs == [(1, 512, 10, 5, 1)]
    else:
        assert convs and all(CO <= T.TC_MAX_CO for _, CO, _, _, _ in convs)
    for C, CO, K, s, F in convs:
        for dt in (torch.float32, torch.bfloat16):
            want = "wide" if "cpc" in arch else "tensor cores"
            assert T.route(dt, C, CO, K, s, F, "conv") == want
            assert T.route(dt, C, CO, K, s, F, "wgrad") == want
            assert T.route(dt, C, CO, K, s, F, "dgrad") == \
                ("CUDA cores" if "cpc" in arch else "tensor cores")


def test_wide_route_takes_what_the_tensor_cores_refuse_for_width():
    """``route`` gives "wide" for CPC's conv and for CO = 68 and 128 at C = 1,
    forward and K2b, never for dgrad; it refuses CO up to 64 (the tensor
    cores), CO not a whole number of 4-channel vectors or past 1024, and more
    than 16 (tap, channel) pairs."""
    from wav2letter_tpu_torch.kernels import tconv as T

    for dt in (torch.float32, torch.bfloat16):
        for C, CO, K, s, F in ((1, 512, 10, 5, 1), (1, 68, 10, 5, 1), (1, 128, 10, 5, 1),
                               (1, 128, 9, 2, 80), (2, 520, 8, 4, 3), (1, 1024, 16, 1, 1)):
            for kind in ("conv", "wgrad"):
                assert T.route(dt, C, CO, K, s, F, kind) == "wide", (dt, C, CO, K, s, F, kind)
            assert T.route(dt, C, CO, K, s, F, "dgrad") != "wide"
        for C, CO, K in ((1, 64, 10), (1, 130, 10), (1, 1028, 10), (1, 512, 17), (2, 512, 9),
                         (17, 128, 1)):
            assert not T.wide_takes(C, CO, K, 5, 1, dt) and \
                not T.wide_takes(C, CO, K, 5, 1, dt, "wgrad")
        assert T.route(dt, 1, 64, 9, 2, 80) == "tensor cores"
    # too wide a window for a block: 1000 positions of 16 channels, K2b's
    # stage of one frame is 4 MB of dy
    assert not T.wide_takes(16, 1024, 1, 1, 1000, torch.float32, "wgrad")


def test_wide_layouts_and_plans():
    """The Python mirrors of the wide kernels' shared memory and plan
    (``csrc/tconv_wide.cu``; the ``cuda`` tests hold them to the C twins), by
    hand at CPC's conv, B = 8 and 200,000 output frames, on 132 SMs."""
    from wav2letter_tpu_torch.kernels import tconv as T

    assert [T.wide_groups(CO) for CO in (68, 128, 512, 520, 1024)] == [15, 8, 2, 1, 1]
    # K2: 16 rows a thread, 2 row groups: 32 frames a tile, a window of 31 * 5
    # + 10 = 165 floats (660 bytes, padded to 672, + 32) twice, and the head
    assert T.wide_layout(1, 1, 512, 10, 5, 4) == (32, 128 + 2 * (672 + 32))
    # K2b: 16 KB of dy a stage (8 frames of 512 floats) + 32, a window of 7 * 5
    # + 10 = 45 floats (180 -> 192, + 32), four stages, the head; the row
    # groups' sums (2 x 10 x 512 floats) fit in the ring
    assert T.wide_layout(1, 1, 512, 10, 5, 4, "wgrad") == (8, 128 + 4 * (16416 + 224))
    assert T.wide_layout(1, 1, 512, 10, 5, 2, "wgrad") == (16, 128 + 4 * (16416 + 208))
    # (frames a tile, tiles a block, blocks): 2 blocks an SM; 782 tiles a row
    assert T.wide_plan(8, 25000, 1, 1, 512, 10, 5, 4, 132) == (32, 24, 261)
    assert T.wide_plan(8, 25000, 1, 1, 512, 10, 5, 4, 132, "wgrad") == (8, 95, 264)
    assert T.wide_plan(1, 7, 1, 1, 512, 10, 5, 4, 132, "wgrad") == (8, 1, 1)
    # one block an SM where two do not fit: a stage of one frame of 20
    # positions of 520 channels (41.6 KB of dy), four of them 166 KB
    assert T.wide_layout(20, 1, 520, 10, 5, 4, "wgrad")[0] == 1
    assert T.tc_blocks_per_sm(T.wide_layout(20, 1, 520, 10, 5, 4, "wgrad")[1]) == 1
    sched = T.schedule(torch.float32, 8, 25000, 1, 512, 10, 5, 1, 132, "wgrad")
    assert (sched["blocks"], sched["warps"], sched["row_groups"]) == (264, 9, 2)


def test_fp32_tensor_core_layouts():
    """The Python mirrors of the fp32 (3xTF32) K2 and K2b shapes: copy
    granule, shared memory by hand, the takes and the routes."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels import tconv as T

    assert [T.tf32_granule(C, F) for C, F in ((16, 80), (20, 80), (28, 80), (2, 80), (1, 80),
                                               (1, 6), (1, 3), (5, 3), (28, 3))] == \
        [16, 16, 16, 8, 16, 8, 4, 4, 16]
    assert T.tf32_granule(1, 80, taps=False) == 4  # dy's CO = 1: a float a position
    # C = 28 -> 28, K = 11, 8 warps x 2 frames: the weight twice, 11 x 32 rows
    # of 40 floats; the ring (15 + 11) + 16 = 42 rows of 16 x 36 floats
    assert T.tf32_smem_bytes(28, 28, 11, 1, 8, 2, 1) == 4 * (2 * 352 * 40 + 42 * 16 * 36)
    # the same conv with its taps split over 4 warps, one frame: 11 ring rows
    # and 3 warps' sums of 16 x 32
    assert T.tf32_smem_bytes(28, 28, 11, 1, 1, 1, 4) == \
        4 * (2 * 352 * 40 + 11 * 16 * 36 + 3 * 16 * 32)
    # C = 1, K = 9, stride 2: 16 tap rows of 24 floats; ring (15 * 2 + 9) + 32
    # rows of 24, rounded up to an even 72
    assert T.tf32_smem_bytes(1, 16, 9, 2, 8, 2, 1) == 4 * (2 * 16 * 24 + 72 * 24)
    # K2b, C = 28 -> 28, K = 11: x ring (7 + 11) + 8 rows of 16 x 40; dy 16 rows
    assert T.tf32_wgrad_smem_bytes(28, 28, 11, 1) == 4 * (26 * 16 * 40 + 16 * 16 * 40)
    # C = 1: taps rows of 20 floats, (14 + 9) + 16 -> 40 rows
    assert T.tf32_wgrad_smem_bytes(1, 16, 9, 2) == 4 * (40 * 20 + 16 * 16 * 24)
    assert T.tf32_steps(1, 9) == 2 and T.tf32_steps(28, 11) == 44 and T.tf32_steps(20, 9) == 27
    # fp32 takes odd C and CO (no pairs to copy), up to CO = 64 and the
    # shared memory; the largest weight the route admits fits to the byte
    assert T.tc_takes(5, 7, 10, 2, 3, torch.float32) and not T.tc_takes(5, 7, 10, 2, 3)
    assert not T.tc_takes(16, 72, 3, 1, 80, torch.float32)
    assert T.tf32_smem_bytes(36, 36, 12, 1, 8, 1, 1) == _build.MAX_SMEM_BYTES
    assert T.tc_takes(36, 36, 12, 1, 80, torch.float32)
    assert not T.tc_takes(48, 48, 12, 1, 80, torch.float32)
    assert not T.tc_wgrad_takes(36, 36, 12, 1, 80, torch.float32)  # 36 units
    assert T.tc_wgrad_takes(5, 7, 10, 2, 3, torch.float32)
    assert T.route(torch.float32, 36, 36, 12, 1, 80, "wgrad") == "CUDA cores"
    assert T.route(torch.float32, 48, 48, 12, 1, 80, "conv") == "CUDA cores"


# (B, Tout, C, CO, K, stride) -> the fp32 K2 schedule on 132 SMs: (warps along
# the frames, frames a warp, warps splitting the taps, tiles a block, blocks).
# The stream's three K2 shapes (PERF.md: the first C2, the first and the last
# TDS conv at a steady chunk), then the flagship's convs at the serving batch
# (B = 4, T = 1536 features) and at the training batch (B = 16)
TF32_PLANS = [
    ((1, 25, 1, 16, 9, 2), (4, 1, 1, 1, 35)),
    ((1, 25, 16, 16, 9, 1), (1, 1, 4, 1, 125)),
    ((1, 6, 28, 28, 11, 1), (1, 1, 8, 1, 30)),
    ((4, 768, 1, 16, 9, 2), (8, 2, 1, 4, 240)),
    ((4, 768, 16, 16, 9, 1), (8, 2, 1, 4, 240)),
    ((4, 384, 16, 20, 11, 2), (8, 2, 1, 4, 120)),
    ((4, 384, 20, 20, 9, 1), (8, 2, 1, 2, 240)),
    ((4, 192, 20, 24, 11, 2), (8, 2, 1, 2, 120)),
    ((4, 192, 24, 24, 11, 1), (8, 2, 1, 2, 120)),
    ((4, 192, 24, 28, 12, 1), (8, 2, 1, 2, 120)),
    ((4, 192, 28, 28, 11, 1), (8, 2, 1, 2, 120)),
    ((16, 768, 1, 16, 9, 2), (8, 2, 1, 16, 240)),
    ((16, 768, 16, 16, 9, 1), (8, 2, 1, 16, 240)),
    ((16, 192, 28, 28, 11, 1), (8, 2, 1, 4, 240)),
]


@pytest.mark.parametrize("shape,plan", TF32_PLANS)
def test_fp32_tensor_core_plans(shape, plan):
    """At the stream's three shapes a block is one frame whose 4 or 8 warps
    split the taps (4 frames of one warp each at C = 1), 30-125 blocks where
    the batch blocks would be 10; at the batch shapes 8 warps walk 16-frame
    tiles. Every one of these runs forward, dgrad and K2b on the tensor
    cores, and the counts agree with the blocks a launch covers."""
    from wav2letter_tpu_torch.kernels import tconv as T

    B, Tout, C, CO, K, s = shape
    got = T.tf32_plan(B, Tout, 80, C, CO, K, s, 132)
    assert got == plan
    mw, mt, ks, ch, blocks = got
    assert blocks == B * 5 * -(-(-(-Tout // (mw * mt))) // ch)
    assert mw * ks <= 8 and (ks == 1 or (mw, mt, ch) == (1, 1, 1))
    assert T.tf32_smem_bytes(C, CO, K, s, mw, mt, ks) <= T.tf32_smem_bytes(
        C, CO, K, s, *T._tf32_batch(CO), 1)
    for kind in ("conv", "dgrad", "wgrad"):
        assert T.route(torch.float32, C, CO, K, s, 80, kind) == "tensor cores"
    sched = T.schedule(torch.float32, B, Tout, C, CO, K, s, 80, 132)
    assert (sched["warps"], sched["tap_splits"], sched["blocks"]) == (mw * ks, ks, blocks)


def test_fp32_tile_chooser_takes_a_second_wave_where_it_pays():
    """At one block an SM (C = 28, 209 KB) and B = 16, 80 (batch row, 16
    positions) pairs: one run each would leave 52 of 132 SMs idle for a
    48-tile run; three runs of 16 take two waves of 32 tiles' work."""
    from wav2letter_tpu_torch.kernels import tconv as T

    assert T.tc_blocks_per_sm(T.tf32_smem_bytes(28, 28, 11, 1, 8, 2, 1)) == 1
    assert T.tc_tiles_per_block(16, 768, 80, 132) == 48
    assert T.tf32_tiles_per_block(16, 768, 80, 132, 16) == 16
    assert T.tf32_tiles_per_block(4, 768, 80, 264, 16) == 4  # as the bf16 cut
    assert T.tf32_wgrad_schedule(16, 768, 80, 28, 28, 11, 1, 132) == (32, 240)


def test_k2_trace_finds_its_anchors_in_the_kernel_sources():
    """``kernels/trace_k2.py`` stamps the tensor-core K2 and K2b by editing
    copies of their sources at fixed anchors; it must find each of them once."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k2 import _PROLOGUE_K2, _PROLOGUE_K2B, _instrument

    for name, prologue, sym in (("tconv.cu", _PROLOGUE_K2, "g_k2_stamps"),
                                ("tconv_wgrad.cu", _PROLOGUE_K2B, "g_k2b_stamps")):
        traced = _instrument((_build.CSRC / name).read_text(), prologue, sym)
        assert traced.count("clock64()") == 6 and f"{sym}_read" in traced


def test_k2_trace_stamps_the_fp32_kernels():
    """``kernels/trace_k2.py`` turns the fp32 kernels' ``W2L_STAMP`` points
    (empty in the port's build) into clock64 stamps; each kernel keeps the
    points of its set-up and of every tile that the trace reads."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k2 import _stamp_points

    assert "#define W2L_STAMP(i)\n" in (_build.CSRC / "tf32_tile.cuh").read_text()
    for name in ("tconv.cu", "tconv_wgrad.cu"):
        src = (_build.CSRC / name).read_text()
        first = _stamp_points(src, "g_k2_stamps").splitlines()[0]
        assert first.startswith("#define W2L_STAMP(i) ") and "clock64()" in first
        for point in ("0", "1", "2 + 4 * it", "3 + 4 * it", "4 + 4 * it", "5 + 4 * it"):
            assert f"W2L_STAMP({point});" in src, (name, point)
    assert "#define W2L_STAMP(i)\n" in (_build.CSRC / "tconv_wide.cu").read_text()


def test_k2_trace_stamps_the_wide_kernels():
    """The wide K2 stamps three points a tile and K2b two a stage, within
    ``_STAMPS`` a block, as ``trace_k2._median_wide`` reads them, into the
    symbol the traced copy declares; it sums a block's steps from the
    stamps."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels import trace_k2 as TK

    src = (_build.CSRC / "tconv_wide.cu").read_text()
    traced = TK._stamped_wide(src, "g_k2w_stamps")
    assert traced.startswith("#define W2L_STAMP(i) ") and "g_k2w_stamps_read" in traced
    assert "__device__ long long g_k2w_stamps[1 << 20];" in traced
    for kind in ("conv", "wgrad"):
        per, cap = TK.WIDE_STAMPED[kind]
        for j in range(per):
            assert f"if (it < {cap}) {{ W2L_STAMP({2 + j} + {per} * it); }}" in src, (kind, j)
        assert 2 + per * cap <= TK._STAMPS
    # two blocks of two tiles: stamps 0, 1, then (load, compute, barrier) a tile
    st = np.zeros((2, TK._STAMPS), np.int64)
    st[0, :8] = [0, 10, 15, 40, 41, 50, 90, 92]
    st[1, :8] = [0, 10, 12, 30, 31, 33, 60, 61]
    got = TK._median_wide(st, np.array([2, 2]), "conv")
    assert got["block_cycles"] == dict(min=61, median=76, max=92)
    assert got["median_block"] == dict(setup=10, wait=5 + 9, compute=25 + 40, barrier=1 + 2,
                                       tiles=2)


# ---------------------------------------------------------------------------
# K1's tensor-core route: its 3xTF32 arithmetic in numpy, and the layouts
# of K1's and K3's two routes in Python
# ---------------------------------------------------------------------------
def _rna_tf32(x):
    """cvt.rna.tf32.f32: fp32 rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero (the low 13 bits of the word become 0)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _mma_3xtf32(a, b):
    """a (M, K) @ b (K, N), K a multiple of 8, as the kernel's m16n8k8 TF32
    steps: per 8-deep step small.big, then big.small, then big.big, each added
    to the fp32 sums."""
    (ab, asm), (bb, bsm) = _split_tf32(a), _split_tf32(b)
    d = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((asm, bb), (ab, bsm), (ab, bb)):
            d = d + x[:, s] @ y[s]
    return d


def _mfsc_3xtf32(pre, cos_mat, sin_mat, mel_fb, frame, stride, mel_floor):
    """K1 on the tensor cores, in numpy: the DFT as one product with cos |
    sin (bins padded to 8, depth to 8, zeros), the magnitudes (0 in the pad
    bins), the mel product, the log."""
    B, S = pre.shape
    T = 1 + (S - frame) // stride
    nb, nm = mel_fb.shape
    kf, np_, nmp = (-(-n // 8) * 8 for n in (frame, nb, nm))
    idx = np.arange(T)[:, None] * stride + np.arange(frame)[None, :]
    frames = np.zeros((B * T, kf), np.float32)
    frames[:, :frame] = pre[:, idx].reshape(B * T, frame)
    bmat = np.zeros((kf, 2 * np_), np.float32)
    bmat[:frame, :nb] = cos_mat
    bmat[:frame, np_:np_ + nb] = sin_mat
    d = _mma_3xtf32(frames, bmat)
    re, im = d[:, :nb], d[:, np_:np_ + nb]
    mag = np.zeros((B * T, np_), np.float32)
    mag[:, :nb] = np.sqrt(np.maximum(re * re + im * im, np.float32(1e-20)))
    fb = np.zeros((np_, nmp), np.float32)
    fb[:nb, :nm] = mel_fb
    mel = _mma_3xtf32(mag, fb)[:, :nm]
    return np.log(np.maximum(mel, np.float32(mel_floor))).reshape(B, T, nm)


def test_tf32_split_rounds_ties_away_from_zero():
    """cvt.rna, not round-half-even: 1 + 2^-11 lies halfway between two TF32
    values and goes up. big + small keeps x to ~2^-22 of it (22 bits of 24)."""
    x = np.float32([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 2**-11 + 2**-23])
    np.testing.assert_array_equal(
        _rna_tf32(x), np.float32([1 + 2**-10, -(1 + 2**-10), 1, 1 + 2**-10]))
    big, small = _split_tf32(x)
    assert np.all(np.abs((big + small) - x) <= 2.0**-22 * np.abs(x))
    np.testing.assert_array_equal((big + small)[:3], x[:3])


# the flagship's frontend (frame 400, n_fft 512, 80 mels) and 8 kHz
# (frame 200, n_fft 256, 40 mels); S gives ragged 16- and 32-frame tiles
@pytest.mark.parametrize("rate,n_mels,S,B", [(16000, 80, 16000, 2), (8000, 40, 8000, 2)])
def test_mfsc_tensor_core_arithmetic_matches_pallas(rate, n_mels, S, B):
    """The kernel's 3xTF32 products (emulated bit for bit in their operand
    rounding, with fp32 sums) hold the TPU kernel's 1e-4, on rows with
    silence (every bin at the 1e-20 floor) and quiet stretches."""
    p = FeatureParams(sample_rate=rate, n_filterbanks=n_mels)
    f = Featurizer(p)
    rng = np.random.RandomState(rate + n_mels)
    audio = (rng.randn(B, S) * 0.1).astype(np.float32)
    audio[0, :S // 4] = 0
    audio[-1, S // 4:S // 2] *= 1e-3
    pre = _pre(audio, p.preem_coef).astype(np.float32)
    frames = f.frame_signal(jnp.asarray(pre))
    want = np.asarray(pallas_mfsc(frames, f.cos_mat, f.sin_mat, f.mel_fb,
                                  mel_floor=p.mel_floor, interpret=True))
    got = _mfsc_3xtf32(pre, np.asarray(f.cos_mat), np.asarray(f.sin_mat),
                       np.asarray(f.mel_fb), p.frame_samples, p.stride_samples, p.mel_floor)
    assert got.shape == want.shape and p.n_fft // 2 + 1 == f.mel_fb.shape[0]
    # the CUDA tests' and chip_smoke's tolerance for the kernel
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mfsc_routes_and_tiles():
    """K1's routes and tiles in Python (the C twins are held to these on the
    card): every frontend of the recipes takes the tensor cores, and the tile
    fills the SMs in whole waves."""
    from wav2letter_tpu_torch.features import FeatureParams as TorchFeatureParams
    import importlib

    from wav2letter_tpu_torch.kernels import _build

    # the module, not the wrapper function that kernels/__init__.py exports
    K1 = importlib.import_module("wav2letter_tpu_torch.kernels.mfsc")

    # audio 34 rows x 164 floats; 4 x 8 rows x 2 x 276 floats of cos | sin
    assert K1.tc_smem_bytes(32, 400, 160, 257) == 4 * (34 * 164 + 4 * 8 * 2 * 276)
    assert K1.tc_smem_bytes(16, 400, 160, 257) == 4 * (18 * 164 + 4 * 8 * 2 * 276)
    assert K1.tc_smem_bytes(48, 400, 160, 257) == 4 * (50 * 164 + 4 * 8 * 2 * 276)
    assert K1.tc_smem_bytes(32, 200, 80, 129) == 4 * (34 * 84 + 4 * 8 * 2 * 148)
    for rate, mels in ((16000, 80), (16000, 40), (8000, 40), (16000, 24)):
        p = TorchFeatureParams(sample_rate=rate, n_filterbanks=mels)
        nb = p.n_fft // 2 + 1
        assert K1.route(p.frame_samples, p.stride_samples, nb, mels) == K1.TENSOR_CORES
        for tt in K1.TC_TILES[1:]:  # two blocks an SM (one of 48 frames)
            assert K1.tc_smem_bytes(tt, p.frame_samples, p.stride_samples, nb) + 1024 \
                <= 228 * 1024 // 2
    assert K1.route(400, 100, 257, 80) == K1.CUDA_CORES  # an 8-deep step crosses rows
    assert K1.route(400, 160, 257, 80, aligned=False) == K1.CUDA_CORES
    assert K1.tc_takes(400, 160, K1.TC_MAX_BINS, 80)
    assert not K1.tc_takes(400, 160, K1.TC_MAX_BINS + 1, 80)
    assert K1.tc_takes(4000, 8, 257, 80)  # 531 rows of 12 floats: 25 KB of audio
    assert not K1.tc_takes(40000, 8, 257, 80)  # 5031 rows: 241 KB
    assert K1.tc_smem_bytes(32, 40000, 8, 257) > _build.MAX_SMEM_BYTES
    # serving, 4 x 1536 frames: 128 blocks of 48, one on the busiest SM
    # (1 x 88), 192 of 32 (2 x 72) or 384 of 16 (3 x 56); training, 16 x 1536:
    # 4 x 88, 6 x 72 or 12 x 56; one row of 1536 frames: 1 x 88, 1 x 72, 1 x 56
    assert K1.tile_frames(4, 1536) == 48
    assert K1.tile_frames(16, 1536) == 48
    assert K1.tile_frames(1, 10) == 16
    assert K1.tile_frames(1, 1536) == 16
    assert K1.tile_frames(8, 1536) == 48  # 256 of 48: 2 x 88; 384 of 32: 3 x 72
    def load(B, T, tt):
        return -(-(B * -(-T // tt)) // 132) * (tt + K1.TILE_FIXED_FRAMES)

    for B in range(1, 17):
        for T in (1, 15, 16, 17, 98, 500, 1536, 3000):
            tt = K1.tile_frames(B, T)
            assert all(load(B, T, tt) <= load(B, T, o) for o in K1.TC_TILES)
    # the two dense products, 3 passes: 6144 frames x 400 x 528 and x 264 x 80
    assert K1.dense_flops(4, 1536, 400, 257, 80) == 6 * 6144 * (400 * 528 + 264 * 80)


@pytest.mark.parametrize("D,itemsize,wpr", [
    (1280, 2, 2), (1600, 2, 2), (1920, 2, 2), (2240, 2, 4), (768, 2, 1),
    (1280, 4, 4), (1600, 4, 4), (1920, 4, 4), (2240, 4, 8), (768, 4, 2),
])
def test_residual_ln_register_layout(D, itemsize, wpr):
    """Every flagship (TDS rows of C x 80) and transformer (768) row takes
    K3's register route: one block a row, the fewest warps that keep a lane
    at four 16-byte vectors of each input."""
    from wav2letter_tpu_torch.kernels import layernorm as K3

    assert K3.route(D, itemsize) == K3.REGISTERS
    assert K3.warps_per_row(D, itemsize) == wpr
    nvec = D // (16 // itemsize)
    assert -(-nvec // (32 * wpr)) <= K3.LN_VECTORS  # a lane's vectors
    assert wpr == 1 or -(-nvec // (16 * wpr)) > K3.LN_VECTORS


def test_residual_ln_routes():
    """The flagship's TDS rows are the widths above; what the register route
    leaves to the shared-memory route."""
    from pathlib import Path

    from wav2letter_tpu_torch.kernels import layernorm as K3
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.models.layers import TDSBlock

    arch = Path(__file__).resolve().parents[1] / "recipes" / "streaming_convnets" / "network.arch"
    with torch.device("meta"):
        model = build_arch_module(str(arch), 80, 9998)
    assert sorted({m.c * m.f for m in model.modules() if isinstance(m, TDSBlock)}) == \
        [1280, 1600, 1920, 2240]
    assert K3.route(100, 2) == K3.SHARED_MEMORY  # 200 bytes: no 16-byte vectors
    assert K3.route(100, 4) == K3.REGISTERS
    assert K3.route(1, 4) == K3.SHARED_MEMORY
    # past 8 warps x 32 lanes x 4 vectors
    assert K3.warps_per_row(8192, 2) == 8 and K3.route(8200, 2) == K3.SHARED_MEMORY
    assert K3.warps_per_row(4096, 4) == 8 and K3.route(4100, 4) == K3.SHARED_MEMORY
    assert K3.route(1280, 2, aligned=False) == K3.SHARED_MEMORY


# (D, itemsize, route, warps a row) of K3b: mls (256), the transformer and
# transformer_s2s (768), the flagship (1280-2240), 3072, the register
# route's widest rows and one vector past them, a D that is not a multiple
# of the 16-byte vector
_R, _S = "registers", "shared memory"
K3B_LAYOUTS = [
    (96, 2, _R, 1), (256, 2, _R, 1), (768, 2, _R, 1), (1280, 2, _R, 2), (1600, 2, _R, 2),
    (1920, 2, _R, 2), (2240, 2, _R, 4), (3072, 2, _R, 4), (8192, 2, _R, 8), (8200, 2, _S, 0),
    (100, 2, _S, 0),
    (96, 4, _R, 1), (256, 4, _R, 1), (768, 4, _R, 2), (1280, 4, _R, 4), (1600, 4, _R, 4),
    (1920, 4, _R, 4), (2240, 4, _R, 8), (3072, 4, _R, 8), (4096, 4, _R, 8), (4100, 4, _S, 0),
    (98, 4, _S, 0),
]


@pytest.mark.parametrize("D,itemsize,way,wpr", K3B_LAYOUTS)
def test_residual_ln_bwd_layout(D, itemsize, way, wpr):
    """K3b's route, warps a row and rows a block: K3's register widths, one
    row a block of 2-8 warps, csrc's ``LN_BWD_ROWS`` one-warp rows a block
    (read from the source the launch is built from); a view that is not
    16-byte aligned goes through shared memory, a block of 256 threads a
    row."""
    from wav2letter_tpu_torch.kernels import layernorm as K3
    from wav2letter_tpu_torch.kernels.trace_k3b import bwd_rows

    rows = bwd_rows() if wpr == 1 else 1
    assert K3.bwd_layout(D, itemsize) == (way, wpr)
    assert K3.route(D, itemsize) == way and K3.warps_per_row(D, itemsize) == wpr
    assert K3.bwd_layout(D, itemsize, aligned=False) == (_S, 0)
    assert wpr * rows <= K3.LN_MAX_WARPS  # a block's warps


def test_residual_ln_bwd_constants_and_signature():
    """The constants the C rule of warps a row (``w2l_residual_ln_warps``)
    reads are the Python rule's (the functions themselves are held to each
    other on the card); K3b's one-warp rows a block is one a block can hold;
    and the launch's ctypes signature has one int per C parameter: dtype, R,
    D and warps a row."""
    import re

    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels import layernorm as K3
    from wav2letter_tpu_torch.kernels.trace_k3b import bwd_rows

    src = (_build.CSRC / "layernorm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("LN_VECTORS") == K3.LN_VECTORS
    assert const("LN_MAX_WARPS") == K3.LN_MAX_WARPS
    assert bwd_rows(src) == const("LN_BWD_ROWS") and bwd_rows() in (1, 2, 4, 8)
    assert _build.SIGNATURES["w2l_residual_ln_bwd"] == \
        [_build._P] * 9 + [_build._I] * 4 + [_build._P]
    decl = re.search(r'extern "C" int w2l_residual_ln_bwd\((.*?)\)', src, re.S).group(1)
    assert len(decl.split(",")) == len(_build.SIGNATURES["w2l_residual_ln_bwd"])


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_k3b_rows_sweep_changes_one_constant(rows):
    """``time_k1k3.py --k3b-rows`` times copies of ``csrc/layernorm.cu`` that
    differ from it by ``LN_BWD_ROWS`` alone."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k3b import bwd_rows, with_bwd_rows

    src = (_build.CSRC / "layernorm.cu").read_text()
    copy = with_bwd_rows(src, rows)
    assert bwd_rows(copy) == rows
    diff = [(a, b) for a, b in zip(src.splitlines(), copy.splitlines()) if a != b]
    assert len(src.splitlines()) == len(copy.splitlines())
    assert len(diff) == (rows != bwd_rows(src))
    assert all("LN_BWD_ROWS" in a for a, _ in diff)


def test_k3b_trace_instruments_the_kernel():
    """``kernels/trace_k3b.py`` finds each of its anchors once in K3b's
    register kernel, and the copy it builds differs from the source only by
    the stamps: the kernel's own lines are all there, in order."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k3b import _instrument

    src = (_build.CSRC / "layernorm.cu").read_text()
    traced = _instrument(src)
    assert traced.count("g_k3b_stamps") == 3 and "w2l_k3b_stamps" in traced
    kept = iter(traced.splitlines())
    assert all(line in kept for line in src.splitlines())


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a header the kernels share (``mma.cuh``: K1's and K4's
    3xTF32 pieces) rebuilds the library."""
    import shutil

    from wav2letter_tpu_torch.kernels import _build

    for p in _build.CSRC.iterdir():
        shutil.copy(p, tmp_path / p.name)
    assert {"mma.cuh", "tc_tile.cuh", "common.cuh"} <= {p.name for p in tmp_path.iterdir()}
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    with open(tmp_path / "mma.cuh", "a") as f:
        f.write("\n")
    assert _build._digest() != before


def test_k1_trace_finds_its_anchors_in_the_kernel_source():
    """``kernels/trace_k1.py`` stamps the tensor-core K1 by editing a copy of
    its source at fixed anchors; it must find each of them once."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k1 import _instrument

    traced = _instrument((_build.CSRC / "mfsc.cu").read_text())
    assert traced.count("clock64()") == 12 and "w2l_k1_stamps" in traced


def test_ctc_probe_alters_only_the_dx_softmax_or_lse():
    """``kernels/probe_ctc.py`` finds the dx kernel's softmax and lse in
    ``ctc.cu``; its ``sm_bf16`` copy rounds the one softmax expression that
    every class goes through to bf16 and ``lse_1e-3`` moves lse alone; every
    other line is the source's."""
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.probe_ctc import mutant_sources

    src = (_build.CSRC / "ctc.cu").read_text()
    copies = mutant_sources(src)
    assert copies["control"] == src
    for name, n_lines, mark in (("sm_bf16", 1, "__float2bfloat16(expf("),
                                ("lse_1e-3", 1, " + 1e-3f;")):
        changed = [(a, b) for a, b in zip(src.splitlines(), copies[name].splitlines()) if a != b]
        assert len(copies[name].splitlines()) == len(src.splitlines())
        assert len(changed) == n_lines and all(mark in b for _, b in changed), name
