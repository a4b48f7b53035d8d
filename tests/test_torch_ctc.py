"""The port's CTC loss and its gradient with respect to the raw logits (on
the CPU the plain version of K5/K5b, ``kernels/ctc.py::ctc_loss_plain``)
against ``wav2letter_tpu/ops/ctc.py`` (a ``lax.scan`` with an analytic VJP)
on padded batches: ``logit_len < T``, targets padded with -1, blank last; and
at the edges the kernels must take: no label, one frame, runs of one token,
bf16 logits, L on the block route at 261 states, 9998 classes. Inputs from a numpy
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2letter_tpu.criterions import CTCCriterion as JaxCTC
from wav2letter_tpu.criterions import get_scale_mode as jax_scale_mode
from wav2letter_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from wav2letter_tpu_torch.criterions import CTCCriterion, get_scale_mode, make_criterion
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.kernels import KERNELS, PLAIN
from wav2letter_tpu_torch.kernels import ctc as K5
from wav2letter_tpu_torch.ops.ctc import ctc_loss


def _batch(seed, B=5, T=23, N=9, U=6):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(B, T, N)).astype(np.float32)
    logit_len = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    logit_len[0] = T
    target_len = rng.randint(1, U + 1, size=B).astype(np.int32)
    targets = np.full((B, U), -1, np.int32)
    for i in range(B):
        targets[i, : target_len[i]] = rng.randint(0, N - 1, size=target_len[i])
    targets[1, :2] = 3  # a repeated label needs a blank between
    target_len[1] = max(target_len[1], 2)
    return logits, targets, logit_len, target_len


def _both(logits, targets, logit_len, target_len, weights):
    jargs = [jnp.asarray(a) for a in (targets, logit_len, target_len)]
    jl = jax_ctc_loss(jnp.asarray(logits), *jargs)
    jg = jax.grad(lambda x: jnp.sum(jax_ctc_loss(x, *jargs) * jnp.asarray(weights)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl = ctc_loss(x, *(torch.from_numpy(a) for a in (targets, logit_len, target_len)))
    (tl * torch.from_numpy(weights)).sum().backward()
    return np.asarray(jl), np.asarray(jg), tl.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_and_gradient_match_jax(seed):
    logits, targets, logit_len, target_len = _batch(seed)
    weights = np.random.RandomState(seed + 9).rand(len(logits)).astype(np.float32) + 0.5
    jl, jg, tl, tg = _both(logits, targets, logit_len, target_len, weights)
    # fp32 log-space recursions over <= 23 frames, losses O(10-50)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tg, jg, atol=2e-5)
    for i, n in enumerate(logit_len):  # no gradient past the valid frames
        assert not tg[i, n:].any() and not jg[i, n:].any()


def _feasible(targets, logit_len, target_len):
    """A row has a valid alignment: at least as many frames as labels plus
    one blank between each pair of equal neighbours."""
    out = []
    for tgt, n, u in zip(targets, logit_len, target_len):
        repeats = sum(int(tgt[i] == tgt[i - 1]) for i in range(1, u))
        out.append(u + repeats <= n)
    return np.array(out)


def test_infeasible_rows_are_finite_as_in_jax():
    """More labels (with the blanks that repeats need) than frames: JAX's
    finite -1e30 makes the loss 1e30, not inf, and keeps the gradient finite
    (states reached by one scan only get a posterior of 1); the port computes
    the same recursion and gives JAX's loss and gradient on those rows too,
    and the other rows of the batch are untouched."""
    logits, targets, logit_len, target_len = _batch(4)
    targets[2] = [1, 1, 1, 1, 1, 1]
    target_len[2], logit_len[2] = 6, 9  # needs 11 frames
    target_len[3], logit_len[3] = 6, 5
    targets[3] = [0, 1, 2, 3, 4, 5]
    weights = np.ones(len(logits), np.float32)
    jl, jg, tl, tg = _both(logits, targets, logit_len, target_len, weights)
    feasible = _feasible(targets, logit_len, target_len)
    assert list(feasible) == [True, True, False, False, True]
    assert np.isfinite(jl).all() and np.isfinite(jg).all()
    assert np.isfinite(tl).all() and np.isfinite(tg).all()
    np.testing.assert_allclose(tl[~feasible], jl[~feasible], rtol=1e-6)
    assert tl[2] == np.float32(1e30)
    assert np.abs(jg[~feasible]).max() > 1  # JAX's saturated posterior, not 0
    np.testing.assert_allclose(tg[~feasible], jg[~feasible], atol=2e-5)
    np.testing.assert_allclose(tl[feasible], jl[feasible], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tg[feasible], jg[feasible], atol=2e-5)


def _edge(case):
    """(logits, targets, logit_len, target_len) of one edge of K5/K5b."""
    rng = np.random.RandomState(11)
    if case == "no_label":  # target_len = 0: L_eff = 1, aN1 = -1e30
        logits = 2.0 * rng.randn(3, 9, 7)
        targets = np.array([[-1, -1], [2, -1], [-1, -1]])
        return logits, targets, np.array([9, 6, 1]), np.array([0, 1, 0])
    if case == "one_frame":  # logit_len = 1: the beta reset at t = 0, alpha at t = 0
        logits = 2.0 * rng.randn(4, 6, 8)
        targets = np.array([[3, -1], [3, 4], [-1, -1], [5, 5]])
        return logits, targets, np.array([1, 1, 1, 6]), np.array([1, 2, 0, 2])
    if case == "token_runs":  # runs of one token: no skip, one token at many s
        logits = 2.0 * rng.randn(3, 30, 6)
        targets = np.array([[2, 2, 2, 2, 1, 1, 2, 2], [4, 4, 4, 4, 4, 4, 4, 4],
                            [0, 1, 0, 1, 0, -1, -1, -1]])
        return logits, targets, np.array([30, 26, 17]), np.array([8, 8, 5])
    if case == "full_length":  # logit_len = T: the beta init at T - 1
        logits = 2.0 * rng.randn(2, 12, 5)
        targets = np.array([[0, 1, 2], [3, 3, -1]])
        return logits, targets, np.array([12, 12]), np.array([3, 2])
    raise ValueError(case)


@pytest.mark.parametrize("case", ["no_label", "one_frame", "token_runs", "full_length"])
def test_edges_match_jax(case):
    logits, targets, logit_len, target_len = _edge(case)
    args = (logits.astype(np.float32), targets.astype(np.int32), logit_len.astype(np.int32),
            target_len.astype(np.int32))
    weights = np.random.RandomState(3).rand(len(logits)).astype(np.float32) + 0.5
    jl, jg, tl, tg = _both(*args, weights)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tg, jg, atol=2e-5)


def test_bf16_logits_match_jax_on_their_fp32_values():
    """bf16 logits are read as they are: the loss is JAX's on the same values
    cast to fp32, and the gradient is JAX's rounded once to bf16."""
    logits, targets, logit_len, target_len = _batch(5)
    x16 = torch.from_numpy(logits).to(torch.bfloat16)
    as32 = x16.float().numpy()
    weights = np.random.RandomState(8).rand(len(logits)).astype(np.float32) + 0.5
    jl, jg, _, _ = _both(as32, targets, logit_len, target_len, weights)
    x = x16.clone().requires_grad_(True)
    tl = ctc_loss(x, *(torch.from_numpy(a) for a in (targets, logit_len, target_len)))
    assert tl.dtype == torch.float32
    (tl * torch.from_numpy(weights)).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=1e-5, atol=1e-4)
    # one bf16 rounding (8 bits of mantissa) of the fp32 gradient
    np.testing.assert_allclose(x.grad.float().numpy(), jg, rtol=2 ** -8, atol=2e-5)


def test_long_target_takes_the_block_route_and_matches_jax():
    """U = 130 (L = 261): the route twin sends it to the block route, a
    state a thread, 288 threads; the loss and gradient there are JAX's."""
    rng = np.random.RandomState(21)
    B, T, N, U = 2, 300, 12, 130
    logits = (2.0 * rng.randn(B, T, N)).astype(np.float32)
    targets = rng.randint(0, N - 1, size=(B, U)).astype(np.int32)
    target_len = np.array([U, U - 7], np.int32)
    targets[1, U - 7:] = -1
    logit_len = np.array([T, T - 20], np.int32)
    assert K5.scan_route(2 * U + 1) == (K5.BLOCK, 288, True)
    weights = np.ones(B, np.float32)
    jl, jg, tl, tg = _both(logits, targets, logit_len, target_len, weights)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-4)
    # the posterior is exp(alpha + beta - logZ) with logZ ~ -600, whose fp32
    # ulp is 6e-5: both sides cancel it with a few ulps of their own
    np.testing.assert_allclose(tg, jg, atol=2e-4)


def test_flagship_vocabulary_matches_jax():
    """N = 9998 (the flagship's 9997 word pieces and the blank) at B = 2,
    T = 16."""
    rng = np.random.RandomState(31)
    B, T, N, U = 2, 16, 9998, 5
    logits = (2.0 * rng.randn(B, T, N)).astype(np.float32)
    targets = rng.randint(0, N - 1, size=(B, U)).astype(np.int32)
    targets[1, 3:] = -1
    weights = np.array([1.0, 0.5], np.float32)
    jl, jg, tl, tg = _both(logits, targets, np.array([16, 11], np.int32),
                           np.array([5, 3], np.int32), weights)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tg, jg, atol=2e-5)


def test_route_twins_at_their_edges():
    """The Python plans the wrappers and the tests read (their C twins are
    held to them on the card): the route and its threads, the ring's depth,
    where the wide route's work goes."""
    assert (K5.RING_DEPTH, K5.BLOCK_SCAN_MAX) == (16, 960)
    assert [K5.route(L) for L in (1, 160, 161, 959, 960, 961, 29055, 29057)] == \
        [K5.BLOCK] * 5 + [K5.WIDE] * 3
    assert [K5.block_threads(L) for L in (1, 32, 33, 161, 193, 257, 960, 961, 9001)] == \
        [32, 32, 64, 192, 224, 288, 960, 1024, 1024]
    assert K5.scan_route(141) == (K5.BLOCK, 160, True)
    assert K5.scan_route(193) == (K5.BLOCK, 224, True)
    # the wide route's double buffer, 8 bytes a state, in shared memory up to
    # L = 29,056, in a global scratch past it
    assert K5.scan_route(29055) == (K5.WIDE, 1024, True)
    assert K5.scan_route(29057) == (K5.WIDE, 1024, False)
    assert K5.WORK_BYTES_PER_STATE * 29056 <= K5._build.MAX_SMEM_BYTES \
        < K5.WORK_BYTES_PER_STATE * 29057


def test_betas_plain_match_jax_on_the_edges():
    """``ctc_betas_plain``, the oracle of K5b's beta scan, against JAX's
    ``_backward_betas`` on ``chip_smoke.py``'s ``edges`` case (a row each with
    no label, one frame, no frame, runs of one token, logit_len = T, no valid
    alignment), on the same lp: the same recursion on every frame and
    state, -1e30 where no path reaches."""
    from chip_smoke import ctc_edge_case
    from wav2letter_tpu.ops.ctc import _backward_betas, _ctc_masks, _extended_labels

    case = ctc_edge_case("edges")
    B, T, N = len(case["targets"]), case["T"], case["N"]
    logits = (2.0 * np.random.RandomState(case["seed"]).randn(B, T, N)).astype(np.float32)
    targets = case["targets"].astype(np.int32)
    logit_len, target_len = case["logit_len"].astype(np.int32), case["target_len"].astype(np.int32)
    x = torch.from_numpy(logits)
    args = K5.prepare(x, *(torch.from_numpy(a) for a in (targets, logit_len, target_len)))
    lp = K5.ctc_fwd_plain(x, *args)[3]
    got = K5.ctc_betas_plain(lp, *args, N).numpy()
    ext = _extended_labels(jnp.asarray(targets), N - 1)
    allow_skip, valid = _ctc_masks(ext, jnp.asarray(target_len))
    want = np.asarray(_backward_betas(jnp.asarray(lp.numpy()), allow_skip, valid,
                                      jnp.asarray(logit_len), jnp.asarray(target_len)))
    assert got.shape == want.shape == (T, B, 2 * targets.shape[1] + 1)
    reached = want > K5.NEG_INF / 2
    assert reached.any() and (~reached).any()
    np.testing.assert_array_equal(got > K5.NEG_INF / 2, reached)
    np.testing.assert_allclose(got[reached], want[reached], rtol=1e-5, atol=1e-4)


def test_cpu_path_is_the_plain_version_and_repeats_in_bits():
    """On the CPU ``ctc_loss`` is ``ctc_loss_plain`` (KERNELS and PLAIN give
    the same bits), and two runs give the same loss and gradient bits."""
    logits, targets, logit_len, target_len = _batch(6)
    ints = [torch.from_numpy(a) for a in (targets, logit_len, target_len)]
    runs = []
    for ops in (KERNELS, PLAIN, KERNELS):
        x = torch.from_numpy(logits).requires_grad_(True)
        loss = ctc_loss(x, *ints, ops=ops)
        loss.sum().backward()
        runs.append((loss.detach(), x.grad))
    for loss, grad in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(grad, runs[0][1])


@pytest.mark.parametrize("onorm,sqnorm", [("none", False), ("target", False),
                                          ("target", True), ("input", False),
                                          ("input", True)])
def test_criterion_scale_modes_match_jax(onorm, sqnorm):
    logits, targets, logit_len, target_len = _batch(7)
    N = logits.shape[-1]
    jcrit = JaxCTC(n_classes=N, scale_mode=jax_scale_mode(onorm, sqnorm))
    want = jcrit.apply({}, *(jnp.asarray(a) for a in (logits, targets, logit_len, target_len)))
    crit = CTCCriterion(N, get_scale_mode(onorm, sqnorm))
    got = crit(*(torch.from_numpy(a) for a in (logits, targets, logit_len, target_len)))
    assert not list(crit.parameters()) and crit.blank_idx == N - 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_make_criterion_names_the_slice_of_what_is_left():
    """Every --criterion of the JAX ``make_criterion`` builds; what it does not
    know is an error in both."""
    from wav2letter_tpu_torch.criterions import Seq2SeqCriterion, TransformerS2SCriterion

    assert isinstance(make_criterion(Config(criterion="ctc"), 5), CTCCriterion)
    s2s = make_criterion(Config(criterion="seq2seq", encoderdim=8), 5)
    tr = make_criterion(Config(criterion="transformer", encoderdim=8), 5)
    assert isinstance(s2s, Seq2SeqCriterion) and isinstance(tr, TransformerS2SCriterion)
    assert (s2s.cfg.eos_idx, s2s.cfg.pad_idx, s2s.cfg.hidden) == (3, 4, 8)
    with pytest.raises(ValueError, match="unknown criterion"):
        make_criterion(Config(criterion="cpc"), 5)
