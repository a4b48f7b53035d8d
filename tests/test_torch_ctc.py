"""The port's CTC loss and its gradient with respect to the raw logits
(``F.ctc_loss`` behind ``log_softmax``) against ``wav2letter_tpu/ops/ctc.py``
(a ``lax.scan`` with an analytic VJP) on padded batches: ``logit_len < T``,
targets padded with -1, blank last. Inputs from a numpy seed."""

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
from wav2letter_tpu_torch.ops.ctc import INFEASIBLE_LOSS, ctc_feasible, ctc_loss


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


def test_infeasible_rows_are_finite_as_in_jax():
    """More labels (with the blanks that repeats need) than frames: JAX's
    finite -1e30 makes the loss 1e30, not inf, and keeps the gradient finite;
    the port gives the same loss and a zero gradient for such a row, and the
    other rows of the batch are untouched."""
    logits, targets, logit_len, target_len = _batch(4)
    targets[2] = [1, 1, 1, 1, 1, 1]
    target_len[2], logit_len[2] = 6, 9  # needs 11 frames
    target_len[3], logit_len[3] = 6, 5
    targets[3] = [0, 1, 2, 3, 4, 5]
    weights = np.ones(len(logits), np.float32)
    jl, jg, tl, tg = _both(logits, targets, logit_len, target_len, weights)
    feasible = ctc_feasible(*(torch.from_numpy(a).long()
                              for a in (targets, logit_len, target_len))).numpy()
    assert list(feasible) == [True, True, False, False, True]
    assert np.isfinite(jl).all() and np.isfinite(jg).all()
    assert np.isfinite(tl).all() and np.isfinite(tg).all()
    np.testing.assert_allclose(tl[~feasible], jl[~feasible], rtol=1e-6)
    assert tl[2] == np.float32(INFEASIBLE_LOSS)
    assert not tg[~feasible].any()
    np.testing.assert_allclose(tl[feasible], jl[feasible], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tg[feasible], jg[feasible], atol=2e-5)


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
