"""The port's seq2seq criterions (``wav2letter_tpu_torch/criterions/
seq2seq.py``) and their runtime against the JAX package's on the CPU, in fp32.

Criterions: the same numpy-seeded encoder states, targets and lengths, and
flax's initial parameters (perturbed, so that the zero-initialized branches
carry signal) converted to the port: ``window_mask`` of every kind; the GRU
criterion over content, keyvalue and neural attention, 1-2 layers and
rounds, label smoothing and each window on and off, and the transformer
criterion at 1-2 layers: losses within 1e-5, gradients (parameters and
encoder states) within 1e-4; ``init_state``, ``decode_step`` and the greedy
tokens; the KV-cached step against the full decoder; the names, shapes and
count of both recipes' criterions at full width against ``jax.eval_shape``;
the ``seq2seq_tds`` recipe's own ``--encoderdim=1024`` with keyvalue
attention fails in both. Scheduled sampling and the decoders' dropouts draw
from the port's generator, so they are tested for their structure.

Runtime: the ``Trainer`` against JAX's from the same initial weights (first
loss 1e-4, parameters after 3 updates 5e-4, the attention window on for the
first 2), ``continue`` replaying an uninterrupted run with sampling and
dropout on, two gloo ranks against one process, and ``run_test`` on a JAX
seq2seq checkpoint: the same hypotheses and WER."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import _launch, _wait
from tests.test_torch_slice import _dataset
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.criterions import seq2seq as J
from wav2letter_tpu.criterions.base import CriterionScaleMode as JaxMode
from wav2letter_tpu.models.arch import build_arch_module as jax_build
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu.runtime.test import run_test as jax_run_test
from wav2letter_tpu.runtime.train import Trainer as JaxTrainer
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.criterions import make_criterion
from wav2letter_tpu_torch.criterions import seq2seq as P
from wav2letter_tpu_torch.criterions.base import CriterionScaleMode
from wav2letter_tpu_torch.runtime.checkpoint import (convert_jax_params, jax_param_name,
                                                     load_checkpoint, params_to_jax_tree)
from wav2letter_tpu_torch.runtime.test import run_test
from wav2letter_tpu_torch.runtime.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 9  # 7 tokens, then eos and pad
NFEAT = 16
N_DATA = 7  # the runtime data's tokens: "|", a, b, c, d, then eos and pad

# (kind, hidden, S2SConfig fields, transformer layers)
CASES = {
    "gru_content": ("gru", 16, dict(attention="content"), 0),
    "gru_keyvalue_soft": ("gru", 8, dict(attention="keyvalue", attn_window="softPretrain",
                                         softw_std=2.0, softw_offset=2.0, softw_rate=1.5), 0),
    "gru_neural_2x2_median": ("gru", 16, dict(attention="neural", n_layers=2, n_rounds=2,
                                              label_smooth=0.1, attn_window="median",
                                              window_left=2, window_right=2), 0),
    "gru_step_smooth": ("gru", 16, dict(attention="content", attn_window="step",
                                        softw_offset=3.0, softw_rate=2.0,
                                        label_smooth=0.05), 0),
    "transformer_1": ("tr", 16, dict(), 1),
    "transformer_2_step": ("tr", 16, dict(label_smooth=0.05, attn_window="step",
                                          softw_offset=3.0, softw_rate=2.0), 2),
    "transformer_2_soft": ("tr", 16, dict(attn_window="soft", softw_std=3.0), 2),
    # encoder states wider than --encoderdim: flax sizes ck/cv from them
    "transformer_2_wide": ("tr", 16, dict(), 2),
}
WIDE = {"transformer_2_wide": 24}


def _batch(seed, B=3, T=12, H=16, U=5):
    """Encoder states, targets (-1 padded) and ragged lengths; row 1 at U."""
    rng = np.random.RandomState(seed)
    em = rng.randn(B, T, H).astype(np.float32)
    elen = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    elen[0] = T
    tlen = rng.randint(1, U + 1, size=B).astype(np.int32)
    tlen[1] = U
    tg = np.full((B, U), -1, np.int32)
    for i in range(B):
        tg[i, : tlen[i]] = rng.randint(0, N - 2, size=tlen[i])
    return em, tg, elen, tlen


def _pair(name, max_len=7, mode="target", seed=1):
    """(JAX criterion, its perturbed params, the port's criterion loaded with
    them, encoder width)."""
    kind, H, kw, layers = CASES[name]
    fields = dict(n_classes=N, eos_idx=N - 2, pad_idx=N - 1, hidden=H,
                  max_decoder_output_len=max_len, **kw)
    jm, pm = ((JaxMode.TARGET_SZ, CriterionScaleMode.TARGET_SZ) if mode == "target"
              else (JaxMode.NONE, CriterionScaleMode.NONE))
    if kind == "gru":
        jc = J.Seq2SeqCriterion(J.S2SConfig(**fields), jm)
        tc = P.Seq2SeqCriterion(P.S2SConfig(**fields), pm)
    else:
        jc = J.TransformerS2SCriterion(J.S2SConfig(**fields), jm, n_tr_layers=layers)
        tc = P.TransformerS2SCriterion(P.S2SConfig(**fields), pm, n_tr_layers=layers,
                                       enc_dim=WIDE.get(name, 0))
    E = WIDE.get(name) or (2 * H if kw.get("attention") == "keyvalue" else H)
    em, tg, elen, tlen = _batch(0, H=E)
    params = jc.init(jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in (em, tg, elen, tlen)))
    leaves, tdef = jax.tree.flatten(params["params"])
    keys = jax.random.split(jax.random.PRNGKey(seed + 10), len(leaves))
    params = jax.tree.unflatten(tdef, [x + 0.1 * jax.random.normal(k, x.shape)
                                       for x, k in zip(leaves, keys)])
    tc.load_state_dict(convert_jax_params(jax.device_get(params)), strict=True)
    return jc, params, tc, E


@pytest.mark.parametrize("kind", ["median", "step", "soft", "softPretrain", "no"])
def test_window_mask_matches_jax(kind):
    fields = dict(n_classes=N, eos_idx=7, pad_idx=8, window_left=3, window_right=2,
                  softw_offset=4.0, softw_rate=2.5, softw_std=3.0)
    jc, pc = J.S2SConfig(**fields), P.S2SConfig(**fields)
    peak = np.asarray([0, 5, 17, 30], np.int32)
    for step in (0, 3, 11):
        want = J.window_mask(kind, step, 32, jnp.asarray(peak), jc)
        got = P.window_mask(kind, step, 32, torch.from_numpy(peak), pc)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.asarray(want),
                                                                   got.shape))
    # the transformer's per-step table, (U, 1) steps
    steps = np.arange(6)[:, None]
    want = J.window_mask(kind, jnp.asarray(steps), 32, jnp.zeros(1, jnp.int32), jc)
    got = P.window_mask(kind, torch.from_numpy(steps), 32, torch.zeros(1, dtype=torch.int32),
                        pc)
    if kind in ("step", "soft", "softPretrain"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,window", [
    (name, window) for name in CASES for window in (False, True)
    if ("attn_window" in CASES[name][2]) == window
    or name in ("gru_keyvalue_soft", "gru_neural_2x2_median")])
def test_criterion_matches_jax(name, window):
    jc, params, tc, E = _pair(name)
    em, tg, elen, tlen = _batch(0, H=E)
    jargs = [jnp.asarray(a) for a in (em, tg, elen, tlen)]
    w = np.asarray([1.0, 0.5, 2.0], np.float32)

    def lf(p, e):
        losses = jc.apply({"params": p}, e, *jargs[1:], train=True, window=window)
        return jnp.sum(losses * w), losses

    (_, want), (gp, ge) = jax.value_and_grad(lf, argnums=(0, 1), has_aux=True)(
        params, jargs[0])
    want = np.asarray(want)
    e = torch.from_numpy(em).requires_grad_(True)
    got = tc(e, *(torch.from_numpy(a) for a in (tg, elen, tlen)), train=True, window=window)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), rtol=1e-4, atol=1e-5)
    grads = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax_tree({n: p.grad for n, p in tc.named_parameters()})))
    want_g = jax.tree_util.tree_leaves_with_path(gp)
    assert len(grads) == len(want_g)
    for path, g in want_g:
        np.testing.assert_allclose(grads[path], np.asarray(g), rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    if window and CASES[name][2].get("attn_window", "no") != "no":
        # the window changes the loss, and only in training
        plain = tc(e.detach(), *(torch.from_numpy(a) for a in (tg, elen, tlen)), train=True)
        assert not np.allclose(plain.detach().numpy(), got.detach().numpy())
        evald = tc(e.detach(), *(torch.from_numpy(a) for a in (tg, elen, tlen)),
                   train=False, window=True)
        np.testing.assert_array_equal(evald.detach().numpy(), plain.detach().numpy())


def _leaves(state):
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    hid, peak = state
    return list(hid) + [peak]


@pytest.mark.parametrize("name", ["gru_keyvalue_soft", "gru_neural_2x2_median",
                                  "transformer_2_step", "transformer_2_wide"])
def test_decode_step_and_greedy_match_jax(name):
    jc, params, tc, E = _pair(name, max_len=9, mode="none")
    em, _, elen, _ = _batch(3, H=E)
    B, T = em.shape[:2]
    jmask = jnp.arange(T)[None, :] < jnp.asarray(elen)[:, None]
    jstate = jc.apply({"params": params}, B, method="init_state")
    with torch.no_grad():
        pstate = tc.init_state(B)
        for a, b in zip(_leaves(jstate), _leaves(pstate)):
            assert tuple(a.shape) == tuple(b.shape) and not np.asarray(a).any() \
                and not b.any()
        toks = np.asarray([7, 2, 5], np.int32)
        for u in range(3):  # three steps on the carried state
            jstate, jl = jc.apply({"params": params}, jstate, jnp.asarray(toks), jnp.asarray(em),
                                  jmask, u, method="decode_step")
            pstate, pl = tc.decode_step(pstate, torch.from_numpy(toks), torch.from_numpy(em),
                                        torch.from_numpy(np.asarray(jmask)), u)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
            for a, b in zip(_leaves(jstate), _leaves(pstate)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
            toks = np.asarray(jl).argmax(-1).astype(np.int32)
        jt, jlen = jc.apply({"params": params}, jnp.asarray(em), jnp.asarray(elen),
                            method="greedy_path")
        pt, plen = tc.greedy_path(torch.from_numpy(em), torch.from_numpy(elen))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))


def test_greedy_stops_early_with_the_fixed_length_tokens():
    """Every row emits eos at once (the eos logit raised): the loop stops at
    its first check and the tokens are JAX's fixed-length scan's."""
    jc, params, tc, E = _pair("gru_content", max_len=40, mode="none")
    params = jax.tree.map(lambda x: x, params)
    params["out"]["bias"] = params["out"]["bias"].at[N - 2].set(50.0)
    with torch.no_grad():
        tc.out.bias[N - 2] = 50.0
    em, _, elen, _ = _batch(4, H=E)
    calls = []
    step = tc.decode_step
    tc.decode_step = lambda *a, **k: (calls.append(1), step(*a, **k))[1]
    with torch.no_grad():
        pt, plen = tc.greedy_path(torch.from_numpy(em), torch.from_numpy(elen))
    jt, jlen = jc.apply({"params": params}, jnp.asarray(em), jnp.asarray(elen),
                        method="greedy_path")
    assert len(calls) == 8 and pt.shape == (3, 40)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))


def test_kv_cache_equals_the_full_decoder():
    _, _, tc, E = _pair("transformer_2_step", max_len=8)
    em, tg, elen, _ = _batch(5, H=E)
    B, T = em.shape[:2]
    enc = torch.from_numpy(em)
    mask = torch.arange(T)[None, :] < torch.from_numpy(elen)[:, None]
    dec_in = torch.cat([torch.full((B, 1), N - 2), torch.from_numpy(tg).clamp(min=0)], 1)
    with torch.no_grad():
        full = tc._decode_all(dec_in, enc, mask)
        state = tc.init_state(B)
        steps = []
        for u in range(dec_in.shape[1]):
            state, lg = tc.decode_step(state, dec_in[:, u], enc, mask, u)
            steps.append(lg)
    assert state["pos"].tolist() == [dec_in.shape[1]] * B
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)


def _recipe_cfg(recipe, **kw):
    cfg = Config.from_sources(argv=[f"--flagsfile={REPO}/recipes/{recipe}/train.cfg"])
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("recipe,kw", [("seq2seq_tds", dict(encoderdim=512)),
                                       ("transformer_s2s", {})])
def test_full_width_criterions_have_jax_names_and_shapes(recipe, kw):
    """The recipes' criterions at full width (10,000 word pieces, eos, pad)."""
    from wav2letter_tpu.criterions import make_criterion as jax_make

    n = 10002
    cfg = _recipe_cfg(recipe, **kw)
    jcfg = JaxConfig()
    jcfg.update(cfg.asdict())
    jc = jax_make(jcfg, n)
    E = 2 * cfg.encoderdim if cfg.attention == "keyvalue" and recipe == "seq2seq_tds" \
        else cfg.encoderdim
    shapes = jax.eval_shape(lambda: jc.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, E)), jnp.zeros((2, 4), jnp.int32),
        jnp.full((2,), 16, jnp.int32), jnp.full((2,), 4, jnp.int32)))["params"]
    want = {jax.tree_util.keystr(p): tuple(s.shape)
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    tc = make_criterion(cfg, n)
    got = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
           jax.tree_util.tree_leaves_with_path(params_to_jax_tree(tc.state_dict()))}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == sum(np.prod(s) for s in want.values())
    assert type(tc).__name__ == type(jc).__name__


def test_recipe_encoderdim_with_keyvalue_fails_in_both():
    """``recipes/seq2seq_tds/train.cfg`` as it stands: keyvalue attention
    splits the arch's 1024 channels into keys of 512 against a query of
    --encoderdim = 1024. Neither package computes anything from it."""
    from wav2letter_tpu.criterions import make_criterion as jax_make

    cfg = _recipe_cfg("seq2seq_tds")
    assert (cfg.encoderdim, cfg.attention) == (1024, "keyvalue")
    jcfg = JaxConfig()
    jcfg.update(cfg.asdict())
    args = (np.zeros((1, 8, 1024), np.float32), np.zeros((1, 3), np.int32),
            np.asarray([8], np.int32), np.asarray([3], np.int32))
    with pytest.raises(ValueError):
        jax.eval_shape(lambda: jax_make(jcfg, 12).init(
            jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args)))
    with pytest.raises(ValueError, match="2 x --encoderdim"):
        make_criterion(cfg, 12)(*(torch.from_numpy(a) for a in args))


def test_scheduled_sampling_and_dropout_draw_by_their_rules():
    jc, params, tc, E = _pair("gru_content")
    em, tg, elen, tlen = (torch.from_numpy(a) for a in _batch(0, H=E))
    with torch.no_grad():
        forced = tc(em, tg, elen, tlen, train=True)
        # --pctteacherforcing=0 with the model's own argmax: the loss of a
        # loop that feeds each step's argmax to the next
        model = P.Seq2SeqCriterion(dataclasses.replace(tc.cfg, pct_teacher_forcing=0.0,
                                                       sampling_strategy="model"),
                                   tc.scale_mode)
        model.load_state_dict(tc.state_dict())
        got = model(em, tg, elen, tlen, train=True)
        mask = torch.arange(em.shape[1])[None, :] < elen[:, None]
        state, prev, ys = tc.init_state(3), torch.full((3,), N - 2), []
        for u in range(tg.shape[1] + 1):
            state, lg = tc.decode_step(state, prev, em, mask, u)
            ys.append(lg)
            prev = lg.argmax(-1)
        tgt_in = torch.where(tg < 0, torch.full_like(tg, N - 1), tg).long()
        want = P._nll(tc.cfg, tc.scale_mode, torch.stack(ys, 1), tgt_in, tlen, elen)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert not torch.allclose(got, forced)
        # eval never samples; random tokens and gumbel draws follow the seed
        assert torch.equal(model(em, tg, elen, tlen, train=False), forced)
        for strategy in ("rand", "gumbel"):
            crit = P.Seq2SeqCriterion(dataclasses.replace(
                tc.cfg, pct_teacher_forcing=0.0, sampling_strategy=strategy,
                gumbel_temperature=0.5), tc.scale_mode)
            crit.load_state_dict(tc.state_dict())
            draws = []
            for seed in (1, 1, 2):
                torch.manual_seed(seed)
                draws.append(crit(em, tg, elen, tlen, train=True))
            assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
            assert torch.isfinite(draws[0]).all()
        # --decoderdropout acts in training only
        drop = P.Seq2SeqCriterion(dataclasses.replace(tc.cfg, dropout=0.5), tc.scale_mode)
        drop.load_state_dict(tc.state_dict())
        assert torch.equal(drop(em, tg, elen, tlen, train=False), tc(em, tg, elen, tlen,
                                                                    train=False))
        assert not torch.allclose(drop(em, tg, elen, tlen, train=True), forced)


def test_transformer_dropout_and_layerdrop_act_in_training_only():
    _, _, tc, E = _pair("transformer_2_step")
    em, tg, elen, tlen = (torch.from_numpy(a) for a in _batch(0, H=E))
    noisy = P.TransformerS2SCriterion(tc.cfg, tc.scale_mode, n_tr_layers=2, tr_dropout=0.5,
                                      tr_layerdrop=0.5)
    noisy.load_state_dict(tc.state_dict())
    with torch.no_grad():
        assert torch.equal(noisy(em, tg, elen, tlen, train=False),
                           tc(em, tg, elen, tlen, train=False))
        torch.manual_seed(3)
        a = noisy(em, tg, elen, tlen, train=True)
        torch.manual_seed(3)
        b = noisy(em, tg, elen, tlen, train=True)
        torch.manual_seed(4)
        c = noisy(em, tg, elen, tlen, train=True)
    assert torch.equal(a, b) and not torch.equal(a, c)


ENCODER_PARAMS = {"seq2seq_tds": (1024, 36_501_656), "transformer_s2s": (512, 90_375_728)}


@pytest.mark.parametrize("recipe", sorted(ENCODER_PARAMS))
def test_full_width_encoders_have_jax_names_and_shapes(recipe):
    """Each recipe's own ``network.arch`` as a seq2seq encoder (not forced to
    the class count), on the meta device, against ``jax.eval_shape``."""
    from wav2letter_tpu.models.arch import build_arch_module as jax_file_build
    from wav2letter_tpu_torch.models import build_arch_module

    out_dim, n_params = ENCODER_PARAMS[recipe]
    path = os.path.join(REPO, "recipes", recipe, "network.arch")
    jmodel = jax_file_build(path, 80, 512, force_label_dim=False)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 80)),
        jnp.asarray([64], jnp.int32)))["params"]
    want = {"/".join(k.key for k in p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        model = build_arch_module(path, 80, 512, force_label_dim=False)
    got = {jax_param_name(k): tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want and sum(np.prod(s) for s in got.values()) == n_params
    last = [v for k, v in model.state_dict().items() if k.endswith("weight") and v.dim() == 2]
    assert last[-1].shape[1] == out_dim  # the encoder states' width


def test_tds_with_layernorm_over_time_matches_jax(tmp_path):
    """``recipes/seq2seq_tds``'s TDS blocks normalize over each sample's
    frames and channels (the arch's default ``lnorm_include_time``): a narrow
    copy's encoder states and every gradient against JAX's non-fused path."""
    from wav2letter_tpu.models.arch import build_arch_module as jax_file_build
    from wav2letter_tpu_torch.models import build_arch_module

    # the recipe's first two stages, one TDS block each, at 16 banks
    arch = str(tmp_path / "seq2seq_tds_narrow.arch")
    with open(arch, "w") as f:
        f.write("""V -1 NFEAT 1 0
SAUG 16 27 2 100 1.0 2
PD 0 4 5
C2 1 10 11 1 2 1 0 0
R
DO 0.2
LN 1 2
TDS 10 9 16 0.2
PD 0 4 5
C2 10 14 11 1 2 1 0 0
R
DO 0.2
LN 1 2
TDS 14 9 16 0.2
RO 2 1 0 3
V 224 -1 1 0
L 224 32
V 32 0 -1 1
""")
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 90, NFEAT).astype(np.float32)
    flen = np.asarray([90, 71], np.int32)
    jmodel = jax_file_build(arch, NFEAT, 16, force_label_dim=False)
    variables = jmodel.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(feats[:1]),
                            jnp.asarray(flen[:1]))
    model = build_arch_module(arch, NFEAT, 16, force_label_dim=False).eval()
    model.load_state_dict(convert_jax_params(jax.device_get(variables["params"])), strict=True)
    em, elen = jax.jit(jmodel.apply)(variables, jnp.asarray(feats), jnp.asarray(flen))
    r = rng.randn(*em.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.apply(
        {"params": p}, jnp.asarray(feats), jnp.asarray(flen))[0] * r)))(variables["params"])
    out, olen = model(torch.from_numpy(feats), torch.from_numpy(flen))
    assert out.shape == em.shape and em.shape[-1] == 32
    np.testing.assert_array_equal(olen.numpy(), np.asarray(elen))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(em), rtol=1e-4, atol=1e-4)
    (out * torch.from_numpy(r)).sum().backward()
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax_tree({k: p.grad for k, p in model.named_parameters()})))
    for p, w in jax.tree_util.tree_leaves_with_path(want):
        w = np.asarray(w)
        np.testing.assert_allclose(got[p], w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(p))


# ---------------------------------------------------------------------------
# the runtime: Trainer, continue, two ranks, run_test
# ---------------------------------------------------------------------------
# narrow copies of the recipes' encoders: seq2seq_tds's C2 + TDS stage (its
# LayerNorms over time, the arch's default) ending in L and V to 2 x
# --encoderdim (keyvalue), and transformer_s2s's
# weight-normed conv, GLU and pool ahead of one TR layer and L to --encoderdim
S2S_ARCHS = {
    "seq2seq": f"""V -1 NFEAT 1 0
PD 0 5 3
C2 1 3 10 1 2 1 0 0
R
LN 1 2
TDS 3 9 NFEAT 0
RO 2 1 0 3
V {3 * NFEAT} -1 1 0
L {3 * NFEAT} 16
V 16 0 -1 1
""",
    "transformer": """V -1 1 NFEAT 0
WN 3 C NFEAT 16 3 1 -1
GLU 2
M 1 1 2 1
RO 2 0 3 1
TR 8 16 2 40 0 0
L 8 8
""",
    # states of 12 channels for --encoderdim=8: flax sizes the decoder's
    # cross-attention keys and values from them
    "transformer_wide": """V -1 1 NFEAT 0
WN 3 C NFEAT 16 3 1 -1
GLU 2
M 1 1 2 1
RO 2 0 3 1
TR 8 16 2 40 0 0
L 8 12
""",
}


@pytest.fixture(scope="module")
def s2s_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("s2s"))
    lst, tokens, lexicon = _dataset(os.path.join(root, "data"), n_utts=12, seed=17)
    archs = {}
    for name, text in S2S_ARCHS.items():
        archs[name] = os.path.join(root, f"{name}.arch")
        with open(archs[name], "w") as f:
            f.write(text)
    return root, lst, tokens, lexicon, archs


def s2s_flags(data, criterion, rundir, **kw):
    """The recipes' criterion flags at the tests' size: seq2seq_tds's
    (keyvalue, softPretrain window for 2 updates, label smoothing, sgd with
    --lrcrit) or transformer_s2s's (adagrad, --trainWithWindow), teacher
    forcing whole and no dropout unless asked."""
    root, lst, tokens, lexicon, archs = data
    flags = dict(train=lst, tokens=tokens, lexicon=lexicon, rundir=rundir, runname="run",
                 arch=archs[criterion], criterion=criterion, eostoken=True, mfsc=True,
                 filterbanks=NFEAT, batchsize=4, maxgradnorm=1.0, iter=3, reportiters=0,
                 nthread=1, pad_multiple=16, compute_dtype="float32", onorm="target",
                 seed=3, maxdecoderoutputlen=8, labelsmooth=0.05, attnWindow="softPretrain",
                 softwstd=4.0, pretrainWindow=2)
    if criterion == "seq2seq":
        flags.update(encoderdim=8, attention="keyvalue", netoptim="sgd", critoptim="sgd",
                     lr=0.2, lrcrit=0.1, momentum=0.9)
    else:
        flags.update(encoderdim=8, am_decoder_tr_layers=2, trainWithWindow=True,
                     netoptim="adagrad", critoptim="adagrad", lr=0.05, lrcrit=0.05,
                     sqnorm=True)
    flags.update(kw)
    return flags


def _record_losses(trainer):
    losses, orig = [], trainer.meters.train.loss.add
    trainer.meters.train.loss.add = lambda v, n=1: (losses.append(float(v)), orig(v, n))
    return losses


@pytest.mark.parametrize("criterion", ["seq2seq", "transformer"])
def test_trainer_matches_jax(s2s_data, tmp_path, criterion):
    flags = s2s_flags(s2s_data, criterion, str(tmp_path / "jax"))
    jcfg = JaxConfig()
    jcfg.update(dict(flags, features_device="tpu"))
    jtr = JaxTrainer(jcfg)
    jtr.save()  # update 0, as a W2LTPU01 file
    init = str(tmp_path / "init.bin")
    shutil.copy(str(tmp_path / "jax" / "run" / "model_last.bin"), init)
    jwin = []
    jgate = jtr._window_active
    jtr._window_active = lambda: (jwin.append(jgate()), jwin[-1])[1]
    jlosses = _record_losses(jtr)
    jtr.run()
    cfg = Config()
    cfg.update(dict(flags, rundir=str(tmp_path / "torch")))
    tr = Trainer(cfg, mode="fork", init_model_path=init, device="cpu")
    wins = []
    gate = tr._window_active
    tr._window_active = lambda: (wins.append((tr.updates, gate())), wins[-1][1])[1]
    tlosses = _record_losses(tr)
    tr.run()
    assert tr.updates == jtr.updates == 3 and len(tlosses) == len(jlosses) == 3
    assert tlosses[0] == pytest.approx(jlosses[0], rel=1e-4)
    assert tlosses == pytest.approx(jlosses, rel=1e-3)
    on = [w for u, w in wins if u == 0]
    assert on and all(on) and (criterion == "transformer") == all(w for _, w in wins)
    for got_sd, want in ((tr.model.state_dict(), jtr.model_params),
                         (tr.criterion.state_dict(), jtr.crit_params)):
        got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax_tree(got_sd)))
        leaves = jax.tree_util.tree_leaves_with_path(jax.device_get(want))
        assert len(leaves) == len(got)
        for path, w in leaves:
            np.testing.assert_allclose(got[path], np.asarray(w), atol=5e-4,
                                       err_msg=jax.tree_util.keystr(path))


def test_continue_replays_the_uninterrupted_run(s2s_data, tmp_path):
    """Scheduled sampling, sampled targets and the decoder's dropout on:
    4 updates equal 2 and ``continue`` 2, bit for bit."""
    noisy = dict(pctteacherforcing=80, sampletarget=0.3, decoderdropout=0.2,
                 samplingstrategy="model")
    cfg = Config()
    cfg.update(s2s_flags(s2s_data, "seq2seq", str(tmp_path / "one"), iter=4, **noisy))
    one = Trainer(cfg, device="cpu")
    one.run()
    cfg = Config()
    cfg.update(s2s_flags(s2s_data, "seq2seq", str(tmp_path / "two"), iter=2, **noisy))
    Trainer(cfg, device="cpu").run()
    two = Trainer(Config.from_sources(argv=[f"--rundir={tmp_path / 'two'}", "--runname=run",
                                            "--iter=4"]), mode="continue", device="cpu")
    assert two.updates == 2 and two.cfg.criterion == "seq2seq"
    two.run()
    for a, b in ((one.model, two.model), (one.criterion, two.criterion)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k


def test_two_ranks_equal_one_process(s2s_data, tmp_path):
    """The criterion's gradients join the data axis's flat all-reduce: the
    replicas stay equal in bits and equal one process at twice the rows."""
    root = str(tmp_path)
    flags = s2s_flags(s2s_data, "seq2seq", os.path.join(root, "dp"), batchsize=2)
    _wait(_launch(root, "s2s", 2, [dict(flags=flags, out=os.path.join(root, "out"))]))
    r0, r1 = (torch.load(os.path.join(root, "out", f"rank{r}.pt")) for r in range(2))
    cfg = Config()
    cfg.update(dict(flags, batchsize=4, rundir=os.path.join(root, "one")))
    one = Trainer(cfg, device="cpu")
    losses = _record_losses(one)
    one.run()
    assert r0["updates"] == r1["updates"] == one.updates == 3
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4, atol=1e-5)
    for key, mod in (("params", one.model), ("crit_params", one.criterion)):
        for k, v in mod.state_dict().items():
            assert torch.equal(r0[key][k], r1[key][k]), k
            np.testing.assert_allclose(r0[key][k].numpy(), v.numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=k)


def s2s_jax_checkpoint(data, criterion, path, seed=5, **kw):
    """A W2LTPU01 file of the narrow arch and criterion at JAX's init, the
    criterion perturbed; and its flags (``kw`` over ``s2s_flags``')."""
    from wav2letter_tpu.criterions import make_criterion as jax_make

    flags = s2s_flags(data, criterion, "", **kw)
    jcfg = JaxConfig(**flags)
    model = jax_build(flags["arch"], NFEAT, flags["encoderdim"], force_label_dim=False)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                                    jnp.zeros((1, 64, NFEAT)), jnp.asarray([64]))
    em, elen = model.apply(variables, jnp.zeros((2, 64, NFEAT)), jnp.asarray([64, 64]))
    crit = jax_make(jcfg, N_DATA)
    cp = crit.init(jax.random.PRNGKey(seed + 1), em, jnp.zeros((2, 3), jnp.int32), elen,
                   jnp.asarray([3, 3]))["params"]
    leaves, tdef = jax.tree.flatten(cp)
    keys = jax.random.split(jax.random.PRNGKey(seed + 2), len(leaves))
    cp = jax.tree.unflatten(tdef, [x + 0.3 * jax.random.normal(k, x.shape)
                                   for x, k in zip(leaves, keys)])
    jax_save(path, JaxCheckpoint(
        config=jcfg.serialize(), epoch=1, updates=10, model_params=variables["params"],
        model_state={}, crit_params=cp, opt_state={}, crit_opt_state={}, extra={}))
    return flags


@pytest.mark.parametrize("criterion", ["seq2seq", "transformer", "transformer_wide"])
def test_run_test_on_a_jax_checkpoint_matches_jax(s2s_data, tmp_path, criterion):
    am = str(tmp_path / "am.bin")
    kw = dict(arch=s2s_data[4][criterion]) if criterion == "transformer_wide" else {}
    flags = s2s_jax_checkpoint(s2s_data, criterion.split("_")[0], am, **kw)
    ckpt = load_checkpoint(am)
    assert set(ckpt.crit_state_dict) == set(make_criterion(Config(**flags), N_DATA)
                                            .state_dict())
    out = {}
    for side in ("jax", "torch"):
        cfg = JaxConfig() if side == "jax" else Config()
        cfg.update(dict(am=am, test=s2s_data[1], batchsize=12,
                        sclite=str(tmp_path / side)))
        out[side] = jax_run_test(cfg) if side == "jax" else run_test(cfg, device="cpu")
    base = os.path.basename(s2s_data[1])
    with open(tmp_path / "jax" / (base + ".hyp")) as f:
        want = f.read()
    with open(tmp_path / "torch" / (base + ".hyp")) as f:
        assert f.read() == want
    assert (out["torch"]["WER"], out["torch"]["TER"]) == (out["jax"]["WER"], out["jax"]["TER"])
    assert out["torch"]["loss"] == pytest.approx(out["jax"]["loss"], rel=1e-3)
