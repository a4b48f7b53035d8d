"""The semi-supervised slice of the PyTorch port against the JAX package, on
the CPU in fp32: ``data/scheduler.py``, ``tools/pseudo_label.py``,
``runtime/train_slimipl.py`` (the decisions of the four cache types, the PLs,
the soft loss, the EMA, ``--slimIPL_dyn_dropout``, ``--slimIPL_saug``,
``continue``), ``runtime/train_lpm.py`` (the proposals, their LM weights, the
refresh, two updates' losses), ``runtime/ipl.py`` (the PLs by viterbi and by
the beam with an LM; the loop and its resume) and ``runtime/profiling.py``.
JAX's IPL loop itself is not run (its own test is marked slow); its parts are.
Dropout and SpecAugment are off wherever two steps are compared."""

import dataclasses
import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from tests.util_synth import make_dataset
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu_torch.config import Config

ARCH = "V -1 1 NFEAT 0\nC NFEAT 16 8 4 4\nGLU 2\nDO 0.0\nRO 2 0 3 1\nL 8 NLABEL\n"
S2S_ARCH = "V -1 1 NFEAT 0\nC NFEAT 16 8 4 4\nGLU 2\nRO 2 0 3 1\nL 8 16\n"
SLIM = dict(slimIPL_start=2, slimIPL_sup_updates=1, slimIPL_unsup_updates=2,
            slimIPL_fixed_cache_updates=2, slimIPL_fixed_cache_update_prob=0.5,
            slimIPL_ema=True, slimIPL_ema_decay=0.9, slimIPL_saug=True)
# a word 2-gram over the synthetic letters-as-words
ARPA = """\\data\\
ngram 1=7
ngram 2=4

\\1-grams:
-1.0\t<s>\t-0.3
-0.7\t</s>
-2.0\t<unk>
-0.6\ta\t-0.2
-0.6\tb\t-0.2
-0.8\tc\t-0.2
-0.9\td\t-0.2

\\2-grams:
-0.2\ta b
-0.3\tb c
-0.4\tc d
-0.5\t<s> a

\\end\\
"""



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The port's CPU work on two threads: the suite's workers share the
    machine, and torch's default of a thread a core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("semi")
    lst, tokens, lexicon = make_dataset(str(root), n_utts=12, seed=31)
    unsup = root / "unsup.lst"
    with open(lst) as f, open(unsup, "w") as g:
        for line in f:
            p = line.split(None, 3)
            g.write(f"u_{p[0]} {p[1]} {p[2]}\n")
    (root / "a.arch").write_text(ARCH)
    (root / "s2s.arch").write_text(S2S_ARCH)
    (root / "lm.arpa").write_text(ARPA)
    return dict(root=root, lst=lst, unsup=str(unsup), tokens=tokens, lexicon=lexicon)


def _flags(data, rundir, **kw):
    d = dict(train=data["lst"], train2=data["unsup"], tokens=data["tokens"],
             lexicon=data["lexicon"], rundir=str(rundir), runname="run", batchsize=4,
             mfsc=True, filterbanks=16, criterion="ctc", lr=0.3, netoptim="sgd",
             maxgradnorm=1.0, iter=12, reportiters=0, nthread=1, pad_multiple=16,
             compute_dtype="float32", arch=str(data["root"] / "a.arch"), onorm="target",
             mintsz=0, seed=5, saug_start_update=1000, saug_fmaskn=1, saug_tmaskn=2,
             saug_fmaskf=4, saug_tmaskt=4)
    d.update(kw)
    return d


def _jcfg(data, rundir, **kw):
    c = JaxConfig()
    c.update(_flags(data, rundir, **kw))
    return c


def _cfg(data, rundir, **kw):
    c = Config()
    c.update(_flags(data, rundir, **kw))
    return c


# ---------------------------------------------------------------------------
# the scheduler and the pseudo-label tools
# ---------------------------------------------------------------------------
def test_data_scheduler_matches_jax(data):
    from wav2letter_tpu.data import AsrDataset as JaxDataset
    from wav2letter_tpu.data import make_token_dict as jax_tokens
    from wav2letter_tpu.data.scheduler import DataScheduler as JaxScheduler
    from wav2letter_tpu_torch.data import AsrDataset, make_token_dict
    from wav2letter_tpu_torch.data.scheduler import DataScheduler

    jc, c = _jcfg(data, ""), _cfg(data, "")
    jd, d = jax_tokens(data["tokens"], "ctc"), make_token_dict(data["tokens"], "ctc")
    jds = [JaxDataset(data["lst"], jd, None, jc),
           JaxDataset(data["unsup"], jd, None, jc, allow_empty_targets=True, batch_size=3)]
    ds = [AsrDataset(data["lst"], d, None, c),
          AsrDataset(data["unsup"], d, None, c, allow_empty_targets=True, batch_size=3)]
    for iters in ([1, 2], [3, 0]):
        js, s = JaxScheduler(jds, iters, seed=3), DataScheduler(ds, iters, seed=3)
        for (ji, jb), (i, b), _ in zip(js, s, range(14)):
            assert i == ji
            assert np.array_equal(b["sample_idx"], jb["sample_idx"])
            assert np.array_equal(b["target"], jb["target"])
            assert np.array_equal(b["audio"], jb["audio"])
        js.set_iterations([0, 2])
        s.set_iterations([0, 2])
        for (ji, jb), (i, b), _ in zip(js, s, range(3)):
            assert i == ji == 1 and np.array_equal(b["sample_idx"], jb["sample_idx"])


def test_pseudo_label_tools_match_jax(data, tmp_path):
    from wav2letter_tpu.tools import pseudo_label as J
    from wav2letter_tpu_torch.tools import pseudo_label as P

    rs = np.random.RandomState(4)
    sids = [l.split()[0] for l in open(data["unsup"])]
    hyps = []
    for k, sid in enumerate(sids):
        words = [["a", "b", "zz"], ["a", "a", "a", "a", "a", "a"], [], ["c", "qq", "d"]][k % 4]
        hyps.append((sid, words, float(rs.randn()), k % 5 != 3))
    for cfg in (dict(), dict(score_quantile=0.4, max_ngram_repeats=1, ngram_order=2),
                dict(drop_no_eos=False, min_words=2, max_words=3)):
        want = J.filter_pseudo_labels(hyps, J.PLFilterConfig(**cfg))
        got = P.filter_pseudo_labels(hyps, P.PLFilterConfig(**cfg))
        assert got == want
    labels = {sid: w for sid, w, _ in want}
    for mod, name in ((J, "jax"), (P, "torch")):
        assert mod.write_pseudo_labeled_list(data["unsup"], labels, str(tmp_path / f"{name}.lst")) \
            == len([w for w in labels.values() if w])
        new = sorted({w for ws in labels.values() for w in ws})
        assert mod.merge_synthetic_lexicon(data["lexicon"], new, str(tmp_path / f"{name}.lex"),
                                           "|") == 2
    for ext in ("lst", "lex"):
        assert (tmp_path / f"torch.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    assert P.analyze_dataset(data["lst"]) == J.analyze_dataset(data["lst"])
    assert P.has_excessive_repeats(list("abab" * 3), 2, 2)


# ---------------------------------------------------------------------------
# slimIPL
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def slim(data, tmp_path_factory):
    """One JAX ``SlimIPLTrainer`` for the module (its set-up compiles op by
    op, ~10 s), with the EMA and the strong SpecAugment, and its initial
    weights as a ``W2LTPU01`` file."""
    from wav2letter_tpu.runtime.train_slimipl import SlimIPLTrainer as JaxSlim

    root = tmp_path_factory.mktemp("jax_slim")
    jtr = JaxSlim(_jcfg(data, root), ipl_flags=dict(SLIM))
    jtr.save()
    init = str(root / "init.bin")
    os.replace(root / "run" / "model_last.bin", init)
    return jtr, init


def _reset(tr, typ, soft):
    tr.fl.update(slimIPL_type=typ, slimIPL_use_soft=soft)
    tr.cache, tr.soft_cache, tr.fixed_cache = {}, {}, []
    tr._cache_hits, tr._label_cursor, tr._label_order = 0, 0, []
    tr._rng = random.Random(tr.cfg.seed + 99)
    tr.updates = 0


def _stub(tr, events, jax_side):
    """Replace the trainer's computations by recorders: an update, a PL
    generation (tokens [1, 2] and three frames of zeros a row), a soft step."""
    def rows(b):
        return tuple(int(i) for i in np.asarray(b["sample_idx"]) if i >= 0)

    def run_train_step(batch, key, sup):
        events.append(("train", sup, rows(batch)))
        tr.updates += 1

    def generate_pls(batch, want_soft=False):
        events.append(("pl", rows(batch)))
        pls = {i: [1, 2] for i in rows(batch)}
        soft = {i: np.zeros((3, tr.n_classes), np.float16) for i in rows(batch)}
        return (pls, soft) if want_soft else pls

    tr._run_train_step, tr._generate_pls = run_train_step, generate_pls
    if jax_side:
        def soft_step(mp, ms, opt, sb, soft, *a):
            events.append(("soft", rows(sb)))
            return mp, ms, opt, 0.0, True

        tr._jit_steps = lambda: setattr(tr, "_soft_step", soft_step)
    else:
        def soft_step(padded, soft_rows, *a):
            events.append(("soft", rows(padded)))
            return 0.0, True

        tr.soft_step = soft_step


@pytest.mark.parametrize("typ,soft", [("naive", False), ("cache", False),
                                      ("pre-cache", False), ("fixed-pre-cache", False),
                                      ("fixed-pre-cache", True)])
def test_slimipl_decisions_match_jax(data, slim, tmp_path, typ, soft):
    """Over 12 updates: sup or unsup, which batches are labeled, trained on,
    skipped or served from the fixed cache, in order, and the caches after."""
    from wav2letter_tpu_torch.runtime.train_slimipl import SlimIPLTrainer

    jtr = slim[0]
    _reset(jtr, typ, soft)
    ema, jtr.ema_params = jtr.ema_params, None
    jev, ev = [], []
    _stub(jtr, jev, True)
    try:
        jstats = jtr.run()
    finally:
        jtr.ema_params = ema
        for k in ("_run_train_step", "_generate_pls", "_jit_steps"):
            delattr(jtr, k)
    tr = SlimIPLTrainer(_cfg(data, tmp_path), ipl_flags=dict(
        SLIM, slimIPL_type=typ, slimIPL_use_soft=soft, slimIPL_ema=False), device="cpu")
    _stub(tr, ev, False)
    stats = tr.run()
    assert ev == jev and stats == jstats
    assert stats["unsup"] > 0 and (typ != "fixed-pre-cache" or stats["warmed"] == 2)
    assert tr.cache == jtr.cache and tr.fixed_cache == jtr.fixed_cache
    assert sorted(tr.soft_cache) == sorted(jtr.soft_cache)
    assert (tr._cache_hits, tr._label_cursor) == (jtr._cache_hits, jtr._label_cursor)


def test_slimipl_pls_soft_loss_and_ema_match_jax(data, slim, tmp_path):
    """From the same weights: a batch's PL tokens (equal) and fp16 emissions,
    then one soft-label update on JAX's cached emissions: the loss (1e-5) and
    the EMA after it (1e-6)."""
    from wav2letter_tpu_torch.runtime.train_slimipl import SlimIPLTrainer

    jtr, init = slim
    _reset(jtr, "fixed-pre-cache", True)
    jtr._pl_step, jtr._soft_step = jtr._make_pl_step(), jtr._make_soft_step()
    tr = SlimIPLTrainer(_cfg(data, tmp_path), ipl_flags=dict(
        SLIM, slimIPL_type="fixed-pre-cache", slimIPL_use_soft=True), mode="fork",
        init_model_path=init, device="cpu")
    ds = jtr.unsup_ds
    batch = ds.materialize(ds.batch_specs()[1])
    jpl, jsoft = jtr._generate_pls(batch, want_soft=True)
    pl, soft = tr._generate_pls(batch, want_soft=True)
    assert pl == jpl and sorted(soft) == sorted(jsoft)
    for i in soft:
        assert soft[i].dtype == np.float16 and soft[i].shape == jsoft[i].shape
        np.testing.assert_allclose(soft[i].astype(np.float32), jsoft[i].astype(np.float32),
                                   atol=1e-2, rtol=1e-3)  # fp16 of fp32 values within 1e-5
    jtr._store_pls(jpl, jsoft)
    tr._store_pls(jpl, jsoft)
    jtr.meters_unsup.reset()
    assert jtr._run_soft_step(batch, jax.random.PRNGKey(3))
    assert tr._run_soft_step(batch, 0)
    want, got = jtr.meters_unsup.loss.value(), tr.meters_unsup.loss.value()
    assert got == pytest.approx(want, abs=1e-5) and want > 0
    from wav2letter_tpu_torch.runtime.checkpoint import params_to_jax_tree

    ema = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax_tree(dict(tr.ema_model.named_parameters()))))
    moved = 0
    for path, w in jax.tree_util.tree_leaves_with_path(jax.device_get(jtr.ema_params)):
        np.testing.assert_allclose(ema[path], np.asarray(w), atol=1e-6, err_msg=str(path))
        moved += 1
    assert moved == len(ema) and tr.updates == jtr.updates == 1


def test_slimipl_dyn_dropout_and_strong_saug_match_jax(data, slim, tmp_path):
    from wav2letter_tpu_torch.runtime.train_slimipl import SlimIPLTrainer

    jtr = slim[0]
    tr = SlimIPLTrainer(_cfg(data, tmp_path), ipl_flags=dict(SLIM, slimIPL_dyn_dropout=0.25),
                        device="cpu")
    assert dataclasses.asdict(tr.specaug_strong) == dataclasses.asdict(jtr.specaug_strong)
    assert tr.specaug_strong.n_freq_masks == 2 and tr.specaug_strong.n_time_masks == 3
    # the strong SpecAugment is on for the supervised updates alone
    seen = []
    tr.train_step = lambda *a: (seen.append(tr.specaug is tr.specaug_strong),
                                (0.0, True, torch.zeros(4, 1, dtype=torch.long),
                                 torch.zeros(4, dtype=torch.long)))[1]
    tr.cfg.update(dict(pcttraineval=0))
    ds = tr.train_ds
    tr._run_train_step(ds.materialize(ds.batch_specs()[0]), 0, sup=True)
    tr._run_train_step(ds.materialize(ds.batch_specs()[0]), 1, sup=False)
    assert seen == [True, False] and tr.specaug is not tr.specaug_strong
    model, jtr.fl["slimIPL_dyn_dropout"] = jtr.model, 0.25
    try:
        jtr._apply_dyn_dropout()
        want = [s.line for s in jtr.model.specs]
    finally:
        jtr.model, jtr.fl["slimIPL_dyn_dropout"] = model, -1.0
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr._apply_dyn_dropout()
    assert tr.arch_lines == want and "DO 0.25" in want
    from wav2letter_tpu_torch.models.layers import Dropout

    assert [m.rate for m in tr.model.modules() if isinstance(m, Dropout)] == [0.25]
    after = tr.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert [p for _, p in tr.net_opt.params] == list(tr.model.parameters())


def test_slimipl_continue_restores_the_caches(data, tmp_path):
    """fixed-pre-cache with soft labels and the EMA, 8 updates with a report
    at 4, then ``continue``: the token, soft and fixed caches (bits) and the
    EMA come back as the run left them."""
    from wav2letter_tpu_torch.cli.train_slimipl import main

    args = [f"--{k}={v}" for k, v in _flags(data, tmp_path, iter=8, reportiters=4).items()]
    args += [f"--{k}={v}" for k, v in SLIM.items()]
    args += ["--slimIPL_type=fixed-pre-cache", "--slimIPL_use_soft=true", "--device=cpu"]
    tr = main(["train"] + args)
    assert tr.fixed_cache and tr.soft_cache and tr.cache and tr.updates == 8
    tr2 = main(["continue"] + [a.replace("--iter=8", "--iter=8") for a in args])
    assert tr2.updates == 8
    assert tr2.cache == tr.cache and tr2.fixed_cache == tr.fixed_cache
    assert (tr2._cache_hits, tr2._label_cursor) == (tr._cache_hits, tr._label_cursor)
    assert sorted(tr2.soft_cache) == sorted(tr.soft_cache)
    for k, v in tr.soft_cache.items():
        assert tr2.soft_cache[k].dtype == np.float16 and np.array_equal(tr2.soft_cache[k], v)
    for (n, a), (_, b) in zip(tr.ema_model.named_parameters(),
                              tr2.ema_model.named_parameters()):
        assert torch.equal(a, b), n
    assert json.load(open(tmp_path / "run" / "pl_cache_fixed.json"))["batches"] == tr.fixed_cache


# ---------------------------------------------------------------------------
# local prior match
# ---------------------------------------------------------------------------
def _lpm_flags(data, **kw):
    return dict(arch=str(data["root"] / "s2s.arch"), criterion="seq2seq", encoderdim=16,
                maxdecoderoutputlen=8, onorm="none", netoptim="adam", critoptim="adam",
                lr=0.01, lrcrit=0.01, maxgradnorm=5.0, lm=str(data["root"] / "lm.arpa"),
                saug_start_update=-1, **kw)


@pytest.fixture(scope="module")
def lpm(data, tmp_path_factory):
    """One JAX ``LPMTrainer`` for the module, its decoder's end and pad
    outputs pushed down (so that its untrained greedy paths are not empty),
    saved as a ``W2LTPU01`` file, and its proposal step compiled once."""
    from wav2letter_tpu.parallel import replicate
    from wav2letter_tpu.runtime.train_lpm import LPMTrainer as JaxLPM

    root = tmp_path_factory.mktemp("jax_lpm")
    jtr = JaxLPM(_jcfg(data, root, **_lpm_flags(data)), lpm_flags=dict(propupdate=1))
    cp = jax.device_get(jtr.crit_params)
    cp["out"]["bias"] = np.asarray(cp["out"]["bias"]).copy()
    cp["out"]["bias"][-2:] = -30.0
    jtr.crit_params = replicate(jtr.mesh, cp)
    jtr.proposal_crit = replicate(jtr.mesh, cp)
    jtr.save()
    init = str(root / "init.bin")
    os.replace(root / "run" / "model_last.bin", init)
    prop = jtr._make_proposal_eval()
    jtr._make_proposal_eval = lambda: prop
    jtr._eval_proposal = prop
    return jtr, init


def _port_lpm(data, tmp_path, init, **fl):
    from wav2letter_tpu_torch.runtime.train_lpm import LPMTrainer

    return LPMTrainer(_cfg(data, tmp_path, **_lpm_flags(data)), lpm_flags=dict(fl),
                      mode="fork", init_model_path=init, device="cpu")


def test_lpm_proposals_and_weights_match_jax(data, lpm, tmp_path):
    jtr, init = lpm
    tr = _port_lpm(data, tmp_path, init, propupdate=1)
    ds = jtr.unpaired_ds
    for spec in ds.batch_specs()[:2]:
        batch = ds.materialize(spec)
        want, got = jtr._propose(batch), tr._propose(batch)
        assert [h for h, _ in got] == [h for h, _ in want]
        assert [x for _, w in got for x in w] == pytest.approx([x for _, w in want for x in w])
        assert sum(len(h[0]) for h, _ in got if h) > len(got)  # real hypotheses


def test_lpm_two_updates_and_refresh_match_jax(data, lpm, tmp_path):
    """A paired then an unpaired update (JAX's proposals, refreshed after
    each): the losses within 1e-4 and the refresh updates equal."""
    jtr, init = lpm
    jtr.updates = 0
    jtr.cfg.update(dict(iter=2))
    jlosses, losses, jrefresh = [], [], []
    make, refresh = jtr._make_train_step, jtr._refresh_proposal

    def make_recorded(*a, **kw):
        step = make(*a, **kw)

        def recorded(*args):
            out = step(*args)
            jlosses.append(float(out[5]))
            return out
        return recorded

    def refresh_recorded():
        jrefresh.append(jtr.updates)
        refresh()

    jtr._make_train_step, jtr._refresh_proposal = make_recorded, refresh_recorded
    try:
        jstats = jtr.run()
    finally:
        del jtr._make_train_step, jtr._refresh_proposal
    tr = _port_lpm(data, tmp_path, init, propupdate=1)
    tr.cfg.update(dict(iter=2))
    step = tr.train_step
    tr.train_step = lambda *a: (lambda out: (losses.append(out[0]), out)[1])(step(*a))
    stats = tr.run()
    assert stats == jstats == {"paired": 1, "unpaired": 1, "skipped": 0}
    assert losses == pytest.approx(jlosses, abs=1e-4) and len(losses) == 2
    assert tr.refreshed_at == jrefresh == [1, 2]


def test_lpm_refresh_schedule_matches_jax(data, lpm, tmp_path):
    """Over 7 updates with --propupdate=3, --audioiter=2: the updates after
    which the proposal is refreshed, and what each stream took (the steps
    replaced by recorders)."""
    jtr, init = lpm
    jtr.updates = 0
    jtr.cfg.update(dict(iter=7))
    jtr.fl.update(propupdate=3, audioiter=2)
    jrefresh, refresh = [], jtr._refresh_proposal

    def fake_step(mp, cp, ms, no, co, *a):
        return mp, cp, ms, no, co, 0.0, True, None, None

    jtr._make_train_step = lambda *a, **kw: fake_step
    jtr._refresh_proposal = lambda: jrefresh.append(jtr.updates)
    try:
        jstats = jtr.run()
    finally:
        del jtr._make_train_step, jtr._refresh_proposal
        jtr.fl.update(propupdate=1, audioiter=1)
    tr = _port_lpm(data, tmp_path, init, propupdate=3, audioiter=2)
    tr.cfg.update(dict(iter=7))
    tr.train_step = lambda *a: (0.0, True, None, None)
    stats = tr.run()
    assert stats == jstats and tr.refreshed_at == jrefresh == [3, 6]
    assert refresh is not None


# ---------------------------------------------------------------------------
# IPL
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("beam", [False, True])
def test_generate_pseudo_labels_matches_jax(data, slim, beam):
    """On one ``W2LTPU01`` checkpoint: the words, scores and end flags of
    every utterance, by viterbi and by the lexicon beam with a 2-gram."""
    from wav2letter_tpu.runtime.ipl import generate_pseudo_labels as jax_generate
    from wav2letter_tpu_torch.runtime.ipl import generate_pseudo_labels

    extra = dict(lm=str(data["root"] / "lm.arpa"), lmweight=1.0, wordscore=0.5,
                 beamsize=20, beamthreshold=50, smearing="max") if beam else {}
    init = slim[1]
    want = jax_generate(init, data["unsup"], _jcfg(data, "", **extra))
    got = generate_pseudo_labels(init, data["unsup"], _cfg(data, "", **extra), device="cpu")
    assert [(s, w, e) for s, w, _, e in got] == [(s, w, e) for s, w, _, e in want]
    assert [x for _, _, x, _ in got] == pytest.approx([x for _, _, x, _ in want], abs=1e-4)
    assert len(got) == 12 and any(w for _, w, _, _ in got)


def test_ipl_loop_runs_and_resumes(data, tmp_path):
    """A seed round and one IPL round of 2 updates each through ``cli.ipl``,
    stopped once the round's PLs are written, then rerun: it resumes from
    ``ipl_state.json``, writes the same PLs and finishes the round."""
    import wav2letter_tpu_torch.runtime.ipl as ipl
    from wav2letter_tpu_torch.cli.ipl import main

    flags = _flags(data, tmp_path, runname="ipl")
    flags.pop("train2")
    args = [f"--{k}={v}" for k, v in flags.items()] + [
        f"--unsup_train={data['unsup']}", "--ipl_rounds=1", "--ipl_seed_iters=2",
        "--ipl_round_iters=2", "--ipl_max_ngram_repeats=100", "--device=cpu"]
    write = ipl.write_pseudo_labeled_list

    class Stop(Exception):
        pass

    def write_then_stop(*a):
        write(*a)
        raise Stop()

    ipl.write_pseudo_labeled_list = write_then_stop
    try:
        with pytest.raises(Stop):
            main(args)
    finally:
        ipl.write_pseudo_labeled_list = write
    run = tmp_path / "ipl"
    state = json.load(open(run / "ipl_state.json"))
    assert state["round"] == 1 and len(state["history"]) == 1
    first = (run / "pl_round01.lst").read_text()
    state = main(args)
    assert state["round"] == 2 and [h["round"] for h in state["history"]] == [0, 1]
    assert (run / "pl_round01.lst").read_text() == first
    assert os.path.exists(state["model"]) and state["model"].endswith(
        os.path.join("round01", "model_last.bin"))
    # a round featurizes on the device, as cli.train does without --features_device
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    assert load_checkpoint(state["model"]).extra["host_features"] is False
    merged = (run / "train_round01.lst").read_text().splitlines()
    assert len(merged) == 12 + len(first.splitlines())
    assert main(args)["round"] == 2  # done: a rerun is a no-op


# ---------------------------------------------------------------------------
# profiling, and the entry points without a card
# ---------------------------------------------------------------------------
def test_profiling_on_the_cpu(tmp_path, capsys):
    from wav2letter_tpu_torch.runtime import profiling

    with profiling.TimeElapsedReporter("scope", sync="cpu") as t:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.elapsed_ms > 0 and "[scope] took" in capsys.readouterr().out
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8, 8).sum()
    assert json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    assert profiling.device_memory_stats() == ({} if not torch.cuda.is_available()
                                               else profiling.device_memory_stats())
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    assert profiling.log_compile_cost(torch.matmul, a, b) == {"flops": 2.0 * 4 * 8 * 16}


@pytest.mark.parametrize("cli", ["train_cpc", "train_slimipl", "train_lpm", "ipl"])
def test_entry_points_need_a_card(data, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    import importlib

    main = importlib.import_module(f"wav2letter_tpu_torch.cli.{cli}").main
    flags = _flags(data, tmp_path)
    if cli == "train_lpm":
        flags.update(_lpm_flags(data))
    args = [f"--{k}={v}" for k, v in flags.items()]
    if cli == "ipl":
        args.append(f"--unsup_train={data['unsup']}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
