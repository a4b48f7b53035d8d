"""The port's ConvLM (``decoder/convlm.py``) and the ``--lmtype=convlm``
decode against the JAX package on the CPU: the GCNN of
``tests/test_native_convlm.py`` with flax weights carried over by
``convert_jax_params``; ``score``, ``finish`` and ``score_batch`` in log10
(1e-5), the LRU cache at a tiny ``lm_memory``, ``load_convlm`` from a JAX
``W2LTPU01`` LM checkpoint and from the port's own; then ``run_decode`` of a
CTC, an ASG and a seq2seq checkpoint with a word-level ConvLM, from one
``--emission_dir`` that the JAX forward fills, to the same words."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_asg import asg_jax_checkpoint
from tests.test_torch_seq2seq import s2s_data, s2s_jax_checkpoint  # noqa: F401 (fixture)
from tests.test_torch_slice import jax_checkpoint  # noqa: F401 (fixture)
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.decoder.convlm import ConvLM as JaxConvLM
from wav2letter_tpu.decoder.convlm import load_convlm as jax_load_convlm
from wav2letter_tpu.models.arch import parse_arch_lines as jax_parse
from wav2letter_tpu.models.lm import LMArchModel as JaxLM
from wav2letter_tpu.models.lm import build_lm_model as jax_build_lm
from wav2letter_tpu.runtime.checkpoint import Checkpoint as JaxCheckpoint
from wav2letter_tpu.runtime.checkpoint import save_checkpoint as jax_save
from wav2letter_tpu.runtime.decode import run_decode as jax_run_decode
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.decoder.convlm import ConvLM, load_convlm
from wav2letter_tpu_torch.models.arch import parse_arch_lines
from wav2letter_tpu_torch.models.lm import LMArchModel
from wav2letter_tpu_torch.runtime.checkpoint import (Checkpoint, convert_jax_params,
                                                     save_checkpoint)
from wav2letter_tpu_torch.runtime.decode import run_decode

V_LM = 8  # w0..w5, </s>, <unk>
VOCAB = [f"w{i}" for i in range(V_LM - 2)] + ["</s>", "<unk>"]
USR = ["w0", "w1", "w2", "w9", "<unk>"]  # w9 is not in the LM: <unk>


def _gcnn(vocab):
    return ["V -1 0 1 1", f"E 12 {vocab}", "RO 1 3 0 2", "WN 3 AC 12 24 3 1 -1 0", "GLU 2",
            "RO 2 0 3 1", f"WN 0 L 12 {vocab}"]


def _lms(context=6, lm_memory=64, seed=3):
    """The JAX ConvLM and the port's on the same (perturbed) weights."""
    jm = JaxLM(tuple(jax_parse(_gcnn(V_LM))), V_LM, V_LM)
    p = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4), jnp.int32))["params"]
    leaves, tdef = jax.tree.flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    p = jax.tree.unflatten(tdef, [x + 0.3 * jax.random.normal(k, x.shape)
                                  for x, k in zip(leaves, keys)])
    pm = LMArchModel(parse_arch_lines(_gcnn(V_LM)), V_LM, V_LM)
    pm.load_state_dict(convert_jax_params(jax.device_get(p)), strict=True)
    kw = dict(usr_vocab=USR, context=context, lm_memory=lm_memory)
    return JaxConvLM(jm, {"params": p}, VOCAB, **kw), ConvLM(pm, VOCAB, **kw)


def _requests(seed, n=40, context=6):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, context + 1, size=n).astype(np.int32)
    hists = np.full((n, context), 7, np.int32)  # padding past lens: any id
    for i in range(n):
        hists[i, : lens[i]] = rng.randint(0, V_LM, size=lens[i])
    hists[5], lens[5] = hists[3], lens[3]  # a repeated history
    return hists, lens, rng.randint(0, V_LM, size=n).astype(np.int32)


@pytest.mark.parametrize("lm_memory", [64, 3])
def test_scores_match_jax(lm_memory):
    """The chain of ``score``s from ``start`` (the usr map, <unk> for a word
    the LM lacks, the history cut to the context), ``finish``, then batches
    of deferred requests; at ``lm_memory`` 3 the cache evicts inside a batch
    and stays bounded."""
    jlm, plm = _lms(context=4, lm_memory=lm_memory)
    assert plm.usr_map == jlm.usr_map == [0, 1, 2, 7, 7]
    js, ps = jlm.start(), plm.start()
    assert ps.ngram == js.ngram == (6,)
    for u in (0, 3, 1, 2, 2, 4):
        js, jsc = jlm.score(js, u)
        ps, psc = plm.score(ps, u)
        assert ps.ngram == js.ngram
        assert psc == pytest.approx(jsc, abs=1e-5)
    assert len(ps.ngram) == 4
    assert plm.finish(ps)[1] == pytest.approx(jlm.finish(js)[1], abs=1e-5)
    for seed in (0, 1):
        args = _requests(seed, context=4)
        np.testing.assert_allclose(plm.score_batch(*args), jlm.score_batch(*args), atol=1e-5)
        assert len(plm.cache) == len(jlm.cache) <= lm_memory
    st = plm.stats
    assert st["device_calls"] >= 1 and 0 <= st["hits"] < st["lookups"]
    assert st["device_ms"] > 0.0


def test_history_longer_than_the_context_fails_in_both():
    jlm, plm = _lms()
    hists = np.arange(8, dtype=np.int32)[None] % V_LM
    args = (hists, np.asarray([8], np.int32), np.asarray([1], np.int32))
    with pytest.raises(ValueError):
        jlm.score_batch(*args)
    with pytest.raises(ValueError):
        plm.score_batch(*args)


def _write_lms(root, vocab):
    """A JAX ``W2LTPU01`` LM checkpoint (as ``cli/train_lm.py`` writes one)
    and the port's ``lm_model.bin`` of the same weights, and the vocab file."""
    arch = os.path.join(root, "lm.arch")
    with open(arch, "w") as f:
        f.write("\n".join(_gcnn(len(vocab))) + "\n")
    vfile = os.path.join(root, "lm_vocab.txt")
    with open(vfile, "w") as f:
        f.write("\n".join(vocab) + "\n")
    jm = jax_build_lm(arch, len(vocab))
    p = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32))["params"]
    p = jax.tree.map(lambda x: x * 3.0, p)  # scores far from uniform
    cfg = JaxConfig()
    cfg.update(dict(arch=arch))
    paths = {"jax": os.path.join(root, "lm_jax.bin"), "torch": os.path.join(root, "lm.bin")}
    jax_save(paths["jax"], JaxCheckpoint(
        config=cfg.serialize(), epoch=0, updates=1, model_params=p, model_state={},
        crit_params={}, opt_state={}, crit_opt_state={}, extra={}))
    pcfg = Config()
    pcfg.update(dict(arch=arch))
    save_checkpoint(paths["torch"], Checkpoint(
        config=pcfg.serialize(), epoch=0, updates=1,
        state_dict=convert_jax_params(jax.device_get(p))))
    return paths, vfile


def test_load_convlm_reads_both_checkpoints(tmp_path):
    paths, vfile = _write_lms(str(tmp_path), VOCAB)
    want = jax_load_convlm(paths["jax"], vfile, usr_vocab=USR, lm_memory=10)
    args = _requests(2, context=8)
    for path in paths.values():
        got = load_convlm(path, vfile, usr_vocab=USR, lm_memory=10, device="cpu")
        assert (got.context, got.lm_memory, got.eos_id, got.unk_id) == (48, 10, 6, 7)
        np.testing.assert_allclose(got.score_batch(*args), want.score_batch(*args), atol=1e-5)
    for load in (jax_load_convlm, lambda *a: load_convlm(*a, device="cpu")):
        with pytest.raises(ValueError, match="lm_vocab"):
            load(paths["jax"], "")
    if not torch.cuda.is_available():  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_convlm(paths["torch"], vfile)


def _lexicon_words(path):
    with open(path) as f:
        return list(dict.fromkeys(line.split()[0] for line in f if line.strip()))


@pytest.fixture(scope="module")
def checkpoints(jax_checkpoint, s2s_data, tmp_path_factory):  # noqa: F811 (fixtures)
    """{criterion: (AM checkpoint, list)}: the CTC slice's, an ASG one and a
    seq2seq (GRU, keyvalue) one, all JAX-written."""
    root = str(tmp_path_factory.mktemp("convlm_decode"))
    out = {"ctc": (jax_checkpoint[1], jax_checkpoint[2])}
    lst, am, _ = asg_jax_checkpoint(os.path.join(root, "asg"))
    out["asg"] = (am, lst)
    am = os.path.join(root, "s2s.bin")
    s2s_jax_checkpoint(s2s_data, "seq2seq", am)
    out["seq2seq"] = (am, s2s_data[1])
    return root, out


@pytest.mark.parametrize("crit,lexicon", [("ctc", True), ("asg", True), ("seq2seq", True),
                                          ("ctc", False)],
                         ids=["ctc", "asg", "seq2seq", "ctc_lexicon_free_tokens"])
def test_decode_with_convlm_matches_jax(checkpoints, tmp_path, monkeypatch, crit, lexicon):
    """``run_decode --lmtype=convlm`` (native beams, two consumer threads
    each with its ConvLM) from the emissions the JAX forward left in
    ``--emission_dir``: the same ``.hyp`` lines and WER in both packages; a
    word ConvLM over the lexicon beams, a token ConvLM over the lexicon-free
    beam."""
    from wav2letter_tpu_torch.runtime.test import Evaluator

    monkeypatch.setenv("W2L_REQUIRE_NATIVE", "1")
    _, cks = checkpoints
    am, lst = cks[crit]
    ev = Evaluator(Config().update(dict(am=am, test=lst)), device="cpu")
    words = _lexicon_words(ev.cfg.lexicon) if lexicon else ev.token_dict.entries()
    paths, vfile = _write_lms(str(tmp_path), words + ["</s>", "<unk>"])
    root, shared = str(tmp_path), str(tmp_path / "em")
    kw = dict(am=am, test=lst, lm=paths["jax"], lmtype="convlm", lm_vocab=vfile,
              lm_memory=20, lmweight=2.0, wordscore=0.5, beamsize=10, beamthreshold=25.0,
              smearing="max", nthread_decoder=2, emission_dir=shared, batchsize=4,
              uselexicon=lexicon, decodertype="wrd" if lexicon else "tkn")
    if crit == "seq2seq":
        kw.update(wordscore=2.0, eosscore=-4.0, beamsizetoken=7, nthread_decoder=1,
                  isbeamdump=True)
    out = {}
    for side in ("jax", "torch"):
        cfg = JaxConfig() if side == "jax" else Config()
        cfg.update(dict(kw, sclite=os.path.join(root, side)))
        if side == "torch":
            cfg.update({"lm": paths["torch"]})
        out[side] = jax_run_decode(cfg) if side == "jax" else run_decode(cfg, device="cpu")
    assert out["torch"]["decoder"].startswith("Native")
    base = os.path.basename(lst)
    hyps = {}
    for side in ("jax", "torch"):
        with open(os.path.join(root, side, base + ".hyp")) as f:
            hyps[side] = sorted(f.read().splitlines())
    assert hyps["torch"] == hyps["jax"] and len(hyps["jax"]) >= 7
    assert out["torch"]["WER"] == out["jax"]["WER"]
    if crit != "seq2seq":
        assert any(h.split(" (")[0] for h in hyps["jax"])  # some utterance decodes to words
        return
    # a random decoder's best hypothesis is empty; its n-best hold the LM's words
    beams = {}
    for side in ("jax", "torch"):
        with open(os.path.join(root, side, base + ".beams")) as f:
            beams[side] = sorted((ln.split("\t")[0], ln.split("\t")[3])
                                 for ln in f.read().splitlines())
    assert beams["torch"] == beams["jax"] and any(w for _, w in beams["jax"])
