"""The port's seq2seq beams (``decoder/seq2seq_beam.py``,
``decoder/s2s_native.py``) and the seq2seq branch of its ``run_decode``
against the JAX package's, on the CPU.

One ``W2LTPU01`` checkpoint per criterion (``tests/test_torch_seq2seq.py``'s
narrow archs, the criterion perturbed from flax's init), a 2-gram ARPA over
the list's transcripts and the lexicon's trie. On the same numpy-seeded
encoder states, each package's Python beam and native beam, sequential and
batched across utterances (``--s2s_batch_decode``), gives the same
hypotheses (tokens, words, completion) with scores within 1e-4, with and
without the attention-threshold and hard/soft-selection pruning. From one
shared ``--emission_dir`` the decode binary (``cli.decode``) and
``run_decode`` write the same ``.hyp``, ``.log`` and beam dump as JAX's."""

import math
import os

import numpy as np
import pytest

from tests.test_torch_seq2seq import s2s_data, s2s_jax_checkpoint  # noqa: F401 (fixture)
from wav2letter_tpu.config import Config as JaxConfig
from wav2letter_tpu.data import Lexicon as JaxLexicon
from wav2letter_tpu.data import make_token_dict as jax_token_dict
from wav2letter_tpu.data import make_word_dict as jax_word_dict
from wav2letter_tpu.decoder import DecoderOptions as JaxOptions
from wav2letter_tpu.decoder import SmearingMode as JaxSmearing
from wav2letter_tpu.decoder import Trie as JaxTrie
from wav2letter_tpu.decoder.lm import KenLM as JaxKenLM
from wav2letter_tpu.decoder.native import NativeLM as JaxNativeLM
from wav2letter_tpu.decoder.native import NativeTrie as JaxNativeTrie
from wav2letter_tpu.decoder.s2s_native import NativeSeq2SeqBatchDecoder as JaxBatch
from wav2letter_tpu.decoder.s2s_native import NativeSeq2SeqDecoder as JaxNative
from wav2letter_tpu.decoder.seq2seq_beam import LexiconSeq2SeqDecoder as JaxLexiconBeam
from wav2letter_tpu.decoder.seq2seq_beam import make_s2s_update_fn as jax_update_fn
from wav2letter_tpu.runtime.decode import run_decode as jax_run_decode
from wav2letter_tpu.runtime.test import Evaluator as JaxEvaluator
import wav2letter_tpu_torch.runtime.decode as port_decode
from wav2letter_tpu_torch.config import Config
from wav2letter_tpu_torch.data import Lexicon, make_token_dict
from wav2letter_tpu_torch.runtime.decode import S2SBeamParts, run_decode
from wav2letter_tpu_torch.runtime.test import Evaluator
from wav2letter_tpu_torch.tools.ngram_lm import train_ngram_lm

DECODE = dict(lmweight=1.0, wordscore=2.0, eosscore=-4.0, beamsize=6, beamsizetoken=7,
              beamthreshold=30.0, uselexicon=True, decodertype="wrd", nthread_decoder=1)
PRUNE = {"none": {}, "pruned": dict(attentionthreshold=2.0, hardselection=1.5,
                                    softselection=4.0)}


@pytest.fixture(scope="module")
def s2s_setup(s2s_data, tmp_path_factory):  # noqa: F811 (the imported fixture)
    """Both criterions' checkpoints, the 2-gram ARPA and random encoder
    states of 2 utterances (T = 9, 14) for each."""
    root = str(tmp_path_factory.mktemp("s2s_decode"))
    lst = s2s_data[1]
    corpus = os.path.join(root, "corpus.txt")
    with open(lst) as f, open(corpus, "w") as out:
        out.writelines(" ".join(line.split()[3:]) + "\n" for line in f)
    lm = os.path.join(root, "lm.arpa")
    train_ngram_lm(corpus, lm, order=2)
    ams, ems = {}, {}
    rng = np.random.RandomState(3)
    for crit in ("seq2seq", "transformer"):
        ams[crit] = os.path.join(root, f"{crit}.bin")
        flags = s2s_jax_checkpoint(s2s_data, crit, ams[crit])
        E = 2 * flags["encoderdim"] if crit == "seq2seq" else flags["encoderdim"]
        ems[crit] = [rng.randn(T, E).astype(np.float32) for T in (9, 14)]
    return dict(root=root, lst=lst, lm=lm, ams=ams, ems=ems)


def _cfg(side, **kw):
    cfg = JaxConfig() if side == "jax" else Config()
    cfg.update(dict(DECODE, **kw))
    return cfg


def _jax_decoders(setup, crit, prune, native):
    """JAX's beam for each utterance, built as its ``run_decode`` does."""
    ev = JaxEvaluator(_cfg("jax", am=setup["ams"][crit], test=setup["lst"]))
    cfg = ev.cfg
    cfg.update(dict(DECODE, lm=setup["lm"], **PRUNE[prune]))
    wd = jax_word_dict(ev.lexicon)
    opts = JaxOptions.from_config(cfg)
    lm = (JaxNativeLM(setup["lm"], usr_vocab=wd.entries()) if native
          else JaxKenLM(setup["lm"], usr_vocab=wd.entries()))
    trie = JaxNativeTrie(ev.n_classes) if native else JaxTrie(ev.n_classes)
    for w, sps in ev.lexicon.entries.items():
        for sp in sps:
            trie.insert([ev.token_dict.get_index(t) for t in sp], wd.get_index(w), 0.0)
    trie.smear("none" if native else JaxSmearing.NONE)
    kw = dict(attention_threshold=cfg.attentionthreshold, hard_selection=cfg.hardselection,
              soft_selection=cfg.softselection)
    eos, L = ev.n_classes - 2, cfg.maxdecoderoutputlen
    if native == "batched":
        return JaxBatch(opts, eos, ev.s2s_criterion, ev.crit_params, lm=lm, trie=trie,
                        max_output_len=L, **kw)
    out = []
    for em in setup["ems"][crit]:
        fn, init = jax_update_fn(ev.s2s_criterion, ev.crit_params, em, em.shape[0])
        out.append(JaxNative(opts, eos, fn, init, lm=lm, trie=trie, max_output_len=L, **kw)
                   if native else
                   JaxLexiconBeam(opts, trie, lm, eos, fn, init, max_output_len=L, **kw))
    return out


def _same(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g.tokens, g.words, g.completed) == (w.tokens, w.words, w.completed)
        for a, b in ((g.score, w.score), (g.am_score, w.am_score), (g.lm_score, w.lm_score)):
            assert a == pytest.approx(b, rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("prune", list(PRUNE))
@pytest.mark.parametrize("beam", ["python", "native", "batched"])
@pytest.mark.parametrize("crit", ["seq2seq", "transformer"])
def test_beams_match_jax(s2s_setup, crit, beam, prune):
    native = beam != "python"
    ev = Evaluator(_cfg("torch", am=s2s_setup["ams"][crit], test=s2s_setup["lst"]),
                   device="cpu")
    cfg = ev.cfg
    cfg.update(dict(DECODE, lm=s2s_setup["lm"], **PRUNE[prune]))
    parts = S2SBeamParts(cfg, ev.token_dict, ev.lexicon, use_native=native)
    assert parts.native == native
    eos, L = ev.n_classes - 2, cfg.maxdecoderoutputlen
    ems = s2s_setup["ems"][crit]
    jdec = _jax_decoders(s2s_setup, crit, prune, beam if beam == "batched" else native)
    if beam == "batched":
        got = parts.batch_decoder(ev.s2s_criterion, eos, L).decode(ems, n_best=4)
        want = jdec.decode(ems, n_best=4)
        # and each utterance's beam as the sequential decoder's
        seq = [parts.decoder(ev.s2s_criterion, em, eos, L).decode(n_best=4) for em in ems]
        for g, s in zip(got, seq):
            _same(g, s)
    else:
        got = [parts.decoder(ev.s2s_criterion, em, eos, L).decode(n_best=4) for em in ems]
        want = [d.decode(n_best=4) for d in jdec]
        assert type(parts.decoder(ev.s2s_criterion, ems[0], eos, L)).__name__ == \
            type(jdec[0]).__name__
    for g, w in zip(got, want):
        _same(g, w)
    assert any(r.words != [-1] for rs in got for r in rs)  # the trie emitted words
    if prune == "pruned" and crit == "seq2seq":
        # the pruning acts: the pruned beams differ from the unpruned ones
        cfg.update({k: math.inf for k in PRUNE["pruned"]})
        free = S2SBeamParts(cfg, ev.token_dict, ev.lexicon, use_native=native)
        loose = [free.decoder(ev.s2s_criterion, em, eos, L).decode(n_best=4) for em in ems]
        assert any([r.score for r in a] != [r.score for r in b] for a, b in zip(loose, got))


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("crit,how", [("seq2seq", "cli"), ("transformer", "batched"),
                                      ("seq2seq", "python")])
def test_decode_from_shared_emissions_matches_jax(s2s_setup, tmp_path, monkeypatch, crit,
                                                  how):
    """The JAX forward fills ``--emission_dir``; both packages decode from it
    (with the beam dump) to the same files."""
    import wav2letter_tpu.decoder.native as jax_native

    root, am, lst = str(tmp_path), s2s_setup["ams"][crit], s2s_setup["lst"]
    monkeypatch.setenv("W2L_REQUIRE_NATIVE", "0" if how == "python" else "1")
    shared = os.path.join(root, "em")
    kw = dict(am=am, test=lst, lm=s2s_setup["lm"], emission_dir=shared, isbeamdump=True,
              batchsize=4, attentionthreshold=15.0, hardselection=1.5, softselection=4.0)
    if how == "batched":
        kw["s2s_batch_decode"] = 3
    if how == "python":
        monkeypatch.setattr(jax_native, "native_available", lambda: False)
        monkeypatch.setattr(port_decode, "S2SBeamParts",
                            lambda *a, **k: S2SBeamParts(*a, use_native=False, **k))
    out = {"jax": jax_run_decode(_cfg("jax", sclite=os.path.join(root, "jax"), **kw))}
    assert len(os.listdir(shared)) == 12
    if how == "cli":
        from wav2letter_tpu_torch.cli.decode import main

        argv = [f"--{k}={v}" for k, v in dict(DECODE, **kw).items()]
        out["torch"] = main(argv + [f"--sclite={os.path.join(root, 'torch')}", "--device=cpu"])
    else:
        out["torch"] = run_decode(_cfg("torch", sclite=os.path.join(root, "torch"), **kw),
                                  device="cpu")
    want_dec = {"cli": "NativeSeq2SeqDecoder", "batched": "NativeSeq2SeqBatchDecoder",
                "python": "LexiconSeq2SeqDecoder"}[how]
    assert out["torch"]["decoder"] == want_dec
    assert (out["torch"]["WER"], out["torch"]["TER"]) == (out["jax"]["WER"], out["jax"]["TER"])
    # the port writes the list's order, JAX the order the beams finished in
    base = os.path.basename(lst)
    for ext in (".hyp", ".ref", ".log"):
        want = _read(os.path.join(root, "jax", base + ext)).splitlines()
        assert sorted(_read(os.path.join(root, "torch", base + ext)).splitlines()) == \
            sorted(want)
    # the beam dump: the same hypotheses, their AM and LM scores within 1e-4
    beams = {}
    for side in ("jax", "torch"):
        beams[side] = {}
        for line in _read(os.path.join(root, side, base + ".beams")).splitlines():
            sid, am_s, lm_s, words = line.split("\t")
            beams[side].setdefault(sid, []).append((words, float(am_s), float(lm_s)))
    assert beams["torch"].keys() == beams["jax"].keys() and len(beams["jax"]) == 12
    for sid, want in beams["jax"].items():
        got = beams["torch"][sid]
        assert [g[0] for g in got] == [w[0] for w in want]
        assert [x for g in got for x in g[1:]] == pytest.approx(
            [x for w in want for x in w[1:]], rel=1e-4, abs=1e-4)
    # random weights: the best hypothesis may be the empty one, the n-best hold words
    assert sum(bool(w[0]) for ws in beams["jax"].values() for w in ws) >= 12


def test_dictionaries_of_both_packages_agree(s2s_setup):
    """The decode's token and word dictionaries: eos and pad after the
    tokens, the lexicon's words in one order."""
    cfg = _cfg("torch", am=s2s_setup["ams"]["seq2seq"], test=s2s_setup["lst"])
    ev = Evaluator(cfg, device="cpu")
    jtok = jax_token_dict(ev.cfg.tokens, "seq2seq", 0, True)
    assert make_token_dict(ev.cfg.tokens, "seq2seq", 0, True).entries() == jtok.entries()
    assert Lexicon.from_file(ev.cfg.lexicon).entries == \
        JaxLexicon.from_file(ev.cfg.lexicon).entries
