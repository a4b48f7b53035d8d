"""The port's copy of the synthetic corpus generator
(``wav2letter_tpu_torch/tools/synth_corpus.py``) against the JAX package's
(``wav2letter_tpu/tools/synth_corpus.py``, numpy only) on the CPU: one seed
writes the same bytes in every file through both at a tiny size (the list
files differ only in the root of their audio paths), and the chain, its
vectorized sampler and the homophone slice agree."""

import filecmp
import os

import numpy as np
import pytest

from wav2letter_tpu.tools import synth_corpus as J
from wav2letter_tpu_torch.tools import synth_corpus as P

TINY = dict(train_hours=0.005, dev_minutes=0.1, test_minutes=0.1, n_words=60,
            n_homophone_pairs=6, lm_sentences=200, seed=3, n_succ=12)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for side, mod in (("jax", J), ("torch", P)):
        d = str(root / side)
        mod.generate(d, **TINY)
        mod.generate_homophone_slice(d, n_utts=3)
        out[side] = d
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_generate_writes_the_same_bytes(corpora):
    jroot, troot = corpora["jax"], corpora["torch"]
    files = _files(jroot)
    assert files == _files(troot)
    wavs = [f for f in files if f.endswith(".wav")]
    assert len(wavs) >= 6 and {"train.lst", "dev.lst", "test.lst", "homo_eval.lst",
                                "tokens.txt", "lexicon.txt", "lm_corpus.txt",
                                "meta.json"} <= set(files)
    for f in files:
        if f.endswith(".lst"):  # equal but for the root of the audio paths
            with open(os.path.join(jroot, f)) as a, open(os.path.join(troot, f)) as b:
                assert a.read().replace(jroot, "ROOT") == b.read().replace(troot, "ROOT"), f
        else:
            assert filecmp.cmp(os.path.join(jroot, f), os.path.join(troot, f),
                               shallow=False), f


def test_chain_and_sampler_agree():
    kw = dict(seed=5, n_words=80, n_homophone_pairs=8, n_succ=16)
    jv, jp, jc = J.load_chain(**kw)
    tv, tp, tc = P.load_chain(**kw)
    assert (jv, jp) == (tv, tp)
    for a, b in ((jc.start, tc.start), (jc.unigram, tc.unigram)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jc.succ + jc.succ_p, tc.succ + tc.succ_p):
        np.testing.assert_array_equal(a, b)
    want = J.sample_chain_sentences(jc, 50, np.random.RandomState(9))
    got = P.sample_chain_sentences(tc, 50, np.random.RandomState(9))
    assert got == want
    rj, rt = np.random.RandomState(4), np.random.RandomState(4)
    np.testing.assert_array_equal(P.synth_words(rt, ["abq", "kl"]),
                                  J.synth_words(rj, ["abq", "kl"]))
