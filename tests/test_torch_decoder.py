"""The port's decoder stack against the JAX package's, on the CPU: n-gram LMs
(ARPA in Python, the native reader, its ``.bin`` and ``.qt`` conversions),
the smeared lexicon trie, the Python beams and the native beam decoder (the
port's own build of ``decoder.cpp``), top-k-shipped emissions, FLAC, and
how a native core that fails to build is reported.

Emissions are seeded fp32 (T = 40, V = 30): token 0 is the word separator,
29 the CTC blank, and a 40-word lexicon spells each word with 1-4 of tokens
1-28 and the separator."""

import os
import stat

import numpy as np
import pytest
import torch

from tests.util_flac import encode_flac
from wav2letter_tpu import decoder as jdec
from wav2letter_tpu.decoder import native as jnative
from wav2letter_tpu.data.audio import load_audio as jax_load_audio
from wav2letter_tpu_torch import decoder as tdec
from wav2letter_tpu_torch.decoder import native as tnative
from wav2letter_tpu_torch.ops import native as native_build
from wav2letter_tpu_torch.tools.ngram_lm import (
    build_binary, build_trie_binary, train_ngram_lm,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, SIL, BLANK, T = 30, 0, 29, 40
SEEDS = [0, 1, 2]

# a 3-gram written by hand: backoff weights at every order and an <unk>
ARPA3 = """\\data\\
ngram 1=6
ngram 2=4
ngram 3=2

\\1-grams:
-1.0\t<s>\t-0.5
-1.2\t</s>
-0.5\tthe\t-0.3
-0.8\tcat\t-0.2
-0.9\tsat\t-0.25
-1.5\t<unk>

\\2-grams:
-0.2\t<s> the\t-0.1
-0.4\tthe cat\t-0.15
-0.6\tcat sat
-0.9\tsat </s>

\\3-grams:
-0.1\t<s> the cat
-0.3\tthe cat sat

\\end\\
"""
SENTENCES = [["the", "cat", "sat"], ["the"], ["cat", "the"], ["sat", "sat", "cat"],
             ["dog"], ["the", "dog", "cat", "sat"], []]


def _lexicon(seed=7, n_words=40):
    rng = np.random.RandomState(seed)
    words = [f"w{i:02d}" for i in range(n_words)]
    spell = {w: [int(t) for t in rng.randint(1, BLANK, rng.randint(1, 5))] + [SIL]
             for w in words}
    return words, spell


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """The hand-written 3-gram, and a word 3-gram and a token 3-gram trained
    by the port's ``train_ngram_lm`` on seeded sentences; each word LM also
    as ``.bin`` and ``.qt``."""
    root = tmp_path_factory.mktemp("lms")
    words, _ = _lexicon()
    rng = np.random.RandomState(3)
    hand = root / "hand.arpa"
    hand.write_text(ARPA3)
    corpus = root / "words.txt"
    corpus.write_text("\n".join(" ".join(words[j] for j in rng.randint(0, len(words), 6))
                                for _ in range(300)) + "\n")
    tokens = root / "tokens.txt"
    tokens.write_text("\n".join(" ".join(f"t{j:02d}" for j in rng.randint(0, V, 8))
                                for _ in range(300)) + "\n")
    out = {"hand": str(hand)}
    for name, src in (("words", corpus), ("tokens", tokens)):
        out[name] = str(root / f"{name}.arpa")
        train_ngram_lm(str(src), out[name], order=3)
    for name in ("hand", "words"):
        out[name + ".bin"] = build_binary(out[name], str(root / f"{name}.bin"))
        out[name + ".qt"] = build_trie_binary(out[name], str(root / f"{name}.qt"))
    return out


# -- LMs ---------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["arpa", "bin", "qt"])
def test_arpa_scores_match_jax(lm_files, fmt):
    """Sentence scores of the 3-gram (backoff at each order, an OOV word
    scored as <unk>) from the port's KenLM factory (ArpaLM or the native
    reader) equal the JAX package's ArpaLM and NativeLM."""
    arpa = lm_files["hand"]
    path = arpa if fmt == "arpa" else lm_files[f"hand.{fmt}"]
    want_py = jdec.ArpaLM(arpa)
    want_nat = jnative.NativeLM(arpa)
    got = tdec.KenLM(path)
    assert isinstance(got, tdec.ArpaLM if fmt == "arpa" else tdec.lm.NativeKenLM)
    got_nat = tnative.NativeLM(path)
    for sent in SENTENCES:
        ids = [want_nat.lib.w2l_lm_word_id(want_nat.ptr, w.encode()) for w in sent]
        gids = [got_nat.lib.w2l_lm_word_id(got_nat.ptr, w.encode()) for w in sent]
        unk = got_nat.lib.w2l_lm_unk_id(got_nat.ptr)
        gids = [unk if i < 0 else i for i in gids]
        ids = [want_nat.lib.w2l_lm_unk_id(want_nat.ptr) if i < 0 else i for i in ids]
        want = want_py.score_sentence(sent)
        assert abs(want_nat.score_sentence_ids(ids) - want) < 1e-4, sent
        assert abs(got.score_sentence(sent) - want) < 1e-4, sent
        assert abs(got_nat.score_sentence_ids(gids) - want) < 1e-4, sent


def test_lm_states_match_jax(lm_files):
    """start/score/finish of the port's ArpaLM walk the JAX package's states
    and scores exactly, with a usr vocabulary that maps a word to <unk>."""
    vocab = ["the", "cat", "sat", "dog"]
    want, got = (pkg.ArpaLM(lm_files["hand"], usr_vocab=vocab) for pkg in (jdec, tdec))
    ws, gs = want.start(False), got.start(False)
    for w in (0, 1, 2, 3, 1, 0):
        ws, a = want.score(ws, w)
        gs, b = got.score(gs, w)
        assert a == b and ws.ngram == gs.ngram
    assert want.finish(ws)[1] == got.finish(gs)[1]


# -- trie --------------------------------------------------------------------
def _tries(pkg, mode, scores):
    _, spell = _lexicon()
    trie = pkg.Trie(V)
    for i, (w, sp) in enumerate(spell.items()):
        trie.insert(sp, i, scores[i])
    trie.smear(getattr(pkg.SmearingMode, mode))
    return trie


@pytest.mark.parametrize("mode", ["MAX", "LOGADD"])
def test_trie_smearing_matches_jax(mode):
    scores = np.random.RandomState(1).uniform(-3, 0, 40).tolist()
    want, got = _tries(jdec, mode, scores), _tries(tdec, mode, scores)
    stack, n = [(want.root, got.root)], 0
    while stack:
        a, b = stack.pop()
        assert sorted(a.children) == sorted(b.children)
        assert (a.labels, a.scores) == (b.labels, b.scores)
        assert a.max_score == b.max_score
        stack += [(a.children[t], b.children[t]) for t in a.children]
        n += 1
    assert n > 40


# -- beams -------------------------------------------------------------------
def _emissions(seed, t=T):
    return (np.random.RandomState(seed).randn(t, V) * 2.0).astype(np.float32)


def _opts(pkg, lm, **kw):
    base = dict(beam_size=25, beam_size_token=V, beam_threshold=30.0,
                lm_weight=1.0 if lm else 0.0, word_score=0.5,
                criterion_type=pkg.CriterionType.CTC)
    base.update(kw)
    return pkg.DecoderOptions(**base)


def _decoder(pkg, native_mod, kind, lm_files, lm, **kw):
    """One decoder of ``pkg`` (the JAX package's or the port's decoder
    module) of ``kind``: lexicon or lexicon-free, Python or native."""
    words, spell = _lexicon()
    opts = _opts(pkg, lm, **kw)
    lexicon = kind.endswith("lexicon")
    lm_path = lm_files["words" if lexicon else "tokens"] if lm else None
    vocab = words if lexicon else [f"t{j:02d}" for j in range(V)]
    if kind.startswith("native"):
        nlm = native_mod.NativeLM(lm_path, usr_vocab=vocab) if lm else None
        trie = None
        if lexicon:
            trie = native_mod.NativeTrie(V)
            plm = pkg.ArpaLM(lm_path, usr_vocab=vocab) if lm else None
            start = plm.start(False) if lm else None
            for i, w in enumerate(words):
                trie.insert(spell[w], i, plm.score(start, i)[1] if lm else 0.0)
            trie.smear("max")
        return native_mod.NativeBeamDecoder(opts, trie, nlm, SIL, BLANK, -1, V,
                                            is_token_lm=not lexicon)
    plm = pkg.ArpaLM(lm_path, usr_vocab=vocab) if lm else pkg.ZeroLM()
    if not lexicon:
        return pkg.LexiconFreeDecoder(opts, plm, SIL, BLANK)
    trie = pkg.Trie(V)
    start = plm.start(False)
    for i, w in enumerate(words):
        trie.insert(spell[w], i, plm.score(start, i)[1] if lm else 0.0)
    trie.smear(pkg.SmearingMode.MAX)
    return pkg.LexiconDecoder(opts, trie, plm, SIL, BLANK, -1)


def _same(got, want, tol=1e-5):
    assert got.tokens == want.tokens
    assert got.words == want.words
    assert abs(got.score - want.score) <= tol
    assert abs(got.am_score - want.am_score) <= tol
    assert abs(got.lm_score - want.lm_score) <= tol


def test_empty_native_results_read_defined_scores(lm_files):
    """A result with no hypothesis behind it reads zeros, the same every time:
    the look-back result of a lexicon beam that saw no frame, and a seq2seq
    beam whose every hypothesis the attention threshold prunes at its first
    step (at most the empty hypothesis to read)."""
    from wav2letter_tpu_torch.decoder.s2s_native import NativeSeq2SeqDecoder

    dec = _decoder(tdec, tnative, "native_lexicon", lm_files, True)
    for _ in range(2):
        dec.decode_begin()
        r = dec.get_best_hypothesis()
        assert (r.score, r.am_score, r.lm_score, r.words, r.tokens) == (0.0, 0.0, 0.0, [], [])
    logp = np.log(np.full((1, 6), 1.0 / 6, np.float32))

    def step(state, toks):  # every hypothesis attends to frame 9 of 10
        return state, np.repeat(logp, len(toks), 0), np.full(len(toks), 9, np.int32)

    s2s = NativeSeq2SeqDecoder(_opts(tdec, False, beam_size=4, beam_size_token=6), 4, step,
                               lambda k: torch.zeros(k, 1), max_output_len=5,
                               attention_threshold=2.0)
    first = s2s.decode(n_best=3)
    assert s2s.decode(n_best=3) == first
    got = [(r.score, r.am_score, r.lm_score, r.tokens) for r in first]
    assert got in ([], [(0.0, 0.0, 0.0, [])])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lm", [False, True], ids=["nolm", "lm"])
@pytest.mark.parametrize("kind", ["lexicon", "lexfree", "native_lexicon", "native_lexfree"])
def test_decode_matches_jax(lm_files, kind, lm, seed):
    """The port's decoder returns the JAX package's DecodeResult (tokens,
    words, scores to 1e-5) on the same emissions, and its n-best list (up to
    3; the lexicon beam keeps only the hypotheses that end a word, where one
    does)."""
    em = _emissions(seed)
    want = _decoder(jdec, jnative, kind, lm_files, lm).decode(em, 3)
    got = _decoder(tdec, tnative, kind, lm_files, lm).decode(em, 3)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("lm", [False, True], ids=["nolm", "lm"])
@pytest.mark.parametrize("kind", ["lexicon", "lexfree"])
def test_native_matches_python_beam(lm_files, kind, lm, seed):
    """In the port, the native decoder finds the Python beam's words, its
    score to 1e-3 (float against double sums)."""
    em = _emissions(seed + 10)
    py = _decoder(tdec, tnative, kind, lm_files, lm).decode(em)[0]
    nat = _decoder(tdec, tnative, "native_" + kind, lm_files, lm).decode(em)[0]
    assert [w for w in py.words if w >= 0] == [w for w in nat.words if w >= 0]
    assert abs(py.score - nat.score) < 1e-3


def test_online_api_matches_batch(lm_files):
    """The native decoder's online API (the one streaming uses): three chunks
    of frames give the batch decode's result, and a look-back query returns
    a prefix of it."""
    em = _emissions(5)
    dec = _decoder(tdec, tnative, "native_lexicon", lm_files, True)
    want = dec.decode(em)[0]
    dec.decode_begin()
    for chunk in np.split(em, [12, 27]):
        dec.decode_step(chunk)
    partial = dec.get_best_hypothesis(look_back=5)
    dec.decode_end()
    got = dec.get_results(1)[0]
    _same(got, want)
    assert len(partial.tokens) <= len(want.tokens)


@pytest.mark.parametrize("fmt", ["bin", "qt"])
def test_binary_lms_decode_as_arpa(lm_files, fmt):
    """The ``.bin`` (probing) and ``.qt`` (quantized trie) conversions of the
    word 3-gram decode as the ARPA does: the same tokens and words, the same
    acoustic score; the LM score equal for ``.bin`` and, for ``.qt``, within
    its 8-bit codebooks' error (0.05 a word, as the JAX package's
    ``test_qt_quantization_error_bounded_and_smaller`` holds it)."""
    words, spell = _lexicon()
    em = _emissions(4)
    results = []
    for path in (lm_files["words"], lm_files[f"words.{fmt}"]):
        lm = tnative.NativeLM(path, usr_vocab=words)
        trie = tnative.NativeTrie(V)
        start = tdec.KenLM(path, usr_vocab=words)
        st = start.start(False)
        for i, w in enumerate(words):
            trie.insert(spell[w], i, start.score(st, i)[1])
        trie.smear("max")
        dec = tnative.NativeBeamDecoder(_opts(tdec, True), trie, lm, SIL, BLANK, -1, V)
        results.append(dec.decode(em)[0])
    want, got = results
    assert got.words == want.words and got.tokens == want.tokens
    assert sum(w >= 0 for w in got.words) >= 3
    assert abs(got.am_score - want.am_score) < 1e-9
    tol = 1e-4 if fmt == "bin" else 0.05 * (sum(w >= 0 for w in got.words) + 1)
    assert abs(got.lm_score - want.lm_score) < tol
    assert abs(got.score - want.score) < tol


@pytest.mark.parametrize("kind", ["lexicon", "native_lexicon"])
def test_topk_rows_decode_as_full_rows(lm_files, kind):
    """Top-k emissions rebuilt as sparse rows (-1e30 elsewhere), as the
    decode's producer ships them, decode as the full rows with
    ``beam_size_token = k`` where every entry the beam reads is shipped: here
    each frame's k largest are the blank, the separator and the tokens of
    two words, and no frame ties at its k-th value. (The blank, the
    separator at the root and a repeated token bypass ``beam_size_token``;
    where one of them falls outside a frame's k, the sparse row gives it
    -1e30 and the decodes part, in the JAX package as here.)"""
    from wav2letter_tpu_torch.runtime.decode import sparse_rows

    _, spell = _lexicon()
    shipped = sorted({SIL, BLANK, *spell["w00"], *spell["w01"]})
    k = len(shipped)
    em = _emissions(6)
    em[:, shipped] += 20.0
    srt = np.sort(em, axis=1)[:, ::-1]
    assert np.all(srt[:, k - 1] > srt[:, k])  # no tie across the k boundary
    vals, idx = torch.topk(torch.from_numpy(em), k, dim=-1)
    assert all(set(row) == set(shipped) for row in idx.tolist())
    sparse = sparse_rows(vals.numpy(), idx.to(torch.int32).numpy(), V)
    full = _decoder(tdec, tnative, kind, lm_files, True, beam_size_token=k).decode(em)[0]
    top = _decoder(tdec, tnative, kind, lm_files, True, beam_size_token=k).decode(sparse)[0]
    assert any(w >= 0 for w in full.words)
    _same(top, full)


# -- FLAC --------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["verbatim", "fixed"])
def test_flac_loads_as_jax(tmp_path, mode):
    from wav2letter_tpu_torch.data.audio import load_audio, load_audio_with_sr

    rng = np.random.RandomState(0)
    samples = (np.sin(np.linspace(0, 200, 9000)) * 12000 + rng.randn(9000) * 50)
    p = tmp_path / f"x_{mode}.flac"
    p.write_bytes(encode_flac([int(s) for s in samples.astype(np.int16)], mode=mode))
    want = jax_load_audio(str(p), 16000)
    got = load_audio(str(p), 16000)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    sr, got2 = load_audio_with_sr(str(p))
    assert sr == 16000 and np.array_equal(got2, want)
    with pytest.raises(ValueError, match="sample rate"):
        load_audio(str(p), 8000)


# -- the native core's build -------------------------------------------------
def test_library_lands_in_build_dir():
    """The ``.so`` lands under ``build/torch_native/`` at the repository
    root, keyed by a hash, and nothing is written beside the sources."""
    pkg_dir = os.path.join(REPO, "wav2letter_tpu_torch", "ops", "native")
    tnative.decoder_lib()
    native_build.flac_lib()
    for name in ("decoder", "flac"):
        so = native_build.library_path(name)
        assert so.parent == native_build.BUILD_DIR
        assert str(so).startswith(os.path.join(REPO, "build", "torch_native", f"lib{name}_"))
        assert so.exists()
    assert sorted(f for f in os.listdir(pkg_dir) if f != "__pycache__") == [
        "__init__.py", "decoder.cpp", "flac.cpp"]


def _failing_compiler(tmp_path):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cxx: simulated compile error' >&2\nexit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    return str(cxx)


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """The native core as it is where the compiler fails: a fresh process's
    cache and a compiler that prints an error and exits 1."""
    monkeypatch.setattr(native_build, "CXX", _failing_compiler(tmp_path))
    monkeypatch.setattr(native_build, "_libs", {})


def test_failed_build_names_compiler_stderr(broken_build):
    with pytest.raises(RuntimeError, match="simulated compile error"):
        native_build.decoder_lib()
    assert not tnative.native_available()


def _decode_inputs(tmp_path):
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import Lexicon, make_token_dict

    (tmp_path / "tokens.txt").write_text("|\na\nb\n")
    (tmp_path / "lexicon.txt").write_text("ab\ta b |\nba\tb a |\n")
    cfg = Config()
    cfg.update(dict(criterion="ctc", uselexicon=True, beamsize=5))
    return (cfg, make_token_dict(str(tmp_path / "tokens.txt"), "ctc", 0, False),
            Lexicon.from_file(str(tmp_path / "lexicon.txt")))


def test_require_native_raises_on_failed_build(broken_build, tmp_path, monkeypatch):
    from wav2letter_tpu_torch.runtime.decode import build_decoder

    monkeypatch.setenv("W2L_REQUIRE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="W2L_REQUIRE_NATIVE=1.*") as e:
        build_decoder(*_decode_inputs(tmp_path))
    assert "simulated compile error" in str(e.value)


def test_fallback_warns_naming_the_exception(broken_build, tmp_path, monkeypatch):
    from wav2letter_tpu_torch.runtime.decode import build_decoder

    monkeypatch.setenv("W2L_REQUIRE_NATIVE", "0")
    with pytest.warns(RuntimeWarning, match="RuntimeError: building decoder.cpp failed"):
        dec, word_dict = build_decoder(*_decode_inputs(tmp_path))
    assert isinstance(dec, tdec.LexiconDecoder) and word_dict is not None
