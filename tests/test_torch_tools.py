"""The port's copies of the tools (``wav2letter_tpu_torch/tools/``) against
their JAX-package originals, on inputs built here at small sizes: each case
runs both copies on the same tree or text and compares what they return and
every byte they write (the output directory's name replaced).

* ``data_prep``: LibriSpeech, MLS, TIMIT with its folding, WSJ, AMI,
  Switchboard/Fisher, Common Voice with its conversion, a Kaldi dir with a
  sox pipe, letter tokens and lexicons, ``lexicon_from_lst``;
* ``wordpiece``: the pieces and their scores, encodings, n-best lists, the
  token and lexicon files;
* ``corpus``: numbers, ordinals, years, roman numerals, pre- and
  post-processing, the title dedup and the Gutenberg chain;
* ``char_lm_eval``: the upper and lower perplexities on a char ARPA;
* ``lm_analysis``: filter, shuffle and the TTS lists at one seed;
* ``ngram_lm.train_counts_arpa`` and ``prod_scale``: the lexicon and ARPA,
  the ``.bin`` and ``.qt`` (scored by both packages' ``NativeLM``);
* ``kenlm_fixture``: its message without the kenlm CLIs.
"""

import json
import os
import wave

import numpy as np
import pytest

from wav2letter_tpu.tools import char_lm_eval as j_char_lm_eval
from wav2letter_tpu.tools import corpus as j_corpus
from wav2letter_tpu.tools import data_prep as j_data_prep
from wav2letter_tpu.tools import kenlm_fixture as j_kenlm_fixture
from wav2letter_tpu.tools import lm_analysis as j_lm_analysis
from wav2letter_tpu.tools import ngram_lm as j_ngram_lm
from wav2letter_tpu.tools import prod_scale as j_prod_scale
from wav2letter_tpu.tools import wordpiece as j_wordpiece
from wav2letter_tpu_torch.tools import char_lm_eval, corpus, data_prep, kenlm_fixture
from wav2letter_tpu_torch.tools import lm_analysis, ngram_lm, prod_scale, wordpiece

SIDES = {
    "jax": dict(data_prep=j_data_prep, wordpiece=j_wordpiece, corpus=j_corpus,
                char_lm_eval=j_char_lm_eval, lm_analysis=j_lm_analysis, ngram_lm=j_ngram_lm,
                prod_scale=j_prod_scale, kenlm_fixture=j_kenlm_fixture),
    "torch": dict(data_prep=data_prep, wordpiece=wordpiece, corpus=corpus,
                  char_lm_eval=char_lm_eval, lm_analysis=lm_analysis, ngram_lm=ngram_lm,
                  prod_scale=prod_scale, kenlm_fixture=kenlm_fixture),
}


def _wav(path, n, sr=16000, seed=0, channels=1):
    rng = np.random.RandomState(seed)
    data = (rng.randn(n * channels) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _files(out):
    """Every file under ``out``: its bytes with ``out`` spelled ``<OUT>``."""
    got = {}
    for dirpath, _, names in os.walk(out):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                got[os.path.relpath(p, out)] = f.read().replace(str(out).encode(), b"<OUT>")
    return got


def _norm(x, out):
    """A return value with ``out`` spelled ``<OUT>`` (list samples as tuples)."""
    if isinstance(x, (list, tuple)):
        return [_norm(v, out) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v, out) for k, v in x.items()}
    if hasattr(x, "sample_id"):
        return (x.sample_id, x.audio_path.replace(str(out), "<OUT>"), x.duration_ms,
                x.transcript)
    if isinstance(x, str):
        return x.replace(str(out), "<OUT>")
    return x


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The corpus trees every data_prep case reads."""
    root = tmp_path_factory.mktemp("trees")
    # LibriSpeech: <split>/<spk>/<chap>/<spk>-<chap>.trans.txt + audio
    for spk, chap, texts in (("19", "198", ["HELLO WORLD", "FOO  BAR Baz"]),
                             ("26", "496", ["A B C"])):
        d = root / "libri" / "train-clean-100" / spk / chap
        d.mkdir(parents=True)
        lines = []
        for i, t in enumerate(texts):
            uid = f"{spk}-{chap}-{i:04d}"
            _wav(d / f"{uid}.wav", 1600 + 160 * i, seed=i)
            lines.append(f"{uid} {t}")
        (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    # MLS: <lang>/<split>/transcripts.txt + audio/<spk>/<book>/<utt>.wav
    base = root / "mls" / "polish" / "dev"
    (base / "audio" / "10" / "20").mkdir(parents=True)
    _wav(base / "audio" / "10" / "20" / "10_20_000001.wav", 2400)
    (base / "transcripts.txt").write_text("10_20_000001\tDzień  Dobry\n"
                                          "10_20_000002\tmissing audio\n")
    # TIMIT: <split>/<dr>/<spk>/*.phn
    d = root / "timit" / "train" / "dr1" / "fcjf0"
    d.mkdir(parents=True)
    _wav(d / "sa1.wav", 3200)
    (d / "sa1.phn").write_text("0 100 h#\n100 200 zh\n200 300 ix\n300 400 q\n400 500 ax-h\n")
    _wav(d / "sx2.wav", 1600, seed=2)
    (d / "sx2.phn").write_text("0 100 pcl\n100 200 ux\n200 300 en\n")
    # WSJ: .ndx over .wv1 paths read as .wav, transcripts in .dot files
    d = root / "wsj" / "wsj0" / "si_tr_s" / "01v"
    d.mkdir(parents=True)
    _wav(d / "01vc0207.wav", 1600)
    _wav(d / "01vc0208.wav", 1760, seed=3)
    (d / "01vc02.dot").write_text("HELLO [NOISE] WORLD. (01vc0207)\n"
                                  "<THE> ~CAT \\SAT (01vc0208)\n")
    (root / "wsj" / "tr.ndx").write_text("; comment\n11_2_1:wsj0/si_tr_s/01v/01vc0207.wv1\n"
                                         "11_2_1:wsj0/si_tr_s/01v/01vc0208.wv1\n")
    # AMI: a words xml and the meeting's audio
    (root / "ami").mkdir()
    (root / "ami" / "m.words.xml").write_text(
        '<nite:root xmlns:nite="http://nite.sourceforge.net/">'
        '<w starttime="0.0" endtime="0.3">hello</w>'
        '<w starttime="0.35" endtime="0.6">world</w>'
        '<w starttime="2.0" endtime="2.4">again</w>'
        '<w starttime="2.5" endtime="2.8">.</w>'
        "</nite:root>")
    np.save(root / "ami" / "meeting.npy",
            np.random.RandomState(4).randn(16000 * 3).astype(np.float32))
    # Switchboard and Fisher transcripts
    (root / "sw.text").write_text("sw2001A-ms98-a-0001 0.50 2.10 HELLO [noise] WORLD\n"
                                  "sw2001A-ms98-a-0002 3.00 4.00 [silence]\n"
                                  "sw2001A-ms98-a-0003 4.00 5.50 UH-HUH [laughter-YEAH] "
                                  "WORLD-\n")
    (root / "fisher.txt").write_text("# header\n12.3 14.5 A: yeah okay\n"
                                     "15.0 16.0 B: [laughter]\n16.0 17.5 B: (( right ))\n")
    # Common Voice: 8 kHz clips, one stereo, and a split tsv
    clips = root / "cv" / "clips"
    clips.mkdir(parents=True)
    _wav(clips / "a.wav", 800, sr=8000)
    _wav(clips / "b.wav", 900, sr=8000, seed=1, channels=2)
    _wav(clips / "c.wav", 800, sr=8000, seed=2)
    (root / "cv" / "dev.tsv").write_text(
        "client_id\tpath\tsentence\n"
        "spk1\ta.wav\tHello, World!\n"
        "spk2\tb.wav\tFoo – bar’s baz…\n"
        "spk3\tc.wav\tHas a Ø weird char\n"
        "spk4\tgone.wav\tno clip\n", encoding="utf-8")
    # Kaldi: wav.scp (a plain path and a sox pipe), segments, text
    src = root / "kaldi"
    src.mkdir()
    from scipy.io import wavfile

    sr = 16000
    t = np.arange(4 * sr) / sr
    mono = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    wavfile.write(str(src / "a.wav"), sr, (mono * 32767).astype(np.int16))
    wavfile.write(str(src / "b.wav"), sr,
                  (np.stack([mono, 0.5 * mono], axis=1) * 32767).astype(np.int16))
    (src / "wav.scp").write_text(f"W1 {src}/a.wav\nW2 sox {src}/b.wav -t wav - remix 1 |\n")
    (src / "segments").write_text("U1 W1 0.50 1.50\nU2 W1 2.00 3.25\nU3 W2 1.00 2.00\n")
    (src / "text").write_text("U1 hello world\nU2 foo bar baz\nU3 quux\n")
    # a list for the token and lexicon builders
    (root / "x.lst").write_text("a /x 100 hello world\nb /y 100 hello there\n"
                                "c /z 100 naïve café hello\n")
    return root


def _prep_case(case, tools, root, out):
    """Run one data_prep case with ``tools`` (one side's modules), writing
    under ``out``; returns what the functions returned."""
    dp = tools["data_prep"]
    if case == "librispeech":
        return dp.prepare_librispeech_split(str(root / "libri"), "train-clean-100",
                                            str(out / "train.lst"))
    if case == "mls":
        return dp.prepare_mls_split(str(root / "mls"), "polish", "dev", str(out / "dev.lst"))
    if case == "timit":
        return [dp.prepare_timit_split(str(root / "timit"), "train", str(out / "timit.lst")),
                dp.fold_phones(["ao", "ax-h", "q", "zh", "b", "pau"])]
    if case == "wsj":
        words = ["HELLO", "[NOISE]", ".", "<THE>", "~CAT", "\\SAT", "DON'T", "*A*", "--DASH"]
        return [dp.prepare_wsj_split(str(root / "wsj"), str(root / "wsj" / "tr.ndx"),
                                     "train", str(out / "wsj.lst")),
                [dp.wsj_normalize_word(w) for w in words],
                dp.parse_wsj_ndx(str(root / "wsj" / "tr.ndx"))]
    if case == "ami":
        words = dp.parse_ami_words_xml(str(root / "ami" / "m.words.xml"))
        return [words, dp.ami_split_segments(words, max_gap_s=0.5),
                dp.prepare_ami_meeting(str(root / "ami" / "m.words.xml"),
                                       str(root / "ami" / "meeting.npy"), "ES2002a",
                                       str(out / "segs"))]
    if case == "swbd_fisher":
        return [dp.parse_swbd_transcript(str(root / "sw.text")),
                dp.parse_fisher_transcript(str(root / "fisher.txt")),
                [dp.swbd_normalize_word(w) for w in ("[noise]", "UH-HUH", "WOR-", "-ING",
                                                     "[laughter-YEAH]", "The")]]
    if case == "commonvoice":
        toks = dp.make_grapheme_tokens(["Hello, World!", "Foo – bar’s baz…"],
                                       str(out / "tokens.txt"))
        n = dp.prepare_commonvoice_split(str(root / "cv" / "dev.tsv"), str(root / "cv" / "clips"),
                                         str(out / "dev.lst"), tokens=toks,
                                         convert_dir=str(out / "conv"))
        return [toks, n, dp.cv_norm_text("Ça – va’ bien?", char_set=None,
                                         replace_set=dp.CV_REPLACE)]
    if case == "kaldi":
        return dp.prepare_kaldi_dir(str(root / "kaldi"), str(out / "kaldi"), name="data.lst",
                                    n_process=2)
    if case == "letters":
        lst = str(root / "x.lst")
        return [dp.make_letter_tokens(str(out / "tokens.txt")),
                dp.make_letter_lexicon([lst], str(out / "lex.txt")),
                dp.make_token_lexicon_from_corpus([lst], str(out / "tok2.txt"),
                                                  str(out / "lex2.txt"))]
    if case == "lexicon_from_lst":
        lst = str(root / "x.lst")
        (out / "tokens.txt").write_text("a\nb\nc\nd\ne\nh\nl\no\nr\nt\nw\n|\n")
        (out / "old.txt").write_text("bar b a r |\n")
        return [dp.lexicon_from_lst(lst, str(out / "tokens.txt"), str(out / "lex.txt"),
                                    n_best=3, min_occ=1),
                dp.lexicon_from_lst(lst, str(out / "tokens.txt"), str(out / "lex_old.txt"),
                                    old_lexicon=str(out / "old.txt")),
                dp.lexicon_from_lst(str(out / "old.txt"), str(out / "tokens.txt"),
                                    str(out / "lex_raw.txt"), raw_text=True)]
    raise AssertionError(case)


PREP_CASES = ["librispeech", "mls", "timit", "wsj", "ami", "swbd_fisher", "commonvoice",
              "kaldi", "letters", "lexicon_from_lst"]


@pytest.mark.parametrize("case", PREP_CASES)
def test_data_prep_matches_jax(trees, tmp_path, case):
    got = {}
    for side, tools in SIDES.items():
        out = tmp_path / side
        out.mkdir()
        res = _prep_case(case, tools, trees, out)
        got[side] = (_norm(res, out), _files(out))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] or case == "swbd_fisher", "the case wrote nothing"


# ---------------------------------------------------------------------------
# wordpiece
# ---------------------------------------------------------------------------
WP_WORDS = ["hello", "help", "world", "word", "held", "helping", "worldly", "wordy", "low",
            "lower", "lowest", "hell", "owl", "dell", "yellow"]


@pytest.fixture(scope="module")
def wp_list(tmp_path_factory):
    rng = np.random.RandomState(5)
    root = tmp_path_factory.mktemp("wp")
    lst = root / "train.lst"
    lines = []
    for i in range(40):
        words = rng.choice(WP_WORDS, rng.randint(2, 7), p=None)
        lines.append(f"u{i} /a{i}.wav 1000 {' '.join(words)}")
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


@pytest.mark.parametrize("vocab_size,max_len", [(20, 6), (40, 4)])
def test_wordpiece_matches_jax(wp_list, tmp_path, vocab_size, max_len):
    got = {}
    for side, tools in SIDES.items():
        wpm = tools["wordpiece"]
        counts = wpm.word_counts_from_lists([wp_list])
        wp = wpm.UnigramWordPiece(vocab_size=vocab_size, max_piece_len=max_len).fit(counts)
        out = tmp_path / side
        out.mkdir()
        toks = wp.save_tokens(counts, str(out / "wp.tokens"))
        wp.save_lexicon(counts.keys(), str(out / "wp.lexicon"), n_best=2)
        wp.save_lexicon(counts.keys(), str(out / "wp1.lexicon"))
        words = WP_WORDS + ["zzz", "yell"]
        got[side] = dict(
            counts=counts, logp=wp.logp, toks=toks, files=_files(out),
            enc={w: wp.encode_word(w) for w in words},
            nbest={w: wp.nbest_word(w, 4) for w in words},
            segs=wpm.nbest_segmentations("helloworld", wp.logp, max_len, 5))
    assert got["torch"] == got["jax"]
    assert len(got["torch"]["logp"]) <= vocab_size


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------
def _corpus_case(case, tools, tmp):
    c = tools["corpus"]
    if case == "numbers":
        ns = list(range(0, 130)) + [999, 1000, 1234, 20019, 1000000, 1200345, 10**9 + 7]
        return [[c.number_to_words(n) for n in ns],
                [c.number_to_ordinal(n) for n in range(1, 130)] + [c.number_to_ordinal(1000)],
                [c.number_to_year(y) for y in (1066, 1900, 1905, 1984, 2000, 2007, 2019, 1600)],
                [c.roman_to_int(r) for r in ("I", "IV", "XIV", "XL", "MCMXCIX", "MMXXIV")],
                [c._int_to_roman(n) for n in (1, 4, 9, 14, 40, 90, 400, 1999)]]
    if case == "roman_errors":
        errs = []
        for bad in ("IIII", "VX", "ABC", "", "IC", "MMMM"):
            try:
                c.roman_to_int(bad)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        return errs
    if case == "lines":
        lines = ["wait 12 min. more", "at 12:30 sharp", "cut 3/4 of it",
                 "Mr. Smith vs. Dr. Jones", "St. Paul and Mrs. Brown", "Chapter II",
                 "Chapter I", "I went home", "in 1905 he left", "the 3rd time",
                 "$ 100 reward", "the dogs ' tails", "well-known & famous", "café résumé",
                 "weird #@%! stuff", "Book XII of 22nd year 1776, 3.5 %"]
        return [[c.preprocess_line(l) for l in lines], [c.postprocess_line(l) for l in lines],
                c.skip_paragraph_markers(["<P>", "text", "", "<P> more"]),
                [c.normalize_lm_text(l) for l in ("Hello, World! it's ME.", "a--b 'c'")],
                c.unique_lines(["b", "a", "b", "c", "a"])]
    if case == "titles":
        return [c.title_match("The Adventures of Tom Sawyer", "adventures of tom sawyer!"),
                c.title_match("Moby Dick", "Pride and Prejudice"),
                c.normalize_title("The  Adventures, of Tom!"),
                c.dedup_corpus_titles(["Moby Dick", "Some Other Book", "moby dik"],
                                      ["moby dick"])]
    if case == "gutenberg":
        books = []
        for i, text in enumerate(["<P>\nChapter I\nMr. Smith went home in 1905\n"
                                  "Mr. Smith went home in 1905\n",
                                  "The 2nd adventure of the well-known hero.\n$ 5 each.\n",
                                  "Should not appear at all.\n"]):
            books.append(str(tmp / f"book{i}.txt"))
            with open(books[-1], "w") as f:
                f.write(text)
        res = c.prepare_gutenberg_corpus(
            books, str(tmp / "corpus.txt"), titles=["A Tale", "Other Story", "The Journey"],
            exclude_titles=["the journey"], vocab_size=5)
        n = c.write_lm_corpus(books[:2], str(tmp / "plain.txt"))
        with open(tmp / "plain.txt") as f:
            vocab = c.build_vocab(f)
        freqs = c.word_frequencies(["a b a", "c a"])
        return [res, n, vocab, freqs, c.kenlm_vocab(freqs, 2)]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["numbers", "roman_errors", "lines", "titles", "gutenberg"])
def test_corpus_matches_jax(tmp_path, case):
    got = {}
    for side, tools in SIDES.items():
        out = tmp_path / side
        out.mkdir()
        got[side] = (_norm(_corpus_case(case, tools, out), out), _files(out))
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# char_lm_eval
# ---------------------------------------------------------------------------
def test_char_lm_eval_matches_jax(tmp_path):
    from wav2letter_tpu.decoder.lm import ArpaLM as JArpaLM
    from wav2letter_tpu_torch.decoder.lm import ArpaLM

    corpus_txt = tmp_path / "c.txt"
    corpus_txt.write_text("the cat\nthe dog\nthe cat sat\na dog sat\n" * 10)
    arpa = tmp_path / "char.arpa"
    ngram_lm.train_ngram_lm(str(corpus_txt), str(arpa), order=4, char_level=True)
    j_arpa = tmp_path / "char_jax.arpa"
    j_ngram_lm.train_ngram_lm(str(corpus_txt), str(j_arpa), order=4, char_level=True)
    assert arpa.read_bytes() == j_arpa.read_bytes()
    sents = [["the", "cat"], ["zzz", "qqq"], ["a", "dog", "sat"]]
    vocab = ["the", "cat", "dog", "sat", "a"]
    lm, jlm = ArpaLM(str(arpa)), JArpaLM(str(arpa))
    for s in sents:
        assert char_lm_eval.upper_word_ppl(lm, [s]) == j_char_lm_eval.upper_word_ppl(jlm, [s])
        assert char_lm_eval.lower_word_ppl(lm, [s], vocab) == \
            j_char_lm_eval.lower_word_ppl(jlm, [s], vocab)
    assert char_lm_eval.upper_word_ppl(lm, sents) == j_char_lm_eval.upper_word_ppl(jlm, sents)
    for w, k in (("hello", 2), ("aaa", 2), ("aaaa", 1), ("abc", 2), ("hello", 0)):
        assert char_lm_eval.transform_asg(w, k) == j_char_lm_eval.transform_asg(w, k)
    assert char_lm_eval.word_to_chars("cat") == j_char_lm_eval.word_to_chars("cat")


# ---------------------------------------------------------------------------
# lm_analysis
# ---------------------------------------------------------------------------
def _align_tree(root):
    """Four utterances and an align file over them in ``cli.align``'s
    format: silences long and short, the first utterance without one (a
    single chunk, which the filter drops)."""
    rng = np.random.RandomState(6)
    lines, lst = [], []
    for u in range(4):
        path = root / f"utt{u}.wav"
        _wav(path, 16000 * 2, seed=u)
        t, ents, words = 0.0, ["0 0 0.00 0.20 $"], []
        t = 0.2
        for w in range(3 + u * 2):
            word = "abcdefg"[rng.randint(7)] * (1 + w % 3)
            ln = 0.1 + 0.05 * rng.randint(3)
            ents.append(f"0 0 {t:.2f} {ln:.2f} {word}")
            words.append(word)
            t += ln
            if w % 2 == 1 and u > 0:
                sil = 0.3 if (u + w) % 3 else 0.05
                ents.append(f"0 0 {t:.2f} {sil:.2f} $")
                t += sil
        lines.append(f"{path}\t" + "\\n".join(ents) + "\n")
        lst.append(f"utt{u} {path} 2000 {' '.join(words)}\n")
    (root / "data.align").write_text("".join(lines))
    (root / "data.lst").write_text("".join(lst))


def test_lm_analysis_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    _align_tree(src)
    got = {}
    for side, tools in SIDES.items():
        la = tools["lm_analysis"]
        out = tmp_path / side
        out.mkdir()
        stats = la.filter_segmentations(str(src / "data.align"), str(src / "data.lst"),
                                        str(out), min_sil=0.13, max_words=4)
        shuf = la.shuffle_segments(stats["filtered_align"], str(out / "shuf"), seed=3,
                                   min_sil=0.13)
        tts = la.generate_shuffled_tts_lists(str(src / "data.lst"), str(out / "tts"),
                                             n_versions=2)
        parsed = [la.parse_align_line(l, 0.13, 0.04)
                  for l in (src / "data.align").read_text().splitlines()]
        stats = {k: dict(v) if isinstance(v, dict) else v for k, v in stats.items()}
        got[side] = (_norm([stats, shuf, tts, parsed], out), _files(out))
    assert got["torch"] == got["jax"]
    assert 1 <= got["torch"][0][0]["kept"] < got["torch"][0][0]["total"] == 4


# ---------------------------------------------------------------------------
# train_counts_arpa and prod_scale
# ---------------------------------------------------------------------------
def test_train_counts_arpa_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    words = [f"w{i}" for i in range(40)]
    text = "\n".join(" ".join(rng.choice(words, rng.randint(1, 9))) for _ in range(300))
    (tmp_path / "c.txt").write_text(text + "\n\n")
    for order, mc in ((3, 1), (4, 2)):
        got = ngram_lm.train_counts_arpa(str(tmp_path / "c.txt"), str(tmp_path / "t.arpa"),
                                         order=order, min_count=mc)
        want = j_ngram_lm.train_counts_arpa(str(tmp_path / "c.txt"),
                                            str(tmp_path / "j.arpa"), order=order,
                                            min_count=mc)
        assert got == want
        assert (tmp_path / "t.arpa").read_bytes() == (tmp_path / "j.arpa").read_bytes()


def test_prod_scale_matches_jax(tmp_path):
    """At 2000 words and 20,000 LM tokens: the lexicon, the ARPA, the
    probing ``.bin`` and the ``.qt`` byte for byte, and the binaries scored
    alike by both packages' ``NativeLM``; the manifest but for its build
    times; a second call reuses the artifacts."""
    from wav2letter_tpu.decoder.native import NativeLM as JNativeLM
    from wav2letter_tpu_torch.decoder.native import NativeLM

    paths = {}
    for side, tools in SIDES.items():
        ps = tools["prod_scale"]
        paths[side] = ps.build_prod_artifacts(str(tmp_path / side), n_lexicon=2000,
                                              lm_tokens=20_000, order=4, seed=0)
    p, j = paths["torch"], paths["jax"]
    for key in ("lexicon", "arpa", "bin", "qt"):
        with open(p[key], "rb") as a, open(j[key], "rb") as b:
            assert a.read() == b.read(), key
    with open(p["manifest"]) as a, open(j["manifest"]) as b:
        ma, mb = json.load(a), json.load(b)
    times = {"gen_s", "arpa_s", "bin_s", "qt_s"}
    assert {k: v for k, v in ma.items() if k not in times} == \
        {k: v for k, v in mb.items() if k not in times}
    assert ma["lexicon_words"] == 2000 and ma["counts"]["4"] > 0
    words = [l.split()[0] for l in open(p["lexicon"])]
    rng = np.random.RandomState(9)
    sents = [list(rng.randint(0, 60, rng.randint(1, 8))) for _ in range(20)]
    for key in ("bin", "qt"):
        lm, jlm = NativeLM(p[key], usr_vocab=words[:60]), JNativeLM(j[key],
                                                                    usr_vocab=words[:60])
        assert lm.used_mmap == 1
        for s in sents:
            assert lm.score_sentence_ids(s) == jlm.score_sentence_ids(s)
    mtime = os.path.getmtime(p["bin"])
    prod_scale.build_prod_artifacts(str(tmp_path / "torch"), n_lexicon=2000,
                                    lm_tokens=20_000, order=4, seed=0)
    assert os.path.getmtime(p["bin"]) == mtime


# ---------------------------------------------------------------------------
# kenlm_fixture
# ---------------------------------------------------------------------------
def test_kenlm_fixture_stops_with_jax_message(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no lmplz, no build_binary
    msgs = []
    for side, tools in SIDES.items():
        with pytest.raises(SystemExit) as e:
            tools["kenlm_fixture"].generate_fixture(str(tmp_path / side))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "lmplz" in msgs[0]
    assert kenlm_fixture._CORPUS == j_kenlm_fixture._CORPUS
    assert kenlm_fixture._QUERIES == j_kenlm_fixture._QUERIES
