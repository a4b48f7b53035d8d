"""Real-kenlm compatibility fixture: generator + verifier.

The port's copy of ``wav2letter_tpu/tools/kenlm_fixture.py``, with the same
functions and outputs; where that imports its package it imports the port's
``decoder/lm.py`` (``KenLM``, ``ArpaLM``) and ``tools/ngram_lm.py``.

The native probing-binary reader/writer (``ops/native/decoder.cpp``) was
reconstructed from kenlm's published format; reader and writer round-trip
each other, but byte-compat against a *real* kenlm artifact needs kenlm
to make one. This module makes that validation turnkey the moment
either becomes available:

  * ``generate_fixture(out_dir)`` — run wherever ``kenlm`` (pip) or the
    ``lmplz``/``build_binary`` CLIs exist: trains a tiny 3-gram on a fixed
    corpus, writes ``fixture.arpa`` + ``fixture.bin`` (real kenlm probing
    binary) + ``queries.json`` (sentence -> kenlm full score, from the real
    kenlm scorer). Copy the directory into ``tests/data/kenlm_fixture/``.
  * ``verify_fixture(fixture_dir)`` — loads ``fixture.bin`` through OUR
    native reader and asserts every recorded query score matches; also
    cross-checks the ARPA text reader. Used by
    ``tests/test_native_decoder.py::test_real_kenlm_fixture`` (auto-skipped
    until the fixture exists).

Usage (on a machine with kenlm):
    python -m wav2letter_tpu_torch.tools.kenlm_fixture generate <out_dir>
    # then commit <out_dir>/* as tests/data/kenlm_fixture/
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List

_CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "a cat and a dog ran home",
    "the cat ran to the dog",
    "home is where the cat sat",
    "the dog and the cat sat still",
]

_QUERIES = [
    "the cat sat",
    "the dog ran home",
    "a cat sat on the mat",
    "unknownword the cat",
    "the the the",
    "home",
]


def generate_fixture(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    corpus = os.path.join(out_dir, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(_CORPUS) + "\n")
    arpa = os.path.join(out_dir, "fixture.arpa")
    binp = os.path.join(out_dir, "fixture.bin")
    lmplz = shutil.which("lmplz")
    build_binary = shutil.which("build_binary")
    if not (lmplz and build_binary):
        raise SystemExit(
            "kenlm CLIs (lmplz/build_binary) not found; install kenlm first"
        )
    with open(corpus) as fin, open(arpa, "w") as fout:
        subprocess.run([lmplz, "-o", "3", "--discount_fallback"],
                       stdin=fin, stdout=fout, check=True)
    subprocess.run([build_binary, "probing", arpa, binp], check=True)
    # trie + quantized-trie variants: the
    # reference ecosystem ships .qt decode LMs built with `build_binary
    # trie -q 8 -b 8` (streaming_convnets/librispeech/prepare_lms.sh)
    trie = os.path.join(out_dir, "fixture.trie")
    qt = os.path.join(out_dir, "fixture.qt")
    subprocess.run([build_binary, "trie", arpa, trie], check=True)
    subprocess.run([build_binary, "trie", "-q", "8", "-b", "8", arpa, qt],
                   check=True)
    try:
        import kenlm  # type: ignore

        scores: Dict[str, Dict[str, float]] = {}
        for path, key in ((binp, "probing"), (trie, "trie"), (qt, "qt")):
            model = kenlm.Model(path)
            scores[key] = {
                q: model.score(q, bos=True, eos=True) for q in _QUERIES
            }
    except ImportError:
        raise SystemExit("python kenlm module needed to record query scores")
    with open(os.path.join(out_dir, "queries.json"), "w") as f:
        json.dump(scores, f, indent=1)
    print(f"fixture written to {out_dir}; copy into tests/data/kenlm_fixture/")


def verify_fixture(fixture_dir: str, tol: float = 1e-3) -> List[str]:
    """Returns a list of mismatch descriptions (empty == full compat).

    Probing binaries must parse and match; real-kenlm trie/.qt binaries are
    currently REJECTED by the native reader (our .qt container is
    self-describing, not byte-compatible — ops/native/decoder.cpp:540-560),
    so for those formats the verifier (a) confirms the rejection is clean,
    and (b) checks our own .qt built from the fixture ARPA matches the real
    kenlm query scores to quantization tolerance — scoping the
    incompatibility to the container, not the math."""
    import tempfile

    from ..decoder.lm import ArpaLM, KenLM

    binp = os.path.join(fixture_dir, "fixture.bin")
    arpa = os.path.join(fixture_dir, "fixture.arpa")
    with open(os.path.join(fixture_dir, "queries.json")) as f:
        queries = json.load(f)
    if "probing" not in queries:  # legacy single-format fixture layout
        queries = {"probing": queries}
    blm = KenLM(binp)  # our native reader on the REAL kenlm binary
    alm = ArpaLM(arpa)
    problems = []
    for sent, want in queries["probing"].items():
        words = sent.split()
        got_bin = blm.score_sentence(words)
        got_arpa = alm.score_sentence(words)
        if abs(got_bin - want) > tol:
            problems.append(
                f"bin: {sent!r}: ours={got_bin:.4f} kenlm={want:.4f}")
        if abs(got_arpa - want) > tol:
            problems.append(
                f"arpa: {sent!r}: ours={got_arpa:.4f} kenlm={want:.4f}")
    # real-kenlm trie/.qt: must be rejected cleanly (documented scope)
    for key, fname in (("trie", "fixture.trie"), ("qt", "fixture.qt")):
        path = os.path.join(fixture_dir, fname)
        if not os.path.exists(path):
            continue
        try:
            KenLM(path)
            problems.append(
                f"{key}: native reader accepted a real kenlm {key} binary "
                "— byte-compat now needs verification, extend this check")
        except ValueError:
            pass
    # our own .qt from the same ARPA: scores must match real kenlm's .qt
    # to 8-bit quantization tolerance
    if "qt" in queries:
        from .ngram_lm import build_trie_binary

        with tempfile.TemporaryDirectory() as td:
            ours = os.path.join(td, "ours.qt")
            build_trie_binary(arpa, ours)
            qlm = KenLM(ours)
            for sent, want in queries["qt"].items():
                got = qlm.score_sentence(sent.split())
                qtol = max(tol, 0.05 * (len(sent.split()) + 1))
                if abs(got - want) > qtol:
                    problems.append(
                        f"our-qt: {sent!r}: ours={got:.4f} kenlm-qt={want:.4f}")
    return problems


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "generate":
        generate_fixture(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "verify":
        probs = verify_fixture(sys.argv[2])
        print("\n".join(probs) if probs else "full compat")
        sys.exit(1 if probs else 0)
    else:
        print(__doc__)
        sys.exit(2)
