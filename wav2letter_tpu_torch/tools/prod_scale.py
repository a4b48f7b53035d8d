"""Production-scale decode artifacts: 200k-word lexicon + GB-class 4-gram.

The port's copy of ``wav2letter_tpu/tools/prod_scale.py``, with the same
functions and outputs; where that imports its package it imports the port's
``tools/synth_corpus.py`` and ``tools/ngram_lm.py`` (whose native writers
build the ``.bin`` and ``.qt``).

The reference's headline decode regime is a 200k-word lexicon with a 3 GB
probing 4-gram (or 628 MB quantized trie), mmap'd at startup
(``recipes/streaming_convnets/librispeech/README.md:116-123``,
``prepare_lms.sh``). This builds the equivalent regime over the soak
corpus's tone language so the TRAINED soak AM can decode against it:

* lexicon: the 1k in-language vocabulary + distractor words over the same
  20-letter alphabet up to ``n_lexicon`` entries (real large lexicons are
  mostly rare words the AM never sees — the distractors exercise exactly
  that trie fanout);
* LM corpus: a 50/50 mix of vectorized Markov-chain sentences (keeps the
  homophone-resolving contexts so decode WER stays meaningful) and Zipf
  distractor sentences (drives distinct-n-gram count into the tens of
  millions);
* 4-gram ARPA via ``train_counts_arpa`` -> probing ``.bin`` (mmap) and
  quantized-trie ``.qt`` via the native writers.

Artifacts cache under the given root keyed by a manifest: minutes to build
cold at the full size, O(1) to reuse.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


def build_prod_artifacts(
    root: str,
    n_lexicon: int = 200_000,
    lm_tokens: int = 24_000_000,
    order: int = 4,
    seed: int = 0,
    distractor_frac: float = 0.5,
    force: bool = False,
) -> Dict[str, str]:
    paths = {
        "lexicon": os.path.join(root, "lexicon200k.txt"),
        "arpa": os.path.join(root, "lm4.arpa"),
        "bin": os.path.join(root, "lm4.bin"),
        "qt": os.path.join(root, "lm4.qt"),
        "manifest": os.path.join(root, "manifest.json"),
    }
    want = dict(n_lexicon=n_lexicon, lm_tokens=lm_tokens, order=order,
                seed=seed, distractor_frac=distractor_frac, version=1)
    if not force and os.path.exists(paths["manifest"]):
        with open(paths["manifest"]) as f:
            have = json.load(f)
        if all(have.get(k) == v for k, v in want.items()):
            return paths
    os.makedirs(root, exist_ok=True)
    from .synth_corpus import LETTERS, load_chain, sample_chain_sentences

    t0 = time.time()
    vocab, pairs, chain = load_chain(seed=seed)
    vocab_set = set(vocab)
    rng = np.random.RandomState(seed + 100)

    # --- distractor words (unique, not in-language) --------------------
    n_distract = n_lexicon - len(vocab)
    distract = []
    seen = set(vocab_set)
    letters = np.asarray(LETTERS)
    while len(distract) < n_distract:
        lens = rng.randint(3, 9, 200_000)
        picks = letters[rng.randint(0, len(letters), (200_000, 8))]
        for i in range(200_000):
            w = "".join(picks[i, :lens[i]])
            if w not in seen:
                seen.add(w)
                distract.append(w)
                if len(distract) >= n_distract:
                    break
    all_words = list(vocab) + distract

    with open(paths["lexicon"], "w") as f:
        for w in all_words:
            f.write(f"{w}\t{' '.join(list(w))} |\n")

    # --- LM corpus -----------------------------------------------------
    corpus = os.path.join(root, "lm_corpus_big.txt")
    avg_len = 6.0
    n_chain_sents = int(lm_tokens * (1 - distractor_frac) / avg_len)
    n_dis_tokens = int(lm_tokens * distractor_frac)
    with open(corpus, "w") as f:
        # chain sentences in slabs (keeps peak memory bounded)
        SLAB = 500_000
        done = 0
        while done < n_chain_sents:
            k = min(SLAB, n_chain_sents - done)
            sents = sample_chain_sentences(chain, k, rng)
            f.write("\n".join(
                " ".join(vocab[i] for i in s) for s in sents) + "\n")
            done += k
        # distractor sentences: Zipf over the full 200k lexicon, plus one
        # guaranteed appearance of every word (so every lexicon entry has a
        # unigram)
        aw = np.asarray(all_words)
        zipf = 1.0 / np.arange(1, len(aw) + 1)
        zipf /= zipf.sum()
        perm = rng.permutation(len(aw))
        emitted = 0
        while emitted < n_dis_tokens:
            k = min(2_000_000, n_dis_tokens - emitted)
            ids = rng.choice(len(aw), k, p=zipf)
            toks = aw[perm[ids]]  # permute ranks so ids aren't rank-sorted
            L = 8
            rows = toks[: (len(toks) // L) * L].reshape(-1, L)
            f.write("\n".join(" ".join(r) for r in rows) + "\n")
            emitted += k
        order_pass = aw[rng.permutation(len(aw))]
        rows = order_pass[: (len(order_pass) // 8) * 8].reshape(-1, 8)
        f.write("\n".join(" ".join(r) for r in rows) + "\n")
        f.write(" ".join(order_pass[(len(order_pass) // 8) * 8:]) + "\n")
    gen_s = time.time() - t0

    # --- ARPA + binaries ----------------------------------------------
    from .ngram_lm import build_binary, build_trie_binary, train_counts_arpa

    t1 = time.time()
    counts = train_counts_arpa(corpus, paths["arpa"], order=order)
    arpa_s = time.time() - t1
    t2 = time.time()
    build_binary(paths["arpa"], paths["bin"])
    bin_s = time.time() - t2
    t3 = time.time()
    build_trie_binary(paths["arpa"], paths["qt"])
    qt_s = time.time() - t3

    manifest = {
        **want,
        "counts": counts,
        "total_ngrams": int(sum(counts.values())),
        "lexicon_words": len(all_words),
        "arpa_mb": round(os.path.getsize(paths["arpa"]) / 1e6, 1),
        "bin_mb": round(os.path.getsize(paths["bin"]) / 1e6, 1),
        "qt_mb": round(os.path.getsize(paths["qt"]) / 1e6, 1),
        "gen_s": round(gen_s, 1), "arpa_s": round(arpa_s, 1),
        "bin_s": round(bin_s, 1), "qt_s": round(qt_s, 1),
    }
    json.dump(manifest, open(paths["manifest"], "w"), indent=1)
    # the big text corpus is only needed at build time
    os.remove(corpus)
    return paths


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--n_lexicon", type=int, default=200_000)
    ap.add_argument("--lm_tokens", type=int, default=24_000_000)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    a = ap.parse_args(argv)
    p = build_prod_artifacts(a.root, a.n_lexicon, a.lm_tokens, a.order,
                             force=a.force)
    print(json.dumps(json.load(open(p["manifest"])), indent=1))


if __name__ == "__main__":
    main()
