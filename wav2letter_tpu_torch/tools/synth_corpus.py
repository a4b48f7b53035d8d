"""Convergence-scale synthetic ASR corpus (tone-coded words + homophones):
the port's copy of ``wav2letter_tpu/tools/synth_corpus.py``, numpy and scipy
only. It draws from each ``RandomState`` in the same order as the JAX
package's module, so one seed writes the same corpus through either package,
byte for byte (tokens, lexicon, LM corpus, ``meta.json``, WAV files; the list
files differ only in the root of their audio paths).

The convergence soak (``tools/soak.py``) needs a corpus big enough to train
the flagship AM for thousands of updates and rich enough that the product
chain has real signal: beam+LM decode must beat viterbi, and the
``--lmweight`` sweep must have a real optimum (reference recipes validate
exactly this way, e.g. ``recipes/streaming_convnets/librispeech/README.md:
99-123``).

Design — a 20-letter tone language with built-in acoustic ambiguity:

* Letters ``a..t``. Letters ``a..p`` get 16 distinct log-spaced tones;
  ``q,r,s,t`` ALIAS the tones of ``k,l,m,n``. Acoustically q==k, r==l,
  s==m, t==n — no AM can separate them, ever.
* A vocabulary of ``n_words`` words over the letters, including
  ``n_homophone_pairs`` pairs (A, B) where B is A with ambiguous letters
  swapped to their alias. Both spellings are REAL lexicon words, so the
  lexicon alone cannot rescue them.
* Sentences come from a first-order Markov chain in which a pair's two
  words are reachable from DISJOINT predecessor sets: an n-gram LM
  resolves every homophone from context; viterbi provably cannot (the
  emissions are identical) — the gap between viterbi WER and beam+LM WER
  is therefore a *structural* property of the corpus, not luck.
* Per-letter amplitude/frequency jitter + white noise keep the task
  non-trivial; inter-word silence gives the ``|`` separator acoustic
  support.

Letters are 200 ms (2.5 output frames at the flagship's 80 ms stride),
word gaps 100 ms.

    python -m wav2letter_tpu_torch.tools.synth_corpus --root DIR [--train_hours H ...]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SR = 16000
LETTERS = [chr(ord("a") + i) for i in range(20)]
# q,r,s,t alias k,l,m,n
ALIAS = {"q": "k", "r": "l", "s": "m", "t": "n"}
AMBIG = sorted(ALIAS) + sorted(ALIAS.values())  # letters with a twin
LETTER_S = 0.2
GAP_S = 0.1
EDGE_S = 0.08


def _tone_table() -> Dict[str, float]:
    freqs = np.geomspace(300.0, 3200.0, 16)
    table = {l: float(freqs[i]) for i, l in enumerate(LETTERS[:16])}
    for a, b in ALIAS.items():
        table[a] = table[b]
    return table


TONES = _tone_table()


def make_vocab(rng: np.random.RandomState, n_words: int = 1000,
               n_homophone_pairs: int = 100) -> Tuple[List[str], List[Tuple[str, str]]]:
    """Vocabulary + homophone pairs. Non-pair words avoid the ambiguous
    letters entirely so the base acoustic task is clean."""
    clean_letters = [l for l in LETTERS if l not in AMBIG]  # a..j,o,p
    vocab: set = set()
    pairs: List[Tuple[str, str]] = []
    while len(pairs) < n_homophone_pairs:
        n = rng.randint(3, 8)
        w = "".join(rng.choice(clean_letters, n))
        # plant 1-2 ambiguous base letters (from k,l,m,n)
        k = min(n, rng.randint(1, 3))
        pos = rng.choice(n, k, replace=False)
        chars = list(w)
        for p in pos:
            chars[p] = rng.choice(sorted(ALIAS.values()))
        a = "".join(chars)
        # b: swap EVERY planted letter to its alias
        rev = {v: k2 for k2, v in ALIAS.items()}
        b = "".join(rev.get(c, c) for c in a)
        if a != b and a not in vocab and b not in vocab:
            vocab.add(a)
            vocab.add(b)
            pairs.append((a, b))
    while len(vocab) < n_words:
        n = rng.randint(3, 8)
        w = "".join(rng.choice(clean_letters, n))
        vocab.add(w)
    return sorted(vocab), pairs


class MarkovText:
    """First-order word chain with Zipf unigrams; each homophone pair's two
    words have disjoint predecessor sets (so a bigram+ LM separates them).

    ``n_succ`` governs bigram diversity — the LM-vs-AM asymmetry knob.
    The flagship AM's receptive field covers the preceding word, so with
    few well-covered bigrams the AM itself learns the chain from audio and
    viterbi resolves the "homophones" (measured in the round-4 soak: best
    lmweight 0.0, viterbi 1.27%). With many successors per word, the
    training AUDIO covers each (predecessor, homophone) bigram ~once while
    the much larger TEXT corpus covers it densely: only the LM can resolve
    the pair — the same text >> audio asymmetry that makes LM fusion pay
    on real speech (streaming_convnets README 8.25 -> 7.48)."""

    def __init__(self, vocab: List[str], pairs: List[Tuple[str, str]],
                 rng: np.random.RandomState, n_succ: int = 12):
        self.vocab = vocab
        self.rng = rng
        widx = {w: i for i, w in enumerate(vocab)}
        V = len(vocab)
        zipf = 1.0 / np.arange(1, V + 1)
        order = rng.permutation(V)
        uni = np.empty(V)
        uni[order] = zipf / zipf.sum()
        self.unigram = uni
        pair_words = {w for p in pairs for w in p}
        # sentence starts avoid homophones (their evidence is left context)
        start = uni.copy()
        for w in pair_words:
            start[widx[w]] = 0.0
        self.start = start / start.sum()
        # successor lists
        self.succ: List[np.ndarray] = []
        self.succ_p: List[np.ndarray] = []
        owner: Dict[int, int] = {}  # successor idx -> (pair, side) claimed
        pair_of: Dict[int, Tuple[int, int]] = {}
        for pi, (a, b) in enumerate(pairs):
            pair_of[widx[a]] = (pi, 0)
            pair_of[widx[b]] = (pi, 1)
        for i in range(V):
            cand = rng.choice(V, n_succ * 2, replace=False, p=None)
            chosen: List[int] = []
            claimed: Dict[int, int] = {}
            for c in cand:
                if len(chosen) >= n_succ:
                    break
                c = int(c)
                if c in pair_of:
                    pi, side = pair_of[c]
                    if claimed.get(pi, side) != side:
                        continue  # never both sides after one predecessor
                    claimed[pi] = side
                chosen.append(c)
            self.succ.append(np.asarray(chosen, np.int64))
            p = self.unigram[chosen] + 1e-6
            self.succ_p.append(p / p.sum())

    def sentence(self, n_words: int) -> List[str]:
        rng = self.rng
        i = int(rng.choice(len(self.vocab), p=self.start))
        out = [self.vocab[i]]
        for _ in range(n_words - 1):
            i = int(rng.choice(self.succ[i], p=self.succ_p[i]))
            out.append(self.vocab[i])
        return out


def load_chain(seed: int = 0, n_words: int = 1000,
               n_homophone_pairs: int = 100, n_succ: int = 12):
    """Re-derive the exact (vocab, pairs, chain) a ``generate(seed=...)``
    call used — same RandomState consumption order — so downstream tools
    (prod-scale lexicon/LM builders) can extend the corpus language without
    re-reading the audio."""
    rng = np.random.RandomState(seed)
    vocab, pairs = make_vocab(rng, n_words, n_homophone_pairs)
    chain = MarkovText(vocab, pairs, rng, n_succ=n_succ)
    return vocab, pairs, chain


def sample_chain_sentences(chain: "MarkovText", n_sentences: int,
                           rng: np.random.RandomState,
                           min_words: int = 4, max_words: int = 8) -> "np.ndarray":
    """Vectorized Markov sampling: all sentences step in lock-step via
    per-word successor CDFs (inverse-CDF sampling), ~100x the per-sentence
    Python loop — needed for the tens-of-millions-of-tokens LM corpora.
    Returns an object array of lists of word ids."""
    V = len(chain.vocab)
    n_succ = max(len(s) for s in chain.succ)
    succ = np.zeros((V, n_succ), np.int64)
    cdf = np.ones((V, n_succ), np.float64)
    for i in range(V):
        k = len(chain.succ[i])
        succ[i, :k] = chain.succ[i]
        if k:
            succ[i, k:] = chain.succ[i][-1] if k else 0
            c = np.cumsum(chain.succ_p[i])
            cdf[i, :k] = c
            cdf[i, k:] = 1.0
    lens = rng.randint(min_words, max_words + 1, n_sentences)
    maxlen = int(lens.max())
    cur = rng.choice(V, n_sentences, p=chain.start)
    out = np.zeros((n_sentences, maxlen), np.int64)
    out[:, 0] = cur
    for t in range(1, maxlen):
        u = rng.rand(n_sentences)
        j = (cdf[cur] > u[:, None]).argmax(1)
        cur = succ[cur, j]
        out[:, t] = cur
    return [out[i, :lens[i]].tolist() for i in range(n_sentences)]


def synth_words(rng: np.random.RandomState, words: Sequence[str],
                snr_db: float = 15.0) -> np.ndarray:
    """Render a word sequence to 16 kHz audio: per-letter tone bursts with
    amplitude/frequency jitter, 5 ms raised-cosine edges, inter-word gaps,
    white noise at ``snr_db``."""
    seg = int(LETTER_S * SR)
    gap = int(GAP_S * SR)
    edge = int(EDGE_S * SR)
    ramp_n = int(0.005 * SR)
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(ramp_n) / ramp_n))
    chunks = [np.zeros(edge + rng.randint(0, gap), np.float32)]
    t = np.arange(seg) / SR
    for w in words:
        for l in w:
            f = TONES[l] * (1.0 + 0.005 * rng.randn())
            amp = 0.25 + 0.15 * rng.rand()
            tone = amp * np.sin(2 * np.pi * f * t + 2 * np.pi * rng.rand())
            tone[:ramp_n] *= ramp
            tone[-ramp_n:] *= ramp[::-1]
            chunks.append(tone.astype(np.float32))
        chunks.append(np.zeros(gap + rng.randint(0, gap), np.float32))
    chunks.append(np.zeros(edge, np.float32))
    wav = np.concatenate(chunks)
    sig_p = float(np.mean(wav**2)) + 1e-12
    noise_p = sig_p / (10 ** (snr_db / 10.0))
    wav = wav + np.sqrt(noise_p) * rng.randn(len(wav)).astype(np.float32)
    return np.clip(wav, -1.0, 1.0).astype(np.float32)


def _write_wav(path: str, wav: np.ndarray):
    from scipy.io import wavfile

    wavfile.write(path, SR, (wav * 32767.0).astype(np.int16))


def generate(root: str, train_hours: float = 20.0, dev_minutes: float = 30.0,
             test_minutes: float = 30.0, n_words: int = 1000,
             n_homophone_pairs: int = 100, lm_sentences: int = 50000,
             seed: int = 0, min_words: int = 4, max_words: int = 8,
             snr_db: float = 15.0, n_succ: int = 12,
             force: bool = False) -> Dict[str, str]:
    """Generate the full corpus layout under ``root``:

    train.lst / dev.lst / test.lst  (16-bit wav per utterance)
    tokens.txt ('|' + 20 letters), lexicon.txt (word -> letters |)
    lm_corpus.txt (``lm_sentences`` Markov sentences for n-gram training)
    meta.json (vocab, pairs, sizes)

    Idempotent: returns the existing layout when meta.json matches."""
    meta_path = os.path.join(root, "meta.json")
    want = dict(train_hours=train_hours, dev_minutes=dev_minutes,
                test_minutes=test_minutes, n_words=n_words,
                n_homophone_pairs=n_homophone_pairs, seed=seed,
                lm_sentences=lm_sentences, min_words=min_words,
                max_words=max_words, snr_db=snr_db, n_succ=n_succ,
                version=3)
    paths = {
        "train": os.path.join(root, "train.lst"),
        "dev": os.path.join(root, "dev.lst"),
        "test": os.path.join(root, "test.lst"),
        "tokens": os.path.join(root, "tokens.txt"),
        "lexicon": os.path.join(root, "lexicon.txt"),
        "lm_corpus": os.path.join(root, "lm_corpus.txt"),
        "meta": meta_path,
    }
    if not force and os.path.exists(meta_path):
        try:
            have = json.load(open(meta_path))
            if all(have.get(k) == v for k, v in want.items()):
                return paths
        except Exception:
            pass

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    vocab, pairs = make_vocab(rng, n_words, n_homophone_pairs)
    chain = MarkovText(vocab, pairs, rng, n_succ=n_succ)

    with open(paths["tokens"], "w") as f:
        f.write("|\n" + "\n".join(LETTERS) + "\n")
    with open(paths["lexicon"], "w") as f:
        for w in vocab:
            f.write(f"{w}\t{' '.join(list(w))} |\n")

    def make_split(tag: str, total_s: float, split_seed: int) -> str:
        srng = np.random.RandomState(split_seed)
        schain = MarkovText(vocab, pairs, srng)
        # share the SAME chain structure across splits: rebuild with the
        # corpus seed for transitions but a split rng for sampling
        schain.succ, schain.succ_p = chain.succ, chain.succ_p
        schain.start, schain.unigram = chain.start, chain.unigram
        audio_dir = os.path.join(root, tag)
        os.makedirs(audio_dir, exist_ok=True)
        lines = []
        acc = 0.0
        i = 0
        while acc < total_s:
            words = schain.sentence(srng.randint(min_words, max_words + 1))
            wav = synth_words(srng, words, snr_db=snr_db)
            uid = f"{tag}{i:06d}"
            p = os.path.join(audio_dir, f"{uid}.wav")
            _write_wav(p, wav)
            dur_ms = 1000.0 * len(wav) / SR
            lines.append(f"{uid} {p} {dur_ms:.1f} {' '.join(words)}")
            acc += len(wav) / SR
            i += 1
        out = paths[tag]
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        return out

    make_split("train", train_hours * 3600.0, seed + 1)
    make_split("dev", dev_minutes * 60.0, seed + 2)
    make_split("test", test_minutes * 60.0, seed + 3)

    with open(paths["lm_corpus"], "w") as f:
        trng = np.random.RandomState(seed + 4)
        tchain = MarkovText(vocab, pairs, trng)
        tchain.succ, tchain.succ_p = chain.succ, chain.succ_p
        tchain.start, tchain.unigram = chain.start, chain.unigram
        for _ in range(lm_sentences):
            f.write(" ".join(tchain.sentence(trng.randint(min_words, max_words + 1))) + "\n")

    with open(meta_path, "w") as f:
        json.dump({**want, "vocab_size": len(vocab),
                   "pairs": pairs[:20], "n_pairs": len(pairs)}, f, indent=1)
    return paths


def main(argv: Optional[List[str]] = None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--train_hours", type=float, default=20.0)
    ap.add_argument("--dev_minutes", type=float, default=30.0)
    ap.add_argument("--test_minutes", type=float, default=30.0)
    ap.add_argument("--n_words", type=int, default=1000)
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--lm_sentences", type=int, default=50000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    a = ap.parse_args(argv)
    paths = generate(a.root, a.train_hours, a.dev_minutes, a.test_minutes,
                     a.n_words, a.pairs, a.lm_sentences, a.seed, force=a.force)
    print(json.dumps(paths, indent=1))


def generate_homophone_slice(root: str, out_tag: str = "homo_eval",
                             n_utts: int = 150, min_pairs: int = 2,
                             seed_offset: int = 5) -> str:
    """Homophone-heavy evaluation slice: rejection-
    sample sentences from the SAME Markov chain until each contains
    >= ``min_pairs`` homophone-pair tokens, synth audio, write
    ``<root>/<out_tag>.lst``. The slice concentrates the corpus's
    structural ambiguity so the viterbi-vs-beam+LM comparison has real
    statistics (~n_utts*min_pairs pair tokens instead of the natural
    ~1% share), while the chain/LM distribution is untouched — the LM
    was trained on the true distribution and is not being handed a
    biased training set."""
    meta = json.load(open(os.path.join(root, "meta.json")))
    vocab, pairs, chain = load_chain(
        meta["seed"], meta["n_words"], meta["n_homophone_pairs"],
        meta.get("n_succ", 12))
    pair_words = {w for p in pairs for w in p}
    srng = np.random.RandomState(meta["seed"] + seed_offset)
    schain = MarkovText(vocab, pairs, srng)
    schain.succ, schain.succ_p = chain.succ, chain.succ_p
    schain.start, schain.unigram = chain.start, chain.unigram
    audio_dir = os.path.join(root, out_tag)
    os.makedirs(audio_dir, exist_ok=True)
    lines = []
    i = tries = 0
    while i < n_utts:
        tries += 1
        if tries > n_utts * 5000:
            raise RuntimeError(
                f"homophone slice: {i}/{n_utts} after {tries} samples — "
                f"chain cannot produce >= {min_pairs} pair tokens/sentence")
        words = schain.sentence(srng.randint(
            meta["min_words"], meta["max_words"] + 1))
        if sum(1 for w in words if w in pair_words) < min_pairs:
            continue
        wav = synth_words(srng, words, snr_db=meta["snr_db"])
        uid = f"{out_tag}{i:06d}"
        p = os.path.join(audio_dir, f"{uid}.wav")
        _write_wav(p, wav)
        dur_ms = 1000.0 * len(wav) / SR
        lines.append(f"{uid} {p} {dur_ms:.1f} {' '.join(words)}")
        i += 1
    out = os.path.join(root, f"{out_tag}.lst")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out


if __name__ == "__main__":
    main()
