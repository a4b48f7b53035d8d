"""Unigram-LM wordpiece training + segmentation.

The port's copy of ``wav2letter_tpu/tools/wordpiece.py``, with the same
functions and outputs; where that imports its package it imports the port's
``data/listfile.py``.

The reference trains a 10k-unigram SentencePiece model and derives nbest-10
wordpiece lexicons (``recipes/utilities/
prepare_librispeech_wp_and_official_lexicon.py:75-180``). sentencepiece is
not a dependency, so this module implements the unigram-LM algorithm
natively (Kudo 2018, simplified): substring seed vocab -> EM (Viterbi hard
assignment) -> prune by likelihood contribution -> final piece set; plus
Viterbi and n-best segmentation for lexicon generation.

Convention matches the reference lexicons: pieces carry a leading ``_`` on
the word-initial piece (``_the``, ``_th e``), ``--usewordpiece=true``.
"""

from __future__ import annotations

import heapq
import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WORD_BOUNDARY = "_"


def _viterbi_segment(
    word: str, logp: Dict[str, float], max_len: int
) -> Tuple[List[str], float]:
    """Best segmentation of ``word`` under piece log-probs."""
    n = len(word)
    best = [-math.inf] * (n + 1)
    back = [0] * (n + 1)
    best[0] = 0.0
    for i in range(1, n + 1):
        for j in range(max(0, i - max_len), i):
            piece = word[j:i]
            lp = logp.get(piece)
            if lp is None:
                continue
            s = best[j] + lp
            if s > best[i]:
                best[i] = s
                back[i] = j
    if best[n] == -math.inf:
        # fall back to chars (always in vocab)
        return list(word), sum(logp.get(c, -20.0) for c in word)
    pieces = []
    i = n
    while i > 0:
        j = back[i]
        pieces.append(word[j:i])
        i = j
    return pieces[::-1], best[n]


def nbest_segmentations(
    word: str, logp: Dict[str, float], max_len: int, n_best: int = 10
) -> List[Tuple[List[str], float]]:
    """N-best segmentations via beam over prefix positions."""
    n = len(word)
    # beams[i] = list of (score, pieces) reaching position i
    beams: List[List[Tuple[float, Tuple[str, ...]]]] = [[] for _ in range(n + 1)]
    beams[0] = [(0.0, ())]
    for i in range(1, n + 1):
        cands: List[Tuple[float, Tuple[str, ...]]] = []
        for j in range(max(0, i - max_len), i):
            piece = word[j:i]
            lp = logp.get(piece)
            if lp is None:
                continue
            for s, pieces in beams[j]:
                cands.append((s + lp, pieces + (piece,)))
        beams[i] = heapq.nlargest(n_best, cands)
    return [(list(p), s) for s, p in beams[n]]


class UnigramWordPiece:
    def __init__(self, vocab_size: int = 10000, max_piece_len: int = 16):
        self.vocab_size = vocab_size
        self.max_piece_len = max_piece_len
        self.logp: Dict[str, float] = {}

    # -- training ----------------------------------------------------------
    def fit(
        self,
        word_counts: Dict[str, int],
        n_iters: int = 4,
        seed_size_mult: int = 4,
        prune_frac: float = 0.2,
    ) -> "UnigramWordPiece":
        # seed: all substrings up to max_piece_len weighted by freq
        sub_counts: Counter = Counter()
        for w, c in word_counts.items():
            L = len(w)
            for i in range(L):
                for j in range(i + 1, min(L, i + self.max_piece_len) + 1):
                    sub_counts[w[i:j]] += c
        chars = {ch for w in word_counts for ch in w}
        seed_n = max(self.vocab_size * seed_size_mult, len(chars) + 1)
        seeds = dict(sub_counts.most_common(seed_n))
        for ch in chars:  # single chars always kept
            seeds.setdefault(ch, 1)
        total = sum(seeds.values())
        self.logp = {p: math.log(c / total) for p, c in seeds.items()}

        while True:
            # EM (hard): segment all words, recount piece usage
            for _ in range(n_iters):
                counts: Counter = Counter()
                for w, c in word_counts.items():
                    pieces, _ = _viterbi_segment(w, self.logp, self.max_piece_len)
                    for p in pieces:
                        counts[p] += c
                tot = sum(counts.values()) or 1
                new_logp = {}
                for p in self.logp:
                    cc = counts.get(p, 0)
                    if cc > 0 or len(p) == 1:
                        new_logp[p] = math.log(max(cc, 0.5) / tot)
                self.logp = new_logp
            if len(self.logp) <= self.vocab_size:
                break
            # prune lowest-likelihood-contribution pieces (keep chars)
            multi = [(self.logp[p], p) for p in self.logp if len(p) > 1]
            multi.sort()
            n_prunable = len(self.logp) - self.vocab_size
            n_drop = max(1, min(n_prunable, int(len(multi) * prune_frac)))
            for _, p in multi[:n_drop]:
                del self.logp[p]
        return self

    # -- encoding ----------------------------------------------------------
    def encode_word(self, word: str) -> List[str]:
        pieces, _ = _viterbi_segment(word, self.logp, self.max_piece_len)
        return [WORD_BOUNDARY + pieces[0]] + pieces[1:]

    def nbest_word(self, word: str, n_best: int = 10) -> List[List[str]]:
        segs = nbest_segmentations(word, self.logp, self.max_piece_len, n_best)
        return [[WORD_BOUNDARY + p[0]] + p[1:] for p, _ in segs]

    # -- artifacts ---------------------------------------------------------
    def token_set(self, word_counts: Dict[str, int]) -> List[str]:
        """All pieces as they appear in encoded text (with/without ``_``)."""
        toks = set()
        for w in word_counts:
            for p in self.encode_word(w):
                toks.add(p)
        return sorted(toks)

    def save_tokens(self, word_counts: Dict[str, int], path: str) -> List[str]:
        toks = self.token_set(word_counts)
        with open(path, "w") as f:
            f.write("\n".join(toks) + "\n")
        return toks

    def save_lexicon(
        self, words: Iterable[str], path: str, n_best: int = 1
    ) -> None:
        """Wordpiece lexicon: one line per (word, segmentation)
        (reference nbest-10 lexicons, prepare_..._wp:152-168)."""
        with open(path, "w") as f:
            for w in sorted(set(words)):
                segs = self.nbest_word(w, n_best) if n_best > 1 else [self.encode_word(w)]
                seen = set()
                for sp in segs:
                    key = tuple(sp)
                    if key in seen:
                        continue
                    seen.add(key)
                    f.write(f"{w}\t{' '.join(sp)}\n")


def word_counts_from_lists(lst_files: Sequence[str]) -> Dict[str, int]:
    from ..data.listfile import read_list_file

    counts: Counter = Counter()
    for lst in lst_files:
        for s in read_list_file(lst):
            counts.update(s.words)
    return dict(counts)
