"""N-gram language model training -> ARPA files: the port's copy of
``wav2letter_tpu/tools/ngram_lm.py``.

The reference shells out to KenLM's ``lmplz``/``build_binary``
(``recipes/lexicon_free/librispeech/train_ngram_lms.sh:15-42``,
``recipes/utilities/prepare_librispeech_official_lm.py``); this module is the
native equivalent: interpolated modified Kneser-Ney (the KenLM default) with
count pruning, writing standard ARPA that ``decoder.lm.ArpaLM`` (and KenLM)
reads. Suitable for char LMs (5-20 gram) and word LMs up to the sizes the
recipes use.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LOG10E = math.log10(math.e)
BOS, EOS, UNK = "<s>", "</s>", "<unk>"


def count_ngrams(
    sentences: Iterable[Sequence[str]], order: int
) -> List[Counter]:
    """counts[n-1][(w1..wn)] over BOS-padded sentences."""
    counts: List[Counter] = [Counter() for _ in range(order)]
    for sent in sentences:
        toks = [BOS] + list(sent) + [EOS]
        L = len(toks)
        for i in range(1, L):
            for n in range(1, order + 1):
                if i - n + 1 < 0:
                    break
                gram = tuple(toks[i - n + 1 : i + 1])
                counts[n - 1][gram] += 1
        counts[0][(BOS,)] += 1
    return counts


class KneserNeyLM:
    """Interpolated Kneser-Ney with fixed discount per order."""

    def __init__(self, order: int = 3, discount: float = 0.75,
                 prune_thresholds: Optional[Sequence[int]] = None):
        self.order = order
        self.discount = discount
        self.prune = list(prune_thresholds or [0] * order)
        while len(self.prune) < order:
            self.prune.append(0)
        self.probs: List[Dict[Tuple[str, ...], float]] = []
        self.backoffs: List[Dict[Tuple[str, ...], float]] = []
        self.vocab: List[str] = []

    # -- training ----------------------------------------------------------
    def fit(self, sentences: Iterable[Sequence[str]]) -> "KneserNeyLM":
        order = self.order
        counts = count_ngrams(sentences, order)
        # prune (except unigrams)
        for n in range(1, order):
            thr = self.prune[n]
            if thr > 0:
                counts[n] = Counter(
                    {g: c for g, c in counts[n].items() if c > thr}
                )
        vocab = sorted({g[0] for g in counts[0]} | {UNK})
        self.vocab = vocab
        D = self.discount

        # continuation counts for lower orders (KN): N1+(* w) etc.
        cont: List[Counter] = [Counter() for _ in range(order)]
        for n in range(1, order):
            for gram in counts[n]:
                cont[n - 1][gram[1:]] += 1

        probs: List[Dict] = [dict() for _ in range(order)]
        backoffs: List[Dict] = [dict() for _ in range(order)]

        # highest order: p(w|h) = max(c-D,0)/c(h) + D*N1+(h*)/c(h) * p_lower
        # computed top-down storing interpolated probs directly.
        def ctx_totals(n: int) -> Tuple[Dict, Dict]:
            tot = defaultdict(float)
            ntypes = defaultdict(int)
            for gram, c in counts[n].items():
                tot[gram[:-1]] += c
                ntypes[gram[:-1]] += 1
            return tot, ntypes

        # unigram KN: continuation probability
        cont_uni = cont[0] if order > 1 else counts[0]
        total_cont = sum(cont_uni.values()) or 1
        uni_p: Dict[Tuple[str, ...], float] = {}
        n_vocab = len(vocab)
        for w in vocab:
            c = cont_uni.get((w,), 0)
            uni_p[(w,)] = max(c - D, 0) / total_cont + (
                D * len(cont_uni) / total_cont
            ) * (1.0 / n_vocab)
        # BOS is never predicted; ARPA convention gives it logprob -99
        probs[0] = uni_p

        def p_lower(gram: Tuple[str, ...]) -> float:
            n = len(gram)
            if n == 1:
                return probs[0].get(gram, probs[0].get((UNK,), 1.0 / n_vocab))
            p = probs[n - 1].get(gram)
            if p is not None:
                return p
            bo = backoffs[n - 2].get(gram[:-1], 1.0)
            return bo * p_lower(gram[1:])

        # fill orders 2..order bottom-up so lower-order probs exist
        for n in range(2, order + 1):
            src = counts[n - 1]
            tot, ntypes = ctx_totals(n - 1)
            for gram, c in src.items():
                h = gram[:-1]
                T = tot[h]
                lam = D * ntypes[h] / T
                probs[n - 1][gram] = max(c - D, 0) / T + lam * p_lower(gram[1:])
            for h in tot:
                backoffs[n - 2][h] = D * ntypes[h] / tot[h]

        self.probs = probs
        self.backoffs = backoffs
        return self

    # -- ARPA output -------------------------------------------------------
    def write_arpa(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\\data\\\n")
            sizes = []
            for n in range(self.order):
                size = len(self.probs[n]) if n > 0 else len(self.vocab)
                sizes.append(size)
                f.write(f"ngram {n + 1}={size}\n")
            f.write("\n")
            for n in range(self.order):
                f.write(f"\\{n + 1}-grams:\n")
                if n == 0:
                    for w in self.vocab:
                        p = self.probs[0].get((w,), 1e-10)
                        lp = -99.0 if w == BOS else math.log10(max(p, 1e-99))
                        bo = self.backoffs[0].get((w,)) if self.order > 1 else None
                        if bo is not None and bo < 1.0:
                            f.write(f"{lp:.6f}\t{w}\t{math.log10(max(bo,1e-99)):.6f}\n")
                        else:
                            f.write(f"{lp:.6f}\t{w}\n")
                else:
                    for gram in sorted(self.probs[n]):
                        p = self.probs[n][gram]
                        lp = math.log10(max(p, 1e-99))
                        bo = (
                            self.backoffs[n].get(gram)
                            if n < self.order - 1
                            else None
                        )
                        if bo is not None and bo < 1.0:
                            f.write(
                                f"{lp:.6f}\t{' '.join(gram)}\t"
                                f"{math.log10(max(bo, 1e-99)):.6f}\n"
                            )
                        else:
                            f.write(f"{lp:.6f}\t{' '.join(gram)}\n")
                f.write("\n")
            f.write("\\end\\\n")


def train_ngram_lm(
    corpus_path: str,
    out_arpa: str,
    order: int = 3,
    char_level: bool = False,
    word_separator: str = "|",
    prune: Optional[Sequence[int]] = None,
) -> KneserNeyLM:
    """Train from a text corpus (one sentence per line). ``char_level``
    produces the lexicon-free recipes' char LMs: words spelled as chars
    joined by the separator token (``train_ngram_lms.sh`` pipeline)."""

    def sentences():
        with open(corpus_path) as f:
            for line in f:
                words = line.strip().lower().split()
                if not words:
                    continue
                if char_level:
                    toks: List[str] = []
                    for i, w in enumerate(words):
                        toks.extend(list(w))
                        if i < len(words) - 1:
                            toks.append(word_separator)
                    yield toks
                else:
                    yield words

    lm = KneserNeyLM(order=order, prune_thresholds=prune)
    lm.fit(sentences())
    lm.write_arpa(out_arpa)
    return lm


def perplexity(arpa_path: str, sentences: Iterable[Sequence[str]]) -> float:
    """Corpus perplexity with an ArpaLM (10^(-avg log10 p)); the analog of
    the reference's kenlm ppl tooling (compute_upper_ppl_kenlm.py)."""
    from ..decoder.lm import ArpaLM, LMState

    lm = ArpaLM(arpa_path)
    total_lp = 0.0
    total_n = 0
    for sent in sentences:
        total_lp += lm.score_sentence([w.lower() for w in sent])
        total_n += len(sent) + 1  # + </s>
    return 10 ** (-total_lp / max(1, total_n))


def build_binary(arpa_path: str, out_bin: str, probing_multiplier: float = 1.5) -> str:
    """ARPA text -> KenLM probing-format binary via the native core — the
    analog of kenlm's ``build_binary`` used throughout the reference recipes
    (e.g. streaming_convnets/librispeech/prepare_lms.sh). The result loads
    through ``decoder.lm.KenLM`` / the native decoder (--lm=*.bin)."""
    from ..ops.native import decoder_lib

    lib = decoder_lib()
    if not lib.w2l_lm_build_binary(
        arpa_path.encode(), out_bin.encode(), probing_multiplier
    ):
        raise RuntimeError(f"build_binary failed for {arpa_path}")
    return out_bin


def build_trie_binary(arpa_path: str, out_qt: str) -> str:
    """ARPA text -> quantized-trie binary (.qt): the small-footprint decode
    format, the analog of kenlm's ``build_binary trie -q 8 -b 8`` the
    reference uses for its 13MB streaming decode LM
    (streaming_convnets/librispeech/prepare_lms.sh, README.md:116-123).
    Sorted suffix trie + bit-packed records + 8-bit equal-population prob/
    backoff codebooks; loads through ``decoder.lm.KenLM`` / the native
    decoder (``--lm=*.qt``) via magic sniffing."""
    from ..ops.native import decoder_lib

    lib = decoder_lib()
    if not lib.w2l_lm_build_trie(arpa_path.encode(), out_qt.encode()):
        raise RuntimeError(f"build_trie_binary failed for {arpa_path}")
    return out_qt


# ---------------------------------------------------------------------------
# Production-scale counts LM (tens of millions of n-grams)
# ---------------------------------------------------------------------------

def train_counts_arpa(
    corpus_path: str,
    out_arpa: str,
    order: int = 4,
    backoff: float = 0.4,
    min_count: int = 1,
) -> Dict[str, int]:
    """Corpus -> ARPA at production scale (tens of millions of n-grams) via
    vectorized numpy counting + stupid-backoff scores.

    The pure-Python Kneser-Ney above tops out around ~1M n-grams; the
    reference's decode regime is a 200k-vocab multi-GB 4-gram built by
    kenlm's ``lmplz`` (streaming_convnets/librispeech/prepare_lms.sh). This
    is the scale path: sentence-bounded n-gram windows are counted with
    ``np.unique`` over packed id arrays (O(n log n), no Python loops) and
    scored with maximum-likelihood probs + a constant backoff ("stupid
    backoff", Brants et al. 2007 — the standard web-scale choice; unlike KN
    it needs no discount statistics pass). The ARPA it writes loads through
    every reader here (ArpaLM, native NgramLM, build_binary -> probing,
    build_trie_binary -> .qt).

    Returns {order: n_entries} counts. Words are whitespace tokens; <s>/</s>
    are added per line."""
    import numpy as np

    vocab: Dict[str, int] = {BOS: 0, EOS: 1}
    sents: List[List[int]] = []
    with open(corpus_path) as f:
        for line in f:
            ws = line.split()
            if not ws:
                continue
            row = [0]
            for w in ws:
                i = vocab.setdefault(w, len(vocab))
                row.append(i)
            row.append(1)
            sents.append(row)
    words = [None] * len(vocab)
    for w, i in vocab.items():
        words[i] = w
    # flat token array + sentence ids for window validity
    lens = np.asarray([len(s) for s in sents], np.int64)
    flat = np.concatenate([np.asarray(s, np.int32) for s in sents])
    sid = np.repeat(np.arange(len(sents), dtype=np.int32), lens)
    N = len(flat)

    log = math.log10
    lines_per_order: Dict[int, Tuple] = {}
    counts_per_order: Dict[int, int] = {}
    # context-count lookup built order-by-order: p(w|ctx) = c(ngram)/c(ctx)
    ctx_counts: Dict[int, Tuple] = {}  # n -> (sorted unique rows, counts)

    def pack(rows):
        """Lexicographic unique over 2D int32 via void view (fast path)."""
        a = np.ascontiguousarray(rows)
        v = a.view([("", a.dtype)] * a.shape[1]).ravel()
        uq, cnt = np.unique(v, return_counts=True)
        return uq.view(a.dtype).reshape(-1, a.shape[1]), cnt

    for n in range(1, order + 1):
        if N < n:
            break
        w = np.lib.stride_tricks.sliding_window_view(flat, n)
        s0 = sid[: N - n + 1]
        s1 = sid[n - 1:]
        # windows must stay within one sentence; <s>/</s> placement is
        # then automatically valid (<s> only ever first, </s> only last)
        valid = s0 == s1
        grams = w[valid]
        uq, cnt = pack(grams)
        if min_count > 1 and n == order:
            keep = cnt >= min_count
            uq, cnt = uq[keep], cnt[keep]
        counts_per_order[n] = len(uq)
        lines_per_order[n] = (uq, cnt)
        ctx_counts[n] = (uq, cnt)

    # probability: c(gram)/c(context); context counts via searchsorted into
    # the previous order's unique table
    def ctx_lookup(rows, n_ctx):
        uq, cnt = ctx_counts[n_ctx]
        a = np.ascontiguousarray(rows)
        v = a.view([("", a.dtype)] * a.shape[1]).ravel()
        base = uq.view([("", uq.dtype)] * uq.shape[1]).ravel()
        idx = np.searchsorted(base, v)
        idx = np.clip(idx, 0, len(base) - 1)
        hit = base[idx] == v
        out = np.where(hit, cnt[idx], 1)
        return out.astype(np.float64)

    lb = log(backoff)
    with open(out_arpa, "w") as f:
        f.write("\\data\\\n")
        for n in range(1, order + 1):
            if n in counts_per_order:
                f.write(f"ngram {n}={counts_per_order[n]}\n")
        f.write("\n")
        tot1 = float(sum(ctx_counts[1][1]))
        for n in range(1, order + 1):
            if n not in lines_per_order:
                continue
            uq, cnt = lines_per_order[n]
            f.write(f"\\{n}-grams:\n")
            if n == 1:
                p = np.log10(cnt / tot1)
            else:
                ctx = ctx_lookup(uq[:, :-1], n - 1)
                p = np.log10(cnt / ctx)
            has_bo = n < order
            # chunked text assembly (tens of millions of rows)
            CH = 500_000
            for s in range(0, len(uq), CH):
                rows = uq[s:s + CH]
                ps = p[s:s + CH]
                buf = []
                for i in range(len(rows)):
                    g = " ".join(words[t] for t in rows[i])
                    if has_bo:
                        buf.append(f"{ps[i]:.4f}\t{g}\t{lb:.4f}")
                    else:
                        buf.append(f"{ps[i]:.4f}\t{g}")
                f.write("\n".join(buf) + "\n")
            f.write("\n")
        f.write("\\end\\\n")
    return counts_per_order
