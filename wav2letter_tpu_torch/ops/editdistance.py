"""Levenshtein edit distance (token/word error meters).

Reference meters: ``DatasetMeters{tknEdit, wrdEdit}`` (``cpc/Train.cpp:587-650``).
"""

from __future__ import annotations

from typing import Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Plain Levenshtein distance between two sequences (host-side)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def error_counts(ref: Sequence, hyp: Sequence) -> Tuple[int, int]:
    """(edits, ref_len) — accumulate for corpus-level WER/TER."""
    return edit_distance(ref, hyp), len(ref)


def align(ref: Sequence, hyp: Sequence):
    """Levenshtein alignment with backtrace.

    Returns a list of (ref_tok_or_None, hyp_tok_or_None) pairs in order:
    (r, h) match/substitution, (r, None) deletion, (None, h) insertion.
    Used for error-slice analyses (e.g. homophone-pair error rates in the
    convergence soak — the per-word analog of the reference's sclite
    alignment reports)."""
    n, m = len(ref), len(hyp)
    # full DP table (slice analyses run on short utterances)
    d = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        d[i][0] = i
    for j in range(m + 1):
        d[0][j] = j
    for i in range(1, n + 1):
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + cost)
    out = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i][j] == d[i - 1][j - 1] + (
                0 if ref[i - 1] == hyp[j - 1] else 1):
            out.append((ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and d[i][j] == d[i - 1][j] + 1:
            out.append((ref[i - 1], None))
            i -= 1
        else:
            out.append((None, hyp[j - 1]))
            j -= 1
    out.reverse()
    return out
