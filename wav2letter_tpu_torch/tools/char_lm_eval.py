"""Char-LM ↔ word-LM perplexity comparison tools.

The port's copy of ``wav2letter_tpu/tools/char_lm_eval.py``, with the same
functions and outputs; where that imports its package it imports the port's
``decoder/lm.py``.

Reference: ``recipes/lexicon_free/utilities/`` (974 LoC:
``compute_upper_ppl_kenlm.py:25-60``, ``compute_lower_ppl_kenlm.py``,
``utils.py:32-52``, ``transform_asg``): character-level LMs are compared to
word LMs by computing word-level perplexity bounds — the **upper** bound
scores each word by its single canonical spelling (an under-estimate of
P(word), hence upper ppl bound); the **lower** bound additionally
marginalizes over word-boundary ambiguity. Also includes the ASG replabel
text transform (``transform_asg``: "hello" -> "helo1" run-length encoding).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence

from ..decoder.lm import ArpaLM, LMState

LOG10 = math.log(10.0)


def transform_asg(word: str, replabel: int = 2) -> str:
    """Run-length encode repeats for ASG text LMs (reference transform_asg):
    'hello' -> 'hel1o' (with replabel>=1: 'll' -> 'l1')."""
    if replabel <= 0:
        return word
    out: List[str] = []
    i = 0
    while i < len(word):
        ch = word[i]
        run = 1
        while i + run < len(word) and word[i + run] == ch and run <= replabel:
            run += 1
        out.append(ch)
        if run > 1:
            out.append(str(run - 1))
        i += run
    return "".join(out)


def word_to_chars(word: str, word_separator: str = "|") -> List[str]:
    return list(word) + [word_separator]


def score_word_chars(
    lm: ArpaLM, state: LMState, chars: Sequence[str]
) -> tuple:
    """Score a char sequence through the char LM; returns (state, log10 p)."""
    total = 0.0
    for c in chars:
        cid = lm.vocab.get(c, lm.unk_id)
        s = lm.raw_score(state.ngram, cid)
        state = LMState(lm._next_state(state.ngram, cid))
        total += s
    return state, total


def upper_word_ppl(
    char_lm: ArpaLM,
    sentences: Iterable[Sequence[str]],
    word_separator: str = "|",
    replabel: int = 0,
) -> float:
    """Word-level perplexity upper bound from a char LM: each word scored by
    its canonical spelling (compute_upper_ppl_kenlm.py semantics)."""
    total_lp = 0.0
    n_words = 0
    for sent in sentences:
        state = char_lm.start(False)
        for w in sent:
            w = transform_asg(w, replabel) if replabel else w
            state, lp = score_word_chars(
                char_lm, state, word_to_chars(w.lower(), word_separator)
            )
            total_lp += lp
            n_words += 1
        _, lp = char_lm.finish(state)
        total_lp += lp
        n_words += 1
    return 10 ** (-total_lp / max(1, n_words))


def lower_word_ppl(
    char_lm: ArpaLM,
    sentences: Iterable[Sequence[str]],
    vocabulary: Sequence[str],
    word_separator: str = "|",
    max_alt: int = 50,
) -> float:
    """Lower bound: at each word position, marginalize P over the vocabulary
    words' spellings (restricted to ``max_alt`` most promising, as the
    reference does for tractability)."""
    vocab = list(vocabulary)[:max_alt]
    total_lp = 0.0
    n_words = 0
    for sent in sentences:
        state = char_lm.start(False)
        for w in sent:
            state_w, lp_w = score_word_chars(
                char_lm, state, word_to_chars(w.lower(), word_separator)
            )
            # normalizer: sum over alternative words from this state
            alts = []
            for v in vocab:
                _, lp_v = score_word_chars(
                    char_lm, state, word_to_chars(v.lower(), word_separator)
                )
                alts.append(lp_v)
            m = max(alts + [lp_w])
            z = m + math.log10(
                sum(10 ** (a - m) for a in alts)
                + (10 ** (lp_w - m) if w.lower() not in vocab else 0.0)
            )
            total_lp += lp_w - z
            n_words += 1
            state = state_w
        n_words += 1
    return 10 ** (-total_lp / max(1, n_words))
