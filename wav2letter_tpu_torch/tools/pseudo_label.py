"""Pseudo-label generation + filtering for self-training / IPL — a copy of
``wav2letter_tpu/tools/pseudo_label.py`` (numpy only).

Reference: ``recipes/self_training/pseudo_labeling/generate_synthetic_data.py
:27-60`` (filters: no-EOS hypotheses, repeated n-grams, score quantile),
``generate_synthetic_lexicon.py`` (merge new words into the lexicon),
``dataset_utils.py`` (write filtered ``.lst``). The IPL loop
(``recipes/ipl/README.md``) = repeated {train -> decode unlabeled -> filter
-> merge -> retrain} driven by these utilities.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.listfile import ListSample, read_list_file, write_list_file


@dataclasses.dataclass
class PLFilterConfig:
    drop_no_eos: bool = True  # s2s hyps that never emitted EOS
    max_ngram_repeats: int = 2  # drop if any n-gram repeats more than this
    ngram_order: int = 4
    score_quantile: float = 0.0  # drop lowest-q fraction by score
    min_words: int = 1
    max_words: int = 10000


def has_excessive_repeats(words: Sequence[str], order: int, max_rep: int) -> bool:
    """True if any ``order``-gram occurs more than ``max_rep`` times
    (degenerate looping hyps, reference filter)."""
    if len(words) < order:
        return False
    counts: Dict[Tuple[str, ...], int] = {}
    for i in range(len(words) - order + 1):
        g = tuple(words[i : i + order])
        counts[g] = counts.get(g, 0) + 1
        if counts[g] > max_rep:
            return True
    return False


def filter_pseudo_labels(
    hyps: List[Tuple[str, List[str], float, bool]],  # (sample_id, words, score, has_eos)
    cfg: PLFilterConfig,
) -> List[Tuple[str, List[str], float]]:
    kept = []
    for sid, words, score, has_eos in hyps:
        if cfg.drop_no_eos and not has_eos:
            continue
        if not (cfg.min_words <= len(words) <= cfg.max_words):
            continue
        if has_excessive_repeats(words, cfg.ngram_order, cfg.max_ngram_repeats):
            continue
        kept.append((sid, words, score))
    if cfg.score_quantile > 0 and kept:
        scores = np.asarray([s for _, _, s in kept])
        thr = np.quantile(scores, cfg.score_quantile)
        kept = [(i, w, s) for i, w, s in kept if s >= thr]
    return kept


def write_pseudo_labeled_list(
    unlabeled_lst: str,
    labels: Dict[str, List[str]],  # sample_id -> words
    out_lst: str,
) -> int:
    """New ``.lst`` containing only successfully-labeled samples."""
    samples = read_list_file(unlabeled_lst)
    out = []
    for s in samples:
        words = labels.get(s.sample_id)
        if words:
            out.append(
                ListSample(s.sample_id, s.audio_path, s.duration_ms, " ".join(words))
            )
    write_list_file(out_lst, out)
    return len(out)


def merge_synthetic_lexicon(
    base_lexicon_path: str,
    new_words: Sequence[str],
    out_path: str,
    word_separator: str = "|",
) -> int:
    """Add letter spellings for new PL words (generate_synthetic_lexicon.py)."""
    from ..data.dictionary import Lexicon

    lx = Lexicon.from_file(base_lexicon_path)
    added = 0
    for w in new_words:
        if w not in lx:
            lx.entries[w] = [list(w) + [word_separator]]
            added += 1
    lx.save(out_path)
    return added


def analyze_dataset(lst_path: str) -> Dict[str, float]:
    """Corpus stats (reference AnalyzeDataset.cpp): counts, duration,
    token/word statistics."""
    samples = read_list_file(lst_path)
    durs = np.asarray([s.duration_ms for s in samples]) if samples else np.zeros(1)
    n_words = np.asarray([len(s.words) for s in samples]) if samples else np.zeros(1)
    return {
        "num_samples": len(samples),
        "total_hours": float(durs.sum() / 3.6e6),
        "mean_duration_ms": float(durs.mean()),
        "max_duration_ms": float(durs.max()),
        "mean_words": float(n_words.mean()),
        "vocab_size": len({w for s in samples for w in s.words}),
    }
