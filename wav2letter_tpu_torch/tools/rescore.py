"""Beam rescoring with external LMs: the port's copy of
``wav2letter_tpu/tools/rescore.py``.

Reference: ``recipes/sota/2019/rescoring/rescore.py:13-50`` — beam dumps
(``--isbeamdump``) become per-hypothesis feature vectors (acoustic score,
first-pass LM score, rescoring-LM score, length); weights are grid-searched
on a dev set; apply to test; also oracle/top-k WER diagnostics.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.editdistance import edit_distance


@dataclasses.dataclass
class BeamHyp:
    sample_id: str
    words: List[str]
    am_score: float
    lm_score: float  # first-pass (decoding) LM

    def features(self, rescore_lm_score: float) -> np.ndarray:
        return np.asarray(
            [self.am_score, self.lm_score, rescore_lm_score, len(self.words)],
            np.float64,
        )


def rescore_beams(
    beams: Dict[str, List[BeamHyp]],  # sample_id -> n-best
    lm_score_fn: Callable[[List[str]], float],  # rescoring LM (e.g. ArpaLM)
    weights: Sequence[float],  # (w_am, w_lm1, w_lm2, w_len)
) -> Dict[str, List[str]]:
    w = np.asarray(weights, np.float64)
    out = {}
    for sid, hyps in beams.items():
        best, best_s = None, -np.inf
        for h in hyps:
            s = float(h.features(lm_score_fn(h.words)) @ w)
            if s > best_s:
                best_s, best = s, h.words
        out[sid] = best or []
    return out


def grid_search_weights(
    beams: Dict[str, List[BeamHyp]],
    refs: Dict[str, List[str]],
    lm_score_fn: Callable[[List[str]], float],
    lm_weights: Sequence[float] = tuple(np.arange(0.0, 2.01, 0.25)),
    len_weights: Sequence[float] = tuple(np.arange(-1.0, 1.01, 0.25)),
) -> Tuple[Tuple[float, ...], float]:
    """Search (lm2, len) weights with am=lm1=1 fixed (reference sweep);
    returns (weights, dev WER)."""
    # pre-compute rescoring LM scores once
    cache: Dict[str, List[float]] = {
        sid: [lm_score_fn(h.words) for h in hyps] for sid, hyps in beams.items()
    }
    best_w, best_wer = (1.0, 1.0, 0.0, 0.0), np.inf
    for w2, wl in itertools.product(lm_weights, len_weights):
        errs = tot = 0
        for sid, hyps in beams.items():
            ref = refs.get(sid, [])
            scores = [
                h.am_score + h.lm_score + w2 * c + wl * len(h.words)
                for h, c in zip(hyps, cache[sid])
            ]
            hyp = hyps[int(np.argmax(scores))].words
            errs += edit_distance(ref, hyp)
            tot += len(ref)
        wer = 100.0 * errs / max(1, tot)
        if wer < best_wer:
            best_wer, best_w = wer, (1.0, 1.0, float(w2), float(wl))
    return best_w, best_wer


def oracle_wer(
    beams: Dict[str, List[BeamHyp]], refs: Dict[str, List[str]], top_k: int = 0
) -> float:
    """Best-achievable WER over the (top-k of the) beam (diagnostic)."""
    errs = tot = 0
    for sid, hyps in beams.items():
        ref = refs.get(sid, [])
        pool = hyps[:top_k] if top_k else hyps
        best = min((edit_distance(ref, h.words) for h in pool), default=len(ref))
        errs += best
        tot += len(ref)
    return 100.0 * errs / max(1, tot)


def load_beam_dump(path: str) -> Dict[str, List[BeamHyp]]:
    """Beam-dump file: ``sample_id \t am \t lm \t word word ...`` per hyp."""
    out: Dict[str, List[BeamHyp]] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            sid, am, lm, words = parts[0], float(parts[1]), float(parts[2]), parts[3].split()
            out.setdefault(sid, []).append(BeamHyp(sid, words, am, lm))
    return out


def save_beam_dump(path: str, beams: Dict[str, List[BeamHyp]]) -> None:
    with open(path, "w") as f:
        for sid, hyps in beams.items():
            for h in hyps:
                f.write(f"{sid}\t{h.am_score}\t{h.lm_score}\t{' '.join(h.words)}\n")
