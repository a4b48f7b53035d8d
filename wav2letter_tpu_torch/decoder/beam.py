"""Beam-search decoders: LexiconDecoder and LexiconFreeDecoder, the port's
copy of ``wav2letter_tpu/decoder/beam.py``.

Reimplements the observable behavior of ``fl::lib::text::LexiconDecoder`` /
``LexiconFreeDecoder`` (upstream; constructed with full options at
``cpc/Decode.cpp:529-624``, streaming API use at
``inference/decoder/Decoder.cpp:227-261``):

  * options: beamSize, beamSizeToken, beamThreshold, lmWeight, wordScore,
    unkScore, silScore, eosScore, logAdd, criterionType ∈ {CTC, ASG, S2S}.
  * batch API ``decode(emissions, T, N)`` and online API
    ``decode_begin / decode_step / decode_end / prune(look_back) /
    get_best_hypothesis(look_back)``.
  * token-passing search: per frame each hypothesis extends with the
    top-``beamSizeToken`` emissions; blank/repeat handling per criterion;
    lexicon hypotheses walk the smeared trie accruing
    ``lmWeight * (smear delta)`` and rescore ``lmWeight * (P(word|h) -
    smear)`` + wordScore on word emission; hyps with identical
    (LM state, trie node, prev-token/blank) merge by max or logadd.

This Python implementation is the reference-correctness path; the native C++
core (``wav2letter_tpu_torch/ops/native``) accelerates the same algorithm and is
used automatically when built.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lm import LM, LMState, ZeroLM
from .trie import SmearingMode, Trie, TrieNode

NEG_INF = -math.inf


class CriterionType(enum.Enum):
    CTC = "ctc"
    ASG = "asg"
    S2S = "s2s"


@dataclasses.dataclass
class DecoderOptions:
    beam_size: int = 2500
    beam_size_token: int = 250000
    beam_threshold: float = 25.0
    lm_weight: float = 0.0
    word_score: float = 0.0
    unk_score: float = NEG_INF
    sil_score: float = 0.0
    eos_score: float = 0.0
    log_add: bool = False
    criterion_type: CriterionType = CriterionType.CTC

    @classmethod
    def from_config(cls, cfg) -> "DecoderOptions":
        ct = {"ctc": CriterionType.CTC, "asg": CriterionType.ASG}.get(
            cfg.criterion, CriterionType.S2S
        )
        return cls(
            beam_size=cfg.beamsize,
            beam_size_token=cfg.beamsizetoken,
            beam_threshold=cfg.beamthreshold,
            lm_weight=cfg.lmweight,
            word_score=cfg.wordscore,
            unk_score=cfg.unkscore,
            sil_score=cfg.silscore,
            eos_score=cfg.eosscore,
            log_add=cfg.logadd,
            criterion_type=ct,
        )


@dataclasses.dataclass
class DecodeResult:
    score: float
    am_score: float
    lm_score: float
    words: List[int]  # word indices per frame (-1 = none)
    tokens: List[int]  # token index per frame
    # s2s: hypothesis reached EOS (vs. cut at maxdecoderoutputlen); the
    # --use_completed_hyp rescoring cfgs filter beam dumps on this
    completed: bool = True

    def word_frames(self) -> List[Tuple[int, int, int]]:
        """(word_idx, begin_frame, end_frame) per emitted word — frame times
        as in the reference's words-with-timestamps output
        (inference/decoder/Decoder.cpp:113-164). end_frame is the frame the
        word completed (its label emission); begin_frame the first frame
        after the previous word/silence."""
        out = []
        begin = 0
        for t, w in enumerate(self.words):
            if w >= 0:
                out.append((w, begin, t))
                begin = t + 1
        return out


class _Hyp:
    __slots__ = (
        "score",
        "am_score",
        "lm_score",
        "lm_state",
        "node",
        "parent",
        "token",
        "word",
        "prev_blank",
    )

    def __init__(self, score, am_score, lm_score, lm_state, node, parent, token, word, prev_blank=False):
        self.score = score
        self.am_score = am_score
        self.lm_score = lm_score
        self.lm_state = lm_state
        self.node = node
        self.parent = parent
        self.token = token
        self.word = word
        self.prev_blank = prev_blank


def _logadd(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b == NEG_INF:
        return a
    return a + math.log1p(math.exp(b - a))


def _backtrack(hyp: _Hyp, T: int) -> Tuple[List[int], List[int]]:
    words = []
    tokens = []
    h = hyp
    while h is not None and h.parent is not None:
        words.append(h.word)
        tokens.append(h.token)
        h = h.parent
    words.reverse()
    tokens.reverse()
    return words, tokens


class _BeamDecoderBase:
    """Shared frame loop + online API."""

    def __init__(self, opts: DecoderOptions):
        self.opts = opts
        self.hyps: List[List[_Hyp]] = []
        self.t = 0

    # -- online API (reference decodeBegin/decodeStep/decodeEnd) ----------
    def decode_begin(self):
        self.t = 0
        self.hyps = [[self._start_hyp()]]

    def decode_step(self, emissions: np.ndarray):
        """emissions (T_chunk, N) raw scores."""
        em = np.asarray(emissions, dtype=np.float64)
        for t in range(em.shape[0]):
            frame = em[t]
            self.hyps.append(self._step_frame(self.hyps[-1], frame))
            self.t += 1

    def decode_end(self):
        self.hyps.append(self._finish(self.hyps[-1]))

    def prune(self, look_back: int = 0):
        """Bounded memory: keep only the last ``look_back``+1 frames of
        lattice, re-rooting backpointers (reference prune(lookBack))."""
        keep_from = max(0, len(self.hyps) - 1 - look_back)
        if keep_from == 0:
            return
        # dropping old frame lists releases dead hypotheses; live ancestor
        # chains (via .parent) survive for backtracking past the cut
        self.hyps = self.hyps[keep_from:]

    def get_best_hypothesis(self, look_back: int = 0) -> DecodeResult:
        frame = max(0, len(self.hyps) - 1 - look_back)
        hyps = self.hyps[frame]
        best = max(hyps, key=lambda h: h.score)
        words, tokens = _backtrack(best, frame)
        return DecodeResult(best.score, best.am_score, best.lm_score, words, tokens)

    # -- batch API ---------------------------------------------------------
    def decode(self, emissions: np.ndarray, n_best: int = 1) -> List[DecodeResult]:
        """emissions (T, N). Returns n_best results sorted by score."""
        self.decode_begin()
        self.decode_step(emissions)
        self.decode_end()
        final = sorted(self.hyps[-1], key=lambda h: -h.score)
        out = []
        for h in final[:n_best]:
            words, tokens = _backtrack(h, len(self.hyps) - 1)
            out.append(DecodeResult(h.score, h.am_score, h.lm_score, words, tokens))
        return out

    # -- search core -------------------------------------------------------
    def _top_tokens(self, frame: np.ndarray) -> np.ndarray:
        n = frame.shape[0]
        k = min(self.opts.beam_size_token, n)
        if k >= n:
            return np.argsort(-frame)
        idx = np.argpartition(-frame, k)[:k]
        return idx[np.argsort(-frame[idx])]

    def _merge_and_prune(self, cands: Dict, best_score: float) -> List[_Hyp]:
        thr = best_score - self.opts.beam_threshold
        hyps = [h for h in cands.values() if h.score >= thr]
        hyps.sort(key=lambda h: -h.score)
        return hyps[: self.opts.beam_size]

    def _add_cand(self, cands: Dict, key, hyp: _Hyp):
        old = cands.get(key)
        if old is None:
            cands[key] = hyp
        else:
            if self.opts.log_add:
                merged = _logadd(old.score, hyp.score)
                if hyp.score > old.score:
                    hyp.score = merged
                    cands[key] = hyp
                else:
                    old.score = merged
            elif hyp.score > old.score:
                cands[key] = hyp


class LexiconDecoder(_BeamDecoderBase):
    """Trie-constrained decoder with word-level (or token-level) LM."""

    def __init__(
        self,
        opts: DecoderOptions,
        trie: Trie,
        lm: LM,
        sil_idx: int,
        blank_idx: int,
        unk_word_idx: int,
        transitions: Optional[np.ndarray] = None,
        is_token_lm: bool = False,
    ):
        super().__init__(opts)
        self.trie = trie
        self.lm = lm
        self.sil = sil_idx
        self.blank = blank_idx
        self.unk_word = unk_word_idx
        self.trans = transitions
        self.is_token_lm = is_token_lm
        self.ctc = opts.criterion_type == CriterionType.CTC
        self.asg = opts.criterion_type == CriterionType.ASG

    def _start_hyp(self) -> _Hyp:
        return _Hyp(0.0, 0.0, 0.0, self.lm.start(False), self.trie.root, None, self.sil, -1)

    def _trans_score(self, to_tok: int, from_tok: int) -> float:
        if self.trans is None or from_tok < 0:
            return 0.0
        return float(self.trans[to_tok, from_tok])

    def _step_frame(self, hyps: List[_Hyp], frame: np.ndarray) -> List[_Hyp]:
        """Reference ``LexiconDecoder::decodeStep``. Lexicon spellings are
        '|'-terminated, so word labels live on sil-children: a word is
        emitted BY traversing that child (sil never bare-resets to root).
        Merge key = (lm_state, node, token, prev_blank) — the reference
        ``compareNoScoreStates`` fields."""
        opts = self.opts
        cands: Dict = {}
        best = NEG_INF
        first = self.t == 0  # transitions gated off on the first frame
        n = frame.shape[0]
        allow = None
        if opts.beam_size_token < n:
            allow = set(int(t) for t in self._top_tokens(frame))
        root = self.trie.root
        for hyp in hyps:
            node = hyp.node
            at_root = node is root
            # smear baseline: 0 at root (reference lexMaxScore)
            lex_max = 0.0 if at_root else node.max_score
            # --- (1) trie children: new token emissions ---
            for tok, child in node.children.items():
                if allow is not None and tok not in allow:
                    continue
                am = float(frame[tok])
                sc = hyp.score + am
                if not first:
                    sc += self._trans_score(tok, hyp.token)
                if tok == self.sil:
                    sc += opts.sil_score
                tl_state, tl_s = hyp.lm_state, 0.0
                if self.is_token_lm and opts.lm_weight != 0.0:
                    tl_state, tl_s = self.lm.score(hyp.lm_state, tok)
                # eat-up a new token (CTC: repeat without blank = same
                # emission, handled by (2))
                if (not self.ctc or hyp.prev_blank or tok != hyp.token) and child.children:
                    esc, elm, est = sc, hyp.lm_score, hyp.lm_state
                    if opts.lm_weight != 0.0:
                        if self.is_token_lm:
                            esc += opts.lm_weight * tl_s
                            elm += tl_s
                            est = tl_state
                        else:
                            delta = child.max_score - lex_max
                            esc += opts.lm_weight * delta
                            elm += delta
                    nh = _Hyp(esc, hyp.am_score + am, elm, est, child, hyp,
                              tok, -1, False)
                    self._add_cand(cands, (est, child, tok, False), nh)
                    best = max(best, nh.score)
                # true-word emissions at labeled children
                for w in child.labels:
                    # single-token-spelling guard (reference): avoid
                    # re-emitting a 1-token word on consecutive frames
                    if at_root and hyp.token == tok:
                        continue
                    bonus = opts.unk_score if w == self.unk_word else opts.word_score
                    if bonus == NEG_INF:
                        continue
                    wsc, wlm, wst = sc + bonus, hyp.lm_score, hyp.lm_state
                    if opts.lm_weight != 0.0:
                        if self.is_token_lm:
                            wsc += opts.lm_weight * tl_s
                            wlm += tl_s
                            wst = tl_state
                        else:
                            wst, s = self.lm.score(hyp.lm_state, w)
                            wsc += opts.lm_weight * (s - lex_max)
                            # lm_score telescopes clean: the in-word smear
                            # deltas accumulated in hyp.lm_score sum to
                            # lex_max and are replaced by the true word score
                            wlm = hyp.lm_score + s - lex_max
                    nh = _Hyp(wsc, hyp.am_score + am, wlm, wst, root, hyp,
                              tok, w, False)
                    self._add_cand(cands, (wst, root, tok, False), nh)
                    best = max(best, nh.score)
                # unknown-word emission at label-less nodes
                if (not child.labels and opts.unk_score > NEG_INF
                        and self.unk_word >= 0 and not self.is_token_lm):
                    wsc, wlm, wst = sc + opts.unk_score, hyp.lm_score, hyp.lm_state
                    if opts.lm_weight != 0.0:
                        wst, s = self.lm.score(hyp.lm_state, self.unk_word)
                        wsc += opts.lm_weight * (s - lex_max)
                        wlm = hyp.lm_score + s - lex_max
                    nh = _Hyp(wsc, hyp.am_score + am, wlm, wst, root, hyp,
                              tok, self.unk_word, False)
                    self._add_cand(cands, (wst, root, tok, False), nh)
                    best = max(best, nh.score)
            # --- (2) same lexicon node: sil at root, else token repeat ---
            if not self.ctc or not hyp.prev_blank or at_root:
                tok2 = self.sil if at_root else hyp.token
                if tok2 >= 0 and tok2 != self.blank:
                    am = float(frame[tok2])
                    sc = hyp.score + am
                    if not first:
                        sc += self._trans_score(tok2, hyp.token)
                    if tok2 == self.sil:
                        sc += opts.sil_score
                    nh = _Hyp(sc, hyp.am_score + am, hyp.lm_score,
                              hyp.lm_state, node, hyp, tok2, -1, False)
                    self._add_cand(cands, (hyp.lm_state, node, tok2, False), nh)
                    best = max(best, nh.score)
            # --- (3) CTC blank: stay, mark prev_blank ---
            if self.ctc and self.blank >= 0:
                am = float(frame[self.blank])
                nh = _Hyp(hyp.score + am, hyp.am_score + am, hyp.lm_score,
                          hyp.lm_state, node, hyp, self.blank, -1, True)
                self._add_cand(cands, (hyp.lm_state, node, self.blank, True), nh)
                best = max(best, nh.score)
        return self._merge_and_prune(cands, best)

    def _finish(self, hyps: List[_Hyp]) -> List[_Hyp]:
        # reference "hasNiceEnding": if any hyp ends at the trie root
        # (complete word), mid-word finals are dropped
        nice = any(h.node is self.trie.root for h in hyps)
        out = []
        for hyp in hyps:
            if nice and hyp.node is not self.trie.root:
                continue
            sc = hyp.score
            lm_sc = hyp.lm_score
            st = hyp.lm_state
            if self.opts.lm_weight != 0.0 and not self.is_token_lm:
                st, s = self.lm.finish(st)
                sc += self.opts.lm_weight * s
                lm_sc += s
            out.append(_Hyp(sc, hyp.am_score, lm_sc, st, hyp.node, hyp.parent, hyp.token, hyp.word, hyp.prev_blank))
        out.sort(key=lambda h: -h.score)
        return out[: self.opts.beam_size]


class LexiconFreeDecoder(_BeamDecoderBase):
    """Unconstrained token decoder with a token-level LM
    (reference LexiconFreeDecoder; ``--uselexicon=false`` path)."""

    def __init__(
        self,
        opts: DecoderOptions,
        lm: LM,
        sil_idx: int,
        blank_idx: int,
        transitions: Optional[np.ndarray] = None,
    ):
        super().__init__(opts)
        self.lm = lm
        self.sil = sil_idx
        self.blank = blank_idx
        self.trans = transitions
        self.ctc = opts.criterion_type == CriterionType.CTC

    def _start_hyp(self) -> _Hyp:
        return _Hyp(0.0, 0.0, 0.0, self.lm.start(False), None, None, self.sil, -1)

    def _trans_score(self, to_tok: int, from_tok: int) -> float:
        if self.trans is None or from_tok < 0:
            return 0.0
        return float(self.trans[to_tok, from_tok])

    def _step_frame(self, hyps: List[_Hyp], frame: np.ndarray) -> List[_Hyp]:
        opts = self.opts
        cands: Dict = {}
        best = NEG_INF
        first = self.t == 0  # transitions gated off on the first frame
        top = self._top_tokens(frame)
        for hyp in hyps:
            for tok in top:
                tok = int(tok)
                am = float(frame[tok])
                base = hyp.score + am
                if self.ctc and tok == self.blank:
                    nh = _Hyp(base, hyp.am_score + am, hyp.lm_score, hyp.lm_state,
                              None, hyp, tok, -1, True)
                    self._add_cand(cands, (hyp.lm_state, hyp.token, True), nh)
                    best = max(best, nh.score)
                    continue
                if tok == hyp.token and (not self.ctc or not hyp.prev_blank):
                    # same emission: no LM, no new token
                    sc = base
                    if not first:
                        sc += self._trans_score(tok, hyp.token)
                    if tok == self.sil:
                        sc += opts.sil_score
                    nh = _Hyp(sc, hyp.am_score + am, hyp.lm_score, hyp.lm_state,
                              None, hyp, tok, -1, False)
                    self._add_cand(cands, (hyp.lm_state, tok, False), nh)
                    best = max(best, nh.score)
                    continue
                sc = base
                if not first:
                    sc += self._trans_score(tok, hyp.token)
                st = hyp.lm_state
                lm_sc = hyp.lm_score
                if opts.lm_weight != 0.0:
                    st, s = self.lm.score(st, tok)
                    sc += opts.lm_weight * s
                    lm_sc += s
                if tok == self.sil:
                    sc += opts.sil_score
                nh = _Hyp(sc, hyp.am_score + am, lm_sc, st, None, hyp, tok, -1, False)
                self._add_cand(cands, (st, tok, False), nh)
                best = max(best, nh.score)
        return self._merge_and_prune(cands, best)

    def _finish(self, hyps: List[_Hyp]) -> List[_Hyp]:
        out = []
        for hyp in hyps:
            sc, lm_sc, st = hyp.score, hyp.lm_score, hyp.lm_state
            if self.opts.lm_weight != 0.0:
                st, s = self.lm.finish(st)
                sc += self.opts.lm_weight * s
                lm_sc += s
            out.append(_Hyp(sc, hyp.am_score, lm_sc, st, None, hyp.parent, hyp.token, hyp.word, hyp.prev_blank))
        out.sort(key=lambda h: -h.score)
        return out[: self.opts.beam_size]
