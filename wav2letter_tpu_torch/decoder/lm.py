"""Language models for beam-search decoding: the port's copy of
``wav2letter_tpu/decoder/lm.py``.

API mirrors ``fl::lib::text::LM`` as used by the reference decoders
(``cpc/Decode.cpp:242-277``, ``inference/decoder/Decoder.cpp:62-71``):

    state = lm.start(is_null_start)
    state', score = lm.score(state, usr_token_idx)
    state', score = lm.finish(state)

Token indices are *user* indices into the word dict (or token dict for
token-level LMs); ``usr_to_lm`` mapping is built at construction.

Implementations:
  * ZeroLM — scores 0 everywhere (``--lmtype`` absent / ZeroLM).
  * ArpaLM — text ARPA n-gram reader with full backoff chain — the KenLM
    equivalent (reads the same .arpa files KenLM builds its binaries from).
  * KenLM — alias that loads .arpa directly or (TODO) kenlm .bin mmap.

Scores are natural-log (KenLM API convention used by flashlight: log10
converted internally — flashlight uses KenLM's Score which returns log10;
wordScore/lmWeight tuning absorbs the base, but we match KenLM and return
log10 to keep recipe lmweight values transferable).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

LOG10 = math.log(10.0)


class LMState:
    """Opaque per-hypothesis LM state; hashable for hyp merging."""

    __slots__ = ("ngram",)

    def __init__(self, ngram: Tuple[int, ...]):
        self.ngram = ngram

    def __hash__(self):
        return hash(self.ngram)

    def __eq__(self, other):
        return isinstance(other, LMState) and self.ngram == other.ngram


class LM:
    def start(self, start_with_nothing: bool = False) -> LMState:
        raise NotImplementedError

    def score(self, state: LMState, usr_token_idx: int) -> Tuple[LMState, float]:
        raise NotImplementedError

    def finish(self, state: LMState) -> Tuple[LMState, float]:
        raise NotImplementedError


class ZeroLM(LM):
    def start(self, start_with_nothing: bool = False) -> LMState:
        return LMState(())

    def score(self, state, usr_token_idx):
        return state, 0.0

    def finish(self, state):
        return state, 0.0


class ArpaLM(LM):
    """ARPA-format n-gram LM with standard backoff.

    score(w | h) = logprob(h+w) if seen, else backoff(h) + score(w | h[1:]).
    Stores log10 probs/backoffs exactly as in the file (KenLM convention).
    """

    def __init__(
        self,
        path: str,
        usr_vocab: Optional[Sequence[str]] = None,
        unk_token: str = "<unk>",
    ):
        self.ngrams: List[Dict[Tuple[int, ...], Tuple[float, float]]] = []
        self.vocab: Dict[str, int] = {}
        self.order = 0
        self._load(path)
        self.unk_id = self.vocab.get(unk_token, -1)
        self.bos_id = self.vocab.get("<s>", -1)
        self.eos_id = self.vocab.get("</s>", -1)
        # usr index -> lm word id
        self.usr_map: Optional[List[int]] = None
        if usr_vocab is not None:
            self.usr_map = [self.vocab.get(w, self.unk_id) for w in usr_vocab]

    # -- loading -----------------------------------------------------------
    def _load(self, path: str) -> None:
        import gzip

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            section = None
            counts = []
            word_ids = self.vocab
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("\\data\\"):
                    section = "data"
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    n = int(line[1 : line.index("-")])
                    section = n
                    while len(self.ngrams) < n:
                        self.ngrams.append({})
                    continue
                if line.startswith("\\end\\"):
                    break
                if section == "data":
                    if line.startswith("ngram"):
                        counts.append(int(line.split("=")[1]))
                    continue
                if isinstance(section, int):
                    parts = line.split("\t")
                    if len(parts) < 2:
                        parts = line.split()
                        if len(parts) < section + 1:
                            continue
                        logp = float(parts[0])
                        words = parts[1 : 1 + section]
                        bo = float(parts[1 + section]) if len(parts) > 1 + section else 0.0
                    else:
                        logp = float(parts[0])
                        words = parts[1].split()
                        bo = float(parts[2]) if len(parts) > 2 else 0.0
                    ids = tuple(
                        word_ids.setdefault(w, len(word_ids)) for w in words
                    )
                    self.ngrams[section - 1][ids] = (logp, bo)
        self.order = len(self.ngrams)

    # -- scoring -----------------------------------------------------------
    def _lookup(self, ids: Tuple[int, ...]) -> Optional[Tuple[float, float]]:
        n = len(ids)
        if 1 <= n <= self.order:
            return self.ngrams[n - 1].get(ids)
        return None

    def raw_score(self, hist: Tuple[int, ...], w: int) -> float:
        """log10 P(w | hist) with backoff."""
        if w < 0:
            # true OOV with no <unk> entry: heavy penalty
            ent = self.ngrams[0].get((self.unk_id,)) if self.unk_id >= 0 else None
            return ent[0] if ent else -10.0
        total_bo = 0.0
        h = hist[-(self.order - 1) :] if self.order > 1 else ()
        while True:
            ent = self._lookup(h + (w,))
            if ent is not None:
                return ent[0] + total_bo
            if not h:
                ent = self.ngrams[0].get((w,))
                if ent is not None:
                    return ent[0] + total_bo
                unk = self.ngrams[0].get((self.unk_id,)) if self.unk_id >= 0 else None
                return (unk[0] if unk else -10.0) + total_bo
            bo_ent = self._lookup(h)
            if bo_ent is not None:
                total_bo += bo_ent[1]
            h = h[1:]

    def _next_state(self, hist: Tuple[int, ...], w: int) -> Tuple[int, ...]:
        h = (hist + (w,))[-(self.order - 1) :] if self.order > 1 else ()
        # truncate to longest seen prefix context (KenLM state minimization
        # skipped — correctness identical, states may be finer-grained)
        return h

    def start(self, start_with_nothing: bool = False) -> LMState:
        if start_with_nothing or self.bos_id < 0:
            return LMState(())
        return LMState((self.bos_id,))

    def score(self, state: LMState, usr_token_idx: int) -> Tuple[LMState, float]:
        w = (
            self.usr_map[usr_token_idx]
            if self.usr_map is not None
            else usr_token_idx
        )
        s = self.raw_score(state.ngram, w)
        return LMState(self._next_state(state.ngram, w)), s

    def finish(self, state: LMState) -> Tuple[LMState, float]:
        if self.eos_id < 0:
            return state, 0.0
        s = self.raw_score(state.ngram, self.eos_id)
        return LMState(self._next_state(state.ngram, self.eos_id)), s

    def score_sentence(self, words: Sequence[str]) -> float:
        """Utility: total log10 prob of a sentence (for perplexity tools)."""
        st = self.start(False)
        total = 0.0
        for w in words:
            wid = self.vocab.get(w, self.unk_id)
            s = self.raw_score(st.ngram, wid)
            st = LMState(self._next_state(st.ngram, wid))
            total += s
        _, s = self.finish(st)
        return total + s


class NativeKenLM(LM):
    """KenLM binary (probing-format) LM backed by the native core
    (``ops/native/decoder.cpp::KenlmBinaryLM``). Also reads ARPA text via the
    same extension. Implements the Python LM protocol so the pure-Python
    decoders can consume .bin files; the native decoder consumes the handle
    directly (reference --lm=*.bin path, ``cpc/Decode.cpp:249-259``)."""

    def __init__(self, path: str, usr_vocab: Optional[Sequence[str]] = None):
        import ctypes

        from ..ops.native import decoder_lib

        self.lib = decoder_lib()
        self.ptr = self.lib.w2l_lm_load(path.encode())
        if not self.ptr:
            raise ValueError(f"failed to load LM: {path}")
        self._c_int32 = ctypes.c_int32
        self.order = self.lib.w2l_lm_order(self.ptr)
        self.unk_id = self.lib.w2l_lm_unk_id(self.ptr)
        self.bos_id = self.lib.w2l_lm_bos_id(self.ptr)
        self.eos_id = self.lib.w2l_lm_eos_id(self.ptr)
        self.usr_map: Optional[List[int]] = None
        if usr_vocab is not None:
            self.usr_map = [
                self.lib.w2l_lm_word_id(self.ptr, w.encode()) for w in usr_vocab
            ]

    def raw_score(self, hist: Tuple[int, ...], w: int) -> float:
        arr = (self._c_int32 * max(1, len(hist)))(*hist)
        return float(self.lib.w2l_lm_score_hist(self.ptr, arr, len(hist), w))

    def _next_state(self, hist: Tuple[int, ...], w: int) -> Tuple[int, ...]:
        return (hist + (w,))[-(self.order - 1):] if self.order > 1 else ()

    def start(self, start_with_nothing: bool = False) -> LMState:
        if start_with_nothing or self.bos_id < 0:
            return LMState(())
        return LMState((self.bos_id,))

    def score(self, state: LMState, usr_token_idx: int) -> Tuple[LMState, float]:
        w = self.usr_map[usr_token_idx] if self.usr_map is not None else usr_token_idx
        s = self.raw_score(state.ngram, w)
        return LMState(self._next_state(state.ngram, w)), s

    def finish(self, state: LMState) -> Tuple[LMState, float]:
        if self.eos_id < 0:
            return state, 0.0
        s = self.raw_score(state.ngram, self.eos_id)
        return LMState(self._next_state(state.ngram, self.eos_id)), s

    def score_sentence(self, words: Sequence[str]) -> float:
        st = self.start(False)
        total = 0.0
        for w in words:
            wid = self.lib.w2l_lm_word_id(self.ptr, w.encode())
            if wid < 0:
                wid = self.unk_id
            s = self.raw_score(st.ngram, wid)
            st = LMState(self._next_state(st.ngram, wid))
            total += s
        _, s = self.finish(st)
        return total + s

    def __del__(self):
        if getattr(self, "ptr", None):
            try:
                self.lib.w2l_lm_free(self.ptr)
            except Exception:
                pass


def KenLM(path: str, usr_vocab: Optional[Sequence[str]] = None) -> LM:
    """Factory matching the reference's KenLM usage (``cpc/Decode.cpp:249``):
    .arpa(.gz) text via the pure-Python reader; .bin (kenlm probing binary)
    and .qt (quantized-trie small-footprint binary, built by
    ``tools.ngram_lm.build_trie_binary``) via the native core, which sniffs
    the format by magic. Real-kenlm trie files are rejected with a pointer
    at the probing/ARPA/qt alternatives."""
    if path.endswith(".bin") or path.endswith(".qt"):
        return NativeKenLM(path, usr_vocab)
    return ArpaLM(path, usr_vocab)
