"""ctypes wrappers over the native C++ beam decoder: the port's copy of
``wav2letter_tpu/decoder/native.py``, over its own build of ``decoder.cpp``.

Same semantics as the Python ``LexiconDecoder``/``LexiconFreeDecoder``
(differentially tested); used automatically by the Decode executor when the
native extension builds. ~100x faster on real beams.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import numpy as np

from .beam import CriterionType, DecodeResult, DecoderOptions
from ..ops.native import decoder_lib


class NativeLM:
    def __init__(self, arpa_path: str, usr_vocab: Optional[Sequence[str]] = None):
        self.lib = decoder_lib()
        self.ptr = self.lib.w2l_lm_load(arpa_path.encode())
        if not self.ptr:
            raise ValueError(f"failed to load ARPA LM: {arpa_path}")
        self.usr_map = None
        if usr_vocab is not None:
            unk = self.lib.w2l_lm_unk_id(self.ptr)
            self.usr_map = np.asarray(
                [self.lib.w2l_lm_word_id(self.ptr, w.encode()) for w in usr_vocab],
                np.int32,
            )
            self.usr_map[self.usr_map < 0] = unk

    def score_word(self, usr_idx: int) -> float:
        """Unigram log10 score of a usr-vocab word (trie smearing start
        scores; reference Decoder.cpp:73-94)."""
        lm_id = int(self.usr_map[usr_idx]) if self.usr_map is not None else usr_idx
        empty = np.zeros(1, np.int32)  # unused at hn=0; avoids a null deref
        return float(
            self.lib.w2l_lm_score_hist(
                self.ptr, empty.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                0, ctypes.c_int32(lm_id)
            )
        )

    @property
    def used_mmap(self) -> int:
        """1 = file-backed mmap (binary containers), 0 = heap copy
        (mmap fallback), -1 = in-memory model (ARPA text)."""
        return int(self.lib.w2l_lm_used_mmap(self.ptr))

    def score_sentence_ids(self, ids: Sequence[int]) -> float:
        arr = np.asarray(ids, np.int32)
        return float(
            self.lib.w2l_lm_score_seq(
                self.ptr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(arr),
            )
        )

    def __del__(self):
        if getattr(self, "ptr", None):
            try:
                self.lib.w2l_lm_free(self.ptr)
            except Exception:
                pass


class NativeExternalLM:
    """Host-scored (deferred) LM handle for the native beam decoder —
    the ConvLM path (reference cpc/Decode.cpp:489-517). The native core
    collects each step's pending (history, word) score requests; ``scorer``
    (``decoder/convlm.py::ConvLM``) resolves them with batched device calls
    via ``score_batch``."""

    def __init__(self, scorer):
        self.lib = decoder_lib()
        self.scorer = scorer
        self.context = int(scorer.context)
        self.ptr = self.lib.w2l_lm_new_external(
            self.context, scorer.eos_id, scorer.eos_id, scorer.unk_id
        )
        self.usr_map = (
            np.asarray(scorer.usr_map, np.int32)
            if scorer.usr_map is not None
            else None
        )

    def __del__(self):
        if getattr(self, "ptr", None):
            try:
                self.lib.w2l_lm_free(self.ptr)
            except Exception:
                pass


class NativeTrie:
    def __init__(self, n_tokens: int):
        self.lib = decoder_lib()
        self.ptr = self.lib.w2l_trie_new()
        self.n_tokens = n_tokens

    def insert(self, spelling: Sequence[int], word_idx: int, score: float):
        arr = np.asarray(spelling, np.int32)
        self.lib.w2l_trie_insert(
            self.ptr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(arr), word_idx, score,
        )

    def smear(self, mode: str):
        m = {"none": 0, "max": 1, "logadd": 2}[mode]
        self.lib.w2l_trie_smear(self.ptr, m)

    def __del__(self):
        if getattr(self, "ptr", None):
            try:
                self.lib.w2l_trie_free(self.ptr)
            except Exception:
                pass


class NativeBeamDecoder:
    """Unified native decoder: lexicon (trie != None) or lexicon-free."""

    def __init__(
        self,
        opts: DecoderOptions,
        trie: Optional[NativeTrie],
        lm: Optional[NativeLM],
        sil_idx: int,
        blank_idx: int,
        unk_word_idx: int,
        n_tokens: int,
        transitions: Optional[np.ndarray] = None,
        is_token_lm: bool = False,
    ):
        self.lib = decoder_lib()
        self.opts = opts
        trans_ptr = None
        self._trans = None
        if transitions is not None:
            self._trans = np.ascontiguousarray(transitions, np.float32)
            trans_ptr = self._trans.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        usr_ptr, n_usr = None, 0
        self._usr = None
        if lm is not None and lm.usr_map is not None:
            self._usr = lm.usr_map
            usr_ptr = self._usr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            n_usr = len(self._usr)
        unk_score = opts.unk_score if math.isfinite(opts.unk_score) else -1e30
        crit = 0 if opts.criterion_type == CriterionType.CTC else 1
        self.ptr = self.lib.w2l_decoder_new(
            opts.beam_size, opts.beam_size_token, opts.beam_threshold,
            opts.lm_weight, opts.word_score, unk_score, opts.sil_score,
            int(opts.log_add), crit,
            trie.ptr if trie else None, lm.ptr if lm else None,
            sil_idx, blank_idx, unk_word_idx, trans_ptr, n_tokens,
            usr_ptr, n_usr, int(is_token_lm),
        )
        self._trie, self._lm = trie, lm  # keep alive

    # -- deferred-LM request loop ------------------------------------------
    def _resolve_requests(self, n_reqs: int) -> "np.ndarray":
        ext = self._lm
        cap = ext.context
        hists = np.zeros((n_reqs, cap), np.int32)
        lens = np.zeros(n_reqs, np.int32)
        words = np.zeros(n_reqs, np.int32)
        i32 = ctypes.POINTER(ctypes.c_int32)
        self._req_export(
            self.ptr, hists.ctypes.data_as(i32), lens.ctypes.data_as(i32),
            words.ctypes.data_as(i32), cap,
        )
        return np.ascontiguousarray(
            ext.scorer.score_batch(hists, lens, words), np.float32
        )

    # -- online API --------------------------------------------------------
    def decode_begin(self):
        self.lib.w2l_decoder_begin(self.ptr)
        self._nframes = 0

    def decode_step(self, emissions: np.ndarray):
        em = np.ascontiguousarray(emissions, np.float32)
        t, n = em.shape
        if isinstance(self._lm, NativeExternalLM):
            self._req_export = self.lib.w2l_decoder_reqs_export
            f32 = ctypes.POINTER(ctypes.c_float)
            for ti in range(t):
                frame = em[ti]
                n_reqs = self.lib.w2l_decoder_step_collect(
                    self.ptr, frame.ctypes.data_as(f32), n
                )
                scores = self._resolve_requests(n_reqs) if n_reqs else None
                self.lib.w2l_decoder_step_apply(
                    self.ptr,
                    scores.ctypes.data_as(f32) if scores is not None else None,
                )
        else:
            self.lib.w2l_decoder_step(
                self.ptr, em.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, n
            )
        self._nframes += t

    def decode_end(self):
        if isinstance(self._lm, NativeExternalLM):
            self._req_export = self.lib.w2l_decoder_reqs_export
            n_reqs = self.lib.w2l_decoder_end_collect(self.ptr)
            scores = self._resolve_requests(n_reqs) if n_reqs else None
            f32 = ctypes.POINTER(ctypes.c_float)
            self.lib.w2l_decoder_end_apply(
                self.ptr,
                scores.ctypes.data_as(f32) if scores is not None else None,
            )
        else:
            self.lib.w2l_decoder_end(self.ptr)

    def prune(self, look_back: int = 0):
        self.lib.w2l_decoder_prune(self.ptr, look_back)

    def get_results(self, n_best: int = 1, max_len: int = 100000) -> List[DecodeResult]:
        n = min(n_best, self.lib.w2l_decoder_nhyps(self.ptr))
        out = []
        toks = np.empty(max_len, np.int32)
        words = np.empty(max_len, np.int32)
        scores = np.zeros(3, np.float64)  # read back as zeros where no hypothesis writes them
        for i in range(n):
            L = self.lib.w2l_decoder_result(
                self.ptr, i,
                toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                max_len, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            if L < 0:
                continue
            out.append(
                DecodeResult(
                    float(scores[0]), float(scores[1]), float(scores[2]),
                    words[:L].tolist(), toks[:L].tolist(),
                )
            )
        return out

    def get_best_hypothesis(self, look_back: int = 0) -> DecodeResult:
        """Best hypothesis ending ``look_back`` frames before the newest
        frame — the stable prefix an online consumer prints (reference
        ``getBestHypothesis(lookBack)``). Consume this, then call
        ``prune(look_back)`` (which re-roots at the same frame): the next
        call reports only words after the consumed prefix."""
        max_len = 100000
        toks = np.empty(max_len, np.int32)
        words = np.empty(max_len, np.int32)
        scores = np.zeros(3, np.float64)  # read back as zeros where no hypothesis writes them
        L = self.lib.w2l_decoder_best_lookback(
            self.ptr, look_back,
            toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_len, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        L = max(L, 0)
        return DecodeResult(
            float(scores[0]), float(scores[1]), float(scores[2]),
            words[:L].tolist(), toks[:L].tolist(),
        )

    # -- batch API ---------------------------------------------------------
    def decode(self, emissions: np.ndarray, n_best: int = 1) -> List[DecodeResult]:
        self.decode_begin()
        self.decode_step(emissions)
        self.decode_end()
        return self.get_results(n_best, max_len=emissions.shape[0] + 8)

    def __del__(self):
        if getattr(self, "ptr", None):
            try:
                self.lib.w2l_decoder_free(self.ptr)
            except Exception:
                pass


def native_available() -> bool:
    try:
        decoder_lib()
        return True
    except Exception:
        return False
