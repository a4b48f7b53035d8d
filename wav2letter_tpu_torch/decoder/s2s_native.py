"""The native (C++) seq2seq beam, the port of
``wav2letter_tpu/decoder/s2s_native.py``.

Python owns the loop, so that the decoder step stays one call on the device
per output position for all hypotheses (``seq2seq_beam.make_s2s_update_fn``,
the beam is the batch); the C++ core (``ops/native/decoder.cpp::S2SDecoder``,
the port's copy) does the rest: candidates over the (K, V) log-probs, the
trie, n-gram LM shallow fusion, eosScore, attentionThreshold, hard and soft
selection and the beam threshold. ``NativeSeq2SeqBatchDecoder`` advances N
utterances' beams through one step call a position, each beam as the
sequential decoder would (``--s2s_batch_decode``).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional

import numpy as np

from .beam import DecodeResult, DecoderOptions
from .native import NativeExternalLM, NativeLM, NativeTrie
from .seq2seq_beam import _gather_state, make_s2s_update_fn_multi
from ..ops.native import decoder_lib


class NativeSeq2SeqDecoder:
    """Unified native s2s decoder: lexicon (trie != None) or lexicon-free.

    ``update_fn(state, toks) -> (new_state, log_probs (K, V), peaks|None)``
    and ``init_state_fn(k)`` as ``seq2seq_beam.make_s2s_update_fn`` makes
    them, the Python decoders' signature.
    """

    def __init__(
        self,
        opts: DecoderOptions,
        eos_idx: int,
        update_fn,
        init_state_fn,
        lm: Optional[NativeLM] = None,
        trie: Optional[NativeTrie] = None,
        word_sep_idx: int = -1,
        max_output_len: int = 200,
        attention_threshold: float = float("inf"),
        hard_selection: float = float("inf"),
        soft_selection: float = float("inf"),
    ):
        self.lib = decoder_lib()
        self.opts = opts
        self.eos = eos_idx
        self.update_fn = update_fn
        self.init_state_fn = init_state_fn
        self.max_output_len = max_output_len
        usr_ptr, n_usr = None, 0
        self._usr = None
        if lm is not None and lm.usr_map is not None:
            self._usr = lm.usr_map
            usr_ptr = self._usr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            n_usr = len(self._usr)

        def fin(x):  # inf -> sentinel the C side maps back to +inf
            return 1e30 if not math.isfinite(x) else float(x)

        self.ptr = self.lib.w2l_s2s_new(
            opts.beam_size, opts.beam_size_token, fin(opts.beam_threshold),
            opts.lm_weight, opts.word_score, opts.eos_score,
            fin(attention_threshold), fin(hard_selection), fin(soft_selection),
            trie.ptr if trie else None, lm.ptr if lm else None,
            eos_idx, word_sep_idx, usr_ptr, n_usr,
        )
        self._trie, self._lm = trie, lm  # keep alive

    def _resolve_requests(self, n_reqs: int) -> np.ndarray:
        ext = self._lm
        cap = ext.context
        hists = np.zeros((n_reqs, cap), np.int32)
        lens = np.zeros(n_reqs, np.int32)
        words = np.zeros(n_reqs, np.int32)
        i32 = ctypes.POINTER(ctypes.c_int32)
        self.lib.w2l_s2s_reqs_export(
            self.ptr, hists.ctypes.data_as(i32), lens.ctypes.data_as(i32),
            words.ctypes.data_as(i32), cap,
        )
        return np.ascontiguousarray(
            ext.scorer.score_batch(hists, lens, words), np.float32
        )

    def decode(self, n_best: int = 1) -> List[DecodeResult]:
        lib = self.lib
        K = self.opts.beam_size
        out_toks = np.empty(K, np.int32)
        out_rows = np.empty(K, np.int32)
        tp = out_toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        rp = out_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        lib.w2l_s2s_begin(self.ptr)
        state = self.init_state_fn(1)
        toks = np.asarray([self.eos], np.int32)
        rows = np.asarray([0], np.int32)
        k = 1
        for _ in range(self.max_output_len):
            state_in = _gather_state(state, rows)
            new_state, logp, peaks = self.update_fn(state_in, toks)
            logp_np = np.ascontiguousarray(logp, np.float32)
            if peaks is not None:
                peaks_np = np.ascontiguousarray(np.asarray(peaks), np.int32)
                pk_ptr = peaks_np.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            else:
                pk_ptr = None
            lp = logp_np.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            if isinstance(self._lm, NativeExternalLM):
                n_reqs = lib.w2l_s2s_step_collect(
                    self.ptr, lp, pk_ptr, k, logp_np.shape[1]
                )
                scores = self._resolve_requests(n_reqs) if n_reqs else None
                k = lib.w2l_s2s_step_apply(
                    self.ptr,
                    scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                    if scores is not None else None,
                    tp, rp,
                )
            else:
                k = lib.w2l_s2s_step(
                    self.ptr, lp, pk_ptr, k, logp_np.shape[1], tp, rp,
                )
            if k <= 0:
                break
            toks = out_toks[:k].copy()
            rows = out_rows[:k].copy()
            state = new_state
        if isinstance(self._lm, NativeExternalLM):
            n_reqs = lib.w2l_s2s_end_collect(self.ptr)
            scores = self._resolve_requests(n_reqs) if n_reqs else None
            lib.w2l_s2s_end_apply(
                self.ptr,
                scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                if scores is not None else None,
            )
        else:
            lib.w2l_s2s_end(self.ptr)

        n = min(n_best, lib.w2l_s2s_nhyps(self.ptr))
        max_len = self.max_output_len + 8
        tk = np.empty(max_len, np.int32)
        wd = np.empty(max_len, np.int32)
        scores = np.zeros(3, np.float64)  # read back as zeros where no hypothesis writes them
        nw = ctypes.c_int32()
        comp = ctypes.c_int32()
        results = []
        for i in range(n):
            L = lib.w2l_s2s_result(
                self.ptr, i,
                tk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                wd.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                max_len, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.byref(nw), ctypes.byref(comp),
            )
            if L < 0:
                continue
            results.append(
                DecodeResult(
                    float(scores[0]), float(scores[1]), float(scores[2]),
                    wd[: nw.value].tolist() or [-1], tk[:L].tolist(),
                    completed=bool(comp.value),
                )
            )
        return results

    def __del__(self):
        if getattr(self, "ptr", None):
            try:
                self.lib.w2l_s2s_free(self.ptr)
            except Exception:
                pass


class NativeSeq2SeqBatchDecoder:
    """N utterances' beams through one decoder step a position: utterance i
    owns the rows ``[i*K, (i+1)*K)`` of one (N*K)-row state of a fixed shape,
    and every beam is what the sequential ``NativeSeq2SeqDecoder`` finds. A
    deferred external LM's requests of the N beams are scored in one batch
    a position."""

    def __init__(
        self,
        opts: DecoderOptions,
        eos_idx: int,
        criterion,
        lm: Optional[NativeLM] = None,
        trie: Optional[NativeTrie] = None,
        word_sep_idx: int = -1,
        max_output_len: int = 200,
        attention_threshold: float = float("inf"),
        hard_selection: float = float("inf"),
        soft_selection: float = float("inf"),
    ):
        self.lib = decoder_lib()
        self.opts = opts
        self.eos = eos_idx
        self.criterion = criterion
        self.max_output_len = max_output_len
        self._lm, self._trie = lm, trie
        self._prune = (attention_threshold, hard_selection, soft_selection)
        self.word_sep_idx = word_sep_idx
        self._usr = lm.usr_map if (lm is not None and lm.usr_map is not None) else None

    def _new_handle(self):
        def fin(x):
            return 1e30 if not math.isfinite(x) else float(x)

        at, hs, ss = self._prune
        usr_ptr, n_usr = None, 0
        if self._usr is not None:
            usr_ptr = self._usr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            n_usr = len(self._usr)
        o = self.opts
        return self.lib.w2l_s2s_new(
            o.beam_size, o.beam_size_token, fin(o.beam_threshold),
            o.lm_weight, o.word_score, o.eos_score,
            fin(at), fin(hs), fin(ss),
            self._trie.ptr if self._trie else None,
            self._lm.ptr if self._lm else None,
            self.eos, self.word_sep_idx, usr_ptr, n_usr,
        )

    def _resolve_batch(self, handles, counts):
        """Export every live decoder's deferred-LM requests, score them in
        ONE batched device call, return per-handle score slices."""
        ext = self._lm
        cap = ext.context
        total = sum(counts)
        if total == 0:
            return [None] * len(handles)
        hists = np.zeros((total, cap), np.int32)
        lens = np.zeros(total, np.int32)
        words = np.zeros(total, np.int32)
        i32 = ctypes.POINTER(ctypes.c_int32)
        off = 0
        for h, n in zip(handles, counts):
            if n == 0:
                continue
            self.lib.w2l_s2s_reqs_export(
                h, hists[off:off + n].ctypes.data_as(i32),
                lens[off:off + n].ctypes.data_as(i32),
                words[off:off + n].ctypes.data_as(i32), cap,
            )
            off += n
        scores = np.ascontiguousarray(
            ext.scorer.score_batch(hists, lens, words), np.float32)
        out, off = [], 0
        for n in counts:
            out.append(scores[off:off + n] if n else None)
            off += n
        return out

    def decode(self, emissions_list: List[np.ndarray],
               n_best: int = 1) -> List[List[DecodeResult]]:
        lib = self.lib
        N = len(emissions_list)
        K = self.opts.beam_size
        R = N * K
        step_fn, init_fn = make_s2s_update_fn_multi(
            self.criterion, emissions_list,
            [e.shape[0] for e in emissions_list], K,
        )
        handles = [self._new_handle() for _ in range(N)]
        try:
            for h in handles:
                lib.w2l_s2s_begin(h)
            state = init_fn()
            toks = [np.asarray([self.eos], np.int32) for _ in range(N)]
            rows = [np.asarray([0], np.int32) for _ in range(N)]
            k = [1] * N
            live = [True] * N
            utt_idx = np.repeat(np.arange(N, dtype=np.int32), K)
            out_toks = np.empty(K, np.int32)
            out_rows = np.empty(K, np.int32)
            tp = out_toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            rp = out_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            ext = isinstance(self._lm, NativeExternalLM)

            for _ in range(self.max_output_len):
                if not any(live):
                    break
                g_toks = np.zeros(R, np.int32)
                g_gather = np.arange(R, dtype=np.int64)
                for i in range(N):
                    if not live[i]:
                        continue
                    base = i * K
                    g_gather[base:base + k[i]] = base + rows[i]
                    g_toks[base:base + k[i]] = toks[i]
                state_in = _gather_state(state, g_gather)
                new_state, logp, peaks = step_fn(state_in, g_toks, utt_idx)
                logp_np = np.ascontiguousarray(logp, np.float32)
                peaks_np = (np.ascontiguousarray(np.asarray(peaks), np.int32)
                            if peaks is not None else None)
                V = logp_np.shape[1]

                def row_ptrs(i):
                    base = i * K
                    lp = logp_np[base:base + k[i]].ctypes.data_as(
                        ctypes.POINTER(ctypes.c_float))
                    if peaks_np is not None:
                        pk = peaks_np[base:base + k[i]].ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int32))
                    else:
                        pk = None
                    return lp, pk

                if ext:
                    counts = []
                    live_ids = [i for i in range(N) if live[i]]
                    for i in live_ids:
                        lp, pk = row_ptrs(i)
                        counts.append(lib.w2l_s2s_step_collect(
                            handles[i], lp, pk, k[i], V))
                    slices = self._resolve_batch(
                        [handles[i] for i in live_ids], counts)
                    for i, sc in zip(live_ids, slices):
                        k[i] = lib.w2l_s2s_step_apply(
                            handles[i],
                            sc.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                            if sc is not None else None, tp, rp)
                        if k[i] <= 0:
                            live[i] = False
                            self._finish(handles[i])
                        else:
                            toks[i] = out_toks[:k[i]].copy()
                            rows[i] = out_rows[:k[i]].copy()
                else:
                    for i in range(N):
                        if not live[i]:
                            continue
                        lp, pk = row_ptrs(i)
                        k[i] = lib.w2l_s2s_step(
                            handles[i], lp, pk, k[i], V, tp, rp)
                        if k[i] <= 0:
                            live[i] = False
                            lib.w2l_s2s_end(handles[i])
                        else:
                            toks[i] = out_toks[:k[i]].copy()
                            rows[i] = out_rows[:k[i]].copy()
                state = new_state
            for i in range(N):
                if live[i]:
                    if ext:
                        self._finish(handles[i])
                    else:
                        lib.w2l_s2s_end(handles[i])
            return [self._results(h, n_best) for h in handles]
        finally:
            for h in handles:
                lib.w2l_s2s_free(h)

    def _finish(self, h):
        n_reqs = self.lib.w2l_s2s_end_collect(h)
        if n_reqs:
            sc = self._resolve_batch([h], [n_reqs])[0]
            self.lib.w2l_s2s_end_apply(
                h, sc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            self.lib.w2l_s2s_end_apply(h, None)

    def _results(self, h, n_best):
        lib = self.lib
        n = min(n_best, lib.w2l_s2s_nhyps(h))
        max_len = self.max_output_len + 8
        tk = np.empty(max_len, np.int32)
        wd = np.empty(max_len, np.int32)
        scores = np.zeros(3, np.float64)  # read back as zeros where no hypothesis writes them
        nw = ctypes.c_int32()
        comp = ctypes.c_int32()
        results = []
        for i in range(n):
            L = lib.w2l_s2s_result(
                h, i, tk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                wd.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                max_len, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.byref(nw), ctypes.byref(comp),
            )
            if L < 0:
                continue
            results.append(DecodeResult(
                float(scores[0]), float(scores[1]), float(scores[2]),
                wd[: nw.value].tolist() or [-1], tk[:L].tolist(),
                completed=bool(comp.value),
            ))
        return results
