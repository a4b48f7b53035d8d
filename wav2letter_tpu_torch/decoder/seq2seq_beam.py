"""Seq2seq beam search with the decoder in the loop, the port of
``wav2letter_tpu/decoder/seq2seq_beam.py``.

Reference: ``LexiconSeq2SeqDecoder`` / ``LexiconFreeSeq2SeqDecoder`` driven
by an ``amUpdateFunc`` that runs the attention decoder on the current
hypothesis set (``cpc/Decode.cpp:529-624``; the options eosScore,
attentionThreshold and hard/soft selection).

The "amUpdateFunc" here is a step of the criterion on the emissions' device:
``(state, prev_tokens) -> (state, log_probs (K, V), attention peaks | None)``,
all K hypotheses advanced by one call of ``decode_step`` (the beam is the
batch), under ``torch.inference_mode``, with one copy to the host a step (the
log-probs and the peaks together). The host loop ranks and extends the
hypotheses; ``decoder/s2s_native.py`` runs the same loop in C++.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .beam import DecodeResult, DecoderOptions
from .lm import LM, ZeroLM
from .trie import Trie, TrieNode


def _device(criterion) -> torch.device:
    return next(criterion.parameters()).device


def _to_host(logits: torch.Tensor, new_state):
    """log_softmax of the step's logits and, for the GRU decoder (a tuple
    state), its attention peaks, in one copy to the host."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if not isinstance(new_state, tuple):
        return logp.cpu().numpy(), None
    both = torch.cat([logp, new_state[1].float()[:, None]], dim=1).cpu().numpy()
    return both[:, :-1], both[:, -1].astype(np.int32)


def make_s2s_update_fn(criterion, emissions, emis_len: int):
    """The decoder step for one utterance's beam. ``emissions`` (T, H), numpy
    or a tensor; the criterion's ``decode_step`` runs on its own device.
    Returns (step_fn(state, toks (K,)) -> (state, log_probs (K, V) numpy,
    peaks (K,) numpy | None), init_state_fn(k))."""
    dev = _device(criterion)
    em = torch.as_tensor(np.asarray(emissions, np.float32), device=dev)[None]
    mask = torch.arange(em.shape[1], device=dev)[None, :] < int(emis_len)

    @torch.inference_mode()
    def step(state, toks):
        tok = torch.as_tensor(np.asarray(toks, np.int64), device=dev)
        K = tok.shape[0]
        new_state, logits = criterion.decode_step(
            state, tok, em.expand(K, -1, -1), mask.expand(K, -1), 0)
        return (new_state,) + _to_host(logits, new_state)

    @torch.inference_mode()
    def init_state(k: int):
        return criterion.init_state(k, torch.float32, dev)

    return step, init_state


def make_s2s_update_fn_multi(criterion, emissions_list: Sequence[np.ndarray],
                             emis_lens: Sequence[int], beam_size: int):
    """The decoder step of N utterances' beams at once: utterance i owns the
    rows ``[i*K, (i+1)*K)`` of one (N*K)-row state; the encoder states are
    padded to a common Tmax and picked per row by ``utt_idx``.

    Returns (step_fn(state, toks (R,), utt_idx (R,)) -> (state, log_probs
    (R, V), peaks | None), init_state_fn())."""
    dev = _device(criterion)
    N = len(emissions_list)
    H = emissions_list[0].shape[-1]
    Tmax = max(e.shape[0] for e in emissions_list)
    enc = np.zeros((N, Tmax, H), np.float32)
    for i, e in enumerate(emissions_list):
        enc[i, : e.shape[0]] = e
    enc = torch.from_numpy(enc).to(dev)
    lens = torch.as_tensor(np.asarray(emis_lens, np.int64), device=dev)
    R = N * beam_size
    rows = {}  # the rows of the last utt_idx: it stays the same through a decode

    @torch.inference_mode()
    def step(state, toks, utt_idx):
        utt_idx = np.asarray(utt_idx, np.int64)
        if rows.get("key") != utt_idx.tobytes():
            idx = torch.from_numpy(utt_idx).to(dev)
            rows.update(key=utt_idx.tobytes(), enc=enc[idx],
                        mask=torch.arange(Tmax, device=dev)[None, :] < lens[idx][:, None])
        tok = torch.as_tensor(np.asarray(toks, np.int64), device=dev)
        new_state, logits = criterion.decode_step(state, tok, rows["enc"], rows["mask"], 0)
        return (new_state,) + _to_host(logits, new_state)

    @torch.inference_mode()
    def init_state():
        return criterion.init_state(R, torch.float32, dev)

    return step, init_state


@torch.inference_mode()
def _gather_state(state, rows):
    """The state's rows ``rows`` (a copy), for a tuple, list or dict of
    tensors whose first axis is the hypothesis."""
    if isinstance(state, dict):
        return {k: _gather_state(v, rows) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_gather_state(v, rows) for v in state)
    if state.dim() >= 1 and state.shape[0] != 0:
        return state[torch.as_tensor(np.asarray(rows, np.int64), device=state.device)]
    return state


@dataclasses.dataclass
class _S2SHyp:
    score: float
    am_score: float
    lm_score: float
    tokens: List[int]
    words: List[int]
    lm_state: object
    node: Optional[TrieNode]
    state_idx: int  # row in the batched decoder state
    peak: int = 0


class Seq2SeqDecoderBase:
    def __init__(
        self,
        opts: DecoderOptions,
        eos_idx: int,
        update_fn,
        init_state_fn,
        lm: Optional[LM] = None,
        max_output_len: int = 200,
        attention_threshold: float = float("inf"),
        hard_selection: float = float("inf"),
        soft_selection: float = float("inf"),
    ):
        self.opts = opts
        self.eos = eos_idx
        self.update_fn = update_fn
        self.init_state_fn = init_state_fn
        self.lm = lm or ZeroLM()
        self.max_output_len = max_output_len
        self.attention_threshold = attention_threshold
        # candidate pruning of the TDS-era decode cfgs (--hardselection,
        # --softselection; the JAX package's reading): a step keeps at most
        # beam_size * hard_selection candidates, and drops those more than
        # soft_selection below its best
        self.hard_selection = hard_selection
        self.soft_selection = soft_selection

    def _lm_extend(self, hyp: _S2SHyp, tok: int) -> Tuple[object, float]:
        if self.opts.lm_weight == 0.0:
            return hyp.lm_state, 0.0
        return self.lm.score(hyp.lm_state, tok)

    def _token_extend(self, hyp, tok):
        """(new node, words emitted, LM delta, LM state), or None where the
        token is not allowed."""
        return None, [], 0.0, hyp.lm_state

    def decode(self, n_best: int = 1) -> List[DecodeResult]:
        opts = self.opts
        K = opts.beam_size
        state = self.init_state_fn(1)
        start = _S2SHyp(0.0, 0.0, 0.0, [], [], self.lm.start(False),
                        getattr(self, "trie", None) and self.trie.root, 0)
        beam = [start]
        finished: List[_S2SHyp] = []
        for _ in range(self.max_output_len):
            toks = np.asarray([h.tokens[-1] if h.tokens else self.eos for h in beam], np.int32)
            state_in = _gather_state(state, [h.state_idx for h in beam])
            new_state, logp, new_peaks = self.update_fn(state_in, toks)
            has_peaks = new_peaks is not None
            if not has_peaks:
                new_peaks = np.zeros(len(beam), np.int32)
            cands: List[_S2SHyp] = []
            n_tok = min(opts.beam_size_token, logp.shape[1])
            for bi, hyp in enumerate(beam):
                # attention-peak monotonicity pruning (--attentionthreshold):
                # drop extensions whose attention jumped implausibly far
                if has_peaks and math.isfinite(self.attention_threshold):
                    if abs(int(new_peaks[bi]) - hyp.peak) > self.attention_threshold:
                        continue
                row = logp[bi]
                for tok in np.argpartition(-row, n_tok - 1)[:n_tok]:
                    tok = int(tok)
                    sc = hyp.score + float(row[tok])
                    if tok == self.eos:
                        finished.append(dataclasses.replace(
                            hyp, score=sc + opts.eos_score,
                            am_score=hyp.am_score + float(row[tok])))
                        continue
                    ext = self._token_extend(hyp, tok)
                    if ext is None:
                        continue
                    node, words, lm_delta, lm_state = ext
                    cands.append(_S2SHyp(
                        sc + opts.lm_weight * lm_delta + opts.word_score * len(words),
                        hyp.am_score + float(row[tok]), hyp.lm_score + lm_delta,
                        hyp.tokens + [tok], hyp.words + words, lm_state, node, bi,
                        int(new_peaks[bi])))
            if not cands:
                break
            cands.sort(key=lambda h: -h.score)
            best = cands[0].score
            if math.isfinite(self.hard_selection):
                cands = cands[: max(1, int(K * self.hard_selection))]
            if math.isfinite(self.soft_selection):
                cands = [h for h in cands if h.score >= best - self.soft_selection]
            beam = [h for h in cands[:K] if h.score >= best - opts.beam_threshold]
            state = new_state
            if not beam:
                break
        was_completed = bool(finished)
        if not finished:
            finished = beam
        out = []
        for h in finished:  # the LM's end of sentence
            sc, lmsc = h.score, h.lm_score
            if self.opts.lm_weight != 0.0:
                _, s = self.lm.finish(h.lm_state)
                sc += self.opts.lm_weight * s
                lmsc += s
            out.append((sc, lmsc, h))
        out.sort(key=lambda x: -x[0])
        return [DecodeResult(sc, h.am_score, lmsc, h.words or [-1], h.tokens,
                             completed=was_completed)
                for sc, lmsc, h in out[:n_best]]


class LexiconFreeSeq2SeqDecoder(Seq2SeqDecoderBase):
    """Token-level beam; optional token LM shallow fusion."""

    def _token_extend(self, hyp, tok):
        lm_state, s = self._lm_extend(hyp, tok)
        return None, [], s, lm_state


class LexiconSeq2SeqDecoder(Seq2SeqDecoderBase):
    """Trie-constrained seq2seq beam with a word-level LM."""

    def __init__(self, opts, trie: Trie, lm, eos_idx, update_fn, init_state_fn,
                 word_sep_idx: int = -1, max_output_len: int = 200, **kw):
        self.trie = trie
        self.word_sep = word_sep_idx
        super().__init__(opts, eos_idx, update_fn, init_state_fn, lm, max_output_len, **kw)

    def _token_extend(self, hyp, tok):
        node = hyp.node or self.trie.root
        if tok == self.word_sep and self.word_sep >= 0:
            return self.trie.root, [], 0.0, hyp.lm_state
        child = node.children.get(tok)
        if child is None:
            return None
        if child.labels:
            w = child.labels[0]
            lm_state, lm_delta = hyp.lm_state, 0.0
            if self.opts.lm_weight != 0.0:
                lm_state, lm_delta = self.lm.score(hyp.lm_state, w)
            return self.trie.root, [w], lm_delta, lm_state
        return child, [], 0.0, hyp.lm_state
