"""ConvLM — neural LM scoring for beam decoding: the port of
``wav2letter_tpu/decoder/convlm.py``.

Reference: ``ConvLM`` (a GCNN LM forwarded on the GPU during decoding, with
``--lm_vocab`` token mapping and an ``--lm_memory`` state cache; one GPU per
decoder thread — ``cpc/Decode.cpp:249-277,494-517``).

The LM is any arch-DSL LM (``models/lm.py``) trained next-token, held on the
decode device (the card unless the caller passes the CPU; it never moves to
the CPU by itself). Scoring keeps an LRU cache of (history -> log-prob row)
entries bounded by ``lm_memory`` and evaluates the misses of a beam step in
batches on the device (``score_batch``, the native beam's deferred-LM
protocol). Scores are log10, as KenLM's. ``stats`` counts the device calls,
the rows they scored, the lookups and cache hits, and the device
milliseconds (CUDA events on the card, the host clock on the CPU);
``load_convlm`` adds the seconds it took to load (``load_s``).
"""

from __future__ import annotations

import math
import os
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .lm import LM, LMState

LN10 = math.log(10.0)


class ConvLM(LM):
    # batch buckets of the deferred requests' misses, as in JAX
    _B_BUCKETS = (8, 32, 128, 512)

    def __init__(self, model: torch.nn.Module, vocab: Sequence[str],
                 usr_vocab: Optional[Sequence[str]] = None, context: int = 48,
                 lm_memory: int = 10000, eos: str = "</s>", unk: str = "<unk>"):
        """``model``: (B, L) ids -> ((B, L, V) logits, _), on its device."""
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.vocab = {w: i for i, w in enumerate(vocab)}
        self.eos_id = self.vocab.get(eos, 0)
        self.unk_id = self.vocab.get(unk, 0)
        self.context = context
        self.usr_map = None
        if usr_vocab is not None:
            self.usr_map = [self.vocab.get(w, self.unk_id) for w in usr_vocab]
        self.cache: "OrderedDict[Tuple[int, ...], np.ndarray]" = OrderedDict()
        self.lm_memory = lm_memory
        self.stats = dict(device_calls=0, rows=0, lookups=0, hits=0, device_ms=0.0)

    @torch.no_grad()
    def _rows(self, ids: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """(B, L) ids -> (B, V) natural log-probs at positions ``pos``."""
        cuda = self.device.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        x = torch.from_numpy(ids).to(self.device)
        p = torch.from_numpy(pos).long().to(self.device)
        logits, _ = self.model(x)
        rows = F.log_softmax(logits[torch.arange(len(pos), device=self.device), p].float(),
                             dim=-1)
        if cuda:
            end.record()
        out = rows.cpu().numpy()
        self.stats["device_ms"] += (start.elapsed_time(end) if cuda
                                    else 1e3 * (time.perf_counter() - t0))
        self.stats["device_calls"] += 1
        self.stats["rows"] += len(pos)
        return out

    def _put(self, hist: Tuple[int, ...], row: np.ndarray) -> None:
        self.cache[hist] = row
        if len(self.cache) > self.lm_memory:
            self.cache.popitem(last=False)

    def _logprobs(self, hist: Tuple[int, ...]) -> np.ndarray:
        self.stats["lookups"] += 1
        row = self.cache.get(hist)
        if row is not None:
            self.stats["hits"] += 1
            self.cache.move_to_end(hist)
            return row
        ids = np.asarray(hist, np.int64)[None]
        row = self._rows(ids, np.asarray([len(hist) - 1]))[0]
        self._put(hist, row)
        return row

    # -- batched scoring (the native beam's deferred-LM protocol) ------------
    # The native beam collects a step's pending (history, word) requests and
    # this resolves them with one device call per bucket. Right-padding is
    # sound because the GCNN LM is causal (position k sees only ids[:k+1]):
    # each row is read at its history's true last position.
    def score_batch(self, hists: np.ndarray, lens: np.ndarray,
                    words: np.ndarray) -> np.ndarray:
        """hists (N, H) LM-id histories (row i valid up to lens[i]), words
        (N,) LM ids -> (N,) float32 log10 P(word | history)."""
        n = len(words)
        keys = [tuple(int(x) for x in hists[i, : lens[i]]) for i in range(n)]
        missing, seen = [], set()
        for k in keys:
            if k not in self.cache and k not in seen:
                seen.add(k)
                missing.append(k)
        ctx = self.context
        i = 0
        while i < len(missing):
            b = next((b for b in self._B_BUCKETS if b >= len(missing) - i), self._B_BUCKETS[-1])
            chunk = missing[i: i + b]
            ids = np.zeros((b, ctx), np.int64)
            pos = np.zeros(b, np.int64)
            for j, k in enumerate(chunk):
                ids[j, : len(k)] = k  # a history longer than the context fails here, as in JAX
                pos[j] = len(k) - 1
            rows = self._rows(ids, pos)
            for j, k in enumerate(chunk):
                self._put(k, rows[j])
            i += len(chunk)
        out = np.empty(n, np.float32)
        self.stats["lookups"] += n
        self.stats["hits"] += n - len(missing)
        for i, k in enumerate(keys):
            row = self.cache.get(k)
            if row is None:  # evicted within this batch (a tiny lm_memory)
                row = self._logprobs(k)
            else:
                self.cache.move_to_end(k)
            out[i] = row[int(words[i])] / LN10
        return out

    # -- LM API ----------------------------------------------------------------
    def start(self, start_with_nothing: bool = False) -> LMState:
        return LMState((self.eos_id,))  # <s> == </s> in the GCNN LM convention

    def score(self, state: LMState, usr_token_idx: int) -> Tuple[LMState, float]:
        w = self.usr_map[usr_token_idx] if self.usr_map is not None else usr_token_idx
        row = self._logprobs(state.ngram)
        nh = (state.ngram + (w,))[-self.context:]
        return LMState(nh), float(row[w]) / LN10

    def finish(self, state: LMState) -> Tuple[LMState, float]:
        row = self._logprobs(state.ngram)
        return state, float(row[self.eos_id]) / LN10


def load_lm_vocab(path: str) -> List[str]:
    """``--lm_vocab``: one token per line, its index the line's."""
    with open(path) as f:
        return [line.strip().split()[0] for line in f if line.strip()]


def load_convlm(model_path: str, lm_vocab_path: str,
                usr_vocab: Optional[Sequence[str]] = None, lm_memory: int = 10000,
                device: str = "cuda") -> ConvLM:
    """The ``--lmtype=convlm`` LM: the model of a self-describing LM checkpoint
    (the port's ``lm_model.bin`` from ``cli/train_lm.py``, or a JAX
    ``W2LTPU01`` one; the arch is in its config) on ``device``, with the
    ``--lm_vocab`` mapping and an ``lm_memory`` cache. The context stays at
    the class's 48, as in JAX."""
    from ..config import Config
    from ..models.lm import build_lm_model
    from ..runtime.checkpoint import load_checkpoint
    from ..runtime.test import resolve_device

    if not lm_vocab_path:
        raise ValueError("--lmtype=convlm requires --lm_vocab")
    t0 = time.perf_counter()
    dev = resolve_device(device)
    vocab = load_lm_vocab(lm_vocab_path)
    ckpt = load_checkpoint(model_path)
    cfg = Config.deserialize(ckpt.config)
    arch = os.path.join(cfg.archdir, cfg.arch) if cfg.archdir else cfg.arch
    # lm_vocab.txt of train_lm already holds </s> and <unk>; the model is made
    # on the device, where its initial weights cost no host time
    with torch.device(dev):
        model = build_lm_model(arch, len(vocab))
    model.load_state_dict(ckpt.state_dict, strict=True)
    lm = ConvLM(model, vocab, usr_vocab=usr_vocab, lm_memory=lm_memory)
    lm.stats["load_s"] = time.perf_counter() - t0
    return lm
