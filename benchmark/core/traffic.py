"""One general generator for every traffic mix: a mix is a data file of
parameters (``benchmark/traffic/<mix>.json``), read here.

Parameters of a mix:
  mode             ``train`` (updates) or ``infer`` (batch transcription)
  batch            utterances a batch (per rank)
  utterances       the pool's size (a multiple of ``batch``)
  seconds_quantiles  [[q, seconds], ...]: the pool's length distribution, a
                   piecewise-linear quantile function from q = 0 to 1
  tokens_per_s     [lo, hi]: target tokens a second of audio (train)
  pad_frames, pad_tokens  the data layer's padding of frames and targets
  sample_rate      audio samples a second

The set of utterance lengths, target lengths and hence batch shapes is the
same for every seed: length i of N is the quantile at (i + 0.5) / N, and its
token rate a fixed low-discrepancy point of ``tokens_per_s``. Batches are runs
of ``batch`` utterances in length order, as the data layer sorts them. The
seed changes only the order of the batches (and of the rows inside one), the
audio and the target tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

GOLDEN = 0.6180339887498949


@dataclasses.dataclass
class BatchShape:
    """One batch of the pool: its utterances' lengths in samples and target
    tokens, and the padded shape the data layer gives it."""
    index: int
    samples: np.ndarray  # (b,) int64 audio samples of each utterance
    tokens: np.ndarray  # (b,) int64 target tokens of each utterance
    frames: int  # padded feature frames T
    max_tokens: int  # padded target length U
    audio_s: float  # real (unpadded) audio seconds

    @property
    def rows(self) -> int:
        return len(self.samples)

    @property
    def width(self) -> int:
        """Padded audio samples S, so that featurizing yields T frames."""
        return (self.frames - 1) * 160 + 400


def quantile(q: np.ndarray, table) -> np.ndarray:
    t = np.asarray(table, dtype=np.float64)
    return np.interp(q, t[:, 0], t[:, 1])


def pool(mix: dict) -> List[BatchShape]:
    """The mix's batches, in length order (the same for every seed)."""
    n, b = int(mix["utterances"]), int(mix["batch"])
    if n % b:
        raise ValueError(f"utterances {n} is not a multiple of the batch {b}")
    sr = int(mix.get("sample_rate", 16000))
    secs = quantile((np.arange(n) + 0.5) / n, mix["seconds_quantiles"])
    samples = np.round(secs * sr).astype(np.int64)
    lo, hi = mix.get("tokens_per_s", [3.0, 4.0])
    rate = lo + (hi - lo) * ((np.arange(n) * GOLDEN) % 1.0)
    tokens = np.maximum(1, np.round(secs * rate)).astype(np.int64)
    pf, pt = int(mix.get("pad_frames", 128)), int(mix.get("pad_tokens", 32))
    out = []
    for k in range(n // b):
        s, u = samples[k * b:(k + 1) * b], tokens[k * b:(k + 1) * b]
        frames = int(s.max() * 1000 // sr) // 10  # the data layer's duration_ms / 10
        out.append(BatchShape(k, s, u, -(-max(frames, 1) // pf) * pf,
                              -(-int(u.max()) // pt) * pt, float(s.sum()) / sr))
    return out


def order(n_batches: int, seed: int) -> np.ndarray:
    """The seed's order of the batches (a cycle through all of them)."""
    return np.random.default_rng([seed, 1]).permutation(n_batches)


def make_batch(shape: BatchShape, seed: int, n_classes: int, device="cpu",
               rank: int = 0) -> Dict[str, np.ndarray]:
    """The numpy dict the data layer yields for ``shape``, from the seed:
    white noise under a random gain every quarter second (so no mel band sits
    at the log floor), zero past each utterance's end; target tokens uniform
    over the classes but the blank (the last), padded with -1."""
    g = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + shape.index * 7919 + rank * 104_729) % (2 ** 63))
    b, S = shape.rows, shape.width
    perm = torch.randperm(b, generator=g, device=device).cpu().numpy()
    samples, tokens = shape.samples[perm], shape.tokens[perm]
    blocks = -(-S // 4000)
    gain = torch.rand((b, blocks), generator=g, device=device) * 0.8 + 0.2
    audio = torch.randn((b, S), generator=g, device=device) * 0.5
    audio *= gain.repeat_interleave(4000, dim=1)[:, :S]
    audio *= (torch.arange(S, device=device)[None, :]
              < torch.as_tensor(samples, device=device)[:, None])
    U = shape.max_tokens
    tgt = torch.randint(0, n_classes - 1, (b, U), generator=g, device=device).cpu().numpy()
    tgt = np.where(np.arange(U)[None, :] < tokens[:, None], tgt, -1).astype(np.int32)
    return {
        "audio": audio.cpu().numpy(),
        "audio_len": samples.astype(np.int32),
        "target": tgt,
        "target_len": tokens.astype(np.int32),
        "sample_idx": (shape.index * b + perm).astype(np.int64),
    }
