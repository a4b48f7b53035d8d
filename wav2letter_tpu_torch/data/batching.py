"""Length bucketing and static-shape batching (TPU-first).

The reference sorts samples by length (``--dataorder=input|input_spiral|
output_spiral`` with ``--inputbinsize`` ms bins) and batches either a fixed
``--batchsize`` or dynamically up to ``--batching_max_duration`` seconds
(``createDataset``, ``cpc/Train.cpp:757-802``). On GPU each batch is padded to
its own max length; on TPU that would trigger one XLA compilation per shape.

TPU-native redesign: every emitted batch is padded to a *bucket boundary* —
time padded up to a multiple of ``pad_multiple`` frames and target length to a
multiple of ``target_pad_multiple`` — so the number of distinct compiled shapes
is bounded and small, while sorting keeps padding waste low (same effect the
reference gets from dynamic batching, with a compilation-friendly shape set).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .listfile import ListSample


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 0 else x


@dataclasses.dataclass
class BatchSpec:
    """Indices of samples in a batch plus its padded static shape."""

    indices: List[int]
    max_input_frames: int  # padded (bucket boundary)
    max_target_len: int  # padded
    # multi-process: materialize exactly this many rows (pad rows appended)
    # so every rank contributes the same local shard shape; 0 = len(indices)
    pad_rows: int = 0


class LengthBucketer:
    """Sorts/filters/shards samples and yields static-shape batch specs."""

    def __init__(
        self,
        input_lengths: Sequence[float],  # per-sample input length (frames)
        target_lengths: Sequence[int],
        batch_size: int,
        data_order: str = "input",
        input_bin_size: int = 100,  # in frames here (caller converts from ms)
        batching_strategy: str = "none",
        batching_max_frames: float = 0.0,  # dynamic: frames budget per batch
        pad_multiple: int = 128,
        target_pad_multiple: int = 32,
        world_rank: int = 0,
        world_size: int = 1,
        max_target_cap: Optional[int] = None,
    ):
        self.input_lengths = np.asarray(input_lengths, dtype=np.float64)
        self.target_lengths = np.asarray(target_lengths, dtype=np.int64)
        self.batch_size = batch_size
        self.pad_multiple = max(1, pad_multiple)
        self.target_pad_multiple = max(1, target_pad_multiple)
        self.world_rank = world_rank
        self.world_size = max(1, world_size)
        self.max_target_cap = max_target_cap

        n = len(self.input_lengths)
        order = np.arange(n)
        # Reference dataorder semantics: samples in the same --inputbinsize
        # bin are considered equal-length; "input" keeps stable order inside
        # a bin, "input_spiral" orders a bin by OUTPUT length (that is the
        # spiral — binning must be the primary key or it is a no-op).
        if data_order == "input":
            keys = (self.input_lengths // max(1, input_bin_size)).astype(np.int64)
            order = np.lexsort((np.arange(n), keys))
        elif data_order == "input_spiral":
            keys = (self.input_lengths // max(1, input_bin_size)).astype(np.int64)
            order = np.lexsort((self.input_lengths, self.target_lengths, keys))
        elif data_order == "output_spiral":
            order = np.lexsort((self.input_lengths, self.target_lengths))
        self.order = order

        self.batches: List[BatchSpec] = []
        if batching_strategy == "dynamic" and batching_max_frames > 0:
            self._build_dynamic(batching_max_frames)
        else:
            self._build_fixed()
        # Shard WITHIN each batch (reference shards samples,
        # ``cpc/Train.cpp:765-766``): every rank sees the same global batch
        # list — same count, same padded (T, U) shapes computed from the FULL
        # index set — and takes a strided slice of the rows. Lockstep SPMD
        # across processes requires identical per-step global shapes; sharding
        # whole batches would let ranks land in different length buckets.
        if self.world_size > 1:
            ws = self.world_size
            self.batches = [
                BatchSpec(
                    spec.indices[self.world_rank :: ws],
                    spec.max_input_frames,
                    spec.max_target_len,
                    pad_rows=(len(spec.indices) + ws - 1) // ws,
                )
                for spec in self.batches
            ]

    def _pad_shape(self, idxs: np.ndarray) -> Tuple[int, int]:
        t = int(round_up(int(self.input_lengths[idxs].max()), self.pad_multiple))
        u = int(self.target_lengths[idxs].max()) if len(idxs) else 0
        u = int(round_up(max(u, 1), self.target_pad_multiple))
        if self.max_target_cap:
            u = min(u, self.max_target_cap)
        return t, u

    def _build_fixed(self) -> None:
        # --batchsize is PER-RANK (reference semantics: global batch =
        # world_size x batchsize); specs group the global batch
        bs = self.batch_size * self.world_size
        for i in range(0, len(self.order), bs):
            idxs = self.order[i : i + bs]
            if len(idxs) == 0:
                continue
            t, u = self._pad_shape(idxs)
            self.batches.append(BatchSpec(idxs.tolist(), t, u))

    def _build_dynamic(self, max_frames: float) -> None:
        # per-rank frames budget -> global budget (see _build_fixed)
        max_frames = max_frames * self.world_size
        cur: List[int] = []
        cur_max = 0.0
        for idx in self.order:
            l = float(self.input_lengths[idx])
            new_max = max(cur_max, l)
            # padded cost model: batch cost = padded_len * (n+1)
            if cur and new_max * (len(cur) + 1) > max_frames:
                arr = np.asarray(cur)
                t, u = self._pad_shape(arr)
                self.batches.append(BatchSpec(cur, t, u))
                cur, cur_max = [], 0.0
                new_max = l
            cur.append(int(idx))
            cur_max = new_max
        if cur:
            arr = np.asarray(cur)
            t, u = self._pad_shape(arr)
            self.batches.append(BatchSpec(cur, t, u))

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[BatchSpec]:
        return iter(self.batches)

    def shuffled(self, seed: int) -> List[BatchSpec]:
        rng = np.random.RandomState(seed)
        perm = rng.permutation(len(self.batches))
        return [self.batches[i] for i in perm]


def filter_samples(
    samples: Sequence[ListSample],
    target_lengths: Sequence[int],
    min_input_ms: float = 0.0,
    max_input_ms: float = 1e9,
    min_target: float = 0.0,
    max_target: float = 1e9,
) -> List[int]:
    """Length filters (``--minisz/--maxisz/--mintsz/--maxtsz``)."""
    keep = []
    for i, s in enumerate(samples):
        if not (min_input_ms <= s.duration_ms <= max_input_ms):
            continue
        if not (min_target <= target_lengths[i] <= max_target):
            continue
        keep.append(i)
    return keep


def pad_batch(
    arrays: List[np.ndarray],
    max_len: int,
    pad_value: float = 0.0,
    dtype=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length [L, ...] arrays into [B, max_len, ...] + lengths."""
    b = len(arrays)
    assert b > 0
    trailing = arrays[0].shape[1:]
    dtype = dtype or arrays[0].dtype
    out = np.full((b, max_len) + trailing, pad_value, dtype=dtype)
    lengths = np.zeros((b,), dtype=np.int32)
    for i, a in enumerate(arrays):
        l = min(a.shape[0], max_len)
        out[i, :l] = a[:l]
        lengths[i] = l
    return out, lengths


def pad_batch_rows(batch: dict, multiple: int) -> dict:
    """Pad the batch (row) dimension to a multiple of the data-mesh size.

    Pad rows get audio_len=0 / target_len=0 and sample_idx=-1; the train
    step masks their losses out and meters skip them. Required because pjit
    shards the leading axis over the data mesh axis (must divide evenly).
    """
    b = next(iter(batch.values())).shape[0]
    target = round_up(b, multiple)
    if target == b:
        out = dict(batch)
    else:
        pad = target - b
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):  # host features (bf16 has no numpy dtype)
                out[k] = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                continue
            widths = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
            fill = -1 if k == "sample_idx" else 0
            out[k] = np.pad(v, widths, constant_values=fill)
    out["row_mask"] = (out["sample_idx"] >= 0).astype(np.float32)
    return out


def make_batches(
    input_arrays: List[np.ndarray],
    target_arrays: List[np.ndarray],
    spec: BatchSpec,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Materialize one padded batch from per-sample arrays."""
    xs = [input_arrays[i] for i in spec.indices]
    ys = [target_arrays[i] for i in spec.indices]
    x, xlen = pad_batch(xs, spec.max_input_frames, 0.0)
    y, ylen = pad_batch(ys, spec.max_target_len, -1, dtype=np.int32)
    return x, xlen, y, ylen
