"""ASR dataset: .lst -> (audio, lengths, targets) batches with host prefetch.

Reference pipeline (``createDataset`` + ``loadPrefetchDataset``,
``cpc/Train.cpp:757-802, 877-878``): list files → audio decode → featurize →
target encode → sort/bucket → batch → shard → N-thread prefetch.

Copied from the JAX package: featurization happens on the device after the
batch is built — the host pipeline decodes audio, applies the
``--sfx_config`` chain and encodes targets — unless a host featurizer is set
(``--features_device=host``). Batches are padded to a bounded set of shapes
(see batching.py).

Each batch is a dict of numpy arrays:
    audio      (B, S)  float32, zero-padded
    audio_len  (B,)    int32 — valid samples per row
    (with a host featurizer, ``feats`` (B, T, C), a CPU tensor in fp32 or
    bf16, and ``feat_len`` (B,) int32 take the place of ``audio``)
    target     (B, U)  int32, padded with -1
    target_len (B,)    int32
    sample_idx (B,)    int64 — index into the dataset's sample list
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import Config
from .audio import load_audio
from .batching import BatchSpec, LengthBucketer, filter_samples
from .dictionary import Dictionary, Lexicon
from .listfile import ListSample, read_list_files
from .targets import TargetOptions, encode_transcript


class AsrDataset:
    """Maps a .lst file to static-shape batches; lazy audio loading."""

    def __init__(
        self,
        list_path: str,
        token_dict: Dictionary,
        lexicon: Optional[Lexicon],
        cfg: Config,
        target_opts: Optional[TargetOptions] = None,
        batch_size: Optional[int] = None,
        world_rank: int = 0,
        world_size: int = 1,
        allow_empty_targets: bool = False,
        max_load: int = -1,
    ):
        self.cfg = cfg
        self.token_dict = token_dict
        self.lexicon = lexicon
        # comma-separated list specs + --datadir prefix (reference
        # pathsConcat semantics; multi-list --train in the sota/mls cfgs)
        self.samples: List[ListSample] = read_list_files(
            list_path, getattr(cfg, "datadir", ""))
        if max_load is None or max_load < 0:
            max_load = cfg.max_load
        if max_load and max_load > 0:
            self.samples = self.samples[:max_load]
        self.topts = target_opts or TargetOptions(
            word_separator=cfg.wordseparator,
            use_wordpiece=cfg.usewordpiece,
            surround=cfg.surround,
            replabel=cfg.replabel,
            sample_target=cfg.sampletarget,
            criterion=cfg.criterion,
            base_dict_size=len(token_dict)
            - (cfg.replabel if cfg.criterion == "asg" else 0)
            - (1 if cfg.criterion == "ctc" else 0),
        )
        rng = random.Random(cfg.seed)
        self.targets: List[np.ndarray] = []
        for s in self.samples:
            ids = encode_transcript(s.words, token_dict, lexicon, self.topts, rng)
            if not ids and not allow_empty_targets:
                ids = []
            self.targets.append(np.asarray(ids, dtype=np.int32))

        keep = filter_samples(
            self.samples,
            [len(t) for t in self.targets],
            cfg.minisz,
            cfg.maxisz,
            cfg.mintsz,
            cfg.maxtsz,
        )
        self.samples = [self.samples[i] for i in keep]
        self.targets = [self.targets[i] for i in keep]

        # input length in feature frames (duration/stride)
        stride_ms = cfg.framestridems
        self.frame_lengths = np.array(
            [max(1, int(s.duration_ms / stride_ms)) for s in self.samples]
        )
        bs = batch_size if batch_size is not None else cfg.batchsize
        max_frames = (
            cfg.batching_max_duration * 1000.0 / stride_ms
            if cfg.batching_strategy == "dynamic"
            else 0.0
        )
        self.bucketer = LengthBucketer(
            self.frame_lengths,
            [len(t) for t in self.targets],
            batch_size=bs,
            data_order=cfg.dataorder,
            input_bin_size=max(1, int(cfg.inputbinsize / stride_ms)),
            batching_strategy=cfg.batching_strategy,
            batching_max_frames=max_frames,
            pad_multiple=cfg.pad_multiple,
            world_rank=world_rank,
            world_size=world_size,
        )
        # sound-effect augmentation chain (--sfx_config)
        self.sfx = None
        if cfg.sfx_config:
            from .sfx import read_sound_effect_config

            self.sfx = read_sound_effect_config(cfg.sfx_config, cfg.seed)
        self.host_featurizer = None

        # samples per frame for audio padding: frames*stride + framesize
        self.sr = cfg.samplerate
        self.stride_samples = int(round(stride_ms * self.sr / 1000.0))
        self.frame_samples = int(round(cfg.framesizems * self.sr / 1000.0))

    def __len__(self) -> int:
        return len(self.bucketer)

    def batch_specs(self, shuffle_seed: Optional[int] = None) -> List[BatchSpec]:
        if shuffle_seed is None:
            return list(self.bucketer)
        return self.bucketer.shuffled(shuffle_seed)

    def audio_samples_for_frames(self, n_frames: int) -> int:
        """Padded sample count such that featurizing yields >= n_frames frames."""
        return (n_frames - 1) * self.stride_samples + self.frame_samples

    def set_host_featurizer(self, featurizer) -> None:
        """Featurize in the prefetch threads (reference W2lDataset
        placement): ``materialize`` then ships (B, T, C) features instead of
        raw audio — see ``features.HostFeaturizer``. ``audio_len`` is kept
        for the speed meters."""
        self.host_featurizer = featurizer

    def materialize(self, spec: BatchSpec) -> Dict[str, np.ndarray]:
        # pad_rows: multi-process lockstep — every rank materializes the same
        # local row count (rows beyond the index list are padding rows with
        # sample_idx=-1, masked out of the loss and meters)
        b = max(len(spec.indices), spec.pad_rows)
        s_max = self.audio_samples_for_frames(spec.max_input_frames)
        audio = np.zeros((b, s_max), dtype=np.float32)
        audio_len = np.zeros((b,), dtype=np.int32)
        tgt = np.full((b, spec.max_target_len), -1, dtype=np.int32)
        tgt[len(spec.indices) :] = 0  # pad rows: 0-fill like pad_batch_rows
        tgt_len = np.zeros((b,), dtype=np.int32)
        for i, idx in enumerate(spec.indices):
            wav = load_audio(self.samples[idx].audio_path, self.sr)
            if self.sfx is not None:
                wav = self.sfx(wav)
            l = min(len(wav), s_max)
            audio[i, :l] = wav[:l]
            audio_len[i] = l
            t = self.targets[idx][: spec.max_target_len]
            tgt[i, : len(t)] = t
            tgt_len[i] = len(t)
        sample_idx = np.concatenate(
            [
                np.asarray(spec.indices, dtype=np.int64),
                np.full((b - len(spec.indices),), -1, np.int64),
            ]
        )
        if self.host_featurizer is not None:
            feats, flen = self.host_featurizer(audio, audio_len)
            return {
                "feats": feats,
                "feat_len": flen.astype(np.int32),
                "audio_len": audio_len,
                "target": tgt,
                "target_len": tgt_len,
                "sample_idx": sample_idx,
            }
        return {
            "audio": audio,
            "audio_len": audio_len,
            "target": tgt,
            "target_len": tgt_len,
            "sample_idx": sample_idx,
        }


class PrefetchIterator:
    """Background-thread batch materialization (reference loadPrefetchDataset)."""

    def __init__(
        self,
        dataset: AsrDataset,
        specs: Sequence[BatchSpec],
        num_threads: int = 2,
        queue_size: int = 8,
    ):
        self.dataset = dataset
        self.specs = list(specs)
        self.num_threads = max(1, num_threads)
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._started = False
        self._n_done = 0
        self._lock = threading.Lock()
        self._next_spec = 0
        self._results: Dict[int, Dict[str, np.ndarray]] = {}
        self._emit_idx = 0

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                if self._next_spec >= len(self.specs):
                    return
                i = self._next_spec
                self._next_spec += 1
            batch = self.dataset.materialize(self.specs[i])
            self.queue.put((i, batch))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._started:
            self._threads = [
                threading.Thread(target=self._worker, daemon=True)
                for _ in range(self.num_threads)
            ]
            for t in self._threads:
                t.start()
            self._started = True
        emitted = 0
        pending: Dict[int, Dict[str, np.ndarray]] = {}
        want = 0
        while emitted < len(self.specs):
            if want in pending:
                batch = pending.pop(want)
                want += 1
                emitted += 1
                yield batch
                continue
            i, batch = self.queue.get()
            pending[i] = batch
        self._stop.set()

    def __len__(self):
        return len(self.specs)
