"""Meters: edit distance, loss, timers, throughput — the port of
``wav2letter_tpu/runtime/meters.py`` (reference ``TrainMeters``: runtime, timer,
sampletimer, fwdtimer, critfwdtimer, bwdtimer, optimtimer and per-dataset
{tknEdit, wrdEdit, loss}) and of its status line. ``sync_meters`` is the
cross-rank reduction (reference ``syncMeter``): the error and loss counts
summed over the data axis."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.editdistance import edit_distance


class EditDistanceMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.errors = 0
        self.total = 0

    def add(self, ref: Sequence, hyp: Sequence):
        self.errors += edit_distance(ref, hyp)
        self.total += len(ref)

    def error_rate(self) -> float:
        return 100.0 * self.errors / max(1, self.total)

    def state(self):
        return [self.errors, self.total]

    def load_state(self, s):
        self.errors, self.total = int(s[0]), int(s[1])


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.n = 0

    def add(self, v: float, n: int = 1):
        self.sum += float(v) * n
        self.n += n

    def value(self) -> float:
        return self.sum / max(1, self.n)

    def state(self):
        return [self.sum, self.n]

    def load_state(self, s):
        self.sum, self.n = float(s[0]), int(s[1])


class TimerMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self._t0: Optional[float] = None
        self.count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self._t0 = None
            self.count += 1

    def value(self) -> float:
        return self.total

    def avg_ms(self) -> float:
        return 1000.0 * self.total / max(1, self.count)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class SpeedMeter:
    """Throughput: audio seconds processed per wall second."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.audio_s = 0.0
        self.wall_t0 = time.perf_counter()

    def add_audio(self, seconds: float):
        self.audio_s += seconds

    def value(self) -> float:
        dt = time.perf_counter() - self.wall_t0
        return self.audio_s / max(1e-9, dt)


class DatasetMeters:
    def __init__(self):
        self.tkn_edit = EditDistanceMeter()
        self.wrd_edit = EditDistanceMeter()
        self.loss = AverageMeter()

    def reset(self):
        self.tkn_edit.reset()
        self.wrd_edit.reset()
        self.loss.reset()


class TrainMeters:
    def __init__(self, valid_tags: Sequence[str] = ()):
        self.runtime = TimerMeter()
        self.timer = TimerMeter()  # per-batch
        self.sample_timer = TimerMeter()
        self.fwd_timer = TimerMeter()
        self.crit_fwd_timer = TimerMeter()
        self.bwd_timer = TimerMeter()
        self.optim_timer = TimerMeter()
        self.speed = SpeedMeter()
        self.train = DatasetMeters()
        self.valid: Dict[str, DatasetMeters] = {t: DatasetMeters() for t in valid_tags}

    def reset_train(self):
        self.train.reset()
        self.speed.reset()
        for t in (
            self.timer,
            self.sample_timer,
            self.fwd_timer,
            self.crit_fwd_timer,
            self.bwd_timer,
            self.optim_timer,
        ):
            t.reset()


def sync_meters(meters: TrainMeters, mesh=None,
                datasets: Optional[List[DatasetMeters]] = None) -> TrainMeters:
    """Sum the edit and loss states of ``datasets`` (default: train, then
    every validation set) over the data axis of ``mesh``, in the JAX order:
    the edit states of all, then the loss states of all. The ranks of a model
    group meter the same rows, so the model axis is not summed. Without a
    mesh of several ranks there is nothing to reduce."""
    if mesh is None or not mesh.distributed:
        return meters
    if datasets is None:
        datasets = [meters.train] + list(meters.valid.values())
    objs = [o for ds in datasets for o in (ds.tkn_edit, ds.wrd_edit)]
    objs += [ds.loss for ds in datasets]
    vals = torch.tensor([v for o in objs for v in o.state()], dtype=torch.float64,
                        device=mesh.device)
    dist.all_reduce(vals, group=mesh.data_group)
    summed = vals.cpu().tolist()
    for i, o in enumerate(objs):
        o.load_state(summed[2 * i: 2 * i + 2])
    return meters


def get_log_string(
    meters: TrainMeters,
    epoch: int,
    updates: int,
    lr: float,
    lr_crit: float = 0.0,
) -> str:
    """Status line in the reference's format (``getLogString`` analog)."""
    parts = [
        f"epoch: {epoch:8d}",
        f"nupdates: {updates:12d}",
        f"lr: {lr:09.6f}",
        f"lrcriterion: {lr_crit:09.6f}",
        f"runtime: {meters.runtime.value():.2f}s",
        f"bch(ms): {meters.timer.avg_ms():.2f}",
        f"smp(ms): {meters.sample_timer.avg_ms():.2f}",
        f"fwd(ms): {meters.fwd_timer.avg_ms():.2f}",
        f"crit-fwd(ms): {meters.crit_fwd_timer.avg_ms():.2f}",
        f"bwd(ms): {meters.bwd_timer.avg_ms():.2f}",
        f"optim(ms): {meters.optim_timer.avg_ms():.2f}",
        f"loss: {meters.train.loss.value():10.5f}",
        f"train-TER: {meters.train.tkn_edit.error_rate():5.2f}",
        f"train-WER: {meters.train.wrd_edit.error_rate():5.2f}",
    ]
    for tag, ds in meters.valid.items():
        parts.append(f"{tag}-loss: {ds.loss.value():10.5f}")
        parts.append(f"{tag}-TER: {ds.tkn_edit.error_rate():5.2f}")
        parts.append(f"{tag}-WER: {ds.wrd_edit.error_rate():5.2f}")
    parts.append(f"avg-isz(audio-s/s): {meters.speed.value():08.2f}")
    return " | ".join(parts)
