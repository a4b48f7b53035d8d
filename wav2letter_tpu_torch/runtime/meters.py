"""Edit-distance and loss meters — the port of the per-dataset meters of
``wav2letter_tpu/runtime/meters.py`` (reference ``DatasetMeters{tknEdit,
wrdEdit, loss}``). Timers, throughput and the cross-process reduction belong
to the training slice."""

from __future__ import annotations

from typing import Sequence

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


class DatasetMeters:
    def __init__(self):
        self.tkn_edit = EditDistanceMeter()
        self.wrd_edit = EditDistanceMeter()
        self.loss = AverageMeter()

    def reset(self):
        self.tkn_edit.reset()
        self.wrd_edit.reset()
        self.loss.reset()
