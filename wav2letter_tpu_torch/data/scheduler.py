"""DataScheduler — interleaves multiple datasets by iteration counts.

The port of ``wav2letter_tpu/data/scheduler.py`` (a copy).

Reference: ``recipes/local_prior_match/src/runtime/DataScheduler.{h,cpp}``
(219 LoC; API at ``DataScheduler.h:22-62``): given datasets with per-dataset
``iterations`` counts and learning-rate tags, yields batches in a repeating
schedule (ds0 x n0, ds1 x n1, ...), reshuffling each epoch.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .dataset import AsrDataset, PrefetchIterator


class DataScheduler:
    def __init__(
        self,
        datasets: Sequence[AsrDataset],
        iterations: Sequence[int],
        num_threads: int = 1,
        seed: int = 0,
    ):
        assert len(datasets) == len(iterations)
        self.datasets = list(datasets)
        self.iterations = [max(0, int(i)) for i in iterations]
        self.num_threads = num_threads
        self.seed = seed
        self._gens: List[Iterator] = [self._cycle(i) for i in range(len(datasets))]

    def _cycle(self, i: int):
        epoch = 0
        while True:
            epoch += 1
            specs = self.datasets[i].batch_specs(shuffle_seed=self.seed + epoch)
            for b in PrefetchIterator(
                self.datasets[i], specs, num_threads=self.num_threads
            ):
                yield b

    def __iter__(self) -> Iterator[Tuple[int, Dict]]:
        """Yields (dataset_index, batch) following the schedule forever."""
        while True:
            for i, n in enumerate(self.iterations):
                for _ in range(n):
                    yield i, next(self._gens[i])

    def set_iterations(self, iterations: Sequence[int]):
        self.iterations = [max(0, int(i)) for i in iterations]
