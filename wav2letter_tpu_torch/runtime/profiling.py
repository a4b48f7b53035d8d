"""Tracing / profiling utilities — the port of
``wav2letter_tpu/runtime/profiling.py``.

Reference analogs: stage timers with explicit device sync around every train
phase (``cpc/Train.cpp:1131-1140``), ``TimeElapsedReporter`` scope timers in
the inference examples (``examples/Util.{h,cpp}``), ArrayFire memory-manager
stat dumps at checkpoints (``Train.cpp:713-717``).

Here: ``torch.profiler`` traces (a Chrome trace of host ranges and, on a
card, kernels), scope timers that synchronize the device the caller names, the
CUDA caching allocator's statistics, and the FLOPs of one call counted by
``torch.utils.flop_counter``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

import torch


class TimeElapsedReporter:
    """Scope timer printing '<name> took Xms' (reference Util.h). ``sync``: a
    device (``torch.device`` or its name); a CUDA one is synchronized before
    the clock is read, so the time covers the work queued in the scope."""

    def __init__(self, name: str, sync: Any = None, quiet: bool = False):
        self.name = name
        self.sync = None if sync is None else torch.device(sync)
        self.quiet = quiet
        self.elapsed_ms: Optional[float] = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if self.sync is not None and self.sync.type == "cuda":
            torch.cuda.synchronize(self.sync)
        self.elapsed_ms = 1000.0 * (time.perf_counter() - self.t0)
        if not self.quiet:
            print(f"[{self.name}] took {self.elapsed_ms:.1f} ms", flush=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope with ``torch.profiler`` (the host, and the card when
    there is one) and write ``<log_dir>/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory statistics in MB (the ArrayFire stats-dump analog),
    under JAX's keys: the caching allocator's current and peak allocated
    bytes, and the card's total memory as the limit. Empty without a card
    (JAX's CPU devices report none either)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": s.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_mb": s.get("allocated_bytes.all.peak", 0) / 1e6,
            "bytes_limit_mb": torch.cuda.get_device_properties(i).total_memory / 1e6,
        }
    return out


def log_compile_cost(fn, *args) -> Dict[str, float]:
    """FLOPs of one call ``fn(*args)``, counted by ``FlopCounterMode`` over the
    operators it dispatches (matrix products and convolutions, forward and,
    if the call runs one, backward). Only ``flops``: PyTorch has no count of
    the bytes a call accesses, so JAX's ``bytes_accessed`` is not returned."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return {"flops": float(fc.get_total_flops())}
