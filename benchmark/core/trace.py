"""A traced window, read from the profiler's own timeline.

``record`` runs a function under ``torch.profiler`` (host and device
activities) inside the range ``bench/window``, which ends after a
synchronize, so that every kernel of the window lies inside it. From the
timeline (host and device on one clock):
  * kernels: each device operation (kernel, copy, set) with its start, its
    end and the host time of the call that launched it;
  * host events: the program's ranges (``w2l/*``) and ops, by thread;
  * busy: the union of the kernels' intervals inside the window; idle is the
    rest of the window's wall;
  * the device time of the kernels launched inside a named host range;
  * the idle gaps, each labelled with what the host was doing then.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Iterable, List, Optional, Tuple

WINDOW = "bench/window"
LABEL_NS = 20_000  # shorter gaps are summed unlabelled


@dataclasses.dataclass
class Kernel:
    name: str
    start: int  # ns
    end: int
    launch: Optional[int]  # ns, host time of the launching call


@dataclasses.dataclass
class HostEvent:
    name: str
    start: int
    end: int
    thread: int
    annotation: bool


@dataclasses.dataclass
class Trace:
    kernels: List[Kernel]
    host: List[HostEvent]
    lo: int
    hi: int

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        return _busy(self.kernels, self.lo, self.hi) / 1e9

    def family_s(self, pieces: Iterable[str]) -> float:
        """Device seconds of the kernels whose name holds one of ``pieces``
        (lower case)."""
        pieces = tuple(pieces)
        return sum(k.end - k.start for k in self.kernels
                   if any(p in k.name.lower() for p in pieces)) / 1e9

    def under_s(self, range_name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside the host range
        ``range_name``; None where the range never opened or launched none."""
        spans = [(h.start, h.end) for h in self.host if h.annotation and h.name == range_name]
        if not spans:
            return None
        total, found = 0, False
        for k in self.kernels:
            if k.launch is not None and any(a <= k.launch <= b for a, b in spans):
                total += k.end - k.start
                found = True
        return total / 1e9 if found else None

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(int)
        for k in self.kernels:
            by[k.name] += k.end - k.start
        return [[name[:160], ns / 1e9] for name, ns in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time inside the window by what the host's launching
        thread was doing at the middle of each gap: the innermost range and
        the innermost op open then (gaps under ``LABEL_NS`` summed apart)."""
        main = next(h.thread for h in self.host if h.name == WINDOW)
        evs = sorted((h for h in self.host if h.thread == main and h.name != WINDOW),
                     key=lambda h: (h.start, -h.end))
        by, stack, i = defaultdict(int), [], 0
        for a, b in gaps(self.kernels, self.lo, self.hi):
            if b - a < LABEL_NS:
                by[f"gaps under {LABEL_NS // 1000} us"] += b - a
                continue
            t = (a + b) // 2
            while i < len(evs) and evs[i].start <= t:
                stack.append(evs[i])
                i += 1
            stack = [h for h in stack if h.end >= t]
            ranges = [h.name for h in stack if h.annotation]
            ops = [h.name for h in stack if not h.annotation]
            by[f"{ranges[-1] if ranges else '-'} > {ops[-1] if ops else 'python'}"[:160]] += b - a
        return [[label, ns / 1e9] for label, ns in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _busy(kernels: List[Kernel], lo: int, hi: int) -> int:
    return sum(b - a for a, b in union(
        (max(k.start, lo), min(k.end, hi)) for k in kernels if k.end > lo and k.start < hi))


def gaps(kernels: List[Kernel], lo: int, hi: int) -> List[Tuple[int, int]]:
    out, at = [], lo
    for a, b in union((max(k.start, lo), min(k.end, hi)) for k in kernels
                      if k.end > lo and k.start < hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def record(fn: Callable[[], None]) -> Trace:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    return parse(prof.profiler.kineto_results.events())


def parse(events) -> Trace:
    """A ``Trace`` from the profiler's kineto events."""
    kernels, host, launches = [], [], {}
    lo = hi = None
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CPU"):
            annotation = bool(e.is_user_annotation())
            host.append(HostEvent(name, start, end, e.start_thread_id(), annotation))
            if e.correlation_id():
                launches[e.correlation_id()] = start
            if name == WINDOW:
                lo, hi = start, end
        elif not e.is_user_annotation() and not name.startswith("Activity Buffer"):
            kernels.append(Kernel(name, start, end, e.linked_correlation_id()))
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    for k in kernels:
        k.launch = launches.get(k.launch)
    return Trace(kernels, host, lo, hi)
