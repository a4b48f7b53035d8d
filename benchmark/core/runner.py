"""One run of one cell: set-up, the measured window, the traced window (with
``--trace 1``), the comparison with the reference, the result line.

Set-up (all of it counted in ``setup_s``): the constructors' files under a
work directory in ``TMPDIR``, the seeded weights on the device, the system,
the pool's batches from the seed, and every batch shape of the cell once.
A training cell's first three updates are its checked steps: the one
``Trainer`` of the run takes them through the window's own call, on three
different batches, before the other shapes are warmed up.

The window runs whole cycles through the pool, each batch once a cycle in
the seed's order, until ``--seconds`` have passed at a cycle's end. In a
serving cell a closed loop hands over the next batch once the previous
one's tokens are on the host. With ``--trace 1`` one more cycle runs under
the profiler after the window: the per-layer metrics read the whole pool's
mix, whatever the seed. The harness's process keeps to ``THREADS`` host
threads, so that it loads the shared host alike from run to run.

After the window (and the peak memory read) the program is freed and the
reference runs: the three updates from the same weights and batches, or the
sampled served batches. A metric that finds nothing to read (a roofline whose
kernels no longer run under the names it knows) fails the run.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, manifest, shapes, system, traffic, weights
from . import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wav2letter_tpu")
CHECKED_STEPS = 3
SAMPLED = 4
THREADS = 4


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_metric(name: str) -> Callable:
    path = manifest.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a metric's reader reads: the window's batches and wall, the
    traced batches and their trace, the set-up time, the arch's calls."""

    def __init__(self, config: dict, mix: dict):
        self.lines = manifest.arch_lines(config)
        self.n_feat = int(config["flags"]["filterbanks"])
        self.n_label = int(config["n_classes"])
        self.itemsize = 2 if config["flags"].get("compute_dtype", "bfloat16") == "bfloat16" else 4
        self.setup_s = 0.0
        self.window: List[traffic.BatchShape] = []
        self.window_s = 0.0
        self.traced: List[traffic.BatchShape] = []
        self.trace: Optional[tracing.Trace] = None
        self._calls: Dict[int, dict] = {}

    def calls(self, shape: traffic.BatchShape) -> dict:
        if shape.index not in self._calls:
            self._calls[shape.index] = shapes.walk(self.lines, self.n_feat, self.n_label,
                                                   shape.rows, shape.frames)
        return self._calls[shape.index]


def _window(seconds: float, device, step: Callable[[int], None], cycle: int) -> float:
    """Calls ``step(i)`` for i = 0, 1, ... in whole cycles of ``cycle`` calls
    (every batch of the pool once) until ``seconds`` have passed at a cycle's
    end, then waits for the device; returns the wall seconds. Whole cycles
    make every window's work the pool's mix, whatever the seed's order."""
    t0 = time.perf_counter()
    i = 0
    while True:
        step(i)
        i += 1
        if i % cycle == 0 and time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return time.perf_counter() - t0


def run(config: dict, mix: dict, limits: dict, metric_names: List[str], seed: int,
        seconds: float, traced: bool, device: str, t_start: float) -> dict:
    """The result of one run (the dict of the last line), checks last."""
    n_classes = int(config["n_classes"])
    ctx = Context(config, mix)
    work = tempfile.mkdtemp(prefix="w2l-bench-")
    try:
        files = system.write_files(work, n_classes, config["flags"].get("wordseparator", "|"))
        w = weights.seeded(system.param_shapes(config), seed, device)
        inputs = {n: t.cpu() for n, t in w.items()}  # for the reference
        pool = traffic.pool(mix)
        order = traffic.order(len(pool), seed)
        batches = [traffic.make_batch(s, seed, n_classes, device) for s in pool]
        if mix["mode"] == "train":
            out = _train(config, mix, files, seed, device, w, inputs, pool, order, batches,
                         ctx, seconds, traced, t_start)
        elif mix["mode"] == "infer":
            out = _infer(config, mix, files, seed, device, w, inputs, pool, order, batches,
                         ctx, seconds, traced, t_start)
        else:
            raise ValueError(f"traffic mode {mix['mode']!r}")
        del w
        attempted, failed, peak, reference_job = out[1:]
        del out  # the program and its state
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        numbers = reference_job()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    metrics = {}
    for name in metric_names:
        value = load_metric(name)(ctx)
        if value is None:
            raise LookupError(f"{name} found nothing to read in this run")
        metrics[name] = value
    result = {"correct": None, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if torch.device(device).type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if traced and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                               "idle_gaps": ctx.trace.idle_gaps(10)}
    checks = check.judge(numbers, limits)
    result["correct"] = check.passed(checks) and failed == 0
    result["not_compared"] = {k: v for k, v in numbers.items() if k not in checks}
    result["checks"] = checks
    return result


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def _train(config, mix, files, seed, device, w, inputs, pool, order, batches, ctx, seconds,
           traced, t_start):
    prog = system.TrainSystem(config, files, seed, device, w)
    start = prog.tr.updates
    checked = [batches[k] for k in order[:CHECKED_STEPS]]
    losses, grad = [], None
    for i, b in enumerate(checked):
        lr = prog.lr()
        loss, _ = prog.step(b)
        losses.append(loss)
        if i == 0:
            grad = prog.first_gradient(inputs, lr)
    with torch.no_grad():
        change = {n: float((p - inputs[n].to(p.device)).double().norm())
                  for n, p in prog.params().items()}
    for k in order[CHECKED_STEPS:]:  # every other shape once
        prog.step(batches[k])
    sync(device)
    ctx.setup_s = time.perf_counter() - t_start
    n = len(order)
    done, failed = [], [0]

    def step(i):
        k = order[i % n]
        _, finite = prog.step(batches[k])
        done.append(pool[k])
        failed[0] += 0 if finite else 1

    ctx.window_s = _window(seconds, device, step, n)
    ctx.window = done
    if traced:
        ctx.trace = tracing.record(lambda: [prog.step(batches[k]) for k in order])
        ctx.traced = [pool[k] for k in order]
    peak = _peak(device)

    def reference():
        from ..reference.steps import Reference

        ref = Reference(manifest.arch_lines(config), config["flags"], int(config["n_classes"]),
                        inputs, device)
        ref_losses, ref_grad = [], None
        for i, b in enumerate(checked):
            loss, g, _ = ref.train_step(b, start + i, seed)
            ref_losses.append(loss)
            if i == 0:
                ref_grad = {n: float(t.double().norm()) for n, t in g.items()}
            del g
        with torch.no_grad():
            ref_change = {n: float((p.detach().cpu() - inputs[n]).double().norm())
                          for n, p in ref.params.items()}
        return check.train_numbers(losses, ref_losses, grad, ref_grad, change, ref_change)

    return prog, len(done), failed[0], peak, reference


def _infer(config, mix, files, seed, device, w, inputs, pool, order, batches, ctx, seconds,
           traced, t_start):
    prog = system.InferSystem(config, files, seed, device, w, int(mix["batch"]))
    for k in order:  # every shape once
        prog.serve(batches[k])
    sync(device)
    ctx.setup_s = time.perf_counter() - t_start
    n = len(order)
    served = []

    def step(i):
        k = order[i % n]
        served.append((k, prog.serve(batches[k])))

    ctx.window_s = _window(seconds, device, step, n)
    ctx.window = [pool[k] for k, _ in served]
    if traced:
        ctx.trace = tracing.record(lambda: [prog.serve(batches[k]) for k in order])
        ctx.traced = [pool[k] for k in order]
    peak = _peak(device)
    rng = np.random.default_rng([seed, 2])
    longest = max(range(len(served)), key=lambda i: pool[served[i][0]].frames)
    rest = [i for i in range(len(served)) if i != longest]
    pick = [longest] + list(rng.choice(rest, size=min(SAMPLED - 1, len(rest)), replace=False))
    sample = [served[i] for i in pick]
    del served[:]

    def reference():
        from ..reference.steps import Reference

        ref = Reference(manifest.arch_lines(config), config["flags"], int(config["n_classes"]),
                        inputs, device)
        refs = [ref.emissions(batches[k]) for k, _ in sample]
        return check.serve_numbers([out for _, out in sample], refs, int(config["n_classes"]) - 1)

    return prog, len(ctx.window), 0, peak, reference


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def environment(root) -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
