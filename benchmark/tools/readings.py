"""Readings that set a cell's limits: the compared numbers of the program's
sound runs and of the control, over many seeds, in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 [--control]
        [--fault half] [--fault nobias] [--dtype float32] [--device cuda:0]

For each seed it builds the cell's inputs (weights, batches) as a run does
and prints one JSON line:
  program  the numbers of the program against the reference: a training
           cell's three checked updates; a serving cell's sample of batches
  leaves   (training) each leaf's norm of the first gradient and of the
           change over the three updates, of every side read
  control  (``--control``) the reference computed on float8 operands put in
           the program's place, against the reference
  fault_half    (``--fault half``) the reference put in the program's place
                with half of each batch left out, the mean over the rest
  fault_nobias  (``--fault nobias``) the reference put in the program's place
                with Adam's bias correction left out
``--dtype`` is a witness, not a run of the cell: the program at another
compute dtype. A serving cell's line also gives the widest
gap away from the rows' ends (``inner_gap``: frames more than ``EDGE`` from
the last) and how far from its row's end the widest gap lies. A run's own
window is not run here.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EDGE = 16  # output frames at a row's end whose inputs reach into the padding


def _free(device):
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def train_readings(cell, seed, device, args, work):
    import torch

    from benchmark.core import check, manifest, runner, system, traffic, weights
    from benchmark.reference.numerics import Precision
    from benchmark.reference.steps import Reference

    cfg, mix = cell.config, cell.traffic
    n = int(cfg["n_classes"])
    files = system.write_files(work, n, cfg["flags"].get("wordseparator", "|"))
    w = weights.seeded(system.param_shapes(cfg), seed, device)
    inputs = {k: t.cpu() for k, t in w.items()}
    pool = traffic.pool(mix)
    order = traffic.order(len(pool), seed)
    batches = [traffic.make_batch(pool[k], seed, n, device) for k in order[:runner.CHECKED_STEPS]]
    lines = manifest.arch_lines(cfg)
    def follow(ref, bs):
        losses, grad = [], None
        for i, b in enumerate(bs):
            loss, g, _ = ref.train_step(b, start + i, seed)
            losses.append(loss)
            if i == 0:
                grad = {k: float(t.double().norm()) for k, t in g.items()}
        change = {k: float((p.detach().cpu() - inputs[k]).double().norm())
                  for k, p in ref.params.items()}
        return losses, grad, change

    out = {"seed": seed}
    t0 = time.perf_counter()
    prog = system.TrainSystem(cfg, files, seed, device, w)
    del w
    start = prog.tr.updates
    losses, grad = [], None
    for i, b in enumerate(batches):
        lr = prog.lr()
        losses.append(prog.step(b)[0])
        if i == 0:
            grad = prog.first_gradient(inputs, lr)
    with torch.no_grad():
        change = {k: float((p - inputs[k].to(p.device)).double().norm())
                  for k, p in prog.params().items()}
    del prog
    _free(device)
    out["program_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = follow(Reference(lines, cfg["flags"], n, inputs, device), batches)
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = check.train_numbers(losses, ref[0], grad, ref[1], change, ref[2])
    out["losses"] = {"program": losses, "reference": ref[0]}
    out["leaves"] = {"program": {"grad": grad, "change": change},
                     "reference": {"grad": ref[1], "change": ref[2]}}
    out["worst_leaf"] = {"grad": _worst(grad, ref[1], ref[1]), "change": _worst(change, ref[2],
                                                                               ref[1])}
    _free(device)
    if args.control:
        ctl = follow(Reference(lines, cfg["flags"], n, inputs, device, prec=Precision(True)),
                      batches)
        out["control"] = check.train_numbers(ctl[0], ref[0], ctl[1], ref[1], ctl[2], ref[2])
        out["losses"]["control"] = ctl[0]
        out["leaves"]["control"] = {"grad": ctl[1], "change": ctl[2]}
        _free(device)
    for fault in args.fault or ():
        fref = Reference(lines, cfg["flags"], n, inputs, device)
        fbatches = batches
        if fault == "half":
            fbatches = [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]
        else:
            _no_bias_correction(fref.opt)
        flt = follow(fref, fbatches)
        out[f"fault_{fault}"] = check.train_numbers(flt[0], ref[0], flt[1], ref[1], flt[2],
                                                    ref[2])
        out["losses"][f"fault_{fault}"] = flt[0]
        out["leaves"][f"fault_{fault}"] = {"grad": flt[1], "change": flt[2]}
        del fref
        _free(device)
    return out


def _no_bias_correction(opt) -> None:
    """The fault ``nobias``: Adam's step on ``opt`` (the reference's
    optimizer) with the moments taken as they are, not over 1 - beta**c."""
    import torch

    if opt.name != "adam":
        raise ValueError("the fault nobias is Adam's")

    @torch.no_grad()
    def step(params, grads, lr, scale):
        opt.count += 1
        for n, p in params.items():
            g = grads[n] * scale
            opt.mu[n].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
            opt.nu[n].mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
            p -= lr * opt.mu[n] / (opt.nu[n].sqrt() + opt.eps)

    opt.step = step


def infer_readings(cell, seed, device, args, work):
    import numpy as np

    from benchmark.core import check, manifest, runner, system, traffic, weights
    from benchmark.reference.numerics import Precision
    from benchmark.reference.steps import Reference

    cfg, mix = cell.config, cell.traffic
    n = int(cfg["n_classes"])
    files = system.write_files(work, n, cfg["flags"].get("wordseparator", "|"))
    w = weights.seeded(system.param_shapes(cfg), seed, device)
    inputs = {k: t.cpu() for k, t in w.items()}
    pool = traffic.pool(mix)
    rng = np.random.default_rng([seed, 2])
    ks = [len(pool) - 1] + list(rng.choice(len(pool) - 1, min(runner.SAMPLED - 1, len(pool) - 1),
                                           replace=False))
    batches = [traffic.make_batch(pool[k], seed, n, device) for k in ks]
    prog = system.InferSystem(cfg, files, seed, device, w, int(mix["batch"]))
    del w
    served = [prog.serve(b) for b in batches]
    del prog
    _free(device)
    lines = manifest.arch_lines(cfg)
    ref = Reference(lines, cfg["flags"], n, inputs, device)
    refs = [ref.emissions(b) for b in batches]
    out = {"seed": seed, "program": check.serve_numbers(served, refs, n - 1),
           "where": _where(served, refs)}
    if args.control:
        ctl = Reference(lines, cfg["flags"], n, inputs, device, prec=Precision(True))
        paths = []
        for b in batches:
            em, el = ctl.emissions(b)
            p = em.argmax(-1).cpu().numpy().astype(np.int32)
            el = el.cpu().numpy()
            toks = [check.collapse(p[i, : int(el[i])], n - 1) for i in range(p.shape[0])]
            paths.append((p, el, toks))
        out["control"] = check.serve_numbers(paths, refs, n - 1)
        out["control_where"] = _where(paths, refs)
    return out


def _worst(prog, ref, ref_grad):
    """The leaf behind a worst-leaf number, with its gap and its norms."""
    import statistics

    from benchmark.core import check

    leaves = check.counted(ref_grad)
    med = statistics.median(ref[n] for n in leaves)
    n = max(leaves, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return [n, abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), prog[n], ref[n], med]


def _where(served, refs):
    """The widest gap more than EDGE frames from its row's end, and the
    distance from its row's end of the widest gap overall."""
    import torch

    inner, worst, at = 0.0, -1.0, -1
    for (paths, _, _), (em, rlen) in zip(served, refs):
        for i in range(em.shape[0]):
            m = int(rlen[i])
            p = torch.as_tensor(paths[i, :m].astype("int64"), device=em.device)
            g = em[i, :m].max(-1).values - em[i, :m].gather(-1, p[:, None])[:, 0]
            if m > EDGE:
                inner = max(inner, float(g[: m - EDGE].max()))
            j = int(g.argmax())
            if float(g[j]) > worst:
                worst, at = float(g[j]), m - 1 - j
    return {"inner_gap": inner, "widest_from_end": at}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half", "nobias"), action="append")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.core import manifest, runner

    runner.environment(ROOT)
    cell = manifest.Cell(args.workload)
    if args.dtype:
        cell.config["flags"]["compute_dtype"] = args.dtype
    fn = train_readings if cell.traffic["mode"] == "train" else infer_readings
    for s in args.seeds.split(","):
        work = tempfile.mkdtemp(prefix="w2l-readings-")
        try:
            print(json.dumps(fn(cell, int(s), args.device, args, work)), flush=True)
        finally:
            import shutil

            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
