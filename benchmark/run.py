"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``wav2letter_tpu_torch``)
beside ``BENCHMARK.json`` and this folder. ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` its per-layer metrics, the traced window's
device busy and wall seconds and a breakdown. Both compare the program's
outputs with the reference; each number compared and its limit are the last
lines of standard error and the last key of the result. Exits non-zero with
no result where the machine lacks the cell's cards, where the program is
missing, where JAX or the JAX package was loaded, or where a metric that
``BENCHMARK.json`` lists for the cell found nothing to read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.core import manifest, runner

    runner.environment(ROOT)
    cell = manifest.Cell(args.workload)
    import torch

    torch.set_num_threads(runner.THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    if cell.chips != 1:
        print("benchmark: cells on several cards are not run by this harness yet",
              file=sys.stderr)
        return 3
    try:
        import wav2letter_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}", file=sys.stderr)
        return 4
    metrics = cell.per_layer() if args.trace else cell.end_to_end()
    try:
        result = runner.run(cell.config, cell.traffic, cell.limits,
                            [m["name"] for m in metrics], args.seed, args.seconds,
                            bool(args.trace), "cuda:0", T_START)
    except LookupError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 6
    bad = runner.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    units = {m["name"]: m["unit"] for m in metrics}
    result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in result["metrics"].items()}
    for name, v in result["not_compared"].items():
        print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
