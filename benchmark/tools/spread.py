"""The spread of a cell's runs, as the bounds are set from it.

    python3 benchmark/tools/spread.py RESULTS [RESULTS ...]

Each file holds one run's result line per line (other lines are skipped).
For each metric it prints the runs' values, the median and the spread: the
distance between the first and third quartiles (``statistics.quantiles(v,
n=4)``) over the median."""

import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths) -> int:
    for path in paths:
        runs = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("{") and '"metrics"' in line:
                    runs.append(json.loads(line))
        print(f"{path}: {len(runs)} runs, correct {[r['correct'] for r in runs]}")
        for name in runs[0]["metrics"] if runs else []:
            v = [r["metrics"][name]["value"] for r in runs]
            s = spread(v) if len(v) >= 2 else float("nan")
            print(f"  {name}: median {statistics.median(v)!r} spread {s!r} values {v!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
