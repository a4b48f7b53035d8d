"""K4 and K4b alone: the attention checks of ``chip_smoke.py`` at the
transformer's serving and training rows (B=4 and 8, T=192, H=4, Dh=192, 12
calls a pass) and K4b's edge shapes, without the rest of its phases.

    python wav2letter_tpu_torch/kernels/time_k4b.py [--root DIR] [bfloat16] [float32]

Run on a machine with a card. ``--root`` (default: this checkout) is the
checkout whose ``chip_smoke.py`` and port are timed, so that two commits can
be compared in one run; a checkout without K4b's edge checks skips them.
Prints, per type, K4's and K4b's rows (K4b's cold device time by launch,
beside the autograd of ``scaled_dot_product_attention``) and each kernel's
sum over its pass. Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main() -> None:
    if not torch.cuda.is_available():
        print("time_k4b: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("dtypes", nargs="*", default=["bfloat16"])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs

    from wav2letter_tpu_torch import kernels

    kernels.disable_tf32()
    print(f"time_k4b: {cs.__file__}", flush=True)
    batch = cs.TRANSFORMER["train"]["batchsize"]
    for dt in args.dtypes:
        details = []
        att = cs.check_attention([("serve", cs.BATCH, 192, 4, 192, True, 12),
                                  ("train", batch, 192, 4, 192, True, 12)], dt, details)
        att = {"mhsa": [r for r in att["mhsa"] if r["tag"] == "serve"],
               "mhsa_bwd": [r for r in att["mhsa_bwd"] if r["tag"] == "train"]}
        if hasattr(cs, "check_attention_bwd"):
            cs.check_attention_bwd(cs.k4b_edges(dt), dt, details)
        for name, rows in att.items():
            agg = cs.per_forward(rows)
            split = {k: round(sum(r["split_ms"][k] * r["calls"] for r in rows), 4)
                     for k in rows[0].get("split_ms", {})}
            print(f"SUM {name} {dt}: {agg['ms']:.4f} ms cold, {agg['warm_ms']:.4f} warm, "
                  f"library {agg['library_ms']:.4f}, plain {agg['plain_ms']:.4f}, bound "
                  f"{agg['bound_ms']:.4f} ({agg['bound_by']}); by launch {json.dumps(split)}",
                  flush=True)
        bad = [r for r in details if not r["ok"]]
        if bad:
            cs.fail(f"{len(bad)} checks disagree with the plain versions: {bad[0]}")
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip())


if __name__ == "__main__":
    main()
