"""K1 and K3 alone: the checks of ``chip_smoke.py`` for K1 (MFSC) at the
flagship's serving and training rows (B=4 and 16, 246000 samples, 1536
frames) and for K3 (residual LayerNorm) at the flagship's 22 rows of one
serving forward and the transformer's 24, without the rest of its phases.

    python wav2letter_tpu_torch/kernels/time_k1k3.py [--root DIR] [bfloat16] [float32]

Run on a machine with a card. ``--root`` (default: this checkout) is the
checkout whose ``chip_smoke.py`` and port are timed, so that two commits can
be compared in one run. Prints each kernel's sum over its pass, cold and
warm, beside its plain version, its library call(s) and its bound, and for a
checkout whose rows carry them, the routes and K1's dense TFLOP/s. Nothing
of the port imports this module.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SERVE_S, FRAMES = 246000, 1536


def _sum(cs, name, rows, extra=()):
    agg = cs.per_forward(rows)
    more = {k: round(sum((r.get(k) or 0.0) * r["calls"] for r in rows), 4) for k in extra
            if any(k in r for r in rows)}
    info = {k: sorted({str(r[k]) for r in rows}) for k in ("route", "tile", "warps_per_row")
            if any(k in r for r in rows)}
    print(f"SUM {name}: {agg['ms']:.4f} ms cold, {agg['warm_ms']:.4f} warm, plain "
          f"{agg['plain_ms']:.4f}, library {agg['library_ms']}, bound {agg['bound_ms']:.4f} "
          f"({agg['bound_by']}); {json.dumps(more)} {json.dumps(info)}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("time_k1k3: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("dtypes", nargs="*", default=["bfloat16", "float32"])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.models import build_arch_module

    kernels.disable_tf32()
    print(f"time_k1k3: {cs.__file__}", flush=True)
    with torch.device("meta"):
        model = build_arch_module(cs.ARCH, cs.N_FEAT, cs.N_TOKENS + 1)
    _, lns = cs.path_calls(model, cs.BATCH, FRAMES)
    tr_lns = [(cs.BATCH * cs.pooled_frames(FRAMES), 768)] * 24
    details = []
    for B in (cs.BATCH, cs.FLAGSHIP["train"]["batchsize"]):
        _sum(cs, f"mfsc B={B}", cs.check_mfsc(B, SERVE_S, details), ("dense_tflops",))
    for dt in args.dtypes:
        for name, shapes in (("flagship", lns), ("transformer", tr_lns)):
            _sum(cs, f"residual_ln {dt} {name}", cs.check_residual_ln(shapes, dt, details),
                 ("layer_norm_ms",))
    bad = [r for r in details if not r["ok"]]
    if bad:
        cs.fail(f"{len(bad)} checks disagree with the plain versions: {bad[0]}")
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip())


if __name__ == "__main__":
    main()
