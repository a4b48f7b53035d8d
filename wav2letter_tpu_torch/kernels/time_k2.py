"""K2, K2 as dgrad and K2b alone at the flagship's shapes: the kernel checks
of ``chip_smoke.py`` (against the plain versions, timed cold against the
library's call and the bound) without the rest of its phases.

    python -m wav2letter_tpu_torch.kernels.time_k2 [bfloat16] [float32]

Run from the root of a checkout on a machine with a card. Prints one line a
shape (route, kernel and library ms, bound) and each kernel's sum over the
path: serving B=4 and training B=16, both at T=1536 feature frames.
Nothing of the port imports this module.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch


def main() -> None:
    if not torch.cuda.is_available():
        print("time_k2: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.models import build_arch_module

    kernels.disable_tf32()
    with torch.device("meta"):
        model = build_arch_module(cs.ARCH, cs.N_FEAT, cs.N_TOKENS + 1)
    convs, _ = cs.path_calls(model, cs.BATCH, 1536)
    tconvs, _ = cs.path_calls(model, cs.FLAGSHIP["train"]["batchsize"], 1536)
    for dt in sys.argv[1:] or ["bfloat16"]:
        details = []
        sums = {"time_conv": cs.check_time_conv(convs, dt, details)}
        back = cs.check_time_conv_backward(tconvs, dt, details)
        sums.update(time_conv_dgrad=back["time_conv_dgrad"],
                    time_conv_wgrad=back["time_conv_wgrad"])
        bad = [r for r in details if not r["ok"]]
        for name, rows in sums.items():
            agg = cs.per_forward(rows)
            print(f"SUM {name} {dt}: {agg['ms']:.4f} ms, library {agg['library_ms']:.4f}, "
                  f"bound {agg['bound_ms']:.4f}", flush=True)
        if bad:
            cs.fail(f"{len(bad)} checks disagree with the plain versions: {bad[0]}")
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
