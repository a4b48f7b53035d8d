"""K2, K2 as dgrad and K2b alone at the flagship's shapes: the kernel checks
of ``chip_smoke.py`` (against the plain versions, timed cold against the
library's call and the bound) without the rest of its phases.

    python wav2letter_tpu_torch/kernels/time_k2.py [--root DIR] [--stream] [--cpc]
        [bfloat16] [float32]

Run on a machine with a card. ``--root`` (default: this checkout) is the
checkout whose ``chip_smoke.py`` and port are timed, so that two commits can
be compared in one run. Prints one line a shape (route, schedule, kernel and
library ms, bound) and each kernel's sum over the path: serving B=4 (K2) and
training B=16 (K2 forward, dgrad, K2b), both at T=1536 feature frames; then,
in fp32, K2 at the stream's three shapes of a steady chunk (B = 1 windows,
timed by CUDA-graph replay), with its dgrad and K2b where the checkout's
``chip_smoke.py`` times them, and the chunk's 15 K2 launches replayed from
one graph. ``--stream`` times only the stream's part. ``--cpc`` times only
CPC's first conv (C 1 -> 512, K 10, stride 5 on raw audio; B = 8 rows of
125,000 samples, 200,000 output frames, about phase 20's largest batch of 8
x 123,120), K2 and K2b, on the route the checkout gives it. Nothing of the
port imports this module.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

FRAMES = 1536
# (B, T, F, C, CO, K, stride, pads): the 15 K2 calls of a steady stream chunk
# of the flagship (500 ms, chip_smoke.py phase 11), in order; the first, the
# second and the last are the stream table's three shapes (PERF.md)
CHUNK = ([(1, 58, 80, 1, 16, 9, 2, (0, 0))] + [(1, 33, 80, 16, 16, 9, 1, (0, 0))] * 2
         + [(1, 34, 80, 16, 20, 11, 2, (0, 0))] + [(1, 20, 80, 20, 20, 9, 1, (0, 0))] * 3
         + [(1, 21, 80, 20, 24, 11, 2, (0, 0))] + [(1, 16, 80, 24, 24, 11, 1, (0, 0))] * 3
         + [(1, 17, 80, 24, 28, 12, 1, (0, 0))] + [(1, 16, 80, 28, 28, 11, 1, (0, 0))] * 3)
STREAM = [CHUNK[0], CHUNK[1], CHUNK[-1]]
CPC_CONV = (8, 125000, 1, 1, 512, 10, 5, (3, 3))


def _cpc(cs, dt: str) -> list:
    """K2 and K2b at ``CPC_CONV`` through the checkout's checks (timed cold
    against the plain versions and ``F.conv2d`` / ``conv2d_weight``), and
    K2's warm time. Returns the rows that disagree with the plain versions."""
    from wav2letter_tpu_torch import kernels

    details = []
    rows = cs.check_time_conv([CPC_CONV], dt, details)
    rows += cs.check_time_conv_backward([CPC_CONV], dt, details)["time_conv_wgrad"]
    B, T, Fq, C, CO, K, s, pads = CPC_CONV
    g = torch.Generator(device="cuda").manual_seed(T + K)
    x = torch.randn((B, T, Fq * C), device="cuda", generator=g).to(getattr(torch, dt))
    w = (0.1 * torch.randn((K, C, CO), device="cuda", generator=g)).to(x.dtype)
    bias = torch.randn((CO,), device="cuda", generator=g)
    rows[0]["warm_ms"] = cs.device_ms(kernels.time_conv, (x, w, Fq, s, pads, bias, True),
                                      cold=False)
    for r in rows:
        print(f"CPC {r['name']} {dt} {r['shape']}: {r.get('route')} "
              f"{json.dumps(r.get('schedule'))}, {r['ms']:.4f} ms cold, warm {r['warm_ms']}, "
              f"plain {r['plain_ms']}, library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of it, err "
              f"{r['max_abs_err']:.2e}", flush=True)
    return [r for r in details if not r["ok"]]


def _stream_k2(cs, key):
    """K2 alone at a stream shape, for a checkout without ``stream_conv_rows``."""
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    B, T, Fq, C, CO, K, s, pads = key
    g = torch.Generator(device="cuda").manual_seed(T + K)
    x = torch.randn((B, T, Fq * C), device="cuda", generator=g)
    w = 0.1 * torch.randn((K, C, CO), device="cuda", generator=g)
    bias = torch.randn((CO,), device="cuda", generator=g)
    args = (x, w, Fq, s, pads, bias, True)
    err, _, ok = cs.compare("time_conv", "float32", kernels.time_conv(*args),
                            kernels.time_conv_plain(*args))
    xn = x.view(B, T, Fq, C).permute(0, 3, 2, 1).contiguous()
    wn = w.permute(2, 1, 0).unsqueeze(2).contiguous()
    return [dict(name="time_conv", shape=list(key), ok=ok, max_abs_err=err,
                 ms=cs.graph_ms(kernels.time_conv, args),
                 library_ms=cs.graph_ms(lambda a, b_, c: F.conv2d(a, b_, c, stride=(1, s)),
                                        (xn, wn, bias)))]


def _chunk_ms(cs) -> float:
    """A steady chunk's 15 K2 launches replayed from one CUDA graph."""
    from wav2letter_tpu_torch import kernels

    args = []
    for B, T, Fq, C, CO, K, s, pads in CHUNK:
        g = torch.Generator(device="cuda").manual_seed(T + K)
        args.append((torch.randn((B, T, Fq * C), device="cuda", generator=g),
                     0.1 * torch.randn((K, C, CO), device="cuda", generator=g), Fq, s, pads,
                     torch.randn((CO,), device="cuda", generator=g), True))

    def chunk():
        for a in args:
            kernels.time_conv(*a)

    return cs.graph_ms(chunk, ())


def main() -> None:
    if not torch.cuda.is_available():
        print("time_k2: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--stream", action="store_true",
                    help="only the stream's shapes and a steady chunk's K2 time (fp32)")
    ap.add_argument("--cpc", action="store_true", help="only CPC's first conv, K2 and K2b")
    ap.add_argument("dtypes", nargs="*", default=["bfloat16"])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.models import build_arch_module

    kernels.disable_tf32()
    print(f"time_k2: {cs.__file__}", flush=True)
    if args.cpc:
        bad = [r for dt in args.dtypes for r in _cpc(cs, dt)]
        print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True).stdout.strip())
        if bad:
            cs.fail(f"{len(bad)} checks disagree with the plain versions: {bad[0]}")
        return
    with torch.device("meta"):
        model = build_arch_module(cs.ARCH, cs.N_FEAT, cs.N_TOKENS + 1)
    convs, _ = cs.path_calls(model, cs.BATCH, FRAMES)
    tconvs, _ = cs.path_calls(model, cs.FLAGSHIP["train"]["batchsize"], FRAMES)
    bad = []
    for dt in ["float32"] if args.stream else args.dtypes:
        details = []
        sums = {}
        if not args.stream:
            sums = {"time_conv": cs.check_time_conv(convs, dt, details),
                    "time_conv B=16": cs.check_time_conv(tconvs, dt, details)}
            back = cs.check_time_conv_backward(tconvs, dt, details)
            sums.update(time_conv_dgrad=back["time_conv_dgrad"],
                        time_conv_wgrad=back["time_conv_wgrad"])
        bad += [r for r in details if not r["ok"]]
        for name, rows in sums.items():
            agg = cs.per_forward(rows)
            print(f"SUM {name} {dt}: {agg['ms']:.4f} ms cold, {agg['warm_ms']:.4f} warm, "
                  f"library {agg['library_ms']:.4f}, bound {agg['bound_ms']:.4f} "
                  f"({agg['bound_by']})", flush=True)
        if dt == "float32":
            for key in STREAM:
                rows = (cs.stream_conv_rows(key) if hasattr(cs, "stream_conv_rows")
                        else _stream_k2(cs, key))
                bad += [r for r in rows if not r["ok"]]
                for r in rows:
                    print(f"STREAM {r['name']} {r['shape']}: {r['ms']:.5f} ms, library "
                          f"{r['library_ms']:.5f}, err {r['max_abs_err']:.2e}", flush=True)
            print(f"CHUNK {len(CHUNK)} K2 launches: {_chunk_ms(cs):.5f} ms", flush=True)
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip())
    if bad:
        cs.fail(f"{len(bad)} checks disagree with the plain versions: {bad[0]}")


if __name__ == "__main__":
    main()
