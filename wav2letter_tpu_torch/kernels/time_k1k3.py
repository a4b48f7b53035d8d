"""K1, K3 and K3b alone: the checks of ``chip_smoke.py`` for K1 (MFSC) at
the flagship's serving and training rows (B=4 and 16, 246000 samples, 1536
frames), for K3 (residual LayerNorm) at the flagship's 22 rows of one
serving forward and the transformer's 24, and for K3b (its backward) at the
flagship's 22 rows of one B=16 update and the transformer's 24 at B=8,
and at the other paths' rows (mls 8 x 3072 x 256, transformer_s2s 24 x 768
x 768, CPC 12 x 12312 x 768 in fp32), without the rest of its phases.

    python wav2letter_tpu_torch/kernels/time_k1k3.py [--root DIR] [--k3b-rows]
        [bfloat16] [float32]

Run on a machine with a card. ``--root`` (default: this checkout) is the
checkout whose ``chip_smoke.py`` and port are timed, so that two commits can
be compared in one run. Prints each kernel's sum over its pass, cold and
warm, beside its plain version, its library call(s) and its bound, and for a
checkout whose rows carry them, the routes, warps a row, rows a block and
K1's dense TFLOP/s. ``--k3b-rows`` (a checkout with K3b's register route)
also times K3b's one-warp rows at 1, 2, 4 and 8 rows a block, cold and warm,
at the shapes of mls (3072 x 256), the transformer (1536 x 768) and
transformer_s2s (768 x 768), each from a copy of ``csrc/layernorm.cu`` built
with that many: the timing behind its ``LN_BWD_ROWS``.
Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SERVE_S, FRAMES = 246000, 1536
K3B_ONE_WARP = [(3072, 256), (1536, 768), (768, 768)]  # mls, transformer, transformer_s2s


def _sum(cs, name, rows, extra=()):
    agg = cs.per_forward(rows)
    more = {k: round(sum((r.get(k) or 0.0) * r["calls"] for r in rows), 4) for k in extra
            if any(k in r for r in rows)}
    info = {k: sorted({str(r[k]) for r in rows})
            for k in ("route", "tile", "warps_per_row", "rows_per_block")
            if any(k in r for r in rows)}
    warm = agg.get("warm_ms")
    print(f"SUM {name}: {agg['ms']:.4f} ms cold, "
          f"{'-' if warm is None else f'{warm:.4f}'} warm, plain "
          f"{agg['plain_ms']:.4f}, library {agg['library_ms']}, bound {agg['bound_ms']:.4f} "
          f"({agg['bound_by']}); {json.dumps(more)} {json.dumps(info)}", flush=True)
    for r in rows:
        print(f"ROW {name} {r['shape']} x{r['calls']}: {r['ms']:.5f} ms cold, "
              f"{r.get('warm_ms')} warm, bound {r['bound_ms']:.5f}, share "
              f"{r['bound_ms'] / r['ms']:.3f}; {json.dumps({k: r[k] for k in info})}",
              flush=True)


def _k3b_rows(cs, dt):
    """K3b's one-warp rows at 1, 2, 4, 8 rows a block, each from a copy of
    ``csrc/layernorm.cu`` built with that ``LN_BWD_ROWS``: ms a launch, cold
    and warm, and the share of the bound, checked against the plain
    version."""
    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels import _build, layernorm
    from wav2letter_tpu_torch.kernels.trace_k3b import bwd_rows, with_bwd_rows
    from wav2letter_tpu_torch.kernels.trace_k4 import build_traced

    src = (_build.CSRC / "layernorm.cu").read_text()
    libs = {n: build_traced(with_bwd_rows(src, n), f"k3b_rows{n}", "w2l_residual_ln_bwd")
            for n in (1, 2, 4, 8)}
    dtype = getattr(torch, dt)
    for R, D in K3B_ONE_WARP:
        if layernorm.warps_per_row(D, dtype.itemsize) != 1:
            continue
        g = torch.Generator(device="cuda").manual_seed(R + D + 1)
        x, y, dout = (torch.randn((R, D), device="cuda", generator=g).to(dtype)
                      for _ in range(3))
        w = torch.tensor([1.3], device="cuda")
        _, mu, rsig = kernels.residual_ln(x, y, w, torch.tensor([-0.2], device="cuda"))
        want = kernels.residual_ln_bwd_plain(dout, x, y, mu, rsig, w)
        b_ms, _ = cs.bound(4 * R * D * dtype.itemsize + 16 * R + 4, 12 * R * D, "float32")
        for rows, lib in libs.items():
            def fn(a, b, c, m, r, wt, lib=lib):
                dz = torch.empty_like(a)
                rg, rgz = (torch.empty((R,), device="cuda") for _ in range(2))
                _build.check(lib.w2l_residual_ln_bwd(
                    a.data_ptr(), b.data_ptr(), c.data_ptr(), m.data_ptr(), r.data_ptr(),
                    wt.data_ptr(), dz.data_ptr(), rg.data_ptr(), rgz.data_ptr(),
                    _build.DTYPE_CODES[dtype], R, D, 1, _build.stream_ptr(a)), "k3b_rows")
                return dz

            args = (dout, x, y, mu, rsig, w)
            err, _, ok = cs.compare("residual_ln_bwd", dt, fn(*args), want[0])
            cold, warm = cs.device_ms(fn, args), cs.device_ms(fn, args, cold=False)
            print(f"K3B_ROWS {dt} {[R, D]} rows {rows}: {cold:.5f} ms cold, {warm:.5f} warm, "
                  f"bound {b_ms:.5f}, share {b_ms / cold:.3f}; ok {ok}, max err {err:.2e}"
                  + ("" if rows != bwd_rows(src) else " (LN_BWD_ROWS)"), flush=True)
            if not ok:
                cs.fail(f"K3b at {rows} rows a block disagrees with its plain version")


def main() -> None:
    if not torch.cuda.is_available():
        print("time_k1k3: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--k3b-rows", action="store_true",
                    help="also time K3b's one-warp rows at 1, 2, 4, 8 rows a block")
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
    _, tlns = cs.path_calls(model, cs.FLAGSHIP["train"]["batchsize"], FRAMES)
    tr_tlns = [(cs.TRANSFORMER["train"]["batchsize"] * cs.pooled_frames(FRAMES), 768)] * 24
    details = []
    for B in (cs.BATCH, cs.FLAGSHIP["train"]["batchsize"]):
        _sum(cs, f"mfsc B={B}", cs.check_mfsc(B, SERVE_S, details), ("dense_tflops",))
    for dt in args.dtypes:
        for name, shapes in (("flagship", lns), ("transformer", tr_lns)):
            _sum(cs, f"residual_ln {dt} {name}", cs.check_residual_ln(shapes, dt, details),
                 ("layer_norm_ms",))
        for name, shapes in (("flagship", tlns), ("transformer", tr_tlns),
                             ("mls", [(3072, 256)] * 8), ("transformer_s2s", [(768, 768)] * 24),
                             ("cpc", [(12312, 768)] * 12 if dt == "float32" else [])):
            if shapes:
                _sum(cs, f"residual_ln_bwd {dt} {name}",
                     cs.check_residual_ln_bwd(shapes, dt, details))
        if args.k3b_rows:
            _k3b_rows(cs, dt)
    bad = [r for r in details if not r["ok"]]
    if bad:
        cs.fail(f"{len(bad)} checks disagree with the plain versions: {bad[0]}")
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip())


if __name__ == "__main__":
    main()
