"""K5 and K5b alone: the CTC checks of ``chip_smoke.py`` at the flagship's
largest training batch (B = 16) and the transformer's (B = 8), both with the
targets of ``chip_smoke.py``'s training list (seed 1) and 9998 classes, and at
its ``CTC_EDGES``, without the rest of its phases.

    python wav2letter_tpu_torch/kernels/time_ctc.py [--root DIR] [bfloat16] [float32]
    python wav2letter_tpu_torch/kernels/time_ctc.py --ring-depths 8,16 [bfloat16]

Run on a machine with a card. ``--root`` (default: this checkout) is the
checkout whose ``chip_smoke.py`` and port are timed. Prints, per type and
batch, K5's and K5b's cold device time by the profiler (inputs in HBM) and by
launch (rows, alpha, beta, dx), their bound in bytes, the plain versions'
time and the library's (``log_softmax`` then ``F.ctc_loss``: its forward,
its backward alone, and the two), and fails if a check disagrees with the
plain versions or a second run differs in a bit. ``--ring-depths`` instead
builds copies of ``csrc/ctc.cu`` with ``RING_DEPTH`` (the frames of lp the
scans bring ahead of their chains) set to each value, and times K5 and K5b
of each, L2-warm, by events and by launch, at the flagship's B = 16, T = 192, N = 9998 for targets of 8 to 128
labels (one copy after the other for each shape), with each copy's loss and
dx against the plain versions. Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch


def main() -> None:
    if not torch.cuda.is_available():
        print("time_ctc: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--ring-depths", default="",
                    help="comma-separated RING_DEPTHs of csrc/ctc.cu to time")
    ap.add_argument("dtypes", nargs="*", default=["bfloat16", "float32"])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.models import build_arch_module

    kernels.disable_tf32()
    print(f"time_ctc: {cs.__file__}", flush=True)
    if args.ring_depths:
        for dt in args.dtypes:
            sweep(cs, [int(v) for v in args.ring_depths.split(",")], dt)
        print(_smi())
        return
    with tempfile.TemporaryDirectory(prefix="time_ctc_") as tmp:
        # chip_smoke.py's lists (seed 0 and 1): the same targets it checks
        _, tokens, lexicon, _ = cs.synth_dataset(os.path.join(tmp, "data"), 0)
        train_lst, _, _, _ = cs.synth_dataset(os.path.join(tmp, "data"), 1, cs.TRAIN_UTTS,
                                              "train", (tokens, lexicon))
        fl_batch = cs.FLAGSHIP["train"]["batchsize"]
        tr_batch = cs.TRANSFORMER["train"]["batchsize"]
        _, T_fl, _ = cs.batch_shapes(train_lst, tokens, lexicon, fl_batch)
        _, T_tr, _ = cs.batch_shapes(train_lst, tokens, lexicon, tr_batch)
        with torch.device("meta"):
            model = build_arch_module(cs.ARCH, cs.N_FEAT, cs.N_TOKENS + 1, ops=kernels.PLAIN)
            em_T = model.eval()(torch.zeros(1, T_fl, cs.N_FEAT))[0].shape[1]
        cases = {"flagship": cs.ctc_path_case(train_lst, tokens, lexicon, fl_batch, em_T, 11),
                 "transformer": cs.ctc_path_case(train_lst, tokens, lexicon, tr_batch,
                                                 cs.pooled_frames(T_tr), 12)}
    for dt in args.dtypes:
        details = []
        rows = cs.check_ctc(cases, dt, details)
        cs.check_ctc_edges(dt, details)
        for f, b in zip(rows["ctc"], rows["ctc_bwd"]):
            out = dict(dtype=dt, batch=f["tag"], shape=f["shape"], route=f["route"],
                       k5_ms=f["ms"], k5_warm_ms=f["warm_ms"], k5_bound_ms=f["bound_ms"],
                       k5b_ms=b["ms"], k5b_warm_ms=b["warm_ms"], k5b_bound_ms=b["bound_ms"],
                       split_ms=dict(f["split_ms"], **b["split_ms"]),
                       kernels_ms=f["ms"] + b["ms"], bound_ms=f["bound_ms"] + b["bound_ms"],
                       plain_fwd_ms=f["plain_ms"], plain_bwd_ms=b["plain_ms"],
                       library_fwd_ms=f["library_ms"], library_bwd_ms=b["library_ms"],
                       library_ms=b["library_fwd_bwd_ms"], bound_by=[f["bound_by"],
                                                                     b["bound_by"]],
                       max_abs_err=[f["max_abs_err"], b["max_abs_err"]],
                       equal_bits=[f["equal_bits"], b["equal_bits"]])
            print(f"SUM {json.dumps(out)}", flush=True)
        bad = [r for r in details if not r["ok"]]
        if bad:
            cs.fail(f"{len(bad)} checks disagree with the plain versions: {bad[0]}")
    print(_smi())


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def sweep(cs, values, dtype_name):
    """K5 and K5b of copies of ``csrc/ctc.cu`` with ``RING_DEPTH`` set to
    each of ``values``: warm ms by events and by launch at the flagship's
    shape for U = 8..128; each copy's loss and dx against the plain
    versions."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_ctc import with_ring_depth
    from wav2letter_tpu_torch.kernels.trace_k4 import build_traced

    src = (_build.CSRC / "ctc.cu").read_text()
    with ThreadPoolExecutor(len(values)) as ex:
        built = list(ex.map(lambda v: build_traced(
            with_ring_depth(src, v), f"ctc_ring_depth{v}", "w2l_ctc_fwd"), values))
    for lib in built:
        lib.w2l_ctc_bwd.argtypes = _build.SIGNATURES["w2l_ctc_bwd"]
        lib.w2l_ctc_bwd.restype = ctypes.c_int
    libs = dict(zip(values, built))
    dtype = getattr(torch, dtype_name)
    code = _build.DTYPE_CODES[dtype]
    for U in (8, 16, 32, 64, 96, 128):
        rng = np.random.RandomState(U)
        B, T, N = 16, 192, 9998
        tl = rng.randint(U * 3 // 4, U + 1, size=B)
        targets = np.full((B, U), -1, np.int64)
        for i in range(B):
            targets[i, :tl[i]] = rng.randint(0, N - 1, size=tl[i])
        case = dict(targets=targets, target_len=tl, logit_len=np.full(B, T), T=T, N=N, seed=U)
        x, tg, ll, tln = cs.ctc_args(case, dtype)
        want = kernels.ctc_fwd_plain(x, tg, ll, tln)
        L = 2 * U + 1
        f32 = dict(dtype=torch.float32, device="cuda")
        g = torch.ones((B,), **f32)
        want_dx = kernels.ctc_bwd_plain(g, x, tg, ll, tln, *want[1:]).float()
        lse, lp, alpha = (torch.empty((B, T), **f32), torch.empty((T, B, L), **f32),
                          torch.empty((T, B, L), **f32))
        loss, logz = torch.empty((B,), **f32), torch.empty((B,), **f32)
        slots = torch.empty((B, 2 * U + 1), dtype=torch.int32, device="cuda")
        beta = torch.empty((T, B, L), **f32)
        dx = torch.empty_like(x)
        stream = _build.stream_ptr(x)
        row = dict(dtype=dtype_name, U=U, L=L)
        for v, lib in libs.items():
            def fwd():
                _build.check(lib.w2l_ctc_fwd(
                    x.data_ptr(), tg.data_ptr(), ll.data_ptr(), tln.data_ptr(), lse.data_ptr(),
                    lp.data_ptr(), alpha.data_ptr(), loss.data_ptr(), logz.data_ptr(), 0, code,
                    B, T, N, U, _build.MAX_SMEM_BYTES, stream), "ctc")

            def bwd():
                _build.check(lib.w2l_ctc_bwd(
                    x.data_ptr(), lse.data_ptr(), lp.data_ptr(), alpha.data_ptr(),
                    logz.data_ptr(), g.data_ptr(), tg.data_ptr(), ll.data_ptr(),
                    tln.data_ptr(), slots.data_ptr(), beta.data_ptr(), 0, dx.data_ptr(), code,
                    B, T, N, U, _build.MAX_SMEM_BYTES, stream), "ctc_bwd")

            ms_f, ms_b = cs.cuda_ms(fwd), cs.cuda_ms(bwd)
            split = {}
            for fn in (fwd, bwd):
                for key, ms in cs.device_split(fn, (), cold=False).items():
                    split[cs._ctc_launch(key)] = split.get(cs._ctc_launch(key), 0.0) + ms
            row[f"RING_DEPTH={v}"] = dict(
                k5_ms=ms_f, k5b_ms=ms_b, split_ms=split,
                loss_max_abs_err=(loss - want[0]).abs().max().item(),
                dx_max_abs_err=(dx.float() - want_dx).abs().max().item(),
                finite=bool(torch.isfinite(dx).all()))
        print(f"SWEEP {json.dumps(row)}", flush=True)


if __name__ == "__main__":
    main()
