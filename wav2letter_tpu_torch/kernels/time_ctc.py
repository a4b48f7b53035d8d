"""K5 and K5b alone: the CTC checks of ``chip_smoke.py`` at the flagship's
largest training batch (B = 16) and the transformer's (B = 8), both with the
targets of ``chip_smoke.py``'s training list (seed 1) and 9998 classes, and at
its ``CTC_EDGES``, without the rest of its phases.

    python wav2letter_tpu_torch/kernels/time_ctc.py [--root DIR] [bfloat16] [float32]
    python wav2letter_tpu_torch/kernels/time_ctc.py --warp-states 0,2,4,8 [bfloat16]

Run on a machine with a card. ``--root`` (default: this checkout) is the
checkout whose ``chip_smoke.py`` and port are timed. Prints, per type and
batch, K5's and K5b's cold device time by the profiler (inputs in HBM), their
bound in bytes, the plain versions' time and the library's (``log_softmax``
then ``F.ctc_loss``: its forward, its backward alone, and the two), and fails
if a check disagrees with the plain versions or a second run differs in a bit.
``--warp-states`` instead builds copies of ``csrc/ctc.cu`` whose warp route
takes at most each given number of states a lane (``WARP_MAX_STATES``; 0:
the block route always) and times K5 and K5b of each, L2-warm by events, at
the flagship's B = 16, T = 192, N = 9998 for targets of 16 to 128 labels.
Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
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
    ap.add_argument("--warp-states", default="",
                    help="comma-separated caps of the warp route's states a lane")
    ap.add_argument("dtypes", nargs="*", default=["bfloat16", "float32"])
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.models import build_arch_module

    kernels.disable_tf32()
    print(f"time_ctc: {cs.__file__}", flush=True)
    if args.warp_states:
        for dt in args.dtypes:
            sweep_warp_states(cs, [int(w) for w in args.warp_states.split(",")], dt)
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


_WARP_MAX = re.compile(r"constexpr int WARP_MAX_STATES = (\d+);")


def sweep_warp_states(cs, caps, dtype_name):
    """K5 and K5b of copies of ``csrc/ctc.cu`` with the warp route capped at
    each of ``caps`` states a lane, warm ms by events, at the flagship's
    shape for U = 16..128; each copy's loss against the plain version."""
    import numpy as np

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k4 import build_traced

    src = (_build.CSRC / "ctc.cu").read_text()
    if len(_WARP_MAX.findall(src)) != 1:
        raise RuntimeError("time_ctc: WARP_MAX_STATES not found once in csrc/ctc.cu")
    libs = {}
    for cap in caps:
        lib = build_traced(_WARP_MAX.sub(f"constexpr int WARP_MAX_STATES = {cap};", src),
                           f"ctc_warp{cap}", "w2l_ctc_fwd")
        lib.w2l_ctc_bwd.argtypes = _build.SIGNATURES["w2l_ctc_bwd"]
        lib.w2l_ctc_bwd.restype = ctypes.c_int
        libs[cap] = lib
    dtype = getattr(torch, dtype_name)
    code = _build.DTYPE_CODES[dtype]
    for U in (16, 32, 64, 96, 128):
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
        lse, lp, alpha = (torch.empty((B, T), **f32), torch.empty((T, B, L), **f32),
                          torch.empty((T, B, L), **f32))
        loss, logz, g = (torch.empty((B,), **f32), torch.empty((B,), **f32),
                         torch.ones((B,), **f32))
        tok = torch.empty((B, U + 1), dtype=torch.int32, device="cuda")
        val = torch.empty((T, B, U + 1), **f32)
        dx = torch.empty_like(x)
        stream = _build.stream_ptr(x)
        row = dict(dtype=dtype_name, U=U, L=L)
        for cap, lib in libs.items():
            def fwd():
                _build.check(lib.w2l_ctc_fwd(
                    x.data_ptr(), tg.data_ptr(), ll.data_ptr(), tln.data_ptr(), lse.data_ptr(),
                    lp.data_ptr(), alpha.data_ptr(), loss.data_ptr(), logz.data_ptr(), 0, code,
                    B, T, N, U, _build.MAX_SMEM_BYTES, stream), "ctc")

            def bwd():
                _build.check(lib.w2l_ctc_bwd(
                    x.data_ptr(), lse.data_ptr(), lp.data_ptr(), alpha.data_ptr(),
                    logz.data_ptr(), g.data_ptr(), tg.data_ptr(), ll.data_ptr(),
                    tln.data_ptr(), tok.data_ptr(), val.data_ptr(), 0, dx.data_ptr(), code,
                    B, T, N, U, _build.MAX_SMEM_BYTES, stream), "ctc_bwd")

            ms_f, ms_b = cs.cuda_ms(fwd), cs.cuda_ms(bwd)
            err = (loss - want[0]).abs().max().item()
            row[f"cap{cap}"] = dict(k5_ms=ms_f, k5b_ms=ms_b, loss_max_abs_err=err,
                                    finite=bool(torch.isfinite(dx).all()))
        print(f"SWEEP {json.dumps(row)}", flush=True)


if __name__ == "__main__":
    main()
