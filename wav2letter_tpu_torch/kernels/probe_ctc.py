"""Two probes of what ``chip_smoke.py``'s K5/K5b checks can see, on a machine
with a card.

    python wav2letter_tpu_torch/kernels/probe_ctc.py mutants
    python wav2letter_tpu_torch/kernels/probe_ctc.py replay

``mutants`` builds copies of ``csrc/ctc.cu`` whose dx kernel rounds the
softmax to bf16 (``sm_bf16``) or reads lse + 1e-3 (``lse_1e-3``), beside an
unaltered copy (``control``), and runs on each ``chip_smoke.py``'s K5b check
(the flagship's shape, B = 16, T = 192, N = 9998, and three of its
``CTC_EDGES``, fp32 and bf16) and the CTC ``cuda`` tests. It prints each
check's largest dx error against its limit, and which checks and tests
failed: the altered copies should fail, the control pass.

``replay`` runs ``chip_smoke.py``'s replay of one flagship update from one
saved state (``replay_update``, its training list's largest batch) in fp32
and bf16, with the CTC criterion as it is (K5/K5b) and with
``log_softmax`` then ``F.ctc_loss`` in its place; then that library call's
backward alone, five times on one input, with labels drawn from 9997 and
from 28 tokens, and counts the elements that differ from the first run,
beside K5b's. Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
# the dx kernel's softmax (its one expression, ``grad``, that every class
# goes through) and its lse
SM = "(expf(v - ls) - p)"
LSE = "const float ls = lse[static_cast<size_t>(b) * T_ + t];"
ROUND_BF16 = "__bfloat162float(__float2bfloat16({}))"


def mutant_sources(src: str) -> dict:
    """{name: source}: the unaltered ``ctc.cu`` and its two altered copies."""
    if (src.count(SM), src.count(LSE)) != (1, 1):
        raise RuntimeError("probe_ctc: the dx kernel's softmax or lse not found in ctc.cu")
    sm = src.replace(SM, "(" + ROUND_BF16.format("expf(v - ls)") + " - p)")
    return {"control": src, "sm_bf16": sm, "lse_1e-3": src.replace(LSE, LSE[:-1] + " + 1e-3f;")}


def flagship_case(seed=0):
    """The ``cuda`` tests' flagship CTC inputs: B = 16, T = 192, N = 9998,
    55-72 random labels a row."""
    rng = np.random.RandomState(seed)
    B, T, N, U = 16, 192, 9998, 72
    ll = rng.randint(150, T + 1, size=B)
    ll[0] = T
    tl = rng.randint(55, U + 1, size=B)
    targets = np.full((B, U), -1, np.int64)
    for i in range(B):
        targets[i, :tl[i]] = rng.randint(0, N - 1, size=tl[i])
    return dict(targets=targets, target_len=tl, logit_len=ll, T=T, N=N, seed=seed + 1)


def probe_mutants(cs) -> dict:
    import pytest

    from wav2letter_tpu_torch.kernels import _build
    from wav2letter_tpu_torch.kernels.trace_k4 import build_traced

    sources = mutant_sources((_build.CSRC / "ctc.cu").read_text())
    _build.build()
    with ThreadPoolExecutor(len(sources)) as ex:
        built = ex.map(lambda kv: build_traced(
            kv[1], "ctc_" + kv[0].replace("-", "_").replace(".", "_"), "w2l_ctc_fwd"),
            sources.items())
        libs = dict(zip(sources, built))
    for lib in libs.values():
        for entry, argtypes in _build.SIGNATURES.items():
            if entry.startswith("w2l_ctc_"):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
    library, summary = _build.library, {}
    try:
        for name, lib in libs.items():
            _build.library = lambda lib=lib: lib
            failed = {"float32": [], "bfloat16": []}
            for dt in failed:
                dtype = getattr(torch, dt)
                cases = [("flagship", cs.ctc_args(flagship_case(), dtype))] + [
                    (k, cs.ctc_args(cs.ctc_edge_case(k), dtype))
                    for k in ("edges", "block", "unaligned")]
                for tag, args in cases:
                    _, bwd = cs._ctc_check(args, dt, False, tag, 0)
                    print(f"[{name}] {dt} {tag}: K5b ok {bwd['ok']}, max err "
                          f"{bwd['max_abs_err']:.3e}, limit (rtol, atol) {bwd['tol']}", flush=True)
                    if not bwd["ok"]:
                        failed[dt].append(tag)
            rc = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider", "-m", "cuda", "-rf",
                              str(ROOT / "tests" / "test_torch_cuda.py"), "-k",
                              "ctc_kernels_match_plain or ctc_function_matches_plain"])
            summary[name] = dict(check_failed=failed, tests_rc=int(rc))
            print(f"MUTANT {name} {json.dumps(summary[name])}", flush=True)
    finally:
        _build.library = library
    return summary


def library_ctc_loss(logits, targets, logit_len, target_len, blank=None, ops=None):
    """The loss as the port computed it before K5/K5b: ``log_softmax`` then
    ``F.ctc_loss``, 1e30 on a row without an alignment."""
    N = logits.shape[2]
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    logit_len, target_len = logit_len.long(), target_len.long()
    losses = F.ctc_loss(log_probs, targets.long().clamp(min=0), logit_len, target_len,
                        blank=N - 1, reduction="none", zero_infinity=True)
    U = targets.shape[1]
    inside = torch.arange(1, U, device=targets.device)[None, :] < target_len[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & inside).sum(dim=1)
    return torch.where(target_len + repeats <= logit_len, losses, losses.new_tensor(1e30))


def probe_replay(cs) -> dict:
    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.criterions import ctc as crit_ctc
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.runtime.train import Trainer

    kernels.library()
    own, out = crit_ctc.ctc_loss, {}
    with tempfile.TemporaryDirectory(prefix="probe_ctc_") as tmp:
        lst, tokens, lexicon, _ = cs.synth_dataset(os.path.join(tmp, "data"), 0)
        train_lst, _, _, _ = cs.synth_dataset(os.path.join(tmp, "data"), 1, cs.TRAIN_UTTS,
                                              "train", (tokens, lexicon))
        for dt in ("float32", "bfloat16"):
            cfg = Config()
            cfg.update(cs.train_flags(cs.FLAGSHIP, train_lst, lst, tokens, lexicon, "", dt, 2))
            cfg.update(dict(rundir="", runname=""))
            tr = Trainer(cfg, device="cuda")
            largest = max(tr.train_ds.batch_specs(), key=lambda s: s.max_input_frames)
            big = pad_batch_rows(tr.train_ds.materialize(largest), 1)
            tgt, tl = np.asarray(big["target"]), np.asarray(big["target_len"])
            dup = int(sum(n - len(set(tgt[i, :n].tolist())) for i, n in enumerate(tl)))
            print(f"[batch] {dt} {list(big['audio'].shape)}: {int(tl.sum())} labels, {dup} of "
                  f"them a repeat of a label earlier in their row", flush=True)
            try:
                for side in ("K5/K5b", "F.ctc_loss"):
                    crit_ctc.ctc_loss = own if side == "K5/K5b" else library_ctc_loss
                    tr.criterion.fp32_emissions = side != "K5/K5b"
                    try:
                        cs.replay_update(tr, big, f"{dt} {side} replay")
                        out[f"{dt} {side}"] = "equal bits"
                    except SystemExit:
                        out[f"{dt} {side}"] = "parameters differ"
            finally:
                crit_ctc.ctc_loss = own
            del tr
            torch.cuda.empty_cache()

    def library_grad(x, tg, ll, tl, g):
        xl = x.detach().requires_grad_(True)
        return torch.autograd.grad(library_ctc_loss(xl, tg, ll, tl), xl, g)[0]

    for alphabet in (9997, 28):
        rng = np.random.RandomState(3)
        B, T, N, U = 16, 192, 9998, 72
        tl = rng.randint(55, U + 1, size=B)
        targets = np.full((B, U), -1, np.int64)
        for i in range(B):
            targets[i, :tl[i]] = rng.randint(0, alphabet, size=tl[i])
        case = dict(targets=targets, target_len=tl, logit_len=np.full(B, T), T=T, N=N, seed=4)
        for dt in ("float32", "bfloat16"):
            x, tg, ll, tln = cs.ctc_args(case, getattr(torch, dt))
            g = torch.ones(B, device="cuda")
            lib = [library_grad(x, tg, ll, tln, g) for _ in range(5)]
            saved = kernels.ctc_fwd(x, tg, ll, tln)[1:]
            own_dx = [kernels.ctc_bwd(g, x, tg, ll, tln, *saved) for _ in range(5)]
            row = dict(alphabet=alphabet, dtype=dt,
                       library_differ=[int((r != lib[0]).sum()) for r in lib[1:]],
                       k5b_differ=[int((r != own_dx[0]).sum()) for r in own_dx[1:]])
            out[f"backward {alphabet} {dt}"] = row
            print(f"[backward] {json.dumps(row)}", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("probe_ctc: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=["mutants", "replay"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from wav2letter_tpu_torch import kernels

    kernels.disable_tf32()
    res = probe_mutants(cs) if args.probe == "mutants" else probe_replay(cs)
    print(f"PROBE {args.probe} {json.dumps(res)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
