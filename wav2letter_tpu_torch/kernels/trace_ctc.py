"""Where a CTC scan step's time goes: a trace of K5's alpha scan and K5b's
beta scan on the block route.

    python -m wav2letter_tpu_torch.kernels.trace_ctc [--ring-depth D] [--out FILE]

Needs a card and ``nvcc``. Builds a copy of ``csrc/ctc.cu`` (with another
``RING_DEPTH`` where given, as ``time_ctc.py --ring-depths`` does) whose scans stamp each step of their first thread with ``clock64()``, six
times in the step's order: at its start (``issue``: to the shared store of
its state), before the barrier (``exchange``: the barrier and the loads of
the neighbours, which the stamp waits for), after the read of the next
step's lp from the ring (``read``: the stamp waits for it), once the step's
lse3 has its result (``compute``), once its alpha or beta is stored
(``store``), and to the next step's start (``loop``); and ``%globaltimer``
beside ``clock64()`` before and after the chain. Runs both scans at the
flagship's B = 16, T = 192, N = 9998, bf16 logits, for U = 96 (L = 193) and
U = 16 (L = 33), once with the inputs out of L2 (``cold``) and once after
the same launches ran three times (``warm``), and prints for each scan:

- ``warm_split_us``: each launch's L2-warm device time by the profiler
  (stamps included), and ``chain_us``: the median block's chain on the
  global timer;
- ``step_cycles`` of the median and of the slowest block: the median over
  its steps of each part, and of their sum; ``step_ns`` at the SM clock the
  stamps imply (``sm_ghz``);
- ``slow_steps``: the steps whose cycles pass twice the median (a step that
  waited on a load shows there);
- ``blocks_us``: the first block's chain start to the last block's chain end,
  and how far apart the blocks' chains started; ``blocks``: each block's SM
  and chain; ``sms``: how many SMs the blocks ran on, and how many blocks
  shared one.

Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import _build
from .trace_k4 import build_traced

MAX_BLOCKS, MAX_STEPS = 64, 256
SPAN = 5  # a block's global timer and clock64 before and after its chain, and its SM
STAMPS = 6  # a step's start, exchange, neighbours in, lse3 result, refill issued, store issued
_STAMP = ('  asm volatile("mov.u64 %0, %%clock64;" : "=l"({}) : {} : "memory");\n')
_GT = '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}) :: "memory");\n'
_CLOCK = '        asm volatile("mov.u64 %0, %%clock64;" : "=l"({}) :: "memory");\n'


def _dep(name: str, *regs: str) -> str:
    return _STAMP.format(name, ", ".join(f'"f"({r})' for r in regs))


def _record(scan: int, step: str) -> str:
    return (f"        if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS} && ({step}) < {MAX_STEPS})"
            " {\n"
            f"          unsigned long long* st = g_ctc_stamps + ((static_cast<size_t>({scan}) *"
            f" {MAX_BLOCKS} + blockIdx.x) * {MAX_STEPS} + ({step})) * {STAMPS};\n"
            "          st[0] = e0; st[1] = e1; st[2] = e2; st[3] = e3; st[4] = e4; st[5] = e5;\n"
            "        }\n")


def _span(scan: int, which: int) -> str:
    """The global timer and clock64 before (``which`` 0) or after (1) the
    chain, and the SM, by the block's first thread."""
    at = f"g_ctc_span[({scan} * {MAX_BLOCKS} + blockIdx.x) * {SPAN}"
    return ("  {\n    unsigned long long gt;\n    unsigned smid;\n" + _GT.format("gt")
            + '    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));\n'
            + f"    if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{\n"
            f"      {at} + {2 * which}] = gt;\n"
            f"      {at} + {2 * which + 1}] = clock64();\n"
            f"      {at} + 4] = smid;\n    }}\n  }}\n")


_DECL = "        long long e0, e1 = 0, e2 = 0, e3 = 0, e4 = 0, e5 = 0;\n"


def _at(stamp: str, *deps: str) -> str:
    return _dep(stamp, *deps) if deps else _CLOCK.format(stamp)


# Each scan kernel's stamps, in the order its step passes them: (anchor,
# "before" or "after" it, stamp, registers the stamp waits for). The parts
# between them are named in PARTS.
_STEP_EDITS = {
    "ctc_alpha_block_kernel(const float*": (0, "k", [
        ("      if (k < n) {  // (a guard, not a break)\n", "after", "e0", ()),
        ("        scan_barrier(ns + 32);\n", "before", "e1", ()),
        ("        const float p1 = w[tid - 1], p2 = w[tid - 2];\n", "after", "e2", ("p1", "p2")),
        ("          lnext = ring_read(ring, k + 1, shift, s);\n        }\n", "after", "e3",
         ("lnext",)),
        ("        a = alpha_step(a, p1, p2, l, valid, skip);\n", "after", "e4", ("a",)),
        ("        if (in) *out = a;\n", "after", "e5", ()),
    ], "  for (int k0 = 0; k0 < n; k0 += D) {\n",
        "  // logZ from the last frame's states 2 tl and 2 tl - 1, through the half\n"),
    "ctc_beta_block_kernel(const float*": (1, "k", [
        ("      if (k < n) {\n", "after", "e0", ()),
        ("        scan_barrier(ns + 32);\n", "before", "e1", ()),
        ("        const float q1 = w[tid + 1], q2 = w[tid + 2];\n", "after", "e2", ("q1", "q2")),
        ("          lnext = ring_read(ring, k + 1, shift, s);\n        }\n", "after", "e3",
         ("lnext",)),
        ("        be = beta_step(bb, q1, q2, valid, from);\n", "after", "e4", ("be",)),
        ("        if (in) *out = be;\n", "after", "e5", ()),
    ], "  for (int k0 = 0; k0 < n; k0 += D) {\n", None),
}

# the parts between a step's stamps e0 .. e5, and from e5 to the next step's e0
PARTS = ("issue", "exchange", "read", "compute", "store", "loop")


def instrument(src: str) -> str:
    """``src`` with the stamps in the block route's two scan kernels; every
    anchor must be found once in its kernel."""
    for head, (scan, step, edits, loop_anchor, end_anchor) in _STEP_EDITS.items():
        if src.count(head) != 1:
            raise RuntimeError(f"trace_ctc: kernel {head!r} not found once in ctc.cu")
        start = src.index(head)
        end = src.index("\n}\n", start) + 3
        kern = src[start:end]
        for i, (anchor, where, stamp, deps) in enumerate(edits):
            if kern.count(anchor) != 1:
                raise RuntimeError(f"trace_ctc: anchor not found once in {head}: {anchor!r}")
            add = (_DECL if i == 0 else "") + _at(stamp, *deps)
            if i == len(edits) - 1:
                add += _record(scan, step)
            kern = kern.replace(anchor, anchor + add if where == "after" else add + anchor)
        kern = kern.replace(loop_anchor, _span(scan, 0) + loop_anchor)
        if end_anchor:
            kern = kern.replace(end_anchor, _span(scan, 1) + end_anchor)
        else:
            kern = kern[:-2] + _span(scan, 1) + "}\n"
        src = src[:start] + kern + src[end:]
    src = src.replace(
        '#include "common.cuh"\n',
        '#include "common.cuh"\n'
        f"__device__ unsigned long long g_ctc_stamps[2 * {MAX_BLOCKS} * {MAX_STEPS} * {STAMPS}];\n"
        f"__device__ unsigned long long g_ctc_span[2 * {MAX_BLOCKS} * {SPAN}];\n", 1)
    src += ('\nextern "C" int w2l_ctc_stamps(unsigned long long* host, int n) {\n'
            "  cudaError_t rc = cudaMemcpyFromSymbol(host, g_ctc_stamps,"
            " n * sizeof(unsigned long long));\n"
            "  if (rc != cudaSuccess) return static_cast<int>(rc);\n"
            f"  return static_cast<int>(cudaMemcpyFromSymbol(host + n, g_ctc_span,"
            f" 2 * {MAX_BLOCKS} * {SPAN} * sizeof(unsigned long long)));\n}}\n")
    return src


def with_ring_depth(src: str, depth: int) -> str:
    """``src`` with ``RING_DEPTH`` (the frames of lp the scans bring ahead of
    their chains) set to ``depth``."""
    pattern = re.compile(r"constexpr int RING_DEPTH = (\d+);")
    if len(pattern.findall(src)) != 1:
        raise RuntimeError("trace_ctc: RING_DEPTH not found once in ctc.cu")
    return pattern.sub(f"constexpr int RING_DEPTH = {int(depth)};", src)


def _steps(st: np.ndarray, span: np.ndarray, blk: int, n: int, names) -> dict:
    """Cycles of each part of block ``blk``'s steps (medians), its chain on
    the global timer, and its SM clock."""
    s = st[blk, :n]
    total = np.diff(s[:, 0])
    parts = {name: s[:, i + 1] - s[:, i] for i, name in enumerate(names[:-1])}
    parts[names[-1]] = s[1:, 0] - s[:-1, 5]
    chain_ns = float(span[blk, 2] - span[blk, 0])
    ghz = float(span[blk, 3] - span[blk, 1]) / chain_ns if chain_ns > 0 else float("nan")
    med = float(np.median(total)) if len(total) else float("nan")
    return dict(
        chain_us=chain_ns / 1e3, sm_ghz=ghz, sm=int(span[blk, 4]),
        step_cycles=dict({k: float(np.median(v)) if len(v) else 0.0 for k, v in parts.items()},
                         total=med),
        step_ns=med / ghz if ghz == ghz else None,
        slow_steps=int((total > 2 * med).sum()) if len(total) else 0)


def _summary(st: np.ndarray, span: np.ndarray, nsteps: np.ndarray, names) -> dict:
    """Stamps (blocks, steps, ``STAMPS``) and spans (blocks, ``SPAN``) of one
    scan: the median block's steps, and the slowest block's."""
    chain = span[:, 2] - span[:, 0]
    order = np.argsort(chain)
    med, slow = int(order[len(order) // 2]), int(order[-1])
    n = int(min(nsteps[med], MAX_STEPS))
    return dict(
        steps=n,
        blocks_us=dict(first_start_to_last_end=float(span[:, 2].max() - span[:, 0].min()) / 1e3,
                       start_spread=float(span[:, 0].max() - span[:, 0].min()) / 1e3),
        sms=dict(distinct=int(len(np.unique(span[:, 4]))),
                 shared_by=sorted(int(c) for c in np.unique(span[:, 4], return_counts=True)[1]
                                  if c > 1)),
        blocks=[dict(b=i, sm=int(span[i, 4]), chain_us=round(float(chain[i]) / 1e3, 3))
                for i in range(len(chain))],
        median_block=_steps(st, span, med, n, names),
        slowest_block=_steps(st, span, slow, n, names))


def trace(lib, cs, U: int) -> dict:
    B, T, N = 16, 192, 9998
    rng = np.random.RandomState(U)
    tl = rng.randint(U * 3 // 4, U + 1, size=B)
    targets = np.full((B, U), -1, np.int64)
    for i in range(B):
        targets[i, :tl[i]] = rng.randint(0, N - 1, size=tl[i])
    case = dict(targets=targets, target_len=tl, logit_len=np.full(B, T), T=T, N=N, seed=U)
    x, tg, ll, tln = cs.ctc_args(case, torch.bfloat16)
    L = 2 * U + 1
    f32 = dict(dtype=torch.float32, device="cuda")
    lse, lp, alpha = (torch.empty((B, T), **f32), torch.empty((T, B, L), **f32),
                      torch.empty((T, B, L), **f32))
    loss, logz, g = torch.empty((B,), **f32), torch.empty((B,), **f32), torch.ones((B,), **f32)
    slots = torch.empty((B, 2 * U + 1), dtype=torch.int32, device="cuda")
    beta, dx = torch.empty((T, B, L), **f32), torch.empty_like(x)
    code = _build.DTYPE_CODES[torch.bfloat16]
    stream = _build.stream_ptr(x)

    def fwd():
        _build.check(lib.w2l_ctc_fwd(
            x.data_ptr(), tg.data_ptr(), ll.data_ptr(), tln.data_ptr(), lse.data_ptr(),
            lp.data_ptr(), alpha.data_ptr(), loss.data_ptr(), logz.data_ptr(), 0, code, B, T,
            N, U, _build.MAX_SMEM_BYTES, stream), "trace_ctc")

    def bwd():
        _build.check(lib.w2l_ctc_bwd(
            x.data_ptr(), lse.data_ptr(), lp.data_ptr(), alpha.data_ptr(), logz.data_ptr(),
            g.data_ptr(), tg.data_ptr(), ll.data_ptr(), tln.data_ptr(), slots.data_ptr(),
            beta.data_ptr(), 0, dx.data_ptr(), code, B, T, N, U, _build.MAX_SMEM_BYTES,
            stream), "trace_ctc")

    split = {}
    for fn in (fwd, bwd):
        for key, ms in cs.device_split(fn, (), cold=False).items():
            split[cs._ctc_launch(key)] = split.get(cs._ctc_launch(key), 0.0) + ms
    flush = torch.empty(2 * cs.L2_BYTES // 4, device="cuda")
    steps = np.full(B, T - 1)
    route = ("block", "wide")[lib.w2l_ctc_route(L)]
    out = dict(U=U, L=L, route=route,
               warm_split_us={k: v * 1e3 for k, v in split.items()})
    for state in ("cold", "warm"):
        if state == "cold":  # x and lp out of L2 before each launch whose stamps are read
            flush.zero_()
            fwd()
            flush.zero_()
            bwd()
        else:  # the same launches again and again, as the warm split times them
            for _ in range(3):
                fwd()
                bwd()
        torch.cuda.synchronize()
        n = 2 * MAX_BLOCKS * MAX_STEPS * STAMPS
        raw = np.zeros(n + 2 * MAX_BLOCKS * SPAN, np.uint64)
        _build.check(lib.w2l_ctc_stamps(raw.ctypes.data, n), "trace_ctc")
        st = raw[:n].astype(np.int64).reshape(2, MAX_BLOCKS, MAX_STEPS, STAMPS)[:, :B]
        span = raw[n:].astype(np.int64).reshape(2, MAX_BLOCKS, SPAN)[:, :B]
        out[state] = {scan: _summary(st[i], span[i], steps, PARTS)
                      for i, scan in enumerate(("alpha", "beta"))}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ring-depth", type=int, default=0, help="RING_DEPTH of the traced copy")
    ap.add_argument("--out", default="", help="also write the readings here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_ctc: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    src = (_build.CSRC / "ctc.cu").read_text()
    if args.ring_depth:
        src = with_ring_depth(src, args.ring_depth)
    src = instrument(src)
    stem = f"trace_ctc{args.ring_depth or ''}"
    lib = build_traced(src, stem, "w2l_ctc_fwd", "w2l_ctc_stamps")
    for entry in ("w2l_ctc_bwd", "w2l_ctc_route"):
        getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows = []
    for U in (96, 16):
        rows.append(dict(ring_depth=args.ring_depth or None, **trace(lib, cs, U)))
        print(f"TRACE {json.dumps(rows[-1])}", flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, traces=rows), f, indent=1)


if __name__ == "__main__":
    main()
