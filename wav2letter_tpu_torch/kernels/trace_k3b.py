"""Where K3b's time goes at narrow rows: a trace of the register route.

    python -m wav2letter_tpu_torch.kernels.trace_k3b [--out FILE]

Needs a card and ``nvcc``. Builds a copy of ``csrc/layernorm.cu`` whose
register-route backward (``residual_ln_bwd_reg_kernel``; the kernel itself is
unchanged) stamps each row from its first thread: ``%globaltimer`` (ns) at
its start and end, ``clock64()`` at its start, once its loads have arrived
(the stamp takes both row sums as inputs, so it waits for every load), after
the paired reduction and after its stores are issued, and ``%smid``. Runs it
at the main paths' row shapes in bf16 (and mls's in fp32), cold, and prints
for each:

- ``kernel_us``: the launch's device time from the profiler (stamps
  included), and ``span_us``: the first row's start to the last row's end
  on the global timer; the rest is the launch's ramp before the first row
  and the drain of the last stores;
- ``row_us``: a row's median time from start to end, and its cycles by step
  (``loads``: the three inputs' round trip to HBM, ``reduce``, ``stores``:
  the issue of dz's vectors);
- ``waves``: how many times over the SMs' slots the rows ran (the largest
  number of rows an SM ran one after another in one slot, as the
  ``resident`` rows an SM held at once divide its rows), and
  ``resident``: the most rows one SM held at once;
- ``bound_us`` beside the kernel's time, from the bytes the function moves.

``bwd_rows`` and ``with_bwd_rows`` read and set the one-warp rows a block
of K3b's launch (``LN_BWD_ROWS`` of ``csrc/layernorm.cu``) for the readings
of ``chip_smoke.py`` and for ``time_k1k3.py --k3b-rows``. Nothing of the port
imports this module.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import _build
from .layernorm import bwd_layout, residual_ln_plain
from .trace_k4 import build_traced

_STAMPS = 7  # per row: globaltimer start, end; clock64 start, loads, reduce, stores; smid
# (dtype, R, D): mls, the transformer, transformer_s2s, two flagship rows; mls in fp32
SHAPES = [("bfloat16", 3072, 256), ("bfloat16", 1536, 768), ("bfloat16", 768, 768),
          ("bfloat16", 12288, 1280), ("bfloat16", 3072, 2240), ("float32", 3072, 256)]
_ROWS = re.compile(r"constexpr int LN_BWD_ROWS = (\d+);")


def bwd_rows(src: str = "") -> int:
    """``LN_BWD_ROWS`` of ``src`` (default ``csrc/layernorm.cu``): the rows a
    block K3b's launch gives rows of one warp (rows of more warps get a block
    each)."""
    found = _ROWS.findall(src or (_build.CSRC / "layernorm.cu").read_text())
    if len(found) != 1:
        raise RuntimeError("trace_k3b: LN_BWD_ROWS not found once in csrc/layernorm.cu")
    return int(found[0])


def with_bwd_rows(src: str, rows: int) -> str:
    """``src`` with K3b's one-warp rows a block set to ``rows``."""
    bwd_rows(src)
    return _ROWS.sub(f"constexpr int LN_BWD_ROWS = {int(rows)};", src)


def _instrument(src: str) -> str:
    """The source with the stamps; every anchor must be found once."""
    start = src.index("residual_ln_bwd_reg_kernel(")
    end = src.index("\ntemplate <typename T, int V>\nvoid launch_bwd_reg_v", start)
    head, kern, tail = src[:start], src[start:end], src[end:]
    gt = '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}) :: "memory");\n'
    edits = [
        ("  if (row >= R) return;  // only a one-warp row past the last: no barrier follows\n",
         "  if (row >= R) return;  // only a one-warp row past the last: no barrier follows\n"
         "  unsigned long long* st = g_k3b_stamps + static_cast<size_t>(row) * 7;\n"
         "  unsigned long long gt0, gt1;\n" + gt.format("gt0")
         + "  const long long c0 = clock64();\n"),
        ("#pragma unroll\n  for (int o = 16; o > 0; o >>= 1) {\n",
         "  long long c1;\n"
         '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1) : "f"(s1), "f"(s2) : "memory");\n'
         "#pragma unroll\n  for (int o = 16; o > 0; o >>= 1) {\n"),
        ("  const float wv = w[0];\n  const float m1 = wv * s1 / D;\n",
         "  long long c2;\n"
         '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c2) : "f"(s1), "f"(s2) : "memory");\n'
         "  const float wv = w[0];\n  const float m1 = wv * s1 / D;\n"),
        ("  if (t == 0) {\n    row_g[row] = s1;\n",
         "  const long long c3 = clock64();\n" + gt.format("gt1")
         + "  if (t == 0) {\n    unsigned smid;\n"
         '    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));\n'
         "    st[0] = gt0; st[1] = gt1; st[2] = c0; st[3] = c1; st[4] = c2; st[5] = c3;\n"
         "    st[6] = smid;\n    row_g[row] = s1;\n"),
    ]
    for old, new in edits:
        if kern.count(old) != 1:
            raise RuntimeError(f"trace_k3b: anchor not found once in the kernel: {old!r}")
        kern = kern.replace(old, new)
    head = head.replace('#include "common.cuh"\n',
                        '#include "common.cuh"\n'
                        "__device__ unsigned long long g_k3b_stamps[7 << 16];\n", 1)
    tail += ('\nextern "C" int w2l_k3b_stamps(unsigned long long* host, int n) {\n'
             "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_k3b_stamps,"
             " n * sizeof(unsigned long long)));\n}\n")
    return head + kern + tail


def _waves(st: np.ndarray) -> tuple:
    """(the most rows one SM held at once, the most rows one SM ran one after
    another in a slot): a sweep over each SM's row intervals."""
    resident, serial = 0, 0
    for sm in np.unique(st[:, 6]):
        rows = st[st[:, 6] == sm]
        ev = sorted([(int(a), 1) for a in rows[:, 0]] + [(int(b), -1) for b in rows[:, 1]],
                    key=lambda e: (e[0], e[1]))
        cur = top = 0
        for _, d in ev:
            cur += d
            top = max(top, cur)
        resident = max(resident, top)
        serial = max(serial, -(-len(rows) // top))
    return resident, serial


def trace(lib, cs, dtype_name: str, R: int, D: int) -> dict:
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(R + D)
    gr, x, y = (torch.randn((R, D), device="cuda", generator=g).to(dtype) for _ in range(3))
    w = torch.tensor([1.3], device="cuda")
    _, mu, rsig = residual_ln_plain(x, y, w, torch.tensor([-0.2], device="cuda"))
    way, wpr = bwd_layout(D, x.element_size())
    assert way == "registers"
    rows = bwd_rows() if wpr == 1 else 1
    code = _build.DTYPE_CODES[dtype]

    def launch(a, b, c, m, r):
        dz = torch.empty_like(a)
        rg, rgz = (torch.empty((R,), device="cuda") for _ in range(2))
        rc = lib.w2l_residual_ln_bwd(a.data_ptr(), b.data_ptr(), c.data_ptr(), m.data_ptr(),
                                     r.data_ptr(), w.data_ptr(), dz.data_ptr(), rg.data_ptr(),
                                     rgz.data_ptr(), code, R, D, wpr,
                                     torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "trace_k3b")
        return dz

    kernel_ms = cs.device_ms(launch, (gr, x, y, mu, rsig))
    inputs = [t.clone() for t in (gr, x, y, mu, rsig)]
    torch.empty(2 * cs.L2_BYTES // 4, device="cuda").zero_()  # the inputs out of L2
    launch(*inputs)  # the launch whose stamps are read
    torch.cuda.synchronize()
    st = np.zeros(R * _STAMPS, np.uint64)
    _build.check(lib.w2l_k3b_stamps(st.ctypes.data, st.size), "trace_k3b")
    st = st.reshape(R, _STAMPS).astype(np.int64)
    row_ns = st[:, 1] - st[:, 0]
    cyc = st[:, 5] - st[:, 2]
    ghz = float(np.median(cyc[row_ns > 0] / row_ns[row_ns > 0]))
    resident, serial = _waves(st)
    ticks = np.diff(np.unique(st[:, 0]))
    nbytes = 4 * R * D * x.element_size() + 16 * R + 4
    b_ms, _ = cs.bound(nbytes, 12 * R * D, "float32")
    return dict(
        dtype=dtype_name, shape=[R, D], warps_per_row=wpr, rows_per_block=rows,
        blocks=-(-R // rows), kernel_us=kernel_ms * 1e3, bound_us=b_ms * 1e3,
        span_us=(st[:, 1].max() - st[:, 0].min()) / 1e3,
        row_us=dict(min=float(row_ns.min()) / 1e3, median=float(np.median(row_ns)) / 1e3,
                    max=float(row_ns.max()) / 1e3),
        row_cycles=dict(loads=int(np.median(st[:, 3] - st[:, 2])),
                        reduce=int(np.median(st[:, 4] - st[:, 3])),
                        stores=int(np.median(st[:, 5] - st[:, 4]))),
        sm_ghz=ghz, sms=int(len(np.unique(st[:, 6]))), resident=resident, waves=serial,
        last_start_us=(st[:, 0].max() - st[:, 0].min()) / 1e3,
        globaltimer_tick_ns=int(ticks[ticks > 0].min()) if (ticks > 0).any() else None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the readings here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_k3b: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    lib = build_traced(_instrument((_build.CSRC / "layernorm.cu").read_text()), "trace_k3b",
                       "w2l_residual_ln_bwd", "w2l_k3b_stamps")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows = []
    for dt, R, D in SHAPES:
        rows.append(trace(lib, cs, dt, R, D))
        print(json.dumps(rows[-1]), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, traces=rows), f, indent=1)


if __name__ == "__main__":
    main()
