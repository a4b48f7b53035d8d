"""Where the time of K4b's first launch goes inside a block: a clock64 trace
of its pipeline.

    python -m wav2letter_tpu_torch.kernels.trace_k4b [--out FILE]

Needs a card and ``nvcc``. Builds a copy of ``csrc/attention.cu`` with
``clock64()`` stamps added in the chunk loop of ``mhsa_bwd_rows_kernel`` (the
kernel itself is unchanged), runs it at the transformer's training shape
(B=8, T=192, H=4, Dh=192, rate 0.2) in bf16 and fp32 at each tile height,
and prints, for the median block, the SM cycles of each pipeline step summed
over the chunks of each phase: ``k`` and ``Pwin`` (the scores), ``v1`` (D's
shares; the softmax runs in its first step), ``v2`` (ds), ``dq_k`` and
``dq_Pwin`` (dq; the rounding of ds runs in the first step). The steps are
split as ``trace_k4.py`` splits K4's: issue, wait, barrier, compute.

Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from . import _build
from .attention import BWD_ROWS, FWD_CHUNK_BYTES, _hash_args, bwd_columns, bwd_smem_bytes
from .trace_k4 import build_traced, median_block

_STAMPS = 256  # per block: 1 + 4 per chunk


def _instrument(src: str) -> str:
    """The kernel source with the stamps; every anchor must be found once in
    the first launch's part of the source."""
    a, b = src.index("// K4b, launch 1"), src.index("// K4b, launch 2")
    head, part, tail = src[:a], src[a:b], src[b:]
    edits = [
        ("float rate, unsigned thresh, float scale) {\n"
         "  extern __shared__ __align__(16) float smem[];\n",
         "float rate, unsigned thresh, float scale) {\n"
         "  extern __shared__ __align__(16) float smem[];\n"
         "  long long* st = g_k4b_stamps + (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *"
         f" blockIdx.z)) * {_STAMPS};\n"
         "  if (threadIdx.x == 0) st[0] = clock64();\n"),
        ("    cp_async_commit();  // one group a chunk, the last one empty\n",
         "    cp_async_commit();  // one group a chunk, the last one empty\n"
         "    if (threadIdx.x == 0) st[1 + 4 * c] = clock64();\n"),
        ("    cp_async_wait<1>();  // chunk c (and g) have arrived\n",
         "    cp_async_wait<1>();  // chunk c (and g) have arrived\n"
         "    if (threadIdx.x == 0) st[2 + 4 * c] = clock64();\n"),
        ("    __syncthreads();\n    const char* buf = stage + (c & 1) * L.stage;\n",
         "    __syncthreads();\n    const char* buf = stage + (c & 1) * L.stage;\n"
         "    if (threadIdx.x == 0) st[3 + 4 * c] = clock64();\n"),
    ]
    for old, new in edits:
        if part.count(old) != 1:
            raise RuntimeError(f"trace_k4b: anchor not found once in csrc/attention.cu: {old!r}")
        part = part.replace(old, new)
    end = part.rindex("    __syncthreads();\n  }\n}")
    part = part[:end] + "    if (threadIdx.x == 0) st[4 + 4 * c] = clock64();\n" + part[end:]
    head = head.replace('#include "common.cuh"\n',
                        '#include "common.cuh"\n__device__ long long g_k4b_stamps[1 << 20];\n', 1)
    tail += ('\nextern "C" int w2l_k4b_stamps(long long* host, int n) {\n'
             "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_k4b_stamps,"
             " n * sizeof(long long)));\n}\n")
    return head + part + tail


def trace(lib, dtype, B=8, T=192, H=4, Dh=192, rows=48) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (0.5 * torch.randn((B, T, H * Dh), device="cuda", generator=g).to(dtype)
                     for _ in range(4))
    pos = (0.1 * torch.randn((2 * T - 1, Dh), device="cuda", generator=g)).to(dtype)
    mask = torch.zeros((B, T), device="cuda")
    grads = [torch.empty_like(q) for _ in range(3)]
    dpos = torch.empty((2 * T - 1, Dh), device="cuda")
    pd = torch.empty((B, H, T, -(-T // 8) * 8), device="cuda", dtype=dtype)
    ds = torch.empty_like(pd)
    part = torch.empty((B * H, 2 * T - 1, Dh), device="cuda")
    sms = _build.sm_count(q.device)
    for _ in range(3):  # the last run's stamps are read
        rc = lib.w2l_mhsa_bwd(*(t.data_ptr() for t in (q, k, v, pos, mask, dout, *grads, dpos,
                                                        pd, ds, part)),
                              _build.DTYPE_CODES[dtype], B, T, H, Dh, *_hash_args(T, 0.2, 7),
                              rows, sms, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "trace_k4b")
    torch.cuda.synchronize()
    nb = -(-T // rows) * H * B
    st = np.zeros(nb * _STAMPS, np.int64)
    _build.check(lib.w2l_k4b_stamps(st.ctypes.data, st.size), "trace_k4b")
    st = st.reshape(nb, _STAMPS)
    ch = FWD_CHUNK_BYTES // torch.tensor([], dtype=dtype).element_size()
    nk, npw = -(-T // ch), -(-(T + rows - 1) // ch)
    s1, s3 = nk + npw, nk + npw + 2 * nk
    n = s3 + -(-Dh // bwd_columns(Dh)) * (nk + npw)

    def phase(c):
        if c < s1:
            return "k" if c < nk else "Pwin"
        if c < s3:
            return "v1" if c < s1 + nk else "v2"
        return "dq_k" if (c - s3) % (nk + npw) < nk else "dq_Pwin"

    return dict(dtype=str(dtype).replace("torch.", ""), shape=[B, T, H, Dh], rows=rows,
                steps=n, **median_block(st, n, phase))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the readings here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_k4b: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    lib = build_traced(_instrument((_build.CSRC / "attention.cu").read_text()), "trace_k4b",
                       "w2l_mhsa_bwd", "w2l_k4b_stamps")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        item = torch.tensor([], dtype=dtype).element_size()
        for rows in BWD_ROWS:
            if bwd_smem_bytes(rows, 192, 192, item) <= _build.MAX_SMEM_BYTES:
                out.append(trace(lib, dtype, rows=rows))
                print(json.dumps(out[-1]), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, traces=out), f, indent=1)


if __name__ == "__main__":
    main()
