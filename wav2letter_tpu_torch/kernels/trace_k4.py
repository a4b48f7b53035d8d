"""Where K4's time goes inside a block: a clock64 trace of its pipeline.

    python -m wav2letter_tpu_torch.kernels.trace_k4 [--out FILE]

Needs a card and ``nvcc``. Builds a copy of ``csrc/attention.cu`` with
``clock64()`` stamps added in K4's chunk loop (the kernel itself is
unchanged), runs it at the transformer's serving shape (B=4, T=192, H=4,
Dh=192) in bf16 and fp32 at each tile height that fits, and prints, for the
median block, the SM cycles of each pipeline step summed over the chunks of
each phase (k, Pwin, v; the softmax runs in the first v step):

- ``issue``: from the end of the last step's products to the next chunk's
  cp.async issued, which takes in the closing barrier of the step before;
- ``wait``: cp.async.wait_group for the chunk in use;
- ``barrier``: the barrier after it;
- ``compute``: the products (and stores) on the chunk.

Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from . import _build
from .attention import FWD_CHUNK_BYTES, FWD_ROWS, _hash_args, fwd_smem_bytes

_STAMPS = 256  # per block: 1 + 4 per chunk


def _instrument(src: str) -> str:
    """The kernel source with the stamps; every anchor must be found once."""
    k4b = src.index("// K4b, launch 1")
    head, tail = src[:k4b], src[k4b:]
    edits = [
        ('#include "common.cuh"\n',
         '#include "common.cuh"\n__device__ long long g_k4_stamps[1 << 20];\n'),
        ("                unsigned thresh, float scale) {\n"
         "  extern __shared__ __align__(16) float smem[];\n",
         "                unsigned thresh, float scale) {\n"
         "  extern __shared__ __align__(16) float smem[];\n"
         "  long long* st = g_k4_stamps + (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *"
         f" blockIdx.z)) * {_STAMPS};\n"
         "  if (threadIdx.x == 0) st[0] = clock64();\n"),
        ("    cp_async_commit();  // one group a chunk, the last one empty\n",
         "    cp_async_commit();  // one group a chunk, the last one empty\n"
         "    if (threadIdx.x == 0) st[1 + 4 * c] = clock64();\n"),
        ("    cp_async_wait<1>();  // chunk c has arrived\n",
         "    cp_async_wait<1>();  // chunk c has arrived\n"
         "    if (threadIdx.x == 0) st[2 + 4 * c] = clock64();\n"),
        ("    __syncthreads();\n    const char* buf = stage + (c & 1) * L.stage;\n",
         "    __syncthreads();\n    const char* buf = stage + (c & 1) * L.stage;\n"
         "    if (threadIdx.x == 0) st[3 + 4 * c] = clock64();\n"),
    ]
    for old, new in edits:
        if head.count(old) != 1:
            raise RuntimeError(f"trace_k4: anchor not found once in csrc/attention.cu: {old!r}")
        head = head.replace(old, new)
    end = head.rindex("    __syncthreads();\n  }\n}")
    head = head[:end] + "    if (threadIdx.x == 0) st[4 + 4 * c] = clock64();\n" + head[end:]
    tail += ('\nextern "C" int w2l_k4_stamps(long long* host, int n) {\n'
             "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_k4_stamps,"
             " n * sizeof(long long)));\n}\n")
    return head + tail


def build_traced(source: str, stem: str, entry: str,
                 stamps: Optional[str] = None) -> ctypes.CDLL:
    """Compile an altered copy of a source of ``csrc/`` into
    ``build/torch_kernels/<stem>/<stem>.cu`` and bind its ``entry`` and, where
    given, ``stamps`` (which copies the stamps to the host)."""
    work = _build.BUILD_DIR / stem
    work.mkdir(parents=True, exist_ok=True)
    src = work / f"{stem}.cu"
    src.write_text(source)
    lib = work / f"lib{stem}.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    res = subprocess.run([_build.nvcc(), *flags, "-shared", f"-I{_build.CSRC}", str(src), "-o",
                          str(lib)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{stem}: nvcc failed:\n{res.stdout}\n{res.stderr}")
    cdll = ctypes.CDLL(str(lib))
    getattr(cdll, entry).argtypes = _build.SIGNATURES[entry]
    getattr(cdll, entry).restype = ctypes.c_int
    if stamps:
        getattr(cdll, stamps).argtypes = [ctypes.c_void_p, ctypes.c_int]
    return cdll


def median_block(st: np.ndarray, n: int, phase_of) -> dict:
    """The stamps (blocks x stamps: one at the start, then 4 a step) of the
    block of median length: its cycles of each step, issue, wait, barrier and
    compute, summed by ``phase_of(step)``, and every block's total."""
    total = st[:, 4 * n] - st[:, 0]
    blk = int(np.argsort(total)[len(st) // 2])
    phases = {}
    prev = st[blk, 0]
    for c in range(n):
        t = st[blk, 1 + 4 * c: 5 + 4 * c]
        sums = phases.setdefault(phase_of(c), np.zeros(4, np.int64))
        sums += np.array([t[0] - prev, t[1] - t[0], t[2] - t[1], t[3] - t[2]])
        prev = t[3]
    return dict(block_cycles=dict(min=int(total.min()), median=int(np.median(total)),
                                  max=int(total.max())),
                median_block={p: dict(zip(("issue", "wait", "barrier", "compute"),
                                          map(int, v))) for p, v in phases.items()})


def trace(lib, dtype, B=4, T=192, H=4, Dh=192, rows=32) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (0.5 * torch.randn((B, T, H * Dh), device="cuda", generator=g).to(dtype)
               for _ in range(3))
    pos = (0.1 * torch.randn((2 * T - 1, Dh), device="cuda", generator=g)).to(dtype)
    mask = torch.zeros((B, T), device="cuda")
    out = torch.empty_like(q)
    for _ in range(3):  # the last run's stamps are read
        rc = lib.w2l_mhsa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                              mask.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[dtype], B, T,
                              H, Dh, *_hash_args(T, 0.0, 7), rows,
                              torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "trace_k4")
    torch.cuda.synchronize()
    nb = -(-T // rows) * H * B
    st = np.zeros(nb * _STAMPS, np.int64)
    _build.check(lib.w2l_k4_stamps(st.ctypes.data, st.size), "trace_k4")
    st = st.reshape(nb, _STAMPS)
    ch = FWD_CHUNK_BYTES // torch.tensor([], dtype=dtype).element_size()
    nk, npw = -(-T // ch), -(-(T + rows - 1) // ch)
    n = nk + npw + -(-Dh // 128) * nk
    return dict(dtype=str(dtype).replace("torch.", ""), shape=[B, T, H, Dh], rows=rows,
                chunks=dict(k=nk, Pwin=npw, v=n - nk - npw),
                **median_block(st, n, lambda c: "k" if c < nk else "Pwin" if c < nk + npw
                               else "v"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the readings here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_k4: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    lib = build_traced(_instrument((_build.CSRC / "attention.cu").read_text()), "trace_k4",
                       "w2l_mhsa_fwd", "w2l_k4_stamps")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows_out = []
    for dtype in (torch.bfloat16, torch.float32):
        item = torch.tensor([], dtype=dtype).element_size()
        for rows in FWD_ROWS:
            if fwd_smem_bytes(rows, 192, 192, item) <= _build.MAX_SMEM_BYTES:
                rows_out.append(trace(lib, dtype, rows=rows))
                print(json.dumps(rows_out[-1]), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, traces=rows_out), f, indent=1)


if __name__ == "__main__":
    main()
