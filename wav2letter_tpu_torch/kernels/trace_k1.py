"""Where K1's time goes inside a block: a clock64 trace of the tensor-core
route.

    python -m wav2letter_tpu_torch.kernels.trace_k1 [--out FILE]

Needs a card and ``nvcc``. Builds a copy of ``csrc/mfsc.cu`` with
``clock64()`` stamps taken by thread 0 of each block (the kernel itself is
unchanged), runs the tensor-core kernel on the flagship's frontend (frame
400, stride 160, 257 bins, 80 mels) at the serving row (B=4, 246000
samples) with 16-, 32- and 48-frame tiles and at the training row (B=16), and
prints, for the block of median length, its SM cycles by step:

- ``staging``: the audio span's and the first three chunks' cp.async
  issued;
- ``dft``: the DFT's 8-deep steps, summed over them and split into
  ``wait`` (cp.async.wait_group for the chunk), ``barrier`` (the barrier
  after it), ``issue`` (the chunk three steps on) and ``products`` (the
  3xTF32 mma.sync tiles), and ``drain`` (the last wait and barrier);
- ``magnitude``: the magnitudes to shared memory and the barrier after;
- ``mel`` and ``stores``: thread 0's warp's mel tiles, products and the
  log and stores apart; ``tail``: waiting for the block's other warps.

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
from .mfsc import tile_frames
from .trace_k4 import build_traced

_STAMPS = 256  # per block: 2 + 4 per 8-deep step + 5


def _instrument(src: str) -> str:
    """The kernel source with the stamps; every anchor must be found once."""
    cc = src.index("// CUDA cores\n// ----")
    head, tail = src[:cc], src[cc:]
    s = "  if (tid == 0) st[{}] = clock64();\n"
    edits = [
        ('#include "tc_tile.cuh"\n',
         '#include "tc_tile.cuh"\n__device__ long long g_k1_stamps[1 << 20];\n'),
        ("  const int g = lane >> 2, tq = lane & 3;\n",
         "  const int g = lane >> 2, tq = lane & 3;\n"
         f"  long long* st = g_k1_stamps + (blockIdx.x + gridDim.x * blockIdx.y) * {_STAMPS};\n"
         + s.format(0)),
        ("    if (c < KS) issue_chunk(c);\n    cp_async_commit();\n  }\n",
         "    if (c < KS) issue_chunk(c);\n    cp_async_commit();\n  }\n" + s.format(1)),
        ("  // chunk c (and the audio) has arrived\n",
         "  // chunk c (and the audio) has arrived\n  " + s.format("2 + 4 * c")),
        ("    __syncthreads();  // ... for every thread; chunk c - 1's buffer is free\n",
         "    __syncthreads();  // ... for every thread; chunk c - 1's buffer is free\n"
         + "  " + s.format("3 + 4 * c")),
        ("    cp_async_commit();  // one group a chunk, maybe empty\n",
         "    cp_async_commit();  // one group a chunk, maybe empty\n" + "  " + s.format("4 + 4 * c")),
        ("    rr += KC;\n", "  " + s.format("5 + 4 * c") + "    rr += KC;\n"),
        ("  __syncthreads();  // every read of the chunks is done before mag overwrites them\n",
         "  __syncthreads();  // every read of the chunks is done before mag overwrites them\n"
         + s.format("2 + 4 * KS")),
        ("\n  // mel: the (row tile, mel tile) pairs",
         "\n" + s.format("3 + 4 * KS") + "  long long mel_cyc = 0, store_cyc = 0, m0 = 0, m1 = 0;"
         "\n  // mel: the (row tile, mel tile) pairs"),
        ("    const int n = nt * 8 + g;\n",
         "    const int n = nt * 8 + g;\n    if (tid == 0) m0 = clock64();\n"),
        ("#pragma unroll\n    for (int h = 0; h < 2; ++h) {\n      const int t = t0",
         "    if (tid == 0) {\n      m1 = clock64();\n      mel_cyc += m1 - m0;\n    }\n"
         "#pragma unroll\n    for (int h = 0; h < 2; ++h) {\n      const int t = t0"),
        ("        if (col < n_mels) orow[col] = logf(fmaxf(acc[2 * h + e], mel_floor));\n"
         "      }\n    }\n",
         "        if (col < n_mels) orow[col] = logf(fmaxf(acc[2 * h + e], mel_floor));\n"
         "      }\n    }\n    if (tid == 0) store_cyc += clock64() - m1;\n"),
    ]
    for old, new in edits:
        if head.count(old) != 1:
            raise RuntimeError(f"trace_k1: anchor not found once in csrc/mfsc.cu: {old!r}")
        head = head.replace(old, new)
    end = head.rindex("}\n\n// ----")
    head = (head[:end] + "  if (tid == 0) {\n    st[4 + 4 * KS] = mel_cyc;\n"
            "    st[5 + 4 * KS] = store_cyc;\n  }\n  __syncthreads();\n"
            + s.format("6 + 4 * KS") + head[end:])
    tail += ('\nextern "C" int w2l_k1_stamps(long long* host, int n) {\n'
             "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_k1_stamps,"
             " n * sizeof(long long)));\n}\n")
    return head + tail


def trace(lib, B: int, S: int, tt: int, frame=400, stride=160, n_bins=257, n_mels=80) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    pre = 0.5 * torch.randn((B, S), device="cuda", generator=g)
    cos_mat, sin_mat = (0.05 * torch.randn((frame, n_bins), device="cuda", generator=g)
                        for _ in range(2))
    mel_fb = torch.rand((n_bins, n_mels), device="cuda", generator=g)
    T = 1 + (S - frame) // stride
    out = torch.empty((B, T, n_mels), device="cuda")
    for _ in range(3):  # the last run's stamps are read
        rc = lib.w2l_mfsc_tc(pre.data_ptr(), cos_mat.data_ptr(), sin_mat.data_ptr(),
                             mel_fb.data_ptr(), out.data_ptr(), B, S, T, frame, stride, n_bins,
                             n_mels, 1.0, tt, 1, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "trace_k1")
    torch.cuda.synchronize()
    nb = -(-T // tt) * B
    st = np.zeros(nb * _STAMPS, np.int64)
    _build.check(lib.w2l_k1_stamps(st.ctypes.data, st.size), "trace_k1")
    st = st.reshape(nb, _STAMPS)
    ks = -(-frame // 8)
    total = st[:, 6 + 4 * ks] - st[:, 0]
    blk = int(np.argsort(total)[nb // 2])
    t = st[blk]
    steps = t[2:2 + 4 * ks].reshape(ks, 4)
    prev = np.concatenate([[t[1]], steps[:-1, 3]])
    dft = dict(wait=int((steps[:, 0] - prev).sum()), barrier=int((steps[:, 1] - steps[:, 0]).sum()),
               issue=int((steps[:, 2] - steps[:, 1]).sum()),
               products=int((steps[:, 3] - steps[:, 2]).sum()))
    mel, stores = int(t[4 + 4 * ks]), int(t[5 + 4 * ks])
    return dict(shape=[B, S, T], tile=tt, blocks=nb, steps=ks,
                block_cycles=dict(min=int(total.min()), median=int(np.median(total)),
                                  max=int(total.max())),
                median_block=dict(staging=int(t[1] - t[0]), dft=dft,
                                  drain=int(t[2 + 4 * ks] - steps[-1, 3]),
                                  magnitude=int(t[3 + 4 * ks] - t[2 + 4 * ks]), mel=mel,
                                  stores=stores,
                                  tail=int(t[6 + 4 * ks] - t[3 + 4 * ks]) - mel - stores))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the readings here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_k1: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    lib = build_traced(_instrument((_build.CSRC / "mfsc.cu").read_text()), "trace_k1",
                       "w2l_mfsc_tc", "w2l_k1_stamps")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for B, S in ((4, 246000), (16, 246000)):
        T = 1 + (S - 400) // 160
        for tt in (16, 32, 48):
            rows.append(dict(trace(lib, B, S, tt), picked=tt == tile_frames(B, T, sms)))
            print(json.dumps(rows[-1]), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, traces=rows), f, indent=1)


if __name__ == "__main__":
    main()
