"""Where the tensor-core and wide K2 and K2b spend a block's cycles: a
clock64 trace of their tile loop, in bf16 and in fp32 (3xTF32), and of the
wide route at CPC's first conv.

    python -m wav2letter_tpu_torch.kernels.trace_k2 [--out FILE] [--wide]

Needs a card and ``nvcc``. Builds copies of ``csrc/tconv.cu`` and
``csrc/tconv_wgrad.cu`` with ``clock64()`` stamps added by thread 0 of each
block (the kernels themselves are unchanged: the bf16 kernels' stamps go in
at fixed anchors, the fp32 kernels' through their ``W2L_STAMP`` points,
empty in the port's build), runs K2 forward, K2 as dgrad and K2b at
flagship shapes, fp32 also at the stream's batch-1 windows, and prints for
the median block the SM cycles of:

- ``setup``: the weight (and, bf16, the zeroed ring and the copy table), and
  issuing the first window's cp.async;
- ``issue``: issuing the next tile's cp.async (summed over the tiles); fp32
  with split taps: the block barrier after the zeroed channel pads;
- ``wait``: cp.async.wait_group for the tile in use (fp32, first tile: and
  splitting the weight into its TF32 halves);
- ``barrier``: the barrier after it;
- ``compute``: the products and the epilogue, with the closing barrier
  (fp32 with split taps: and the ordered sum of the splits).

The wide kernels (``--wide`` traces only them, at CPC's first conv) stamp,
for the median block, ``setup`` (the barriers, the first window's bulk copy
issued, the weights into registers), ``wait`` (the tile's bulk copy landing:
the load step), ``compute`` (the products, and K2's 16-byte stores) and, in
K2, ``barrier`` (the block barrier after a tile). K2b's stamps are its first
consumer thread's; its producer warp is not stamped.

Nothing of the port imports this module.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import _build
from .tconv import (TC_TT, TF32_WG_TT, out_frames, tc_granule, tc_schedule, tc_smem_bytes,
                    tc_wgrad_smem_bytes, tc_wgrad_units, tf32_granule, tf32_plan,
                    tf32_wgrad_schedule, wide_plan)

_STAMPS = 256  # per block: 2 + 4 per tile
_LOOP = ("    cp_async_commit();\n    cp_async_wait<1>();\n    __syncthreads();\n")
_CLOSE = "    __syncthreads();  // the ring slots this tile read are free for the next copies\n"
# the first window's copies issued, up to the end of a line
_PROLOGUE_K2 = "  cp_async_commit();\n\n  // per-lane parts of the ldmatrix addresses (bytes)\n"
_PROLOGUE_K2B = "  cp_async_commit();\n\n  const int mat = lane >> 3, li = lane & 7;\n"


def _instrument(src: str, prologue: str, sym: str) -> str:
    """One kernel source with the stamps; every anchor must be found once."""
    start = src.index("// bf16 on the tensor cores")
    head, tail = src[:start], src[start:]
    stamp = "    if (threadIdx.x == 0) st[{}] = clock64();\n"
    edits = [
        ("  extern __shared__ __align__(16) unsigned char tc_smem[];\n",
         "  extern __shared__ __align__(16) unsigned char tc_smem[];\n"
         f"  long long* st = {sym} + (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *"
         f" blockIdx.z)) * {_STAMPS};\n"
         "  if (threadIdx.x == 0) st[0] = clock64();\n"),
        (prologue, prologue + "  if (threadIdx.x == 0) st[1] = clock64();\n"),
        (_LOOP, "    cp_async_commit();\n" + stamp.format("2 + 4 * it")
         + "    cp_async_wait<1>();\n" + stamp.format("3 + 4 * it")
         + "    __syncthreads();\n" + stamp.format("4 + 4 * it")),
        (_CLOSE, _CLOSE + stamp.format("5 + 4 * it")),
    ]
    for old, new in edits:
        if tail.count(old) != 1:
            raise RuntimeError(f"trace_k2: anchor not found once: {old!r}")
        tail = tail.replace(old, new)
    head = head.replace('#include "tc_tile.cuh"\n',
                        f'#include "tc_tile.cuh"\n__device__ long long {sym}[1 << 20];\n', 1)
    return head + tail + _reader(sym)


def _reader(sym: str) -> str:
    return (f'\nextern "C" int {sym}_read(long long* host, int n) {{\n'
            f"  return static_cast<int>(cudaMemcpyFromSymbol(host, {sym},"
            " n * sizeof(long long)));\n}\n")


def _stamped_wide(src: str, sym: str) -> str:
    """``csrc/tconv_wide.cu`` with its ``W2L_STAMP`` points stamping into
    ``sym``, declared and read here."""
    src = src.replace('#include "common.cuh"\n',
                      f'#include "common.cuh"\n__device__ long long {sym}[1 << 20];\n', 1)
    return _stamp_points(src, sym) + _reader(sym)


def _stamp_points(src: str, sym: str) -> str:
    """The fp32 kernels' ``W2L_STAMP(i)`` points as stamps of thread 0 into
    ``sym`` (which ``_instrument`` declares), ``_STAMPS`` a block."""
    return (f"#define W2L_STAMP(i) if (threadIdx.x == 0) {sym}[(blockIdx.x + gridDim.x * "
            f"(blockIdx.y + gridDim.y * blockIdx.z)) * {_STAMPS} + (i)] = clock64();\n" + src)


def _build_traced() -> ctypes.CDLL:
    work = _build.BUILD_DIR / "trace_k2"
    work.mkdir(parents=True, exist_ok=True)
    srcs = []
    for name, prologue, sym in (
            ("tconv.cu", _PROLOGUE_K2, "g_k2_stamps"),
            ("tconv_wgrad.cu", _PROLOGUE_K2B, "g_k2b_stamps")):
        src = work / name.replace(".cu", "_traced.cu")
        src.write_text(_stamp_points(
            _instrument((_build.CSRC / name).read_text(), prologue, sym), sym))
        srcs.append(str(src))
    src = work / "tconv_wide_traced.cu"
    src.write_text(_stamped_wide((_build.CSRC / "tconv_wide.cu").read_text(), "g_k2w_stamps"))
    srcs.append(str(src))
    lib = work / "libk2trace.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    res = subprocess.run([_build.nvcc(), *flags, "-shared", f"-I{_build.CSRC}", *srcs, "-o",
                          str(lib)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"trace_k2: nvcc failed:\n{res.stdout}\n{res.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for name in ("w2l_time_conv_tc", "w2l_time_conv_wgrad_tc", "w2l_time_conv_tf32",
                 "w2l_time_conv_wgrad_tf32", "w2l_time_conv_wide", "w2l_time_conv_wgrad_wide"):
        getattr(cdll, name).argtypes = _build.SIGNATURES[name]
        getattr(cdll, name).restype = ctypes.c_int
    for name in ("g_k2_stamps_read", "g_k2b_stamps_read", "g_k2w_stamps_read"):
        getattr(cdll, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    return cdll


def _median_block(st: np.ndarray, ntiles: np.ndarray) -> dict:
    total = np.array([row[5 + 4 * (n - 1)] - row[0] for row, n in zip(st, ntiles)])
    blk = int(np.argsort(total)[len(total) // 2])
    row, n = st[blk], int(ntiles[blk])
    out = dict(setup=int(row[1] - row[0]), issue=0, wait=0, barrier=0, compute=0, tiles=n)
    prev = row[1]
    for it in range(n):
        t = row[2 + 4 * it: 6 + 4 * it]
        out["issue"] += int(t[0] - prev)
        out["wait"] += int(t[1] - t[0])
        out["barrier"] += int(t[2] - t[1])
        out["compute"] += int(t[3] - t[2])
        prev = t[3]
    return dict(block_cycles=dict(min=int(total.min()), median=int(np.median(total)),
                                  max=int(total.max())), median_block=out)


def trace(lib, dtype: str, kind: str, B, T, F, C, CO, K, stride, pads) -> dict:
    """One call of K2 (``kind`` "conv" or "dgrad") or K2b ("wgrad") at the
    conv's shape in ``dtype`` on the tensor cores; the schedule as the
    wrapper picks it."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    fp32 = dt == torch.float32
    Tout = out_frames(T, K, stride, pads)
    x = torch.randn((B, T, F * C), device="cuda", generator=g).to(dt)
    w = (0.1 * torch.randn((K, C, CO), device="cuda", generator=g)).to(dt)
    dy = torch.randn((B, Tout, F * CO), device="cuda", generator=g).to(dt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    plan = {}
    if kind == "wgrad":
        To = Tout
        if fp32:
            tt, (ch, nb) = TF32_WG_TT, tf32_wgrad_schedule(B, To, F, C, CO, K, stride, sms)
        else:
            tt, (ch, nb) = TC_TT, tc_schedule(B, To, F, tc_wgrad_smem_bytes(C, CO, K, stride),
                                              sms)
        partial = torch.empty((nb * tc_wgrad_units(C, K)[1], K * C * CO), device="cuda")
        dw = torch.empty((K, C, CO), device="cuda")
        entry = lib.w2l_time_conv_wgrad_tf32 if fp32 else lib.w2l_time_conv_wgrad_tc
        gran = (tf32_granule(C, F), tf32_granule(CO, F, False)) if fp32 else (
            tc_granule(C, F), tc_granule(CO, F))

        def run():
            return entry(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(), B, T, F,
                         C, CO, K, stride, pads[0], Tout, ch, *gran, stream)
        read = lib.g_k2b_stamps_read
    else:
        if kind == "dgrad":  # the conv from CO to C at stride 1 over dy dilated by stride
            src, wt, Ti, To, s, lp, dil = (dy, w.flip(0).transpose(1, 2).contiguous(), Tout,
                                           T, 1, K - 1 - pads[0], stride)
            Ci, Co = CO, C
        else:
            src, wt, Ti, To, s, lp, dil, Ci, Co = x, w, T, Tout, stride, pads[0], 1, C, CO
        y = torch.empty((B, To, F * Co), device="cuda", dtype=dt)
        if fp32:
            mw, mt, ks, ch, nb = tf32_plan(B, To, F, Ci, Co, K, s, sms)
            tt = mw * mt
            plan = dict(warps=mw * ks, frames_a_warp=mt, tap_splits=ks)

            def run():
                return lib.w2l_time_conv_tf32(src.data_ptr(), wt.data_ptr(), None, y.data_ptr(),
                                              B, Ti, F, Ci, Co, K, s, lp, To, 0, dil, mw, mt, ks,
                                              ch, tf32_granule(Ci, F), stream)
        else:
            tt, (ch, nb) = TC_TT, tc_schedule(B, To, F, tc_smem_bytes(Ci, Co, K, s), sms)

            def run():
                return lib.w2l_time_conv_tc(src.data_ptr(), wt.data_ptr(), None, y.data_ptr(),
                                            B, Ti, F, Ci, Co, K, s, lp, To, 0, dil, ch,
                                            tc_granule(Ci, F), stream)
        read = lib.g_k2_stamps_read
    for _ in range(3):  # the last run's stamps are read
        _build.check(run(), "trace_k2")
    torch.cuda.synchronize()
    st = np.zeros(nb * _STAMPS, np.int64)
    _build.check(read(st.ctypes.data, st.size), "trace_k2")
    st = st.reshape(nb, _STAMPS)
    n_t = -(-To // tt)
    runs = -(-n_t // ch)
    ntiles = np.array([min(ch, n_t - (i % runs) * ch) for i in range(nb)])
    return dict(dtype=dtype, kind=kind, shape=[B, T, F, C, CO, K, stride, list(pads)],
                frames_a_tile=tt, tiles_per_block=ch, blocks=nb, **plan,
                **_median_block(st, ntiles))


# stamps of the wide kernels: K2 three a tile (84 tiles at most), K2b two a
# stage (126 at most), after the two of the set-up
WIDE_STAMPED = {"conv": (3, 84), "wgrad": (2, 126)}


def _median_wide(st: np.ndarray, ntiles: np.ndarray, kind: str) -> dict:
    """The median block's cycles by step, from the wide kernels' stamps."""
    per, cap = WIDE_STAMPED[kind]
    n = np.minimum(ntiles, cap)
    total = np.array([row[1 + per * k] - row[0] for row, k in zip(st, n)])
    blk = int(np.argsort(total)[len(total) // 2])
    row, k = st[blk], int(n[blk])
    out = dict(setup=int(row[1] - row[0]), wait=0, compute=0, tiles=k)
    if per == 3:
        out["barrier"] = 0
    prev = row[1]
    for it in range(k):
        t = row[2 + per * it: 2 + per * (it + 1)]
        out["wait"] += int(t[0] - prev)
        out["compute"] += int(t[1] - t[0])
        if per == 3:
            out["barrier"] += int(t[2] - t[1])
        prev = t[-1]
    return dict(block_cycles=dict(min=int(total.min()), median=int(np.median(total)),
                                  max=int(total.max())), median_block=out)


def trace_wide(lib, dtype: str, kind: str, B, T, F, C, CO, K, stride, pads) -> dict:
    """One call of the wide K2 (``kind`` "conv") or K2b ("wgrad") at the
    conv's shape, the plan as the wrapper picks it."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    Tout = out_frames(T, K, stride, pads)
    x = torch.randn((B, T, F * C), device="cuda", generator=g).to(dt)
    w = (0.1 * torch.randn((K, C, CO), device="cuda", generator=g)).to(dt)
    dy = torch.randn((B, Tout, F * CO), device="cuda", generator=g).to(dt)
    bias = torch.randn((CO,), device="cuda", generator=g)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    code = _build.DTYPE_CODES[dt]
    tt, ch, nb = wide_plan(B, Tout, F, C, CO, K, stride, x.element_size(), sms, kind)
    if kind == "wgrad":
        partial = torch.empty((nb, K * C * CO), device="cuda")
        dw = torch.empty((K, C, CO), device="cuda")

        def run():
            return lib.w2l_time_conv_wgrad_wide(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                                                dw.data_ptr(), code, B, T, F, C, CO, K, stride,
                                                pads[0], Tout, ch, stream)
    else:
        y = torch.empty((B, Tout, F * CO), device="cuda", dtype=dt)

        def run():
            return lib.w2l_time_conv_wide(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                          y.data_ptr(), code, B, T, F, C, CO, K, stride, pads[0],
                                          Tout, 1, ch, stream)
    for _ in range(3):  # the last run's stamps are read
        _build.check(run(), "trace_k2")
    torch.cuda.synchronize()
    st = np.zeros(nb * _STAMPS, np.int64)
    _build.check(lib.g_k2w_stamps_read(st.ctypes.data, st.size), "trace_k2")
    st = st.reshape(nb, _STAMPS)
    tiles = B * -(-Tout // tt)
    ntiles = np.array([min(ch, tiles - i * ch) for i in range(nb)])
    return dict(dtype=dtype, kind=kind, route="wide",
                shape=[B, T, F, C, CO, K, stride, list(pads)], frames_a_tile=tt,
                tiles_per_block=ch, blocks=nb, **_median_wide(st, ntiles, kind))


# CPC's first conv (B = 8 rows of 125,000 samples), K2 and K2b
WIDE_SHAPES = [("float32", "conv", 8, 125000, 1, 1, 512, 10, 5, (3, 3)),
               ("float32", "wgrad", 8, 125000, 1, 1, 512, 10, 5, (3, 3))]


# (dtype, kind, B, T, F, C, CO, K, stride, pads): a serving TDS conv of the
# flagship, its strided C2, the last TDS conv, the dgrad and K2b of
# training's largest shapes; fp32 also at the stream's first and last TDS
# conv (B = 1 windows of a steady chunk, split taps)
SHAPES = [("bfloat16", "conv", 4, 768, 80, 16, 16, 9, 1, (7, 1)),
          ("bfloat16", "conv", 4, 768, 80, 16, 20, 11, 2, (8, 2)),
          ("bfloat16", "conv", 4, 192, 80, 28, 28, 11, 1, (10, 0)),
          ("bfloat16", "dgrad", 16, 768, 80, 16, 16, 9, 1, (7, 1)),
          ("bfloat16", "dgrad", 16, 768, 80, 16, 20, 11, 2, (8, 2)),
          ("bfloat16", "wgrad", 16, 768, 80, 16, 16, 9, 1, (7, 1)),
          ("bfloat16", "wgrad", 16, 192, 80, 28, 28, 11, 1, (10, 0)),
          ("float32", "conv", 4, 768, 80, 16, 16, 9, 1, (7, 1)),
          ("float32", "conv", 4, 192, 80, 28, 28, 11, 1, (10, 0)),
          ("float32", "dgrad", 16, 768, 80, 16, 20, 11, 2, (8, 2)),
          ("float32", "wgrad", 16, 768, 80, 16, 16, 9, 1, (7, 1)),
          ("float32", "wgrad", 16, 192, 80, 28, 28, 11, 1, (10, 0)),
          ("float32", "conv", 1, 33, 80, 16, 16, 9, 1, (0, 0)),
          ("float32", "conv", 1, 16, 80, 28, 28, 11, 1, (0, 0))]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the readings here as JSON")
    ap.add_argument("--wide", action="store_true", help="only the wide kernels at CPC's conv")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_k2: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    lib = _build_traced()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rows = []
    for shape in [] if args.wide else SHAPES:
        rows.append(trace(lib, *shape))
        print(json.dumps(rows[-1]), flush=True)
    for shape in WIDE_SHAPES:
        rows.append(trace_wide(lib, *shape))
        print(json.dumps(rows[-1]), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, traces=rows), f, indent=1)


if __name__ == "__main__":
    main()
