"""Build the CUDA sources in ``csrc/`` into one shared library and load it.

The library has a plain C interface and is bound with ``ctypes``: every
pointer and the stream go in as ``c_void_p``, and every entry point returns
``cudaGetLastError()`` after its launch. Each ``.cu`` file is compiled by its
own ``nvcc`` process, all started together, and the objects are linked into
``build/torch_kernels/libw2l_kernels_<hash>.so`` at the repository root. The
hash covers the sources, the headers they share (``*.cuh``: ``common.cuh``,
``mma.cuh``, ``tc_tile.cuh``, ``tf32_tile.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged tree is loaded as built.
Processes that build at once (the ranks of a node) serialize on a file lock,
so one compiles and the others load its library.

Nothing here runs at import: the first wrapper that launches a kernel calls
``library()``, which builds on first use.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh

MAX_SMEM_BYTES = 232448  # dynamic shared memory one block can get on sm_90

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
SIGNATURES = {
    "w2l_mfsc_cc": [_P] * 5 + [_I] * 7 + [_F, _P],
    "w2l_mfsc_tc": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
    "w2l_mfsc_cc_max_bins": [],
    "w2l_mfsc_tc_smem_bytes": [_I, _I, _I, _I],
    "w2l_mfsc_tc_takes": [_I] * 5,
    "w2l_mfsc_tile_frames": [_I, _I, _I],
    "w2l_time_conv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    "w2l_time_conv_tile": [],
    "w2l_time_conv_tc": [_P, _P, _P, _P] + [_I] * 13 + [_P],
    "w2l_time_conv_tc_smem_bytes": [_I, _I, _I, _I],
    "w2l_time_conv_tf32": [_P, _P, _P, _P] + [_I] * 16 + [_P],
    "w2l_time_conv_tf32_smem_bytes": [_I] * 7,
    "w2l_time_conv_tf32_plan": [_I] * 8 + [_P],
    "w2l_time_conv_wgrad_tf32": [_P, _P, _P, _P] + [_I] * 12 + [_P],
    "w2l_time_conv_wgrad_tf32_smem_bytes": [_I, _I, _I, _I],
    "w2l_time_conv_wgrad_tc": [_P, _P, _P, _P] + [_I] * 12 + [_P],
    "w2l_time_conv_wgrad_tc_smem_bytes": [_I, _I, _I, _I],
    "w2l_time_conv_wgrad_tc_reps": [_I, _I],
    "w2l_time_conv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    "w2l_time_conv_wgrad_tile": [],
    "w2l_time_conv_wide": [_P] * 4 + [_I] * 12 + [_P],
    "w2l_time_conv_wide_smem_bytes": [_I] * 7,
    "w2l_time_conv_wide_takes": [_I] * 7,
    "w2l_time_conv_wide_plan": [_I] * 10 + [_P],
    "w2l_time_conv_wgrad_wide": [_P] * 4 + [_I] * 11 + [_P],
    "w2l_time_conv_wgrad_window": [_I, _I, _I, _I],
    "w2l_residual_ln": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
    "w2l_residual_ln_warps": [_I, _I],
    "w2l_residual_ln_bwd": [_P] * 9 + [_I] * 4 + [_P],
    "w2l_mhsa_fwd": [_P] * 6 + [_I] * 7 + [_F, _U, _F, _I, _P],
    "w2l_mhsa_bwd": [_P] * 13 + [_I] * 7 + [_F, _U, _F, _I, _I, _P],
    "w2l_mhsa_fwd_smem_bytes": [_I, _I, _I, _I],
    "w2l_mhsa_bwd_smem_bytes": [_I, _I, _I, _I],
    "w2l_mhsa_max_head_dim": [_I, _I],
    "w2l_ctc_fwd": [_P] * 10 + [_I] * 6 + [_P],
    "w2l_ctc_bwd": [_P] * 13 + [_I] * 6 + [_P],
    "w2l_ctc_betas": [_P] * 7 + [_I] * 5 + [_P],
    "w2l_ctc_route": [_I],
    "w2l_ctc_ring_depth": [],
    "w2l_ctc_block_threads": [_I],
    "w2l_ctc_work_bytes": [_I],
    "w2l_ctc_work_in_smem": [_I, _I],
}

# Launches per kernel since the last reset. A wrapper adds one where it
# launches its kernel and nowhere else; its plain version never counts.
LAUNCHES = {"mfsc": 0, "time_conv": 0, "time_conv_wgrad": 0, "residual_ln": 0,
            "residual_ln_bwd": 0, "mhsa": 0, "mhsa_bwd": 0, "ctc": 0, "ctc_bwd": 0}

_lib = None
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (one nvcc each, in parallel) and link the library.
    Returns its path; the compiler's output is kept in ``build.log``."""
    lib = BUILD_DIR / f"libw2l_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if not lib.exists():
            _compile(lib)
    return lib


def _compile(lib: Path) -> None:
    sources = sorted(CSRC.glob("*.cu"))
    work = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    cc = nvcc()
    procs = []
    for src in sources:
        obj = work / (src.stem + ".o")
        cmd = [cc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [cc, "-shared", "-o", str(work / lib.name),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"building the CUDA kernels failed ({', '.join(failed)}):\n"
            + "\n".join(log))
    os.replace(work / lib.name, lib)
    shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def disable_tf32() -> None:
    """Full fp32 products and convolutions, as the JAX reference computes
    them: TF32 keeps ~3 digits, and error that depends on the shape has
    broken streaming before."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check(rc: int, name: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card (the kernels size their grids)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Wrappers take CPU tensors to the plain version and CUDA tensors to the
    kernel; anything else, or a mix of devices, is refused."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
