"""The native host core, built with ``g++`` at first use and bound with ctypes:

  * ``decoder.cpp``: ARPA, KenLM-probing and ``qt`` binary n-gram LMs, the
    lexicon trie, the CTC/ASG beam decoder with its online API and the
    seq2seq beam (``w2l_s2s_*``);
  * ``flac.cpp``: the FLAC audio decoder.

Both are copies of the JAX package's sources. Each builds into
``build/torch_native/lib<name>_<hash>.so`` at the repository root, never next
to the sources. The hash covers the source, the compiler command and the host
CPU's model name and flags (``-march=native`` code must not run on another
CPU), not mtimes, which a fresh checkout resets. Processes that build at once
serialize on a file lock, and the library is written under a temporary name
and moved into place, so no process loads a half-written file. A failed build
raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native"]

_lock = threading.Lock()
_libs = {}


def _host_cpu() -> str:
    """The host CPU's model name and its instruction-set flags: what
    ``-march=native`` compiles for (a model name alone can be generic)."""
    seen = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags") and key not in seen:
                    seen[key] = value.strip()
    except OSError:
        pass
    return " | ".join(seen.values()) or platform.processor() or platform.machine()


def library_path(name: str) -> Path:
    """Where the library of ``<name>.cpp`` lands for this source, compiler
    command and host CPU."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless a library for it is already built."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if so.exists():
            return so
        fd, tmp = tempfile.mkstemp(prefix=f".{so.stem}_", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [CXX, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", tmp]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise RuntimeError(f"building {name}.cpp failed: {' '.join(cmd)}: {e}") from e
        if r.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"building {name}.cpp failed (rc {r.returncode}): {' '.join(cmd)}\n"
                f"{r.stderr}")
        os.replace(tmp, so)
    return so


def load_lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]


def decoder_lib() -> ctypes.CDLL:
    lib = load_lib("decoder")
    c = ctypes
    lib.w2l_lm_load.restype = c.c_void_p
    lib.w2l_lm_load.argtypes = [c.c_char_p]
    lib.w2l_lm_free.argtypes = [c.c_void_p]
    lib.w2l_lm_word_id.restype = c.c_int
    lib.w2l_lm_word_id.argtypes = [c.c_void_p, c.c_char_p]
    lib.w2l_lm_unk_id.restype = c.c_int
    lib.w2l_lm_unk_id.argtypes = [c.c_void_p]
    lib.w2l_lm_score_seq.restype = c.c_float
    lib.w2l_lm_score_seq.argtypes = [c.c_void_p, c.POINTER(c.c_int32), c.c_int]
    lib.w2l_lm_used_mmap.restype = c.c_int
    lib.w2l_lm_used_mmap.argtypes = [c.c_void_p]
    lib.w2l_lm_build_binary.restype = c.c_int
    lib.w2l_lm_build_binary.argtypes = [c.c_char_p, c.c_char_p, c.c_float]
    lib.w2l_lm_build_trie.restype = c.c_int
    lib.w2l_lm_build_trie.argtypes = [c.c_char_p, c.c_char_p]
    lib.w2l_lm_order.restype = c.c_int
    lib.w2l_lm_order.argtypes = [c.c_void_p]
    lib.w2l_lm_score_hist.restype = c.c_float
    lib.w2l_lm_score_hist.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int, c.c_int32,
    ]
    lib.w2l_lm_bos_id.restype = c.c_int
    lib.w2l_lm_bos_id.argtypes = [c.c_void_p]
    lib.w2l_lm_eos_id.restype = c.c_int
    lib.w2l_lm_eos_id.argtypes = [c.c_void_p]
    lib.w2l_trie_new.restype = c.c_void_p
    lib.w2l_trie_free.argtypes = [c.c_void_p]
    lib.w2l_trie_insert.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int, c.c_int, c.c_float,
    ]
    lib.w2l_trie_smear.argtypes = [c.c_void_p, c.c_int]
    lib.w2l_decoder_new.restype = c.c_void_p
    lib.w2l_decoder_new.argtypes = [
        c.c_int, c.c_int, c.c_double, c.c_double, c.c_double, c.c_double,
        c.c_double, c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_int,
        c.c_int, c.c_int, c.POINTER(c.c_float), c.c_int,
        c.POINTER(c.c_int32), c.c_int, c.c_int,
    ]
    lib.w2l_decoder_free.argtypes = [c.c_void_p]
    lib.w2l_decoder_begin.argtypes = [c.c_void_p]
    lib.w2l_decoder_step.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int, c.c_int]
    lib.w2l_decoder_end.argtypes = [c.c_void_p]
    lib.w2l_decoder_nhyps.restype = c.c_int
    lib.w2l_decoder_nhyps.argtypes = [c.c_void_p]
    lib.w2l_decoder_result.restype = c.c_int
    lib.w2l_decoder_result.argtypes = [
        c.c_void_p, c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int, c.POINTER(c.c_double),
    ]
    lib.w2l_decoder_prune.argtypes = [c.c_void_p, c.c_int]
    lib.w2l_decoder_best_lookback.restype = c.c_int
    lib.w2l_decoder_best_lookback.argtypes = [
        c.c_void_p, c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int, c.POINTER(c.c_double),
    ]
    lib.w2l_lm_new_external.restype = c.c_void_p
    lib.w2l_lm_new_external.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int]
    lib.w2l_decoder_step_collect.restype = c.c_int
    lib.w2l_decoder_step_collect.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int,
    ]
    lib.w2l_decoder_reqs_export.restype = c.c_int
    lib.w2l_decoder_reqs_export.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.c_int,
    ]
    lib.w2l_decoder_step_apply.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.w2l_decoder_end_collect.restype = c.c_int
    lib.w2l_decoder_end_collect.argtypes = [c.c_void_p]
    lib.w2l_decoder_end_apply.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    # the seq2seq beam (S2SDecoder): one step a call on the (K, V) log-probs
    # the decoder step computed, as the JAX loader binds it
    lib.w2l_s2s_step_collect.restype = c.c_int
    lib.w2l_s2s_step_collect.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.POINTER(c.c_int32), c.c_int, c.c_int,
    ]
    lib.w2l_s2s_reqs_export.restype = c.c_int
    lib.w2l_s2s_reqs_export.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.c_int,
    ]
    lib.w2l_s2s_step_apply.restype = c.c_int
    lib.w2l_s2s_step_apply.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    lib.w2l_s2s_end_collect.restype = c.c_int
    lib.w2l_s2s_end_collect.argtypes = [c.c_void_p]
    lib.w2l_s2s_end_apply.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.w2l_s2s_new.restype = c.c_void_p
    lib.w2l_s2s_new.argtypes = [
        c.c_int, c.c_int, c.c_double, c.c_double, c.c_double, c.c_double,
        c.c_double, c.c_double, c.c_double, c.c_void_p, c.c_void_p,
        c.c_int, c.c_int, c.POINTER(c.c_int32), c.c_int,
    ]
    lib.w2l_s2s_free.argtypes = [c.c_void_p]
    lib.w2l_s2s_begin.argtypes = [c.c_void_p]
    lib.w2l_s2s_step.restype = c.c_int
    lib.w2l_s2s_step.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.POINTER(c.c_int32), c.c_int,
        c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    lib.w2l_s2s_end.argtypes = [c.c_void_p]
    lib.w2l_s2s_nhyps.restype = c.c_int
    lib.w2l_s2s_nhyps.argtypes = [c.c_void_p]
    lib.w2l_s2s_result.restype = c.c_int
    lib.w2l_s2s_result.argtypes = [
        c.c_void_p, c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int, c.POINTER(c.c_double), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
    ]
    return lib


def flac_lib() -> ctypes.CDLL:
    lib = load_lib("flac")
    c = ctypes
    lib.w2l_flac_read.restype = c.c_void_p
    lib.w2l_flac_read.argtypes = [
        c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int), c.POINTER(c.c_int),
    ]
    lib.w2l_flac_copy_free.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64]
    return lib


def flac_decode(path: str):
    """Decode a FLAC file -> (sample_rate, float32 mono samples)."""
    import numpy as np

    lib = flac_lib()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    handle = lib.w2l_flac_read(path.encode(), ctypes.byref(n),
                               ctypes.byref(sr), ctypes.byref(ch))
    if not handle:
        raise ValueError(f"flac decode failed: {path}")
    out = np.empty(n.value, np.float32)
    lib.w2l_flac_copy_free(
        handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n.value
    )
    if ch.value > 1:
        out = out.reshape(-1, ch.value).mean(axis=1)
    return sr.value, np.ascontiguousarray(out, np.float32)
