"""Audio file loading (sox-free), copied from the JAX package.

WAV is decoded with scipy (any PCM/float encoding), ``.npy`` holds raw
float arrays, and FLAC decodes through the port's native decoder
(``ops/native/flac.cpp``), built with ``g++`` at first use.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def load_audio(path: str, expected_sr: int = 16000) -> np.ndarray:
    """Return float32 mono samples in [-1, 1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path).astype(np.float32)
        return arr.reshape(-1)
    if ext == ".wav":
        sr, data = _load_wav(path)
        if expected_sr and sr != expected_sr:
            raise ValueError(f"{path}: sample rate {sr} != expected {expected_sr}")
        return data
    if ext == ".flac":
        return _load_flac(path, expected_sr)
    raise ValueError(f"unsupported audio format: {path}")


def load_audio_with_sr(path: str) -> Tuple[int, np.ndarray]:
    """Like load_audio but returns (sample_rate, mono float32 samples)
    without asserting a rate (used by conversion tools)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return 16000, np.load(path).astype(np.float32).reshape(-1)
    if ext == ".wav":
        return _load_wav(path)
    if ext == ".flac":
        from ..ops.native import flac_decode

        return flac_decode(path)
    raise ValueError(f"unsupported audio format: {path}")


def _load_wav(path: str) -> Tuple[int, np.ndarray]:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return sr, np.ascontiguousarray(data, dtype=np.float32)


def _load_flac(path: str, expected_sr: int) -> np.ndarray:
    from ..ops.native import flac_decode

    sr, data = flac_decode(path)
    if expected_sr and sr != expected_sr:
        raise ValueError(f"{path}: sample rate {sr} != expected {expected_sr}")
    return data
