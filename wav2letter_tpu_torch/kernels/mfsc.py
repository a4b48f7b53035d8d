"""K1: the MFSC core (framing, windowed |DFT|, mel, log) — wrapper, plain
version and the layout of the kernel's two routes. The kernels are in
``csrc/mfsc.cu``; they replace the TPU kernel
``wav2letter_tpu/ops/pallas/mel.py::pallas_mfsc``.

The tensor-core route (3xTF32 ``mma.sync`` tiles) takes a stride that is a
multiple of 8, up to 320 bins and cos/sin matrices that start 16-byte
aligned; the CUDA-core route takes any stride up to 288 bins. ``route``
picks one (C twin ``w2l_mfsc_tc_takes``); a shape neither takes raises.
"""

from __future__ import annotations

import torch

from . import _build

TENSOR_CORES, CUDA_CORES = "tensor cores", "CUDA cores"
TC_TILES = (48, 32, 16)  # frames a tensor-core block, the larger first
TC_MAX_BINS = 320    # 8 warps x 5 tiles of 8 bins
CC_MAX_BINS = 288    # 32 lanes x 9 bins
_TC_NBUF, _TC_KC = 4, 8  # chunk buffers, cos/sin rows a chunk
# A block's fixed cost (streaming and splitting all of cos and sin) in frames'
# worth of its time, from the block traces of kernels/trace_k1.py
TILE_FIXED_FRAMES = 40


def _odd_units(n: int) -> int:
    """n floats rounded up to an odd number of 16-byte units, in floats."""
    return 4 * ((-(-n // 4)) | 1)


def tc_smem_bytes(tt: int, frame: int, stride: int, n_bins: int) -> int:
    """Shared memory of a tensor-core block of ``tt`` frames (C twin
    ``w2l_mfsc_tc_smem_bytes``): the audio span as rows of ``stride``
    samples at an odd number of 16-byte units, then four chunk buffers of 8
    cos and 8 sin rows (pitch 4 mod 16 floats), which the magnitudes reuse."""
    kf = -(-frame // 8) * 8
    rows_a = tt + (kf - 1) // stride
    np_ = -(-n_bins // 8) * 8
    units = (n_bins + 9) // 4
    need = max(4 * units, np_ + 3)
    pb = (need - 4 + 15) // 16 * 16 + 4
    stage = _TC_NBUF * _TC_KC * 2 * pb
    mag = tt * _odd_units(np_)
    return 4 * (rows_a * _odd_units(stride) + max(stage, mag))


def tc_takes(frame: int, stride: int, n_bins: int, n_mels: int) -> bool:
    """Whether the tensor-core route takes the shape (C twin
    ``w2l_mfsc_tc_takes``): an 8-deep step of the DFT must not cross a row of
    staged audio, so the stride is a multiple of 8."""
    return (frame > 0 and stride > 0 and stride % 8 == 0 and 0 < n_bins <= TC_MAX_BINS
            and n_mels > 0
            and tc_smem_bytes(TC_TILES[0], frame, stride, n_bins) <= _build.MAX_SMEM_BYTES)


def route(frame: int, stride: int, n_bins: int, n_mels: int, aligned: bool = True) -> str:
    """Where K1 runs a shape: the tensor cores where ``tc_takes`` and the
    cos/sin matrices start 16-byte aligned (``aligned``), else the CUDA cores."""
    return TENSOR_CORES if aligned and tc_takes(frame, stride, n_bins, n_mels) else CUDA_CORES


def tile_frames(B: int, T: int, sms: int = 132) -> int:
    """Frames a tensor-core block (C twin ``w2l_mfsc_tile_frames``): of 48,
    32 and 16, the tile that gives the busiest SM the least work, that SM's
    blocks ceil(blocks / sms) times a block's cost, which is its frames plus
    ``TILE_FIXED_FRAMES`` (every block streams all of cos and sin and splits
    them for the tensor cores, whatever its tile); the larger on a tie."""
    best, best_load = TC_TILES[0], None
    for tt in TC_TILES:
        blocks = B * -(-T // tt)
        load = -(-blocks // sms) * (tt + TILE_FIXED_FRAMES)
        if best_load is None or load < best_load:
            best, best_load = tt, load
    return best


def dense_flops(B: int, T: int, frame: int, n_bins: int, n_mels: int) -> int:
    """Operations of the kernel's two dense products at the tensor cores'
    shapes (bins and depth padded to 8), three TF32 passes each."""
    kf, np_, nm = -(-frame // 8) * 8, -(-n_bins // 8) * 8, -(-n_mels // 8) * 8
    return 3 * 2 * B * T * (kf * 2 * np_ + np_ * nm)


def mfsc_plain(pre: torch.Tensor, cos_mat: torch.Tensor, sin_mat: torch.Tensor,
               mel_fb: torch.Tensor, frame: int, stride: int,
               mel_floor: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`mfsc`, the same function in fp32."""
    _build.disable_tf32()
    if pre.shape[-1] < frame:
        return pre.new_zeros(pre.shape[:-1] + (0, mel_fb.shape[1]), dtype=torch.float32)
    frames = pre.float().unfold(-1, frame, stride)  # (B, T, frame)
    re = frames @ cos_mat
    im = frames @ sin_mat
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-20))
    return torch.log(torch.clamp(mag @ mel_fb, min=mel_floor))


def mfsc(pre: torch.Tensor, cos_mat: torch.Tensor, sin_mat: torch.Tensor,
         mel_fb: torch.Tensor, frame: int, stride: int,
         mel_floor: float) -> torch.Tensor:
    """Log mel filterbank energies of pre-emphasized audio.

    pre (B, S) float32; cos_mat/sin_mat (frame, n_bins) with the window
    folded in; mel_fb (n_bins, n_mels). Returns (B, T, n_mels) float32 with
    T = 1 + (S - frame) // stride (0 when S < frame): frame t starts at
    sample t * stride. On the card :func:`route` picks the kernel; a shape
    neither route takes raises.
    """
    if pre.device.type == "cpu":
        return mfsc_plain(pre, cos_mat, sin_mat, mel_fb, frame, stride, mel_floor)
    _build.require_cuda("mfsc", pre, cos_mat, sin_mat, mel_fb)
    for name, t in (("pre", pre), ("cos_mat", cos_mat), ("sin_mat", sin_mat),
                    ("mel_fb", mel_fb)):
        if t.dtype != torch.float32:
            raise TypeError(f"mfsc: {name} must be float32, got {t.dtype}")
    if pre.dim() != 2:
        raise ValueError(f"mfsc: pre must be (B, S), got {tuple(pre.shape)}")
    B, S = pre.shape
    n_bins, n_mels = mel_fb.shape
    if cos_mat.shape != (frame, n_bins) or sin_mat.shape != (frame, n_bins):
        raise ValueError(
            f"mfsc: cos/sin must be ({frame}, {n_bins}), got "
            f"{tuple(cos_mat.shape)} and {tuple(sin_mat.shape)}")
    aligned = cos_mat.data_ptr() % 16 == 0 and sin_mat.data_ptr() % 16 == 0
    way = route(frame, stride, n_bins, n_mels, aligned)
    if way == CUDA_CORES and n_bins > CC_MAX_BINS:
        raise ValueError(f"mfsc: {n_bins} bins exceed the CUDA-core kernel's {CC_MAX_BINS}")
    T = 1 + (S - frame) // stride if S >= frame else 0
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=pre.device)
    if B == 0 or T == 0:
        return out
    lib = _build.library()
    ptrs = (pre.data_ptr(), cos_mat.data_ptr(), sin_mat.data_ptr(), mel_fb.data_ptr(),
            out.data_ptr())
    dims = (B, S, T, frame, stride, n_bins, n_mels, float(mel_floor))
    if way == TENSOR_CORES:
        vec = int(pre.data_ptr() % 16 == 0 and S % 4 == 0)
        rc = lib.w2l_mfsc_tc(*ptrs, *dims, tile_frames(B, T, _build.sm_count(pre.device)),
                             vec, _build.stream_ptr(pre))
    else:
        rc = lib.w2l_mfsc_cc(*ptrs, *dims, _build.stream_ptr(pre))
    _build.check(rc, "mfsc")
    _build.LAUNCHES["mfsc"] += 1
    return out
