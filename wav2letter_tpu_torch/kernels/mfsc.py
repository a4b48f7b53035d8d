"""K1: the MFSC core (framing, windowed |DFT|, mel, log) — wrapper and plain
version. The kernel is ``csrc/mfsc.cu``; it replaces the TPU kernel
``wav2letter_tpu/ops/pallas/mel.py::pallas_mfsc``."""

from __future__ import annotations

import torch

from . import _build


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
    sample t * stride.
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
    lib = _build.library()
    if n_bins > lib.w2l_mfsc_max_bins():
        raise ValueError(
            f"mfsc: {n_bins} bins exceed the kernel's {lib.w2l_mfsc_max_bins()}")
    T = 1 + (S - frame) // stride if S >= frame else 0
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=pre.device)
    if B == 0 or T == 0:
        return out
    rc = lib.w2l_mfsc(pre.data_ptr(), cos_mat.data_ptr(), sin_mat.data_ptr(),
                      mel_fb.data_ptr(), out.data_ptr(), B, S, T, frame, stride,
                      n_bins, n_mels, float(mel_floor), _build.stream_ptr(pre))
    _build.check(rc, "mfsc")
    _build.LAUNCHES["mfsc"] += 1
    return out
