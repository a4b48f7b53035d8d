"""MFSC features with local CMVN, and SpecAugment's masks.

MFSC (HTK conventions, as flashlight's ``Mfsc``, without dither):
pre-emphasis 0.97 with the first sample kept, 25 ms Hamming frames every
10 ms, the magnitude of a DFT of the next power of two, a triangular mel
filterbank on the HTK mel scale, ``log(max(., mel_floor))``. Local CMVN:
each utterance and channel centred over all its (padded) frames, then
normalised by the mean and variance of a window of ``left`` frames before
and ``right`` after. Computed in float64.

SpecAugment (flashlight's ``SpecAugment``): ``n_f`` frequency masks of a
width uniform in 0..F, ``n_t`` time masks of a width uniform in
0..min(T, p * length); every draw of a call from one ``torch.rand`` of
(rows, 2 * (n_f + n_t)) uniforms on the step's generator, two a mask (width,
then start), frequency masks first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def mel_filterbank(n_filters: int, n_fft: int, sample_rate: float) -> np.ndarray:
    """(n_fft // 2 + 1, n_filters) triangles, equally spaced on the HTK mel
    scale from 0 Hz to Nyquist."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    edges = hz(np.linspace(mel(0.0), mel(sample_rate / 2.0), n_filters + 2))
    bins = np.arange(n_fft // 2 + 1, dtype=np.float64) * sample_rate / n_fft
    fb = np.zeros((n_fft // 2 + 1, n_filters))
    for m in range(n_filters):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((bins - lo) / (mid - lo), (hi - bins) / (hi - mid)))
    return fb


def mfsc(audio: torch.Tensor, audio_len: torch.Tensor, n_mels: int = 80,
         sample_rate: int = 16000, frame_ms: float = 25.0, stride_ms: float = 10.0,
         preemph: float = 0.97, mel_floor: float = 1.0):
    """audio (B, S) -> (log mel energies (B, T, n_mels) float64, valid
    frames (B,) int64), T = 1 + (S - frame) // stride."""
    frame = int(round(frame_ms * sample_rate / 1000.0))
    stride = int(round(stride_ms * sample_rate / 1000.0))
    n_fft = 1 << (frame - 1).bit_length()
    x = audio.double()
    pre = torch.cat([x[:, :1], x[:, 1:] - preemph * x[:, :-1]], dim=1)
    window = torch.from_numpy(np.hamming(frame)).to(x.device)
    frames = pre.unfold(1, frame, stride) * window
    mag = torch.fft.rfft(frames, n=n_fft).abs()
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(x.device)
    feats = torch.log(torch.clamp(mag @ fb, min=mel_floor))
    flen = torch.clamp(1 + torch.div(audio_len.long() - frame, stride, rounding_mode="floor"),
                       min=0)
    return feats, flen


def local_cmvn(feats: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """feats (B, T, C), normalised over a sliding window of frames, in
    feats' dtype (float64 here)."""
    B, T, C = feats.shape
    y = feats - feats.mean(dim=1, keepdim=True)
    zero = y.new_zeros((B, 1, C))
    s1 = torch.cat([zero, y.cumsum(1)], 1)
    s2 = torch.cat([zero, (y * y).cumsum(1)], 1)
    t = torch.arange(T, device=y.device)
    lo, hi = (t - left).clamp(min=0), (t + right + 1).clamp(max=T)
    n = (hi - lo).to(y.dtype)[None, :, None]
    mean = (s1[:, hi] - s1[:, lo]) / n
    var = ((s2[:, hi] - s2[:, lo]) / n - mean * mean).clamp(min=0.0)
    return (y - mean) / torch.sqrt(var + 1e-10)


def _uniform_int(u: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.floor(u * high), high - 1).long()


def specaugment_keep(rows: int, T: int, C: int, generator: torch.Generator, n_f: int,
                     f_width: int, n_t: int, t_width: int, t_share: float,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cells SpecAugment keeps, (rows, T, C) bool on the CPU.
    ``lengths`` (rows,): the valid frames that bound the time masks (the
    padded length T where None)."""
    n = n_f + n_t
    keep = torch.ones((rows, T, C), dtype=torch.bool)
    if n == 0:
        return keep
    u = torch.rand((rows, 2 * n), generator=generator, dtype=torch.float64)
    length = (torch.full((rows,), float(T), dtype=torch.float64) if lengths is None
              else lengths.cpu().double())
    one = torch.ones((), dtype=torch.float64)
    c = torch.arange(C)[None, :]
    t = torch.arange(T)[None, :]
    col = 0
    for _ in range(n_f):
        w = _uniform_int(u[:, col], one * (f_width + 1))
        start = _uniform_int(u[:, col + 1], torch.clamp(C - w.double(), min=1.0))
        col += 2
        keep &= ~((c >= start[:, None]) & (c < (start + w)[:, None]))[:, None, :]
    most = torch.clamp(torch.floor(t_share * length), max=float(t_width))
    for _ in range(n_t):
        w = _uniform_int(u[:, col], torch.clamp(most + 1, min=1.0))
        start = _uniform_int(u[:, col + 1], torch.clamp(length - w.double(), min=1.0))
        col += 2
        keep &= ~((t >= start[:, None]) & (t < (start + w)[:, None]))[:, :, None]
    return keep


def features(batch: dict, device, cmvn_left: int, cmvn_right: int = 0,
             n_mels: int = 80):
    """The features of a batch dict (numpy ``audio``, ``audio_len``):
    (B, T, n_mels) on ``device``, valid frames (B,); local CMVN in float64."""
    audio = torch.as_tensor(batch["audio"]).to(device)
    alen = torch.as_tensor(batch["audio_len"]).to(device)
    feats, flen = mfsc(audio, alen, n_mels)
    if cmvn_left > 0 or cmvn_right > 0:
        feats = local_cmvn(feats, cmvn_left, cmvn_right)
    return feats, flen

