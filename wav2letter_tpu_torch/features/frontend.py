"""MFSC / MFCC / power-spectrum frontend — the port of
``wav2letter_tpu/features/frontend.py``.

Same semantics as the JAX frontend (reference ``fl::lib::audio::Mfsc``),
without dither, which only training turns on:

    preemphasis (0.97, x[0] kept) -> Hamming window -> |DFT|
    (magnitude, n_fft = next pow2 of frame length) -> HTK mel filterbank ->
    log(max(x, melfloor)) [-> DCT-II + liftering for MFCC] [-> deltas]
    [-> local CMVN]

For MFSC and MFCC the framing, |DFT|, mel and log run as one call of kernel
K1 (``kernels.mfsc``) on the pre-emphasized audio; the rest is plain PyTorch.
``HostFeaturizer`` runs the same module on the CPU in the data threads
(``--features_device=host``), where K1's wrapper takes its plain version.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels import KERNELS


def n_fft_for(frame_samples: int) -> int:
    n = 1
    while n < frame_samples:
        n *= 2
    return n


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_filters: int, n_fft: int, sample_rate: float,
                   low_freq: float = 0.0, high_freq: float = -1.0) -> np.ndarray:
    """HTK-style triangular mel filterbank, shape (n_fft//2+1, n_filters)."""
    if high_freq <= 0:
        high_freq = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(low_freq), hz_to_mel(high_freq), n_filters + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins, dtype=np.float64) * sample_rate / n_fft
    fb = np.zeros((n_bins, n_filters), dtype=np.float64)
    for m in range(n_filters):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """DCT-II matrix (HTK normalization), shape (n_in, n_out)."""
    i = np.arange(n_in, dtype=np.float64)[:, None]
    k = np.arange(n_out, dtype=np.float64)[None, :]
    m = np.sqrt(2.0 / n_in) * np.cos(np.pi * k * (i + 0.5) / n_in)
    return m.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FeatureParams:
    sample_rate: int = 16000
    frame_size_ms: float = 25.0
    frame_stride_ms: float = 10.0
    n_filterbanks: int = 80
    low_freq: float = 0.0
    high_freq: float = -1.0
    n_cepstral: int = 13
    lifter_param: float = 22.0
    delta_window: int = 0
    preem_coef: float = 0.97
    mel_floor: float = 1.0
    feature_type: str = "mfsc"  # mfsc|mfcc|pow|raw
    local_norm_left: int = 0
    local_norm_right: int = 0

    @property
    def frame_samples(self) -> int:
        return int(round(self.frame_size_ms * self.sample_rate / 1000.0))

    @property
    def stride_samples(self) -> int:
        return int(round(self.frame_stride_ms * self.sample_rate / 1000.0))

    @property
    def n_fft(self) -> int:
        return n_fft_for(self.frame_samples)

    @classmethod
    def from_config(cls, cfg) -> "FeatureParams":
        return cls(
            sample_rate=cfg.samplerate,
            frame_size_ms=cfg.framesizems,
            frame_stride_ms=cfg.framestridems,
            n_filterbanks=cfg.filterbanks,
            low_freq=cfg.lowfreqfilterbank,
            high_freq=cfg.highfreqfilterbank,
            n_cepstral=cfg.mfcccoeffs,
            delta_window=cfg.devwin,
            mel_floor=cfg.melfloor,
            feature_type=cfg.feature_type(),
            local_norm_left=cfg.localnrmlleftctx,
            local_norm_right=cfg.localnrmlrightctx,
        )


class Featurizer(nn.Module):
    """(audio (B, S), audio_len (B,)) -> (feats (B, T, C), feat_len (B,)).

    The DFT, mel and DCT matrices are non-persistent buffers, so
    ``.to(device)`` moves them with the module and checkpoints never hold
    them. ``ops`` picks the K1 implementation: ``kernels.KERNELS`` (the
    default) or ``kernels.PLAIN``.
    """

    def __init__(self, params: FeatureParams, ops: SimpleNamespace = KERNELS):
        super().__init__()
        self.p = params
        self.ops = ops
        p = params
        if p.feature_type == "raw":
            return
        n_fft = p.n_fft
        fs = p.frame_samples
        window = np.hamming(fs).astype(np.float64)
        t = np.arange(fs, dtype=np.float64)[:, None]
        k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
        ang = -2.0 * np.pi * t * k / n_fft
        self._buffer("cos_mat", window[:, None] * np.cos(ang))
        self._buffer("sin_mat", window[:, None] * np.sin(ang))
        self._buffer("mel_fb", mel_filterbank(
            p.n_filterbanks, n_fft, p.sample_rate, p.low_freq, p.high_freq))
        if p.feature_type == "mfcc":
            self._buffer("dct", dct_matrix(p.n_filterbanks, p.n_cepstral))
            kk = np.arange(p.n_cepstral, dtype=np.float64)
            self._buffer("lifter", 1.0 + 0.5 * p.lifter_param
                         * np.sin(np.pi * kk / p.lifter_param))

    def _buffer(self, name: str, arr: np.ndarray) -> None:
        self.register_buffer(
            name, torch.from_numpy(np.asarray(arr, np.float32)), persistent=False)

    def forward(self, audio: torch.Tensor, audio_len: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        p = self.p
        if audio.dim() == 1:
            audio = audio[None]
        if p.feature_type == "raw":
            return audio[..., None], audio_len
        audio = audio.float()
        # preemphasis: x[t] - a*x[t-1]; reference keeps x[0] as-is
        pre = torch.cat([audio[..., :1], audio[..., 1:] - p.preem_coef * audio[..., :-1]],
                        dim=-1).contiguous()
        fs, ss = p.frame_samples, p.stride_samples
        if p.feature_type == "pow":
            frames = pre.unfold(-1, fs, ss)
            re = frames @ self.cos_mat
            im = frames @ self.sin_mat
            feats = torch.sqrt(torch.clamp(re * re + im * im, min=1e-20))
        else:
            feats = self.ops.mfsc(pre, self.cos_mat, self.sin_mat, self.mel_fb,
                                  fs, ss, p.mel_floor)
            if p.feature_type == "mfcc":
                feats = (feats @ self.dct) * self.lifter
            if p.delta_window > 0:
                d = _delta(feats, p.delta_window)
                dd = _delta(d, p.delta_window)
                feats = torch.cat([feats, d, dd], dim=-1)
        if p.local_norm_left > 0 or p.local_norm_right > 0:
            feats = local_normalize(feats, p.local_norm_left, p.local_norm_right)
        flen = None
        if audio_len is not None:
            flen = torch.clamp(
                1 + torch.div(audio_len - fs, ss, rounding_mode="floor"), min=0
            ).to(torch.int32)
        return feats, flen


def _delta(x: torch.Tensor, win: int) -> torch.Tensor:
    """Regression deltas over time (HTK formula)."""
    denom = 2.0 * sum(i * i for i in range(1, win + 1))
    out = torch.zeros_like(x)
    for i in range(1, win + 1):
        fwd = torch.cat([x[:, i:], x[:, -1:].expand(-1, i, -1)], dim=1)
        bwd = torch.cat([x[:, :1].expand(-1, i, -1), x[:, :-i]], dim=1)
        out = out + i * (fwd - bwd)
    return out / denom


def local_normalize(feats: torch.Tensor, left_ctx: int, right_ctx: int) -> torch.Tensor:
    """Sliding-window CMVN over time via cumulative sums of centered values
    (centering per utterance and channel keeps E[x^2]-E[x]^2 from cancelling
    in fp32 on near-constant windows)."""
    B, T, C = feats.shape
    y = feats - feats.mean(dim=1, keepdim=True)
    zeros = feats.new_zeros((B, 1, C))
    cs = torch.cat([zeros, torch.cumsum(y, dim=1)], dim=1)
    cs2 = torch.cat([zeros, torch.cumsum(y * y, dim=1)], dim=1)
    t = torch.arange(T, device=feats.device)
    lo = torch.clamp(t - left_ctx, min=0)
    hi = torch.clamp(t + right_ctx + 1, max=T)
    n = (hi - lo).to(feats.dtype)[None, :, None]
    mean_y = (cs[:, hi] - cs[:, lo]) / n
    var = torch.clamp((cs2[:, hi] - cs2[:, lo]) / n - mean_y * mean_y, min=0.0)
    return (y - mean_y) / torch.sqrt(var + 1e-10)


class HostFeaturizer:
    """The featurizer of the host data pipeline (``--features_device=host``;
    JAX ``features/frontend.py::HostFeaturizer``): the reference featurizes
    in its data-loading threads and ships (T, C) features. ``Featurizer`` on
    the CPU, called by the prefetch threads on numpy batches; it returns the
    features as a CPU tensor in ``out_dtype`` (bf16 under
    ``--compute_dtype=bfloat16``, half the bytes of fp32 audio a frame-channel)
    and their lengths as int32 numpy."""

    def __init__(self, params: FeatureParams, out_dtype: torch.dtype = torch.float32):
        self._feat = Featurizer(params)
        self.out_dtype = out_dtype

    @torch.no_grad()
    def __call__(self, audio: np.ndarray, audio_len: np.ndarray
                 ) -> Tuple[torch.Tensor, np.ndarray]:
        feats, flen = self._feat(torch.from_numpy(np.asarray(audio, np.float32)),
                                 torch.from_numpy(np.asarray(audio_len, np.int32)))
        return feats.to(self.out_dtype), flen.numpy()
