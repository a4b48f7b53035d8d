"""Sound-effect augmentation chain (``--sfx_config`` JSON) — a copy of
``wav2letter_tpu/data/sfx.py`` (numpy only).

Reference: flashlight's sfx library configured by a JSON file and applied in
the input transform (``sfx::readSoundEffectConfigFile``,
``cpc/Train.cpp:739-747``). Supported effects mirror the upstream set:

  Amplify            {ratioMin, ratioMax}
  ClampAmplitude     {}
  Normalize          {onlyIfTooHigh}
  AdditiveNoise      {listFilePath, minSnr, maxSnr, nClipsMin, nClipsMax, proba}
  ReverbEcho         {proba, initialMin, initialMax, rt60Min, rt60Max,
                      repeatMin, repeatMax, jitter, sampleRate}
  TimeStretch        {factorMin, factorMax, proba}

JSON format: a list of {"type": name, "conf": {...}} entries, applied in
order (host-side, numpy — runs in the prefetch threads). One
``random.Random(seed)`` feeds the chain, so its draws follow the order in
which the threads materialize the waveforms, as in the JAX package.
"""

from __future__ import annotations

import json
import random
from typing import Callable, List, Optional, Sequence

import numpy as np

from .audio import load_audio
from .listfile import read_list_file


class SoundEffect:
    def __call__(self, audio: np.ndarray, rng: random.Random) -> np.ndarray:
        raise NotImplementedError


class Amplify(SoundEffect):
    def __init__(self, conf):
        self.lo = float(conf.get("ratioMin", 0.8))
        self.hi = float(conf.get("ratioMax", 1.2))

    def __call__(self, audio, rng):
        return audio * rng.uniform(self.lo, self.hi)


class ClampAmplitude(SoundEffect):
    def __init__(self, conf=None):
        pass

    def __call__(self, audio, rng):
        return np.clip(audio, -1.0, 1.0)


class Normalize(SoundEffect):
    def __init__(self, conf):
        self.only_if_too_high = bool(conf.get("onlyIfTooHigh", True))

    def __call__(self, audio, rng):
        m = np.abs(audio).max()
        if m > 1.0 or (not self.only_if_too_high and m > 0):
            return audio / m
        return audio


class AdditiveNoise(SoundEffect):
    def __init__(self, conf):
        self.min_snr = float(conf.get("minSnr", 0.0))
        self.max_snr = float(conf.get("maxSnr", 30.0))
        self.n_min = int(conf.get("nClipsMin", 1))
        self.n_max = int(conf.get("nClipsMax", 1))
        self.proba = float(conf.get("proba", 1.0))
        self.list_path = conf.get("listFilePath", "")
        self._noise_files: Optional[List[str]] = None

    def _files(self):
        if self._noise_files is None:
            if self.list_path.endswith(".lst"):
                self._noise_files = [s.audio_path for s in read_list_file(self.list_path)]
            else:
                with open(self.list_path) as f:
                    self._noise_files = [l.strip() for l in f if l.strip()]
        return self._noise_files

    def __call__(self, audio, rng):
        if rng.random() > self.proba:
            return audio
        files = self._files()
        if not files:
            return audio
        n_clips = rng.randint(self.n_min, max(self.n_min, self.n_max))
        noise = np.zeros_like(audio)
        for _ in range(n_clips):
            clip = load_audio(rng.choice(files), expected_sr=0)
            if len(clip) >= len(audio):
                start = rng.randint(0, len(clip) - len(audio))
                noise += clip[start : start + len(audio)]
            else:
                reps = int(np.ceil(len(audio) / len(clip)))
                noise += np.tile(clip, reps)[: len(audio)]
        snr_db = rng.uniform(self.min_snr, self.max_snr)
        sig_p = np.mean(audio ** 2) + 1e-10
        noise_p = np.mean(noise ** 2) + 1e-10
        scale = np.sqrt(sig_p / (noise_p * (10 ** (snr_db / 10.0))))
        return audio + scale * noise


class ReverbEcho(SoundEffect):
    """Simple exponential-decay echo reverb (upstream ReverbEcho model)."""

    def __init__(self, conf):
        self.proba = float(conf.get("proba", 1.0))
        self.initial_min = float(conf.get("initialMin", 0.1))
        self.initial_max = float(conf.get("initialMax", 0.3))
        self.rt60_min = float(conf.get("rt60Min", 0.3))
        self.rt60_max = float(conf.get("rt60Max", 1.3))
        self.repeat_min = int(conf.get("repeatMin", 1))
        self.repeat_max = int(conf.get("repeatMax", 8))
        self.jitter = float(conf.get("jitter", 0.1))
        self.sr = int(conf.get("sampleRate", 16000))

    def __call__(self, audio, rng):
        if rng.random() > self.proba:
            return audio
        initial = rng.uniform(self.initial_min, self.initial_max)
        rt60 = rng.uniform(self.rt60_min, self.rt60_max)
        repeats = rng.randint(self.repeat_min, max(self.repeat_min, self.repeat_max))
        out = audio.copy()
        frac = 1.0
        echo = audio * initial
        for _ in range(repeats):
            jitter = 1 + rng.uniform(-self.jitter, self.jitter)
            delay = max(1, int(0.001 * jitter * self.sr + rt60 / repeats * self.sr))
            frac *= 10 ** (-3 * (delay / self.sr) / rt60)
            if delay >= len(audio):
                break
            out[delay:] += (echo * frac)[: len(audio) - delay]
        return out


class TimeStretch(SoundEffect):
    """Naive resample-based stretch (rate change without pitch preservation)."""

    def __init__(self, conf):
        self.lo = float(conf.get("factorMin", 0.9))
        self.hi = float(conf.get("factorMax", 1.1))
        self.proba = float(conf.get("proba", 1.0))

    def __call__(self, audio, rng):
        if rng.random() > self.proba:
            return audio
        f = rng.uniform(self.lo, self.hi)
        n = max(1, int(len(audio) / f))
        idx = np.linspace(0, len(audio) - 1, n)
        return np.interp(idx, np.arange(len(audio)), audio).astype(np.float32)


_EFFECTS = {
    "Amplify": Amplify,
    "ClampAmplitude": ClampAmplitude,
    "Normalize": Normalize,
    "AdditiveNoise": AdditiveNoise,
    "ReverbEcho": ReverbEcho,
    "TimeStretch": TimeStretch,
}


class SoundEffectChain:
    def __init__(self, effects: Sequence[SoundEffect], seed: int = 0):
        self.effects = list(effects)
        self.rng = random.Random(seed)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        for e in self.effects:
            audio = e(audio, self.rng)
        return audio.astype(np.float32)


def read_sound_effect_config(path: str, seed: int = 0) -> SoundEffectChain:
    """Parse the JSON chain config (reference readSoundEffectConfigFile)."""
    with open(path) as f:
        items = json.load(f)
    effects = []
    for item in items:
        t = item["type"]
        if t not in _EFFECTS:
            raise ValueError(f"unknown sound effect: {t}")
        effects.append(_EFFECTS[t](item.get("conf", {})))
    return SoundEffectChain(effects, seed)
