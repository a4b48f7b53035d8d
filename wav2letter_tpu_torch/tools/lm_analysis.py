"""LM-bias / segmentation analysis — reference ``recipes/sota/2019/lm_analysis``.

The port's copy of ``wav2letter_tpu/tools/lm_analysis.py``, with the same
functions and outputs; where that imports its package it imports the port's
``data/audio.py``.

The experiment disentangles acoustic vs linguistic representations of an AM:
  1. ``filter_segmentations`` — parse a forced-alignment file (``cli/align.py``
     output; reference ``Align``), split utterances at silences longer than
     ``min_sil``, keep samples with >1 chunk and <=``max_words`` words per
     chunk (``filter_segmentations.py:61-71``).
  2. ``shuffle_segments`` — cut the audio at those silence boundaries, shuffle
     the chunks, concatenate, and emit a shuffled ``.lst``
     (``shuffle_segments.py:70-103``; sox trim/concat replaced with in-process
     numpy cuts, PCM16 wav output).
  3. ``generate_shuffled_tts_lists`` — per-utterance word-order shuffles for
     the TTS resynthesis experiment (``generate_shuffle_dev_other_tts.py``).
     TTS synthesis itself used an external Mozilla-TTS checkpoint in the
     reference and is out of scope here.

WER deltas between original and shuffled lists are then measured with the
Test executor, exactly as the reference README prescribes.
"""

from __future__ import annotations

import os
import wave
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.audio import load_audio


# ---------------------------------------------------------------------------
# align-file parsing
# ---------------------------------------------------------------------------
def parse_align_line(line: str, min_sil: float, tolerance: float = 0.0):
    """-> (audio_path, chunk_starts, chunk_ends, chunk_words) split at
    silences > min_sil (reference shuffle_segments.py:35-68)."""
    sp = line.split("\t")
    path = sp[0]
    entries = sp[1].strip().split("\\n")
    chunk_starts: List[float] = [0.0]
    chunk_ends: List[float] = []
    words: List[str] = []
    cur_words: List[str] = []
    cur_end = 0.0
    for i, ent in enumerate(entries):
        f = ent.split()
        begin, length, word = float(f[2]), float(f[3]), f[4]
        cur_end = begin + length
        if i == 0 and word == "$":
            continue  # leading silence is part of chunk 0 (reference skips
            # entry 0 unconditionally — its align files always start with $)
        if word == "$":
            if length > min_sil:
                if cur_words:
                    chunk_ends.append(cur_end - tolerance)
                    chunk_starts.append(cur_end - tolerance)
                    words.append(" ".join(cur_words))
                    cur_words = []
                else:
                    # consecutive silences: slide the chunk start forward
                    chunk_starts[-1] = cur_end - tolerance
            continue
        cur_words.append(word)
    if cur_words:
        chunk_ends.append(cur_end)
        words.append(" ".join(cur_words))
    else:
        chunk_starts.pop()
    return path, chunk_starts, chunk_ends, words


def filter_segmentations(
    align_file: str,
    original_lst: str,
    out_dir: Optional[str] = None,
    min_sil: float = 0.13,
    max_words: int = 6,
) -> Dict:
    """Keep samples with >=2 chunks and <=max_words words per chunk; writes
    ``<align>.filtered`` + ``original.filtered.lst``. Returns stats."""
    out_dir = out_dir or os.path.dirname(os.path.abspath(align_file))
    stats = {
        "word_counter": defaultdict(int),
        "chunk_counter": defaultdict(int),
        "kept": 0,
        "total": 0,
    }
    good: List[str] = []
    with open(align_file) as f:
        for line in f:
            if not line.strip():
                continue
            stats["total"] += 1
            _, starts, ends, words = parse_align_line(line, min_sil)
            n_chunk = len(words)
            stats["chunk_counter"][n_chunk] += 1
            ok = n_chunk >= 2
            for wc in words:
                nw = len(wc.split())
                stats["word_counter"][nw] += 1
                if nw > max_words:
                    ok = False
            if ok:
                good.append(line)
    stats["kept"] = len(good)

    filtered_align = os.path.join(out_dir, os.path.basename(align_file) + ".filtered")
    with open(filtered_align, "w") as f:
        f.writelines(good)
    names = {l.split("\t")[0].split("/")[-1] for l in good}
    filtered_lst = os.path.join(out_dir, "original.filtered.lst")
    with open(original_lst) as f, open(filtered_lst, "w") as out:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[1].split("/")[-1] in names:
                out.write(line)
    stats["filtered_align"] = filtered_align
    stats["filtered_lst"] = filtered_lst
    return stats


# ---------------------------------------------------------------------------
# segment shuffling
# ---------------------------------------------------------------------------
def _write_wav(path: str, wav: np.ndarray, sr: int):
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def shuffle_segments(
    filtered_align: str,
    out_dir: str,
    seed: int = 0,
    min_sil: float = 0.13,
    tolerance: float = 0.04,
    sample_rate: int = 16000,
) -> str:
    """Chunk-shuffled copies of each utterance (audio cut at silence
    boundaries, chunks permuted, re-concatenated). Writes wavs + a ``.lst``;
    returns the list path."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    out_lst = os.path.join(out_dir, "shuffled.lst")
    with open(filtered_align) as f, open(out_lst, "w") as out:
        for li, line in enumerate(f):
            if not line.strip():
                continue
            path, starts, ends, words = parse_align_line(line, min_sil, tolerance)
            order = rng.permutation(len(starts))
            new_target = " ".join(words[i] for i in order)
            stem = os.path.splitext(os.path.basename(path))[0]
            new_path = os.path.join(out_dir, f"{stem}_shuf{seed}.wav")
            wav = load_audio(path, sample_rate)
            pieces = [
                wav[int(starts[i] * sample_rate): int(ends[i] * sample_rate)]
                for i in order
            ]
            cat = np.concatenate([p for p in pieces if p.size] or [wav])
            _write_wav(new_path, cat, sample_rate)
            dur_ms = 1000.0 * len(cat) / sample_rate
            out.write(f"{stem}_shuf{seed} {new_path} {dur_ms:.1f} {new_target}\n")
    return out_lst


# ---------------------------------------------------------------------------
# TTS word-order shuffles
# ---------------------------------------------------------------------------
def generate_shuffled_tts_lists(
    lst_path: str, out_dir: str, n_versions: int = 5, base_seed: int = 42
) -> List[str]:
    """Per-utterance word-order permutations for TTS resynthesis
    (generate_shuffle_dev_other_tts.py semantics: one text file per version,
    transcripts word-shuffled)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(lst_path) as f:
        data = [line.strip() for line in f if line.strip()]
    outs = []
    for v in range(n_versions):
        rng = np.random.RandomState(base_seed + v)
        out = os.path.join(out_dir, f"tts_shuffled_{v}.txt")
        with open(out, "w") as fo:
            for line in rng.permutation(data):
                parts = line.split(" ")
                shuffled = rng.permutation(parts[3:])
                fo.write(" ".join(shuffled) + "\n")
        outs.append(out)
    return outs
