"""``.lst`` dataset list files.

Format (reference ``data/librispeech/utils.py:36-46``):
    sample_id  abs_audio_path  duration_ms  transcript words ...
one sample per line, whitespace-separated, transcript may be empty.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List


@dataclasses.dataclass
class ListSample:
    sample_id: str
    audio_path: str
    duration_ms: float
    transcript: str

    @property
    def words(self) -> List[str]:
        return self.transcript.split()


def resolve_list_paths(spec: str, datadir: str = "") -> List[str]:
    """Reference path semantics (``pathsConcat``; ``--train=a.lst,b.lst``
    with ``--datadir`` prefix, e.g. ``sota/2019/librispeech/
    train_am_transformer_s2s.cfg``): comma-separated list files, each joined
    under datadir unless absolute."""
    out = []
    for p in spec.split(","):
        p = p.strip()
        if not p:
            continue
        if datadir and not os.path.isabs(p):
            p = os.path.join(datadir, p)
        out.append(p)
    return out


def read_list_files(spec: str, datadir: str = "") -> List[ListSample]:
    """Concatenation of all lists named by a comma spec (+datadir)."""
    out: List[ListSample] = []
    for p in resolve_list_paths(spec, datadir):
        out.extend(read_list_file(p))
    return out


def read_list_file(path: str) -> List[ListSample]:
    out: List[ListSample] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 3)
            if len(parts) < 3:
                raise ValueError(f"malformed .lst line in {path}: {line!r}")
            sid, apath, dur = parts[0], parts[1], float(parts[2])
            transcript = parts[3] if len(parts) > 3 else ""
            out.append(ListSample(sid, apath, dur, transcript))
    return out


def write_list_file(path: str, samples: List[ListSample]) -> None:
    with open(path, "w") as f:
        for s in samples:
            f.write(f"{s.sample_id} {s.audio_path} {s.duration_ms} {s.transcript}".rstrip() + "\n")
