"""Tiny configurations and mixes for the CPU tests: the same arch lines and
flags as the benchmark's configurations, at widths a test run can hold."""

from __future__ import annotations

import copy
import json
import os

from benchmark.core import manifest

TDS_LINES = """V -1 NFEAT 1 0
PD 0 2 1
C2 1 4 5 1 2 1 0 0
R
DO 0.1
LN 1 2
TDS 4 5 16 0.1 0 1 0
PD 0 3 1
C2 4 6 5 1 2 1 0 0
R
DO 0.1
LN 1 2
TDS 6 5 16 0.1 0 0 0
RO 2 1 0 3
V 96 -1 1 0
L 96 NLABEL
V NLABEL 0 -1 1
"""

TR_LINES = """V -1 1 NFEAT 0
WN 3 C NFEAT 32 3 1 -1
GLU 2
DO 0.1
M 1 1 2 1
RO 2 0 3 1
TR 16 32 2 64 0.2 0.1
TR 16 32 2 64 0.2 0.1
L 16 NLABEL
"""

N_CLASSES = 12
# Limits of the tiny CPU runs, where both sides compute in float32: far above
# round-off, and far under what a broken timed path reads.
LIMITS = {"train": {"grad_gap_median": 0.05, "change_gap": 0.05},
          "infer": {"token_gap": 0.5, "length_mismatch": 0, "collapse_mismatch": 0}}


def config(kind: str, tmp: str, dtype: str = "float32") -> dict:
    """The benchmark's config ``kind`` (tds_ctc or transformer_ctc), its arch
    swapped for the tiny one, 16 filterbanks, ``N_CLASSES`` classes."""
    with open(manifest.HERE / "configs" / f"{kind}.json") as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    path = os.path.join(tmp, f"{kind}.arch")
    with open(path, "w") as f:
        f.write(TDS_LINES if kind == "tds_ctc" else TR_LINES)
    c["arch_file"] = path
    c["n_classes"] = N_CLASSES
    c["flags"].update(filterbanks=16, compute_dtype=dtype)
    if "localnrmlleftctx" in c["flags"]:
        c["flags"]["localnrmlleftctx"] = 30
    return c


def mix(mode: str) -> dict:
    return {"mode": mode, "batch": 4, "utterances": 8,
            "seconds_quantiles": [[0.0, 0.5], [0.5, 0.8], [1.0, 1.2]],
            "tokens_per_s": [3.0, 4.0], "pad_frames": 16, "pad_tokens": 4, "sample_rate": 16000}
