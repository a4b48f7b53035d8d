"""The control: the reference computed on float8 operands (the precision
below the configurations' bfloat16) put in the program's place has to come
out as not correct. On the card at each cell's own size against the cell's
limits (``cuda``); on the CPU at a tiny size, further from the reference than
the program is."""

import json
import sys
import tempfile
import types

import pytest
import torch

from benchmark.core import check, manifest

from . import tiny

sys.path.insert(0, str(manifest.HERE / "tools"))
import readings  # noqa: E402

SEEDS = (7001, 7002, 7003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


def _cells():
    b = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in b["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cells())
def test_control_fails_on_the_card(card, name):
    cell = manifest.Cell(name)
    args = types.SimpleNamespace(control=True, fault=None)
    fn = readings.train_readings if cell.traffic["mode"] == "train" else readings.infer_readings
    for seed in SEEDS:
        out = fn(cell, seed, card, args, tempfile.mkdtemp())
        assert check.passed(check.judge(out["program"], cell.limits)), out
        assert not check.passed(check.judge(out["control"], cell.limits)), out


@pytest.mark.parametrize("kind,mode,number", [("transformer_ctc", "train", "grad_gap_median"),
                                              ("transformer_ctc", "infer", "token_gap")])
def test_control_is_further_than_the_program(tmp_path, kind, mode, number):
    cell = types.SimpleNamespace(config=tiny.config(kind, str(tmp_path), "bfloat16"),
                                 traffic=tiny.mix(mode))
    args = types.SimpleNamespace(control=True, fault=None)
    fn = readings.train_readings if mode == "train" else readings.infer_readings
    out = fn(cell, 2, "cpu", args, tempfile.mkdtemp(dir=tmp_path))
    assert out["control"][number] > 2 * out["program"][number], out
