"""Runs of the harness on the CPU at a tiny size (the harness's look for a
card skipped): the reference against the program's plain path, the result
line's schema, and the faults the comparison has to catch."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.core import manifest, runner, system

from . import tiny

ROOT = manifest.ROOT
KINDS = [("transformer_ctc", "train"), ("transformer_ctc", "infer"), ("tds_ctc", "infer"),
         ("tds_ctc", "train")]


def run(tmp_path, kind, mode, seed=2 ** 31 + 77, **kw):
    names = ["setup_s", f"{mode}_audio_s_per_s", f"mfu.{mode}"]
    return runner.run(tiny.config(kind, str(tmp_path)), tiny.mix(mode), tiny.LIMITS[mode],
                      names, seed, 0.3, False, "cpu", time.perf_counter(), **kw)


def a_cell():
    return json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


@pytest.mark.parametrize("kind,mode", KINDS)
def test_reference_matches_the_plain_path(tmp_path, kind, mode):
    """float32 on both sides: the numbers are round-off, far under any limit."""
    r = run(tmp_path, kind, mode)
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] <= (0 if "mismatch" in name else 1e-4), (name, c)


def test_result_schema(tmp_path):
    r = run(tmp_path, "tds_ctc", "infer")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "not_compared",
                       "checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "infer_audio_s_per_s", "mfu.infer"}
    assert all(v > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def _stale(monkeypatch):
    step = system.TrainSystem.step

    def stale(self, batch):
        before = {n: p.detach().clone() for n, p in self.params().items()}
        out = step(self, batch)
        with torch.no_grad():
            for n, p in self.params().items():
                p.copy_(before[n])
        return out

    monkeypatch.setattr(system.TrainSystem, "step", stale)


def _half_train(monkeypatch):
    step = system.TrainSystem.step
    monkeypatch.setattr(system.TrainSystem, "step", lambda self, b: step(
        self, {k: v[: len(v) // 2] for k, v in b.items()}))


def _half_serve(monkeypatch):
    serve = system.InferSystem.serve
    monkeypatch.setattr(system.InferSystem, "serve", lambda self, b: serve(
        self, {k: v[: len(v) // 2] for k, v in b.items()}))


def _altered_token(monkeypatch):
    serve = system.InferSystem.serve

    def altered(self, b):
        paths, lens, toks = serve(self, b)
        toks[0] = list(toks[0]) + [1]
        return paths, lens, toks

    monkeypatch.setattr(system.InferSystem, "serve", altered)


def _altered_path(monkeypatch):
    serve = system.InferSystem.serve

    def altered(self, b):
        paths, lens, toks = serve(self, b)
        paths = paths.copy()
        paths[0, 0] = (paths[0, 0] + 1) % (tiny.N_CLASSES - 1)
        toks[0] = list(toks[0])
        return paths, lens, toks

    monkeypatch.setattr(system.InferSystem, "serve", altered)


@pytest.mark.parametrize("kind,mode,fault", [
    ("transformer_ctc", "train", _stale), ("transformer_ctc", "train", _half_train),
    ("tds_ctc", "infer", _half_serve), ("tds_ctc", "infer", _altered_token),
    ("tds_ctc", "infer", _altered_path)],
    ids=["state_unchanged", "half_batch_train", "half_batch_serve", "token_altered",
         "path_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, kind, mode, fault):
    fault(monkeypatch)
    r = run(tmp_path, kind, mode)
    assert r["correct"] is False, r["checks"]


def test_run_refuses_without_the_cards(tmp_path):
    """No card here: a non-zero exit and no result. (On a machine with a card
    the harness would run instead.)"""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", a_cell(),
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's folder."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", a_cell(),
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""



def test_a_metric_with_nothing_to_read_fails_the_run(tmp_path):
    """A roofline that finds no kernel to read (here, a run with no trace)
    fails the run instead of dropping out of its line."""
    with pytest.raises(LookupError, match="attention_roofline.train"):
        runner.run(tiny.config("transformer_ctc", str(tmp_path)), tiny.mix("train"),
                   tiny.LIMITS["train"], ["setup_s", "attention_roofline.train"], 5, 0.3,
                   False, "cpu", time.perf_counter())
