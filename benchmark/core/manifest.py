"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root names the cells; a cell names its configuration
(``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<traffic>.json``); its comparison's limits are
``benchmark/limits/<cell>.json``."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, name: str):
        self.manifest = _json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        self.config = _json(HERE / "configs" / f"{self.workload['config']}.json")
        self.traffic = _json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"] if self._reports(m)]

    def per_layer(self) -> List[dict]:
        return [m for m in self.manifest["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        """A metric with no ``workloads`` key (``setup_s``) is every cell's."""
        return "workloads" not in metric or self.name in metric["workloads"]


def arch_lines(config: dict) -> List[str]:
    with open(ROOT / config["arch_file"]) as f:
        return f.read().splitlines()


def arch_path(config: dict) -> str:
    return os.fspath(ROOT / config["arch_file"])
