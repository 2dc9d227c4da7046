"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file and its per-layer metric readers
(``metrics/<name>.py``). Adding a cell adds files and entries only."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


class Cell:
    def __init__(self, workload: str, root: Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; "
                             f"known: {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = load_traffic(self.entry["traffic"])
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in spec["per_layer"]
                          if workload in m.get("workloads", [workload])]


def load_traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def load_metric(name: str):
    """The reader module of per-layer metric ``name``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
