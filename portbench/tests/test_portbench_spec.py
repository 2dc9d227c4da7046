"""The benchmark's files against its contract: names, units and limits of
``BENCHMARK.json``, every piece found by name, and each metric file's
declarations matching its entry."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness.cells import Cell, load_metric, load_traffic  # noqa: E402
from portbench.harness.check import NUMBERS, limits  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    seen = set()
    for e in SPEC[section]:
        extra = set(e) - KEYS[section]
        assert extra <= {"workloads"}, (section, extra)
        assert KEYS[section] <= set(e), (section, e)
        assert NAME.match(e["name"]), e["name"]
        assert e["name"] not in seen
        seen.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                assert "\t" not in e[k]
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_end_to_end_rules():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(workload):
    cell = Cell(workload)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic == load_traffic(cell.entry["traffic"])
    assert cell.entry["chips"] == 1
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert set(limits(workload)) == set(NUMBERS)
    for k in cell.config["path"]:
        if k not in ("mode", "skin"):
            assert k in cell.config["assumed"], k


@pytest.mark.parametrize("entry", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_metric_file_matches_entry(entry):
    mod = load_metric(entry["name"])
    assert mod.UNIT == entry["unit"]
    assert mod.LAYER == entry["layer"]
    assert mod.SOURCE == entry["source"]
    assert mod.MOVES == entry["moves"]
    assert getattr(mod, "WORKLOADS", None) == entry.get("workloads")
    assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert callable(mod.read)


def test_config_files_are_distinct_and_used():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for f in files:
        assert any(f.startswith(p + "/") for p in SPEC["paths"])
