"""BENCHMARK.json against the contract, and every name it gives found as a
file of its own."""
import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import CELLS, ROOT

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
WIDTHS = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|expansion|experts_per)")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"] and (ROOT / "portbench").is_dir()
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    n = len(BENCH["workloads"])
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024 and 1 <= n <= 24


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in E2E and set(m["workloads"]) <= set(CELLS)
        assert "\n" not in m["layer"] and "\t" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    entry, wl, cfg = harness.cell(name)
    assert entry["chips"] == 1 and NAME.match(entry["traffic"]) and len(entry["why"]) <= 200
    harness.entry_class(wl["entry"])
    assert harness.reported(BENCH, name, "per_layer"), "every cell reports a per-layer metric"
    e2e = [m["name"] for m in harness.reported(BENCH, name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith("portbench/configs/") and cfg["file"].endswith(".json")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"] == []
    assert cfg["source"].startswith("https://") and len(cfg["source"]) <= 200
    assert not any(WIDTHS.search(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_found_by_name(name):
    mod = harness.metric_module(name)
    assert callable(mod.read)
    assert name in harness.metric_names()
