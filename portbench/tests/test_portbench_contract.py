"""BENCHMARK.json against the benchmark's contract: names and units, every
cell's files found by name, metrics and bounds."""
import re

import pytest

from portbench import harness

from .tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_keys_and_names():
    assert set(BENCH) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert set(e) <= KEYS[section], e
            assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert PATH.match(c["file"]) and c["file"].startswith("portbench/")
    assert all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32


def test_metrics_sources_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers) >= 5


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(cell):
    """Each cell finds its configuration, traffic, driver, limits and every
    metric reader by name, and reports setup_s, one more end-to-end metric
    and at least one per-layer metric."""
    w = harness.find_cell(BENCH, cell)
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    config = harness.load_json(ROOT / cfg["file"])
    assert {"arch", "train", "gen"} <= set(config)
    traffic = harness.load_json(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
    driver = harness.load_module("drivers", traffic["driver"])
    assert callable(driver.drive) and callable(driver.check)
    assert harness.load_json(ROOT / "portbench" / "limits" / f"{cell}.json")
    e2e = [m["name"] for m in harness.metrics_for(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.metrics_for(BENCH, cell, "per_layer")
    assert per
    for m in harness.metrics_for(BENCH, cell, "end_to_end") + per:
        assert callable(harness.load_reader(m["name"]).read)


def test_readers_shared_by_a_family():
    """idle_share.serve_full and idle_share.train read through one file;
    a metric with a file of its own keeps it."""
    shared = harness.load_reader("idle_share.train")
    assert harness.load_reader("idle_share.serve_full").__file__ == shared.__file__
    assert shared.__file__.endswith("metrics/idle_share.py")
    assert harness.load_reader("mfu.train").__file__.endswith("metrics/mfu.train.py")


def test_every_per_layer_metric_names_its_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]


def test_config_files_copy_the_repo_configs():
    """Each configuration's file holds the repo configuration as written
    (nothing is reduced)."""
    for c in BENCH["configs"]:
        mine = harness.load_json(ROOT / c["file"])
        repo = harness.load_json(ROOT / "configs" / f"{c['name']}.json")
        assert c["reduced"] == [] and mine["reduced"] == []
        for section in ("arch", "train", "gen"):
            assert mine[section] == repo[section], (c["name"], section)


def test_check_budget():
    """A full check of 24 cells fits the driver's 43200 s at run_seconds."""
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_result_line_is_strict_json():
    """An infinite or NaN number prints as null."""
    import json

    from portbench.run import finite

    line = json.dumps(finite({"metrics": {"audio_s_per_s": {"value": float("inf")}},
                              "checks": {"served_gap": {"value": float("nan"), "limit": 0.5}}}),
                      allow_nan=False)
    assert json.loads(line)["metrics"]["audio_s_per_s"]["value"] is None
