"""BENCHMARK.json against the contract's rules, and every part of a cell
found by name: configuration file, traffic file, driver, metric reader."""

import importlib
import json
import re

from bench_torch import harness
from bench_torch.harness import HERE, ROOT
from bench_torch.run import reported

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_and_entry_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench_torch"] and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for key, allowed in KEYS.items():
        for e in B[key]:
            extra = set(e) - allowed
            assert extra <= ({"workloads"} if key in ("end_to_end",
                                                      "per_layer") else set())
            assert allowed <= set(e), (key, e["name"])


def test_names_units_and_text():
    names = [e["name"] for k in KEYS for e in B[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in B[k]]
        assert len(got) == len(set(got))
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in B["configs"] + B["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in B["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\t" not in m["layer"]
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in B["end_to_end"])
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_each_moves_names_a_metric_every_listed_cell_reports():
    e2e = {m["name"] for m in B["end_to_end"]}
    cells = [w["name"] for w in B["workloads"]]
    for m in B["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert m["moves"] in {x["name"] for x in reported(B, cell, False)}
    for cell in cells:
        ends = {x["name"] for x in reported(B, cell, False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert reported(B, cell, True)
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert used == {c["name"] for c in B["configs"]}
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert c["file"].startswith("bench_torch/")
        data = harness.load_json(ROOT / c["file"])
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


def test_cells_found_by_name():
    for w in B["workloads"]:
        mix = harness.load_json(HERE / "traffic" / f"{w['traffic']}.json")
        importlib.import_module(f"bench_torch.drivers.{mix['driver']}")
        entry = harness.find(B, "configs", w["config"])
        cfg = harness.load_json(ROOT / entry["file"])
        importlib.import_module(f"bench_torch.reference.{cfg['reference']}")
    for m in B["per_layer"]:
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_command_names_only_paths():
    assert B["command"] == ["python3", "-m", "bench_torch.run"]
    assert len(B["command"]) <= 32
