"""BENCHMARK.json keeps to its format (keys, names, units, bounds), and
every part a cell names is found by its name: the configuration and
traffic files, the limits, and a reader for each metric whose declared
unit, direction, source, layer and ``moves`` match the entry."""

import json
import re

import pytest

from conftest import ROOT

from perfbench import harness

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "perfbench/run.py"]
    assert B["paths"] == ["perfbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"}),
                       ("end_to_end", {"name", "unit", "better", "bound",
                                       "source"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves"})):
        for e in B[kind]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in names
            names.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_cells_one_chip_and_bounds():
    assert all(w["chips"] == 1 for w in B["workloads"])
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(w):
    _, cfg, traffic, limits = harness.cell(w["name"], B)
    assert cfg["name"] == w["config"]
    assert traffic["kind"] == "train"
    assert set(limits) == set(harness.CHECKS)
    assert all(v > 0 for v in limits.values())
    # the check's first three steps train rows that all differ
    assert min(harness.batches_of(traffic)) >= 3
    # the configuration's family, found by its name
    assert callable(harness.family(cfg, "program").build)
    assert callable(harness.family(cfg, "reference").model)


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(m):
    mod = harness.module("metrics", m["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
        m["unit"], m["better"], m["source"], m["layer"], m["moves"])
    assert m["moves"] in {e["name"] for e in B["end_to_end"]}


@pytest.mark.parametrize("m", B["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_reader(m):
    mod = harness.module("end_to_end", m["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
        m["unit"], m["better"], m["source"])


def test_config_files_under_paths():
    for c in B["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("traffic, steps, samples", [
    ("sflv3-tenth-b16", 23, 80), ("sflv3-160th-b2", 12, 10)])
def test_epoch_schedule(traffic, steps, samples):
    t = json.loads((ROOT / "perfbench" / "traffic" /
                    f"{traffic}.json").read_text())
    assert harness.epoch_steps(t) == steps
    assert harness.step_samples(t) == samples
