"""BENCHMARK.json: its required form and the files it names."""

import json
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
MAN = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|_dim$|_rank$|per_tok|width)")


def all_metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16 and len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
    assert all(w.startswith("perfbench") or "/" not in w
               for w in MAN["command"])
    n = len(MAN["workloads"])
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24 and 1 <= len(MAN["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, n // 4)


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + all_metrics(), ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], all_metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("perfbench/")
    data = harness.load_json(os.path.join(ROOT, conf["file"]))
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert len(conf["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in conf["reduced"])
    assert any(w["config"] == conf["name"] for w in MAN["workloads"])


def test_end_to_end_bounds():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(cell):
    e2e, layer = harness.cell_metrics(MAN, cell["name"])
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names
    entry, traffic, config = harness.find_cell(MAN, cell["name"])
    assert os.path.exists(harness.workload_path(cell["name"]))
    assert traffic["limits"]
    assert cell["chips"] in (1, 4)


@pytest.mark.parametrize("metric", all_metrics(), ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_agrees(metric):
    mod = harness.reader(metric["name"])
    assert mod.UNIT == metric["unit"] and mod.BETTER == metric["better"]
    assert mod.SOURCE == metric["source"]
    assert mod.LAYER == metric.get("layer")
    assert mod.MOVES == metric.get("moves")
    if "moves" in metric:
        # each listed cell reports the end-to-end metric it moves
        for cell in metric.get("workloads", []):
            e2e, _ = harness.cell_metrics(MAN, cell)
            assert metric["moves"] in [m["name"] for m in e2e]
    if "roofline" in metric["name"]:
        assert metric["unit"] == "%"
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(m["layer"] in layers for m in MAN["per_layer"])
