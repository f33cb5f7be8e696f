"""BENCHMARK.json against the contract's characters and limits, and every
file that a cell, a mix, a configuration or a metric is found by."""

from __future__ import annotations

import re

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_one_line(w) and not w.startswith("/")
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_unique_and_plain(key):
    names = [e["name"] for e in BENCH[key]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_metrics():
    keys = {"name", "unit", "better", "source", "bound", "workloads"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= keys and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    layer_keys = {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= layer_keys and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("port_bench/configs/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.cell(cell)
    assert {"name", "model", "head", "loss", "optim"} <= set(c.config)
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap",
                             "teacher_change_gap"}
    assert {m["name"] for m in c.end_to_end} >= {"setup_s",
                                                 "train_img_per_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_reduced_keys_are_the_keys_changed_from_the_source():
    for c in BENCH["configs"]:
        config = spec.load_json(spec.ROOT / c["file"])
        changed = {k for k, v in config["published"].items()
                   if config["model"].get(k) != v}
        assert changed == set(c["reduced"])


def test_layers_are_named_in_perf_md():
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf
