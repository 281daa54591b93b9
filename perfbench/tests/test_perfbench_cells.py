"""BENCHMARK.json against the contract's shape, and every cell, mix,
configuration and metric found by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import ROOT

from perfbench.harness.cell import (load_benchmark, load_traffic,
                                    metric_reader, metrics_for_cell,
                                    resolve_cell)

BENCH = load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits in its 43200 seconds
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        names.append(("metric", m["name"]))
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        names.append(("metric", m["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for _, n in names)
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in metrics_for_cell(BENCH, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = metrics_for_cell(BENCH, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_every_layer_metric_moves_one_e2e_metric_and_names_its_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = resolve_cell(cell, ROOT)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(c.driver, "run") and hasattr(c.driver, "checks")
    assert hasattr(c.driver, "control")
    assert c.traffic == load_traffic(c.entry["traffic"])
    assert set(c.entry) >= {"chips"} and c.chips == 1


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    reader = metric_reader(metric)
    assert callable(reader.read)
    # a run that holds nothing to read gives nothing, not 0
    assert reader.read({"kind": "none", "window_s": 1.0,
                        "setup_s": 1.0}) in (None, 1.0)


def test_config_files_state_what_runs():
    glm = json.loads((ROOT / "perfbench/configs/glm4-9b.json").read_text())
    a = glm["arch"]
    assert glm["num_layers"] == a["n_layers"] == 40
    assert glm["hidden_size"] == a["d_model"] == 4096
    assert glm["num_attention_heads"] == a["n_heads"] == 32
    assert glm["multi_query_group_num"] == a["n_kv_heads"] == 2
    assert glm["kv_channels"] == a["d_head"] == 128
    assert glm["ffn_hidden_size"] == a["d_ff"] == 13696
    assert glm["padded_vocab_size"] == a["padded_vocab"] == 151552
    assert glm["torch_dtype"] == a["dtype"] == "bfloat16"
    entry = {c["name"]: c for c in BENCH["configs"]}["glm4-9b"]
    assert entry["reduced"] == glm["reduced"]
    paper = json.loads((ROOT / "perfbench/configs/paper-sfc.json").read_text())
    assert paper["dtype"] == "float32" and paper["block"] == 128


def test_a_new_mix_is_a_new_file(tmp_path):
    """A traffic file and an entry make a cell; no file changes."""
    dest = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (dest / "perfbench").rglob("*")
              if p.is_file()}
    mix = json.loads((ROOT / "perfbench/traffic/n1024.json").read_text())
    mix.update(batch=4, n=2048)
    (dest / "perfbench/traffic/n2048.json").write_text(json.dumps(mix))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "paper.n2048", "config": "paper-sfc",
                           "traffic": "n2048", "chips": 1, "why": "new"})
    (dest / "BENCHMARK.json").write_text(json.dumps(b))
    cell = resolve_cell("paper.n2048", dest)
    assert cell.traffic["n"] == 2048 and cell.config["name"] == "paper-sfc"
    assert all(p.read_bytes() == data for p, data in before.items())
    # metrics without a workloads key apply to it at once
    names = {m["name"] for m in metrics_for_cell(b, "paper.n2048", False)}
    assert names == {"setup_s"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        resolve_cell("no.such.cell", ROOT)
