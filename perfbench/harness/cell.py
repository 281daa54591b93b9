"""Cells, configurations, traffic mixes, drivers and metric readers, each
found by its name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics.  Everything that
belongs to one of them is a file of its own under ``perfbench/``:

* a configuration is ``configs/<name>.json`` (the entry's ``file``); its
  ``driver`` key names ``drivers/<driver>.py`` and its ``reference`` key
  ``reference/<reference>.py``;
* a traffic mix is ``traffic/<name>.json``, parameters that the
  configuration's driver reads;
* a metric is ``metrics/<name>.py``, a module with ``read(run)`` that
  returns a number, or None where the run holds nothing to read.

A new cell, mix or metric is therefore a new file and a new entry, and
no file already here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"

__all__ = ["ROOT", "PERFBENCH", "Cell", "load_benchmark", "resolve_cell",
           "load_traffic", "load_module", "metric_reader",
           "metrics_for_cell"]


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_traffic(name: str, base: Path = PERFBENCH) -> dict:
    """The traffic mix ``name``: ``traffic/<name>.json``."""
    path = base / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` under the module name ``name`` (file names
    may hold dots and dashes, which an import statement cannot)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(kind: str, name: str) -> str:
    return "perfbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


def metric_reader(name: str, base: Path = PERFBENCH) -> ModuleType:
    return load_module(base / "metrics" / f"{name}.py",
                       _modname("metric", name))


class Cell:
    """One entry of ``workloads``, with its configuration, its traffic, and
    the modules that run and check it."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"choose from {sorted(cells)}")
        self.bench = bench
        self.entry = cells[name]
        self.name = name
        base = root / "perfbench"
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.traffic = load_traffic(self.entry["traffic"], base)
        self.chips = int(self.entry["chips"])
        self.driver = load_module(base / "drivers" / f"{self.config['driver']}.py",
                                  _modname("driver", self.config["driver"]))
        self.reference = load_module(
            base / "reference" / f"{self.config['reference']}.py",
            _modname("reference", self.config["reference"]))

    def metrics(self, trace: bool) -> list[dict]:
        return metrics_for_cell(self.bench, self.name, trace)


def metrics_for_cell(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    without tracing, its per-layer metrics with.  A metric without a
    ``workloads`` key applies to every cell (a per-layer one: every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}

    def applies(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        return m["moves"] in reported

    return [m for m in bench["per_layer"] if applies(m)]


def resolve_cell(name: str, root: Path = ROOT) -> Cell:
    return Cell(load_benchmark(root), name, root)
