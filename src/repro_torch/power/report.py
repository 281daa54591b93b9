"""Session-level energy report: collect readings, emit/validate JSON
(port of ``repro.power.report``, the same schema)::

    {"schema_version": 1, "kind": "repro-power-report",
     "backend": "<rapl|nvml|model>", "meta": {...},
     "readings": [EnergyReading.to_dict(), ...],
     "totals": {"joules": J, "seconds": s, "edp": J*s, "flops": F}}

``validate_report`` is the schema check; the module is runnable::

    python -m repro_torch.power.report report.json
    python -m repro_torch.power.report --bench bench.json
"""
from __future__ import annotations

import json
from typing import Any

from .meter import EnergyReading

__all__ = ["SCHEMA_VERSION", "EnergyReport", "validate_report",
           "validate_bench_payload"]

SCHEMA_VERSION = 1
_KIND = "repro-power-report"


class EnergyReport:
    """Accumulates :class:`EnergyReading` records for one run."""

    def __init__(self, backend: str | None = None, meta: dict | None = None):
        self.backend = backend
        self.meta = dict(meta or {})
        self.readings: list[EnergyReading] = []

    def add(self, reading: EnergyReading) -> None:
        self.readings.append(reading)
        if self.backend is None:
            self.backend = reading.backend

    def totals(self) -> dict[str, float]:
        j = sum(r.joules for r in self.readings)
        s = sum(r.seconds for r in self.readings)
        return {"joules": j, "seconds": s, "edp": j * s,
                "flops": sum(r.flops for r in self.readings)}

    def to_dict(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "kind": _KIND,
            "backend": self.backend or "unknown",
            "meta": self.meta,
            "readings": [r.to_dict() for r in self.readings],
            "totals": self.totals(),
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)


# ------------------------------------------------------------------ schema
def _check_reading(r: Any, where: str, errors: list[str]) -> None:
    if not isinstance(r, dict):
        errors.append(f"{where}: reading is not an object")
        return
    for key, typ in (("label", str), ("backend", str),
                     ("domains", dict)):
        if not isinstance(r.get(key), typ):
            errors.append(f"{where}.{key}: expected {typ.__name__}")
    for key in ("seconds", "joules", "edp", "watts"):
        v = r.get(key)
        if not isinstance(v, (int, float)) or v < 0:
            errors.append(f"{where}.{key}: expected non-negative number, "
                          f"got {v!r}")
    dom = r.get("domains")
    if isinstance(dom, dict):
        for k, v in dom.items():
            if not isinstance(k, str) or not isinstance(v, (int, float)):
                errors.append(f"{where}.domains[{k!r}]: expected str -> "
                              "number")
    for i, c in enumerate(r.get("children") or []):
        _check_reading(c, f"{where}.children[{i}]", errors)


def validate_report(d: Any, *, strict: bool = False) -> list[str]:
    """Return schema problems ([] when valid); ``strict`` raises instead."""
    errors: list[str] = []
    if not isinstance(d, dict):
        errors.append("report is not a JSON object")
    else:
        if d.get("schema_version") != SCHEMA_VERSION:
            errors.append(
                f"schema_version: expected {SCHEMA_VERSION}, "
                f"got {d.get('schema_version')!r}")
        if d.get("kind") != _KIND:
            errors.append(f"kind: expected {_KIND!r}, got {d.get('kind')!r}")
        if not isinstance(d.get("backend"), str):
            errors.append("backend: expected string")
        readings = d.get("readings")
        if not isinstance(readings, list):
            errors.append("readings: expected list")
        else:
            for i, r in enumerate(readings):
                _check_reading(r, f"readings[{i}]", errors)
        totals = d.get("totals")
        if not isinstance(totals, dict) or not all(
                isinstance(totals.get(k), (int, float))
                for k in ("joules", "seconds", "edp")):
            errors.append("totals: expected {joules, seconds, edp} numbers")
    if errors and strict:
        raise ValueError("invalid energy report: " + "; ".join(errors))
    return errors


def validate_bench_payload(d: Any, *, strict: bool = False) -> list[str]:
    """Validate a benchmark payload (the reference's ``benchmarks/run.py
    --json`` schema): provenance stamp plus the embedded energy
    report."""
    errors: list[str] = []
    if not isinstance(d, dict):
        errors.append("payload is not a JSON object")
    else:
        for key in ("schema_version", "git_sha", "backend", "power_backend"):
            if key not in d:
                errors.append(f"missing stamp field {key!r}")
        if not isinstance(d.get("results"), dict):
            errors.append("results: expected object")
        errors += validate_report(d.get("energy"))
    if errors and strict:
        raise ValueError("invalid bench payload: " + "; ".join(errors))
    return errors


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="JSON file to validate")
    ap.add_argument("--bench", action="store_true",
                    help="validate a benchmark payload (provenance stamp plus "
                         "an embedded energy report) instead of a bare "
                         "power report")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        d = json.load(f)
    errors = (validate_bench_payload if args.bench else validate_report)(d)
    if errors:
        for e in errors:
            print(f"INVALID {args.path}: {e}")
        return 1
    print(f"OK {args.path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
