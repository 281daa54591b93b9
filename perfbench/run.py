"""Run one cell of the benchmark on the card and print its result.

    python3 perfbench/run.py --workload glm4-9b.docqa --seed 7 \\
        --seconds 51 --trace 0

The cell, its configuration and traffic mix, and the metrics it reports
are found by name from ``BENCHMARK.json`` (``perfbench/harness/cell.py``).
The run sets up (kernels built into the checkout's ``build/``, inputs
drawn on the card from ``--seed``, every shape warmed up), measures for
``--seconds``, then checks what the timed path produced against the
plain reference.  ``--trace 1`` records the card's activity over the
window and reports the per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``), then ``checks``, each number compared beside its limit;
the same numbers close standard error.  Without a CUDA card, or with
fewer cards than the cell asks for, or if JAX or the JAX package was
loaded, it exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every cache the program keeps stays at a fixed place in the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build"
                                              / "repro_torch_kernels")
    os.environ["REPRO_TUNE_CACHE"] = str(ROOT / "build" / "perfbench"
                                         / "tune.json")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's
    (the port's ``repro_torch`` is another name)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in _FORBIDDEN})


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda",
            energy=None, t_start: float | None = None) -> dict:
    """Run the cell's driver, read its metrics and check its outputs.
    ``t_start`` (``time.perf_counter``), when given, is where set-up
    began: the process's start.  Returns the result object (without
    printing)."""
    import torch

    from perfbench.harness.cell import metric_reader

    drv = cell.driver
    rec = drv.run(cell, seed, seconds, trace, device=device, energy=energy)
    if t_start is not None:
        rec["setup_s"] = rec["window_start_s"] - t_start
        rec["setup_pre_s"] = rec["setup_start_s"] - t_start
    t_read = time.perf_counter()
    metrics = {}
    for m in cell.metrics(trace):
        v = metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = drv.checks(cell, rec)
    rec["check_s"] = time.perf_counter() - t
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": all(c["ok"] for c in checks),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_by_host(rec["spans"], 10)}
    rec["read_s"] = time.perf_counter() - t_read - rec["check_s"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    out["_detail"] = checks
    out["_record"] = {k: v for k, v in rec.items()
                      if isinstance(v, (int, float)) and v is not None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    pre = {}

    import torch

    from perfbench.harness.cell import resolve_cell
    from perfbench.harness.nvml import EnergyCounter

    pre["pre_import_s"] = time.perf_counter() - T_START
    cell = resolve_cell(args.workload)
    pre["pre_cell_s"] = time.perf_counter() - T_START
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; this benchmark measures the card "
              "and reports nothing from the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pre["pre_cuda_s"] = time.perf_counter() - T_START
    energy = EnergyCounter(0)
    pre["pre_nvml_s"] = time.perf_counter() - T_START
    out = measure(cell, args.seed, args.seconds, bool(args.trace),
                  energy=energy, t_start=T_START)
    out["_record"].update(pre)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    detail = out.pop("_detail")
    print("run " + json.dumps(out.pop("_record")), file=sys.stderr)
    for c in detail:
        extra = {k: v for k, v in c.items()
                 if k not in ("name", "value", "limit", "ok")}
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'} {json.dumps(extra)}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
