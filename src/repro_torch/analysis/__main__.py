"""``python -m repro_torch.analysis`` -- run the static passes and emit a
JSON report (port of ``python -m repro.analysis``).

Examples::

    python -m repro_torch.analysis --config paper --shape 2048x2048x256
    python -m repro_torch.analysis --schedules-only --max-grid 16

The report has the reference's ``contracts``, ``schedules`` and
``winner`` sections under the H100 (``"hw": "H100"``).  The reference
also audits XLA's compiled HLO (its default run's ``hlo`` section, and
``--epilogue-gate``, which runs only the fused-epilogue gate); the
port's GEMMs are hand-written CUDA, with no HLO to read, so the report
names that section under ``omitted`` with the reason, and
``--epilogue-gate`` exits non-zero with it.

Exit status is 0 iff every section that ran passed; the report is
printed to stdout (or written to ``--out``) either way.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.energy import H100

from .contracts import check_gemm_contract
from .schedule import crosscheck_cost_model, verify_schedule

HLO_OMITTED = ("the HLO audit reads XLA's compiled HLO (the reference's "
               "analysis/hlo_audit.py over launch/hlo.py); the port's "
               "kernels are hand-written CUDA and its library baseline is "
               "torch, so there is no HLO to audit")


def _parse_shape(text: str) -> tuple:
    try:
        m, n, k = (int(p) for p in text.lower().split("x"))
        return m, n, k
    except ValueError:
        raise SystemExit(
            f"--shape must be MxNxK (e.g. 2048x2048x256), got {text!r}"
        ) from None


def _candidate_section(m: int, n: int, k: int, dtype_bytes: int,
                       hw=H100) -> dict:
    """Full-level contract check over the tuner's candidate grid for this
    shape: everything the tuner would launch must pass, and the checker
    must also reject the canonical bad configs."""
    from repro_torch.tune.autotune import candidate_configs
    from repro_torch.tune.cost import TuneConfig

    checked = rejected = 0
    bad = []
    for cfg in candidate_configs(m, n, k, dtype_bytes=dtype_bytes, hw=hw):
        if cfg.schedule == "xla":
            continue
        rep = check_gemm_contract(cfg, m, n, k, dtype_bytes=dtype_bytes,
                                  hw=hw, level="full")
        checked += 1
        if not rep.ok:
            rejected += 1
            bad.append(rep.to_dict())
    # negative controls: the checker must veto these
    over = check_gemm_contract(
        TuneConfig(schedule="morton", bm=4096, bn=4096, bk=512),
        4096, 4096, 512, dtype_bytes=dtype_bytes, hw=hw, level="fast")
    nonsq = check_gemm_contract(
        TuneConfig(schedule="hilbert", use_prefetch=False),
        3 * 128, 128, 256, dtype_bytes=dtype_bytes, hw=hw, level="fast")
    controls_ok = ("vmem-budget" in over.codes()
                   and "no-closed-form" in nonsq.codes())
    return {
        "ok": rejected == 0 and controls_ok,
        "checked": checked,
        "rejected": rejected,
        "rejections": bad,
        "negative_controls_ok": controls_ok,
    }


def _schedule_section(max_grid: int, hw=H100) -> dict:
    """Bijection proofs for every schedule at every grid size up to
    ``max_grid`` x ``max_grid``, plus the static byte-drift cross-check
    on power-of-two square grids."""
    from repro_torch.core.schedule import SCHEDULES

    failures = []
    proved = 0
    for name in SCHEDULES:
        for r in range(1, max_grid + 1):
            for c in range(1, max_grid + 1):
                rep = verify_schedule(name, r, c,
                                      g=4 if name == "supertile" else 0)
                proved += 1
                if not rep.ok:
                    failures.append(rep.to_dict())
    drift = []
    for name in ("rowmajor", "boustrophedon", "morton", "hilbert",
                 "supertile"):
        for mt in (2, 4, 8, 16):
            rep = crosscheck_cost_model(
                name, mt, mt, 2, g=4 if name == "supertile" else 0, hw=hw)
            drift.append({"schedule": name, "grid": mt,
                          "ok": rep.ok, **rep.stats})
            if not rep.ok:
                failures.append(rep.to_dict())
    return {"ok": not failures, "orders_proved": proved,
            "drift": drift, "failures": failures}


def _winner_section(m: int, n: int, k: int, dtype_bytes: int, hw=H100,
                    cache=None) -> dict:
    """Resolve the tuned config for this shape (analytic; nothing is
    launched) and run it through the full contract checker."""
    from repro_torch.tune.autotune import autotune

    best = autotune(m, n, k, measure=False, hw=hw, cache=cache).config
    rep = check_gemm_contract(best, m, n, k, dtype_bytes=dtype_bytes, hw=hw,
                              level="full")
    return {"ok": rep.ok, "config": best.to_dict(),
            "contract": rep.to_dict()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel-contract checker and SFC schedule verifier")
    ap.add_argument("--config", default="paper",
                    help="problem preset; 'paper' = the paper's GEMM "
                         "study (shape taken from --shape)")
    ap.add_argument("--shape", default="2048x2048x256",
                    help="GEMM problem as MxNxK")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--max-grid", type=int, default=16,
                    help="largest tile grid for the schedule sweep")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default: stdout)")
    ap.add_argument("--epilogue-gate", action="store_true",
                    help="the reference's HLO fused-epilogue gate: refused "
                         "here (no HLO)")
    ap.add_argument("--schedules-only", action="store_true",
                    help="run only the schedule verifier section")
    args = ap.parse_args(argv)

    if args.epilogue_gate:
        raise SystemExit(f"--epilogue-gate is not available: "
                         f"{HLO_OMITTED}")
    m, n, k = _parse_shape(args.shape)
    import numpy as np
    dtype_bytes = int(np.dtype(args.dtype).itemsize)

    report = {"config": args.config, "shape": [m, n, k],
              "dtype": args.dtype, "hw": "H100",
              "vmem_per_chip": H100.vmem_per_chip,
              "sections": {}}
    if args.schedules_only:
        report["sections"]["schedules"] = _schedule_section(args.max_grid)
    else:
        report["sections"]["contracts"] = _candidate_section(
            m, n, k, dtype_bytes)
        report["sections"]["schedules"] = _schedule_section(args.max_grid)
        report["sections"]["winner"] = _winner_section(
            m, n, k, dtype_bytes)
        report["omitted"] = {"hlo": HLO_OMITTED}

    report["ok"] = all(s.get("ok") for s in report["sections"].values())
    text = json.dumps(report, indent=2, default=str)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"[analysis] report -> {args.out}  ok={report['ok']}")
    else:
        print(text)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
