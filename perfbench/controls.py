"""Readings that set the limits of ``correct``: per seed, the program's
number (the lower reading) and the control's (the plain reference put
in the program's place in the nearest precision below the
configuration's: fp8 for the bf16 model, TF32 for the f32 study).

    python3 perfbench/controls.py --workload glm4-9b.docqa \\
        --seeds 11 12 13 --seconds 51

A serving cell runs its window for each seed (the control reads the
gap of the token the fp8 reference puts first at each served position);
a GEMM cell needs no window.  One JSON line per seed.  It runs on the
card only; ``perfbench/tests/test_perfbench_controls.py`` drives it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness.cell import resolve_cell
    from perfbench.run import _paths

    _paths()
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = resolve_cell(args.workload)
    for seed in args.seeds:
        out = cell.driver.control(cell, seed, args.seconds)
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
