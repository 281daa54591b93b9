"""Quickstart: the paper's technique in five minutes, on the H100 port.

1. Order a matrix traversal along Morton/Hilbert curves (paper §II);
2. quantify the locality effect with the block-cache simulator (§IV-A);
3. run the SFC-scheduled GEMM kernel (B1) against ``torch.matmul``;
4. put the energy model to work (§IV-B: speed != energy efficiency);
5. meter a real region with ``repro_torch.power`` and tune for EDP.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

On the card (the default) step 3 launches the CUDA kernel; with
``--device cpu`` it runs the kernel's plain PyTorch version.  Times
printed in step 4 are the H100 model's; those of step 5 are measured on
the device named beside them.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import grid_schedule  # noqa: E402
from repro_torch.core.curves import hilbert_encode_py, \
    morton_encode_py  # noqa: E402
from repro_torch.core.energy import H100, energy_joules  # noqa: E402
from repro_torch.core.locality import matmul_hbm_traffic  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.ops import sfc_matmul  # noqa: E402
from repro_torch.power import EnergyMeter, detect_backend  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    print("=" * 64)
    print("1. Space-filling curve orders over a 4x4 grid (paper Fig. 1)")
    for name in ("morton", "hilbert"):
        order = grid_schedule(name, 4, 4)
        grid = np.zeros((4, 4), int)
        for t, (i, j) in enumerate(order):
            grid[i, j] = t
        print(f"  {name}:\n{grid}")
    print("  serial of (y=3, x=5):",
          "morton", morton_encode_py(3, 5),
          "| hilbert", hilbert_encode_py(3, 5, 3))

    print("=" * 64)
    print("2. Locality: block traffic of a 16x16x16-tile matmul")
    bb = {"A": 1, "B": 1, "C": 1}
    for name in ("rowmajor", "morton", "hilbert"):
        r = matmul_hbm_traffic(grid_schedule(name, 16, 16), 16, bb,
                               model="lru", capacity=96)
        print(f"  {name:9s}: {r['misses']:6d} block fetches")

    print("=" * 64)
    print(f"3. The SFC-scheduled GEMM (B1) vs torch.matmul on {where}")
    g = torch.Generator().manual_seed(0)
    a = torch.randn(128, 128, generator=g).to(dev)
    b = torch.randn(128, 128, generator=g).to(dev)
    want = torch.matmul(a.double(), b.double())
    for sched in ("morton", "hilbert"):
        out = sfc_matmul(a, b, schedule=sched, bm=32, bn=32, bk=32)
        err = float((out.double() - want).abs().max())
        print(f"  {sched:9s}: max |err| vs torch.matmul (f64) = {err:.2e}")

    print("=" * 64)
    print("4. Energy model: raising the clock when memory-bound "
          "(paper Fig. 6)")
    print(f"   (times and joules: the {H100.name} model, not measured)")
    flops, traffic = 2 * (2**12) ** 3, 3.2e11  # a memory-bound config
    for f in (0.5, 0.75, 1.0):
        e = energy_joules(flops, traffic, 0, chips=1, f_scale=f)
        print(f"  f={f:4.2f}: time {e['time']*1e3:7.2f} ms  "
              f"energy {e['total']:6.2f} J")
    print("   -> time does not improve, energy keeps climbing: the paper's")
    print("      'speed != energy efficiency once memory-bound' in one "
          "sweep.")

    print("=" * 64)
    print("5. Energy telemetry: meter a region, tune for energy-delay "
          "product")
    backend = detect_backend()  # RAPL > NVML > analytic model
    sfc_matmul(a, b, schedule="auto", objective="edp")  # tune outside
    _sync(dev)
    t0 = time.perf_counter()
    with EnergyMeter("quickstart-gemm", backend=backend,
                     flops=2.0 * 128 ** 3) as em:
        sfc_matmul(a, b, schedule="auto", objective="edp")
        _sync(dev)
    wall = time.perf_counter() - t0
    r = em.reading
    print(f"  measured on {where}: backend={r.backend}  "
          f"{r.seconds*1e3:.2f} ms ({wall*1e3:.2f} ms wall)  "
          f"{r.joules:.4f} J  EDP={r.edp:.3e} J*s")
    print("   -> schedule='auto' adjudicated under objective='edp'; "
          "winners")
    print("      cache per-objective, so time- and energy-tuned configs "
          "coexist.")


if __name__ == "__main__":
    main()
