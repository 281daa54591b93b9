"""Reproduce the paper's study end-to-end (Tables/Figures analogues) on
the H100 model.

Run:  PYTHONPATH=src python examples_torch/sfc_study.py [--device cpu]

Walks the paper's experiment grid through the H100 port's models and
prints the findings next to the paper's claims.  Every time and joule
printed is the ``H100`` model's (``repro_torch.core.energy``), not a
measurement; the block traffic comes from the exact LRU simulation.
``--device`` is accepted for symmetry with the other examples: the
study is host arithmetic only.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import grid_schedule  # noqa: E402
from repro_torch.core.curves import hilbert_index_cost_ops, \
    morton_index_cost_ops  # noqa: E402
from repro_torch.core.energy import H100, energy_joules  # noqa: E402
from repro_torch.core.locality import matmul_hbm_traffic  # noqa: E402

BLOCK = 128
DTYPE_BYTES = 4  # f32 blocks (the paper's doubles in f32)
# the paper's DVFS points (Table III), as fractions of its 2.6 GHz
FREQS = {"1.2GHz": 1.2 / 2.6, "1.8GHz": 1.8 / 2.6, "2.6GHz": 1.0,
         "ondemand": 1.15}   # ondemand ~ turbo above nominal
# the cache a GEMM's tiles are re-read from on the card: the H100 SXM5's
# 50 MB L2 (NVIDIA's data sheet); 80 % of it holds blocks
L2_BYTES = 50e6
# index decode: one integer op a cycle at the H100 SXM5's 1.98 GHz boost
# clock (data sheet), a first-order model of the kernel's per-tile decode
INDEX_OPS_PER_S = 1.98e9


def matmul_model(size_log2: int, schedule: str, *, chips: int = 1,
                 f_scale: float = 1.0, cache_blocks: int | None = None,
                 hw=H100):
    """Time/energy model of one n x n x n blocked matmul under a
    schedule on ``chips`` H100s.

    The grid is (n/128)^2 output tiles x (n/128) k-blocks; device-memory
    traffic from the exact LRU block-cache simulation with an L2-sized
    cache; compute = 2n^3 FLOPs.  ``chips`` splits the output grid
    row-contiguously (the paper's OpenMP parallel-for analogue)."""
    n = 2 ** size_log2
    g = n // BLOCK
    bb = BLOCK * BLOCK * DTYPE_BYTES
    if cache_blocks is None:
        cache_blocks = int(L2_BYTES * 0.8 / bb)
    order = grid_schedule(schedule, g, g)
    blocks = {"A": bb, "B": bb, "C": bb}
    if chips > 1:
        # split schedule into per-chip contiguous spans (locality kept)
        traffic = sum(
            matmul_hbm_traffic(s, g, blocks, model="lru",
                               capacity=cache_blocks)["total_bytes"]
            for s in np.array_split(order, chips))
    else:
        traffic = matmul_hbm_traffic(order, g, blocks, model="lru",
                                     capacity=cache_blocks)["total_bytes"]
    flops = 2.0 * n ** 3
    # index-computation overhead (paper §II): per-tile decode cost
    idx_ops = {"rowmajor": 2, "colmajor": 2, "boustrophedon": 4,
               "supertile": 8,
               "morton": morton_index_cost_ops(),
               "hilbert": hilbert_index_cost_ops(16)}[schedule]
    idx_time = len(order) * idx_ops / (INDEX_OPS_PER_S * f_scale * chips)
    e = energy_joules(flops, traffic, 0.0, chips, hw=hw, f_scale=f_scale)
    e["time"] = max(e["time"], idx_time)
    e["idx_time"] = idx_time
    e["traffic"] = traffic
    return e


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="accepted for symmetry; the study runs on the host")
    ap.parse_args(argv)
    print(f"(times and joules below: the {H100.name} model, not measured)")

    print("Paper claim 1: index cost RM < MO < HO")
    print(f"  ops/translation: RM=2  MO={morton_index_cost_ops()}  "
          f"HO={hilbert_index_cost_ops(16)}")

    print("\nPaper claim 2: locality HO >= MO > RM (memory-bound regime)")
    bb = {"A": 1, "B": 1, "C": 1}
    for cap in (64, 128):
        row = {}
        for s in ("rowmajor", "morton", "hilbert"):
            row[s] = matmul_hbm_traffic(grid_schedule(s, 32, 32), 32, bb,
                                        model="lru", capacity=cap)["misses"]
        print(f"  cache={cap:4d} blocks: RM={row['rowmajor']} "
              f"MO={row['morton']} HO={row['hilbert']}")

    print("\nPaper claim 3: size-10 in-cache -> ordering insignificant, "
          "RM wins")
    for size in (10, 12):
        times = {s: matmul_model(size, s, chips=8)["time"]
                 for s in ("rowmajor", "morton", "hilbert")}
        best = min(times, key=times.get)
        print(f"  n=2^{size}: " + "  ".join(
            f"{s}={t*1e3:.3f}ms" for s, t in times.items()) + f"  -> {best}")

    print("\nPaper claim 4: memory-bound + higher clock = disproportionate "
          "energy")
    for f, fs in FREQS.items():
        m = matmul_model(12, "rowmajor", chips=8, f_scale=fs)
        print(f"  RM n=2^12 {f:>8s}: t={m['time']*1e3:7.3f} ms  "
              f"E={m['total']:.3f} J")
    print("\n(chip_smoke.py measures the study's kernels, B3 and B4, on "
          "the card.)")


if __name__ == "__main__":
    main()
