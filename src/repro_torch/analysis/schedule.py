"""Schedule verifier and static locality cross-check (port of
``repro.analysis.schedule``).

Two jobs:

* :func:`verify_order` / :func:`verify_schedule` -- prove a grid
  traversal is a **bijection** onto the rows x cols tile grid: every
  visited tile in bounds, every tile visited exactly once.  A duplicate
  tile is a write-write race between the kernel's tile steps (two steps
  flush their accumulator into the same output block); a missing tile
  is silent wrong output.  The proof is vectorised numpy over the raw
  (T, 2) array, so corrupt or hand-built permutations can be checked
  directly.

* :func:`stack_distance_traffic` / :func:`crosscheck_cost_model` -- an
  **independent second implementation** of the cost model's LRU traffic
  accounting, via the classic stack-distance algorithm (an access hits
  a capacity-C LRU iff fewer than C distinct blocks were touched since
  its previous access) instead of ``repro_torch.core.locality``'s
  explicit OrderedDict replay.  Both walk the same A/B access stream of
  the blocked matmul, so on any grid small enough to escape the cost
  model's prefix probe the two byte counts must agree to within
  :data:`STATIC_DRIFT_TOL`: a static drift detector that catches a bug
  in either implementation before a measurement could.

:func:`crosscheck_link_model` holds the closed-form ring all-reduce
traffic (``tune.cost.ring_allreduce_link_bytes``) to an explicit
per-step simulation of the collective in the same way; it is host
arithmetic and needs no process group.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.energy import H100
from repro_torch.core.schedule import grid_schedule, schedule_extra_kwargs
from repro_torch.tune.cost import TuneConfig, predict, \
    ring_allreduce_link_bytes

from .contracts import ContractReport, verify_order

__all__ = ["STATIC_DRIFT_TOL", "verify_order", "verify_schedule",
           "stack_distance_traffic", "crosscheck_cost_model",
           "crosscheck_link_model"]

# tolerance band for static-vs-model traffic: both sides are exact
# replays of the same trace, so the band only absorbs float accumulation
# and leaves room for the prefix-probe scaling the model applies beyond
# its max_sim_steps budget (never hit at <= 16x16 grids)
STATIC_DRIFT_TOL = 0.02


def verify_schedule(name: str, rows: int, cols: int,
                    g: int = 0) -> ContractReport:
    """Bijection proof for a named ``grid_schedule`` at one grid size."""
    order = grid_schedule(name, rows, cols,
                          **schedule_extra_kwargs(name, g))
    return verify_order(order, rows, cols,
                        subject=f"schedule {name} {rows}x{cols}"
                                + (f" g={g}" if g else ""))


def _stack_distance_misses(trace, capacity: int) -> dict:
    """Per-tensor miss counts of a capacity-C LRU over ``trace``, by
    stack distance: keep the recency stack (most recent first); an
    access at stack position p hits iff p < capacity.  Equivalent to an
    explicit LRU replay for every capacity at once, and implemented with
    none of :mod:`repro_torch.core.locality`'s machinery, which is the
    point."""
    stack: list = []
    misses: dict = {}
    for key in trace:
        try:
            p = stack.index(key)
        except ValueError:
            p = None
        if p is None or p >= capacity:
            misses[key[0]] = misses.get(key[0], 0) + 1
        if p is not None:
            stack.pop(p)
        stack.insert(0, key)
    return misses


def stack_distance_traffic(order, kt: int, block_bytes: dict,
                           capacity: int) -> dict:
    """Device-memory traffic of a blocked matmul under ``order`` via
    stack distances.  The access stream is
    ``matmul_block_trace(k_inner=True)``'s -- per output tile (i, j),
    A[i, kk] then B[kk, j] for kk in [0, kt) -- built here
    independently; C is written back once per tile (the accumulator
    flush) and never occupies the simulated cache."""
    trace = []
    for (i, j) in np.asarray(order):
        for kk in range(kt):
            trace.append(("A", int(i), kk))
            trace.append(("B", kk, int(j)))
    misses = _stack_distance_misses(trace, capacity)
    read_bytes = (misses.get("A", 0) * block_bytes["A"]
                  + misses.get("B", 0) * block_bytes["B"])
    write_bytes = len(order) * block_bytes["C"]
    n_miss = sum(misses.values())
    return {
        "read_bytes": read_bytes,
        "write_bytes": write_bytes,
        "total_bytes": read_bytes + write_bytes,
        "misses": n_miss,
        "accesses": len(trace),
        "hit_rate": 1.0 - n_miss / max(len(trace), 1),
    }


def crosscheck_cost_model(
    schedule: str,
    mt: int,
    nt: int,
    kt: int = 2,
    *,
    bm: int = 128,
    bn: int = 128,
    bk: int = 128,
    dtype_bytes: int = 4,
    capacity: int | None = None,
    g: int = 0,
    hw=H100,
    tol: float = STATIC_DRIFT_TOL,
) -> ContractReport:
    """Static byte-drift check: stack-distance traffic against
    ``tune.cost.predict`` on the exact-divisible shape (mt*bm, nt*bn,
    kt*bk), same schedule, same capacity (``predict``'s on-chip capacity
    under ``hw`` unless given).  A relative deviation above ``tol`` is a
    ``byte-drift`` violation: one of the two locality implementations
    changed behaviour."""
    m, n, k = mt * bm, nt * bn, kt * bk
    cfg = TuneConfig(schedule=schedule, bm=bm, bn=bn, bk=bk, g=g)
    est = predict(cfg, m, n, k, dtype_bytes, hw=hw, capacity=capacity)
    cap = est.extras["capacity"]
    order = grid_schedule(schedule, mt, nt,
                          **schedule_extra_kwargs(schedule, g))
    static = stack_distance_traffic(
        order, kt,
        {"A": bm * bk * dtype_bytes, "B": bk * bn * dtype_bytes,
         "C": bm * bn * dtype_bytes},
        cap)
    rel = abs(static["total_bytes"] - est.traffic_bytes) \
        / max(est.traffic_bytes, 1.0)
    rep = ContractReport(
        subject=f"drift {schedule} {mt}x{nt}x{kt}"
                + (f" g={g}" if g else ""))
    rep.stats.update(
        model_bytes=float(est.traffic_bytes),
        static_bytes=float(static["total_bytes"]),
        rel_drift=float(rel), tol=tol, capacity=int(cap),
        hit_rate=static["hit_rate"], grid=(mt, nt, kt))
    if rel > tol:
        rep.add("byte-drift",
                f"static LRU stack-distance traffic "
                f"{static['total_bytes'] / 1e6:.3f} MB deviates "
                f"{rel:.1%} from the cost model's "
                f"{est.traffic_bytes / 1e6:.3f} MB "
                f"(tol {tol:.0%}) on {schedule} {mt}x{nt}x{kt}")
    return rep


def crosscheck_link_model(
    payload_bytes: float,
    ways: int,
    *,
    hops: float = 1.0,
    tol: float = STATIC_DRIFT_TOL,
) -> ContractReport:
    """Static link-traffic drift check: an explicit per-step ring
    simulation against the closed form
    :func:`repro_torch.tune.cost.ring_allreduce_link_bytes`.

    The simulation enumerates what a ring all-reduce sends: ``ways - 1``
    reduce-scatter steps then ``ways - 1`` all-gather steps, each step
    every rank forwarding one ``payload / ways`` chunk to its +1
    neighbour over ``hops`` physical links, summed chunk by chunk and
    rank by rank, then divided by ``ways``: the closed form is **per
    device** (the ranks are symmetric, every device's links carry 1/ways
    of the total, and that share bounds wall time).  The closed form
    collapses that to ``2 (w-1)/w * payload * hops``; a deviation above
    ``tol`` means the formula and the collective it models have
    diverged."""
    chunk = payload_bytes / max(ways, 1)
    total = 0.0
    for _phase in ("reduce-scatter", "all-gather"):
        for _step in range(max(ways - 1, 0)):
            for _rank in range(ways):
                total += chunk * hops  # one chunk over `hops` links
    static = total / max(ways, 1)      # symmetric ranks: per-device share
    model = ring_allreduce_link_bytes(payload_bytes, ways, hops)
    rel = abs(static - model) / max(model, 1.0) if ways > 1 else 0.0
    rep = ContractReport(subject=f"link-drift ring w={ways} h={hops}")
    rep.stats.update(model_bytes=float(model), static_bytes=float(static),
                     rel_drift=float(rel), tol=tol, ways=int(ways),
                     hops=float(hops))
    if ways > 1 and rel > tol:
        rep.add("link-drift",
                f"simulated ring traffic {static / 1e6:.3f} MB deviates "
                f"{rel:.1%} from ring_allreduce_link_bytes "
                f"{model / 1e6:.3f} MB (tol {tol:.0%}) at "
                f"ways={ways} hops={hops}")
    return rep
