"""Block-trace cache simulation (port of ``repro.core.locality``): the
reproduction's "cachegrind" (paper §IV-A).

The paper probes locality with valgrind/cachegrind last-level miss
counts; here the quantity is block traffic between device memory and a
block cache.  This module replays a block access trace (from
:func:`repro_torch.core.schedule.matmul_block_trace`) through three
cache models:

* ``lru``          -- classic LRU of ``capacity`` blocks: a hardware
                      cache (paper-faithful) or a software block cache.
* ``consecutive``  -- capacity 1 per *operand*: a fetch is elided only if
                      the immediately preceding access to the same
                      operand used the same block (the reference's Pallas
                      pipeline "revisiting" rule).
* ``direct``       -- direct-mapped cache with ``capacity`` sets over
                      Python's ``hash`` of the block key.  String hashing
                      is salted per process (``PYTHONHASHSEED``), so its
                      counts differ from one process to the next; the
                      software-cached GEMM (B4) keys its slots by block id
                      instead (:func:`repro_torch.kernels.sfc_matmul_cached.dma_counts`).

All counters are in *block* units; multiply by block bytes for traffic.
Host Python only: nothing here touches a device.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from .schedule import matmul_block_trace

__all__ = ["CacheStats", "simulate_lru", "simulate_consecutive",
           "simulate_direct", "simulate", "matmul_hbm_traffic"]


@dataclass
class CacheStats:
    accesses: int = 0
    misses: int = 0
    per_tensor_misses: dict = field(default_factory=dict)

    @property
    def hits(self) -> int:
        return self.accesses - self.misses

    @property
    def miss_rate(self) -> float:
        return self.misses / max(self.accesses, 1)


def simulate_lru(trace, capacity: int) -> CacheStats:
    """LRU over (tensor, r, c) block keys with ``capacity`` block slots."""
    cache: OrderedDict = OrderedDict()
    st = CacheStats()
    for key in trace:
        st.accesses += 1
        if key in cache:
            cache.move_to_end(key)
        else:
            st.misses += 1
            st.per_tensor_misses[key[0]] = st.per_tensor_misses.get(key[0], 0) + 1
            cache[key] = True
            if len(cache) > capacity:
                cache.popitem(last=False)
    return st


def simulate_consecutive(trace) -> CacheStats:
    """Revisiting model: one slot per tensor name."""
    last: dict = {}
    st = CacheStats()
    for key in trace:
        st.accesses += 1
        t = key[0]
        if last.get(t) != key:
            st.misses += 1
            st.per_tensor_misses[t] = st.per_tensor_misses.get(t, 0) + 1
            last[t] = key
    return st


def simulate_direct(trace, capacity: int) -> CacheStats:
    """Direct-mapped cache with ``capacity`` sets over a cheap block hash
    (``hash(key) % capacity``: reproducible only within one process)."""
    sets: dict = {}
    st = CacheStats()
    for key in trace:
        st.accesses += 1
        idx = hash(key) % capacity
        if sets.get(idx) != key:
            st.misses += 1
            st.per_tensor_misses[key[0]] = st.per_tensor_misses.get(key[0], 0) + 1
            sets[idx] = key
    return st


def simulate(trace, model: str = "lru", capacity: int = 8) -> CacheStats:
    if model == "lru":
        return simulate_lru(trace, capacity)
    if model == "consecutive":
        return simulate_consecutive(trace)
    if model == "direct":
        return simulate_direct(trace, capacity)
    raise ValueError(f"unknown cache model {model!r}")


def matmul_hbm_traffic(
    order,
    kt: int,
    block_bytes: dict,
    model: str = "lru",
    capacity: int = 8,
    k_inner: bool = True,
) -> dict:
    """Device-memory traffic (bytes) of a blocked matmul under a schedule
    and a cache model.

    ``block_bytes`` maps tensor name -> bytes per block, e.g.
    ``{"A": bm*bk*4, "B": bk*bn*4, "C": bm*bn*4}``.  C blocks are counted
    once for the final write regardless of cache model (write-back of the
    accumulator), plus read misses if k is outermost.
    """
    trace = matmul_block_trace(order, kt, k_inner=k_inner)
    reads = [a for a in trace if a[0] != "C"] if k_inner else trace
    st = simulate(reads, model=model, capacity=capacity)
    read_bytes = sum(
        st.per_tensor_misses.get(t, 0) * b
        for t, b in block_bytes.items()
        if t != "C"
    )
    if not k_inner:
        read_bytes += st.per_tensor_misses.get("C", 0) * block_bytes["C"]
    write_bytes = len(order) * block_bytes["C"]
    return {
        "stats": st,
        "read_bytes": read_bytes,
        "write_bytes": write_bytes,
        "total_bytes": read_bytes + write_bytes,
        "misses": st.misses,
    }
