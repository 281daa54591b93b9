"""Analytic cost model for GEMM schedule/tiling candidates (port of
``repro.tune.cost``).

The pre-filter of the autotuner: for a candidate :class:`TuneConfig` on
a given (M, N, K, dtype) problem it predicts

* device-memory traffic -- exact LRU block-cache replay of the
  candidate's grid schedule (``repro_torch.core.locality.
  matmul_hbm_traffic``), in a cache of ``hw.vmem_per_chip`` (under
  :data:`~repro_torch.core.energy.H100`, one block's shared memory);
* index-step cost -- the paper's per-translation op counts
  (``repro_torch.core.curves.*_cost_ops``), zero when the schedule is a
  prefetched table;
* compute time -- 2*M*N*K FLOPs at ``hw.peak_flops``.

Predicted time is ``max(t_compute, t_hbm) + t_index``.  The model is a
ranking device; the measured top-k adjudicates near-ties.  The model
logic is the reference's, number for number under the same ``HW``; only
the default part differs.  Large grids are probed by a schedule prefix
of ``max_sim_steps`` accesses, read traffic scaled by the remaining
fraction.
"""
from __future__ import annotations

import dataclasses
from dataclasses import asdict, dataclass, field

from repro_torch.core.curves import hilbert_index_cost_ops, morton_index_cost_ops
from repro_torch.core.energy import H100, clamp_f_scale
from repro_torch.core.locality import matmul_hbm_traffic
from repro_torch.core.schedule import grid_schedule, schedule_extra_kwargs

__all__ = ["TuneConfig", "CostEstimate", "EpilogueSpec", "AttnSpec",
           "CommSpec", "ring_allreduce_link_bytes", "predict",
           "predict_attn", "attn_decode_bytes", "attn_decode_flops",
           "epilogue_extra_bytes", "epilogue_flops",
           "vmem_block_capacity", "with_f_scale"]

# scalar-unit rate used for index-decode overhead (matches benchmarks/common)
_SCALAR_OPS_PER_S = 0.94e9

# per-tile index translation cost in scalar ops (paper §II, Table I lift)
_IDX_OPS = {
    "rowmajor": 2,
    "colmajor": 2,
    "boustrophedon": 4,
    "supertile": 8,
    "peano": 24,
    "xla": 0,
}


@dataclass(frozen=True)
class TuneConfig:
    """One point of the autotuner's search space.

    ``schedule="xla"`` is the library baseline (``ops.library_matmul``,
    no SFC kernel);
    ``g`` is the supertile factor and only meaningful for
    ``schedule="supertile"``.  ``f_scale`` is the DVFS operating point
    the candidate is scored at (DESIGN.md §8): it changes the modelled
    compute/index time and the dynamic compute energy, never the kernel
    code, so the paper's Fig. 5/6 "energy-optimal frequency < time-optimal
    frequency once memory-bound" crossover is searchable.
    """

    schedule: str = "morton"
    bm: int = 128
    bn: int = 128
    bk: int = 128
    use_prefetch: bool = True
    g: int = 0
    f_scale: float = 1.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TuneConfig":
        # pre-DVFS cache entries carry no f_scale -> nominal frequency
        return cls(**{k: d[k] for k in
                      ("schedule", "bm", "bn", "bk", "use_prefetch", "g",
                       "f_scale")
                      if k in d})

    def schedule_kwargs(self) -> dict:
        return schedule_extra_kwargs(self.schedule, self.g)

    def kernel_config(self) -> "TuneConfig":
        """The candidate with the DVFS dimension stripped: what the
        kernel launch actually keys on (and what gets wall-timed)."""
        if self.f_scale == 1.0:
            return self
        return dataclasses.replace(self, f_scale=1.0)


# elementwise VPU ops per output element for each fused activation --
# used only to account epilogue FLOPs in the energy estimate (time-wise
# the epilogue rides the flush and is fully overlapped)
_ACT_OPS = {"none": 0, "relu": 1, "silu": 4, "gelu": 8}


@dataclass(frozen=True)
class EpilogueSpec:
    """The post-matmul epilogue a GEMM call carries (DESIGN.md §9).

    The spec is *what math follows the dot*, independent of where it
    runs: fused into the kernel flush (SFC kernel) or as separate library
    elementwise ops after the library dot.  The cost model charges the
    two executions differently -- that asymmetry is what moves tuning
    winners once the epilogue is free.
    """

    bias: bool = False
    activation: str = "none"
    residual: bool = False

    @property
    def is_noop(self) -> bool:
        return (not self.bias and self.activation == "none"
                and not self.residual)

    def tag(self) -> str:
        """Stable short form for cache keys, e.g. ``bias+gelu+res``."""
        parts = []
        if self.bias:
            parts.append("bias")
        if self.activation != "none":
            parts.append(self.activation)
        if self.residual:
            parts.append("res")
        return "+".join(parts) or "none"


def epilogue_extra_bytes(ep: EpilogueSpec | None, m: int, n: int,
                         dtype_bytes: int, fused: bool) -> float:
    """HBM bytes the epilogue adds on top of the bare GEMM's traffic.

    Fused (kernel flush): only the *new inputs* are streamed -- the bias
    vector (N elements) and the residual array
    (M*N, each block read exactly once thanks to consecutive-index
    revisiting).  C is still written exactly once; there is no C re-read.

    Unfused (dot-then-elementwise): XLA fuses the elementwise chain into
    a single extra pass -- generous to the baseline -- but that pass
    still re-reads all of C and re-writes all of C on top of the same
    bias/residual input reads.  The fused path is therefore cheaper by
    exactly ``2*M*N*dtype_bytes``: the eliminated C round trip.
    """
    if ep is None or ep.is_noop:
        return 0.0
    bias_bytes = n * dtype_bytes if ep.bias else 0.0
    res_bytes = m * n * dtype_bytes if ep.residual else 0.0
    if fused:
        return bias_bytes + res_bytes
    return 2.0 * m * n * dtype_bytes + bias_bytes + res_bytes


def epilogue_flops(ep: EpilogueSpec | None, m: int, n: int) -> float:
    """Elementwise op count of the epilogue (bias add + activation +
    residual add), charged per output element.  Dwarfed by 2*M*N*K but
    kept so the energy model's core term stays consistent."""
    if ep is None or ep.is_noop:
        return 0.0
    ops = _ACT_OPS.get(ep.activation, 4)
    ops += 1 if ep.bias else 0
    ops += 1 if ep.residual else 0
    return float(ops) * m * n


@dataclass(frozen=True)
class AttnSpec:
    """The decode-attention cache layout a serving step runs under
    (DESIGN.md §10) -- the attention analogue of :class:`EpilogueSpec`.

    ``kind="contig"`` is the per-slot strip cache (every step streams
    ``slots * cache_len`` K/V rows whether a slot is live or not);
    ``kind="paged"`` gathers only the pages the block tables actually
    map.  The tag keys the tuner's cache (``.../attn=paged-p8``): a
    winner adjudicated on strip traffic must never be served to a paged
    caller, whose byte curve scales with occupancy instead of pool size.

    ``share`` is the effective-occupancy term continuous batching adds
    (DESIGN.md §11): the fraction of logically mapped pages that are
    *distinct physical* pages once copy-on-write prefix sharing
    deduplicates them (unique physical / logical mapped).  Shared pages
    are gathered once per step, not once per slot, so the paged byte
    curve scales by ``share``.  ``share=1.0`` (no sharing) is the
    historical behaviour and keeps the tag -- and therefore every
    existing cache key -- byte-for-byte unchanged.
    """

    kind: str = "contig"        # "contig" | "paged"
    page_size: int = 0
    share: float = 1.0          # unique-physical / logical mapped pages

    def __post_init__(self):
        if self.kind not in ("contig", "paged"):
            raise ValueError(f"unknown attention cache kind {self.kind!r}")
        if self.kind == "paged" and self.page_size < 1:
            raise ValueError("paged AttnSpec needs page_size >= 1")
        if not 0.0 < self.share <= 1.0:
            raise ValueError(
                f"share must be in (0, 1], got {self.share!r}")

    def tag(self) -> str:
        """Stable cache-key form: ``contig`` / ``paged-p8``; a sharing
        ratio below 1 appends ``-s<ratio>`` (``paged-p8-s0.62``) so
        shared-prefix winners never collide with unshared ones, while
        ``share=1.0`` keys stay byte-for-byte what they always were."""
        if self.kind == "contig":
            return self.kind
        tag = f"paged-p{self.page_size}"
        if self.share != 1.0:
            tag += f"-s{self.share:.2f}"
        return tag


def ring_allreduce_link_bytes(payload_bytes: float, ways: int,
                              hops: float = 1.0) -> float:
    """Modeled bytes-over-links of one ring all-reduce, per chip.

    Reduce-scatter + all-gather each move ``(ways - 1) / ways`` of the
    payload through every chip's outgoing link, hence the classic
    ``2 * (w - 1) / w`` factor.  ``hops`` is the mean *physical* ICI
    distance between logical ring neighbours under the mesh's curve
    embedding (:func:`repro.launch.mesh.link_distance`): a neighbour
    send that crosses ``hops`` torus links occupies ``hops`` links'
    bandwidth and pays ``hops`` links' per-byte energy -- the
    distance-weighted traffic term of the spatial-computer model
    (PAPERS.md), and what makes placement a tunable quantity rather
    than a no-op relabeling (DESIGN.md §15).
    """
    if ways <= 1:
        return 0.0
    return 2.0 * (ways - 1) / ways * float(payload_bytes) * float(hops)


@dataclass(frozen=True)
class CommSpec:
    """The collective a tuned call implies on a multi-chip mesh
    (DESIGN.md §15) -- the communication analogue of
    :class:`EpilogueSpec`.

    A row-parallel TP GEMM ends in an all-reduce of its (M, N) output
    over the ``ways``-ray "model" axis; an SP decode-attention step ends
    in the online-softmax psum.  ``ways`` is the ring size, ``hops`` the
    mean physical ICI hop count between ring neighbours under the mesh's
    curve embedding (:func:`repro.launch.mesh.link_distance`), ``axis``
    the logical mesh axis for provenance.  ``comm=None`` everywhere is
    the single-chip behaviour and keeps every existing cache key
    byte-for-byte unchanged (the ``share=1.0`` discipline of
    :class:`AttnSpec`).
    """

    ways: int
    hops: float = 1.0
    axis: str = "model"

    def __post_init__(self):
        if self.ways < 2:
            raise ValueError(
                f"CommSpec needs ways >= 2 (a 1-ray ring moves no "
                f"bytes; pass comm=None), got {self.ways}")
        if not self.hops > 0.0:
            raise ValueError(f"hops must be > 0, got {self.hops!r}")

    def tag(self) -> str:
        """Stable cache-key form, e.g. ``tp8-h2.50``: winners are keyed
        by ring size AND hop distance, so re-embedding the mesh along a
        different curve re-adjudicates instead of serving a winner tuned
        for another placement's byte curve."""
        return f"tp{self.ways}-h{self.hops:.2f}"

    def allreduce_link_bytes(self, payload_bytes: float) -> float:
        return ring_allreduce_link_bytes(payload_bytes, self.ways,
                                         self.hops)


def attn_decode_bytes(spec: AttnSpec, *, slots: int, cache_len: int,
                      lengths=None, n_kv_heads: int, d_head: int,
                      dtype_bytes: int = 4) -> float:
    """Modeled HBM bytes one decode step's attention moves (K + V reads
    plus gather metadata; the O(slots * d) q/out traffic is identical
    across layouts and omitted so the comparison isolates the cache).

    Contiguous: the batched SDPA streams every slot's whole
    ``cache_len`` strip -- dead slots and unreached positions included,
    because the strip is one dense array.

    Paged: only the allocated pages of each sequence move -- per slot
    ``ceil(len / page_size)`` pages of ``page_size`` tokens (the tail of
    the last page rides along: DMA granularity is a page) -- plus the
    block-table reads (4 bytes per entry).  At low occupancy this is
    strictly below the strip reads; at full occupancy it approaches
    them from above the table overhead (regression-tested).

    ``lengths``: per-slot live sequence lengths (0 = slot free); default
    assumes every slot full (worst case for the paged layout).

    ``spec.share`` scales the page bytes (not the table reads: every
    slot still walks its own block table) -- copy-on-write prefix
    sharing means only the *unique physical* pages move through HBM
    (DESIGN.md §11).  ``share=1.0`` is the unshared curve.
    """
    per_tok = 2.0 * n_kv_heads * d_head * dtype_bytes      # K + V
    if spec.kind == "contig":
        return float(slots) * cache_len * per_tok
    ps = spec.page_size
    if lengths is None:
        lengths = [cache_len] * slots
    pages = sum(-(-int(ln) // ps) for ln in lengths if ln > 0)
    table_entries = slots * (-(-cache_len // ps))
    return spec.share * pages * ps * per_tok + 4.0 * table_entries


def attn_decode_flops(*, slots: int, cache_len: int, lengths=None,
                      n_heads: int, d_head: int) -> float:
    """QK^T + PV flops of one decode step (2 GEMV sweeps per head)."""
    if lengths is None:
        lengths = [cache_len] * slots
    toks = sum(int(ln) for ln in lengths)
    return 4.0 * toks * n_heads * d_head


def predict_attn(
    cfg: TuneConfig,
    spec: AttnSpec,
    *,
    slots: int,
    cache_len: int,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    lengths=None,
    dtype_bytes: int = 4,
    hw=H100,
    comm: "CommSpec | None" = None,
) -> CostEstimate:
    """Cost estimate for one paged/contiguous decode-attention step at
    the candidate's DVFS point -- the attention analogue of
    :func:`predict`, consumed by the tuner's ``attn=`` keyspace
    (``repro.tune.autotune.resolve_attn_config``).  The gather is pure
    memory traffic (no LRU replay needed: each page moves exactly once),
    so the estimate is the roofline of the traffic model above.

    ``comm`` adds the SP online-softmax combine (DESIGN.md §15): the
    per-step psum of the f32 (o, l, m) partials -- ``slots * n_heads *
    (d_head + 2)`` floats -- hop-weighted over the mesh's embedding.
    """
    flops = attn_decode_flops(slots=slots, cache_len=cache_len,
                              lengths=lengths, n_heads=n_heads,
                              d_head=d_head)
    traffic = attn_decode_bytes(spec, slots=slots, cache_len=cache_len,
                                lengths=lengths, n_kv_heads=n_kv_heads,
                                d_head=d_head, dtype_bytes=dtype_bytes)
    ici_bytes = comm.allreduce_link_bytes(
        slots * n_heads * (d_head + 2) * 4.0) if comm else 0.0
    f = clamp_f_scale(hw, cfg.f_scale)
    t_compute = flops / (hw.peak_flops * f)
    t_hbm = traffic / hw.hbm_bw
    t_ici = ici_bytes / hw.ici_bw
    return CostEstimate(cfg, max(t_compute, t_hbm, t_ici), traffic,
                        t_compute, t_hbm, 0.0, flops,
                        ici_bytes=ici_bytes, t_ici=t_ici,
                        extras={"attn": spec.tag(), "slots": slots,
                                "cache_len": cache_len,
                                "comm": comm.tag() if comm else "none"})


@dataclass(frozen=True)
class CostEstimate:
    config: TuneConfig
    time: float            # seconds (model)
    traffic_bytes: float   # HBM read+write bytes (model)
    t_compute: float
    t_hbm: float
    t_index: float
    flops: float = 0.0
    ici_bytes: float = 0.0  # modeled bytes-over-links (CommSpec term)
    t_ici: float = 0.0
    extras: dict = field(default_factory=dict)


def vmem_block_capacity(bm: int, bn: int, bk: int, dtype_bytes: int,
                        hw=H100, frac: float = 0.8) -> int:
    """How many operand blocks an on-chip LRU of ``hw.vmem_per_chip`` can hold (conservative:
    sized by the largest block among A/B/C)."""
    biggest = max(bm * bk, bk * bn, bm * bn) * dtype_bytes
    return max(2, int(hw.vmem_per_chip * frac / biggest))


def _index_ops(schedule: str, mt: int, nt: int) -> int:
    if schedule == "morton":
        return morton_index_cost_ops()
    if schedule == "hilbert":
        # order of the bounding power-of-two square (8 -> 3, 9 -> 4)
        order = max(max(mt, nt) - 1, 1).bit_length()
        return hilbert_index_cost_ops(order)
    return _IDX_OPS.get(schedule, 8)


def predict(
    cfg: TuneConfig,
    m: int,
    n: int,
    k: int,
    dtype_bytes: int = 4,
    *,
    hw=H100,
    capacity: int | None = None,
    max_sim_steps: int = 200_000,
    epilogue: EpilogueSpec | None = None,
    fuse_epilogue: bool = True,
    comm: "CommSpec | None" = None,
) -> CostEstimate:
    """Model the time/traffic of ``cfg`` on an M x N x K GEMM.

    ``capacity`` overrides the LRU size in blocks (tests use small caches
    to reach the memory-bound regime on small grids); default is the
    on-chip-budget capacity for the candidate's block sizes.

    ``epilogue`` adds the post-matmul bias/activation/residual passes to
    the accounting (DESIGN.md §9).  Kernel candidates execute it fused
    into the flush (``fuse_epilogue=True``: no C re-read/re-write, the
    bias is a tiled (1, bn) input, the residual streams once); the
    ``"xla"`` library baseline always pays the unfused dot-then-
    elementwise pipeline -- an extra full C round trip.

    ``comm`` adds the collective the call implies on a multi-chip mesh
    (DESIGN.md §15): a row-parallel TP GEMM's (M, N) output all-reduce,
    hop-weighted by the mesh's curve embedding.  The term is identical
    across kernel candidates (the collective doesn't care how the tiles
    were walked) but NOT across DVFS points: ``time = max(t_compute,
    t_hbm, t_ici) + t_index``, so once the collective is the roofline,
    lowering f is time-free and the energy/EDP objectives slide down
    the frequency grid -- the mechanism that moves winners (tested in
    tests/test_comm_placement.py).
    """
    bm, bn, bk = cfg.bm, cfg.bn, cfg.bk
    mt = -(-m // bm)
    nt = -(-n // bn)
    kt = -(-k // bk)
    ep = None if (epilogue is None or epilogue.is_noop) else epilogue
    flops = 2.0 * m * n * k + epilogue_flops(ep, m, n)
    # DVFS: compute rate (tensor cores and index arithmetic) scales with core clock,
    # HBM bandwidth does not (core/energy.py) -- lowering f only costs
    # time once t_compute(f) crosses t_hbm
    f = clamp_f_scale(hw, cfg.f_scale)
    t_compute = flops / (hw.peak_flops * f)
    # the output all-reduce moves the same bytes whatever the schedule;
    # its time shares the roofline max (collectives overlap the k-loop
    # at best, the flush at worst), its bytes feed the e_ici energy term
    ici_bytes = comm.allreduce_link_bytes(m * n * dtype_bytes) \
        if comm else 0.0
    t_ici = ici_bytes / hw.ici_bw

    if cfg.schedule == "xla":
        # tuned-library baseline: assume near-roofline traffic (each
        # operand streamed once, output written once) -- plus the
        # unfused epilogue pipeline's extra passes when one is attached
        traffic = dtype_bytes * (m * k + k * n + m * n) \
            + epilogue_extra_bytes(ep, m, n, dtype_bytes, fused=False)
        t_hbm = traffic / hw.hbm_bw
        return CostEstimate(cfg, max(t_compute, t_hbm, t_ici), traffic,
                            t_compute, t_hbm, 0.0, flops,
                            ici_bytes=ici_bytes, t_ici=t_ici,
                            extras={"epilogue": ep.tag() if ep else "none",
                                    "epilogue_fused": False,
                                    "comm": comm.tag() if comm else "none"})

    if capacity is None:
        capacity = vmem_block_capacity(bm, bn, bk, dtype_bytes, hw=hw)
    order = grid_schedule(cfg.schedule, mt, nt, **cfg.schedule_kwargs())
    t_tiles = len(order)

    # prefix probe for huge grids (regime-preserving, see module docstring)
    steps = t_tiles * kt * 2
    if steps > max_sim_steps:
        probe_tiles = max(capacity, max_sim_steps // (2 * kt))
        probe = order[:probe_tiles]
    else:
        probe = order
    blocks = {
        "A": bm * bk * dtype_bytes,
        "B": bk * bn * dtype_bytes,
        "C": bm * bn * dtype_bytes,
    }
    r = matmul_hbm_traffic(probe, kt, blocks, model="lru",
                           capacity=capacity)
    scale = t_tiles / len(probe)
    read_bytes = r["read_bytes"] * scale
    write_bytes = t_tiles * blocks["C"]
    ep_bytes = epilogue_extra_bytes(ep, m, n, dtype_bytes,
                                    fused=fuse_epilogue)
    traffic = read_bytes + write_bytes + ep_bytes
    t_hbm = traffic / hw.hbm_bw

    t_index = 0.0
    if not cfg.use_prefetch:
        t_index = t_tiles * kt * _index_ops(cfg.schedule, mt, nt) \
            / (_SCALAR_OPS_PER_S * f)

    return CostEstimate(
        cfg,
        max(t_compute, t_hbm, t_ici) + t_index,
        traffic,
        t_compute,
        t_hbm,
        t_index,
        flops,
        ici_bytes=ici_bytes,
        t_ici=t_ici,
        extras={"misses": r["misses"] * scale, "probe_tiles": len(probe),
                "grid": (mt, nt, kt), "capacity": capacity,
                "epilogue": ep.tag() if ep else "none",
                "epilogue_fused": bool(fuse_epilogue and ep),
                "epilogue_bytes": ep_bytes,
                "comm": comm.tag() if comm else "none"},
    )


def with_f_scale(est: CostEstimate, f_scale: float,
                 hw=H100) -> CostEstimate:
    """Re-derive ``est`` at a different DVFS point without re-simulating.

    Traffic is frequency-invariant; compute and index time scale as 1/f
    (tensor cores and index arithmetic on the core clock), memory and link time are
    untouched (HBM and ICI run on their own clocks).  This is what lets
    the autotuner expand every kernel candidate over the whole frequency
    grid at the cost of ONE LRU replay.
    """
    f_new = clamp_f_scale(hw, f_scale)
    f_old = clamp_f_scale(hw, est.config.f_scale)
    if f_new == f_old:
        return est
    ratio = f_old / f_new
    t_compute = est.t_compute * ratio
    t_index = est.t_index * ratio
    return dataclasses.replace(
        est,
        config=dataclasses.replace(est.config, f_scale=f_new),
        time=max(t_compute, est.t_hbm, est.t_ici) + t_index,
        t_compute=t_compute,
        t_index=t_index,
    )
