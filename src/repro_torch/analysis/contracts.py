"""Kernel contract checker, the part the tuner calls (port of
``repro.analysis.contracts``: ``Violation``, ``ContractReport``,
``gemm_vmem_bytes``, ``check_gemm_contract``, ``check_attn_contract``).

Host arithmetic that proves, for a :class:`~repro_torch.tune.cost.
TuneConfig` on a concrete GEMM shape (or a decode-attention problem on
a block table), what a kernel would otherwise refuse at launch:

* **structure** -- positive shape and blocks, a known schedule;
* **on-chip budget** -- against ``hw.vmem_per_chip``.  Under the
  reference's parts, the reference kernel's working set (A, B and C
  blocks plus the f32 accumulator and epilogue tiles) within
  ``VMEM_FRAC`` of it.  Under :data:`~repro_torch.core.energy.H100`,
  the port's SFC kernel (``repro_torch.kernels.sfc_matmul``) is the
  kernel: its wrapper's rule, an A (bm, bk) and a B (bk, bn) tile within
  one block's shared memory, and its tile rule, bm and bn multiples of
  16 up to 128 (``kernel-tile``);
  For a paged decode attention under the H100 the kernel is the port's
  B2 (``repro_torch.kernels.paged_attention``): the dynamic shared
  memory of the plan it would launch (``attn_smem_bytes``) within one
  block's limit, and its d_head rule;
* **closed-form decode** -- ``use_prefetch=False`` needs a square
  power-of-two grid for morton/hilbert;
* **grid replay** (``level="full"``) -- the schedule is a bijection
  onto the tile grid, and the closed-form decode equals the table.

:func:`gemm_launch_key` names what the port's kernel is actually given
for a candidate, so the tuner can collapse candidates that are the
same launch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.energy import H100
from repro_torch.core.schedule import SCHEDULES, grid_schedule, is_pow2

__all__ = ["Violation", "ContractReport", "VMEM_FRAC", "gemm_vmem_bytes",
           "port_kernel_hw", "gemm_launch_key",
           "verify_order", "check_gemm_contract", "check_attn_contract"]

# fraction of the on-chip budget the reference kernel's working set may
# claim (its semaphores, tables and spills live in the rest)
VMEM_FRAC = 0.9

# how large a grid the full-level replay decodes in closed form
_MAX_DECODE_TILES = 4096


@dataclass(frozen=True)
class Violation:
    """One broken invariant: a stable machine-readable ``code`` plus a
    diagnostic.  Codes: the reference's (``bad-config``,
    ``unknown-schedule``, ``vmem-budget``, ``no-closed-form``,
    ``oob-tile``, ``write-race``, ``missed-tile``, ``decode-mismatch``,
    ``page-oob``, ``page-alias``, ``zero-row-write``, ``table-extent``,
    ``gqa-divisibility``) and the port kernel's ``kernel-tile``."""

    code: str
    message: str

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message}


@dataclass
class ContractReport:
    subject: str
    violations: list[Violation] = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def codes(self) -> set[str]:
        return {v.code for v in self.violations}

    def add(self, code: str, message: str) -> None:
        self.violations.append(Violation(code, message))

    def to_dict(self) -> dict:
        return {"subject": self.subject, "ok": self.ok,
                "violations": [v.to_dict() for v in self.violations],
                "stats": self.stats}

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise AssertionError(
                f"{self.subject}: {len(self.violations)} contract "
                f"violation(s): "
                + "; ".join(v.message for v in self.violations))


def port_kernel_hw(hw) -> bool:
    """Whether ``hw`` is the part the port's kernels run on (the H100):
    candidates must then be launches the port's SFC kernel takes."""
    return hw.name == H100.name


def gemm_vmem_bytes(cfg, dtype_bytes: int = 4, epilogue=None) -> int:
    """The reference kernel's resident working set of one grid step:
    A (bm, bk) + B (bk, bn) + staged C (bm, bn) in the operand dtype,
    the (bm, bn) f32 accumulator, and a fused epilogue's (1, bn) bias
    tile and (bm, bn) residual block."""
    bm, bn, bk = cfg.bm, cfg.bn, cfg.bk
    need = (bm * bk + bk * bn + bm * bn) * dtype_bytes + bm * bn * 4
    if epilogue is not None and not epilogue.is_noop:
        if epilogue.bias:
            need += bn * dtype_bytes
        if epilogue.residual:
            need += bm * bn * dtype_bytes
    return need


def gemm_launch_key(cfg, m: int, n: int, k: int,
                    dtype_bytes: int = 4) -> tuple:
    """What the port's SFC kernel is given for ``cfg`` on an M x N x K
    GEMM: candidates with equal keys are the same launch.  ``bk`` sizes
    no buffer of the kernel.  On the rows path (M <= 8, bn = 128, N a
    multiple of 8, K of a 16-byte vector; ``_rows_path``) every tile is
    a full-K 128-column strip split over ``split_plan``'s cluster, which
    depends on the shape alone, so ``bm`` does not reach the kernel
    either; what differs is the tile order (the table, or the closed-form
    decode's mode)."""
    from repro_torch.kernels.sfc_matmul import _rows_path

    bm, bn = cfg.bm, cfg.bn
    mt, nt = -(-m // bm), -(-n // bn)
    rows = _rows_path(m, n, k, bn, dtype_bytes)
    if cfg.use_prefetch:
        order = grid_schedule(cfg.schedule, mt, nt,
                              **cfg.schedule_kwargs()).tobytes()
    else:
        order = ("decode", cfg.schedule)
    return ("rows", order) if rows else ("tile", bm, bn, order)


def verify_order(order, rows: int, cols: int, *,
                 subject: str | None = None) -> ContractReport:
    """Prove ``order`` is a bijection onto the rows x cols grid (port of
    ``repro.analysis.schedule.verify_order``)."""
    rep = ContractReport(subject=subject or f"order {rows}x{cols}")
    arr = np.asarray(order)
    rep.stats.update(rows=rows, cols=cols, tiles=int(arr.shape[0]))
    if arr.ndim != 2 or arr.shape[1] != 2:
        rep.add("bad-config", f"order must be (T, 2), got shape {arr.shape}")
        return rep
    if arr.shape[0] != rows * cols:
        rep.add("missed-tile" if arr.shape[0] < rows * cols
                else "write-race",
                f"order has {arr.shape[0]} entries for a "
                f"{rows}x{cols} = {rows * cols}-tile grid")
    oob = (arr[:, 0] < 0) | (arr[:, 0] >= rows) \
        | (arr[:, 1] < 0) | (arr[:, 1] >= cols)
    for t in np.flatnonzero(oob)[:8]:
        rep.add("oob-tile",
                f"step {int(t)} visits tile ({int(arr[t, 0])}, "
                f"{int(arr[t, 1])}) outside {rows}x{cols}")
    ok = arr[~oob]
    counts = np.bincount(ok[:, 0] * cols + ok[:, 1], minlength=rows * cols)
    for flat in np.flatnonzero(counts > 1)[:8]:
        rep.add("write-race",
                f"output tile ({int(flat) // cols}, {int(flat) % cols}) "
                f"is written {int(counts[flat])} times: write-write "
                f"race between grid steps")
    for flat in np.flatnonzero(counts == 0)[:8]:
        rep.add("missed-tile",
                f"output tile ({int(flat) // cols}, {int(flat) % cols}) "
                f"is never visited")
    return rep


def _closed_form_ok(schedule: str, mt: int, nt: int) -> bool:
    if schedule in ("rowmajor", "colmajor"):
        return True
    if schedule in ("morton", "hilbert"):
        return mt == nt and is_pow2(mt)
    return False


def check_gemm_contract(
    cfg,
    m: int,
    n: int,
    k: int,
    *,
    dtype_bytes: int = 4,
    epilogue=None,
    hw=H100,
    vmem_frac: float = VMEM_FRAC,
    level: str = "full",
) -> ContractReport:
    """Check ``cfg`` against an M x N x K GEMM.

    ``level="fast"`` runs the O(1) checks (structure, on-chip budget,
    the port kernel's tile rule under the H100, closed-form existence):
    what the tuner applies per candidate.  ``level="full"`` also
    replays the schedule over the whole ceil-divided grid and, for
    closed-form configs, holds the kernel's decode to the table."""
    rep = ContractReport(
        subject=f"gemm {m}x{n}x{k} {cfg.schedule} "
                f"bm={cfg.bm} bn={cfg.bn} bk={cfg.bk}")
    if level not in ("fast", "full"):
        raise ValueError(f"unknown level {level!r}")
    if min(m, n, k) < 1:
        rep.add("bad-config", f"non-positive GEMM shape {(m, n, k)}")
        return rep
    if cfg.schedule == "xla":
        rep.stats.update(grid=None, vmem_bytes=0, note="library baseline")
        return rep  # no SFC kernel: nothing to prove
    if min(cfg.bm, cfg.bn, cfg.bk) < 1:
        rep.add("bad-config", f"non-positive blocks "
                              f"{(cfg.bm, cfg.bn, cfg.bk)}")
        return rep
    if cfg.schedule not in SCHEDULES:
        rep.add("unknown-schedule",
                f"schedule {cfg.schedule!r} not in {sorted(SCHEDULES)}")
        return rep

    mt, nt, kt = -(-m // cfg.bm), -(-n // cfg.bn), -(-k // cfg.bk)
    ep = None if (epilogue is None or epilogue.is_noop) else epilogue
    port = port_kernel_hw(hw)
    if port:
        from repro_torch.kernels.sfc_matmul import tile_ok, tile_smem_bytes

        # the port kernel's wrapper refuses past one block's shared
        # memory, all of it (no fraction: the rule is the wrapper's)
        need = tile_smem_bytes(cfg.bm, cfg.bn, cfg.bk, dtype_bytes)
        budget = int(hw.vmem_per_chip)
    else:
        need = gemm_vmem_bytes(cfg, dtype_bytes, ep)
        budget = int(hw.vmem_per_chip * vmem_frac)
    rep.stats.update(
        grid=(mt, nt, kt), tiles=mt * nt,
        padded_shape=(mt * cfg.bm, nt * cfg.bn, kt * cfg.bk),
        vmem_bytes=need, vmem_budget=budget,
        epilogue=ep.tag() if ep else "none",
        tile_aligned=(cfg.bm % 8 == 0 and cfg.bn % 128 == 0
                      and cfg.bk % 128 == 0),
    )
    if need > budget:
        rep.add("vmem-budget",
                f"working set {need / 1e6:.3f} MB exceeds "
                f"{budget / 1e6:.3f} MB of {hw.name}'s on-chip budget: "
                f"blocks bm={cfg.bm} bn={cfg.bn} bk={cfg.bk}"
                + (f" + epilogue {ep.tag()}" if ep and not port else ""))
    if port and not tile_ok(cfg.bm, cfg.bn):
        rep.add("kernel-tile",
                f"the SFC kernel takes bm and bn in multiples of 16 up to "
                f"128, got {cfg.bm}x{cfg.bn}")
    if not cfg.use_prefetch and not _closed_form_ok(cfg.schedule, mt, nt):
        rep.add("no-closed-form",
                f"use_prefetch=False needs a closed-form decode; "
                f"{cfg.schedule!r} has none on a {mt}x{nt} grid "
                f"(morton/hilbert need a square power-of-two grid)")
    if level == "fast" or rep.violations:
        return rep

    # ---- full level: replay the permutation --------------------------
    order = grid_schedule(cfg.schedule, mt, nt, **cfg.schedule_kwargs())
    sub = verify_order(order, mt, nt, subject=rep.subject)
    rep.violations.extend(sub.violations)
    rep.stats["order_verified"] = sub.ok
    # with the permutation a bijection onto [0, mt) x [0, nt), every
    # tile's A rows, B columns and output are in bounds and each output
    # tile is written by exactly one step
    rep.stats["index_maps"] = {
        "a": "(i, kk)", "b": "(kk, j)", "o": "(i, j)", "bias": "(0, j)"}
    if not cfg.use_prefetch and sub.ok:
        if mt * nt <= _MAX_DECODE_TILES:
            import torch

            from repro_torch.kernels.sfc_matmul import decode_step

            i, j = decode_step(torch.arange(mt * nt), cfg.schedule, mt, nt)
            got = torch.stack([i, j], dim=1).numpy()
            bad = np.flatnonzero((got != np.asarray(order)).any(axis=1))
            if len(bad):
                t = int(bad[0])
                rep.add("decode-mismatch",
                        f"closed-form decode_step({t}) = "
                        f"({int(got[t, 0])}, {int(got[t, 1])}) but the "
                        f"schedule table says "
                        f"{tuple(int(x) for x in order[t])}")
            rep.stats["decode_verified"] = not rep.violations
        else:
            rep.stats["decode_verified"] = "skipped (grid > " \
                f"{_MAX_DECODE_TILES} tiles)"
    return rep


def _attn_vmem_bytes(n_heads: int, n_kv_heads: int, d_head: int,
                     page_size: int, dtype_bytes: int) -> int:
    """Working set of one reference ``paged_attention`` grid step: the
    q block and the output block (1, h, d), one K and one V page block
    (page, hkv, d), and the f32 online-softmax scratch."""
    g = n_heads // max(n_kv_heads, 1)
    io = (2 * n_heads * d_head
          + 2 * page_size * n_kv_heads * d_head) * dtype_bytes
    scratch = (2 * n_kv_heads * g + n_kv_heads * g * d_head) * 4
    return io + scratch


def check_attn_contract(
    spec,
    *,
    block_table=None,
    num_pages: int | None = None,
    lengths=None,
    dtype_bytes: int = 4,
    hw=H100,
    vmem_frac: float = VMEM_FRAC,
) -> ContractReport:
    """Check a decode-attention problem (duck-typed
    :class:`~repro_torch.tune.autotune.DecodeAttnSpec`: ``slots``,
    ``cache_len``, ``n_heads``, ``n_kv_heads``, ``d_head``, ``attn``).

    Always: GQA divisibility and the paged working set against the
    on-chip budget.  Under the reference's parts that is one reference
    grid step's (q, output, a K and a V page block and the softmax
    scratch) within ``vmem_frac`` of the budget; under the H100
    (:func:`port_kernel_hw`) it is what the port's B2 allocates for the
    plan it would launch (``attn_smem_bytes`` at ``attn_stage_pages``,
    the ring of K/V stages or the merge buffers, the block table and
    the barriers) against one block's dynamic shared-memory limit, all
    of it, as ``check_gemm_contract`` holds the GEMM's tiles; and B2's
    d_head limit (``kernel-tile``).  With ``block_table`` (slots x
    width, page ids, -1 = unmapped) and ``num_pages``: every entry in
    ``[-1, num_pages)``
    (``page-oob``), no slot maps a page twice (``page-alias``), and a
    live slot's write target (position ``lengths[s] - 1``) is mapped
    (``zero-row-write``) inside the table (``table-extent``)."""
    attn = spec.attn
    rep = ContractReport(
        subject=f"attn slots={spec.slots} cache_len={spec.cache_len} "
                f"{attn.tag()}")
    if spec.slots < 1 or spec.cache_len < 1:
        rep.add("bad-config",
                f"non-positive slots/cache_len "
                f"{(spec.slots, spec.cache_len)}")
        return rep
    if spec.n_kv_heads < 1 or spec.n_heads % spec.n_kv_heads != 0:
        rep.add("gqa-divisibility",
                f"n_heads={spec.n_heads} not a multiple of "
                f"n_kv_heads={spec.n_kv_heads}")
        return rep
    if attn.kind != "paged":
        rep.stats["note"] = "contiguous layout: no block-table contract"
        return rep

    ps = attn.page_size
    if port_kernel_hw(hw):
        from repro_torch.kernels.paged_attention import _MAX_DH, \
            _SMEM_LIMIT, attn_smem_bytes, attn_stage_pages

        stage = attn_stage_pages(ps, spec.d_head, dtype_bytes)
        need = attn_smem_bytes(ps, spec.d_head, dtype_bytes, stage,
                               spec.n_heads // spec.n_kv_heads)
        budget = _SMEM_LIMIT
        rep.stats["stage_pages"] = stage
        if spec.d_head > _MAX_DH:
            rep.add("kernel-tile",
                    f"the paged-attention kernel takes d_head <= "
                    f"{_MAX_DH}, got {spec.d_head}")
    else:
        need = _attn_vmem_bytes(spec.n_heads, spec.n_kv_heads, spec.d_head,
                                ps, dtype_bytes)
        budget = int(hw.vmem_per_chip * vmem_frac)
    rep.stats.update(page_size=ps, vmem_bytes=need, vmem_budget=budget)
    if need > budget:
        rep.add("vmem-budget",
                f"paged-attention working set {need / 1e6:.3f} MB "
                f"exceeds {budget / 1e6:.3f} MB (page_size={ps}, "
                f"heads={spec.n_heads}/{spec.n_kv_heads}, "
                f"d_head={spec.d_head})")
    if block_table is None:
        return rep
    if num_pages is None:
        raise ValueError("block_table checks need num_pages")

    bt = np.asarray(block_table)
    rep.stats.update(num_pages=int(num_pages),
                     table_shape=tuple(bt.shape),
                     mapped=int((bt >= 0).sum()))
    bad = np.argwhere((bt < -1) | (bt >= num_pages))
    for s, p in bad[:8]:
        rep.add("page-oob",
                f"slot {int(s)} entry {int(p)} maps page "
                f"{int(bt[s, p])} outside [0, {num_pages})")
    for s in range(bt.shape[0]):
        row = bt[s][bt[s] >= 0]
        if len(row) != len(set(row.tolist())):
            vals, counts = np.unique(row, return_counts=True)
            dup = int(vals[counts > 1][0])
            rep.add("page-alias",
                    f"slot {s} maps page {dup} at more than one "
                    f"logical position (double-write within the slot)")
    if lengths is not None:
        for s, ln in enumerate(lengths):
            if ln <= 0:
                continue
            pg = (int(ln) - 1) // ps
            if pg >= bt.shape[1]:
                rep.add("table-extent",
                        f"slot {s} write target (pos {int(ln) - 1}) "
                        f"falls in page {pg} beyond the table width "
                        f"{bt.shape[1]}")
            elif bt[s, pg] < 0:
                rep.add("zero-row-write",
                        f"slot {s} write target (pos {int(ln) - 1}, "
                        f"page {pg}) is unmapped: the decode write "
                        f"would land in the reserved zero row")
    return rep
