"""Paged KV cache: page allocator and Morton page layout (port of
``repro.serve.paged_kv``, without prefix sharing).

Each decode slot owns a block table mapping logical page index ->
logical page id; pages live in one shared physical pool.  Release pushes
page ids back on a LIFO free list (no data moves); admission is bounded
by the pool.  The ``(layer, page)`` grid is laid out along a Morton
curve (:func:`page_permutation`), the paper's locality technique applied
to the KV pool.  The allocator is host-side numpy; the pool tensors live
on the serving device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schedule import grid_schedule
from repro_torch.device import resolve_device

from .state import DecodeState, KVLayout

__all__ = ["PageAllocator", "PoolExhausted", "page_permutation",
           "init_paged_decode_state", "init_paged_serving", "zero_row_index",
           "pages_needed", "physical_rows", "default_pool_pages",
           "default_slot_pages"]


class PoolExhausted(RuntimeError):
    """The free list is empty (distinct from the block-table extent
    error, so preemption retries only what it can cure)."""


def pages_needed(length: int, page_size: int) -> int:
    """Pages required to hold ``length`` tokens (ceil division)."""
    return -(-int(length) // int(page_size))


def page_permutation(n_layers: int, num_pages: int) -> np.ndarray:
    """Physical row of logical ``(layer, page)``: its position along the
    Morton traversal of the (n_layers, num_pages) grid."""
    order = grid_schedule("morton", n_layers, num_pages)
    perm = np.empty((n_layers, num_pages), np.int32)
    perm[order[:, 0], order[:, 1]] = np.arange(len(order), dtype=np.int32)
    return perm


def zero_row_index(k_pages) -> int:
    """The reserved all-zeros physical row (table entries of -1 map
    here)."""
    return k_pages.shape[0] - 1


class PageAllocator:
    """Free-list page allocator with per-slot block tables (host-side).

    Logical page ids index the ``num_pages`` pool; the Morton
    permutation to physical rows is applied at gather time.  The free
    list is LIFO, so a released slot's pages go to the next admission
    first.  Pages are reference counted as in the reference; without
    prefix sharing every live page has refcount 1.  :meth:`state_dict`
    keeps the reference's snapshot format (its prefix-sharing fields
    stay empty).
    """

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int | None = None):
        if num_pages < 1 or page_size < 1 or slots < 1:
            raise ValueError((num_pages, page_size, slots))
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_pages_per_slot = int(max_pages_per_slot or num_pages)
        # LIFO free list: pop() hands out the most recently freed page
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self.block_table = np.full(
            (self.slots, self.max_pages_per_slot), -1, np.int32)
        self.seq_lens = np.zeros(self.slots, np.int32)
        self.ref = np.zeros(self.num_pages, np.int32)
        self._ever_freed: set[int] = set()
        self.stats = {"allocated": 0, "freed": 0, "reused": 0,
                      "cow_forks": 0, "prefix_hits": 0, "shared_pages": 0,
                      "revived": 0}

    # ------------------------------------------------------------- queries --
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def was_freed(self, pid: int) -> bool:
        """True if ``pid`` has been freed before: its rows may hold a
        previous occupant's K/V and need a scrub on reuse."""
        return pid in self._ever_freed

    def slot_pages(self, slot: int) -> list[int]:
        return [int(p) for p in self.block_table[slot] if p >= 0]

    # ----------------------------------------------------------- mutation --
    def _check_extent(self, slot: int, page_idx: int) -> None:
        if page_idx >= self.max_pages_per_slot:
            raise RuntimeError(
                f"slot {slot} outgrew its block table "
                f"({page_idx} >= {self.max_pages_per_slot} pages); "
                f"raise max_pages_per_slot / num_pages")

    def _pop_free(self) -> int:
        if self._free:
            return self._free.pop()
        raise PoolExhausted(
            f"KV page pool exhausted ({self.num_pages} pages of "
            f"{self.page_size} tokens); raise num_pages or lower "
            f"concurrency")

    def _alloc_one(self, slot: int, page_idx: int) -> int:
        self._check_extent(slot, page_idx)
        pid = self._pop_free()
        self.block_table[slot, page_idx] = pid
        self.ref[pid] = 1
        self.stats["allocated"] += 1
        if pid in self._ever_freed:
            self.stats["reused"] += 1
        return pid

    def ensure(self, slot: int, position: int) -> list[int]:
        """Allocate the page holding ``position`` for ``slot`` if absent;
        returns the newly allocated page ids (empty on a hit).  Gap
        pages are not allocated: they read the shared zero row."""
        page_idx = int(position) // self.page_size
        self._check_extent(slot, page_idx)
        if self.block_table[slot, page_idx] >= 0:
            self.seq_lens[slot] = max(self.seq_lens[slot], position + 1)
            return []
        pid = self._alloc_one(slot, page_idx)
        self.seq_lens[slot] = max(self.seq_lens[slot], position + 1)
        return [pid]

    def ensure_range(self, slot: int, length: int) -> list[int]:
        """Allocate pages covering positions [0, length) (prefill)."""
        new: list[int] = []
        for pg in range(pages_needed(length, self.page_size)):
            self._check_extent(slot, pg)
            if self.block_table[slot, pg] < 0:
                new.append(self._alloc_one(slot, pg))
        self.seq_lens[slot] = max(self.seq_lens[slot], length)
        return new

    def release(self, slot: int) -> list[int]:
        """Drop ``slot``'s references (metadata only); a page returns to
        the free list at refcount zero.  Returns the pages freed."""
        freed: list[int] = []
        for pid in self.slot_pages(slot):
            self.ref[pid] -= 1
            if self.ref[pid] < 0:
                raise RuntimeError(f"page {pid}: negative refcount")
            if self.ref[pid] > 0:
                continue
            self._free.append(pid)
            self._ever_freed.add(pid)
            freed.append(pid)
        self.stats["freed"] += len(freed)
        self.block_table[slot] = -1
        self.seq_lens[slot] = 0
        return freed

    def check_invariants(self) -> None:
        """Every pool page is either free exactly once or referenced by
        exactly ``ref`` table entries, never both; raises RuntimeError
        naming the first offending page."""
        seen: set = set()
        for pid in self._free:
            if pid in seen:
                raise RuntimeError(
                    f"page {pid}: double-free (appears more than once "
                    f"across the free pools)")
            seen.add(pid)
        counts = np.zeros(self.num_pages, np.int64)
        for s in range(self.slots):
            for pid in self.slot_pages(s):
                counts[pid] += 1
        for pid in range(self.num_pages):
            ref, cnt = int(self.ref[pid]), int(counts[pid])
            if ref < 0:
                raise RuntimeError(f"page {pid}: negative refcount {ref}")
            if pid in seen:
                if ref != 0 or cnt != 0:
                    raise RuntimeError(
                        f"page {pid}: on a free pool but still referenced "
                        f"(ref={ref}, mapped by {cnt} table entries)")
            elif cnt == 0:
                raise RuntimeError(
                    f"page {pid}: orphaned -- mapped by no slot and absent "
                    f"from both free pools")
            elif ref != cnt:
                raise RuntimeError(
                    f"page {pid}: refcount {ref} != {cnt} mapping table "
                    f"entries")

    def state_dict(self) -> dict:
        """Allocator metadata as JSON-native values, in the reference's
        snapshot format; free-list order is kept."""
        return {
            "free": [int(p) for p in self._free],
            "free_cached": [],
            "block_table": self.block_table.tolist(),
            "seq_lens": self.seq_lens.tolist(),
            "ref": self.ref.tolist(),
            "ever_freed": sorted(int(p) for p in self._ever_freed),
            "stats": {k: int(v) for k, v in self.stats.items()},
            "index": None,
        }


def default_pool_pages(slots: int, cache_len: int, page_size: int) -> int:
    """Pool sized to the contiguous cache's token footprint."""
    return max(1, slots * pages_needed(cache_len, page_size))


def default_slot_pages(num_pages: int, cache_len: int,
                       page_size: int) -> int:
    """Default block-table width: the ``cache_len`` equivalent plus one
    page of lockstep-write headroom, capped at the pool."""
    return min(num_pages, pages_needed(cache_len, page_size) + 1)


def init_paged_decode_state(cfg, slots: int, *, page_size: int = 8,
                            num_pages: int | None = None,
                            max_pages_per_slot: int | None = None,
                            cache_len: int = 128, dtype=None,
                            device=None) -> DecodeState:
    """Device tensors of the paged KV cache: ``k_pages``/``v_pages`` of
    shape ``(n_layers * num_pages + 1, page_size, n_kv_heads, d_head)``
    (row ``i`` holds the logical (layer, page) whose Morton position is
    ``i``; the last row is the reserved zero row), ``page_perm``
    (n_layers, num_pages) int32 and ``block_tables`` (slots,
    max_pages_per_slot) int32, all -1."""
    if not cfg.has_attention or cfg.has_ssm:
        raise ValueError(
            f"paged KV cache needs a pure-attention family, got "
            f"{cfg.family!r} (ssm/hybrid states are not paged)")
    if cfg.swa_window is not None:
        raise ValueError("paged KV cache does not implement SWA rings yet")
    dev = resolve_device(device)
    dtype = dtype or cfg.act_torch_dtype()
    num_pages = num_pages or default_pool_pages(slots, cache_len, page_size)
    max_pages_per_slot = max_pages_per_slot or default_slot_pages(
        num_pages, cache_len, page_size)
    rows = cfg.n_layers * num_pages + 1  # +1: the shared zero row
    shape = (rows, page_size, cfg.n_kv_heads, cfg.d_head)
    return DecodeState({
        "k_pages": torch.zeros(shape, dtype=dtype, device=dev),
        "v_pages": torch.zeros(shape, dtype=dtype, device=dev),
        "page_perm": torch.from_numpy(
            page_permutation(cfg.n_layers, num_pages)).to(dev),
        "block_tables": torch.full((slots, max_pages_per_slot), -1,
                                   dtype=torch.int32, device=dev),
    }, KVLayout.PAGED)


def init_paged_serving(cfg, slots: int, cache_len: int, *,
                       page_size: int = 8, num_pages: int | None = None,
                       max_pages_per_slot: int | None = None, dtype=None,
                       device=None):
    """A :class:`PageAllocator` and its device state, agreeing on pool
    size and block-table width."""
    num_pages = num_pages or default_pool_pages(slots, cache_len, page_size)
    max_pages_per_slot = max_pages_per_slot or default_slot_pages(
        num_pages, cache_len, page_size)
    alloc = PageAllocator(num_pages, page_size, slots, max_pages_per_slot)
    state = init_paged_decode_state(
        cfg, slots, page_size=page_size, num_pages=num_pages,
        max_pages_per_slot=max_pages_per_slot, cache_len=cache_len,
        dtype=dtype, device=device)
    return alloc, state


def physical_rows(perm, block_table, zero_row: int):
    """Map logical block-table entries to physical page rows.

    ``perm``: (..., num_pages) Morton positions, one layer's row or the
    full (n_layers, num_pages) table; ``block_table``: (..., pages)
    logical ids (-1 empty).  Returns perm.shape[:-1] + block_table.shape;
    unallocated entries map to the reserved zero row."""
    perm = torch.as_tensor(perm)
    bt = torch.as_tensor(block_table, device=perm.device)
    rows = perm[..., bt.clamp(min=0).long()]
    return torch.where(bt >= 0, rows, torch.full_like(rows, zero_row))
