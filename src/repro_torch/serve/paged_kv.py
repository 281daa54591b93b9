"""Paged KV cache: page allocator, prefix index and Morton page layout
(port of ``repro.serve.paged_kv``).

Each decode slot owns a block table mapping logical page index ->
logical page id; pages live in one shared physical pool.  Release pushes
page ids back on a LIFO free list (no data moves); admission is bounded
by the pool.  The ``(layer, page)`` grid is laid out along a Morton
curve (:func:`page_permutation`), the paper's locality technique applied
to the KV pool.  Under prefix sharing, pages are reference counted and
page-aligned prompt prefixes are indexed by content (:class:`PrefixIndex`)
so later admissions map the same pages; a write into a shared page
forks a private copy first.  The allocator and the index are host-side
numpy and Python; the pool tensors live on the serving device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schedule import grid_schedule
from repro_torch.device import resolve_device
from repro_torch.runtime.chaos import fire as _chaos_fire

from .state import DecodeState, KVLayout

__all__ = ["PageAllocator", "PoolExhausted", "PrefixIndex",
           "page_permutation", "init_paged_decode_state",
           "init_paged_serving", "zero_row_index", "pages_needed",
           "physical_rows", "default_pool_pages", "default_slot_pages"]


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


class PrefixIndex:
    """Radix-style index of *full* prompt pages by content.

    Each edge is one full page keyed by its ``page_size``-token tuple;
    a walk from the root matches the longest indexed page-aligned prompt
    prefix.  Only full pages are indexed: a partial tail page grows as
    its owner appends, so a content key for it would go stale -- partial
    tails stay private and are shared only through explicit table clones
    (:meth:`PageAllocator.clone_table`), where copy-on-write protects
    them.  Eviction removes a single edge; orphaned descendants become
    unreachable (a walk stops at the missing parent) and drain through
    the cached-free FIFO like any other cold page.
    """

    def __init__(self):
        self._root: dict[tuple, int] = {}
        # pid -> children dict of the node *after* that page
        self._children: dict[int, dict[tuple, int]] = {}
        # pid -> (parent children dict, edge key): eviction backref
        self._owner: dict[int, tuple[dict, tuple]] = {}

    def __contains__(self, pid: int) -> bool:
        return pid in self._owner

    def __len__(self) -> int:
        return len(self._owner)

    def _chunks(self, tokens, page_size: int):
        for pg in range(len(tokens) // page_size):
            yield tuple(tokens[pg * page_size:(pg + 1) * page_size])

    def match(self, tokens, page_size: int) -> list[int]:
        """Longest indexed full-page prefix of ``tokens`` -> page ids."""
        cur, out = self._root, []
        for tup in self._chunks(tokens, page_size):
            pid = cur.get(tup)
            if pid is None:
                break
            out.append(pid)
            cur = self._children.setdefault(pid, {})
        return out

    def insert(self, tokens, page_ids, page_size: int) -> None:
        """Index ``page_ids`` as the full-page prefix of ``tokens``.
        Existing edges win (first writer keeps the canonical page)."""
        cur = self._root
        for tup, pid in zip(self._chunks(tokens, page_size), page_ids):
            have = cur.get(tup)
            if have is None:
                cur[tup] = int(pid)
                self._owner[int(pid)] = (cur, tup)
                have = int(pid)
            cur = self._children.setdefault(have, {})

    def evict(self, pid: int) -> None:
        owner = self._owner.pop(int(pid), None)
        if owner is not None:
            children, key = owner
            children.pop(key, None)
        self._children.pop(int(pid), None)

    # ---------------------------------------------------- serialization --
    def edges(self) -> list[list]:
        """The index as ``[parent_pid, key_tokens, pid]`` edges (parent
        -1 at the root) -- JSON-native, the reference's snapshot format.

        Edges orphaned by a parent's eviction are left out: no walk
        reaches them, and :meth:`from_edges` drops them.  (The
        reference's ``edges`` raises ``KeyError`` while the index holds
        one; where it returns, the two lists are equal.)"""
        parent_of = {id(self._root): -1}
        for pid, children in self._children.items():
            parent_of[id(children)] = pid
        return [[parent_of[id(children)], list(key), int(pid)]
                for pid, (children, key) in self._owner.items()
                if id(children) in parent_of]

    @classmethod
    def from_edges(cls, edges) -> "PrefixIndex":
        """Rebuild from :meth:`edges`.  Insertion order is resolved by
        fixpoint (a child edge waits for its parent); orphaned edges --
        impossible for an index serialized by :meth:`edges` -- are
        dropped rather than looping forever."""
        ix = cls()
        pending = [(int(parent), tuple(key), int(pid))
                   for parent, key, pid in edges]
        while pending:
            rest = []
            for parent, key, pid in pending:
                if parent == -1:
                    node = ix._root
                elif parent in ix._owner:
                    node = ix._children.setdefault(parent, {})
                else:
                    rest.append((parent, key, pid))
                    continue
                node[key] = pid
                ix._owner[pid] = (node, key)
            if len(rest) == len(pending):
                break
            pending = rest
        return ix


class PageAllocator:
    """Free-list page allocator with per-slot block tables (host-side).

    Logical page ids index the ``num_pages`` pool; the Morton
    permutation to physical rows is applied at gather time.  The free
    list is LIFO, so a released slot's pages go to the next admission
    first.

    Pages are reference counted: block tables of several slots may map
    the same page (prefix sharing through :class:`PrefixIndex`, or a
    whole-table :meth:`clone_table`), ``release`` decrements, and a page
    returns to a free pool only at refcount zero.  Writes into a shared
    page go through :meth:`fork` (copy-on-write; the caller copies the
    rows on the device).  ``prefix_sharing=False`` keeps no index and a
    single LIFO pool.  :meth:`state_dict` is the reference's snapshot
    format, equal to the reference's after the same operations.
    """

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int | None = None, *,
                 prefix_sharing: bool = False):
        if num_pages < 1 or page_size < 1 or slots < 1:
            raise ValueError((num_pages, page_size, slots))
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_pages_per_slot = int(max_pages_per_slot or num_pages)
        # LIFO free list: pop() hands out the most recently freed page
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        # freed pages whose content is still indexed (the prefix cache):
        # revived on an index hit, evicted FIFO (coldest first) when the
        # plain pool runs dry
        self._free_cached: list[int] = []
        self.block_table = np.full(
            (self.slots, self.max_pages_per_slot), -1, np.int32)
        self.seq_lens = np.zeros(self.slots, np.int32)
        self.ref = np.zeros(self.num_pages, np.int32)
        self.prefix_sharing = bool(prefix_sharing)
        self.index = PrefixIndex() if prefix_sharing else None
        self._ever_freed: set[int] = set()
        self.stats = {"allocated": 0, "freed": 0, "reused": 0,
                      "cow_forks": 0, "prefix_hits": 0, "shared_pages": 0,
                      "revived": 0}

    # ------------------------------------------------------------- queries --
    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._free_cached)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    def occupancy(self) -> float:
        return self.pages_in_use / self.num_pages

    def can_admit(self, prompt_len: int) -> bool:
        return pages_needed(prompt_len, self.page_size) <= self.free_pages

    def was_freed(self, pid: int) -> bool:
        """True if ``pid`` has been freed before: its rows may hold a
        previous occupant's K/V and need a scrub on reuse."""
        return pid in self._ever_freed

    def slot_pages(self, slot: int) -> list[int]:
        return [int(p) for p in self.block_table[slot] if p >= 0]

    def page_counts(self) -> np.ndarray:
        """Per-slot count of allocated pages (the serve loop's traffic
        accounting)."""
        return (self.block_table >= 0).sum(axis=1)

    def refcount(self, pid: int) -> int:
        return int(self.ref[pid])

    # ----------------------------------------------------------- mutation --
    def _check_extent(self, slot: int, page_idx: int) -> None:
        if page_idx >= self.max_pages_per_slot:
            raise RuntimeError(
                f"slot {slot} outgrew its block table "
                f"({page_idx} >= {self.max_pages_per_slot} pages); "
                f"raise max_pages_per_slot / num_pages")

    def _pop_free(self) -> int:
        """A fresh page id: the plain LIFO pool first, then FIFO
        eviction from the prefix-cached pool (the coldest cached page
        loses its index entry)."""
        # chaos point: fires before any mutation, so an injected
        # allocation fault leaves the allocator consistent
        _chaos_fire("alloc")
        if self._free:
            return self._free.pop()
        if self._free_cached:
            pid = self._free_cached.pop(0)
            self.index.evict(pid)
            return pid
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
        """Drop ``slot``'s references (metadata only).  A page returns to
        a free pool only at refcount zero: zero-ref pages still in the
        prefix index park on the cached FIFO (revivable), the rest go
        back on the plain LIFO list.  Returns the pages freed."""
        freed: list[int] = []
        for pid in self.slot_pages(slot):
            self.ref[pid] -= 1
            if self.ref[pid] < 0:
                raise RuntimeError(f"page {pid}: negative refcount")
            if self.ref[pid] > 0:
                continue
            if self.index is not None and pid in self.index:
                self._free_cached.append(pid)
            else:
                self._free.append(pid)
            self._ever_freed.add(pid)
            freed.append(pid)
        self.stats["freed"] += len(freed)
        self.block_table[slot] = -1
        self.seq_lens[slot] = 0
        return freed

    # ----------------------------------------------- sharing / copy-on-write
    def clone_table(self, src: int, dst: int) -> list[int]:
        """Fork ``src``'s whole block table into ``dst``: every mapped
        page, the partial tail included, is shared by reference; the
        first write into a shared page forks it (:meth:`fork`).  Returns
        the shared page ids."""
        shared = self.slot_pages(src)
        self.block_table[dst] = self.block_table[src]
        self.seq_lens[dst] = self.seq_lens[src]
        for pid in shared:
            self.ref[pid] += 1
        self.stats["shared_pages"] += len(shared)
        return shared

    def adopt_prefix(self, slot: int, tokens) -> int:
        """Map the longest indexed page-aligned prefix of ``tokens`` into
        ``slot``'s table by reference; returns the shared length in
        tokens (0 without sharing or without a match).  Live pages gain
        a reference; cached (freed but indexed) ones leave the cached
        FIFO without a scrub: their content is the requested prefix."""
        if self.index is None:
            return 0
        matched = self.index.match(tokens, self.page_size)
        for pg, pid in enumerate(matched):
            self._check_extent(slot, pg)
            if self.ref[pid] == 0:
                self._free_cached.remove(pid)
                self.ref[pid] = 1
                self.stats["revived"] += 1
            else:
                self.ref[pid] += 1
            self.block_table[slot, pg] = pid
        n = len(matched)
        if n:
            self.stats["prefix_hits"] += n
            self.stats["shared_pages"] += n
            self.seq_lens[slot] = max(
                self.seq_lens[slot], n * self.page_size)
        return n * self.page_size

    def register_prefix(self, slot: int, tokens) -> None:
        """Index ``slot``'s full-page prefix of ``tokens`` for later
        admissions.  Full pages only: a partial tail keeps growing under
        decode writes, so its content key would go stale."""
        if self.index is None:
            return
        full = len(tokens) // self.page_size
        pids = [int(p) for p in self.block_table[slot, :full]]
        if all(p >= 0 for p in pids):
            self.index.insert(tokens, pids, self.page_size)

    def needs_fork(self, slot: int, position: int) -> bool:
        """True when a write at ``position`` would land in a page that
        another table also maps (refcount > 1): :meth:`fork` first."""
        page_idx = int(position) // self.page_size
        if page_idx >= self.max_pages_per_slot:
            return False  # the extent error surfaces in ensure()
        pid = self.block_table[slot, page_idx]
        return pid >= 0 and self.ref[pid] > 1

    def fork(self, slot: int, position: int) -> tuple[int, int]:
        """Copy-on-write fork of the shared page holding ``position``:
        a private page for ``slot``, one reference less on the shared
        original.  Returns ``(old_pid, new_pid)`` for the caller's device
        copy, which overwrites every row of the new page (no scrub)."""
        page_idx = int(position) // self.page_size
        old = int(self.block_table[slot, page_idx])
        if old < 0 or self.ref[old] <= 1:
            raise RuntimeError(
                f"slot {slot} page {page_idx} (id {old}) is not shared")
        new = self._pop_free()
        self.ref[new] = 1
        self.ref[old] -= 1
        self.block_table[slot, page_idx] = new
        self.stats["allocated"] += 1
        self.stats["cow_forks"] += 1
        if new in self._ever_freed:
            self.stats["reused"] += 1
        return old, new

    def check_invariants(self) -> None:
        """Every pool page is either free exactly once or referenced by
        exactly ``ref`` table entries, never both, and every cached-free
        page is still reachable through the prefix index; raises
        RuntimeError naming the first offending page."""
        seen: set = set()
        for pid in list(self._free) + list(self._free_cached):
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
        for pid in self._free_cached:
            if self.index is None or pid not in self.index:
                raise RuntimeError(
                    f"page {pid}: on the cached-free list but evicted from "
                    f"the prefix index (unreachable for reuse, unsafe to "
                    f"leave unscrubbed)")

    def state_dict(self) -> dict:
        """Allocator metadata as JSON-native values, in the reference's
        snapshot format; free-list order is kept."""
        return {
            "free": [int(p) for p in self._free],
            "free_cached": [int(p) for p in self._free_cached],
            "block_table": self.block_table.tolist(),
            "seq_lens": self.seq_lens.tolist(),
            "ref": self.ref.tolist(),
            "ever_freed": sorted(int(p) for p in self._ever_freed),
            "stats": {k: int(v) for k, v in self.stats.items()},
            "index": self.index.edges() if self.index is not None
            else None,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore :meth:`state_dict` (the reference's format; either
        package's snapshot loads).  Pool geometry is construction-time:
        a block table of another shape or a pool of another size raises
        ``ValueError``; only the mutable metadata is replaced.  The
        prefix index is rebuilt from the listed edges: the reachable
        ones, which is all a walk can find."""
        table = np.asarray(d["block_table"], np.int32)
        if table.shape != self.block_table.shape:
            raise ValueError(
                f"snapshot block table {table.shape} does not fit this "
                f"allocator {self.block_table.shape}")
        ref = np.asarray(d["ref"], np.int32)
        if ref.shape != self.ref.shape:
            raise ValueError(
                f"snapshot pool of {ref.shape[0]} pages does not fit this "
                f"allocator's {self.num_pages}")
        self._free = [int(p) for p in d["free"]]
        self._free_cached = [int(p) for p in d["free_cached"]]
        self.block_table = table
        self.seq_lens = np.asarray(d["seq_lens"], np.int32)
        self.ref = ref
        self._ever_freed = {int(p) for p in d["ever_freed"]}
        self.stats = {k: int(v) for k, v in d["stats"].items()}
        if self.prefix_sharing:
            self.index = PrefixIndex.from_edges(d["index"] or [])


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
                       prefix_sharing: bool = False, device=None):
    """A :class:`PageAllocator` (with a :class:`PrefixIndex` when
    ``prefix_sharing``) and its device state, agreeing on pool size and
    block-table width."""
    num_pages = num_pages or default_pool_pages(slots, cache_len, page_size)
    max_pages_per_slot = max_pages_per_slot or default_slot_pages(
        num_pages, cache_len, page_size)
    alloc = PageAllocator(num_pages, page_size, slots, max_pages_per_slot,
                          prefix_sharing=prefix_sharing)
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
