"""Serve-state snapshot/restore (port of ``repro.runtime.snapshot``).

Lightweight snapshots of everything the serving loop needs to replay a
failed iteration: the ``DecodeState`` tensors (the contiguous strips and
``kv_pos``, or the paged KV pool, the page permutation and the block
tables), the page allocator's metadata when the loop is paged (block
tables, free lists, refcounts, prefix-index edges via
:meth:`PageAllocator.state_dict`), and the scheduler's host state
(queue, outputs, per-slot bookkeeping), in the reference's format.

In memory by default: a snapshot clones the state's tensors on their
own device, in stream order, with no host synchronisation and no copy
to the host; a restore writes them back into the live tensors with
``copy_`` and, paged, rebuilds the block-table tensor from the
allocator.  Both
are cheap enough that chaos runs snapshot every iteration.  With a
``root`` directory each snapshot *also* goes through
:mod:`repro_torch.checkpoint.store` (atomic rename, per-leaf crc32, the
reference's on-disk format, bf16 leaves included), which copies the
tensors to the host; a restarted process can restore from it, and
corruption surfaces as :class:`~repro_torch.checkpoint.
CheckpointCorruptionError` instead of garbage KV.

Every paged restore re-audits the allocator via
:meth:`PageAllocator.check_invariants` -- a snapshot that resurrects a
corrupted page table fails loudly at restore time, never by serving
another request's KV rows.  ``last_snapshot_ms`` / ``last_restore_ms``
are host times: on the card the in-memory forms' device copies may
still be running when they are read.
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["ServeSnapshotter"]


def _int_keys(d: dict) -> dict:
    """JSON round trips stringify int dict keys; undo that (idempotent
    on the in-memory path)."""
    return {int(k): v for k, v in d.items()}


class ServeSnapshotter:
    """Snapshot/restore bound to one ``ServeLoop``.

    ``every``: snapshot cadence in scheduler iterations; ``root``: also
    persist through the checkpoint store (``keep`` most recent kept on
    disk).  ``restore(from_disk=True)`` takes the on-disk path -- what a
    restarted process would do."""

    def __init__(self, loop, every: int = 1, root: str | None = None,
                 keep: int = 2):
        self.loop = loop
        self.every = max(1, int(every))
        self.root = root
        self.keep = keep
        self._mem: tuple | None = None
        self.snapshots = 0
        self.restores = 0
        self.last_snapshot_ms = 0.0
        self.last_restore_ms = 0.0

    # ------------------------------------------------------------ capture --
    def _sched_state(self) -> dict:
        """Scheduler host state, JSON-native (ints/lists/None) so the
        in-memory and on-disk snapshot formats are identical."""
        lp = self.loop
        return {
            "pos": [int(p) for p in lp.pos],
            "active": [bool(a) for a in lp.active],
            "slot_req": [int(r) for r in lp.slot_req],
            "queue": [[int(r), list(p)] for r, p in lp.queue],
            "out": {int(r): list(t) for r, t in lp.out.items()},
            "request_emitted": {int(r): int(n)
                                for r, n in lp.request_emitted.items()},
            "admit_seq": [int(s) for s in lp._admit_seq],
            "admit_counter": int(lp._admit_counter),
            "prefill_len": [int(n) for n in lp._prefill_len],
            "prefill_done": [int(n) for n in lp._prefill_done],
            "slot_prompt": [list(p) if p is not None else None
                            for p in lp._slot_prompt],
            "phases": {int(r): ph for r, ph in lp._req_phase.items()
                       if ph is not None},
            "preemptions": int(lp.preemptions),
        }

    def maybe_snapshot(self, iteration: int) -> bool:
        if iteration % self.every != 0:
            return False
        self.snapshot(iteration)
        return True

    def snapshot(self, iteration: int) -> None:
        t0 = time.perf_counter()
        lp = self.loop
        tensors = {k: v.clone() for k, v in lp.state.items()}
        sched = self._sched_state()
        alloc = lp.alloc.state_dict() if lp.alloc is not None else None
        self._mem = (int(iteration), tensors, sched, alloc)
        if self.root is not None:
            from repro_torch.checkpoint.store import save_checkpoint
            save_checkpoint(
                self.root, int(iteration), tensors, keep=self.keep,
                meta={"sched": sched, "alloc": alloc,
                      "iteration": int(iteration)})
        self.snapshots += 1
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------ restore --
    def restore(self, *, from_disk: bool = False) -> int:
        """Rewind the loop to the last snapshot; returns its iteration.
        A restored allocator (paged) is invariant-audited before the
        loop touches it again."""
        t0 = time.perf_counter()
        lp = self.loop
        if from_disk or self._mem is None:
            iteration, tensors, sched, alloc = self._load_disk()
        else:
            iteration, tensors, sched, alloc = self._mem
        for k, v in tensors.items():
            lp.state[k].copy_(v)
        if alloc is not None:
            lp.alloc.load_state_dict(alloc)
        # scheduler fields: fresh copies so a second restore of the same
        # snapshot starts from identical state
        lp.pos = np.asarray(sched["pos"], np.int32)
        lp.active = np.asarray(sched["active"], bool)
        lp.slot_req = list(sched["slot_req"])
        lp.queue = [(int(r), list(p)) for r, p in sched["queue"]]
        lp.out = {r: list(t) for r, t in _int_keys(sched["out"]).items()}
        lp.request_emitted = _int_keys(sched["request_emitted"])
        lp._admit_seq = list(sched["admit_seq"])
        lp._admit_counter = int(sched["admit_counter"])
        # one admission appends one id and bumps the counter
        del lp.admitted[lp._admit_counter:]
        lp._prefill_len = np.asarray(sched["prefill_len"], np.int64)
        lp._prefill_done = np.asarray(sched["prefill_done"], np.int64)
        lp._slot_prompt = [list(p) if p is not None else None
                           for p in sched["slot_prompt"]]
        lp.preemptions = int(sched["preemptions"])
        self._reconcile_phases(_int_keys(sched["phases"]))
        if lp.paged:
            lp._sync_tables()
            lp.alloc.check_invariants()
        self.restores += 1
        self.last_restore_ms = (time.perf_counter() - t0) * 1e3
        return int(iteration)

    def _load_disk(self) -> tuple:
        if self.root is None:
            raise RuntimeError("no snapshot taken and no snapshot root")
        from repro_torch.checkpoint.store import latest_step, \
            load_checkpoint
        last = latest_step(self.root)
        if last is None:
            raise RuntimeError(f"no snapshot found under {self.root}")
        tensors, meta = load_checkpoint(self.root, last,
                                        dict(self.loop.state.items()))
        return meta["iteration"], tensors, meta["sched"], meta["alloc"]

    def _reconcile_phases(self, target: dict[int, str]) -> None:
        """Rewind per-request lifecycle phases, keeping the async phase
        spans balanced: close any span a request holds now, reopen the
        one it held at snapshot time (a request that *finished* between
        snapshot and fault re-enters its snapshot phase and will simply
        re-finish during replay)."""
        lp = self.loop
        reqs = set(lp._req_phase) | set(target)
        for req in reqs:
            cur = lp._req_phase.get(req)
            want = target.get(req)
            if cur == want:
                continue
            if cur:
                lp.tracer.end_async(f"request.{cur}", req)
            if want:
                lp.tracer.begin_async(f"request.{want}", req)
        lp._req_phase = dict(target)
