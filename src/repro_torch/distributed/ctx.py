"""Mesh context (port of ``repro.distributed.ctx``) on
``torch.distributed``: the logical mesh of ranks with a process group
for every set of its axes, the explicit collectives the sharded model
code issues (counted by kind), the active-mesh context the model code
reads, and the bring-up of a world of ranks.

The reference leaves the collectives to GSPMD (``constrain`` pins a
layout and XLA inserts them).  Here every collective is spelled out
where the model code needs it, so ``constrain`` has no counterpart.

Backends: NCCL for CUDA tensors, one rank per card; gloo only where the
caller asks for the CPU.  A collective refuses a CUDA tensor on a gloo
group (:meth:`Mesh.check`), so no card tensor takes the host's path.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import itertools
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "MeshCtx", "mesh_context", "current", "dp_axes",
           "COLLECTIVES", "init_world", "spawn", "world_backend"]

# collectives issued, by kind: the sharded steps' communication, read
# (and zeroed) by whoever measures a step
COLLECTIVES: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

WORLD_TIMEOUT_S = 300.0   # a collective's wait for its peers
SPAWN_TIMEOUT_S = 600.0   # spawn's wait for each rank to finish


@dataclasses.dataclass(frozen=True)
class _Group:
    """One process group of the mesh: ``members`` are the global ranks
    in mesh order (the linear index over the group's axes, first axis
    major, as the reference's ``_axis_index``); torch numbers a group's
    ranks by sorted global rank, and ``order[i]`` is the mesh index of
    the group's i-th rank."""
    pg: object
    members: tuple
    order: tuple

    @property
    def size(self) -> int:
        return len(self.members)


class Mesh:
    """A logical mesh over the ranks of the world.

    ``shape`` maps each axis name to its size (as a jax ``Mesh``'s);
    ``devices`` holds the global rank at each mesh coordinate (row-major
    over the ranks ``0 .. prod - 1`` unless ``ranks`` permutes them, as
    a ``device_order`` does).  Construction is collective: every rank of
    the world creates every group (``dist.new_group``), in the same
    order; a rank outside the mesh holds no group (``coord`` None).  A
    mesh needs ``prod(shape)`` ranks of the world and raises otherwise.
    """

    def __init__(self, shape, axis_names, ranks=None):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {sizes} does not match axes "
                             f"{self.axis_names}")
        n = int(np.prod(sizes))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n > world:
            raise ValueError(f"a {sizes} mesh needs {n} ranks; the world "
                             f"holds {world}")
        ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        if sorted(ranks) != list(range(n)):
            raise ValueError(f"mesh ranks {ranks} are not a permutation of "
                             f"0..{n - 1}")
        self.shape = dict(zip(self.axis_names, sizes))
        self.devices = np.asarray(ranks, dtype=np.int64).reshape(sizes)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.devices == self.rank)
        self.coord = dict(zip(self.axis_names, (int(c) for c in where[0]))) \
            if len(where) else None
        self._groups: dict[tuple, _Group] = {}
        if dist.is_initialized():
            self._build_groups()

    def _build_groups(self):
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                dims = [names.index(a) for a in axes]
                rest = [i for i in range(len(names)) if i not in dims]
                grid = np.moveaxis(self.devices, dims + rest,
                                   list(range(len(names))))
                grid = grid.reshape(int(np.prod([self.shape[a]
                                                 for a in axes])), -1)
                for col in range(grid.shape[1]):
                    members = tuple(int(r) for r in grid[:, col])
                    pg = dist.new_group(sorted(members))
                    if self.rank in members:
                        order = tuple(members.index(r)
                                      for r in sorted(members))
                        self._groups[axes] = _Group(pg, members, order)

    def __repr__(self):
        return f"Mesh({self.shape})"

    # ----------------------------------------------------------- queries --
    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)], dtype=int))

    def index(self, axes) -> int:
        """This rank's linear index over ``axes`` (in mesh order, first
        axis major)."""
        idx = 0
        for a in self.axis_names:
            if a in _axes(axes):
                idx = idx * self.shape[a] + self.coord[a]
        return idx

    def group(self, axes) -> _Group:
        axes = tuple(a for a in self.axis_names if a in _axes(axes))
        return self._groups[axes]

    def check(self, t: torch.Tensor, g: _Group | None) -> None:
        """Refuse a CUDA tensor on a gloo group, a CPU tensor on NCCL
        (``g`` None: the world's group)."""
        backend = dist.get_backend(g.pg if g is not None else None)
        if t.is_cuda != (backend == "nccl"):
            raise RuntimeError(f"a {t.device} tensor cannot take the "
                               f"{backend} group of {self}")

    # ------------------------------------------------------- collectives --
    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"):
        """In-place all-reduce of ``t`` over ``axes``; returns ``t``.  A
        non-contiguous ``t`` goes through a contiguous copy."""
        g = self.group(axes)
        self.check(t, g)
        COLLECTIVES[f"all_reduce_{op}"] += 1
        buf = t if t.is_contiguous() else t.contiguous()
        dist.all_reduce(buf, op=_OPS[op], group=g.pg)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Concatenate every member's ``t`` along ``dim`` in mesh order."""
        g = self.group(axes)
        t = t.contiguous()
        self.check(t, g)
        COLLECTIVES["all_gather"] += 1
        parts = [torch.empty_like(t) for _ in range(g.size)]
        dist.all_gather(parts, t, group=g.pg)
        ordered = [None] * g.size
        for i, p in enumerate(parts):
            ordered[g.order[i]] = p
        return torch.cat(ordered, dim=dim)

    def all_to_all(self, t: torch.Tensor, axes, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``):
        chunk j of ``t`` along ``split_dim`` goes to the member at mesh
        index j; what arrives is concatenated along ``concat_dim`` in
        mesh order."""
        g = self.group(axes)
        self.check(t, g)
        COLLECTIVES["all_to_all"] += 1
        chunks = [c.contiguous() for c in t.chunk(g.size, dim=split_dim)]
        # torch numbers the group's ranks by global rank: send and
        # receive in that numbering, reorder to mesh order
        send = [chunks[g.order[i]] for i in range(g.size)]
        recv = [torch.empty_like(send[i]) for i in range(g.size)]
        dist.all_to_all(recv, send, group=g.pg)
        ordered = [None] * g.size
        for i, r in enumerate(recv):
            ordered[g.order[i]] = r
        return torch.cat(ordered, dim=concat_dim)

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Send ``t`` to the next member along ``axis`` and receive the
        previous member's (the first member receives zeros): the
        reference's ``ppermute`` with pairs ``(i, i + 1)``."""
        g = self.group((axis,))
        self.check(t, g)
        i = self.coord[axis]
        COLLECTIVES["send_recv"] += 1
        req = None
        if i + 1 < g.size:
            req = dist.isend(t.contiguous(), g.members[i + 1])
        out = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        if i > 0:
            dist.recv(out, g.members[i - 1])
        if req is not None:
            req.wait()
        return out


    def send(self, t: torch.Tensor, dst: int) -> None:
        """Send ``t`` to the global rank ``dst`` (point to point)."""
        self.check(t, None)
        COLLECTIVES["send_recv"] += 1
        dist.send(t.contiguous(), dst)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """Receive a tensor shaped like ``like`` from the global rank
        ``src``."""
        self.check(like, None)
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(out, src)
        return out


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: Mesh
    dp: tuple          # data-parallel axes the batch is split over
    model_axis: str = "model"
    seq_axes: tuple | None = None  # decode SP axes (default: (model_axis,))

    @property
    def tp(self) -> int:
        return self.mesh.shape.get(self.model_axis, 1)

    @property
    def sp(self) -> tuple:
        """The axes a contiguous decode cache's sequence is split over."""
        return self.seq_axes if self.seq_axes is not None \
            else (self.model_axis,)


_CTX: list[MeshCtx] = []


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


@contextlib.contextmanager
def mesh_context(mesh: Mesh | None, seq_axes: tuple | None = None,
                 dp: tuple | None = None):
    if mesh is None:
        yield None
        return
    ctx = MeshCtx(mesh=mesh, dp=dp if dp is not None else dp_axes(mesh),
                  seq_axes=seq_axes)
    _CTX.append(ctx)
    try:
        yield ctx
    finally:
        _CTX.pop()


def current() -> MeshCtx | None:
    return _CTX[-1] if _CTX else None


# ------------------------------------------------------------ the world --
def world_backend(device: str | torch.device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(rank: int, world: int, store_path: str,
               device) -> torch.device:
    """Join a world of ``world`` ranks through a ``FileStore`` (no
    network): NCCL with one card per rank (``cuda:rank``), gloo on the
    CPU.  Returns this rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < world:
            raise RuntimeError(
                f"a world of {world} ranks needs {world} cards; "
                f"{torch.cuda.device_count()} are visible")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        world_backend(dev), store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S),
        **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


def _rank_main(rank, world, store_path, device, out_dir, fn, args):
    torch.set_num_threads(1)
    try:
        init_world(rank, world, store_path, device)
        result = fn(*args)
        if rank == 0:
            torch.save(result, os.path.join(out_dir, "result.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, device="cpu"):
    """Run ``fn(*args)`` on ``world`` fresh ranks (spawned processes, one
    thread each) joined by :func:`init_world`; returns rank 0's result.
    ``fn`` must be importable (a module-level function).  A rank that
    raises makes the call raise with its traceback; the others are then
    stopped (a collective never waits on a dead peer past the group's
    timeout)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, os.path.join(d, "store"), device, d, fn, args))
            for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(SPAWN_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errs = sorted(f for f in os.listdir(d) if f.startswith("error"))
        if errs:
            with open(os.path.join(d, errs[0])) as f:
                raise RuntimeError(f"rank failed ({errs[0]}):\n{f.read()}")
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"ranks exited with "
                               f"{[p.exitcode for p in procs]}")
        return torch.load(os.path.join(d, "result.pt"), weights_only=False)
