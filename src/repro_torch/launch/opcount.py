"""What one step does, counted as it runs: FLOPs, memory traffic,
collectives, live memory and kernel launches.  This module takes the
role of the reference's ``launch/hlo.py`` (``analyze_hlo``,
``collective_bytes``, ``op_census``) and of XLA's ``memory_analysis``,
which read a compiled module; the port has no module to read, so it
counts the step itself, under a ``TorchDispatchMode``.

:func:`count_step` runs ``fn(*args)`` once and returns the keys of
``analyze_hlo`` for it, per chip (one rank's step):

* ``flops``: 2 M N K for every GEMM; every other op takes its count
  from ``torch.utils.flop_counter``'s registry (the attention einsums'
  ``bmm``, a convolution); elementwise ops count 0, as a dot-only HLO
  count does;
* ``traffic_bytes``, the fused model (as the reference's: elementwise
  chains fuse into their neighbours): a GEMM reads its operands, bias
  and residual once and writes its output once; a gather (``index``,
  ``index_select``, ``gather``, ``embedding``) moves its output twice,
  a scatter (``index_put_``, ``index_copy_``, ``scatter``, a
  ``copy_`` into part of a buffer, ...) its update twice, the dynamic
  slices of the HLO; a collective moves its operand twice;
* ``traffic_bytes_upper``: every op that writes writes its output and
  it is read once (2 x its output bytes; views and bare allocations
  move nothing);
* ``collectives``: ``{kind: {bytes, count}}`` under the reference's HLO
  names, ``total_bytes`` and ``total_count``, from the mesh's own
  records (``distributed.ctx.record_collectives``; operand bytes per
  chip, as ``launch/hlo.py::_operand_bytes`` counts them);
* ``op_census``: aten ops by name;
* ``kernels``: launches and FLOPs by the route each GEMM takes on the
  card: ``"b1_rows"`` (B1's rows path, ``kernels/sfc_matmul.py::
  _rows_path``), ``"b1_tile"``, ``"b3"``, ``"xla"`` (the library GEMM,
  ``ops.library_matmul``), ``"auto"`` (a tuner-routed GEMM, unresolved
  on a meta tensor) and ``"torch"`` (an aten GEMM outside the engine:
  the attention and expert einsums);
* ``gemms``: the count of each GEMM shape, ``"route MxNxK dtype"`` (a
  batch as ``BxMxNxK``);
* ``memory``: the keys of XLA's ``memory_analysis``.
  ``argument_size_in_bytes`` is the storage of the arguments (this
  rank's shards of the parameters, the optimizer state and the batch),
  ``output_size_in_bytes`` that of the results (an argument updated in
  place counts in both, as a donated buffer does), and
  ``temp_size_in_bytes`` the peak of the bytes of every storage the
  step allocates while it lives, results included.  A storage lives
  until torch frees it, so a tensor autograd saves counts until the
  backward releases it.  The estimate misses what one aten op keeps to
  itself (a kernel's workspace) and the caching allocator's rounding;
  ``argument + temp`` is the step's peak beside
  ``torch.cuda.max_memory_allocated``.

Every GEMM of the engine passes :func:`repro_torch.kernels.ops.
sfc_matmul` (or ``sfc_matmul_batched``), whose hook hands it to the
counter: it is recorded, and on a meta tensor an empty meta output of
the kernel's shape and dtype is returned, so no kernel wrapper sees it.
On a real tensor the GEMM runs as always, with the mode paused, so the
ops of its plain version (on the CPU) are not counted: the card's
launch is one op.  On the card ``launched`` holds the launches the
kernel wrappers really made in the step; ``kernels`` is the count the
same step gives on its meta twin.  ``torch.utils.flop_counter`` cannot
see a ctypes launch: the hook is how B1 is counted there.

Collectives come from the mesh (``distributed.ctx``); the ops of a
process group (``c10d``), of the profiler and ``lift_fresh`` (a
``torch.tensor`` constant, which a meta tensor makes without it) are
not counted.
"""
from __future__ import annotations

import collections
import contextlib
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.ctx import record_collectives
from repro_torch.kernels import ops, paged_attention, sfc_matmul, \
    sfc_matmul_cached
from repro_torch.kernels.sfc_matmul import _rows_path

__all__ = ["count_step", "OpCounter", "COLLECTIVE_OPS", "gemm_route"]

# the reference's collective kinds (launch/hlo.py::COLLECTIVE_OPS)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")
_HLO_KIND = {"all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce",
             "all_gather": "all-gather", "all_to_all": "all-to-all",
             "send_recv": "collective-permute"}

_aten = torch.ops.aten
# allocations write nothing
_ALLOCS = {_aten.empty, _aten.empty_strided, _aten.empty_like,
           _aten.new_empty, _aten.new_empty_strided}
# gathers move their output in and out
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
# scatters move their update (the argument at this position) in and out
_SCATTERS = {_aten.index_put: 2, _aten.index_put_: 2,
             _aten._index_put_impl_: 2, _aten.index_copy: 3,
             _aten.index_copy_: 3, _aten.index_add: 3, _aten.index_add_: 3,
             _aten.scatter: 3, _aten.scatter_: 3, _aten.scatter_add: 3,
             _aten.scatter_add_: 3, _aten.slice_scatter: 1,
             _aten.select_scatter: 1, _aten.masked_scatter: 2,
             _aten.masked_scatter_: 2}
_SKIP_NAMESPACES = ("c10d", "_c10d_functional", "profiler")
# a constant ``torch.tensor`` lifts from the host: an op on the CPU and
# the card, none on meta, so not counted anywhere
_UNCOUNTED = {_aten.lift_fresh}
# the kernel wrappers' launch counters, read around a step on the card
_LAUNCH_COUNTERS = (("b1", sfc_matmul, "launches"),
                    ("b3", sfc_matmul, "batched_launches"),
                    ("b2", paged_attention, "launches"),
                    ("b4", sfc_matmul_cached, "launches"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """Every tensor in a tree of dicts, mappings, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "keys") and hasattr(tree, "__getitem__"):
        return [t for k in tree.keys() for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def gemm_route(schedule: str, m: int, n: int, k: int, bn: int,
               dtype: torch.dtype, batched: str | None = None) -> str:
    """The route a GEMM takes on the card: ``"b1_rows"``, ``"b1_tile"``,
    ``"b3"``, ``"xla"`` or ``"auto"`` (see the module docstring).  The
    rows path needs 16-byte-aligned operands besides its shape, which a
    tensor from torch's allocator is; the route assumes it."""
    if schedule in ("xla", "auto"):
        return schedule
    if batched == "b3":
        return "b3"
    vec_el = 16 // dtype.itemsize
    vec = k % vec_el == 0 and n % vec_el == 0 and bn % vec_el == 0
    return "b1_rows" if vec and _rows_path(m, n, k, bn, dtype.itemsize) \
        else "b1_tile"


class OpCounter(TorchDispatchMode):
    """The counts of the ops run inside it (see the module docstring).
    Use :meth:`run`, or :func:`count_step`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.fused_bytes = 0.0
        self.upper_bytes = 0.0
        self.census: collections.Counter = collections.Counter()
        self.kernels: dict = {}
        self.gemms: collections.Counter = collections.Counter()
        self.launched: dict = {}
        self.collective_log: list = []
        self._paused = 0
        self._open = False
        self._live: dict[int, int] = {}     # step storages: id -> bytes
        self._args: set[int] = set()
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0

    # -------------------------------------------------------- memory --
    def _free(self, key: int) -> None:
        if not self._open:
            return
        if key in self._args:
            self._args.discard(key)
        elif key in self._live:
            self.live -= self._live.pop(key)

    def _note(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as allocated by the step, unless it is
        an argument's or already counted."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._args:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _hold_args(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self._args:
                self._args.add(st._cdata)
                weakref.finalize(st, self._free, st._cdata)

    # --------------------------------------------------------- GEMMs --
    def gemm(self, run, a: torch.Tensor, b: torch.Tensor, *, schedule: str,
             bn: int, out_dtype, bias, residual, batched: str | None = None):
        """One GEMM of ``kernels/ops.py`` (``run()`` makes it): record
        it; a meta operand gets an empty meta output, any other runs
        with the mode paused."""
        out_dtype = out_dtype or a.dtype
        m, k = a.shape[-2:]
        n = b.shape[-1]
        lead = tuple(a.shape[:-2])
        nb = math.prod(lead)
        route = gemm_route(schedule, m, n, k, bn, a.dtype, batched)
        launches = nb if route.startswith("b1") and batched == "b1" else 1
        flops = 2.0 * nb * m * n * k
        if a.device.type == "meta":
            with self.paused():
                out = torch.empty(*lead, m, n, dtype=out_dtype,
                                  device="meta")
        else:
            with self.paused():
                out = run()
                if out.untyped_storage().nbytes() > _nbytes(out):
                    # the plain version's output is a view of its padded
                    # tiles; the kernel's owns its m x n storage
                    out = out.clone()
        ent = self.kernels.setdefault(route, {"launches": 0, "flops": 0.0})
        ent["launches"] += launches
        ent["flops"] += flops
        dims = "x".join(str(d) for d in (*((nb,) if lead else ()), m, n, k))
        self.gemms[f"{route} {dims} {str(a.dtype)[6:]}"] += 1
        self.flops += flops
        self.fused_bytes += sum(_nbytes(t) for t in (a, b, bias, residual)
                                if t is not None) + _nbytes(out)
        self.upper_bytes += 2 * _nbytes(out)
        self.census["sfc_matmul"] += 1
        self._note(out)
        return out

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ------------------------------------------------------- the mode --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if self._paused or func.namespace in _SKIP_NAMESPACES \
                or packet in _UNCOUNTED:
            return out
        self.census[packet.__name__] += 1
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            ent = self.kernels.setdefault("torch",
                                          {"launches": 0, "flops": 0.0})
            ent["launches"] += 1
            ent["flops"] += f
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            shapes = ",".join("x".join(map(str, t.shape)) for t in ins)
            self.gemms[f"torch {packet.__name__}({shapes}) "
                       f"{str(outs[0].dtype)[6:]}"] += 1
            self.fused_bytes += sum(_nbytes(t) for t in ins + outs)
        elif packet in _GATHERS:
            self.fused_bytes += 2 * sum(_nbytes(t) for t in outs)
        elif packet in _SCATTERS:
            src = args[_SCATTERS[packet]] if len(args) > _SCATTERS[packet] \
                else None
            if isinstance(src, torch.Tensor):
                self.fused_bytes += 2 * _nbytes(src)
        elif packet is _aten.copy_ and \
                _nbytes(args[0]) < args[0].untyped_storage().nbytes():
            self.fused_bytes += 2 * _nbytes(args[0])
        if not func.is_view and packet not in _ALLOCS:
            self.upper_bytes += 2 * sum(_nbytes(t) for t in outs)
        for t in outs:
            self._note(t)
        return out

    # ------------------------------------------------------------ run --
    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` counted; returns its result."""
        arg_tensors = _tensors((args, kwargs))
        self.argument_bytes = _storage_bytes(arg_tensors)
        before = _launch_counts()
        self._open = True
        self._hold_args(arg_tensors)
        outer, ops.gemm_counter = ops.gemm_counter, self
        try:
            with record_collectives() as log, self:
                out = fn(*args, **kwargs)
        finally:
            ops.gemm_counter = outer
        self.collective_log = log
        self.output_bytes = _storage_bytes(_tensors(out))
        if any(t.is_cuda for t in arg_tensors + _tensors(out)):
            after = _launch_counts()
            self.launched = {k: after[k] - before[k] for k in after}
        self._open = False
        return out

    def report(self) -> dict:
        coll = {k: {"bytes": 0, "count": 0} for k in COLLECTIVE_OPS}
        for rec in self.collective_log:
            c = coll[_HLO_KIND[rec["kind"]]]
            c["bytes"] += rec["bytes"]
            c["count"] += 1
        coll["total_bytes"] = sum(coll[k]["bytes"] for k in COLLECTIVE_OPS)
        coll["total_count"] = sum(coll[k]["count"] for k in COLLECTIVE_OPS)
        out = {
            "flops": self.flops,
            "traffic_bytes": self.fused_bytes + 2.0 * coll["total_bytes"],
            "traffic_bytes_upper": self.upper_bytes,
            "collectives": coll,
            "collective_log": [dict(r, axes=list(r["axes"]))
                               for r in self.collective_log],
            "op_census": dict(sorted(self.census.items())),
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "gemms": dict(sorted(self.gemms.items())),
            "memory": {"argument_size_in_bytes": self.argument_bytes,
                       "output_size_in_bytes": self.output_bytes,
                       "temp_size_in_bytes": self.peak},
        }
        if self.launched:
            out["launched"] = self.launched
        return out


def _launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in _LAUNCH_COUNTERS}


def count_step(fn, *args, with_output: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counted (module docstring);
    returns the count, or ``(count, result)`` with ``with_output``."""
    counter = OpCounter()
    out = counter.run(fn, *args, **kwargs)
    return (counter.report(), out) if with_output else counter.report()

