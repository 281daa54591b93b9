"""The serving loop's decode step replayed from captured CUDA graphs.

:class:`DecodeGraphs` sits behind :meth:`repro_torch.launch.serve.
ServeLoop._step`.  On the card, with the paged pool, the loop's decode
step launches the same kernels in the same order every step (B1's rows
path, B2, B5 for a routed moe, and the small torch ops around them); a
graph captured from the unchanged :func:`repro_torch.models.
decode_step` replays that chain with one launch from the host.  Every
kernel and its arguments are the eager step's: the graph only stops
re-enqueueing them from Python.

When the loop replays: the device is CUDA, the layout paged, and no
mesh context, chaos plan or GEMM counter (``kernels.ops.gemm_counter``,
the dry-run's) is active; :func:`eager_reasons` names what is not so,
and the step then runs eagerly.  B2's wrapper fires the ``kernel`` chaos
point on the host at each launch, which a replay would skip, and a GEMM
counter must see every call.

What a graph reads and writes lives at the addresses it had at capture:
the static inputs (tokens (slots, 1), pos (slots,) int32, mask (slots,)
and the live rows (slots,) int64, of which a key reads the first n;
each step's device inputs are copied in on the stream), the loop's
pool (``k_pages``, ``v_pages``, ``page_perm`` and
``block_tables``, which the loop writes in place) and the weights.
Before each replay the state's tensors are checked against the captured
ones; a mismatch raises.

Keys: the dense families decode all ``slots`` rows under the row mask,
so one graph serves every step.  A routed moe gathers only the live rows
(``rows``), so its graphs are keyed by their count n, 1 to ``slots``
(None where the step routes every row, lockstep's prefill), each
shape the eager step's: tokens and routes are the eager ones bit for
bit.  The graphs share one memory pool; they never run concurrently, and
what one writes (its logits, its routes) is read on the stream before
the next replays.

Capture happens at the loop's first decode step, for every key the loop
can meet: each key first runs the step eagerly once with every row
masked (it writes no page; its logits are dropped), which leaves the
schedule tables, launch plans and built libraries warm, so no
allocation outside the graph's pool and no copy from the host happens
inside the captured region.  The kernel wrappers' launch counters
(:mod:`repro_torch.kernels.launch_counts`) are restored after the
warm-ups and captures, and each replay adds the launches its capture
made, so the counts equal the eager step's.  A
routed key owns a :class:`~repro_torch.models.moe.MoeLog` whose counts
the graph zeroes first; after a replay they and the routes are copied
into the caller's log.

The logits a replay returns are the graph's static output: a caller
that keeps them past the next step clones them.
"""
from __future__ import annotations

import functools
import weakref

import torch

from repro_torch.kernels import launch_counts, ops
from repro_torch.models.layers import tp_context
from repro_torch.models.moe import MoeLog
from repro_torch.runtime import chaos as _chaos

__all__ = ["DecodeGraphs", "eager_reasons", "graph_key", "graph_keys"]

def eager_reasons(loop) -> list[str]:
    """Why ``loop``'s decode step runs eagerly now (empty: it replays)."""
    out = []
    if loop.device.type != "cuda":
        out.append(f"device {loop.device.type}")
    if not loop.paged:
        out.append("layout contiguous")
    if tp_context() is not None:
        out.append("mesh")
    if loop.chaos is not None or _chaos.active() is not None:
        out.append("chaos")
    if ops.gemm_counter is not None:
        out.append("gemm counter")
    return out


def graph_key(cfg, rows) -> int | None:
    """The graph a step replays: the live-row count of a routed moe's
    step (None where it routes every row), None for every other family."""
    if not cfg.routed_moe or rows is None:
        return None
    return int(rows.numel())


def graph_keys(loop) -> list:
    """The keys ``loop``'s decode steps meet: a routed moe's live-row
    counts 1 to ``slots``; one key otherwise.  (Lockstep's prefill steps
    route every row, key None: their first step captures it.)"""
    if not loop.cfg.routed_moe:
        return [None]
    return list(range(1, loop.slots + 1))


class _Graph:
    """One key's graph: its static outputs (the logits and, for a routed
    key, the routes (n_layers, n, k)), its launches a step, its log and
    the addresses of the state's tensors it read."""

    def __init__(self, graph, outs, launches, log, state_ptrs):
        self.graph = graph
        self.logits, self.routes = outs
        self.launches = launches
        self.log = log
        self.state_ptrs = state_ptrs


class DecodeGraphs:
    """Static inputs and the captured graphs of one loop's decode step
    (the module docstring).  Built by the loop on the card with the paged
    pool; :meth:`step` replays, capturing first where needed."""

    def __init__(self, loop):
        # no reference cycle: a loop dropped frees its weights, pool and
        # graphs at once, not at the next collection of cycles
        self.loop = weakref.proxy(loop)
        dev, b = loop.device, loop.slots
        self.tokens = torch.zeros(b, 1, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(b, dtype=torch.int32, device=dev)
        self.mask = torch.zeros(b, dtype=torch.bool, device=dev)
        self.rows = torch.zeros(b, dtype=torch.int64, device=dev)
        self.graphs: dict = {}
        self._pool = None

    def _fill(self, toks, pos, mask, rows) -> int | None:
        """Copy the step's device inputs into the static buffers (on the
        stream); returns the step's key."""
        self.tokens.copy_(toks)
        self.pos.copy_(pos)
        self.mask.copy_(mask)
        key = graph_key(self.loop.cfg, rows)
        if key is not None:
            self.rows[:key].copy_(rows)
        return key

    def _run(self, key, log):
        """The decode step on the static inputs, as captured: the log's
        counts zeroed first; returns (logits, the routes stacked or
        None)."""
        if log is not None:
            log.counts.zero_()
            log.routes.clear()
        logits = self.loop._decode(
            self.tokens, self.pos, self.mask,
            None if key is None else self.rows[:key], log)
        return logits, torch.stack(log.routes) if log is not None else None

    def _new_graph(self, fn):
        """Capture ``fn`` on a side stream into a graph on the keys'
        shared pool; returns (the graph, ``fn``'s outputs)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            outs = fn()
        return graph, outs

    def _state_ptrs(self) -> dict:
        return {k: v.data_ptr() for k, v in self.loop.state.items()}

    def capture(self, keys) -> None:
        """Warm up and capture each of ``keys`` (module docstring); the
        static inputs and the launch counters are left as they were."""
        lp = self.loop
        held = [t.clone() for t in (self.tokens, self.pos, self.mask,
                                    self.rows)]
        before = launch_counts.snapshot()
        experts = len(lp.moe_expert_rows) if lp.cfg.routed_moe else 0
        for key in keys:
            log = MoeLog(experts, lp.device, routes=True) \
                if lp.cfg.routed_moe else None
            self.tokens.zero_()
            self.pos.zero_()
            self.mask.zero_()
            self.rows.copy_(torch.arange(lp.slots, device=lp.device))
            self._run(key, log)            # warm-up: every row masked
            start = launch_counts.snapshot()
            graph, outs = self._new_graph(
                functools.partial(self._run, key, log))
            launches = launch_counts.delta(start)
            self.graphs[key] = _Graph(graph, outs, launches, log,
                                      self._state_ptrs())
            lp.c_graph_captures.inc()
            lp.tracer.instant("serve.decode.graph_captures",
                              rows=lp.slots if key is None else key)
        launch_counts.restore(before)
        for buf, t in zip((self.tokens, self.pos, self.mask, self.rows),
                          held):
            buf.copy_(t)

    def step(self, toks, pos, mask, rows=None, moe_log=None):
        """One decode step replayed (capturing every key the loop can
        meet at its first call, and a key not met before at its own):
        returns the graph's logits; ``moe_log`` gains its counts and
        routes."""
        key = self._fill(toks, pos, mask, rows)
        if not self.graphs:
            self.capture([k for k in graph_keys(self.loop) if k != key]
                         + [key])
        elif key not in self.graphs:
            self.capture([key])
        g = self.graphs[key]
        if self._state_ptrs() != g.state_ptrs:
            raise RuntimeError(
                "the serving state's tensors moved since the decode graph "
                "was captured; the graph would read the old ones")
        g.graph.replay()
        launch_counts.add(g.launches)
        self.loop.c_graph_replays.inc()
        if moe_log is not None:
            moe_log.counts.copy_(g.log.counts)
            if moe_log.routes is not None:
                moe_log.routes.extend(g.routes)
        return g.logits
