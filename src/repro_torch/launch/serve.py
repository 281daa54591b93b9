"""Batched serving loop, lockstep or continuous, over either KV layout
(port of ``repro.launch.serve.ServeLoop``: the dense, moe, ssm and
hybrid archs).

A fixed pool of decode slots keeps its KV cache in one of two layouts
(:attr:`repro_torch.serve.ServeConfig.layout`): ``contiguous`` (the
default, as in the reference), a strip of ``cache_len`` entries per
slot, or a ring of one window under SWA; or ``paged``, one shared pool
of Morton-ordered physical pages with per-slot block tables and
copy-free release.  Two schedulers (:attr:`repro_torch.serve.
ServeConfig.mode`):

* ``lockstep``: a request's whole prompt is prefilled at admission,
  token by token through the decode step with a one-hot row mask; live
  slots then decode together, each on its own position.
* ``continuous``: requests join and leave mid-flight.  Prompts are
  prefilled in chunks (``prefill_kv_chunk``, one gang of ``slots`` rows
  x ``prefill_budget`` tokens a step) interleaved with decode steps, so
  a long prompt never stalls the slots already decoding (not under a
  whole-model SWA ring: a chunk has no ring; windows per layer, which
  keep every page, serve here).  With ``prefix_sharing`` (the default;
  paged only), slots whose prompts share
  page-aligned prefixes map the same pages through a prefix index, an
  identical prompt clones its live source's whole block table, and a
  write into a shared page forks a private copy first (copy-on-write).

Both schedulers and both layouts give the same greedy tokens for the
same requests, as in the reference.  The ssm and hybrid families (an
SSD state per slot) serve lockstep on the contiguous layout only, as
in the reference; a slot's SSD rows are zeroed when a request is
admitted into it (the reference's next request starts from the
previous occupant's state, ROADMAP.md queue C).  Every slot decodes on
its own position, SWA and hybrid archs included: the reference keeps
those on one shared position, the oldest live slot's, so a request
admitted later reads ring entries it never wrote (queue C); here a
row's ring validity follows its own clock.  Pool exhaustion (paged)
preempts the most recently admitted other busy slot, which rejoins the
queue with its full context.  Every projection runs through the SFC GEMM kernel
(the rows path in decode, the tile path in a prefill chunk) and every
paged decode step's attention through the paged decode kernel when the
engine has a curve schedule and the device is ``cuda``; the contiguous
decode attention and a chunk's attention are plain torch, as they are
XLA in the reference.

Energy, as in the reference: every lockstep prefill, prefill chunk and
decode step runs inside an :class:`~repro_torch.power.EnergyMeter` on
the loop's power backend (``power_backend=``, default
:func:`~repro_torch.power.detect_backend`; name ``NvmlBackend(poll_s=
NVML_POLL_S)`` for the card's own joules: auto-detection prefers RAPL,
the CPU package's), with the reference's
:class:`~repro_torch.power.WorkloadHints`; the readings land in
``energy`` (an :class:`~repro_torch.power.EnergyReport`) and are charged
to requests in ``request_joules``, weighted by the tokens each processed
(a decode step splits evenly over its live slots).  The meter adds no
device synchronisation: a reading holds what the counter saw between
the window's ends, which on the H100 moves every 100 ms, so a step's
reading is coarse and a run's sum is what is exact.  With
``ServeConfig.objective`` set, the GEMMs run ``schedule="auto"`` under
that metric and the DVFS points of the decode step's shapes
(``f_scales``) come from the tuner.

Observability, as in the reference: every request carries a lifecycle
of async trace spans (``request`` enclosing ``request.queued`` /
``request.prefill`` / ``request.decode``) and every scheduler iteration
a ``serve.step`` span with ``serve.admit``, ``serve.prefill_chunk`` and
``serve.decode`` children, on the loop's :class:`~repro_torch.obs.
Tracer` (``tracer=``, default the process tracer, disabled until a
caller installs one); metrics (time to first token, time per output
token, end-to-end latency, step time, queue depth, pool occupancy,
faults) go to ``metrics=`` (default the process registry, none with
``ServeConfig(obs=False)``); :meth:`ServeLoop.latency_summary` gives
exact percentiles and lands in the energy report's ``latency`` meta.
Spans read the host clock and add no device sync.  The decode step
ends in a copy of the logits to the host, so its span is true wall
time; a prefill chunk does not, so ``serve.prefill_chunk`` is the
host's enqueue time of the chunk (its device time shows in the next
synchronising span).

Inside those two spans the loop opens children (port-only names):
``serve.decode.pages`` (paged), ``serve.decode.upload`` (``rows``: the
live slots), ``serve.decode.dispatch``, ``serve.decode.sync`` (the
logits' copy) and ``serve.decode.sample``; ``serve.prefill_chunk.plan``
and ``serve.prefill_chunk.dispatch`` (``tokens``: the gang's prompt
tokens; ``rows``: ``slots x prefill_budget``).  With an enabled tracer
on CUDA, each dispatch span also gets ``device_ms``: the elapsed time
of a pair of CUDA events recorded on the current stream just before and
after ``decode_step`` / ``prefill_kv_chunk``, read after the decode's
logits copy (no synchronisation of its own; a disabled tracer creates
no event).  A pair measures the stream's wall time between its marks:
where the host enqueues more slowly than the card runs, it includes the
card's idle inside the step.  The counters ``serve.prefill.rows``,
``serve.decode.rows`` and ``serve.decode.steps`` sum the same rows and
steps for ``--metrics-report``.

On the card with the paged pool, and with no chaos plan, mesh context or
GEMM counter active, the decode step is a replay of a CUDA graph
captured from the unchanged ``decode_step`` at the loop's first decode
step (:mod:`repro_torch.launch.decode_graph`: the same kernels, in the
same order, sent by one launch); everything else decodes eagerly.
``serve.decode.graph_captures`` counts the graphs captured (one a key,
each also an instant event) and ``serve.decode.graph_replays`` the
decode steps replayed; their share of ``serve.decode.steps`` says how
often the replay engages.

A routed moe (``cfg.routed_moe``) routes only the live decode rows (their
indices uploaded with the step's inputs) and the gang's prompt tokens.
Each step's per-expert counts, summed over layers, land in a small
device tensor whose copy to the host is queued behind the step and read
after the next logits copy (no sync of its own): the dispatch spans gain
``moe_rows`` (the step's routed assignments, summed over layers, known
on the host) and ``experts_touched`` (summed over layers, the experts
with at least one row), the counters ``serve.moe.assignments`` and
``serve.moe.experts_touched`` sum them, and ``moe_expert_rows`` the
per-expert counts.  Set ``route_steps`` to a list to keep every step's
routing, each routed row's request, position and experts a layer (the
benchmark's check holds them to the reference's router).

Fault tolerance, as in the reference: a deterministic chaos schedule
(``ServeConfig.chaos``, :mod:`repro_torch.runtime.chaos`) injects
faults at allocation, the decode step, the top of an iteration, the
logits (NaN), a delay and the power counter.  An iteration that raises
a :class:`~repro_torch.runtime.chaos.TransientFault` is restored from
its snapshot (:class:`~repro_torch.runtime.ServeSnapshotter`, every
iteration under chaos; device clones, no host copy unless
``snapshot_dir``) and replayed, at most ``max_step_retries`` times.
Logits that are not finite fail only their request (the NaN
quarantine); requests past ``deadline_ms`` fail; a pool or SLO-
violation rate over a watermark sheds the queue; an EMA watchdog flags
straggling iterations.  There is no kernel fallback: a real CUDA error
is not a transient fault and propagates.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
      --layout paged --mode continuous --requests 6 --max-new 16 \\
      --power-backend nvml --energy-report report.json \\
      --trace trace.jsonl --metrics-report metrics.json \\
      --chaos "alloc@step=2,nan@step=3:req=1" --snapshot-dir snaps

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch h2o_danube_3_4b --cache-len 64 --requests 4 --max-new 16

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite_moe_3b_a800m --layout paged --mode continuous

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \\
      --requests 4 --max-new 16

(``--smoke --device cpu`` runs the SMOKE config on the CPU.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.decode_graph import DecodeGraphs, eager_reasons
from repro_torch.launch.steps import _engine_for
from repro_torch.models import DotEngine, decode_step, \
    fused_epilogue_savings_bytes, init_decode_state, init_model, \
    prefill_kv_chunk
from repro_torch.models.moe import MoeLog
from repro_torch.obs import MetricsRegistry, Tracer, default_registry, \
    default_tracer, null_registry
from repro_torch.power import EnergyMeter, EnergyReport, WorkloadHints, \
    detect_backend
from repro_torch.runtime import InjectedFault, ServeSnapshotter, \
    StragglerMonitor, TransientFault, parse_chaos_spec
from repro_torch.runtime import chaos as _chaos
from repro_torch.serve import PoolExhausted, ServeConfig
from repro_torch.serve.paged_kv import init_paged_serving, \
    page_permutation, pages_needed
from repro_torch.tune.cost import AttnSpec, attn_decode_bytes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class ServeLoop:
    """Lockstep or continuous serving over the contiguous strips or the
    paged KV pool.

    ``params`` must already live on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``).  ``engine`` defaults to
    ``DotEngine()``, the Morton-scheduled SFC GEMM (with an objective,
    ``schedule="auto"``).  ``power_backend`` meters every step (default
    :func:`~repro_torch.power.detect_backend`).  ``metrics`` and
    ``tracer`` receive the loop's instruments and spans (defaults as in
    the reference: the process registry and tracer, or no-ops with
    ``ServeConfig(obs=False)``)."""

    def __init__(self, cfg, params, config: ServeConfig | None = None, *,
                 engine: DotEngine | None = None, power_backend=None,
                 metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, device=None):
        sc = config if config is not None else ServeConfig()
        if not cfg.has_decode:
            raise NotImplementedError(
                f"{cfg.name} is an {cfg.family}: an encoder has no decode "
                f"step to serve")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the loop serves on {self.device}")
        if sc.mode == "continuous":
            if not cfg.has_attention or cfg.has_ssm:
                raise ValueError(
                    f"continuous batching needs a pure-attention family "
                    f"(chunked prefill), got {cfg.family!r}")
            if cfg.swa_window is not None:
                raise ValueError(
                    "continuous batching does not support a whole-model "
                    "SWA ring yet (windows per layer serve)")
        self.config = sc
        self.cfg = cfg
        self.params = params
        self.engine = _engine_for(engine, sc.objective)
        self.objective = sc.objective or "time"
        self.mode = sc.mode
        self.slots = sc.slots
        self.cache_len = sc.cache_len
        self.paged = sc.paged
        self.page_size = sc.page_size
        self.prefill_budget = sc.prefill_budget
        # prefix sharing needs block tables (paged) and the mid-flight
        # admissions that make a shared prefix reachable (continuous)
        self.prefix_sharing = bool(sc.prefix_sharing and sc.paged
                                   and sc.mode == "continuous")
        self.attn_spec = AttnSpec("paged", sc.page_size) if sc.paged \
            else AttnSpec("contig")
        # DVFS points of the decode step's shapes for the energy hints:
        # the projection (slots x d x d, fused residual), the MLP
        # up-projection (fused silu) and the decode attention, each under
        # its own keyspace
        self.f_scales = {"proj": 1.0, "mlp": 1.0, "attn": 1.0}
        if sc.objective:
            from repro_torch.tune import EpilogueSpec, GemmSpec, resolve
            self.f_scales["proj"] = resolve(
                GemmSpec(sc.slots, cfg.d_model, cfg.d_model, cfg.act_dtype,
                         epilogue=EpilogueSpec(residual=True)),
                backend=self.device.type, objective=sc.objective).f_scale
            self.f_scales["mlp"] = resolve(
                GemmSpec(sc.slots, cfg.d_ff or cfg.d_model, cfg.d_model,
                         cfg.act_dtype,
                         epilogue=EpilogueSpec(activation="silu")),
                backend=self.device.type, objective=sc.objective).f_scale
            if cfg.has_attention:
                self.f_scales["attn"] = self._resolve_attn_f()
        # the dominant projection's point is the hints' scalar
        self.f_scale = self.f_scales["proj"]
        self.temperature = sc.temperature
        self.eos_id = sc.eos_id
        self.rng = np.random.default_rng(sc.seed)
        if sc.paged:
            self.alloc, self.state = init_paged_serving(
                cfg, sc.slots, sc.cache_len, page_size=sc.page_size,
                num_pages=sc.num_pages, prefix_sharing=self.prefix_sharing,
                device=self.device)
            self._perm_np = page_permutation(cfg.n_layers,
                                             self.alloc.num_pages)
        else:
            self.alloc = None
            self.state = init_decode_state(cfg, sc.slots, sc.cache_len,
                                           device=self.device)
        self.pos = np.zeros(sc.slots, np.int32)   # next position per slot
        self.active = np.zeros(sc.slots, bool)
        self.out: dict[int, list[int]] = {}
        self.slot_req = [-1] * sc.slots
        self.queue: list[tuple[int, list[int]]] = []
        # per-request generation budget survives preemption; admission
        # order picks the preemption victim (most recently admitted)
        self.request_emitted: dict[int, int] = {}
        self._admit_seq = [0] * sc.slots
        self._admit_counter = 0
        self.preemptions = 0
        self.admitted: list[int] = []   # request ids in admission order
        # continuous bookkeeping: a slot mid-prefill has _prefill_len >= 0
        # (its prompt's length) and _prefill_done tokens written;
        # _slot_prompt keeps the admitted prompt for chunking, prefix
        # registration and clone matching
        self._prefill_len = np.full(sc.slots, -1, np.int64)
        self._prefill_done = np.zeros(sc.slots, np.int64)
        self._slot_prompt: list[list[int] | None] = [None] * sc.slots
        # prompt tokens prefilled per continuous iteration (each entry
        # <= prefill_budget)
        self.prefill_tokens_per_step: list[int] = []
        self.steps = 0          # decode_step calls, lockstep prefill included
        self.chunk_steps = 0    # prefill_kv_chunk calls
        # energy: one reading per prefill / prefill chunk / decode step,
        # charged to requests by the tokens each processed in it
        self.power = power_backend or detect_backend()
        # modeled bytes one decode step over the slot pool no longer
        # moves thanks to the fused epilogues
        self.ep_saved_step = fused_epilogue_savings_bytes(cfg, sc.slots)
        # modeled per-step traffic: the weights stream once a step
        self._gemm_bytes_step = float(sum(
            t.numel() * t.element_size() for t in _leaves(params)))
        self._cache_dtype_bytes = cfg.act_torch_dtype().itemsize
        self._min_share = 1.0
        self._share_tag: str | None = None
        self.energy = EnergyReport(backend=self.power.name,
                                   meta={"driver": "serve",
                                         "slots": sc.slots,
                                         "mode": sc.mode,
                                         "objective": self.objective,
                                         "attn": self.attn_spec.tag(),
                                         "attn_share": 1.0,
                                         "f_scale": self.f_scale,
                                         "f_scale_per_shape":
                                         dict(self.f_scales),
                                         "attn_bytes_step":
                                         self._attn_bytes_step(),
                                         "gemm_bytes_step":
                                         self._gemm_bytes_step,
                                         "fused_epilogue_saved_bytes_step":
                                         self.ep_saved_step})
        self.request_joules: dict[int, float] = {}
        self._tok_flops = 2.0 * sum(t.numel() for t in _leaves(params))
        # --- observability ------------------------------------------------
        self._bind_obs(
            metrics if metrics is not None else (
                default_registry() if sc.obs else null_registry()),
            tracer if tracer is not None else (
                default_tracer() if sc.obs else Tracer(enabled=False)))
        # request lifecycle on the time.monotonic clock (seconds; trace
        # timestamps are the same clock in us): arrival at submit, first
        # decoded token, retirement
        self.arrival_s: dict[int, float] = {}
        self.first_token_s: dict[int, float] = {}
        self.finish_s: dict[int, float] = {}
        self.request_ttft_ms: dict[int, float] = {}
        self.request_tpot_ms: dict[int, float] = {}
        self.request_e2e_ms: dict[int, float] = {}
        self.request_slo_ok: dict[int, bool] = {}
        # current lifecycle phase per request (queued/prefill/decode):
        # keeps the async phase spans balanced across preemption
        self._req_phase: dict[int, str | None] = {}
        self._revived_seen = 0
        self.g_share.set(1.0)
        # --- fault tolerance ----------------------------------------------
        self.guards = sc.fault_guards
        self.deadline_ms = sc.deadline_ms
        self.errors: dict[int, str] = {}
        # requests whose retirement already hit the metrics and spans: a
        # restore can rewind a finished request into flight, and its
        # replayed retirement must not count twice
        self._finished: set[int] = set()
        self._iter = 0
        self.straggler = StragglerMonitor()
        self.chaos = parse_chaos_spec(sc.chaos, seed=sc.seed) \
            if sc.chaos else None
        # under chaos, restore-and-replay must always be possible: snapshot
        # every iteration unless the caller chose a cadence
        every = sc.snapshot_every or (1 if self.chaos is not None else None)
        self.snapshotter = ServeSnapshotter(
            self, every=every, root=sc.snapshot_dir) if every else None
        # the decode step's captured graphs and their static inputs, where
        # the loop can replay (on the card, paged, no chaos plan or mesh)
        self._graphs = DecodeGraphs(self) if not eager_reasons(self) \
            else None

    # -------------------------------------------------------------- obs --
    def _bind_obs(self, metrics: MetricsRegistry, tracer: Tracer) -> None:
        """Bind the metrics registry and tracer and hand out this loop's
        instruments (the reference's names, then the port's row
        counters; ``serve.degraded`` stays 0: the port has no kernel
        fallback)."""
        self.metrics = m = metrics
        self.tracer = tracer
        self.m_ttft = m.histogram("serve.ttft_ms")
        self.m_tpot = m.histogram("serve.tpot_ms")
        self.m_e2e = m.histogram("serve.e2e_ms")
        self.m_step = m.histogram("serve.step_ms")
        self.m_prefill_tok = m.histogram("serve.prefill_tokens")
        self.c_submitted = m.counter("serve.requests.submitted")
        self.c_finished = m.counter("serve.requests.finished")
        self.c_preempt = m.counter("serve.preemptions")
        self.c_cow = m.counter("serve.cow_forks")
        self.c_scrubbed = m.counter("serve.pages.scrubbed")
        self.c_revived = m.counter("serve.pages.revived")
        self.c_slo_met = m.counter("serve.slo.met")
        self.c_slo_violation = m.counter("serve.slo.violations")
        self.g_queue = m.gauge("serve.queue.depth")
        self.g_occ = m.gauge("serve.pool.occupancy")
        self.g_hit_ratio = m.gauge("serve.prefix.hit_ratio")
        self.g_share = m.gauge("serve.attn.min_share")
        self.c_failed = m.counter("serve.requests.failed")
        self.c_shed = m.counter("serve.shed")
        self.c_retries = m.counter("serve.retries")
        self.c_restores = m.counter("serve.restores")
        self.c_degraded = m.counter("serve.degraded")
        self.h_restore_ms = m.histogram("serve.restore_ms")
        self._fault_counters: dict[str, object] = {}
        # the steps' rows, summed as the dispatch spans' args give them
        self.c_prefill_rows = m.counter("serve.prefill.rows")
        self.c_decode_rows = m.counter("serve.decode.rows")
        self.c_decode_steps = m.counter("serve.decode.steps")
        # decode graphs captured (one a key) and decode steps replayed
        self.c_graph_captures = m.counter("serve.decode.graph_captures")
        self.c_graph_replays = m.counter("serve.decode.graph_replays")
        if self.cfg.routed_moe:
            self.c_moe_assign = m.counter("serve.moe.assignments")
            self.c_moe_touched = m.counter("serve.moe.experts_touched")
        # (dispatch span args, start event, end event) not yet read
        self._device_marks: list[tuple[dict, object, object]] = []
        # routed moe: (dispatch span args, host copy of the step's expert
        # counts) not yet read, and the per-expert rows read so far
        self._moe_pending: list[tuple[dict, torch.Tensor]] = []
        self.moe_expert_rows = np.zeros(
            self.params["layers"]["moe"]["router"].shape[-1], np.int64) \
            if self.cfg.routed_moe else None
        # a list keeps every step's routing (request ids, positions,
        # (n_layers, rows, k) expert ids on the device); None keeps none
        self.route_steps: list | None = None

    def _device_mark(self):
        """A timing event recorded on the current stream, or None: only
        while the tracer records on a CUDA device."""
        if not (self.tracer.enabled and self.device.type == "cuda"):
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _close_mark(self, args: dict, start) -> None:
        """Pair ``start`` (a :meth:`_device_mark`, or None) with a mark
        recorded now; the pair's elapsed time becomes
        ``args["device_ms"]`` at the next :meth:`_read_device_ms`."""
        if start is not None:
            self._device_marks.append((args, start, self._device_mark()))

    def _read_device_ms(self) -> None:
        """Write ``device_ms`` of every pair recorded so far.  Called
        right after the decode's copy of its logits to the host, which
        waited for the stream: each pair has completed, and reading it
        synchronises nothing."""
        for args, start, end in self._device_marks:
            args["device_ms"] = start.elapsed_time(end)
        self._device_marks.clear()

    def _moe_log(self):
        """A step's :class:`~repro_torch.models.moe.MoeLog` (keeping the
        routes where ``route_steps`` is a list), or None unless the moe is
        routed."""
        if not self.cfg.routed_moe:
            return None
        return MoeLog(len(self.moe_expert_rows), self.device,
                      routes=self.route_steps is not None)

    def _moe_queue(self, args: dict, log, rids, positions) -> None:
        """After a step's dispatch: its routed assignments (a row a
        request id in ``rids``, fed at ``positions``, x top-k x layers)
        into ``args`` and the counter, a copy of its counts to the host
        queued on the stream (read by :meth:`_read_moe` after the next
        logits copy) and, where kept, its routes."""
        if log is None:
            return
        n = len(rids) * self.cfg.moe_topk * self.cfg.n_layers
        if self.tracer.enabled:
            args["moe_rows"] = n
        self.c_moe_assign.inc(n)
        if self.device.type == "cuda":
            host = torch.empty(log.counts.shape, dtype=log.counts.dtype,
                               pin_memory=True)
            host.copy_(log.counts, non_blocking=True)
        else:
            host = log.counts
        self._moe_pending.append((args, host))
        if log.routes is not None:
            self.route_steps.append((np.asarray(rids), np.asarray(positions),
                                     torch.stack(log.routes)))

    def _read_moe(self) -> None:
        """``experts_touched`` of every queued step: their copies were
        queued before the logits copy that just waited for the stream."""
        for args, host in self._moe_pending:
            c = host.numpy()
            e = len(self.moe_expert_rows)
            if self.tracer.enabled:
                args["experts_touched"] = int(c[e])
            self.c_moe_touched.inc(int(c[e]))
            self.moe_expert_rows += c[:e].astype(np.int64)
        self._moe_pending.clear()

    def _fault(self, point: str, **args) -> None:
        """Count one observed or injected fault at ``point``: a
        ``serve.faults.<point>`` counter plus an instant trace event."""
        c = self._fault_counters.get(point)
        if c is None:
            c = self.metrics.counter(f"serve.faults.{point}")
            self._fault_counters[point] = c
        c.inc()
        self.tracer.instant(f"serve.faults.{point}", **args)

    # ------------------------------------------------- request lifecycle --
    def _set_phase(self, req_id: int, phase: str | None) -> None:
        """Move a request between lifecycle phases, keeping one async
        span (``request.<phase>``) open per request at all times."""
        prev = self._req_phase.get(req_id)
        if prev:
            self.tracer.end_async(f"request.{prev}", req_id)
        self._req_phase[req_id] = phase
        if phase:
            self.tracer.begin_async(f"request.{phase}", req_id)

    def _finish_request(self, req_id: int,
                        error: str | None = None) -> None:
        """Retirement: TTFT / TPOT / e2e histograms, SLO attainment
        against ``config.latency_slo_ms`` (a TTFT target), and the
        request's enclosing async span closed with its totals.  ``error``
        retires a failed request (NaN quarantine, deadline, shed): it
        counts on ``serve.requests.failed`` and skips the latency and
        SLO accounting.  A replayed retirement (after a restore) is left
        out of the metrics and spans."""
        repeat = req_id in self._finished
        self._finished.add(req_id)
        now = time.monotonic()
        self.finish_s[req_id] = now
        n_out = self.request_emitted.get(req_id, 0)
        ttft = tpot = slo_ok = None
        if repeat:
            pass
        elif error is not None:
            self.c_failed.inc()
        else:
            self.c_finished.inc()
            arr = self.arrival_s.get(req_id)
            first = self.first_token_s.get(req_id)
            if arr is not None and first is not None:
                ttft = (first - arr) * 1e3
                self.request_ttft_ms[req_id] = ttft
                self.m_ttft.observe(ttft)
                e2e = (now - arr) * 1e3
                self.request_e2e_ms[req_id] = e2e
                self.m_e2e.observe(e2e)
            if first is not None and n_out > 1:
                tpot = (now - first) * 1e3 / (n_out - 1)
                self.request_tpot_ms[req_id] = tpot
                self.m_tpot.observe(tpot)
            slo = self.config.latency_slo_ms
            if slo is not None and ttft is not None:
                slo_ok = bool(ttft <= slo)
                self.request_slo_ok[req_id] = slo_ok
                (self.c_slo_met if slo_ok else self.c_slo_violation).inc()
        self._set_phase(req_id, None)
        if not repeat:
            self.tracer.end_async(
                "request", req_id, tokens=n_out,
                joules=self.request_joules.get(req_id, 0.0),
                ttft_ms=ttft, tpot_ms=tpot, slo_ok=slo_ok, error=error)

    def _finish_error(self, req_id: int, reason: str) -> None:
        """Finish a request with an error instead of requeueing it; the
        caller has already detached it from any slot or the queue."""
        self.errors[req_id] = reason
        self.tracer.instant("serve.request.failed", req=req_id,
                            reason=reason)
        self._finish_request(req_id, error=reason)

    def _fail_slot(self, slot: int, reason: str) -> None:
        """Evict a busy slot's request and finish it with ``reason`` (NaN
        quarantine, deadline): deactivate, drop prefill state, release
        its page references; co-resident slots never notice."""
        req = self.slot_req[slot]
        self.active[slot] = False
        self._prefill_len[slot] = -1
        self._prefill_done[slot] = 0
        self._slot_prompt[slot] = None
        self._release(slot)
        self._finish_error(req, reason)

    def _pump_gauges(self) -> None:
        """Per-iteration gauges: queue depth and, paged, pool occupancy,
        prefix hit ratio and the pages revived from the prefix cache."""
        self.g_queue.set(len(self.queue))
        if not self.paged:
            return
        st = self.alloc.stats
        used = self.alloc.num_pages - self.alloc.free_pages
        self.g_occ.set(used / max(self.alloc.num_pages, 1))
        hits = st.get("prefix_hits", 0)
        self.g_hit_ratio.set(hits / max(hits + st.get("allocated", 0), 1))
        rev = st.get("revived", 0) - self._revived_seen
        if rev:
            self.c_revived.inc(rev)
            self._revived_seen = st.get("revived", 0)

    def latency_summary(self) -> dict:
        """Exact percentiles over the per-request latencies (the
        histograms hold the same data bucketed) and SLO attainment."""
        def pct(vals: list[float]) -> dict:
            if not vals:
                return {"count": 0}
            a = np.asarray(sorted(vals), np.float64)
            return {"count": len(vals),
                    "p50": float(np.percentile(a, 50)),
                    "p95": float(np.percentile(a, 95)),
                    "p99": float(np.percentile(a, 99)),
                    "mean": float(a.mean()), "max": float(a.max())}
        met = sum(1 for ok in self.request_slo_ok.values() if ok)
        total = len(self.request_slo_ok)
        return {"ttft_ms": pct(list(self.request_ttft_ms.values())),
                "tpot_ms": pct(list(self.request_tpot_ms.values())),
                "e2e_ms": pct(list(self.request_e2e_ms.values())),
                "slo": {"target_ms": self.config.latency_slo_ms,
                        "met": met, "violations": total - met,
                        "attainment": met / total if total else None}}

    # ----------------------------------------------------------- energy --
    def _resolve_attn_f(self, share: float = 1.0) -> float:
        """DVFS point of the decode-attention winner under the paged
        layout; ``share`` < 1 resolves under the live sharing keyspace
        (``.../attn=paged-p8-sX.XX``)."""
        from repro_torch.tune import DecodeAttnSpec, resolve
        spec = self.attn_spec
        if share < 0.995:
            spec = dataclasses.replace(spec, share=max(0.01, round(share, 2)))
        return resolve(
            DecodeAttnSpec(self.slots, self.cache_len,
                           n_heads=self.cfg.n_heads,
                           n_kv_heads=self.cfg.n_kv_heads,
                           d_head=self.cfg.d_head,
                           dtype=self.cfg.act_dtype, attn=spec),
            backend=self.device.type,
            objective=self.config.objective).f_scale

    def _observe_share(self, share: float) -> None:
        """Keep the lowest sharing ratio seen and, when it enters a new
        0.01 bucket under an objective, re-resolve the attention point
        under that keyspace."""
        if share >= self._min_share:
            return
        self._min_share = share
        self.g_share.set(share)
        tag = f"{max(0.01, round(share, 2)):.2f}"
        if self.config.objective and tag != self._share_tag \
                and self.cfg.has_attention:
            self._share_tag = tag
            self.f_scales["attn"] = self._resolve_attn_f(share)
            self.energy.meta["f_scale_per_shape"] = dict(self.f_scales)

    def _attn_share(self) -> float:
        """Unique physical pages over logical block-table entries: shared
        pages are gathered once a step.  1.0 without sharing."""
        if not self.prefix_sharing:
            return 1.0
        logical = int(self.alloc.page_counts().sum())
        if logical == 0:
            return 1.0
        unique = len({pid for s in range(self.slots)
                      for pid in self.alloc.slot_pages(s)})
        return unique / logical

    def _attn_bytes_step(self) -> float:
        """Modeled attention-cache bytes of one decode step, all layers:
        paged, the allocated pages, scaled by the sharing ratio;
        contiguous, the full strips."""
        if not self.cfg.has_attention:
            return 0.0
        spec = self.attn_spec
        lengths = None
        if self.paged:
            # allocated pages as lengths: ceil(len / page) recovers them
            lengths = [int(n) * self.page_size
                       for n in self.alloc.page_counts()]
            share = self._attn_share()
            if share != 1.0:
                spec = dataclasses.replace(spec, share=share)
                self.energy.meta["attn_share"] = min(
                    self.energy.meta.get("attn_share", 1.0), share)
                self._observe_share(share)
        return self.cfg.n_layers * attn_decode_bytes(
            spec, slots=self.slots, cache_len=self.cache_len,
            lengths=lengths, n_kv_heads=self.cfg.n_kv_heads,
            d_head=self.cfg.d_head, dtype_bytes=self._cache_dtype_bytes)

    # ------------------------------------------------------ paged helpers --
    def _release(self, slot: int) -> None:
        """Drop a slot's page references (paged; copy-free, pages return
        to a free pool at refcount zero).  A contiguous slot's strips
        are simply written over by its next request."""
        if self.paged:
            self.alloc.release(slot)
            self._sync_tables()

    def _sync_tables(self):
        """The allocator's block tables into the state's tensor, in place:
        a decode graph reads it at the address it had at capture."""
        self.state["block_tables"].copy_(
            torch.from_numpy(self.alloc.block_table))

    def _scrub_pages(self, page_ids):
        """Zero the physical rows (all layers) of newly allocated pages
        that were freed before; a fresh pool is already zero.  COW forks
        skip this (their copy overwrites every row), and so do adopted
        prefix pages (their content is the requested prefix)."""
        dirty = [pid for pid in page_ids if self.alloc.was_freed(pid)]
        rows = [int(r) for pid in dirty for r in self._perm_np[:, pid]]
        if rows:
            self.c_scrubbed.inc(len(dirty))
            idx = torch.as_tensor(rows, device=self.device)
            self.state["k_pages"][idx] = 0
            self.state["v_pages"][idx] = 0

    def _cow_forks(self) -> bool:
        """Copy-on-write: fork any shared page an active slot is about
        to write this step (refcount > 1 at its write position), copying
        the old page's physical rows of every layer into the private
        page.  Pool exhaustion during a fork preempts like any other
        allocation; a preemption can drop the refcount to 1 and make the
        fork unnecessary, hence the re-check."""
        forked = False
        for s in range(self.slots):
            if not self.active[s]:
                continue
            p = int(self.pos[s])
            while self.alloc.needs_fork(s, p):
                try:
                    old, new = self.alloc.fork(s, p)
                except PoolExhausted:
                    if not self._preempt_victim(s):
                        raise
                    continue
                src = torch.as_tensor(self._perm_np[:, old],
                                      device=self.device).long()
                dst = torch.as_tensor(self._perm_np[:, new],
                                      device=self.device).long()
                self.state["k_pages"][dst] = self.state["k_pages"][src]
                self.state["v_pages"][dst] = self.state["v_pages"][src]
                self.c_cow.inc()
                forked = True
                break
        return forked

    def _upload(self, toks: np.ndarray, pos, mask: np.ndarray):
        """A decode step's tokens, positions and row mask on the device,
        in that order (each a blocking copy from host memory)."""
        dev = self.device
        return (torch.tensor(toks, device=dev),
                torch.tensor(pos, dtype=torch.int32, device=dev),
                torch.tensor(mask, device=dev))

    def _step(self, toks: torch.Tensor, pos: torch.Tensor,
              mask: torch.Tensor, rows=None, moe_log=None):
        """One decode step: a replay of its captured graph where the loop
        can replay (:mod:`repro_torch.launch.decode_graph`), else
        eager.  A replay's logits are overwritten by the next step."""
        if self._graphs is not None and not eager_reasons(self):
            logits = self._graphs.step(toks, pos, mask, rows, moe_log)
        else:
            logits = self._decode(toks, pos, mask, rows, moe_log)
        self.steps += 1
        return logits

    def _decode(self, toks, pos, mask, rows=None, moe_log=None):
        """The eager decode step, which a decode graph captures."""
        logits, self.state = decode_step(
            self.params, self.cfg, self.state, toks, pos, self.engine,
            row_mask=mask, rows=rows, moe_log=moe_log)
        return logits

    def _preempt_victim(self, needer: int) -> bool:
        """Requeue the most recently admitted other busy slot (decoding
        or mid-prefill) with its full context as a new prompt (its
        generation budget carries over) and release its references (a
        victim sharing prefix pages frees only its private pages).
        False when the needer is the only busy slot."""
        cands = [s for s in range(self.slots)
                 if s != needer
                 and (self.active[s] or self._prefill_len[s] >= 0)]
        if not cands:
            return False
        victim = max(cands, key=lambda s: self._admit_seq[s])
        req = self.slot_req[victim]
        self.active[victim] = False
        self._prefill_len[victim] = -1
        self._prefill_done[victim] = 0
        self._slot_prompt[victim] = None
        self._release(victim)
        self.preemptions += 1
        self.c_preempt.inc()
        self.tracer.instant("serve.preempt", req=req, needer=needer)
        # a victim already past its deadline can never meet it again:
        # finish it with an error instead of requeueing it
        if self._deadline_expired(req, time.monotonic()):
            self._fault("deadline", req=req)
            self._finish_error(req, "deadline")
        else:
            self.queue.insert(0, (req, list(self.out[req])))
            self._set_phase(req, "queued")
        return True

    # ------------------------------------------------ deadlines / shed --
    def _deadline_expired(self, req_id: int, now: float) -> bool:
        if self.deadline_ms is None:
            return False
        arr = self.arrival_s.get(req_id)
        return arr is not None and (now - arr) * 1e3 > self.deadline_ms

    def _enforce_deadlines(self) -> None:
        """Fail every request past its deadline (``deadline_ms`` on the
        arrival clock): queued ones leave the queue, busy slots are
        evicted.  Runs at the top of every iteration."""
        if self.deadline_ms is None:
            return
        now = time.monotonic()
        expired = [(r, p) for r, p in self.queue
                   if self._deadline_expired(r, now)]
        if expired:
            self.queue = [(r, p) for r, p in self.queue
                          if not self._deadline_expired(r, now)]
            for r, _ in expired:
                self._fault("deadline", req=r, where="queued")
                self._finish_error(r, "deadline")
        for s in range(self.slots):
            busy = self.active[s] or self._prefill_len[s] >= 0
            if busy and self._deadline_expired(self.slot_req[s], now):
                self._fault("deadline", req=self.slot_req[s], where="slot")
                self._fail_slot(s, "deadline")

    def _should_shed(self) -> bool:
        """True while pool occupancy or the observed SLO-violation rate
        is at or above its watermark."""
        sc = self.config
        if sc.shed_occupancy is not None and self.paged \
                and self.alloc.occupancy() >= sc.shed_occupancy:
            return True
        if sc.shed_violation_rate is not None and self.request_slo_ok:
            viol = sum(1 for ok in self.request_slo_ok.values() if not ok)
            if viol / len(self.request_slo_ok) >= sc.shed_violation_rate:
                return True
        return False

    def _shed_queue(self) -> None:
        while self.queue and self._should_shed():
            req_id, _ = self.queue.pop(0)
            self.c_shed.inc()
            self.tracer.instant("serve.shed", req=req_id)
            self._finish_error(req_id, "shed")

    # -------------------------------------------------------- scheduling --
    def submit(self, req_id: int, prompt: list[int],
               arrival_ts: float | None = None):
        """Queue a request.  ``arrival_ts`` is its arrival on the
        ``time.monotonic`` clock in seconds (default: now); TTFT, e2e
        latency, deadlines and SLO attainment count from it."""
        t = time.monotonic() if arrival_ts is None else float(arrival_ts)
        self.arrival_s[req_id] = t
        self.queue.append((req_id, list(prompt)))
        self.c_submitted.inc()
        self.tracer.begin_async("request", req_id, ts=t * 1e6,
                                prompt_tokens=len(prompt))
        self._req_phase[req_id] = None
        self.tracer.begin_async("request.queued", req_id, ts=t * 1e6)
        self._req_phase[req_id] = "queued"

    def _admit(self, max_new: int = 0):
        """Lockstep admission: whole-prompt prefill, token by token
        through the decode step with only the admitted slot writing.
        ``max_new`` bounds the request's positions (:meth:`_fits`)."""
        self._shed_queue()
        for slot in range(self.slots):
            if self.active[slot] or not self.queue:
                continue
            req_id, prompt = self.queue[0]
            self._fits(req_id, prompt, max_new)
            if self.paged:
                need = self._pages_for(prompt)
                # +1 decode-headroom page when the pool can ever supply it
                want = min(need + 1, self.alloc.num_pages)
                if want > self.alloc.free_pages:
                    break   # head-of-line blocks until a release frees pages
            self.queue.pop(0)
            self.admitted.append(req_id)
            self._set_phase(req_id, "prefill")
            if self.paged:
                self._scrub_pages(self.alloc.ensure_range(slot, len(prompt)))
                self._sync_tables()
            if self.cfg.has_ssm:
                # the request starts as it would alone: the reference
                # keeps the previous occupant's SSD rows (ROADMAP.md
                # queue C)
                self.state["ssm_h"][:, slot] = 0
                self.state["ssm_conv"][:, slot] = 0
            mask = np.zeros(self.slots, bool)
            mask[slot] = True
            # one "prefill" reading, all of it this request's
            with self.tracer.span("serve.prefill", req=req_id,
                                  tokens=len(prompt)), \
                    EnergyMeter("prefill", backend=self.power,
                                reporter=self.energy,
                                hints=WorkloadHints(
                                    flops=self._tok_flops * len(prompt),
                                    hbm_bytes=self._gemm_bytes_step
                                    * len(prompt),
                                    gemm_bytes=self._gemm_bytes_step
                                    * len(prompt),
                                    f_scale=self.f_scale)) as em:
                for i, tok in enumerate(prompt):
                    toks = np.zeros((self.slots, 1), np.int32)
                    toks[slot, 0] = tok
                    self._step(*self._upload(toks, i, mask))
            self.request_joules[req_id] = \
                self.request_joules.get(req_id, 0.0) + em.reading.joules
            self.pos[slot] = len(prompt)
            self.active[slot] = True
            self._set_phase(req_id, "decode")
            self.slot_req[slot] = req_id
            self._slot_prompt[slot] = list(prompt)
            self.out[req_id] = list(prompt)
            self.request_emitted.setdefault(req_id, 0)
            self._admit_seq[slot] = self._admit_counter
            self._admit_counter += 1

    def _fits(self, req_id: int, prompt: list[int], max_new: int) -> None:
        """Contiguous strips without a ring: a request writes positions
        [0, len(prompt) + the tokens it has left), and every one must
        lie within ``cache_len``; raises otherwise, as a paged slot
        that outgrows its block table does.  An SWA ring wraps, and an
        ssm state has no strips."""
        if self.paged or self.cfg.swa_window is not None \
                or not self.cfg.has_attention:
            return
        left = max(max_new - self.request_emitted.get(req_id, 0), 0)
        if len(prompt) + left > self.cache_len:
            raise RuntimeError(
                f"request {req_id}: a {len(prompt)}-token prompt and "
                f"{left} new tokens outgrow the {self.cache_len}-entry "
                f"strips; raise cache_len")

    def _pages_for(self, prompt: list[int]) -> int:
        """Pages a prompt needs; raises when the whole pool is too small."""
        need = pages_needed(len(prompt), self.page_size)
        if need > self.alloc.num_pages:
            raise RuntimeError(
                f"prompt of {len(prompt)} tokens exceeds the whole page "
                f"pool ({self.alloc.num_pages} pages x {self.page_size} "
                f"tokens)")
        return need

    def _clone_source(self, prompt: list[int]) -> int | None:
        """A live, fully prefilled slot whose admitted prompt equals
        ``prompt``: its whole block table (partial tail included) can be
        shared by reference."""
        for s in range(self.slots):
            if self.active[s] and self._slot_prompt[s] == prompt:
                return s
        return None

    def _admit_continuous(self, max_new: int = 0):
        """Continuous admission: claim a free slot at once, share what
        the prefix index already holds (or clone a live identical
        prompt's table), and leave the rest of the prompt to the chunked
        prefill stream.  ``max_new`` bounds the request's positions
        (:meth:`_fits`)."""
        self._shed_queue()
        for slot in range(self.slots):
            if not self.queue:
                break
            if self.active[slot] or self._prefill_len[slot] >= 0:
                continue
            req_id, prompt = self.queue[0]
            self._fits(req_id, prompt, max_new)
            clone_src = None
            if self.paged:
                need = self._pages_for(prompt)
                clone_src = self._clone_source(prompt) \
                    if self.prefix_sharing else None
                if clone_src is not None:
                    cost = 0   # every page shared by reference
                else:
                    # pages to draw from the free pools: the unmatched
                    # ones plus cached (ref 0) matches, which are revived
                    # out of the free pool; live matches are free
                    matched = self.alloc.index.match(
                        prompt, self.page_size) if self.prefix_sharing \
                        else []
                    cost = need - sum(1 for pid in matched
                                      if self.alloc.refcount(pid) > 0)
                want = min(cost + 1, self.alloc.num_pages)
                if want > self.alloc.free_pages:
                    break   # head-of-line blocks until a release frees pages
            self.queue.pop(0)
            self.admitted.append(req_id)
            self._set_phase(req_id, "prefill")
            self.slot_req[slot] = req_id
            self._slot_prompt[slot] = list(prompt)
            self.out[req_id] = list(prompt)
            self.request_emitted.setdefault(req_id, 0)
            self._admit_seq[slot] = self._admit_counter
            self._admit_counter += 1
            if clone_src is not None:
                # whole-table fork: no prefill compute; the first write
                # into a shared page forks it
                self.alloc.clone_table(clone_src, slot)
                self._sync_tables()
                self.pos[slot] = len(prompt)
                self.active[slot] = True
                self._set_phase(req_id, "decode")
                continue
            adopted = self.alloc.adopt_prefix(slot, prompt) \
                if self.prefix_sharing else 0
            if adopted:
                self._sync_tables()
            if adopted >= len(prompt):
                # a page-aligned prompt served whole from the index
                self.pos[slot] = len(prompt)
                self.active[slot] = True
                self._set_phase(req_id, "decode")
            else:
                self._prefill_len[slot] = len(prompt)
                self._prefill_done[slot] = adopted

    def _plan_chunk(self):
        """The chunk's gang: its rows (slot, tokens done, tokens taken)
        and its host inputs (tokens, slots, starts, lengths), with the
        rows' pages allocated (preempting on exhaustion), scrubbed and
        the tables uploaded; None when no prompt is mid-prefill."""
        gang = [s for s in range(self.slots) if self._prefill_len[s] >= 0]
        if not gang:
            return None
        gang.sort(key=lambda s: self._admit_seq[s])
        budget = self.prefill_budget
        rows: list[tuple[int, int, int]] = []
        for s in gang:
            if budget <= 0:
                break
            take = min(budget,
                       int(self._prefill_len[s] - self._prefill_done[s]))
            if take <= 0:
                continue
            rows.append((s, int(self._prefill_done[s]), take))
            budget -= take
        if not rows:
            return None
        if self.paged:
            new: list[int] = []
            for s, done, take in rows:
                while True:
                    try:
                        new += self.alloc.ensure_range(s, done + take)
                        break
                    except PoolExhausted:
                        if not self._preempt_victim(s):
                            raise
            # a preemption may have evicted a later gang member: keep
            # only the rows still mid-prefill
            rows = [(s, d, t) for s, d, t in rows
                    if self._prefill_len[s] >= 0]
            if new:
                self._scrub_pages(new)
            self._sync_tables()
            if not rows:
                return None
        toks = np.zeros((self.slots, self.prefill_budget), np.int32)
        sl = np.zeros(self.slots, np.int32)
        st = np.zeros(self.slots, np.int32)
        ln = np.zeros(self.slots, np.int32)
        for i, (s, done, take) in enumerate(rows):
            toks[i, :take] = self._slot_prompt[s][done:done + take]
            sl[i] = s
            st[i] = done
            ln[i] = take
        # pad rows (length 0) take distinct spare slot ids
        spare = iter(s for s in range(self.slots)
                     if s not in {r[0] for r in rows})
        for i in range(len(rows), self.slots):
            sl[i] = next(spare)
        return rows, (toks, sl, st, ln)

    def _prefill_step(self) -> int:
        """One chunked-prefill gang under the per-step token budget:
        oldest admissions first, each taking up to the budget left.  The
        gang is always (slots, prefill_budget), short rows padded and
        pad rows of length 0, so every chunk's GEMMs have M = slots x
        prefill_budget.  Returns the prompt tokens prefilled.

        Under ``serve.prefill_chunk``: ``serve.prefill_chunk.plan``
        (:meth:`_plan_chunk`), then ``serve.prefill_chunk.dispatch``
        around the inputs' upload and the ``prefill_kv_chunk`` call,
        with ``tokens`` (the prompt tokens in the gang), ``rows``
        (``slots x prefill_budget``) and, traced on CUDA, ``device_ms``
        (:meth:`_read_device_ms`)."""
        tr = self.tracer
        with tr.span("serve.prefill_chunk.plan"):
            plan = self._plan_chunk()
        if plan is None:
            return 0
        rows, host = plan
        dev = self.device
        total = sum(t for _, _, t in rows)
        gang_rows = self.slots * self.prefill_budget
        with EnergyMeter("prefill-chunk", backend=self.power,
                         reporter=self.energy,
                         hints=WorkloadHints(
                             flops=self._tok_flops * total,
                             hbm_bytes=self._gemm_bytes_step,
                             gemm_bytes=self._gemm_bytes_step,
                             f_scale=self.f_scale)) as em, \
                tr.span("serve.prefill_chunk.dispatch", tokens=total,
                        rows=gang_rows) as args:
            inputs = [torch.tensor(a, device=dev) for a in host]
            start = self._device_mark()
            log = self._moe_log()
            self.state = prefill_kv_chunk(self.params, self.cfg, self.state,
                                          *inputs, self.engine, moe_log=log)
            self._close_mark(args, start)
            if log is not None:
                # the valid entries in gang-row order, each row's in turn
                self._moe_queue(
                    args, log,
                    [self.slot_req[s] for s, _, t in rows for _ in range(t)],
                    [p for _, d, t in rows for p in range(d, d + t)])
        self.c_prefill_rows.inc(gang_rows)
        self.chunk_steps += 1
        # charged by the prompt tokens each row processed in the chunk
        for s, done, take in rows:
            r = self.slot_req[s]
            self.request_joules[r] = self.request_joules.get(r, 0.0) \
                + em.reading.joules * take / total
        for s, done, take in rows:
            self._prefill_done[s] = done + take
            if self._prefill_done[s] >= self._prefill_len[s]:
                # prompt fully cached: index its full pages, then decode
                # on the slot's own clock; the first decode feeds the
                # prompt's last token at position len(prompt), the
                # lockstep discipline, which token parity depends on
                if self.prefix_sharing:
                    self.alloc.register_prefix(s, self._slot_prompt[s])
                self._prefill_len[s] = -1
                self._prefill_done[s] = 0
                self.pos[s] = len(self._slot_prompt[s])
                self.active[s] = True
                self._set_phase(self.slot_req[s], "decode")
        return total

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits_row))
        p = np.exp(logits_row / self.temperature -
                   np.max(logits_row / self.temperature))
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _ensure_decode_pages(self) -> None:
        """Every live slot's page for its next position (preempting on
        exhaustion), copy-on-write forks, scrubs and the tables' upload."""
        new: list[int] = []
        for s in range(self.slots):
            while self.active[s]:
                try:
                    new += self.alloc.ensure(s, int(self.pos[s]))
                    break
                except PoolExhausted:
                    if not self._preempt_victim(s):
                        raise
        forked = self._cow_forks() if self.prefix_sharing else False
        if new:
            self._scrub_pages(new)
        if new or forked:
            self._sync_tables()

    def _decode_once(self, max_new: int):
        """One decode step over the live slots: page allocation (with
        preemption on exhaustion), copy-on-write forks, the step, then
        sampling and retirement.  Shared by both schedulers.

        Under ``serve.decode``, in order: ``serve.decode.pages`` (paged
        only: :meth:`_ensure_decode_pages`), ``serve.decode.upload``
        (:meth:`_upload`; ``rows``, the live slots),
        ``serve.decode.dispatch`` (the ``decode_step`` call; traced on
        CUDA, ``device_ms``), ``serve.decode.sync`` (the logits' copy to
        the host, which waits for the stream) and
        ``serve.decode.sample`` (the NaN quarantine, sampling and
        retirement)."""
        tr = self.tracer
        if self.chaos is not None and self.chaos.match(
                "kernel", step=self._iter) is not None:
            # a launch fault of the step, injected before any launch
            raise InjectedFault("kernel", f"step={self._iter}")
        if self.paged:
            with tr.span("serve.decode.pages"):
                self._ensure_decode_pages()
        toks = np.zeros((self.slots, 1), np.int32)
        for s in range(self.slots):
            if self.active[s]:
                toks[s, 0] = self.out[self.slot_req[s]][-1]
        n_active = int(self.active.sum())
        attn_bytes = self._attn_bytes_step()
        # the report keeps the peak per-step attention traffic
        self.energy.meta["attn_bytes_step"] = max(
            self.energy.meta["attn_bytes_step"], attn_bytes)
        with EnergyMeter("decode-step", backend=self.power,
                         reporter=self.energy,
                         hints=WorkloadHints(
                             flops=self._tok_flops * n_active,
                             hbm_bytes=self._gemm_bytes_step + attn_bytes,
                             attn_bytes=attn_bytes,
                             gemm_bytes=self._gemm_bytes_step,
                             f_scale=self.f_scale)) as em:
            with tr.span("serve.decode.upload", rows=n_active):
                inputs = self._upload(toks, self.pos, self.active)
                # a routed moe: the live rows, and the step's counts
                live = np.flatnonzero(self.active)
                moe = {"rows": torch.tensor(live, device=self.device),
                       "moe_log": self._moe_log()} \
                    if self.cfg.routed_moe else {}
            self.c_decode_rows.inc(n_active)
            self.c_decode_steps.inc()
            with tr.span("serve.decode.dispatch") as args:
                start = self._device_mark()
                logits = self._step(*inputs, **moe)
                self._close_mark(args, start)
                if moe:
                    self._moe_queue(args, moe["moe_log"],
                                    [self.slot_req[s] for s in live],
                                    self.pos[live])
            with tr.span("serve.decode.sync"):
                logits = logits[:, 0].float().cpu().numpy()
            if self._device_marks:
                self._read_device_ms()
            if self._moe_pending:
                self._read_moe()
        # one token per live slot: an even split
        j_per_req = em.reading.joules / max(n_active, 1)
        for s in range(self.slots):
            if self.active[s]:
                r = self.slot_req[s]
                self.request_joules[r] = \
                    self.request_joules.get(r, 0.0) + j_per_req
        with tr.span("serve.decode.sample"):
            self._sample_and_retire(logits, max_new)

    def _sample_and_retire(self, logits: np.ndarray, max_new: int) -> None:
        """After a decode step's logits reach the host: the NaN
        quarantine, then a token per live slot and the retirement of
        finished requests."""
        # NaN/Inf quarantine: injected poisoning first, then the scan.
        # Only the offending slot's request fails; the others sample this
        # very step.  It never raises and runs after every retryable
        # fault point of the iteration, so a replay cannot revive a
        # request failed here.
        if self.chaos is not None:
            for s in range(self.slots):
                if self.active[s] and self.chaos.match(
                        "nan", step=self._iter,
                        request=self.slot_req[s]) is not None:
                    if not logits.flags.writeable:
                        logits = np.array(logits)
                    logits[s, :] = np.nan
        if self.guards:
            finite = np.isfinite(logits).all(axis=1)
            for s in range(self.slots):
                if self.active[s] and not finite[s]:
                    self._fault("nan", req=self.slot_req[s], slot=s)
                    self._fail_slot(s, "nan")
        t_tok = time.monotonic()
        for s in range(self.slots):
            if not self.active[s]:
                continue
            tok = self._sample(logits[s])
            r = self.slot_req[s]
            self.out[r].append(tok)
            self.request_emitted[r] += 1
            if r not in self.first_token_s:
                self.first_token_s[r] = t_tok
            self.pos[s] += 1
            if tok == self.eos_id or self.request_emitted[r] >= max_new:
                self.active[s] = False
                self._slot_prompt[s] = None
                self._finish_request(r)
                self._release(s)

    def _pending(self) -> bool:
        return bool(self.queue or self.active.any()
                    or (self._prefill_len >= 0).any())

    def _iteration_body(self, max_new: int) -> None:
        """One scheduler iteration under the ``serve.step`` span:
        injected straggler and step faults first, deadlines next, then
        admission (alloc faults), prefill and decode (kernel faults), and
        the NaN quarantine last -- every retryable point precedes the
        quarantine, so a replay never revives a request it failed."""
        tr = self.tracer
        it = self._iter
        if self.chaos is not None:
            ev = self.chaos.match("straggler", step=it)
            if ev is not None:
                # counted at injection: the EMA watchdog needs warmup
                self._fault("straggler", step=it, seconds=ev.seconds)
                time.sleep(ev.seconds)
            self.chaos.check("step", step=it)
        with tr.span("serve.step", mode=self.mode):
            self._enforce_deadlines()
            if self.mode == "continuous":
                with tr.span("serve.admit"):
                    self._admit_continuous(max_new)
                with tr.span("serve.prefill_chunk"):
                    n = self._prefill_step()
                self.prefill_tokens_per_step.append(n)
                if n:
                    self.m_prefill_tok.observe(n)
            else:
                with tr.span("serve.admit"):
                    self._admit(max_new)
            if self.active.any():
                with tr.span("serve.decode"):
                    self._decode_once(max_new)

    def _recover(self, e: TransientFault, attempt: int) -> None:
        """After a transient fault: rewind to the last snapshot
        (restore-and-replay), then back off exponentially.  There is no
        kernel fallback to engage."""
        if self.snapshotter is not None:
            t0 = time.perf_counter()
            with self.tracer.span("serve.restore", attempt=attempt,
                                  error=repr(e)):
                self.snapshotter.restore()
            self.c_restores.inc()
            self.h_restore_ms.observe((time.perf_counter() - t0) * 1e3)
        back = self.config.retry_backoff_s
        if back:
            time.sleep(min(back * 2 ** (attempt - 1), 1.0))

    def _run_iteration(self, max_new: int) -> None:
        """One iteration with bounded retry: snapshot on cadence, run the
        body, and on a :class:`TransientFault` count it, restore and
        replay, at most ``max_step_retries`` times (then it propagates).
        Anything else propagates at once."""
        if self.snapshotter is not None:
            self.snapshotter.maybe_snapshot(self._iter)
        if self.chaos is not None:
            _chaos.set_context(step=self._iter)
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                self._iteration_body(max_new)
                break
            except TransientFault as e:
                attempt += 1
                point = getattr(e, "point", "step")
                self._fault(point, error=repr(e), attempt=attempt)
                self.c_retries.inc()
                if attempt > self.config.max_step_retries:
                    raise
                self._recover(e, attempt)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.m_step.observe(dt_ms)
        # EMA step-time watchdog; the first iterations are skipped
        if self.guards and self._iter >= 2 \
                and self.straggler.observe(self._iter, dt_ms / 1e3):
            self._fault("straggler_detected", step=self._iter, ms=dt_ms)
        self._pump_gauges()
        self._iter += 1

    def run(self, max_new: int = 32) -> dict[int, list[int]]:
        """Serve until queue and slots drain (max_new tokens per
        request, tracked per request so a preempted request resumes its
        budget), each iteration under :meth:`_run_iteration` with the
        chaos injector installed as this thread's fault source.  Returns
        request id -> prompt + generated tokens (a failed request keeps
        what it had; one failed before admission has no entry)."""
        with _chaos.install(self.chaos):
            while self._pending():
                self._run_iteration(max_new)
        self.energy.meta["latency"] = self.latency_summary()
        return self.out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--layout", default="contiguous",
                    choices=["contiguous", "paged"],
                    help="KV cache layout: per-slot strips (a ring of one "
                         "window under SWA) or the paged pool")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--mode", default="lockstep",
                    choices=["lockstep", "continuous"],
                    help="scheduler: lockstep (whole-prompt prefill at "
                         "admission) or continuous batching with chunked "
                         "prefill")
    ap.add_argument("--prefill-budget", type=int, default=32,
                    help="most prompt tokens prefilled per step (with "
                         "--mode continuous)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="turn copy-on-write prompt-prefix sharing off "
                         "(it applies with --mode continuous only)")
    ap.add_argument("--schedule", default=None,
                    help="GEMM tile schedule of the SFC kernel, 'xla' for "
                         "the torch.matmul baseline, or 'auto' for the "
                         "tuner (default: morton, auto with --objective)")
    ap.add_argument("--objective", default=None,
                    choices=["time", "energy", "edp"],
                    help="route every GEMM through the autotuner "
                         "adjudicated on this metric")
    ap.add_argument("--power-backend", default=None,
                    choices=["rapl", "nvml", "model"],
                    help="pin the energy telemetry backend (default: auto, "
                         "which prefers RAPL, the CPU package, where it is "
                         "readable; nvml is the card)")
    ap.add_argument("--energy-report", default=None, metavar="PATH",
                    help="write the per-step energy report JSON here")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="time-to-first-token SLO target in ms; per-"
                         "request attainment is counted and summarised")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the span trace as JSONL here (convert / "
                         "validate with python -m repro_torch.obs.trace, "
                         "load the converted JSON in Perfetto)")
    ap.add_argument("--metrics-report", default=None, metavar="PATH",
                    help="write the metrics registry snapshot JSON here")
    ap.add_argument("--no-obs", action="store_true",
                    help="turn the metrics and spans off entirely")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline on the arrival clock; "
                         "expired requests finish with an error")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault-injection schedule, e.g. "
                         "'alloc@step=2,nan@step=3:req=1,"
                         "straggler@step=4:delay=0.3'")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="serve-state snapshot cadence in scheduler "
                         "iterations (default: 1 under --chaos, else "
                         "off)")
    ap.add_argument("--snapshot-dir", default=None, metavar="PATH",
                    help="also write snapshots to disk through the "
                         "checkpoint store (default: in memory only)")
    ap.add_argument("--shed-occupancy", type=float, default=None,
                    help="shed queued requests when page-pool occupancy "
                         "crosses this watermark (0..1]")
    ap.add_argument("--shed-violation-rate", type=float, default=None,
                    help="shed queued requests when the observed SLO-"
                         "violation rate crosses this watermark (0..1]")
    ap.add_argument("--max-step-retries", type=int, default=2,
                    help="bounded retries per scheduler iteration on a "
                         "transient fault")
    ap.add_argument("--no-fault-guards", action="store_true",
                    help="turn off the NaN quarantine and the straggler "
                         "watchdog")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no serving loop")
    dev = resolve_device(args.device)
    serve_cfg = ServeConfig(
        slots=args.slots, cache_len=args.cache_len,
        temperature=args.temperature, seed=args.seed, layout=args.layout,
        page_size=args.page_size, num_pages=args.num_pages, mode=args.mode,
        prefill_budget=args.prefill_budget,
        prefix_sharing=not args.no_prefix_sharing,
        objective=args.objective, latency_slo_ms=args.slo_ms,
        obs=not args.no_obs, fault_guards=not args.no_fault_guards,
        deadline_ms=args.deadline_ms,
        max_step_retries=args.max_step_retries,
        snapshot_every=args.snapshot_every, snapshot_dir=args.snapshot_dir,
        shed_occupancy=args.shed_occupancy,
        shed_violation_rate=args.shed_violation_rate, chaos=args.chaos)
    tracer = None
    if args.trace and not args.no_obs:
        from repro_torch.obs import set_default_tracer
        # the process default, so spans opened below the loop land in it
        tracer = Tracer(enabled=True)
        set_default_tracer(tracer)
    if dev.type == "cuda" and args.schedule != "xla":
        from repro_torch.kernels import _build
        secs = _build.build()   # first-use nvcc, kept out of the timing
        print(f"[serve] kernels built in {max(secs.values()):.1f}s")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(cfg, gen, device=dev)
    loop = ServeLoop(cfg, params, serve_cfg,
                     engine=DotEngine(schedule=args.schedule)
                     if args.schedule else None,
                     power_backend=detect_backend(args.power_backend),
                     tracer=tracer, device=dev)
    rng = np.random.default_rng(args.seed)
    for r in range(args.requests):
        loop.submit(r, rng.integers(2, cfg.vocab, size=args.prompt_len).tolist())
    t0 = time.perf_counter()
    out = loop.run(max_new=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_new = sum(len(v) - args.prompt_len for v in out.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}: {args.requests} requests "
          f"({args.mode}, {loop.attn_spec.tag()}), {total_new} tokens, "
          f"{loop.steps} decode steps and {loop.chunk_steps} prefill chunks "
          f"in {dt:.2f}s ({total_new / max(dt, 1e-9):.1f} tok/s), "
          f"{loop.preemptions} preemptions")
    totals = loop.energy.totals()
    fs = loop.f_scales
    print(f"[serve] energy ({loop.power.name}, objective={loop.objective}, "
          f"f_scale proj {fs['proj']:g} / mlp {fs['mlp']:g} / attn "
          f"{fs['attn']:g}): {totals['joules']:.2f} J over "
          f"{len(loop.energy.readings)} readings, "
          f"{totals['joules'] / max(total_new, 1):.3f} J/token")
    print(f"[serve] modeled per decode step: "
          f"~{loop.energy.meta['attn_bytes_step'] / 1e6:.2f} MB KV "
          f"traffic ({loop.attn_spec.tag()}) next to "
          f"~{loop.energy.meta['gemm_bytes_step'] / 1e6:.2f} MB of weights;"
          f" fused epilogues save ~{loop.ep_saved_step / 1e6:.2f} MB")
    if args.chaos or loop.errors or loop.snapshotter is not None:
        snaps = loop.snapshotter.snapshots if loop.snapshotter else 0
        rests = loop.snapshotter.restores if loop.snapshotter else 0
        print(f"[serve] fault tolerance: {snaps} snapshots, {rests} "
              f"restores, {len(loop.errors)} failed requests")
        for r, reason in sorted(loop.errors.items()):
            print(f"  req {r}: failed ({reason})")
        if loop.chaos is not None:
            print(f"[serve] chaos: {len(loop.chaos.fired)} injected "
                  f"faults {loop.chaos.fired}, schedule "
                  f"{'exhausted' if loop.chaos.exhausted() else 'open'}")
    for r, toks in sorted(out.items()):
        print(f"  req {r}: {toks[:args.prompt_len]} -> "
              f"{toks[args.prompt_len:][:8]}... "
              f"({loop.request_joules.get(r, 0.0):.2f} J)")
    lat = loop.energy.meta["latency"]
    ttft, tpot, e2e = lat["ttft_ms"], lat["tpot_ms"], lat["e2e_ms"]
    if ttft["count"]:
        print(f"[serve] latency (host clock): TTFT p50 {ttft['p50']:.1f} / "
              f"p95 {ttft['p95']:.1f} / p99 {ttft['p99']:.1f} ms, e2e p50 "
              f"{e2e['p50']:.1f} / p99 {e2e['p99']:.1f} ms"
              + (f", TPOT p50 {tpot['p50']:.2f} / p95 {tpot['p95']:.2f} / "
                 f"p99 {tpot['p99']:.2f} ms a token" if tpot["count"]
                 else ""))
    slo = lat["slo"]
    if slo["target_ms"] is not None:
        n = slo["met"] + slo["violations"]
        print(f"[serve] SLO (TTFT <= {slo['target_ms']:g} ms): "
              f"{slo['met']}/{n} met, {slo['violations']} violations")
    if args.energy_report:
        loop.energy.write(args.energy_report)
        print(f"[serve] wrote energy report to {args.energy_report}")
    if args.metrics_report:
        loop.metrics.write(args.metrics_report)
        print(f"[serve] wrote metrics snapshot to {args.metrics_report}")
    if tracer is not None:
        tracer.write_jsonl(args.trace)
        print(f"[serve] wrote {len(tracer.events)} trace events to "
              f"{args.trace} (python -m repro_torch.obs.trace {args.trace} "
              f"-o trace.json for Perfetto)")
    return out


if __name__ == "__main__":
    main()
