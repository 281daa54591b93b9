"""Batched serving loop over the paged KV cache, lockstep or continuous
(port of the paged paths of ``repro.launch.serve.ServeLoop``).

A fixed pool of decode slots shares one paged KV pool (Morton-ordered
physical pages, per-slot block tables, copy-free release).  Two
schedulers (:attr:`repro_torch.serve.ServeConfig.mode`):

* ``lockstep``: a request's whole prompt is prefilled at admission,
  token by token through the decode step with a one-hot row mask; live
  slots then decode together, each on its own position.
* ``continuous``: requests join and leave mid-flight.  Prompts are
  prefilled in chunks (``prefill_kv_chunk``, one gang of ``slots`` rows
  x ``prefill_budget`` tokens a step) interleaved with decode steps, so
  a long prompt never stalls the slots already decoding.  With
  ``prefix_sharing`` (the default), slots whose prompts share
  page-aligned prefixes map the same pages through a prefix index, an
  identical prompt clones its live source's whole block table, and a
  write into a shared page forks a private copy first (copy-on-write).

Both schedulers give the same greedy tokens for the same requests, as
in the reference.  Pool exhaustion preempts the most recently admitted
other busy slot, which rejoins the queue with its full context.  Every
projection runs through the SFC GEMM kernel (the rows path in decode,
the tile path in a prefill chunk) and every decode step's attention
through the paged decode kernel when the engine has a curve schedule
and the device is ``cuda``; a chunk's attention over its slots' pages
is plain torch, as it is XLA in the reference.

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

Not ported yet (ROADMAP.md): the contiguous layout, chaos injection,
snapshots, observability, the NaN guard, deadlines and load shedding.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
      --mode continuous --requests 6 --max-new 16 \\
      --power-backend nvml --energy-report report.json

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
from repro_torch.models import DotEngine, decode_step, \
    fused_epilogue_savings_bytes, init_model, prefill_kv_chunk
from repro_torch.power import EnergyMeter, EnergyReport, WorkloadHints, \
    detect_backend
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


def _engine_for(engine: DotEngine | None,
                objective: str | None) -> DotEngine:
    """The loop's GEMM engine: without an objective the explicit engine
    or the Morton default; with one, the tuner-routed engine under that
    metric (an explicit engine is re-stamped with it)."""
    if objective is None:
        return engine or DotEngine()
    from repro_torch.tune.objective import OBJECTIVES
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; choose from {OBJECTIVES}")
    if engine is None:
        return DotEngine(schedule="auto", objective=objective)
    if engine.objective != objective:
        return dataclasses.replace(engine, objective=objective)
    return engine


class ServeLoop:
    """Lockstep or continuous serving over the paged KV pool.

    ``params`` must already live on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``).  ``engine`` defaults to
    ``DotEngine()``, the Morton-scheduled SFC GEMM (with an objective,
    ``schedule="auto"``).  ``power_backend`` meters every step (default
    :func:`~repro_torch.power.detect_backend`)."""

    def __init__(self, cfg, params, config: ServeConfig | None = None, *,
                 engine: DotEngine | None = None, power_backend=None,
                 device=None):
        sc = config if config is not None else ServeConfig()
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
                    "continuous batching does not support SWA rings yet")
        self.config = sc
        self.cfg = cfg
        self.params = params
        self.engine = _engine_for(engine, sc.objective)
        self.objective = sc.objective or "time"
        self.mode = sc.mode
        self.slots = sc.slots
        self.cache_len = sc.cache_len
        self.page_size = sc.page_size
        self.prefill_budget = sc.prefill_budget
        # prefix sharing needs the mid-flight admissions that make a
        # shared prefix reachable (continuous)
        self.prefix_sharing = bool(sc.prefix_sharing
                                   and sc.mode == "continuous")
        self.attn_spec = AttnSpec("paged", sc.page_size)
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
        self.alloc, self.state = init_paged_serving(
            cfg, sc.slots, sc.cache_len, page_size=sc.page_size,
            num_pages=sc.num_pages, prefix_sharing=self.prefix_sharing,
            device=self.device)
        self._perm_np = page_permutation(cfg.n_layers, self.alloc.num_pages)
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
        the allocated pages, scaled by the sharing ratio."""
        if not self.cfg.has_attention:
            return 0.0
        spec = self.attn_spec
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
    def _sync_tables(self):
        self.state["block_tables"] = torch.tensor(
            self.alloc.block_table, device=self.device)

    def _scrub_pages(self, page_ids):
        """Zero the physical rows (all layers) of newly allocated pages
        that were freed before; a fresh pool is already zero.  COW forks
        skip this (their copy overwrites every row), and so do adopted
        prefix pages (their content is the requested prefix)."""
        dirty = [pid for pid in page_ids if self.alloc.was_freed(pid)]
        rows = [int(r) for pid in dirty for r in self._perm_np[:, pid]]
        if rows:
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
                forked = True
                break
        return forked

    def _step(self, toks: np.ndarray, pos, mask: np.ndarray):
        dev = self.device
        logits, self.state = decode_step(
            self.params, self.cfg, self.state,
            torch.tensor(toks, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            self.engine, row_mask=torch.tensor(mask, device=dev))
        self.steps += 1
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
        self.alloc.release(victim)
        self._sync_tables()
        self.preemptions += 1
        self.queue.insert(0, (req, list(self.out[req])))
        return True

    # -------------------------------------------------------- scheduling --
    def submit(self, req_id: int, prompt: list[int]):
        self.queue.append((req_id, list(prompt)))

    def _admit(self):
        """Lockstep admission: whole-prompt prefill, token by token
        through the decode step with only the admitted slot writing."""
        for slot in range(self.slots):
            if self.active[slot] or not self.queue:
                continue
            req_id, prompt = self.queue[0]
            need = pages_needed(len(prompt), self.page_size)
            if need > self.alloc.num_pages:
                raise RuntimeError(
                    f"prompt of {len(prompt)} tokens exceeds the whole page "
                    f"pool ({self.alloc.num_pages} pages x {self.page_size} "
                    f"tokens)")
            # +1 decode-headroom page when the pool can ever supply it
            want = min(need + 1, self.alloc.num_pages)
            if want > self.alloc.free_pages:
                break   # head-of-line blocks until a release frees pages
            self.queue.pop(0)
            self.admitted.append(req_id)
            self._scrub_pages(self.alloc.ensure_range(slot, len(prompt)))
            self._sync_tables()
            mask = np.zeros(self.slots, bool)
            mask[slot] = True
            # one "prefill" reading, all of it this request's
            with EnergyMeter("prefill", backend=self.power,
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
                    self._step(toks, i, mask)
            self.request_joules[req_id] = \
                self.request_joules.get(req_id, 0.0) + em.reading.joules
            self.pos[slot] = len(prompt)
            self.active[slot] = True
            self.slot_req[slot] = req_id
            self._slot_prompt[slot] = list(prompt)
            self.out[req_id] = list(prompt)
            self.request_emitted.setdefault(req_id, 0)
            self._admit_seq[slot] = self._admit_counter
            self._admit_counter += 1

    def _clone_source(self, prompt: list[int]) -> int | None:
        """A live, fully prefilled slot whose admitted prompt equals
        ``prompt``: its whole block table (partial tail included) can be
        shared by reference."""
        for s in range(self.slots):
            if self.active[s] and self._slot_prompt[s] == prompt:
                return s
        return None

    def _admit_continuous(self):
        """Continuous admission: claim a free slot at once, share what
        the prefix index already holds (or clone a live identical
        prompt's table), and leave the rest of the prompt to the chunked
        prefill stream."""
        for slot in range(self.slots):
            if not self.queue:
                break
            if self.active[slot] or self._prefill_len[slot] >= 0:
                continue
            req_id, prompt = self.queue[0]
            need = pages_needed(len(prompt), self.page_size)
            if need > self.alloc.num_pages:
                raise RuntimeError(
                    f"prompt of {len(prompt)} tokens exceeds the whole page "
                    f"pool ({self.alloc.num_pages} pages x {self.page_size} "
                    f"tokens)")
            clone_src = self._clone_source(prompt) \
                if self.prefix_sharing else None
            if clone_src is not None:
                cost = 0   # every page shared by reference
            else:
                # pages to draw from the free pools: the unmatched ones
                # plus cached (ref 0) matches, which are revived out of
                # the free pool; live matches are adopted for free
                matched = self.alloc.index.match(prompt, self.page_size) \
                    if self.prefix_sharing else []
                cost = need - sum(1 for pid in matched
                                  if self.alloc.refcount(pid) > 0)
            want = min(cost + 1, self.alloc.num_pages)
            if want > self.alloc.free_pages:
                break   # head-of-line blocks until a release frees pages
            self.queue.pop(0)
            self.admitted.append(req_id)
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
                continue
            adopted = self.alloc.adopt_prefix(slot, prompt) \
                if self.prefix_sharing else 0
            if adopted:
                self._sync_tables()
            if adopted >= len(prompt):
                # a page-aligned prompt served whole from the index
                self.pos[slot] = len(prompt)
                self.active[slot] = True
            else:
                self._prefill_len[slot] = len(prompt)
                self._prefill_done[slot] = adopted

    def _prefill_step(self) -> int:
        """One chunked-prefill gang under the per-step token budget:
        oldest admissions first, each taking up to the budget left.  The
        gang is always (slots, prefill_budget), short rows padded and
        pad rows of length 0, so every chunk's GEMMs have M = slots x
        prefill_budget.  Returns the prompt tokens prefilled."""
        gang = [s for s in range(self.slots) if self._prefill_len[s] >= 0]
        if not gang:
            return 0
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
            return 0
        new: list[int] = []
        for s, done, take in rows:
            while True:
                try:
                    new += self.alloc.ensure_range(s, done + take)
                    break
                except PoolExhausted:
                    if not self._preempt_victim(s):
                        raise
        # a preemption may have evicted a later gang member: keep only
        # the rows still mid-prefill
        rows = [(s, d, t) for s, d, t in rows if self._prefill_len[s] >= 0]
        if new:
            self._scrub_pages(new)
        self._sync_tables()
        if not rows:
            return 0
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
        dev = self.device
        total = sum(t for _, _, t in rows)
        with EnergyMeter("prefill-chunk", backend=self.power,
                         reporter=self.energy,
                         hints=WorkloadHints(
                             flops=self._tok_flops * total,
                             hbm_bytes=self._gemm_bytes_step,
                             gemm_bytes=self._gemm_bytes_step,
                             f_scale=self.f_scale)) as em:
            self.state = prefill_kv_chunk(
                self.params, self.cfg, self.state,
                torch.tensor(toks, device=dev), torch.tensor(sl, device=dev),
                torch.tensor(st, device=dev), torch.tensor(ln, device=dev),
                self.engine)
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
        return total

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits_row))
        p = np.exp(logits_row / self.temperature -
                   np.max(logits_row / self.temperature))
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def _decode_once(self, max_new: int):
        """One decode step over the live slots: page allocation (with
        preemption on exhaustion), copy-on-write forks, the step, then
        sampling and retirement.  Shared by both schedulers."""
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
            logits = self._step(toks, self.pos, self.active)
            logits = logits[:, 0].float().cpu().numpy()   # synchronises
        # one token per live slot: an even split
        j_per_req = em.reading.joules / max(n_active, 1)
        for s in range(self.slots):
            if self.active[s]:
                r = self.slot_req[s]
                self.request_joules[r] = \
                    self.request_joules.get(r, 0.0) + j_per_req
        for s in range(self.slots):
            if not self.active[s]:
                continue
            tok = self._sample(logits[s])
            r = self.slot_req[s]
            self.out[r].append(tok)
            self.request_emitted[r] += 1
            self.pos[s] += 1
            if tok == self.eos_id or self.request_emitted[r] >= max_new:
                self.active[s] = False
                self._slot_prompt[s] = None
                # copy-free: the slot drops its references; pages return
                # to a free pool only at refcount zero
                self.alloc.release(s)
                self._sync_tables()

    def _pending(self) -> bool:
        return bool(self.queue or self.active.any()
                    or (self._prefill_len >= 0).any())

    def _iteration_body(self, max_new: int) -> None:
        """One scheduler iteration: admission, then (continuous) one
        prefill chunk, then one decode step over the live slots."""
        if self.mode == "continuous":
            self._admit_continuous()
            self.prefill_tokens_per_step.append(self._prefill_step())
        else:
            self._admit()
        if self.active.any():
            self._decode_once(max_new)

    def run(self, max_new: int = 32) -> dict[int, list[int]]:
        """Serve until queue and slots drain (max_new tokens per
        request, tracked per request so a preempted request resumes its
        budget).  Returns request id -> prompt + generated tokens."""
        while self._pending():
            self._iteration_body(max_new)
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
    ap.add_argument("--layout", default="paged",
                    choices=["contiguous", "paged"],
                    help="KV cache layout (only paged is ported)")
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    serve_cfg = ServeConfig(
        slots=args.slots, cache_len=args.cache_len,
        temperature=args.temperature, seed=args.seed, layout=args.layout,
        page_size=args.page_size, num_pages=args.num_pages, mode=args.mode,
        prefill_budget=args.prefill_budget,
        prefix_sharing=not args.no_prefix_sharing,
        objective=args.objective)
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
                     device=dev)
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
          f"({args.mode}, paged p{args.page_size}), {total_new} tokens, "
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
    for r, toks in sorted(out.items()):
        print(f"  req {r}: {toks[:args.prompt_len]} -> "
              f"{toks[args.prompt_len:][:8]}... "
              f"({loop.request_joules.get(r, 0.0):.2f} J)")
    if args.energy_report:
        loop.energy.write(args.energy_report)
        print(f"[serve] wrote energy report to {args.energy_report}")
    return out


if __name__ == "__main__":
    main()
