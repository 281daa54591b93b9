"""Schedule/tiling autotuner for the SFC GEMM (port of
``repro.tune.autotune``).

1. **enumerate** candidate configs (schedule x block sizes x prefetch x
   supertile factor, plus the ``xla`` library baseline), each vetted by
   the contract checker; under :data:`~repro_torch.core.energy.H100`
   only launches the port's SFC kernel takes, one per distinct launch;
2. **pre-filter analytically** with the LRU traffic simulator and the
   index-cost model (:mod:`repro_torch.tune.cost`), no launch;
3. **measure** the surviving top-k on the card (``backend="cuda"``):
   device time by CUDA events on the current stream, the L2 flushed
   before each timed launch, median of ``reps``; on the CPU the tuner
   scores analytically, as the reference does off its accelerator;
4. **persist** the winner in the on-disk JSON cache
   (:mod:`repro_torch.tune.cache`).

``resolve_config`` is the hot-path entry used by
``repro_torch.kernels.ops.sfc_matmul(schedule="auto")``.  Under the
reference's ``HW`` constants every list, estimate and analytic winner
is the reference's.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.energy import F_SCALE_MAX, H100, clamp_f_scale
from repro_torch.obs.metrics import default_registry

from .cache import TuneCache, cache_key, default_cache_path
from .cost import AttnSpec, CommSpec, CostEstimate, EpilogueSpec, \
    TuneConfig, predict, predict_attn, with_f_scale
from .objective import OBJECTIVES, objective_value

__all__ = ["TuneResult", "candidate_configs", "autotune", "resolve_config",
           "measure_config", "f_scale_candidates", "resolved_f_scale",
           "autotune_attn", "resolve_attn_config", "resolved_attn_f_scale",
           "GemmSpec", "DecodeAttnSpec", "resolve", "default_backend"]

_BLOCK_CANDIDATES = (
    (128, 128, 128),
    (256, 256, 128),
    (128, 128, 256),
    (256, 256, 256),
    (512, 256, 128),
)
# the port kernel's tiles: bm, bn multiples of 16 up to 128 (bk sizes no
# buffer); smaller tiles put more blocks on the card's 132 SMs
_H100_BLOCK_CANDIDATES = (
    (128, 128, 128),
    (64, 128, 128),
    (64, 64, 128),
)
_SCHEDULE_CANDIDATES = ("rowmajor", "boustrophedon", "morton", "hilbert",
                        "supertile")
_SUPERTILE_G = (2, 4, 8)
# bytes written before each timed launch: more than the H100's 50 MB L2
_FLUSH_BYTES = 256 * 2 ** 20


def default_backend() -> str:
    """``"cuda"`` where a CUDA device is available, else ``"cpu"``: the
    backend field of cache keys (the reference's is JAX's backend)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def f_scale_candidates(hw=H100) -> tuple[float, ...]:
    """The DVFS dimension of the search space: a small grid spanning
    [hw.f_min, F_SCALE_MAX] (clamped, deduped, nominal always present):
    min, the f_min..nominal midpoint, nominal, and the turbo ceiling."""
    raw = (hw.f_min, (hw.f_min + 1.0) / 2.0, 1.0, F_SCALE_MAX)
    out: list[float] = []
    for f in raw:
        f = clamp_f_scale(hw, f)
        if f not in out:
            out.append(f)
    return tuple(out)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _dtype_name(dtype) -> str:
    """Canonical dtype string for cache keys (``torch.bfloat16``,
    ``"bfloat16"`` and ``np.float32`` name themselves as the reference
    names them)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name if dtype != "bfloat16" else "bfloat16"


def _dtype_bytes(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if dtype == "bfloat16":
        return 2
    return np.dtype(dtype).itemsize


def _timeit(fn, *, reps: int, warmup: int, device: torch.device) -> float:
    """Median seconds of ``fn()``: on a CUDA device, CUDA events on the
    current stream around each launch, the L2 flushed before each (the
    serving GEMMs find their weights cold); on the CPU, which runs
    synchronously, the host clock."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        scratch = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device)
        events = []
        for _ in range(reps):
            scratch.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record(stream)
            fn()
            e.record(stream)
            events.append((s, e))
        torch.cuda.synchronize(device)
        ts = [s.elapsed_time(e) * 1e-3 for s, e in events]
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclass
class TuneResult:
    config: TuneConfig
    key: str
    from_cache: bool
    estimates: list[CostEstimate] = field(default_factory=list)
    measured: dict = field(default_factory=dict)  # repr(cfg) -> seconds

    @property
    def best_estimate(self) -> CostEstimate | None:
        for e in self.estimates:
            if e.config == self.config:
                return e
        return self.estimates[0] if self.estimates else None


def candidate_configs(
    m: int,
    n: int,
    k: int,
    *,
    dtype_bytes: int = 4,
    schedules=_SCHEDULE_CANDIDATES,
    blocks=None,
    include_xla: bool = True,
    hw=H100,
    epilogue: EpilogueSpec | None = None,
) -> list[TuneConfig]:
    """Enumerate the valid search space for an M x N x K GEMM.

    Every non-xla candidate passes the contract checker
    (:func:`repro_torch.analysis.contracts.check_gemm_contract`, fast
    level): the on-chip budget, and ``use_prefetch=False`` only where
    the closed-form decode exists.  Blocks exceeding the (padded)
    problem are dropped as pure padding.  ``blocks`` defaults to the
    reference's list, or under the H100 to the port kernel's tiles;
    under the H100 candidates that are the same launch of the port's
    kernel (:func:`~repro_torch.analysis.contracts.gemm_launch_key`)
    collapse to the first of them.
    """
    from repro_torch.analysis.contracts import check_gemm_contract, \
        gemm_launch_key, port_kernel_hw

    port = port_kernel_hw(hw)
    if blocks is None:
        blocks = _H100_BLOCK_CANDIDATES if port else _BLOCK_CANDIDATES
    out: list[TuneConfig] = []
    if include_xla:
        out.append(TuneConfig(schedule="xla"))
    launches: set = set()
    for bm, bn, bk in blocks:
        if bm > max(m, 128) or bn > max(n, 128) or bk > max(k, 128):
            continue  # block would be pure padding
        mt, nt = -(-m // bm), -(-n // bn)
        for sched in schedules:
            if sched == "supertile":
                cands = [TuneConfig(sched, bm, bn, bk, True, g)
                         for g in _SUPERTILE_G if g < max(mt, nt)]
            else:
                cands = [TuneConfig(sched, bm, bn, bk, True)]
                if sched in ("morton", "hilbert"):
                    cands.append(TuneConfig(sched, bm, bn, bk, False))
            for c in cands:
                if not check_gemm_contract(c, m, n, k,
                                           dtype_bytes=dtype_bytes,
                                           epilogue=epilogue, hw=hw,
                                           level="fast").ok:
                    continue
                if port:
                    key = gemm_launch_key(c, m, n, k, dtype_bytes)
                    if key in launches:
                        continue
                    launches.add(key)
                out.append(c)
    return out


# called with (cfg, m, n, k) immediately before each fresh
# measure_config during a search -- the seam a test uses to prove the
# tuner never launches a rejected candidate.  Hooks must not mutate;
# exceptions propagate.
_PRECOMPILE_HOOKS: list = []


def measure_config(
    cfg: TuneConfig,
    m: int,
    n: int,
    k: int,
    dtype="float32",
    *,
    reps: int = 5,
    warmup: int = 2,
    seed: int = 0,
    batched: bool = False,
    epilogue: EpilogueSpec | None = None,
    device=None,
) -> float:
    """Median seconds of one GEMM under ``cfg`` on ``device`` (default
    ``cuda``): the SFC kernel (B1, or B3 with ``batched=True``, a batch
    of 2 reported per element) or, for ``"xla"``, the library GEMM the
    serving path would run (``ops.library_matmul``: on bf16 CUDA
    operands one bf16 GEMM with f32 output, then the same epilogue), on
    operands made from ``seed``.  On a CUDA
    device the time is the device's, by CUDA events
    (:func:`_timeit`)."""
    from repro_torch.kernels.ops import sfc_matmul, sfc_matmul_batched

    dev = torch.device(device or "cuda")
    tdt = _TORCH_DTYPES[_dtype_name(dtype)]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(tdt)

    kw = dict(schedule=cfg.schedule, bm=cfg.bm, bn=cfg.bn, bk=cfg.bk,
              use_prefetch=cfg.use_prefetch, g=cfg.g)
    if epilogue is not None and not epilogue.is_noop:
        kw["activation"] = epilogue.activation
        if epilogue.bias:
            kw["bias"] = rand(n)
    lead = (2,) if batched else ()
    a, b = rand(*lead, m, k), rand(*lead, k, n)
    if epilogue is not None and epilogue.residual:
        kw["residual"] = rand(*lead, m, n)
    fn = sfc_matmul_batched if batched else sfc_matmul
    t = _timeit(lambda: fn(a, b, **kw), reps=reps, warmup=warmup, device=dev)
    return t / 2 if batched else t


def _device_of(backend: str) -> torch.device:
    """The device a measurement on ``backend`` runs on."""
    return torch.device("cuda" if backend == "cuda" else "cpu")


def _should_measure(backend: str) -> bool:
    env = os.environ.get("REPRO_TUNE_MEASURE")
    if env is not None:
        return env not in ("", "0")
    return backend == "cuda"  # CPU times say nothing of the card


def autotune(
    m: int,
    n: int,
    k: int,
    dtype="float32",
    *,
    backend: str | None = None,
    hw=H100,
    topk: int = 3,
    measure: bool | None = None,
    cache: TuneCache | None = None,
    refresh: bool = False,
    capacity: int | None = None,
    candidates: list[TuneConfig] | None = None,
    batched: bool = False,
    objective: str = "time",
    f_scales: tuple[float, ...] | None = None,
    epilogue: EpilogueSpec | None = None,
    comm: CommSpec | None = None,
) -> TuneResult:
    """Pick the best GEMM config for (M, N, K, dtype) on ``backend``.

    Cache hit returns immediately.  Otherwise: analytic ranking of the
    full candidate set, then (``measure``) adjudication of the ``topk``
    survivors, then the winner is persisted.  ``objective`` scores
    candidates as wall time, joules, or energy-delay product
    (:mod:`repro_torch.tune.objective`); each objective has its own cache
    keyspace.  ``epilogue`` is the fused bias/activation/residual the
    caller attaches (DESIGN.md §9): kernel candidates are scored on
    fused traffic (no C round trip), the xla baseline on the unfused
    pipeline, and the winner is cached under an epilogue-tagged key.
    ``capacity`` pins the simulated cache size in blocks (tests);
    ``refresh`` forces a re-search.

    The search space is every kernel candidate crossed with the DVFS
    grid (``f_scales``, default :func:`f_scale_candidates`; pass ``()``
    to pin candidates at their own frequency).  Each kernel config pays
    one LRU replay -- frequency variants are re-derived analytically
    (:func:`repro_torch.tune.cost.with_f_scale`) -- so widening the space by
    the frequency axis costs sort time, not simulation time.  Wall-time
    measurement runs at the host's actual (nominal) frequency, since
    userspace cannot set the DVFS point of the accelerator it is
    timing: ``objective="time"`` adjudicates on the raw measurement,
    while energy/EDP scoring scales the nominal measurement by the
    model's own DVFS slowdown ratio for the static term.

    ``comm`` is the collective the caller's mesh implies (DESIGN.md
    §15): candidates are scored with the hop-weighted bytes-over-links
    term (:func:`repro_torch.tune.cost.predict` with ``comm=``) and the winner
    is cached under the mesh keyspace (``.../comm=tp8-h2.50``), so
    single-chip winners never leak onto a mesh and vice versa.
    """
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; choose from {OBJECTIVES}")
    dtype_name = _dtype_name(dtype)
    dtype_bytes = _dtype_bytes(dtype)
    backend = backend or default_backend()
    if cache is None:  # NB: empty TuneCache is falsy (__len__), never `or`
        cache = TuneCache()
    if epilogue is not None and epilogue.is_noop:
        epilogue = None
    key = cache_key(m, n, k, dtype_name, backend, batched=batched,
                    objective=objective,
                    epilogue=epilogue.tag() if epilogue else None,
                    comm=comm.tag() if comm else None)

    if not refresh:
        hit = cache.get(key)
        if hit is not None:
            return TuneResult(TuneConfig.from_dict(hit["config"]), key,
                              from_cache=True)

    if candidates is not None:
        # explicit candidate lists (tests, sweeps, replays of stale
        # caches) go through the same static contract gate the
        # enumerator applies -- a rejected config must never reach
        # predict(), let alone a compile
        from repro_torch.analysis.contracts import check_gemm_contract

        cands = []
        for c in candidates:
            rep = check_gemm_contract(c, m, n, k,
                                      dtype_bytes=dtype_bytes,
                                      epilogue=epilogue, hw=hw,
                                      level="fast")
            default_registry().counter("tune.contracts.checked").inc()
            if rep.ok:
                cands.append(c)
            else:
                default_registry().counter("tune.contracts.rejected").inc()
    else:
        cands = candidate_configs(m, n, k, dtype_bytes=dtype_bytes,
                                  hw=hw, epilogue=epilogue)
    # one LRU replay per kernel config; DVFS variants derived analytically
    base: dict[TuneConfig, CostEstimate] = {}
    for c in cands:
        kc = c.kernel_config()
        if kc not in base:
            base[kc] = predict(kc, m, n, k, dtype_bytes, hw=hw,
                               capacity=capacity, epilogue=epilogue,
                               comm=comm)
    fs = f_scale_candidates(hw) if f_scales is None else tuple(
        clamp_f_scale(hw, f) for f in f_scales)
    ests = []
    seen: set[TuneConfig] = set()
    for c in cands:
        b = base[c.kernel_config()]
        for f in dict.fromkeys((clamp_f_scale(hw, c.f_scale),) + fs):
            e = with_f_scale(b, f, hw=hw)
            if e.config not in seen:
                seen.add(e.config)
                ests.append(e)
    ests.sort(key=lambda e: (objective_value(e, objective, hw=hw),
                             e.traffic_bytes))

    if measure is None:
        measure = _should_measure(backend)
    measured: dict = {}
    if measure and ests:
        best, best_score = None, None
        for e in ests[:max(1, topk)]:
            kc = e.config.kernel_config()
            t_nom = measured.get(repr(kc))
            if t_nom is None:
                for hook in _PRECOMPILE_HOOKS:
                    hook(kc, m, n, k)
                t_nom = measure_config(kc, m, n, k, dtype,
                                       batched=batched, epilogue=epilogue,
                                       device=_device_of(backend))
                measured[repr(kc)] = t_nom
                # model-calibration drift (DESIGN.md §12): the ratio of
                # measured wall time to the analytic prediction, one
                # observation per fresh measure_config -- log2 buckets
                # make "within 2x" one bucket, so the histogram is a
                # first-class view of how honest the cost model is
                default_registry().histogram(
                    "tune.drift.time_ratio").observe(
                    t_nom / max(base[kc].time, 1e-12))
            # the host runs at nominal frequency.  objective="time"
            # therefore adjudicates on the *raw* measurement: a DVFS
            # point the device cannot actually switch to must never let
            # a measurably slower kernel outscore a faster one.  For
            # energy/edp the hypothetical operating point is the whole
            # question, so the static term uses the nominal measurement
            # scaled by the model's own DVFS slowdown ratio.
            if objective == "time" or e.config.f_scale == 1.0:
                t = t_nom
            else:
                b = base[kc]
                t = t_nom * (e.time / b.time)
            # the wall clock times the local kernel only -- the
            # collective is not in the measured region -- so the
            # modeled link time floors the measurement (same overlap
            # assumption as the analytic roofline)
            t = max(t, e.t_ici)
            score = objective_value(e, objective, hw=hw, wall_time=t)
            if best_score is None or score < best_score:
                best, best_score = e.config, score
        chosen = best
    else:
        chosen = ests[0].config if ests else TuneConfig()

    # provenance: the *chosen* config's own estimate (measurement may
    # have overturned the analytic ranking); the analytic front-runner
    # is kept under its own key for tuner forensics
    chosen_est = next((e for e in ests if e.config == chosen), None)
    entry = {
        "config": chosen.to_dict(),
        "shape": [int(m), int(n), int(k)],
        "dtype": dtype_name,
        "backend": backend,
        "objective": objective,
        "epilogue": epilogue.tag() if epilogue else "none",
        "comm": comm.tag() if comm else "none",
        "measured": measured,
        "predicted_time": chosen_est.time if chosen_est else None,
        "predicted_score": (objective_value(chosen_est, objective, hw=hw)
                            if chosen_est else None),
        "analytic_best": ({
            "config": ests[0].config.to_dict(),
            "predicted_time": ests[0].time,
            "predicted_score": objective_value(ests[0], objective, hw=hw),
        } if ests else None),
    }
    cache.put(key, entry)
    return TuneResult(chosen, key, from_cache=False, estimates=ests,
                      measured=measured)


# in-process memo for resolve_config: repeated auto-dispatches must not
# re-open/re-parse the JSON file per GEMM call.  Keyed by (cache path,
# bucket key) so test fixtures with distinct temp paths stay isolated.
_RESOLVE_MEMO: dict = {}


def _memoised_resolve(path: str, bucket: str, compute) -> TuneConfig:
    """Shared memo discipline of the resolvers (GEMM and attention).

    Keyed on the cache file's mtime: any on-disk mutation (invalidate(),
    another process re-tuning) makes the memo entry unreachable, so a
    stale winner is never served past an explicit cache change.  The
    winner is stored under the post-search mtime (a fresh search writes
    the file) and only this path's superseded entries are evicted; once
    all buckets are persisted the mtime stops moving and every shape
    resolves from the memo without touching the file.
    """
    def _mtime() -> int:
        try:
            return os.stat(path).st_mtime_ns
        except OSError:
            return 0

    cfg = _RESOLVE_MEMO.get((path, _mtime(), bucket))
    if cfg is None:
        cfg = compute()
        now = _mtime()
        for mk in [mk for mk in _RESOLVE_MEMO
                   if mk[0] == path and mk[1] != now]:
            del _RESOLVE_MEMO[mk]
        _RESOLVE_MEMO[(path, now, bucket)] = cfg
    return cfg


def _validate_for_shape(cfg: TuneConfig, m: int, n: int, k: int,
                        dtype_bytes: int = 4) -> TuneConfig:
    """Re-check a (possibly cached) config against the *exact* serving
    shape, delegating to the static contract checker (fast level) and
    repairing what it flags:

    * ``no-closed-form`` -- winners are bucketed per pow2 range, so a
      use_prefetch=False winner tuned on a square-pow2 tile grid can be
      handed a same-bucket shape whose padded grid has no closed-form
      decode.  Flipping to the scalar-prefetch table is always valid
      (any grid) and at least as fast (index cost amortised to zero).
    * ``vmem-budget`` -- a stale or hand-edited cache entry (or a
      winner tuned at a smaller dtype) whose working set exceeds the budget
      for *this* call would hard-fault the kernel at launch; the blocks
      are clamped to the 128^3 baseline, which fits on every supported
      part.

    repairs preserve every other field -- in particular the tuned
    f_scale, which is a property of the objective, not of the block
    geometry or decode mechanism being swapped here (regression-tested).
    """
    from repro_torch.analysis.contracts import check_gemm_contract

    if cfg.schedule == "xla":
        return cfg
    for _ in range(2):  # each repair can surface at most one more code
        codes = check_gemm_contract(
            cfg, m, n, k, dtype_bytes=dtype_bytes, level="fast").codes()
        if "vmem-budget" in codes:
            cfg = dataclasses.replace(cfg, bm=128, bn=128, bk=128)
        elif "no-closed-form" in codes:
            cfg = dataclasses.replace(cfg, use_prefetch=True)
        else:
            break
    return cfg


def resolve_config(
    m: int,
    n: int,
    k: int,
    dtype="float32",
    *,
    backend: str | None = None,
    cache: TuneCache | None = None,
    batched: bool = False,
    objective: str = "time",
    epilogue: EpilogueSpec | None = None,
    comm: CommSpec | None = None,
) -> TuneConfig:
    """Hot-path ``schedule="auto"`` resolution: cached winner or a fresh
    (analytic + measured-on-the-card) search.  Memoised in-process, so after
    first use per shape bucket it is a dict lookup; safe to call at
    trace time (shapes are static).  ``batched`` keys the 3-D-grid
    kernel's winners separately from the 2-D kernel's (different block
    specs, different optimum); ``objective`` selects the adjudication
    metric, ``epilogue`` the fused bias/activation/residual shape and
    ``comm`` the mesh's collective term (DESIGN.md §15) -- all three key
    the memo and the on-disk cache, so time-tuned, bare-GEMM or
    single-chip winners never leak into an energy/EDP, fused-epilogue
    or multi-chip policy."""
    dtype_name = _dtype_name(dtype)
    bk_ = backend or default_backend()
    if epilogue is not None and epilogue.is_noop:
        epilogue = None
    path = cache.path if cache is not None else default_cache_path()
    bucket = cache_key(m, n, k, dtype_name, bk_, batched=batched,
                       objective=objective,
                       epilogue=epilogue.tag() if epilogue else None,
                       comm=comm.tag() if comm else None)
    cfg = _memoised_resolve(
        path, bucket,
        lambda: autotune(m, n, k, dtype, backend=backend, cache=cache,
                         batched=batched, objective=objective,
                         epilogue=epilogue, comm=comm).config)
    # per-call: validity depends on the exact shape, not the bucket
    return _validate_for_shape(cfg, m, n, k, _dtype_bytes(dtype))


def resolved_f_scale(
    m: int,
    n: int,
    k: int,
    dtype="float32",
    *,
    backend: str | None = None,
    cache: TuneCache | None = None,
    batched: bool = False,
    objective: str = "time",
    epilogue: EpilogueSpec | None = None,
    comm: CommSpec | None = None,
) -> float:
    """The DVFS operating point of the tuned winner for this shape.

    Launch-layer consumers (train.py / serve.py) feed this into their
    per-step :class:`~repro_torch.power.EnergyMeter` hints so the telemetry
    accounts energy at the frequency the objective actually selected,
    not blindly at nominal.  Delegates to :func:`resolve_config`, so it
    shares the memo/cache and is safe to call once at startup.
    """
    return resolve_config(m, n, k, dtype, backend=backend, cache=cache,
                          batched=batched, objective=objective,
                          epilogue=epilogue, comm=comm).f_scale


# ------------------------------------------------------ decode attention ---
def _attn_key(slots: int, cache_len: int, n_kv_heads: int, d_head: int,
              dtype_name: str, backend: str, attn: AttnSpec,
              objective: str, comm: CommSpec | None = None) -> str:
    # attention "shape" for bucketing: (slots, kv width, cache_len)
    return cache_key(slots, n_kv_heads * d_head, cache_len, dtype_name,
                     backend, objective=objective, attn=attn.tag(),
                     comm=comm.tag() if comm else None)


def autotune_attn(
    slots: int,
    cache_len: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    dtype="float32",
    attn: AttnSpec,
    backend: str | None = None,
    hw=H100,
    cache: TuneCache | None = None,
    refresh: bool = False,
    objective: str = "time",
    f_scales: tuple[float, ...] | None = None,
    lengths=None,
    comm: CommSpec | None = None,
) -> TuneResult:
    """Tune the decode-attention step under its own cache keyspace
    (``.../attn=paged-p8`` / ``.../attn=contig``, DESIGN.md §10).

    The search space is the DVFS grid over the layout's analytic
    roofline (:func:`repro_torch.tune.cost.predict_attn`): a paged gather at
    low occupancy is deeply memory-bound, so energy/EDP objectives pick
    a lower operating point for the attention phase than for the
    compute-bound projection GEMMs -- the per-shape ``f_scale`` split
    the launch telemetry stamps (train.py / serve.py).  Winners persist
    in the same on-disk cache as the GEMM searches but can never
    collide with them (distinct key prefix).
    """
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; choose from {OBJECTIVES}")
    dtype_name = _dtype_name(dtype)
    dtype_bytes = _dtype_bytes(dtype)
    backend = backend or default_backend()
    if cache is None:
        cache = TuneCache()
    key = _attn_key(slots, cache_len, n_kv_heads, d_head, dtype_name,
                    backend, attn, objective, comm)
    if not refresh:
        hit = cache.get(key)
        if hit is not None:
            return TuneResult(TuneConfig.from_dict(hit["config"]), key,
                              from_cache=True)

    fs = f_scale_candidates(hw) if f_scales is None else tuple(
        clamp_f_scale(hw, f) for f in f_scales)
    ests = [predict_attn(TuneConfig(schedule=attn.tag(), f_scale=f),
                         attn, slots=slots, cache_len=cache_len,
                         n_heads=n_heads, n_kv_heads=n_kv_heads,
                         d_head=d_head, lengths=lengths,
                         dtype_bytes=dtype_bytes, hw=hw, comm=comm)
            for f in dict.fromkeys(fs)]
    ests.sort(key=lambda e: (objective_value(e, objective, hw=hw),
                             -e.config.f_scale))
    chosen = ests[0]
    entry = {
        "config": chosen.config.to_dict(),
        "shape": [int(slots), int(n_kv_heads * d_head), int(cache_len)],
        "dtype": dtype_name,
        "backend": backend,
        "objective": objective,
        "attn": attn.tag(),
        "comm": comm.tag() if comm else "none",
        "predicted_time": chosen.time,
        "predicted_bytes": chosen.traffic_bytes,
        "predicted_score": objective_value(chosen, objective, hw=hw),
    }
    cache.put(key, entry)
    return TuneResult(chosen.config, key, from_cache=False, estimates=ests)


def resolve_attn_config(
    slots: int,
    cache_len: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    dtype="float32",
    attn: AttnSpec,
    backend: str | None = None,
    cache: TuneCache | None = None,
    objective: str = "time",
    comm: CommSpec | None = None,
) -> TuneConfig:
    """Hot-path resolution of the decode-attention winner: the memoised
    twin of :func:`resolve_config` over the ``attn=`` keyspace (same
    :func:`_memoised_resolve` mtime discipline).  ``comm`` keys the mesh
    keyspace exactly as in :func:`resolve_config`."""
    dtype_name = _dtype_name(dtype)
    bk_ = backend or default_backend()
    path = cache.path if cache is not None else default_cache_path()
    bucket = _attn_key(slots, cache_len, n_kv_heads, d_head, dtype_name,
                       bk_, attn, objective, comm)
    return _memoised_resolve(
        path, bucket,
        lambda: autotune_attn(slots, cache_len, n_heads=n_heads,
                              n_kv_heads=n_kv_heads, d_head=d_head,
                              dtype=dtype, attn=attn, backend=backend,
                              cache=cache, objective=objective,
                              comm=comm).config)


def resolved_attn_f_scale(
    slots: int,
    cache_len: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    dtype="float32",
    attn: AttnSpec,
    backend: str | None = None,
    cache: TuneCache | None = None,
    objective: str = "time",
    comm: CommSpec | None = None,
) -> float:
    """The DVFS operating point the attention phase tuned to -- stamped
    into serve/train telemetry next to the projection GEMM's own
    ``resolved_f_scale`` (the ROADMAP per-shape f_scale hint)."""
    return resolve_attn_config(
        slots, cache_len, n_heads=n_heads, n_kv_heads=n_kv_heads,
        d_head=d_head, dtype=dtype, attn=attn, backend=backend,
        cache=cache, objective=objective, comm=comm).f_scale


# ------------------------------------------------------ unified resolve ----
@dataclass(frozen=True)
class GemmSpec:
    """A GEMM tuning problem as a value: what :func:`resolve_config`
    took as six positional/keyword arguments, packaged so call sites
    build the spec once and hand it around (launch layer, benchmarks).
    ``epilogue`` is the fused bias/activation/residual the caller will
    attach (DESIGN.md §9); ``comm`` is the mesh's collective term
    (DESIGN.md §15)."""

    m: int
    n: int
    k: int
    dtype: str = "float32"
    batched: bool = False
    epilogue: EpilogueSpec | None = None
    comm: CommSpec | None = None


@dataclass(frozen=True)
class DecodeAttnSpec:
    """A decode-attention tuning problem as a value -- the attention
    twin of :class:`GemmSpec`.  ``attn`` is the cache-layout
    :class:`~repro_torch.tune.cost.AttnSpec` (contig / paged / shared)."""

    slots: int
    cache_len: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    dtype: str = "float32"
    attn: AttnSpec = AttnSpec()
    comm: CommSpec | None = None


def resolve(
    spec,
    *,
    backend: str | None = None,
    cache: TuneCache | None = None,
    objective: str = "time",
    search: bool = False,
    **search_kw,
):
    """One tuning entrypoint for every problem kind (DESIGN.md §11).

    Dispatches on the spec's type: :class:`GemmSpec` routes through the
    GEMM keyspace (``mm/`` / ``bmm/``), :class:`DecodeAttnSpec` through
    the attention keyspace (``attn=...``).  The legacy pairs
    (``resolve_config``/``resolve_attn_config`` and
    ``autotune``/``autotune_attn``) remain the implementation -- this
    wrapper adds **no** key material of its own, so every cache entry
    and memo bucket is byte-for-byte the one the legacy entrypoint
    would produce.

    ``search=False`` (default) is the memoised hot path and returns the
    winning :class:`TuneConfig`; ``search=True`` runs the full search
    machinery (``refresh=``, ``measure=``, ... via ``**search_kw``) and
    returns the :class:`TuneResult` with estimates and provenance.
    """
    if isinstance(spec, GemmSpec):
        if search:
            return autotune(spec.m, spec.n, spec.k, spec.dtype,
                            backend=backend, cache=cache,
                            batched=spec.batched, objective=objective,
                            epilogue=spec.epilogue, comm=spec.comm,
                            **search_kw)
        if search_kw:
            raise TypeError(
                f"search options {sorted(search_kw)} need search=True")
        return resolve_config(spec.m, spec.n, spec.k, spec.dtype,
                              backend=backend, cache=cache,
                              batched=spec.batched, objective=objective,
                              epilogue=spec.epilogue, comm=spec.comm)
    if isinstance(spec, DecodeAttnSpec):
        if search:
            return autotune_attn(spec.slots, spec.cache_len,
                                 n_heads=spec.n_heads,
                                 n_kv_heads=spec.n_kv_heads,
                                 d_head=spec.d_head, dtype=spec.dtype,
                                 attn=spec.attn, backend=backend,
                                 cache=cache, objective=objective,
                                 comm=spec.comm, **search_kw)
        if search_kw:
            raise TypeError(
                f"search options {sorted(search_kw)} need search=True")
        return resolve_attn_config(spec.slots, spec.cache_len,
                                   n_heads=spec.n_heads,
                                   n_kv_heads=spec.n_kv_heads,
                                   d_head=spec.d_head, dtype=spec.dtype,
                                   attn=spec.attn, backend=backend,
                                   cache=cache, objective=objective,
                                   comm=spec.comm)
    raise TypeError(
        f"resolve() takes a GemmSpec or DecodeAttnSpec, got "
        f"{type(spec).__name__}")
