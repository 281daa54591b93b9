"""Port parity for the serving loop's observability: ``repro_torch``'s
``ServeLoop(device="cpu")`` and ``repro``'s paged ``ServeLoop`` on the
same requests at the qwen3_1_7b SMOKE width (shared weights, f32), each
with its own metrics registry and an enabled tracer.  The metric
series (names and kinds), the counters, the multiset of trace events
and the latency summary's keys are equal; the trace validates under
both packages; span joules sum to the energy report's total; obs off
records nothing; SLO violations are counted."""
import collections

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models import DotEngine as JaxEngine
from repro.models import init_model as jax_init_model
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import Tracer as JaxTracer
from repro.obs import validate_trace as jax_validate
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import DotEngine
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import MetricsRegistry, Tracer, validate_trace
from repro_torch.serve import ServeConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax_smoke("qwen3_1_7b"), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


SHORT = list(range(40, 48))
SHARED = list(range(60, 76))

# (mode, ServeConfig fields, prompts): prefix sharing with a clone and
# a fork; pool pressure with preemptions in both modes
SCENARIOS = {
    "continuous_shared": ("continuous",
                          dict(slots=2, cache_len=64, page_size=8,
                               prefill_budget=8),
                          [SHORT, SHARED, list(SHARED)]),
    "continuous_pressure": ("continuous",
                            dict(slots=2, cache_len=64, page_size=4,
                                 num_pages=5, eos_id=-1, prefill_budget=3),
                            [list(range(2, 11)), list(range(20, 29)),
                             [5, 6, 7]]),
    "lockstep_pressure": ("lockstep",
                          dict(slots=2, cache_len=64, page_size=4,
                               num_pages=4, eos_id=-1),
                          [[5, 6, 7, 8], [5, 6, 7, 8], [9, 10, 11]]),
}


def _run_both(weights, mode, sc, prompts, max_new=6, **extra):
    jp, tp = weights
    ref = JaxServeLoop(jax_smoke("qwen3_1_7b"), jp,
                       JaxServeConfig(layout="paged", mode=mode, **sc,
                                      **extra),
                       engine=JaxEngine(schedule="morton"),
                       metrics=JaxRegistry(), tracer=JaxTracer())
    mine = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(layout="paged", mode=mode, **sc, **extra),
                     engine=DotEngine(schedule="morton"),
                     metrics=MetricsRegistry(), tracer=Tracer(),
                     device="cpu")
    outs = []
    for loop in (ref, mine):
        for r, p in enumerate(prompts):
            loop.submit(r, p)
        outs.append(loop.run(max_new=max_new))
    assert outs[0] == outs[1]
    return ref, mine


# the port's own series and spans, which the reference has no
# counterpart of: the decode and chunk steps' rows, the phases inside
# serve.decode and serve.prefill_chunk, and the decode graphs' captures
# and replays
PORT_ONLY = ("serve.prefill.rows", "serve.decode.rows", "serve.decode.steps",
             "serve.decode.pages", "serve.decode.upload",
             "serve.decode.dispatch", "serve.decode.sync",
             "serve.decode.sample", "serve.prefill_chunk.plan",
             "serve.prefill_chunk.dispatch", "serve.decode.graph_captures",
             "serve.decode.graph_replays")


def _series(loop):
    """The snapshot's series, less the straggler watchdog's (it flags
    iterations by wall time: the reference's first ones compile) and
    the port's own."""
    return {k: v for k, v in loop.metrics.snapshot()["series"].items()
            if k != "serve.faults.straggler_detected" and k not in PORT_ONLY}


COUNTERS = ("serve.requests.submitted", "serve.requests.finished",
            "serve.requests.failed", "serve.preemptions", "serve.cow_forks",
            "serve.pages.scrubbed", "serve.pages.revived", "serve.shed",
            "serve.retries", "serve.restores", "serve.degraded")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_metrics_equal_reference(weights, scenario):
    mode, sc, prompts = SCENARIOS[scenario]
    ref, mine = _run_both(weights, mode, sc, prompts)
    s_ref, s = _series(ref), _series(mine)
    assert {k: v["type"] for k, v in s.items()} == \
        {k: v["type"] for k, v in s_ref.items()}
    for name in COUNTERS:
        assert s[name]["value"] == s_ref[name]["value"], name
    for name in ("serve.prefill_tokens", "serve.ttft_ms", "serve.tpot_ms",
                 "serve.e2e_ms", "serve.step_ms"):
        assert s[name]["count"] == s_ref[name]["count"], name
    assert s["serve.prefill_tokens"]["sum"] == \
        s_ref["serve.prefill_tokens"]["sum"]
    for name in ("serve.queue.depth", "serve.pool.occupancy",
                 "serve.prefix.hit_ratio", "serve.attn.min_share"):
        for k in ("value", "min", "max"):
            assert s[name][k] == pytest.approx(s_ref[name][k]), (name, k)
    assert s["serve.requests.submitted"]["value"] == len(prompts)
    assert s["serve.requests.finished"]["value"] == len(prompts)
    if scenario == "continuous_shared":
        assert s["serve.cow_forks"]["value"] >= 1
    else:
        assert s["serve.preemptions"]["value"] >= 1
        assert mine.preemptions == s["serve.preemptions"]["value"]


def _event_multiset(tracer):
    return collections.Counter(
        (e["ph"], e["name"], e.get("id"), tuple(sorted(e["args"])))
        for e in tracer.events
        if e["name"] != "serve.faults.straggler_detected"
        and e["name"] not in PORT_ONLY)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_trace_events_equal_reference(weights, scenario):
    mode, sc, prompts = SCENARIOS[scenario]
    ref, mine = _run_both(weights, mode, sc, prompts)
    assert _event_multiset(mine.tracer) == _event_multiset(ref.tracer)
    doc = mine.tracer.to_chrome()
    assert validate_trace(doc) == [] and jax_validate(doc) == []
    depth = {e["name"]: e["depth"] for e in mine.tracer.events
             if e["ph"] == "X"}
    assert depth["serve.step"] == 0
    assert depth["serve.admit"] == depth["serve.decode"] == 1
    for r in range(len(prompts)):
        evs = sorted((e for e in doc["traceEvents"]
                      if e.get("id") == str(r)), key=lambda e: e["ts"])
        assert (evs[0]["name"], evs[0]["ph"]) == ("request", "b")
        assert (evs[-1]["name"], evs[-1]["ph"]) == ("request", "e")
        begun = [e["name"] for e in evs if e["ph"] == "b"]
        assert begun.index("request.queued") < \
            begun.index("request.prefill") < begun.index("request.decode")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_latency_summary_and_span_joules(weights, scenario):
    mode, sc, prompts = SCENARIOS[scenario]
    ref, mine = _run_both(weights, mode, sc, prompts, latency_slo_ms=1e6)
    lat, lat_ref = mine.latency_summary(), ref.latency_summary()
    assert {k: sorted(v) for k, v in lat.items()} == \
        {k: sorted(v) for k, v in lat_ref.items()}
    for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
        assert lat[key]["count"] == lat_ref[key]["count"] == len(prompts)
        assert 0.0 < lat[key]["p50"] <= lat[key]["p95"] <= lat[key]["p99"] \
            <= lat[key]["max"]
    assert lat["slo"] == lat_ref["slo"] == {
        "target_ms": 1e6, "met": len(prompts), "violations": 0,
        "attainment": 1.0}
    assert mine.energy.meta["latency"] == lat
    total = mine.energy.totals()["joules"]
    span_j = sum(e["args"].get("joules", 0.0)
                 for e in mine.tracer.events if e["ph"] == "X")
    assert total > 0.0
    assert span_j == pytest.approx(total, rel=1e-9)
    assert sum(mine.request_joules.values()) == pytest.approx(total,
                                                              rel=1e-9)


def test_obs_off_is_metric_free(weights):
    _, tp = weights
    sc = ServeConfig(slots=1, cache_len=32, page_size=8, layout="paged",
                     mode="continuous", prefill_budget=8, obs=False)
    loop = ServeLoop(get_smoke_config("qwen3_1_7b"), tp, sc,
                     engine=DotEngine(schedule="morton"), device="cpu")
    loop.submit(0, [5, 6, 7, 8])
    out = loop.run(max_new=2)
    assert len(out[0]) == 6
    assert loop.metrics.snapshot()["series"] == {}
    assert loop.tracer.events == []
    assert loop.latency_summary()["ttft_ms"]["count"] == 1


def test_slo_violations_counted(weights):
    """A microsecond TTFT target: every request violates it, in the
    counters and the summary, as in the reference."""
    mode, sc, prompts = SCENARIOS["continuous_shared"]
    ref, mine = _run_both(weights, mode, sc, prompts, latency_slo_ms=1e-3)
    s, s_ref = _series(mine), _series(ref)
    for name in ("serve.slo.violations", "serve.slo.met"):
        assert s[name]["value"] == s_ref[name]["value"]
    assert s["serve.slo.violations"]["value"] == len(prompts)
    lat = mine.latency_summary()["slo"]
    assert lat["violations"] == len(prompts) and lat["attainment"] == 0.0


def test_cli_writes_trace_and_metrics(tmp_path):
    from repro_torch.launch.serve import main
    from repro_torch.obs import default_tracer, load_events

    trace_path, metrics_path = tmp_path / "t.jsonl", tmp_path / "m.json"
    before = default_tracer()
    out = main(["--arch", "qwen3_1_7b", "--smoke", "--device", "cpu",
                "--mode", "continuous", "--requests", "2", "--max-new", "2",
                "--slo-ms", "1e6", "--trace", str(trace_path),
                "--metrics-report", str(metrics_path)])
    from repro_torch.obs import set_default_tracer
    set_default_tracer(before)
    assert all(len(v) == 8 + 2 for v in out.values())
    doc = load_events(str(trace_path))
    assert validate_trace(doc) == [] and jax_validate(doc) == []
    import json
    snap = json.loads(metrics_path.read_text())
    assert snap["series"]["serve.requests.finished"]["value"] >= 2
