"""The serving loop's decode graphs on the card (``launch/decode_graph.py``).

A dense SMOKE model (qwen3-1.7b's) and mellum2's routed SMOKE, in bf16,
served paged, continuous (admissions, releases and preemptions mid-run)
and lockstep: the loop that replays its decode step against the same loop
kept eager by an armed chaos plan that never fires.  Every step's
logits, the greedy tokens, the routes and every kernel launch counter
are equal; every decode step is a replay (the first one too, after the
captures it triggers); after the captures the replaying loop makes the
same stream synchronisations, site for site, as the eager loops; and a
profiler started after the captures records the replayed B1, B2 (and
B5) kernels by name.

Marked ``card``: every test skips without a CUDA card, decided when it
runs.  On the card: ``python3 -m pytest -q tests/test_torch_serve_graph_card.py``.
The file imports no JAX."""
import collections
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch import decode_graph as dg  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.serve import ServeLoop  # noqa: E402
from repro_torch.models import DotEngine, init_model  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402

pytestmark = pytest.mark.card

# three slots contend for 12 pages of 4 tokens
PRESSURE = dict(slots=3, cache_len=48, page_size=4, num_pages=12,
                eos_id=-1, prefill_budget=6, layout="paged",
                mode="continuous")
NEVER = "nan@step=1:req=999"   # armed, matches no request: eager decode
MAX_NEW = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 -m "
                    "pytest tests/test_torch_serve_graph_card.py")
    from repro_torch.kernels import _build
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=["qwen3_1_7b", "mellum2_12b_a2_5b"])
def model(request, dev):
    cfg = dataclasses.replace(get_smoke_config(request.param),
                              param_dtype="bfloat16", act_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(3)
    return cfg, init_model(cfg, gen, device=dev)


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(2, vocab, size=int(n)).tolist()
            for n in (13, 9, 17, 5, 11)]


def _serve(model, dev, chaos=None, mode="continuous"):
    """One run: (loop, tokens, each step's logits, the launch counters'
    moves, where each stream synchronisation after the first decode step
    was asked for)."""
    cfg, params = model
    sc = ServeConfig(**dict(PRESSURE, mode=mode), chaos=chaos)
    loop = ServeLoop(cfg, params, sc,
                     engine=DotEngine(schedule="morton"),
                     metrics=MetricsRegistry(), tracer=Tracer(), device=dev)
    loop.route_steps = [] if cfg.routed_moe else None
    logits = []
    sample = loop._sample_and_retire

    def logged(lg, max_new):
        logits.append(np.array(lg))
        return sample(lg, max_new)

    loop._sample_and_retire = logged
    for r, p in enumerate(_prompts(cfg.vocab)):
        loop.submit(r, p)
    torch.cuda.synchronize()
    before = launch_counts.snapshot()
    while loop.steps == 0:
        loop._run_iteration(MAX_NEW)
    torch.cuda.synchronize()
    # the mode is set outside the record: torch's first switch to "warn"
    # in a process reports one synchronisation of its own
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = loop.run(max_new=MAX_NEW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = launch_counts.delta(before)
    syncs = collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    return loop, out, logits, launches, syncs


def _value(loop, name):
    return loop.metrics.snapshot()["series"][name]["value"]


@pytest.mark.parametrize("mode", ["continuous", "lockstep"])
def test_replays_equal_the_eager_decode_bit_for_bit(model, dev, mode):
    """Lockstep's prefill steps (every row routed, one position for all
    rows) replay a key of their own."""
    graphed, out, logits, launches, _ = _serve(model, dev, mode=mode)
    eager, want, want_logits, want_launches, _ = _serve(
        model, dev, chaos=NEVER, mode=mode)
    assert graphed._graphs is not None and eager._graphs is None
    assert out == want
    assert graphed.preemptions == eager.preemptions
    assert graphed.preemptions > 0 or mode == "lockstep"
    # lockstep's prefill steps sample nothing: their logits are dropped
    # and their pages feed the logits that follow
    assert len(logits) == len(want_logits) > 0
    assert graphed.steps == eager.steps
    assert len(logits) == graphed.steps or mode == "lockstep"
    for a, b in zip(logits, want_logits):
        assert np.array_equal(a, b)
    assert launches == want_launches
    assert launches["sfc_matmul.launches"] > 0
    keys = dg.graph_keys(graphed)
    if mode == "lockstep" and graphed.cfg.routed_moe:
        keys = keys + [None]
    assert sorted(graphed._graphs.graphs, key=str) == sorted(keys, key=str)
    assert _value(graphed, "serve.decode.graph_captures") == len(keys)
    assert _value(graphed, "serve.decode.graph_replays") == graphed.steps
    assert _value(eager, "serve.decode.graph_replays") == 0
    if graphed.cfg.routed_moe:
        assert np.array_equal(graphed.moe_expert_rows, eager.moe_expert_rows)
        assert len(graphed.route_steps) == len(eager.route_steps)
        for (ra, pa, a), (rb, pb, b) in zip(graphed.route_steps,
                                            eager.route_steps):
            assert np.array_equal(ra, rb) and np.array_equal(pa, pb)
            assert torch.equal(a.cpu(), b.cpu())


def test_replays_add_no_synchronisation(model, dev, monkeypatch):
    """The same synchronisations, site for site, as the loop held eager
    and as the loop kept eager by an armed chaos plan."""
    syncs = _serve(model, dev)[-1]
    armed = _serve(model, dev, chaos=NEVER)
    monkeypatch.setattr(serve_mod, "eager_reasons", lambda loop: ["held"])
    held = _serve(model, dev)
    assert armed[0]._graphs is None and held[0]._graphs is None
    assert sum(syncs.values()) > 0
    assert syncs == held[-1]
    assert syncs == armed[-1]


def test_a_profiler_started_after_capture_sees_the_replayed_kernels(model,
                                                                    dev):
    from torch.profiler import ProfilerActivity, profile

    cfg, params = model
    loop = ServeLoop(cfg, params, ServeConfig(**PRESSURE),
                     engine=DotEngine(schedule="morton"),
                     metrics=MetricsRegistry(), tracer=Tracer(), device=dev)
    for r, p in enumerate(_prompts(cfg.vocab)):
        loop.submit(r, p)
    while loop.steps == 0:
        loop._run_iteration(MAX_NEW)
    torch.cuda.synchronize()
    graphs = loop._graphs.graphs
    assert sorted(graphs, key=str) == sorted(dg.graph_keys(loop), key=str)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for g in graphs.values():
            g.graph.replay()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert any("sfc_matmul_rows_bf16" in n for n in names)
    assert any("paged_attn_kernel" in n for n in names)
    assert any("sfc_matmul_grouped" in n for n in names) == cfg.routed_moe
