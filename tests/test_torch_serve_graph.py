"""The decode graphs' bookkeeping on the CPU (``launch/decode_graph.py``).

A CUDA graph is captured and replayed only on the card
(``tests/test_torch_serve_graph_card.py``).  Here: when the loop replays
(never on the CPU, the contiguous strips, under chaos, on a mesh or
under a GEMM counter), which graph a step replays, the block tables
written in place, and the loop's side of a replay: with a graph that
keeps a capture's contract on the CPU (a replay recomputes the captured
step and writes its outputs over the captured ones, and launches nothing
from the host), the served tokens, logits, routes, counters and launch
counts equal the eager loop's, and a state whose tensors moved raises."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.ctx import AbstractMesh, mesh_context  # noqa: E402
from repro_torch.kernels import launch_counts, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import sfc_matmul as b1_mod  # noqa: E402
from repro_torch.launch import decode_graph as dg  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.serve import ServeLoop  # noqa: E402
from repro_torch.models import DotEngine, init_model  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402

ARCHS = ("qwen3_1_7b", "mellum2_12b_a2_5b")
# two slots contend for a pool of 12 pages of 4 tokens: admissions,
# releases and preemptions mid-run
PRESSURE = dict(slots=3, cache_len=48, page_size=4, num_pages=12,
                eos_id=-1, prefill_budget=6)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_smoke_config(request.param)
    return cfg, init_model(cfg, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(2, vocab, size=int(n)).tolist()
            for n in (13, 9, 17, 5, 11)]


def _loop(model, layout="paged", mode="continuous", **sc):
    cfg, params = model
    kw = dict(PRESSURE, layout=layout, mode=mode)
    kw.update(sc)
    return ServeLoop(cfg, params, ServeConfig(**kw),
                     engine=DotEngine(schedule="morton"),
                     metrics=MetricsRegistry(), tracer=Tracer(),
                     device="cpu")


def _serve(loop, max_new=6):
    for r, p in enumerate(_prompts(loop.cfg.vocab)):
        loop.submit(r, p)
    return loop.run(max_new=max_new)


def _counter(loop, name):
    return loop.metrics.snapshot()["series"][name]["value"]


# ----------------------------------------------------------- conditions --
def _on_card(loop):
    """``loop`` as the conditions see it on the card (nothing runs)."""
    loop.device = torch.device("cuda")
    return dg.eager_reasons(loop)


def test_the_cpu_decodes_eagerly(model):
    loop = _loop(model)
    assert dg.eager_reasons(loop) == ["device cpu"]
    assert loop._graphs is None
    _serve(loop)
    assert loop.steps > 0
    assert _counter(loop, "serve.decode.graph_replays") == 0
    assert _counter(loop, "serve.decode.graph_captures") == 0
    assert _on_card(loop) == []


@pytest.mark.parametrize("case", ["contiguous", "chaos plan",
                                  "installed chaos", "mesh", "gemm counter"])
def test_each_condition_alone_keeps_the_step_eager(model, case, monkeypatch):
    if case == "contiguous":
        loop = _loop(model, layout="contiguous", mode="lockstep")
        want = ["layout contiguous"]
    elif case == "chaos plan":
        loop = _loop(model, chaos="nan@step=3:req=1")
        want = ["chaos"]
    else:
        loop = _loop(model)
        want = {"installed chaos": ["chaos"], "mesh": ["mesh"],
                "gemm counter": ["gemm counter"]}[case]
    if case in ("contiguous", "chaos plan"):
        _serve(loop)
        assert loop._graphs is None
        assert _counter(loop, "serve.decode.graph_replays") == 0
        assert _on_card(loop) == want
        return
    if case == "gemm counter":
        monkeypatch.setattr(ops, "gemm_counter", object())
        assert _on_card(loop) == want
        monkeypatch.undo()
    elif case == "mesh":
        with mesh_context(AbstractMesh((1, 2), ("data", "model"))):
            assert _on_card(loop) == want
    else:
        with chaos.install(chaos.parse_chaos_spec("kernel@step=99")):
            assert _on_card(loop) == want
    assert _on_card(loop) == []


def test_key_is_the_live_row_count_of_a_routed_moe(model):
    cfg, _ = model
    rows = torch.tensor([0, 2])
    lp = types.SimpleNamespace(cfg=cfg, slots=3)
    if cfg.routed_moe:
        assert dg.graph_key(cfg, rows) == 2
        assert dg.graph_key(cfg, None) is None
        assert dg.graph_keys(lp) == [1, 2, 3]
    else:
        assert dg.graph_key(cfg, rows) is None
        assert dg.graph_keys(lp) == [None]


def test_block_tables_are_written_in_place(model):
    loop = _loop(model)
    seen = []
    orig = loop._sync_tables

    def recording():
        orig()
        bt = loop.state["block_tables"]
        seen.append((bt.data_ptr(),
                     np.array_equal(bt.numpy(), loop.alloc.block_table)))

    loop._sync_tables = recording
    _serve(loop)
    assert loop.preemptions > 0 and len(seen) > 10
    assert {p for p, _ in seen} == {loop.state["block_tables"].data_ptr()}
    assert all(eq for _, eq in seen)


def test_every_kernel_launch_counter_is_registered():
    """A decode graph moves the registry's counters: a wrapper's counter
    left out of it would keep its capture's launches and miss replays."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels
    found = set()
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}")
        found |= {f"{info.name}.{k}" for k, v in vars(mod).items()
                  if k.endswith("launches") and type(v) is int}
    assert "sfc_matmul_grouped.grouped_launches" in found
    assert found == set(launch_counts.snapshot())


def test_launch_counts_restore_and_add_every_counter():
    before = launch_counts.snapshot()
    b1_mod.launches += 3
    pa_mod.window_launches += 1
    moved = launch_counts.delta(before)
    assert {k: v for k, v in moved.items() if v} == {
        "sfc_matmul.launches": 3, "paged_attention.window_launches": 1}
    launch_counts.restore(before)
    assert launch_counts.snapshot() == before
    launch_counts.add(moved)
    assert b1_mod.launches == before["sfc_matmul.launches"] + 3
    launch_counts.restore(before)
    assert launch_counts.snapshot() == before


# ------------------------------------------------- replay, on the CPU --
class _CpuGraph:
    """A graph's contract on the CPU: a replay runs the captured step
    again, launching nothing from the host (the launch counters keep
    their values), and writes its outputs over the captured ones."""

    def __init__(self, fn, outs):
        self.fn, self.outs = fn, outs

    def replay(self):
        held = launch_counts.snapshot()
        fresh = self.fn()
        launch_counts.restore(held)
        for out, new in zip(self.outs, fresh):
            if out is not None:
                out.copy_(new)


def _cpu_graph(self, fn):
    outs = fn()
    return _CpuGraph(fn, outs), outs


def _launching(loop):
    """Count three B1 and one B2 "launch" each eager decode step."""
    orig = loop._decode

    def decode(*a, **k):
        b1_mod.launches += 3
        pa_mod.launches += 1
        return orig(*a, **k)

    loop._decode = decode


def _run_logged(loop):
    logits = []
    orig = loop._sample_and_retire

    def sample(lg, max_new):
        logits.append(np.array(lg))
        return orig(lg, max_new)

    loop._sample_and_retire = sample
    loop.route_steps = [] if loop.cfg.routed_moe else None
    _launching(loop)
    b1, b2 = b1_mod.launches, pa_mod.launches
    out = _serve(loop)
    return out, logits, (b1_mod.launches - b1, pa_mod.launches - b2)


@pytest.fixture
def cpu_graphs(monkeypatch):
    monkeypatch.setattr(serve_mod, "eager_reasons", lambda loop: [])
    monkeypatch.setattr(dg.DecodeGraphs, "_new_graph", _cpu_graph)


@pytest.mark.parametrize("mode", ["continuous", "lockstep"])
def test_replays_serve_what_the_eager_loop_serves(model, mode, cpu_graphs,
                                                  monkeypatch):
    """Lockstep's prefill steps (every row routed, one position for all
    rows) replay a key of their own."""
    graphed = _loop(model, mode=mode)
    assert graphed._graphs is not None
    got = _run_logged(graphed)
    monkeypatch.undo()
    eager = _loop(model, mode=mode)
    assert eager._graphs is None
    want = _run_logged(eager)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) > 0
    assert graphed.steps == eager.steps
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2]
    assert graphed.preemptions == eager.preemptions
    assert graphed.preemptions > 0 or mode == "lockstep"
    keys = dg.graph_keys(graphed)
    if mode == "lockstep" and graphed.cfg.routed_moe:
        keys = keys + [None]
    assert sorted(graphed._graphs.graphs, key=str) == sorted(keys, key=str)
    assert _counter(graphed, "serve.decode.graph_captures") == len(keys)
    assert _counter(graphed, "serve.decode.graph_replays") == graphed.steps
    captures = [e for e in graphed.tracer.events
                if e["name"] == "serve.decode.graph_captures"]
    assert len(captures) == len(keys)
    # less the graphs' own and the watchdog's, which reads wall time
    skip = ("serve.decode.graph_captures", "serve.decode.graph_replays",
            "serve.faults.straggler_detected")
    series = {k: v for k, v in graphed.metrics.snapshot()["series"].items()
              if k not in skip}
    assert series.keys() == {k for k in eager.metrics.snapshot()["series"]
                             if k not in skip}
    for k, v in series.items():
        if v["type"] == "counter":
            assert v["value"] == _counter(eager, k), k
    if graphed.cfg.routed_moe:
        assert np.array_equal(graphed.moe_expert_rows, eager.moe_expert_rows)
        assert len(graphed.route_steps) == len(eager.route_steps)
        for (ra, pa, a), (rb, pb, b) in zip(graphed.route_steps,
                                            eager.route_steps):
            assert np.array_equal(ra, rb) and np.array_equal(pa, pb)
            assert torch.equal(a, b)


def test_a_dropped_loop_is_freed_without_a_collection(model, cpu_graphs):
    """The graphs hold no reference back to their loop: a serving run's
    weights and pool go when the run's last reference does."""
    import gc
    import weakref

    loop = _loop(model)
    for r, p in enumerate(_prompts(loop.cfg.vocab)):
        loop.submit(r, p)
    while not loop._graphs.graphs:
        loop._run_iteration(6)
    gone = weakref.ref(loop)
    gc.disable()
    try:
        del loop
        assert gone() is None
    finally:
        gc.enable()


def test_a_moved_state_raises(model, cpu_graphs):
    loop = _loop(model)
    for r, p in enumerate(_prompts(loop.cfg.vocab)):
        loop.submit(r, p)
    while not loop._graphs.graphs:
        loop._run_iteration(6)
    loop.state["block_tables"] = loop.state["block_tables"].clone()
    with pytest.raises(RuntimeError, match="moved"):
        while loop._pending():
            loop._run_iteration(6)
