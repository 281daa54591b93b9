"""The serving loop's spans inside ``serve.decode`` and
``serve.prefill_chunk``, their args and the row counters, on the CPU at
the qwen3_1_7b SMOKE width, continuous, on both KV layouts: the decode's
phases nest in order, the chunk's ``tokens`` and ``rows`` match what the
loop prefilled and computed, the decode's ``rows`` the rows the step
ran, and the counters sum the args.  The device marks behind
``device_ms`` are made only while the tracer records on CUDA."""
import itertools

import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import DotEngine, init_model
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import ServeConfig

PROMPTS = [list(range(5, 17)), list(range(20, 29)), [3, 4, 5]]
DECODE = ["serve.decode.pages", "serve.decode.upload",
          "serve.decode.dispatch", "serve.decode.sync",
          "serve.decode.sample"]


@pytest.fixture(scope="module")
def params():
    return init_model(get_smoke_config("qwen3_1_7b"), device="cpu")


def _loop(params, layout, tracer):
    sc = ServeConfig(slots=2, cache_len=64, page_size=8, layout=layout,
                     mode="continuous", prefill_budget=8, eos_id=-1)
    return ServeLoop(get_smoke_config("qwen3_1_7b"), params, sc,
                     engine=DotEngine(schedule="morton"),
                     metrics=MetricsRegistry(), tracer=tracer, device="cpu")


@pytest.fixture(scope="module", params=["paged", "contiguous"])
def served(request, params):
    """A traced run, and the row count of each ``decode_step`` call read
    from its row mask."""
    loop = _loop(params, request.param, Tracer())
    masks = []
    orig = serve_mod.decode_step

    def counting(*a, row_mask, **k):
        masks.append(int(row_mask.sum()))
        return orig(*a, row_mask=row_mask, **k)

    serve_mod.decode_step = counting
    try:
        for r, p in enumerate(PROMPTS):
            loop.submit(r, p)
        loop.run(max_new=4)
    finally:
        serve_mod.decode_step = orig
    return request.param, loop, masks


def _spans(loop, name):
    return [e for e in loop.tracer.events
            if e["ph"] == "X" and e["name"] == name]


def _children(loop, parent):
    end = parent["ts"] + parent["dur"]
    return sorted((e for e in loop.tracer.events
                   if e["ph"] == "X" and e["depth"] == parent["depth"] + 1
                   and parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end),
                  key=lambda e: e["ts"])


def test_decode_phases_nest_in_order(served):
    layout, loop, _ = served
    decodes = _spans(loop, "serve.decode")
    assert decodes and all(d["depth"] == 1 for d in decodes)
    want = DECODE if layout == "paged" else DECODE[1:]
    for d in decodes:
        kids = _children(loop, d)
        assert [k["name"] for k in kids] == want
        assert all(k["depth"] == 2 for k in kids)
        for a, b in zip(kids, kids[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
    n_kids = sum(len(_spans(loop, n)) for n in want)
    assert n_kids == len(want) * len(decodes)


def test_chunk_phases_and_args(served):
    _, loop, _ = served
    chunks = _spans(loop, "serve.prefill_chunk")
    assert len(chunks) == len(loop.prefill_tokens_per_step)
    dispatched = 0
    for c, n in zip(chunks, loop.prefill_tokens_per_step):
        kids = _children(loop, c)
        names = [k["name"] for k in kids]
        if n:
            assert names == ["serve.prefill_chunk.plan",
                             "serve.prefill_chunk.dispatch"]
            assert kids[1]["args"] == {"tokens": n, "rows": 2 * 8}
            dispatched += 1
        else:
            assert names == ["serve.prefill_chunk.plan"]
    assert dispatched == loop.chunk_steps > 0


def test_decode_rows_are_the_live_slots(served):
    _, loop, masks = served
    rows = [e["args"]["rows"] for e in _spans(loop, "serve.decode.upload")]
    assert rows == masks
    assert sorted(set(rows)) == [1, 2]
    tokens = sum(len(loop.out[r]) - len(p) for r, p in enumerate(PROMPTS))
    assert sum(rows) == tokens == 4 * len(PROMPTS)


def test_counters_sum_the_span_args(served):
    _, loop, _ = served
    s = loop.metrics.snapshot()["series"]
    assert s["serve.prefill.rows"]["value"] == sum(
        e["args"]["rows"] for e in _spans(loop, "serve.prefill_chunk.dispatch"))
    assert s["serve.decode.rows"]["value"] == sum(
        e["args"]["rows"] for e in _spans(loop, "serve.decode.upload"))
    assert s["serve.decode.steps"]["value"] == \
        len(_spans(loop, "serve.decode")) == loop.steps
    # on the CPU no dispatch span gets a device time
    assert not any("device_ms" in e["args"] for e in loop.tracer.events)


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: counts the events made and
    reads a fake clock at ``record``."""
    made = 0
    clock = itertools.count()

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self):
        self.t = next(self.clock)

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    return _FakeEvent


def test_device_marks_pair_and_read_on_cuda(params, fake_events):
    loop = _loop(params, "paged", Tracer())
    loop.device = torch.device("cuda")   # the marks' gate only; no tensor
    args = {}
    start = loop._device_mark()
    loop._close_mark(args, start)
    assert fake_events.made == 2 and "device_ms" not in args
    loop._read_device_ms()
    assert args == {"device_ms": 1.0} and loop._device_marks == []


def test_disabled_tracer_makes_no_event(params, fake_events):
    loop = _loop(params, "paged", Tracer(enabled=False))
    for r, p in enumerate(PROMPTS):
        loop.submit(r, p)
    loop.run(max_new=4)
    assert loop.tracer.events == [] and loop._device_marks == []
    assert fake_events.made == 0
    loop.device = torch.device("cuda")
    assert loop._device_mark() is None
    loop._close_mark({}, None)
    assert fake_events.made == 0 and loop._device_marks == []
    s = loop.metrics.snapshot()["series"]
    assert s["serve.decode.steps"]["value"] == loop.steps
