"""Port parity for the span tracer: ``repro_torch.obs.trace`` against
``repro.obs.trace``.  The same calls give the same events (names,
phases, ids, arg keys, nesting); each package's validator accepts the
other's JSONL and finds the same problems in broken documents; the CLI
round-trips; a disabled tracer records nothing; the energy meter's
readings land on the innermost open span."""
import json
import time

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.obs import trace as jax_trace
from repro_torch.obs import trace
from repro_torch.power import EnergyMeter, EnergyReport


def _script(tr):
    """One call sequence: nested spans with args added mid-span, async
    lifecycles that overlap, instants."""
    tr.begin_async("request", 0, prompt_tokens=4)
    tr.begin_async("request.queued", 0)
    with tr.span("serve.step", mode="continuous") as args:
        args["extra"] = 1
        with tr.span("serve.admit"):
            tr.end_async("request.queued", 0)
            tr.begin_async("request.prefill", 0)
        with tr.span("serve.prefill_chunk"):
            tr.begin_async("request", 7, ts=tr.now_us() - 5.0)
            tr.instant("serve.preempt", req=7, needer=0)
    tr.end_async("request.prefill", 0)
    tr.end_async("request", 7, tokens=0)
    tr.end_async("request", 0, tokens=3, joules=0.5)


def _shape(events):
    return [(e["ph"], e["name"], e["cat"], e.get("id"), e.get("depth"),
             e.get("s"), sorted(e["args"])) for e in events]


def test_same_calls_give_the_same_events():
    mine, ref = trace.Tracer(), jax_trace.Tracer()
    _script(mine)
    _script(ref)
    assert _shape(mine.events) == _shape(ref.events)
    assert [sorted(e) for e in mine.events] == \
        [sorted(e) for e in ref.events]
    step = next(e for e in mine.events if e["name"] == "serve.step")
    assert step["args"] == {"mode": "continuous", "extra": 1}
    for inner in ("serve.admit", "serve.prefill_chunk"):
        ev = next(e for e in mine.events if e["name"] == inner)
        assert ev["depth"] == step["depth"] + 1
        assert step["ts"] <= ev["ts"]
        assert ev["ts"] + ev["dur"] <= step["ts"] + step["dur"]


def test_same_clock_as_the_reference():
    """Both stamp time.monotonic_ns() / 1e3: a port event sits between
    two reference readings taken around it."""
    before = jax_trace.Tracer.now_us()
    mine = trace.Tracer.now_us()
    after = jax_trace.Tracer.now_us()
    assert before <= mine <= after


def test_each_validator_accepts_the_others_jsonl(tmp_path):
    mine, ref = trace.Tracer(), jax_trace.Tracer()
    _script(mine)
    _script(ref)
    mine.write_jsonl(str(tmp_path / "mine.jsonl"))
    ref.write_jsonl(str(tmp_path / "ref.jsonl"))
    for path in ("mine.jsonl", "ref.jsonl"):
        p = str(tmp_path / path)
        assert jax_trace.validate_trace(jax_trace.load_events(p)) == []
        assert trace.validate_trace(trace.load_events(p)) == []
    assert trace.load_events(str(tmp_path / "mine.jsonl")) == \
        jax_trace.load_events(str(tmp_path / "mine.jsonl"))


BROKEN = {
    "not_a_document": [1, 2],
    "bad_phase": {"traceEvents": [{"ph": "Q", "name": "x", "ts": 0.0}]},
    "no_dur": {"traceEvents": [{"ph": "X", "name": "x", "ts": 0.0}]},
    "negative_ts": {"traceEvents": [{"ph": "i", "name": "x", "ts": -1}]},
    "no_name": {"traceEvents": [{"ph": "i", "ts": 0.0}]},
    "unclosed": {"traceEvents": [{"ph": "b", "name": "r", "cat": "request",
                                  "id": "1", "ts": 1.0}]},
    "orphan_end": {"traceEvents": [{"ph": "e", "name": "r",
                                    "cat": "request", "id": "1",
                                    "ts": 1.0}]},
    "end_before_begin": {"traceEvents": [
        {"ph": "b", "name": "r", "cat": "request", "id": "1", "ts": 5.0},
        {"ph": "e", "name": "r", "cat": "request", "id": "1", "ts": 1.0}]},
    "int_id": {"traceEvents": [{"ph": "b", "name": "r", "cat": "request",
                                "id": 1, "ts": 1.0}]},
    "args_not_object": {"traceEvents": [{"ph": "i", "name": "x", "ts": 0.0,
                                         "args": [1]}]},
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_validators_find_the_same_problems(case):
    doc = BROKEN[case]
    got = trace.validate_trace(doc)
    assert got and got == jax_trace.validate_trace(doc)
    with pytest.raises(ValueError, match="invalid trace"):
        trace.validate_trace(doc, strict=True)


def test_cli_round_trip(tmp_path):
    tr = trace.Tracer()
    with tr.span("work"):
        pass
    tr.begin_async("request", 0)
    tr.end_async("request", 0)
    src, out = tmp_path / "trace.jsonl", tmp_path / "trace.json"
    tr.write_jsonl(str(src))
    assert trace.main([str(src), "-o", str(out), "--validate"]) == 0
    doc = json.loads(out.read_text())
    assert trace.validate_trace(doc) == []
    assert doc["traceEvents"] == tr.to_chrome()["traceEvents"]
    # idempotent: the converted document reads back unchanged, and the
    # reference's CLI takes it too
    assert trace.load_events(str(out))["traceEvents"] == doc["traceEvents"]
    assert jax_trace.main([str(out), "--validate"]) == 0
    tr.write_chrome(str(tmp_path / "direct.json"))
    assert json.loads((tmp_path / "direct.json").read_text()) == \
        tr.to_chrome()
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ph": "X", "name": "x", "ts": -1}\n')
    assert trace.main([str(bad), "--validate"]) == 1


def test_disabled_tracer_records_nothing():
    tr = trace.Tracer(enabled=False)
    with tr.span("a"), tr.span("b"):
        pass
    tr.begin_async("request", 0)
    tr.end_async("request", 0)
    tr.instant("i")
    assert tr.events == []
    assert trace.default_tracer().enabled is False


def test_default_tracer_install_and_trace_span():
    tr = trace.Tracer()
    prev = trace.set_default_tracer(tr)
    try:
        with trace.trace_span("lib.work", n=3):
            pass
    finally:
        assert trace.set_default_tracer(prev) is tr
    assert [(e["name"], e["args"]) for e in tr.events] == \
        [("lib.work", {"n": 3})]


def test_energy_lands_on_the_innermost_span():
    """Top-level meter readings add their joules to the innermost open
    span; nested readings ride inside their parent (no double count),
    so the span's joules equal the report's total."""
    assert trace.attribute_energy(1.0) is False     # no open span
    rep = EnergyReport(backend="test")
    tr = trace.Tracer()
    with tr.span("outer") as outer:
        with tr.span("phase") as args:
            with EnergyMeter("outer", reporter=rep), \
                    EnergyMeter("inner", reporter=rep):
                np.dot(np.ones((64, 64)), np.ones((64, 64)))
            with EnergyMeter("second", reporter=rep):
                time.sleep(0.001)
    assert args["joules"] == pytest.approx(rep.totals()["joules"])
    assert args["metered_s"] > 0.0
    assert "joules" not in outer
    ev = next(e for e in tr.events if e["name"] == "phase")
    assert ev["args"]["joules"] == args["joules"]


def test_wall_offset_is_recorded_in_the_chrome_document():
    """The offset from the events' clock to ``time.time_ns`` (the clock
    of ``torch.profiler``'s device events) agrees with a direct read,
    sits in the document's metadata, and leaves the document valid for
    both packages."""
    tr = trace.Tracer()
    with tr.span("work"):
        pass
    off = tr.wall_offset_ns()
    assert abs(off - (time.time_ns() - time.monotonic_ns())) < 1_000_000
    doc = tr.to_chrome()
    assert doc["otherData"] == {"wall_offset_ns": off}
    assert trace.validate_trace(doc) == []
    assert jax_trace.validate_trace(doc) == []
    ev = doc["traceEvents"][0]
    assert abs(ev["ts"] * 1e3 + off - time.time_ns()) < 1e9
