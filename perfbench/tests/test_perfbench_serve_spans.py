"""The serving loop's step spans on the card: tracing adds no
host-device synchronisation, a disabled tracer makes no CUDA event, and
an enabled one gives every dispatch span a device time.  Needs the card
and skips without one:

    python3 -m pytest perfbench/tests -m card -k spans
"""
from __future__ import annotations

import warnings

import pytest
from conftest import ROOT

from perfbench.harness.cell import resolve_cell


@pytest.mark.card
def test_tracing_adds_no_sync_and_times_every_dispatch(card, monkeypatch):
    import torch

    from perfbench.run import _paths
    from repro_torch.kernels import _build

    _paths()
    cell = resolve_cell("glm4-9b.docqa", ROOT)
    drv, arch = cell.driver, cell.config["arch"]
    _build.build(tuple(cell.config["kernels"]))
    weights = drv.make_weights(arch, 2147483701, card)
    stream = drv.RequestStream(cell.traffic, 2147483701, arch["vocab"])
    prompts = [stream.tokens(n) for n in (150, 90, 40)]
    made = []
    real_event = torch.cuda.Event

    def counting_event(*a, **k):
        made.append(1)
        return real_event(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", counting_event)

    def serve(traced: bool):
        made.clear()
        loop = drv._program(cell.config, cell.traffic, weights, card, traced)
        for r, p in enumerate(prompts):
            loop.submit(r, p)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = loop.run(max_new=4)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        return loop, out, syncs, len(made)

    serve(False)   # first use of every shape
    off, out_off, syncs_off, events_off = serve(False)
    on, out_on, syncs_on, events_on = serve(True)
    assert out_on == out_off
    assert syncs_on == syncs_off > 0
    assert events_off == 0 and off.tracer.events == []
    dispatch = [e for e in on.tracer.events if e["ph"] == "X"
                and e["name"] in ("serve.decode.dispatch",
                                  "serve.prefill_chunk.dispatch")]
    assert events_on == 2 * len(dispatch) > 0
    assert all(e["args"]["device_ms"] > 0 for e in dispatch)
    assert {e["name"] for e in dispatch} == {"serve.decode.dispatch",
                                             "serve.prefill_chunk.dispatch"}
