"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the harness's look for a card and drives the rest of a
run (``run.measure``) of a tiny cell on the CPU, with the program broken
in one of the ways a cell can be: a step that returns its state
unchanged, half of the batch left out (the rest standing in for it), a
token or an answer altered where it is produced.  The cells run on one
card, so there is no exchange between cards to leave out.  A sound run
of the same cell comes out correct."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness.cell import resolve_cell
from perfbench.run import measure


# long enough that requests finish in the window on a loaded CPU
SECONDS = 4.0


def _measure(root, cell):
    return measure(resolve_cell(cell, root), 2147483653, SECONDS, False,
                   device="cpu")


def test_sound_runs_are_correct(tiny_root):
    for cell in ("tiny.docqa", "tiny.gemm"):
        out = _measure(tiny_root, cell)
        assert out["correct"], out["checks"]
        assert out["attempted"] > 0 and out["failed"] == 0


# ------------------------------------------------------------ serving --
def _unchanged_state(orig):
    def step(params, cfg, state, *args, **kw):
        saved = {k: state[k].clone() for k in ("k_pages", "v_pages")}
        logits, state = orig(params, cfg, state, *args, **kw)
        for k, v in saved.items():
            state[k].copy_(v)
        return logits, state
    return step


def _half_batch(orig):
    def step(params, cfg, state, *args, **kw):
        logits, state = orig(params, cfg, state, *args, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:logits.shape[0] - h]
        return logits, state
    return step


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_broken_decode_step_is_not_correct(tiny_root, monkeypatch, fault):
    import repro_torch.launch.serve as serve

    wrap = {"unchanged_state": _unchanged_state,
            "half_batch": _half_batch}[fault]
    monkeypatch.setattr(serve, "decode_step", wrap(serve.decode_step))
    out = _measure(tiny_root, "tiny.docqa")
    assert not out["correct"], out["checks"]


def test_altered_token_is_not_correct(tiny_root, monkeypatch):
    from repro_torch.launch.serve import ServeLoop

    orig = ServeLoop._sample
    calls = [0]

    def sample(self, row):
        # every 7th token becomes the least likely one
        calls[0] += 1
        return int(row.argmin()) if calls[0] % 7 == 0 else orig(self, row)

    monkeypatch.setattr(ServeLoop, "_sample", sample)
    out = _measure(tiny_root, "tiny.docqa")
    assert not out["correct"], out["checks"]


# --------------------------------------------------------------- study --
class _Broken:
    def __init__(self, eng, fault):
        self.eng, self.fault = eng, fault

    def dot_batched(self, a, b):
        if self.fault == "unchanged_state":
            return torch.zeros(a.shape[0], a.shape[1], b.shape[2],
                               dtype=a.dtype)
        out = self.eng.dot_batched(a, b)
        if self.fault == "half_batch":
            h = out.shape[0] // 2
            out[h:] = out[:out.shape[0] - h]
        else:
            out[0, 0, 0] += 1.0
        return out


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
def test_broken_gemm_is_not_correct(tiny_root, monkeypatch, fault):
    cell = resolve_cell("tiny.gemm", tiny_root)
    orig = cell.driver.engines
    monkeypatch.setattr(cell.driver, "engines", lambda c, t: [
        (k, _Broken(e, fault)) for k, e in orig(c, t)])
    out = measure(cell, 2147483653, SECONDS, False, device="cpu")
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
