"""The port's training CLI on the CPU (``python -m
repro_torch.launch.train ... --device cpu``), mirroring the reference's
system tests of ``repro.launch.train``: the quickstart's loss falls,
a run resumes from its checkpoint, a run with an injected failure ends
with the clean run's loss and parameters exactly (the executor restores
the last checkpoint and replays the same batches), ``--objective edp``
reports joules per step; plus the asynchronous checkpointer, the
failure injector and the step executor against the reference's."""
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.obs import MetricsRegistry as RefRegistry
from repro.runtime import FailureInjector as RefInjector
from repro.runtime import StepExecutor as RefExecutor
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, \
    load_checkpoint
from repro_torch.launch.train import main as train_main
from repro_torch.obs import MetricsRegistry, default_tracer, load_events, \
    set_default_tracer, validate_trace
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import FailureInjector, InjectedFailure, \
    StepExecutor

CPU = ["--device", "cpu"]
SMOKE = ["--arch", "qwen3_1_7b", "--smoke", "--batch", "4", "--seq", "32",
         "--power-backend", "model"] + CPU


@pytest.fixture
def isolated_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


def test_tiny_lm_trains_and_loss_drops():
    """The quickstart: 40 steps on the qwen3 SMOKE config."""
    state = train_main(["--arch", "qwen3_1_7b", "--smoke", "--steps", "40",
                        "--batch", "8", "--seq", "64", "--lr", "3e-3",
                        "--log-every", "20"] + CPU)
    assert state["last_loss"] is not None
    assert state["last_loss"] < 4.5   # ln(128) = 4.85 at init


def test_train_resumes_from_checkpoint(tmp_path, capsys):
    d = str(tmp_path)
    ck = ["--ckpt-dir", d, "--ckpt-every", "6", "--log-every", "6"]
    first = train_main(SMOKE + ["--steps", "12"] + ck)
    assert latest_step(d) == 12
    state = train_main(SMOKE + ["--steps", "6"] + ck)
    assert "[train] resumed from step 12" in capsys.readouterr().out
    assert state["last_loss"] is not None
    assert int(state["opt"]["count"]) == 18
    assert latest_step(d) == 18
    assert int(first["opt"]["count"]) == 12


def test_injected_failure_ends_with_the_clean_runs_loss(tmp_path, capsys):
    clean = train_main(SMOKE + ["--steps", "8", "--log-every", "4"])
    failed = train_main(SMOKE + ["--steps", "8", "--log-every", "4",
                                 "--ckpt-dir", str(tmp_path),
                                 "--ckpt-every", "1",
                                 "--inject-failure-at", "5"])
    out = capsys.readouterr().out
    assert "restored step 5 after failure" in out and "retries 1" in out
    assert failed["last_loss"] == clean["last_loss"]
    for a, b in zip(tree_leaves(failed["params"]),
                    tree_leaves(clean["params"])):
        assert torch.equal(a, b)


def test_train_with_edp_objective_reports_joules(isolated_tune_cache,
                                                 capsys):
    state = train_main(SMOKE + ["--steps", "4", "--objective", "edp",
                                "--log-every", "2"])
    assert state["last_loss"] is not None
    out = capsys.readouterr().out
    assert "objective=edp" in out
    assert "J/step" in out and "EDP/step" in out


def test_trace_and_metrics_reports(tmp_path):
    trace, report = tmp_path / "t.jsonl", tmp_path / "m.json"
    prev = default_tracer()
    try:   # --trace installs the process's default tracer, as in repro
        train_main(SMOKE + ["--steps", "3", "--trace", str(trace),
                            "--metrics-report", str(report)])
    finally:
        set_default_tracer(prev)
    doc = load_events(str(trace))
    assert validate_trace(doc) == []
    steps = [e for e in doc["traceEvents"] if e.get("name") == "train.step"]
    assert len(steps) == 3
    snap = json.loads(report.read_text())
    assert "train.step_ms" in json.dumps(snap)


@pytest.mark.parametrize("flag", [["--mesh", "2,2"],
                                  ["--device-order", "hilbert"],
                                  ["--pod-compress"]])
def test_distributed_flags_wait_for_a15(flag):
    with pytest.raises(NotImplementedError, match="A15"):
        train_main(SMOKE + ["--steps", "1"] + flag)


def test_async_checkpointer_round_trip(tmp_path):
    """The tree is copied to the host when ``save`` returns: an in-place
    update afterwards (as AdamW makes) does not reach the file.  The
    reference's loader reads the port's files, bf16 included."""
    tree = {"p": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)
                  .to(torch.bfloat16)},
            "opt": {"m": torch.linspace(-1, 1, 7), "count":
                    torch.tensor(5, dtype=torch.int32)}}
    want = {"p": {"w": tree["p"]["w"].clone()},
            "opt": {"m": tree["opt"]["m"].clone(),
                    "count": tree["opt"]["count"].clone()}}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(3, tree)
    tree["p"]["w"].add_(1)
    tree["opt"]["m"].mul_(2)
    ck.save(4, tree)
    ck.wait()
    ck.close()
    assert latest_step(str(tmp_path)) == 4
    got, _ = load_checkpoint(str(tmp_path), 3, want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got4, _ = load_checkpoint(str(tmp_path), 4, tree)
    for a, b in zip(tree_leaves(got4), tree_leaves(tree)):
        assert torch.equal(a, b)
    ref, _ = ref_load_checkpoint(str(tmp_path), 3, {
        "p": {"w": 0}, "opt": {"m": 0, "count": 0}})
    np.testing.assert_array_equal(np.asarray(ref["p"]["w"], np.float32),
                                  want["p"]["w"].float().numpy())
    np.testing.assert_array_equal(ref["opt"]["count"], 5)


def test_async_checkpointer_raises_a_write_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    with pytest.raises(OSError):
        ck.close()


def _scripted(kind, injector_cls, executor_cls, registry):
    """Run 6 steps of a counter with a failure at step 2 and a step that
    raises on its first attempt at step 4; returns what the executor
    saw."""
    flaky = {4: 1}
    log = []

    def step_fn(state, step):
        if flaky.get(step):
            flaky[step] -= 1
            raise RuntimeError("transient")
        log.append(step)
        return state + 1

    def restore(step):
        log.append(f"restore@{step}")
        return step

    ex = executor_cls(step_fn, restore, injector=injector_cls({2: kind}),
                      metrics=registry)
    state, end = ex.run(0, 0, 6)
    return state, end, log, [s for s, _ in ex.retries]


def test_step_executor_and_injector_match_reference():
    ref = _scripted("node-loss", RefInjector, RefExecutor, RefRegistry())
    reg = MetricsRegistry()
    ours = _scripted("node-loss", FailureInjector, StepExecutor, reg)
    assert ours == ref
    assert reg.counter("train.retries").value == 2
    assert reg.counter("train.restores").value == 2
    inj = FailureInjector({1: "x"})
    inj.check(0)
    with pytest.raises(InjectedFailure, match="x @ step 1"):
        inj.check(1)
    inj.check(1)                       # fires once
    assert inj.fired == [(1, "x")]


def test_step_executor_gives_up_after_max_retries():
    def always(state, step):
        raise RuntimeError("dead")

    ex = StepExecutor(always, lambda s: 0, max_retries=2,
                      metrics=MetricsRegistry())
    with pytest.raises(RuntimeError, match="dead"):
        ex.run(0, 0, 1)
    assert len(ex.retries) == 3
