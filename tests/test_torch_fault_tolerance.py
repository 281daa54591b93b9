"""Port parity for serving through faults: ``repro_torch.runtime``
(chaos injector, straggler watchdog, serve snapshotter),
``repro_torch.checkpoint`` (the on-disk store) and the fault-tolerant
``ServeLoop(device="cpu")`` against ``repro`` on the qwen3_1_7b SMOKE
width (shared weights, f32, paged).  Chaos specs parse and fire alike;
checkpoints, bf16 leaves included, load across the two packages both
ways and corruption raises; the allocator's state round-trips; a
restore replays to the same tokens; under the reference's chaos spec
the survivors' tokens, the errors and the fault counters equal the
reference's.  Deadlines are driven by arrival stamps in the past, never
by wall-clock budgets."""
import json
import time

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import store as jax_store
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models import DotEngine as JaxEngine
from repro.models import init_model as jax_init_model
from repro.obs import MetricsRegistry as JaxRegistry
from repro.runtime import ServeSnapshotter as JaxSnapshotter
from repro.runtime import StragglerMonitor as JaxStraggler
from repro.runtime import chaos as jax_chaos
from repro.serve import PageAllocator as JaxAllocator
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import DotEngine
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import MetricsRegistry, default_registry
from repro_torch.runtime import ServeSnapshotter, StragglerMonitor
from repro_torch.runtime import chaos
from repro_torch.serve import PageAllocator, ServeConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_reference_fallback():
    """A ``kernel`` fault makes the reference's loop mark a sticky
    process-wide kernel fallback; clear it for the tests after."""
    from repro.kernels import paged_attention
    yield
    paged_attention.reset_fallback()


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax_smoke("qwen3_1_7b"), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------ chaos spec --
SPECS = ["alloc@step=2,nan@step=3:req=1:times=2,straggler@delay=0.5,"
         "kernel@p=0.5",
         "alloc@step=2,step@step=4,kernel@step=6,straggler@step=8:delay=0.2,"
         "power@step=10",
         "nan@step=3:req=1", " step@step=1 , ,power"]


def _events(inj):
    return [(e.point, e.step, e.request, e.p, e.times, e.seconds, e.fired)
            for e in inj.events]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_spec_equals_reference(spec):
    assert _events(chaos.parse_chaos_spec(spec, seed=3)) == \
        _events(jax_chaos.parse_chaos_spec(spec, seed=3))
    assert chaos.POINTS == jax_chaos.POINTS


@pytest.mark.parametrize("spec", ["alloc@bogus=1", "frobnicate@step=1",
                                  "  ", "alloc@step=x", ","])
def test_bad_specs_rejected_like_reference(spec):
    with pytest.raises(ValueError) as mine:
        chaos.parse_chaos_spec(spec)
    with pytest.raises(ValueError) as ref:
        jax_chaos.parse_chaos_spec(spec)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_seeded_probabilistic_firing_equals_reference(seed):
    spec = "kernel@p=0.3:times=5,alloc@step=4:p=0.5:times=3,nan@req=2:p=0.7"
    mine = chaos.parse_chaos_spec(spec, seed=seed)
    ref = jax_chaos.parse_chaos_spec(spec, seed=seed)
    for step in range(40):
        for point, req in (("kernel", None), ("alloc", None), ("nan", 2),
                           ("nan", 1)):
            a = mine.match(point, step=step, request=req)
            b = ref.match(point, step=step, request=req)
            assert (a is None) == (b is None)
    assert mine.fired == ref.fired and mine.fired
    assert mine.exhausted() == ref.exhausted()


def test_injector_step_semantics_and_thread_local_fire():
    inj = chaos.ChaosInjector([chaos.ChaosEvent("alloc", step=3)])
    assert inj.match("alloc", step=1) is None
    assert inj.match("kernel", step=5) is None
    assert inj.match("alloc", step=5) is not None
    assert inj.match("alloc", step=6) is None
    assert inj.exhausted() and inj.fired == [("alloc", 5, None)]
    assert chaos.active() is None
    chaos.fire("alloc")                       # no injector: a no-op
    inj = chaos.ChaosInjector([chaos.ChaosEvent("alloc", step=2)])
    with chaos.install(inj):
        chaos.set_context(step=0)
        chaos.fire("alloc")
        chaos.set_context(step=2)
        with pytest.raises(chaos.InjectedFault) as ei:
            chaos.fire("alloc")
        assert ei.value.point == "alloc"
        assert isinstance(ei.value, chaos.TransientFault)
        # the reference's hook is another module: it sees nothing
        assert jax_chaos.active() is None
    assert chaos.active() is None


def test_straggler_monitor_equals_reference():
    dts = [0.1, 0.12, 0.09, 0.11, 0.5, 0.1, 0.1, 0.35, 0.31, 0.1, 2.0]
    for kw in ({}, {"factor": 2.0, "alpha": 0.5, "warmup": 1}):
        mine, ref = StragglerMonitor(**kw), JaxStraggler(**kw)
        assert [mine.observe(i, dt) for i, dt in enumerate(dts)] == \
            [ref.observe(i, dt) for i, dt in enumerate(dts)]
        assert mine.events == ref.events and mine.ema == ref.ema


# ------------------------------------------------------------- the store --
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((4, 6)).astype(np.float32)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return {"w": f32, "layers": [{"k": np.arange(6, dtype=np.int32)},
                                 {"k": np.ones(2, bool)}],
            "bf": bf, "none": None}


def _port_tree(seed=0):
    t = _tree(seed)
    return {"w": torch.from_numpy(t["w"]),
            "layers": [{"k": torch.from_numpy(t["layers"][0]["k"])},
                       {"k": torch.from_numpy(t["layers"][1]["k"])}],
            "bf": torch.from_numpy(t["bf"]).to(torch.bfloat16),
            "none": None}


def _jax_tree(seed=0):
    t = _tree(seed)
    t["bf"] = np.asarray(jnp.asarray(t["bf"], jnp.bfloat16))
    return t


def _manifest(root, step):
    return json.loads((root / f"step_{step:08d}" / "manifest.json")
                      .read_text())


def test_store_port_checkpoint_loads_in_reference(tmp_path):
    store.save_checkpoint(str(tmp_path / "p"), 5, _port_tree(),
                          meta={"a": 1})
    jax_store.save_checkpoint(str(tmp_path / "r"), 5, _jax_tree(),
                              meta={"a": 1})
    assert _manifest(tmp_path / "p", 5) == _manifest(tmp_path / "r", 5)
    assert sorted(p.name for p in (tmp_path / "p/step_00000005").iterdir()) \
        == sorted(p.name for p in (tmp_path / "r/step_00000005").iterdir())
    got, meta = jax_store.load_checkpoint(str(tmp_path / "p"), 5,
                                          _jax_tree())
    assert meta == {"a": 1}
    want = _jax_tree()
    assert got["bf"].dtype == want["bf"].dtype
    np.testing.assert_array_equal(got["bf"].view(np.uint16),
                                  want["bf"].view(np.uint16))
    np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["layers"][1]["k"],
                                  want["layers"][1]["k"])
    assert jax_store.latest_step(str(tmp_path / "p")) == \
        store.latest_step(str(tmp_path / "p")) == 5


def test_store_reference_checkpoint_loads_in_port(tmp_path):
    jax_store.save_checkpoint(str(tmp_path), 7, _jax_tree(1))
    got, meta = store.load_checkpoint(str(tmp_path), 7, _port_tree())
    want = _port_tree(1)
    assert meta == {}
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"], want["bf"])
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got["layers"][0]["k"], want["layers"][0]["k"])
    assert got["none"] is None


def test_store_keeps_the_newest_and_renames_atomically(tmp_path):
    for step in range(5):
        store.save_checkpoint(str(tmp_path), step, _port_tree(step), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003", "step_00000004"]
    assert store.latest_step(str(tmp_path)) == 4
    assert store.latest_step(str(tmp_path / "nothing")) is None


def _saved(root):
    tree = _port_tree()
    store.save_checkpoint(str(root), 3, tree)
    return tree, root / "step_00000003"


def test_truncated_leaf_raises(tmp_path):
    tree, step_dir = _saved(tmp_path)
    leaf = step_dir / "w.npy"
    leaf.write_bytes(leaf.read_bytes()[:40])
    with pytest.raises(store.CheckpointCorruptionError, match="truncated"):
        store.load_checkpoint(str(tmp_path), 3, tree)


@pytest.mark.parametrize("leaf", ["w", "bf"])
def test_bit_flip_raises(tmp_path, leaf):
    tree, step_dir = _saved(tmp_path)
    path = step_dir / f"{leaf}.npy"
    data = bytearray(path.read_bytes())
    data[-3] ^= 0xFF                       # data region, header intact
    path.write_bytes(bytes(data))
    with pytest.raises(store.CheckpointCorruptionError, match="crc32"):
        store.load_checkpoint(str(tmp_path), 3, tree)
    with pytest.raises(jax_store.CheckpointCorruptionError, match="crc32"):
        jax_store.load_checkpoint(str(tmp_path), 3, _jax_tree())
    assert issubclass(store.CheckpointCorruptionError, OSError)


def test_missing_leaf_and_bad_manifest_raise(tmp_path):
    tree, step_dir = _saved(tmp_path)
    (step_dir / "layers__0__k.npy").unlink()
    with pytest.raises(store.CheckpointCorruptionError, match="missing"):
        store.load_checkpoint(str(tmp_path), 3, tree)
    manifest = _manifest(tmp_path, 3)
    del manifest["leaves"]["layers__0__k"]
    (step_dir / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(store.CheckpointCorruptionError,
                       match="missing leaves"):
        store.load_checkpoint(str(tmp_path), 3, tree)
    (step_dir / "manifest.json").write_text("{ not json")
    with pytest.raises(store.CheckpointCorruptionError, match="manifest"):
        store.load_checkpoint(str(tmp_path), 3, tree)


# -------------------------------------------------------- the allocator --
def _drive(a):
    a.ensure_range(0, 10)
    a.register_prefix(0, list(range(10)))
    a.ensure_range(1, 5)
    a.release(1)
    a.release(0)          # indexed pages land on the cached-free FIFO
    a.adopt_prefix(1, list(range(8)) + [99])
    a.ensure_range(1, 9)


def test_allocator_state_round_trips_across_packages():
    mine = PageAllocator(16, 4, 2, prefix_sharing=True)
    ref = JaxAllocator(16, 4, 2, prefix_sharing=True)
    _drive(mine)
    _drive(ref)
    d, d_ref = mine.state_dict(), ref.state_dict()
    assert d == d_ref
    match = ref.index.match(list(range(10)), 4)
    nxt = ref.ensure_range(0, 6)
    assert mine.ensure_range(0, 6) == nxt
    for src in (d, d_ref):
        fresh = PageAllocator(16, 4, 2, prefix_sharing=True)
        fresh.load_state_dict(json.loads(json.dumps(src)))   # disk trip
        fresh.check_invariants()
        assert fresh.state_dict() == d_ref
        assert fresh.index.match(list(range(10)), 4) == match
        # the restored allocator goes on exactly as the original
        assert fresh.ensure_range(0, 6) == nxt
    back = JaxAllocator(16, 4, 2, prefix_sharing=True)
    back.load_state_dict(json.loads(json.dumps(d)))
    back.check_invariants()


@pytest.mark.parametrize("other", [dict(slots=4), dict(num_pages=12),
                                   dict(max_pages_per_slot=3)])
def test_allocator_load_rejects_geometry_mismatch(other):
    kw = dict(num_pages=16, page_size=4, slots=2)
    a = PageAllocator(**kw)
    b = PageAllocator(**{**kw, **other})
    with pytest.raises(ValueError, match="does not fit"):
        b.load_state_dict(a.state_dict())


def test_alloc_chaos_fires_before_any_mutation():
    a = PageAllocator(8, 4, 1)
    before = a.state_dict()
    with chaos.install(chaos.ChaosInjector([chaos.ChaosEvent("alloc")])):
        with pytest.raises(chaos.InjectedFault):
            a.ensure_range(0, 6)
    assert a.state_dict() == before
    a.check_invariants()


# ------------------------------------------------------ the serve loop --
def _loop(weights, mode="continuous", chaos_spec=None, metrics=None,
          ref=False, n=4, **sc):
    jp, tp = weights
    kw = dict(slots=2, cache_len=64, layout="paged", mode=mode,
              prefill_budget=16, chaos=chaos_spec)
    kw.update(sc)
    if ref:
        loop = JaxServeLoop(jax_smoke("qwen3_1_7b"), jp, JaxServeConfig(**kw),
                            engine=JaxEngine(schedule="morton"),
                            metrics=metrics or JaxRegistry())
    else:
        loop = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                         ServeConfig(**kw), engine=DotEngine(),
                         metrics=metrics or MetricsRegistry(), device="cpu")
    rng = np.random.default_rng(0)
    for r in range(n):
        loop.submit(r, rng.integers(2, loop.cfg.vocab, size=8).tolist())
    return loop


# the reference's acceptance spec (tests/test_fault_tolerance.py)
CHAOS_SPEC = "alloc@step=2,nan@step=3:req=1,straggler@step=4:delay=0.05"
FAULT_COUNTERS = ("serve.requests.failed", "serve.requests.finished",
                  "serve.faults.nan", "serve.faults.straggler",
                  "serve.faults.alloc", "serve.faults.step",
                  "serve.faults.kernel", "serve.retries", "serve.restores")


def _counts(loop):
    snap = loop.metrics.snapshot()["series"]
    return {k: snap.get(k, {}).get("value") for k in FAULT_COUNTERS}


@pytest.mark.parametrize("spec", [
    CHAOS_SPEC, "alloc@step=2,step@step=4,kernel@step=5,power@step=3",
    "kernel@step=2:times=2"])
def test_chaos_survivors_equal_clean_run_and_reference(weights, spec):
    base = _loop(weights).run(max_new=6)
    loop = _loop(weights, chaos_spec=spec)
    out = loop.run(max_new=6)
    ref = _loop(weights, chaos_spec=spec, ref=True)
    out_ref = ref.run(max_new=6)
    assert out == out_ref
    assert loop.errors == ref.errors
    assert loop.chaos.fired == ref.chaos.fired
    assert loop.chaos.exhausted() and ref.chaos.exhausted()
    assert _counts(loop) == _counts(ref)
    assert loop.snapshotter.restores == ref.snapshotter.restores >= 1
    loop.alloc.check_invariants()
    for r, toks in base.items():
        if r not in loop.errors:
            assert out[r] == toks, f"survivor {r} diverged"
    if spec == CHAOS_SPEC:
        assert loop.errors == {1: "nan"}


def test_lockstep_step_fault_is_transparent(weights):
    base = _loop(weights, mode="lockstep").run(max_new=6)
    loop = _loop(weights, mode="lockstep", chaos_spec="step@step=1")
    assert loop.run(max_new=6) == base
    assert loop.errors == {}
    snap = loop.metrics.snapshot()["series"]
    assert snap["serve.retries"]["value"] == 1
    assert snap["serve.restores"]["value"] == 1


def test_retries_are_bounded_and_real_errors_propagate(weights):
    loop = _loop(weights, chaos_spec="step@step=1:times=3")
    with pytest.raises(chaos.InjectedFault):
        loop.run(max_new=6)
    assert loop.metrics.snapshot()["series"]["serve.retries"]["value"] == 3
    loop = _loop(weights)

    def broken(max_new):
        raise RuntimeError("CUDA error: an illegal memory access")

    loop._decode_once = broken
    with pytest.raises(RuntimeError, match="illegal memory"):
        loop.run(max_new=6)
    assert loop.metrics.snapshot()["series"]["serve.retries"]["value"] == 0


def test_snapshot_restore_replays_the_same_tokens(weights, tmp_path):
    loop = _loop(weights, n=3, prefill_budget=8)
    for _ in range(3):
        loop._run_iteration(max_new=5)
    snap = ServeSnapshotter(loop, every=1, root=str(tmp_path))
    snap.snapshot(3)
    want = (loop.pos.copy(), loop.active.copy(),
            {r: list(t) for r, t in loop.out.items()},
            [(r, list(p)) for r, p in loop.queue], loop.alloc.state_dict(),
            {k: v.clone() for k, v in loop.state.items()})
    while loop._pending():
        loop._run_iteration(max_new=5)
    final = {r: list(t) for r, t in loop.out.items()}

    def check_rewound():
        np.testing.assert_array_equal(loop.pos, want[0])
        np.testing.assert_array_equal(loop.active, want[1])
        assert loop.out == want[2] and loop.queue == want[3]
        assert loop.alloc.state_dict() == want[4]
        for k, v in want[5].items():
            assert torch.equal(loop.state[k], v), k
        loop.alloc.check_invariants()

    for from_disk in (False, True):
        assert snap.restore(from_disk=from_disk) == 3
        check_rewound()
        while loop._pending():
            loop._run_iteration(max_new=5)
        assert {r: list(t) for r, t in loop.out.items()} == final
    assert snap.snapshots == 1 and snap.restores == 2


def test_reference_snapshot_restores_into_the_port(weights, tmp_path):
    """A snapshot the reference's loop wrote to disk, restored into the
    port's loop mid-run: the port finishes with the reference's tokens."""
    ref = _loop(weights, ref=True, n=3, prefill_budget=8)
    mine = _loop(weights, n=3, prefill_budget=8)
    for loop in (ref, mine):
        for _ in range(2):
            loop._run_iteration(max_new=5)
    JaxSnapshotter(ref, root=str(tmp_path)).snapshot(2)
    out_ref = ref.run(max_new=5)
    mine._run_iteration(max_new=5)          # drift, then rewind
    assert ServeSnapshotter(mine, root=str(tmp_path)).restore(
        from_disk=True) == 2
    assert mine.run(max_new=5) == out_ref


def test_deadlines_from_arrival_stamps(weights):
    """A request stamped long ago fails in the queue; a slot whose
    request's stamp is moved into the past fails at the next iteration;
    the others finish, as in the reference.  The deadline (1000 s) is
    far beyond any run's wall time."""
    outs = []
    for ref in (False, True):
        loop = _loop(weights, ref=ref, n=0, deadline_ms=1e6)
        now = time.monotonic()
        loop.submit(0, [5, 6, 7])
        loop.submit(1, [8, 9, 10], arrival_ts=now - 2000.0)
        loop.submit(2, [11, 12, 13, 14])
        loop._run_iteration(max_new=4)
        assert loop.errors == {1: "deadline"}
        loop.arrival_s[2] = now - 2000.0
        outs.append((loop.run(max_new=4), dict(loop.errors),
                     _counts(loop)))
        assert 1 not in outs[-1][0]
        assert len(outs[-1][0][0]) == 3 + 4
        loop.alloc.check_invariants()
    assert outs[0] == outs[1]
    assert outs[0][1] == {1: "deadline", 2: "deadline"}


def test_preempt_past_deadline_finishes_with_error(weights):
    for ref in (False, True):
        loop = _loop(weights, ref=ref, n=0, mode="lockstep", page_size=4,
                     num_pages=8)
        loop.submit(0, [5, 6, 7, 8])
        loop.submit(1, [9, 10, 11, 12])
        loop._admit()
        assert loop.active.all()
        loop.deadline_ms = 1000.0
        loop.arrival_s[1] = time.monotonic() - 2000.0
        assert loop._preempt_victim(0)
        assert loop.errors == {1: "deadline"} and loop.queue == []
        loop.alloc.check_invariants()


def test_occupancy_shedding(weights):
    outs = []
    for ref in (False, True):
        loop = _loop(weights, ref=ref, n=0, mode="lockstep", slots=1,
                     page_size=8, shed_occupancy=0.05)
        for r in range(3):
            loop.submit(r, [5 + r] * 8)
        outs.append((loop.run(max_new=4), dict(loop.errors),
                     loop.metrics.snapshot()["series"]["serve.shed"]))
    assert outs[0] == outs[1]
    assert outs[0][1] == {1: "shed", 2: "shed"}
    assert outs[0][2]["value"] == 2


def test_power_chaos_gives_zero_joules():
    from repro_torch.power import EnergyMeter, detect_backend
    faults = default_registry().counter("power.faults")
    before = faults.value
    with chaos.install(chaos.ChaosInjector([chaos.ChaosEvent("power")])):
        with EnergyMeter("x", backend=detect_backend("model")) as em:
            time.sleep(0.001)
        with EnergyMeter("y", backend=detect_backend("model")) as em2:
            time.sleep(0.001)
    assert em.reading.joules == 0.0 and em.reading.seconds > 0
    assert em2.reading.joules > 0.0          # the one event is spent
    assert faults.value == before + 1


def test_guards_off_lets_nan_through(weights):
    """``fault_guards=False``: the quarantine is off, so a poisoned row
    is sampled (argmax of NaNs) instead of failing its request."""
    loop = _loop(weights, chaos_spec="nan@step=3:req=1", fault_guards=False)
    out = loop.run(max_new=6)
    assert loop.errors == {} and len(out[1]) == 8 + 6
