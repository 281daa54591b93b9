"""Port parity for the moe, ssm and hybrid archs (granite-moe-1b-a400m,
granite-moe-3b-a800m with 10 experts at SMOKE size, mamba2-780m,
hymba-1.5b with a 32-token window beside its SSD) on the CPU, against
``repro`` on shared weights (``params_from_jax``, f32) and numpy-seeded
inputs: configs field by field, ``forward``/``loss_fn``/``aux`` and
the gradients (320 tokens, so the moe layers take the capacity path),
one decode step and its state, the greedy tokens of ``ServeLoop``
(moe: both modes and both layouts; ssm and hybrid: lockstep on the
contiguous layout, the only one the reference serves them on), the
GEMM counts a decode step and a train step make, and the serving
loop's fault paths on an ssm state.

Positions: every family decodes on per-slot positions.  The reference
keeps ssm and hybrid states on one shared position (the oldest live
slot's); mamba2 reads no position, so its tokens equal the reference's
wherever no slot is reused; hymba's attention does, so its tokens are
compared only where that position is every live slot's own (one slot,
or equal prompts admitted together).

A reused slot: the port zeroes the slot's SSD rows at admission, the
reference starts the next request from the previous occupant's state
(ROADMAP.md queue C).  So a request's logits in any mix equal its
logits alone (exactly, on the CPU), while the reference's differ in a
reused slot (measured up to 5.9 on mamba2 and 5.0 on hymba SMOKE).

Tolerances (f32): logits within 2e-5 (moe) and 2e-4 (the families
with an SSD), the loss and aux within 1e-5 relative, every gradient leaf
within 1e-4 (moe) and 3e-4 (SSD) of its largest magnitude; a decode
step's logits within 2e-5 and its state within 1e-5; tokens exact.  The
SSD's bounds: both packages round its intra-chunk buffer to bf16 at the
same points, but exp and the f32 sums ahead of the rounding differ by an
ulp now and then (XLA's and torch's), and an element that lands one
bf16 step (2**-8) away moves the logits by up to ~1e-4 and a small
gradient leaf by ~1e-4 of its scale (measured at 4 x 80 tokens on
mamba2: logits 1.2e-4, ``A_log``'s gradient 1.4e-4; at 4 x 32, where
``tests/test_torch_train.py`` holds every arch to 1e-5 and 1e-4, no
element lands apart).
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models import DotEngine as JaxEngine
from repro.models import init_model as jax_init_model
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_decode_state as ref_init_state
from repro.models.transformer import loss_fn as ref_loss_fn
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeLoop
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.steps import grads_of
from repro_torch.models import DotEngine, decode_step, forward, \
    init_decode_state, init_model, prefill_kv, prefill_kv_chunk
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import ServeSnapshotter
from repro_torch.serve import ServeConfig

MOE = ["granite_moe_1b_a400m", "granite_moe_3b_a800m"]
STATEFUL = ["mamba2_780m", "hymba_1_5b"]
FAMILIES = MOE + STATEFUL
# B1 GEMMs a layer of a decode step: the attention's 4 (moe: its experts
# are torch einsums), in_proj and out_proj (ssm), both and the MLP's 3
# (hybrid); plus the vocab head once
DECODE_GEMMS = {"moe": 4, "ssm": 2, "hybrid": 9}
REF_ENGINE = JaxEngine(schedule="morton")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def count_gemms(monkeypatch):
    """Counts calls of the GEMM kernel wrapper (the CPU runs its plain
    version, which the launch counter does not count)."""
    calls = [0]
    inner = ops.sfc_matmul_cuda

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(ops, "sfc_matmul_cuda", counted)
    return calls


_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        jp = jax_init_model(jax_smoke(arch), jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    return _WEIGHTS[arch]


def _prompts(lens, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).tolist() for n in lens]


def _recording(base):
    """``base`` with every sampled logit row kept per request."""
    class Recording(base):
        def _decode_once(self, max_new):
            self._live = [self.slot_req[s] for s in range(self.slots)
                          if self.active[s]]
            self._k = 0
            return super()._decode_once(max_new)

        def _sample(self, row):
            r = self._live[self._k]
            self._k += 1
            self.rows.setdefault(r, []).append(np.array(row, copy=True))
            return super()._sample(row)
    return Recording


def _ref_loop(arch, **sc):
    jp, _ = _weights(arch)
    loop = _recording(JaxServeLoop)(jax_smoke(arch), jp, JaxServeConfig(**sc),
                                    engine=REF_ENGINE)
    loop.rows = {}
    return loop


def _port_loop(arch, **sc):
    _, tp = _weights(arch)
    loop = _recording(ServeLoop)(get_smoke_config(arch), tp,
                                 ServeConfig(**sc),
                                 engine=DotEngine(schedule="morton"),
                                 device="cpu")
    loop.rows = {}
    return loop


def _serve(loop, requests, max_new):
    for r, p in requests:
        loop.submit(r, p)
    return loop.run(max_new=max_new)


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_equal_reference_field_by_field(arch, which):
    get_t, get_j = {"config": (get_config, jax_config),
                    "smoke": (get_smoke_config, jax_smoke)}[which]
    mine, ref = get_t(arch), get_j(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in ("padded_vocab", "has_attention", "has_ssm", "has_decode",
                 "subquadratic"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.runnable_shapes() == ref.runnable_shapes()
    assert mine.params_count() == ref.params_count()
    assert mine.active_params_count() == ref.active_params_count()
    assert get_t(arch.replace("_", "-")) == mine
    assert arch in ARCHS


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_model_tree_matches_reference(arch):
    jp, _ = _weights(arch)
    mine = init_model(get_smoke_config(arch),
                      torch.Generator().manual_seed(0), device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
           for k, v in jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert got == want


# ------------------------------------------------------------ training --
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_aux_and_grads_match_reference(arch):
    """4 x 80 tokens (the moe layers' capacity path; hymba's window of
    32 and five SSD chunks of 16 crossed)."""
    jp, tp = _weights(arch)
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 128, (4, 80)).astype(np.int32),
             "labels": rng.integers(0, 128, (4, 80)).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref_logits, ref_aux = ref_forward(jp, jcfg, batch, REF_ENGINE)
    with torch.no_grad():
        logits, aux = forward(tp, cfg, tb, DotEngine())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=2e-4 if cfg.has_ssm else 2e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5,
                               atol=1e-7)
    assert (float(aux) > 0) == (cfg.family == "moe")
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        lambda q: ref_loss_fn(q, jcfg, batch, REF_ENGINE), has_aux=True)(jp)
    loss, metrics, g = grads_of(cfg, tp, tb, DotEngine())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_m[k]),
                                   rtol=1e-5, atol=1e-7)
    flat = jax.tree_util.tree_flatten_with_path(ref_g)[0]
    leaves = tree_leaves(g)
    assert len(flat) == len(leaves)
    for (path, want), got in zip(flat, leaves):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= (3e-4 if cfg.has_ssm else 1e-4) * scale, \
            (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_gemm_count(arch, remat, count_gemms):
    """GEMMs through the kernel wrapper in one step's forward and
    backward: per layer the forward's n (4 moe, 2 ssm, 9 hybrid), their
    dgrad and wgrad, and w1's recomputed pre-activation where there is
    a SwiGLU MLP; the head's 3; a "full" remat recomputes the forward's
    n.  Both policies give the same loss and gradients bit for bit."""
    _, tp = _weights(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), remat_policy=remat)
    rng = np.random.default_rng(4)
    tb = {k: torch.from_numpy(rng.integers(0, 128, (2, 32)).astype(np.int32))
          for k in ("tokens", "labels")}
    loss, _, g = grads_of(cfg, tp, tb, DotEngine())
    n = DECODE_GEMMS[cfg.family]
    mlp = 1 if cfg.family == "hybrid" else 0
    want = cfg.n_layers * (3 * n + mlp + (n if remat == "full" else 0)) + 3
    assert count_gemms[0] == want
    base, _, g0 = grads_of(get_smoke_config(arch), tp, tb, DotEngine())
    assert torch.equal(loss, base)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                 tree_leaves(g0)))


# -------------------------------------------------------------- decode --
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "per-row"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_reference(arch, vector, count_gemms):
    """Three decode steps from a zero contiguous state (cache 32),
    positions scalar or per row (a row masked off in the last step):
    logits within 2e-5, the state's every key within 1e-5, the masked
    row's state untouched; 4 L + 1 / 2 L + 1 / 9 L + 1 GEMMs a step."""
    jp, tp = _weights(arch)
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    st = init_decode_state(cfg, 3, 32, device="cpu")
    jst = ref_init_state(jcfg, 3, 32)
    assert set(st) == set(jst.keys())
    rng = np.random.default_rng(5)
    for i in range(3):
        toks = rng.integers(2, 128, (3, 1)).astype(np.int32)
        pos = np.array([i, i + 2, i + 5], np.int32) if vector \
            else np.int32(i)
        mask = np.array([True, i < 2, True])
        before = {k: v.clone() for k, v in st.items()}
        count_gemms[0] = 0
        logits, st = decode_step(tp, cfg, st, torch.from_numpy(toks),
                                 torch.as_tensor(pos), DotEngine(),
                                 row_mask=torch.from_numpy(mask))
        assert count_gemms[0] == DECODE_GEMMS[cfg.family] * cfg.n_layers + 1
        jl, jst = ref_decode_step(jp, jcfg, jst, jnp.asarray(toks),
                                  jnp.asarray(pos), REF_ENGINE,
                                  row_mask=jnp.asarray(mask))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=2e-5, rtol=0)
        for k in st:
            if k == "kv_pos" and vector:
                continue   # per-row positions leave it alone, by design
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       atol=1e-5, rtol=0, err_msg=k)
        if not mask[1]:
            for k in ("ssm_h", "ssm_conv"):
                if k in st:
                    assert torch.equal(st[k][:, 1], before[k][:, 1])


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_paged_decode_match_reference(arch):
    """``prefill_kv`` of a 9-token prompt into slot 1 (contiguous) and a
    paged decode step over it: logits within 2e-5 of the reference's."""
    from repro.serve.paged_kv import PageAllocator as RefAlloc
    from repro.serve.paged_kv import init_paged_decode_state as ref_paged
    from repro_torch.serve.paged_kv import init_paged_serving

    jp, tp = _weights(arch)
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    prompt = _prompts((9,), seed=6)[0]
    st = init_decode_state(cfg, 2, 16, device="cpu")
    jst = ref_init_state(jcfg, 2, 16)
    logits, st = prefill_kv(tp, cfg, st, prompt, slot=1)
    jl, jst = __import__("repro.models.transformer", fromlist=["x"]) \
        .prefill_kv(jp, jcfg, jst, jnp.asarray(prompt), slot=1,
                    engine=REF_ENGINE)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(st["k"].numpy(), np.asarray(jst["k"]),
                               atol=1e-5, rtol=0)
    alloc, pst = init_paged_serving(cfg, 2, 16, page_size=4, device="cpu")
    jpst = ref_paged(jcfg, 2, page_size=4, num_pages=alloc.num_pages,
                     max_pages_per_slot=alloc.max_pages_per_slot)
    jalloc = RefAlloc(alloc.num_pages, 4, 2, alloc.max_pages_per_slot)
    for a in (alloc, jalloc):
        a.ensure_range(0, 3)
        a.ensure_range(1, 6)
    pst["block_tables"] = torch.tensor(alloc.block_table)
    jpst["block_tables"] = jnp.asarray(jalloc.block_table)
    toks = np.array([[5], [9]], np.int32)
    pos = np.array([2, 5], np.int32)
    got, _ = decode_step(tp, cfg, pst, torch.from_numpy(toks),
                         torch.from_numpy(pos), DotEngine())
    want, _ = ref_decode_step(jp, jcfg, jpst, jnp.asarray(toks),
                              jnp.asarray(pos), REF_ENGINE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("arch", STATEFUL)
def test_stateful_families_need_the_contiguous_lockstep_loop(arch):
    """ssm and hybrid states are not paged and have no bulk or chunked
    prefill: the paged layout, continuous mode, ``prefill_kv`` and
    ``prefill_kv_chunk`` raise, as in the reference."""
    _, tp = _weights(arch)
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match="pure-attention"):
        _port_loop(arch, layout="paged")
    with pytest.raises(ValueError, match="pure-attention"):
        _port_loop(arch, mode="continuous")
    st = init_decode_state(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        prefill_kv(tp, cfg, st, [3, 4])
    with pytest.raises(ValueError, match="pure-attention"):
        prefill_kv_chunk(tp, cfg, st, torch.zeros(1, 2, dtype=torch.int64),
                         [0], [0], [2])
    assert ("k" in st) == (cfg.family == "hybrid")
    assert st["ssm_h"].dtype == torch.float32


def test_encoder_and_vlm_frontends_wait_for_their_slice():
    for family in ("encoder", "vlm"):
        cfg = dataclasses.replace(get_smoke_config("qwen3_1_7b"),
                                  family=family)
        with pytest.raises(NotImplementedError, match="A11"):
            init_model(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="A11"):
            init_decode_state(cfg, 1, 8, device="cpu")


# ------------------------------------------------------------- serving --
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["lockstep", "continuous"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_tokens_equal_reference(arch, mode, layout):
    """Five ragged prompts through 2 slots (pages of 4, chunks of 5):
    the reference's greedy tokens and admission order."""
    sc = dict(slots=2, cache_len=64, mode=mode, layout=layout, page_size=4,
              prefill_budget=5, eos_id=-1)
    reqs = list(enumerate(_prompts((5, 3, 7, 6, 4), seed=1)))
    ref, mine = _ref_loop(arch, **sc), _port_loop(arch, **sc)
    assert _serve(mine, reqs, 6) == _serve(ref, reqs, 6)
    if mode == "continuous":
        assert mine.prefill_tokens_per_step == ref.prefill_tokens_per_step


@pytest.mark.parametrize("traffic", ["together", "one_request"])
@pytest.mark.parametrize("arch", STATEFUL)
def test_stateful_tokens_equal_reference(arch, traffic):
    """Lockstep, contiguous: three 6-token prompts admitted together
    into 3 slots, or one 40-token prompt through 1 slot (hymba's ring of
    32 wraps): the reference's tokens, no slot reused."""
    if traffic == "together":
        sc = dict(slots=3, cache_len=64, eos_id=-1)
        reqs = list(enumerate(_prompts((6, 6, 6), seed=2)))
    else:
        sc = dict(slots=1, cache_len=64, eos_id=-1)
        reqs = [(0, _prompts((40,), seed=3)[0])]
    want = _serve(_ref_loop(arch, **sc), reqs, 12)
    assert _serve(_port_loop(arch, **sc), reqs, 12) == want


def test_mamba2_tokens_equal_reference_in_a_staggered_mix():
    """mamba2 reads no position: prompts of 20, 9 and 14 tokens through
    3 slots admitted at once but finishing apart give the reference's
    tokens (no slot is reused)."""
    sc = dict(slots=3, cache_len=64, eos_id=-1)
    reqs = list(enumerate(_prompts((20, 9, 14), seed=0)))
    want = _serve(_ref_loop("mamba2_780m", **sc), reqs, 10)
    assert _serve(_port_loop("mamba2_780m", **sc), reqs, 10) == want


@pytest.mark.parametrize("arch", STATEFUL)
def test_staggered_mix_equals_alone(arch):
    """2 slots, prompts of 5, 3, 7, 6 and 4 tokens, 8 new: requests 2-4
    reuse a slot at another position than its co-resident's.  In the
    port each request's logits in the mix equal its logits alone,
    exactly; in the reference (stale SSD rows, and for hymba the shared
    position) a reused slot's do not."""
    sc = dict(slots=2, cache_len=64, eos_id=-1)
    reqs = list(enumerate(_prompts((5, 3, 7, 6, 4), seed=2)))
    for make, sound in ((_port_loop, True), (_ref_loop, False)):
        mix = make(arch, **sc)
        toks = _serve(mix, reqs, 8)
        same = []
        for r, p in reqs:
            alone = make(arch, **sc)
            one = _serve(alone, [(r, p)], 8)
            same.append(one[r] == toks[r] and all(
                np.array_equal(a, b) for a, b in zip(mix.rows[r],
                                                     alone.rows[r])))
        assert all(same) if sound else not all(same), (make.__name__, same)


@pytest.mark.parametrize("arch", STATEFUL)
def test_reused_slot_starts_from_a_zero_ssm_state(arch, monkeypatch):
    """One slot, two requests: the first leaves non-zero SSD rows; when
    the second is admitted its first prefill step sees zero rows."""
    loop = _port_loop(arch, slots=1, cache_len=64, eos_id=-1)
    _serve(loop, [(0, _prompts((7,), seed=4)[0])], 4)
    assert float(loop.state["ssm_h"].abs().sum()) > 0
    seen = []
    inner = loop._step

    def spy(toks, pos, mask):
        if not seen:
            seen.append((loop.state["ssm_h"][:, 0].clone(),
                         loop.state["ssm_conv"][:, 0].clone()))
        return inner(toks, pos, mask)

    monkeypatch.setattr(loop, "_step", spy)
    _serve(loop, [(1, _prompts((5,), seed=5)[0])], 4)
    assert all(float(t.abs().max()) == 0.0 for t in seen[0])


# --------------------------------------------------------------- faults --
SNAP_PROMPTS = [[5, 6, 7, 8, 9, 10], [20, 21, 22], [30, 31, 32, 33],
                [40, 41]]


def _snap_loop(**extra):
    _, tp = _weights("mamba2_780m")
    return ServeLoop(get_smoke_config("mamba2_780m"), tp,
                     ServeConfig(slots=2, cache_len=32, eos_id=-1, **extra),
                     engine=DotEngine(schedule="morton"), device="cpu")


@pytest.mark.parametrize("where", ["memory", "disk"])
def test_ssm_snapshot_corrupt_restore_replays(where, tmp_path):
    """A mamba2 loop snapshotted mid-run (the SSD rows and the
    scheduler), its ``ssm_h`` and ``ssm_conv`` then corrupted with NaN:
    the restore brings both back exactly, and the run ends with an
    uninterrupted run's tokens."""
    clean = _snap_loop()
    want = _serve(clean, list(enumerate(SNAP_PROMPTS)), 6)
    loop = _snap_loop()
    for r, p in enumerate(SNAP_PROMPTS):
        loop.submit(r, p)
    for _ in range(5):
        loop._run_iteration(6)
    snap = ServeSnapshotter(loop, root=str(tmp_path) if where == "disk"
                            else None)
    snap.snapshot(loop._iter)
    saved = {k: v.clone() for k, v in loop.state.items()}
    assert set(saved) == {"ssm_h", "ssm_conv"}
    for k in saved:
        loop.state[k].fill_(float("nan"))
    assert snap.restore(from_disk=where == "disk") == 5
    for k, v in saved.items():
        assert torch.equal(loop.state[k], v), k
    assert loop.run(max_new=6) == want


def test_ssm_chaos_retries_and_nan_quarantine():
    """Retried step and kernel faults (restore and replay every time)
    give the clean run's tokens; a NaN injected into request 1's logits
    fails request 1 only, and every other request's tokens equal the
    clean run's (its slot's SSD rows are zeroed for the next request)."""
    clean = _serve(_snap_loop(), list(enumerate(SNAP_PROMPTS)), 6)
    retry = _snap_loop(chaos="step@step=2,kernel@step=4,step@step=7",
                       retry_backoff_s=0.0)
    assert _serve(retry, list(enumerate(SNAP_PROMPTS)), 6) == clean
    assert retry.snapshotter.restores >= 3 and retry.chaos.exhausted()
    nan = _snap_loop(chaos="nan@step=3:req=1")
    out = _serve(nan, list(enumerate(SNAP_PROMPTS)), 6)
    assert nan.errors == {1: "nan"}
    for r in (0, 2, 3):
        assert out[r] == clean[r], r


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_runs_each_family(arch, capsys):
    """The CLI on the SMOKE config on the CPU (moe continuous and paged,
    the others lockstep contiguous)."""
    extra = ["--mode", "continuous", "--layout", "paged"] \
        if arch in MOE else []
    out = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "4",
                      "--power-backend", "model", "--no-obs"] + extra)
    assert sorted(out) == [0, 1, 2]
    assert all(8 < len(t) <= 8 + 4 for t in out.values())
    assert get_smoke_config(arch).name in capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_runs_each_family(arch):
    """``launch/train.py`` on the SMOKE config on the CPU: 3 steps of 4 x
    32 tokens, a finite last loss and every parameter finite."""
    from repro_torch.launch.train import main as train_main

    out = train_main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "4", "--seq", "32",
                      "--log-every", "1", "--power-backend", "model",
                      "--no-obs"])
    assert np.isfinite(out["last_loss"])
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(out["params"]))
