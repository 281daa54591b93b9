"""Training-path parity of the port against ``repro`` on the CPU.

Inputs are made once with numpy (the reference's parameters through
``convert.params_from_jax``, its batches) and go through both packages;
the reference runs its engine ``DotEngine(schedule="morton")``, whose
CPU path is the f32-accumulated XLA dot with the same fused epilogue.

Tolerances (f32 SMOKE configs; the plain SFC GEMM sums bk-deep blocks
in another order than XLA's dot):

* forward logits within 1e-5 absolute (O(1) values); the loss, ``ce``
  and ``aux`` within 1e-5 relative; every gradient leaf within 1e-4 of
  its largest magnitude (through 2 layers and the backward);
* one ``adamw_update``: moments, master and f32 parameters within 1e-6
  relative (the same f32 ops in the same order), bf16 parameters within
  one bf16 rounding step, the norm and the rate within 1e-6 relative;
  the schedules within 1e-6 relative;
* batches of ``PackedSyntheticData`` and ``make_batch`` equal exactly;
* five ``make_train_step`` steps: every loss and gradient norm within
  1e-5 relative, the final parameters within 1e-4 absolute (Adam's
  normalised step turns f32 rounding differences of tiny gradients into
  differences of up to lr).
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.data import PackedSyntheticData as RefData
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import DotEngine as RefDotEngine
from repro.models import init_model as ref_init_model
from repro.models import loss_fn as ref_loss_fn
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.frontends import make_batch as ref_make_batch
from repro.models.transformer import forward as ref_forward
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro.optim.schedule import cosine_schedule as ref_cosine
from repro.optim.schedule import linear_schedule as ref_linear

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data import PackedSyntheticData, PrefetchLoader
from repro_torch.data.pipeline import batch_to_device
from repro_torch.launch.steps import grads_of, make_train_step
from repro_torch.models import DotEngine, forward, make_batch
from repro_torch.models.config import ShapeSpec
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule, \
    init_opt_state, linear_schedule
from repro_torch.optim.adamw import tree_leaves

REF_ENGINE = RefDotEngine(schedule="morton")
SHAPE = (4, 32)            # batch, seq


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the multi-rank tests' ranks share the cores
    with this module's worker, and an oversubscribed thread pool waits
    far longer than one thread computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **over):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _params(ref_cfg, seed=0):
    p = ref_init_model(ref_cfg, jax.random.PRNGKey(seed))
    return p, params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _batch(ref_cfg, step=0, seed=0, mask=False):
    b, s = SHAPE
    batch = RefData(ref_cfg, RefShapeSpec("t", s, b, "train"),
                    seed=seed).batch(step)
    if mask:
        m = np.ones((b, s), np.float32)
        m[:, : s // 4] = 0.0
        m[1, :] = 0.0
        batch["loss_mask"] = m
    return batch, batch_to_device(batch, "cpu")


def _leaf_close(got: torch.Tensor, want, rel: float):
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("mask", [False, True], ids=["", "loss_mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, mask):
    ref_cfg, cfg = _configs(arch)
    ref_p, p = _params(ref_cfg)
    ref_b, b = _batch(ref_cfg, mask=mask)
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        lambda q: ref_loss_fn(q, ref_cfg, ref_b, REF_ENGINE),
        has_aux=True)(ref_p)
    loss, metrics, g = grads_of(cfg, p, b, DotEngine())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_m[k]),
                                   rtol=1e-5, atol=1e-7)
    flat = jax.tree_util.tree_flatten_with_path(ref_g)[0]
    leaves = tree_leaves(g)
    assert len(flat) == len(leaves)
    for (path, want), got in zip(flat, leaves):
        _leaf_close(got, want, 1e-4)
    if not mask:
        ref_logits, _ = ref_forward(ref_p, ref_cfg, ref_b, REF_ENGINE)
        with torch.no_grad():
            logits, aux = forward(p, cfg, b, DotEngine())
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=1e-5, rtol=0)
        if cfg.family != "moe":
            assert float(aux) == 0.0


def test_padded_vocab_is_masked_as_the_reference_masks_it():
    ref_cfg, cfg = _configs("qwen3_1_7b", vocab=100)
    assert cfg.padded_vocab == 128
    ref_p, p = _params(ref_cfg)
    ref_b, b = _batch(ref_cfg)
    ref_logits, _ = ref_forward(ref_p, ref_cfg, ref_b, REF_ENGINE)
    with torch.no_grad():
        logits, _ = forward(p, cfg, b, DotEngine())
    assert bool((logits[..., 100:] == -1e30).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-5, rtol=0)
    ref_loss, _ = ref_loss_fn(ref_p, ref_cfg, ref_b, REF_ENGINE)
    loss, _, _ = grads_of(cfg, p, b, DotEngine())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


def _opt_inputs(seed, count):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 4, 3)}}
    dtypes = {"a": "float32", "b": {"c": "bfloat16", "d": "float32"}}

    def draw(node, dt, scale):
        if isinstance(node, dict):
            return {k: draw(node[k], dt[k], scale) for k in node}
        return jnp.asarray(rng.standard_normal(node) * scale, dtype=dt)

    params = draw(shapes, dtypes, 1.0)
    grads = draw(shapes, dtypes, 3.0)
    state = ref_init_opt_state(params)
    state["m"] = jax.tree.map(lambda x: x + 0.01, state["m"])
    state["v"] = jax.tree.map(lambda x: x + 0.02, state["v"])
    state["count"] = jnp.asarray(count, jnp.int32)
    return params, grads, state


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device="cpu")


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("count", [0, 6])
def test_adamw_update_matches_reference(count, clip):
    params, grads, state = _opt_inputs(count + 1, count)
    ocfg = dict(peak_lr=1e-2, warmup=3, total_steps=20, clip_norm=clip)
    rp, rs, rm = ref_adamw_update(grads, state, params,
                                  RefAdamWConfig(**ocfg))
    tp, ts = _to_torch(params), _to_torch(state)
    tp2, ts2, tm = adamw_update(_to_torch(grads), ts, tp, AdamWConfig(**ocfg))
    assert tp2 is tp and ts2 is ts          # updated in place
    assert int(ts["count"]) == int(rs["count"]) == count + 1
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-6)
    for key in ("m", "v", "master"):
        for got, want in zip(tree_leaves(ts[key]),
                             jax.tree.leaves(rs[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(rp)):
        assert str(got.dtype)[6:] == str(want.dtype)
        rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-7)


def test_init_opt_state_matches_reference():
    params, _, _ = _opt_inputs(0, 0)
    rs = ref_init_opt_state(params)
    ts = init_opt_state(_to_torch(params))
    assert int(ts["count"]) == 0 and ts["count"].dtype == torch.int32
    for key in ("m", "v", "master"):
        for got, want in zip(tree_leaves(ts[key]), jax.tree.leaves(rs[key])):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("warmup,total,floor", [(100, 10_000, 0.1),
                                                (10, 50, 0.0), (0, 4, 0.1)])
def test_schedules_match_reference(warmup, total, floor):
    for step in (0, 1, 2, 5, 9, 10, 11, 37, 50, 99, 100, 101, 5000, 20_000):
        kw = dict(peak_lr=3e-3, warmup=warmup, total=total)
        np.testing.assert_allclose(
            float(cosine_schedule(step, floor=floor, **kw)),
            float(ref_cosine(step, floor=floor, **kw)), rtol=1e-6)
        np.testing.assert_allclose(
            float(linear_schedule(torch.tensor(step, dtype=torch.int32),
                                  **kw)),
            float(ref_linear(step, **kw)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "glm4_9b"])
def test_packed_batches_equal_reference(arch):
    ref_cfg, cfg = _configs(arch)
    for seed, (b, s) in ((0, (4, 32)), (3, (2, 300)), (11, (1, 17))):
        ref = RefData(ref_cfg, RefShapeSpec("t", s, b, "train"), seed=seed,
                      mean_doc_len=16)
        ours = PackedSyntheticData(cfg, ShapeSpec("t", s, b, "train"),
                                   seed=seed, mean_doc_len=16)
        for step in (0, 1, 7, 1000):
            want, got = ref.batch(step), ours.batch(step)
            assert set(want) == set(got) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_loader_yields_the_dataset_in_order_on_the_device():
    cfg = get_smoke_config("qwen3_1_7b")
    data = PackedSyntheticData(cfg, ShapeSpec("t", 16, 2, "train"), seed=5)
    loader = PrefetchLoader(data, start_step=3,
                            put_fn=lambda b: batch_to_device(b, "cpu"))
    try:
        for want_step in (3, 4, 5):
            step, batch = next(loader)
            assert step == want_step
            for k, v in data.batch(step).items():
                assert isinstance(batch[k], torch.Tensor)
                np.testing.assert_array_equal(batch[k].numpy(), v)
    finally:
        loader.close()
    assert not loader._t.is_alive()

    class Broken:
        def batch(self, step):
            raise RuntimeError("no data")

    loader = PrefetchLoader(Broken())
    try:
        with pytest.raises(RuntimeError, match="no data"):
            next(loader)
    finally:
        loader.close()


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_make_batch_equals_reference(seed):
    ref_cfg, cfg = _configs("qwen3_1_7b")
    want = ref_make_batch(ref_cfg, RefShapeSpec("t", 24, 3, "train"),
                          seed=seed)
    got = make_batch(cfg, ShapeSpec("t", 24, 3, "train"), seed=seed)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_five_train_steps_match_reference(grad_accum):
    ref_cfg, cfg = _configs("qwen3_1_7b")
    ref_p, p = _params(ref_cfg)
    ref_o, o = ref_init_opt_state(ref_p), init_opt_state(p)
    ocfg = dict(peak_lr=3e-3, warmup=1, total_steps=5)
    ref_step = jax.jit(ref_make_train_step(
        ref_cfg, None, RefAdamWConfig(**ocfg), grad_accum=grad_accum,
        engine=REF_ENGINE))
    step = make_train_step(cfg, None, AdamWConfig(**ocfg),
                           grad_accum=grad_accum)
    for i in range(5):
        ref_b, b = _batch(ref_cfg, step=i, seed=1)
        ref_p, ref_o, ref_m = ref_step(ref_p, ref_o, ref_b)
        p2, o2, m = step(p, o, b)
        assert p2 is p and o2 is o
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5)
        assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
        np.testing.assert_allclose(float(m["ce"]), float(m["loss"]),
                                   rtol=1e-6)
    assert int(o["count"]) == int(ref_o["count"]) == 5
    for got, want in zip(tree_leaves(p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_train_step_raises_for_a_mesh():
    """Given a mesh, ``make_train_step`` runs on the shards (2 gloo
    ranks, a (1, 1, 2) mesh): the same loss within 1e-5 relative, the
    parameters within the reference selftest's 5e-2 of the
    single-device step, and the update within 1e-6 of the single-device
    ``adamw_update`` (``_dist_ranks.assert_update_matches``); it
    raises, naming the shapes, only on a model axis the heads do not
    divide (4 ranks: 2 kv-heads).  Off a mesh ``pod_compress`` changes
    nothing, as in the reference."""
    import _dist_ranks
    from repro_torch.distributed.ctx import spawn

    ref_cfg, cfg = _configs("qwen3_1_7b")
    ref_p, p = _params(ref_cfg)
    _, b = _batch(ref_cfg, step=0, seed=1)
    ocfg = dict(peak_lr=1e-2, warmup=0)
    np_p = jax.tree.map(np.asarray, ref_p)
    np_b = {k: v.numpy() for k, v in b.items()}
    bad = spawn(_dist_ranks.mesh_step_ranks, 4, "qwen3_1_7b", np_p, np_b,
                ocfg, 4)
    assert "2 kv-heads do not both divide the 4-way model axis" \
        in bad["error"]
    got = spawn(_dist_ranks.mesh_step_ranks, 2, "qwen3_1_7b", np_p, np_b,
                ocfg, 2)
    runs = []
    for pod_compress in (False, True):
        q = jax.tree.map(lambda t: t.clone(), p)
        q, _, m = make_train_step(cfg, None, AdamWConfig(**ocfg),
                                  pod_compress=pod_compress)(
            q, init_opt_state(q), b)
        runs.append((float(m["loss"]), tree_leaves(q)))
    assert runs[0][0] == runs[1][0]
    for x, y in zip(runs[0][1], runs[1][1]):
        assert torch.equal(x, y)
    loss, want = runs[0]
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    for g, w in zip(got["params"], want):
        np.testing.assert_allclose(g, w.numpy(), rtol=5e-2, atol=5e-2)
    g_single = [g.numpy() for g in tree_leaves(grads_of(
        cfg, p, b, DotEngine())[2])]
    for g, w in zip(got["grads"], g_single):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    noise = _dist_ranks.assert_update_matches(
        got["step"], _dist_ranks.adamw_single(p, got["grads"], ocfg),
        _dist_ranks.adamw_single(p, g_single, ocfg), g_single,
        got["names"], lr=ocfg["peak_lr"])
    assert noise <= sum(x.size for x in g_single) // 1000
