"""The port's sharded training on CPU gloo ranks against the reference.

The reference's own distributed checks cannot run here (its GSPMD steps
fail on the installed jax), but their contract can: the sharded step
equals the single-device step.  So the port's (2, 2, 2) step -- data,
tensor and ZeRO-1 parallel on 8 ranks (``repro_torch.distributed.ctx.
spawn``) -- is held to the reference's *single-device*
``make_train_step``, built as the reference's selftest builds it
(``src/repro/launch/selftest.py:29-43``: qwen3-1.7b SMOKE, f32,
``AdamWConfig(peak_lr=1e-2, warmup=0)``, ``make_batch`` of 8 x 32, seed
1), on the reference's weights (``params_from_jax``).

Bounds:

* the loss within 1e-5 relative (the port's own f32 bound for losses);
* the updated parameters within rtol = atol = 5e-2, the reference
  selftest's own (``selftest.py:67-69``): Adam's first step moves every
  weight by about lr = 1e-2 whatever the gradient's size, so a weight
  whose gradient is f32 noise may move either way (C4, ROADMAP.md);
* the update itself (ZeRO-1: each data rank's slices of m, v and the
  master, the all-gather of the parameters, the sharded clipping norm)
  against the port's single-device ``adamw_update``: on the step's own
  gradients every element within 1e-6 (m and v: of the leaf's largest);
  on the single-device gradients the same but for the elements whose
  gradient is f32 noise (``_dist_ranks.assert_update_matches``);
* the port's sharded gradients against its single-device gradients,
  each leaf within 1e-5 of its largest magnitude (the reduction order
  across ranks is the only difference), at grad_accum 1 and 2;
* the row-parallel GEMM with a residual (``layers.out_proj``) equals the
  one-device product within 1e-5, so a residual added on every rank
  (twice here) fails; its gradients likewise;
* a checkpoint saved under (2, 2, 2) and restored under (2, 1, 2) is
  bit-equal, shard by shard and gathered.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from repro.configs import get_smoke_config as ref_smoke
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_model as ref_init_model
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.frontends import make_batch as ref_make_batch
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import init_opt_state as ref_init_opt_state

import _dist_ranks
from repro_torch.distributed.ctx import spawn

OCFG = dict(peak_lr=1e-2, warmup=0)
ARCH = "qwen3_1_7b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_weights():
    return ref_init_model(ref_smoke(ARCH), jax.random.PRNGKey(0), moe_pad=2)


@pytest.fixture(scope="module")
def train(ref_weights):
    """One spawn of 8 ranks: the sharded step, the sharded and the
    single-device gradients; beside it the reference's step."""
    cfg = ref_smoke(ARCH)
    batch = ref_make_batch(cfg, RefShapeSpec("st_train", 32, 8, "train"),
                           seed=1)
    port = spawn(_dist_ranks.train_ranks, 8, ARCH, _np(ref_weights),
                 _np(batch), OCFG)
    step = jax.jit(ref_make_train_step(cfg, None, RefAdamWConfig(**OCFG)))
    pr, _, mr = step(ref_weights, ref_init_opt_state(ref_weights), batch)
    return port, _np(jax.tree.leaves(pr)), float(mr["loss"])


def test_sharded_step_loss_equals_the_reference_single_device(train):
    port, _, ref_loss = train
    assert abs(port["loss"] - ref_loss) <= 1e-5 * abs(ref_loss), \
        (port["loss"], ref_loss)


def test_sharded_step_params_within_the_selftest_bound(train):
    port, ref_params, _ = train
    assert len(port["params"]) == len(ref_params)
    for got, want in zip(port["params"], ref_params):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_zero1_update_equals_single_device_adamw(train):
    port = train[0]
    n = sum(p.size for p in port["params"])
    noise = _dist_ranks.assert_update_matches(
        port["step"], port["adamw_grads1"], port["adamw_single1"],
        port["single1"], port["names"], lr=OCFG["peak_lr"])
    # 17 of 90,496 at seed 1: a thousandth is the bound
    assert noise <= n // 1000, (noise, n)


def test_row_parallel_backward_gemms_take_the_activation_dtype():
    """A bf16 step on a (1, 1, 2) mesh runs B1 on the operand dtypes of
    the one-device step, backward included: the row-parallel wo and w2
    give f32 partial products, but their dgrad and wgrad GEMMs take
    the cotangent in bf16 as the fused one-device GEMMs do (only the
    vocab head's backward runs in f32 on both)."""
    got = spawn(_dist_ranks.gemm_dtypes_ranks, 2, ARCH, 2)
    assert got["mesh"] == got["single"], got
    # the head's dgrad and wgrad (f32 dLogits) are the only f32 GEMMs;
    # wo's and w2's backward in f32 would add four a layer
    assert got["single"] == {("torch.bfloat16", "torch.bfloat16"): 45,
                             ("torch.float32", "torch.float32"): 2}, got


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_sharded_gradients_equal_single_device(train, grad_accum):
    port = train[0]
    for got, want in zip(port[f"grads{grad_accum}"],
                         port[f"single{grad_accum}"]):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("grad", [False, True])
def test_row_parallel_residual_added_once(grad):
    """``x @ w + residual`` with K split over 2 ranks: the partial
    products are summed, the residual added once after the sum."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    res = rng.standard_normal((6, 24)).astype(np.float32)
    got = spawn(_dist_ranks.row_parallel_ranks, 2, x, w, res, grad)
    np.testing.assert_allclose(got["y"], x @ w + res, rtol=1e-5, atol=1e-5)
    if grad:   # d/d(residual) = 1 once, not once per rank
        np.testing.assert_array_equal(got["dres"], np.ones_like(res))
        np.testing.assert_allclose(got["dx"], np.ones_like(res) @ w.T,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dw"], x.T @ np.ones_like(res),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ckpt(ref_weights, tmp_path_factory):
    """One spawn of 8 ranks: the checkpoint round trip, then
    ``gather_to_root`` and the placed init."""
    return spawn(_dist_ranks.checkpoint_ranks, 8, _np(ref_weights),
                 str(tmp_path_factory.mktemp("ckpt")))


def test_checkpoint_saved_on_2x2x2_restores_on_2x1x2(ref_weights, ckpt):
    out = ckpt
    assert out["sizes"] == (2, 1, 2) and out["scale"] == 2
    assert out["equal"] is True
    for got, want in zip(jax.tree.leaves(out["back"]),
                         jax.tree.leaves(_np(ref_weights))):
        np.testing.assert_array_equal(got, want)


def test_gather_to_root_and_placed_init(ref_weights, ckpt):
    """``gather_to_root`` rebuilds the parameters and the ZeRO-1 state on
    rank 0 alone, bit-equal, under the Hilbert order, each distinct
    shard sent once (rank 0's own are not sent); ``init_model`` with
    ``place=shard_leaf`` draws the shards of the full draw."""
    import types

    import jax.tree_util as jtu
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd

    out = ckpt["gather"]
    assert out["placed_equal"] is True
    for got, want in zip(jtu.tree_leaves(out["full"]),
                         jtu.tree_leaves(out["want"])):
        np.testing.assert_array_equal(got, want)
    # per leaf: one send for each shard but rank 0's
    sizes = {"pod": 2, "data": 2, "model": 2}
    cfg = get_smoke_config(ARCH)
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    shapes = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"),
                          ref_weights)
    tup = lambda x: isinstance(x, tuple)  # noqa: E731
    want = 0
    for spec in (jtu.tree_leaves(shd.param_specs(cfg), is_leaf=tup)
                 + jtu.tree_leaves(shd.opt_state_specs(cfg, shapes, mesh)
                                   ["m"], is_leaf=tup)):
        axes = {a for s in spec if s is not None
                for a in ((s,) if isinstance(s, str) else s)}
        want += int(np.prod([sizes[a] for a in axes])) - 1
    assert out["sends"] == want


@pytest.mark.slow
def test_train_cli_mesh_with_failure_and_resume(tmp_path):
    """``--mesh 2,2,2 --device cpu``: the one command starts 8 ranks,
    trains through an injected failure (restored from rank 0's
    checkpoint) and a later resume from the last checkpoint."""
    from repro_torch.launch.train import main

    argv = ["--arch", ARCH, "--smoke", "--batch", "8", "--seq", "32",
            "--mesh", "2,2,2", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "10", "--log-every", "10"]
    state = main(argv + ["--steps", "20", "--inject-failure-at", "17"])
    assert np.isfinite(state["last_loss"])
    resumed = main(argv + ["--steps", "30"])
    assert np.isfinite(resumed["last_loss"])


@pytest.mark.slow
def test_pod_compress_converges():
    """The port's selftest: 8 steps with the error-feedback bf16 pod
    mean land near the exact sync's loss (the reference's bound)."""
    from repro_torch.launch.selftest import run
    run("pod_compress_converges", "cpu")
