"""The port's distributed layer against the reference where both are
exact, with no ranks spawned: every sharding spec and fallback counter,
the curve placement of ranks, the TPU-torus hop model and the tuner's
comm tag, the elastic plan, and the error-feedback compression.

A stand-in with ``axis_names`` and a ``shape`` mapping takes the place
of a jax ``Mesh`` (the spec functions read nothing else); the
reference's ``PartitionSpec`` is compared as the tuple it is.  Every
comparison is exact: equal specs, equal counts, equal permutations,
equal floats, bf16 bit for bit.
"""
import itertools

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import repro.configs as ref_configs
import repro.distributed.sharding as ref_shd
import repro.launch.mesh as ref_mesh
import repro.launch.steps as ref_steps
import repro.obs.metrics as ref_metrics
from repro.models import init_model as ref_init_model
from repro.optim.compress import ef_compress as ref_ef_compress
from repro.runtime.elastic import plan_elastic_mesh as ref_plan

import repro_torch.distributed.sharding as shd
import repro_torch.launch.mesh as mesh_mod
import repro_torch.launch.steps as steps
import repro_torch.obs.metrics as metrics
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.distributed.ctx import Mesh
from repro_torch.models import init_model
from repro_torch.optim.compress import ef_compress
from repro_torch.runtime.elastic import plan_elastic_mesh


class FakeMesh:
    """``axis_names`` and ``shape``: all a spec function reads."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))

    def __repr__(self):
        return f"FakeMesh({self.shape})"


MESHES = [FakeMesh(s, n) for s, n in [
    ((2, 2, 2), ("pod", "data", "model")),
    ((1, 1, 1), ("pod", "data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((16, 16), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((4, 8), ("data", "model")),
    ((1, 8), ("data", "model")),
    ((3, 2), ("data", "model")),
]]
MESH_IDS = [str(tuple(m.shape.values())) for m in MESHES]


def _tuples(tree):
    """A reference spec tree with every ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _ref_counter(name):
    return ref_metrics.default_registry().counter(name).value


def _counter(name):
    return metrics.default_registry().counter(name).value


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    cfg = get_config(arch)
    assert shd.param_specs(cfg) == _tuples(
        ref_shd.param_specs(ref_configs.get_config(arch)))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_and_batch_specs_equal_reference(arch, mesh):
    """ZeRO-1 over "data" on the full configs' shapes (meta tensors on
    the port's side, ``eval_shape`` on the reference's), the batch specs
    at divisible and indivisible batches and the decode SP axes."""
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    pad = mesh.shape["model"]
    if "data" in mesh.shape:
        got = shd.opt_state_specs(cfg, init_model(cfg, device="meta",
                                                  moe_pad=pad), mesh)
        want = ref_shd.opt_state_specs(ref_cfg, jax.eval_shape(
            lambda: ref_init_model(ref_cfg, jax.random.PRNGKey(0),
                                   moe_pad=pad)), mesh)
        assert got == _tuples(want)
    for b in (1, 7, 8, 256):
        assert shd.batch_specs(cfg, mesh, b) == _tuples(
            ref_shd.batch_specs(ref_cfg, mesh, b))
        assert shd.decode_seq_axes(cfg, mesh, b) == \
            ref_shd.decode_seq_axes(ref_cfg, mesh, b)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_and_counters_equal_reference(arch, mesh):
    """Both layouts' specs, and each fallback counted as often as the
    reference counts it (``distributed.paged_kv_replicated``,
    ``distributed.seq_shard_fallback_replicated``)."""
    cfg, ref_cfg = get_smoke_config(arch), ref_configs.get_smoke_config(arch)
    names = ("distributed.paged_kv_replicated",
             "distributed.seq_shard_fallback_replicated")
    before = [(_counter(n), _ref_counter(n)) for n in names]
    if cfg.has_attention:
        assert shd.paged_decode_state_specs(cfg, mesh) == _tuples(
            ref_shd.paged_decode_state_specs(ref_cfg, mesh))
    for b, cache_len in itertools.product((1, 8, 64), (32, 96, 100, 4096)):
        assert shd.decode_state_specs(cfg, mesh, b, cache_len) == _tuples(
            ref_shd.decode_state_specs(ref_cfg, mesh, b, cache_len))
    for n, (port0, ref0) in zip(names, before):
        assert _counter(n) - port0 == _ref_counter(n) - ref0, n


@pytest.mark.parametrize("mesh", MESHES[:6], ids=MESH_IDS[:6])
def test_zero1_spec_equals_reference(mesh):
    specs = [(), (None,), ("model",), (None, "model"), ("model", None),
             (None, None, "model")]
    shapes = [(4,), (16, 2048), (3, 5), (32, 64, 8), (256,), (1, 16, 16)]
    for spec, shape in itertools.product(specs, shapes):
        if len(spec) > len(shape):
            continue
        assert shd.zero1_spec(spec, shape, mesh) == tuple(
            ref_shd.zero1_spec(P(*spec), shape, mesh)), (spec, shape)


@pytest.mark.parametrize("order", mesh_mod.DEVICE_ORDERS)
@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (2, 4), (4, 4), (4, 8),
                                  (8, 8), (16, 16)])
def test_device_permutation_equals_reference(order, grid):
    rows, cols = grid
    devs = list(range(rows * cols))
    got = mesh_mod.device_permutation(order, rows, cols, devs)
    assert got == ref_mesh.device_permutation(order, rows, cols, devs)
    assert sorted(got) == devs


def test_device_permutation_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="unknown device_order"):
        mesh_mod.device_permutation("zorder", 2, 2, range(4))
    with pytest.raises(ValueError, match="cannot tile"):
        mesh_mod.device_permutation("hilbert", 2, 4, range(6))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 3, 12])
def test_default_torus_equals_reference(n):
    try:
        want = ref_mesh.default_torus(n)
    except ValueError:
        with pytest.raises(ValueError):
            mesh_mod.default_torus(n)
        return
    assert mesh_mod.default_torus(n) == want


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("order", mesh_mod.DEVICE_ORDERS)
@pytest.mark.parametrize("mesh", MESHES[:7], ids=MESH_IDS[:7])
def test_link_distance_equals_reference(mesh, order, wrap):
    """The TPU-torus hop model, float for float."""
    got = mesh_mod.link_distance(mesh, device_order=order, wrap=wrap)
    assert got == ref_mesh.link_distance(mesh, device_order=order,
                                         wrap=wrap)


@pytest.mark.parametrize("order", mesh_mod.DEVICE_ORDERS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_comm_for_tag_equals_reference(mesh, order):
    """``_comm_for`` under the order a mesh was built with: the same
    CommSpec tag, so the tuner's mesh cache keys agree."""
    port_mesh = FakeMesh(tuple(mesh.shape.values()), mesh.axis_names)
    ref_m = FakeMesh(tuple(mesh.shape.values()), mesh.axis_names)
    mesh_mod._record_device_order(port_mesh, order)
    ref_mesh._record_device_order(ref_m, order)
    got, want = steps._comm_for(port_mesh), ref_steps._comm_for(ref_m)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.tag() == want.tag()
        assert (got.ways, got.hops, got.axis) == \
            (want.ways, want.hops, want.axis)


@pytest.mark.parametrize("failed", [0, 1, 2, 3, 4, 6, 7, 8])
@pytest.mark.parametrize("axes,sizes", [
    (("pod", "data", "model"), (2, 2, 2)),
    (("data", "model"), (16, 16)),
    (("pod", "data", "model"), (2, 16, 16)),
    (("data", "model"), (8, 1)),
])
def test_plan_elastic_mesh_equals_reference(axes, sizes, failed):
    try:
        want = ref_plan(axes, sizes, failed)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="cannot form a mesh"):
            plan_elastic_mesh(axes, sizes, failed)
        return
    assert plan_elastic_mesh(axes, sizes, failed) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ef_compress_bit_equal_to_reference(seed):
    """Three rounds of error feedback on seeded gradients: the bf16
    payloads and the f32 residuals bit for bit."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 48), "b": {"c": (128,), "d": (3, 5, 7)}}
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32) * 10.0 ** rng.integers(-6, 3), shapes,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    ref_ef = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32),
                          grads[0])
    ef = jax.tree.map(lambda g: torch.zeros(g.shape), grads[0])
    for g in grads:
        ref_c, ref_ef = ref_ef_compress(jax.tree.map(jnp.asarray, g), ref_ef)
        c, ef = ef_compress(jax.tree.map(torch.from_numpy, g), ef)
        for got, want in zip(jax.tree.leaves(c), jax.tree.leaves(ref_c)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        for got, want in zip(jax.tree.leaves(ef), jax.tree.leaves(ref_ef)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_mesh_larger_than_the_world_raises():
    """Outside a joined world the world is one rank."""
    with pytest.raises(ValueError, match="needs 8 ranks; the world holds 1"):
        Mesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh_mod.make_smoke_mesh((2, 2, 2), device_order="hilbert")
    with pytest.raises(ValueError, match="unknown device_order"):
        mesh_mod.make_smoke_mesh((1, 1, 1), device_order="zorder")
