"""Port parity for the locality study's host modules: ``repro_torch``'s
``core.curves`` index costs, ``core.schedule.matmul_block_trace``,
``core.locality`` (the cache simulator), ``core.layout`` (SFC storage
layouts on tensors), ``configs.paper`` and the GEMM oracles of
``kernels.ref``, against ``repro``'s on the same inputs.

Traces, cache statistics, traffic bytes, permutations and layouts must
be equal exactly.  ``simulate_direct`` keys its sets by Python's
``hash``, which is salted per process, so port and reference are
compared inside this one process.  The GEMM oracles compare f32 outputs
within atol = rtol = 1e-5 (f32 summation order only)."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import paper as jax_paper
from repro.core import curves as jax_curves
from repro.core import layout as jax_layout
from repro.core import locality as jax_locality
from repro.core import schedule as jax_schedule
from repro.kernels import ref as jax_ref
from repro_torch.configs import paper
from repro_torch.core import curves, layout, locality, schedule
from repro_torch.kernels import ref

F32 = dict(rtol=1e-5, atol=1e-5)
GRIDS = [("rowmajor", 8, 8, 0), ("morton", 8, 8, 0), ("hilbert", 8, 8, 0),
         ("peano", 9, 9, 0), ("supertile", 8, 8, 2), ("morton", 4, 6, 0),
         ("hilbert", 5, 3, 0)]


def _order(name, rows, cols, g):
    kw = {"g": g} if g else {}
    return (jax_schedule.grid_schedule(name, rows, cols, **kw),
            schedule.grid_schedule(name, rows, cols, **kw))


def _stats(st):
    return (st.accesses, st.misses, st.hits, st.miss_rate,
            dict(st.per_tensor_misses))


def test_index_cost_ops_match():
    assert curves.morton_index_cost_ops() == \
        jax_curves.morton_index_cost_ops()
    for order in range(1, 17):
        assert curves.hilbert_index_cost_ops(order) == \
            jax_curves.hilbert_index_cost_ops(order)


@pytest.mark.parametrize("k_inner", [True, False])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}-{g[1]}x{g[2]}")
def test_matmul_block_trace_matches(grid, k_inner):
    jo, to = _order(*grid)
    assert schedule.matmul_block_trace(to, 3, k_inner=k_inner) == \
        jax_schedule.matmul_block_trace(jo, 3, k_inner=k_inner)


@pytest.mark.parametrize("capacity", [1, 4, 9, 24, 64])
@pytest.mark.parametrize("name", ["rowmajor", "morton", "hilbert"])
def test_simulators_match(name, capacity):
    jo, to = _order(name, 8, 8, 0)
    jt = jax_schedule.matmul_block_trace(jo, 4)
    tt = schedule.matmul_block_trace(to, 4)
    assert _stats(locality.simulate_lru(tt, capacity)) == \
        _stats(jax_locality.simulate_lru(jt, capacity))
    assert _stats(locality.simulate_direct(tt, capacity)) == \
        _stats(jax_locality.simulate_direct(jt, capacity))
    assert _stats(locality.simulate_consecutive(tt)) == \
        _stats(jax_locality.simulate_consecutive(jt))
    for model in ("lru", "consecutive", "direct"):
        assert _stats(locality.simulate(tt, model, capacity)) == \
            _stats(jax_locality.simulate(jt, model, capacity))


def test_unknown_cache_model_raises():
    with pytest.raises(ValueError, match="unknown cache model"):
        locality.simulate([], "fifo")


@pytest.mark.parametrize("model", ["lru", "consecutive", "direct"])
@pytest.mark.parametrize("k_inner", [True, False])
@pytest.mark.parametrize("capacity", [8, 48])
@pytest.mark.parametrize("grid", GRIDS[:5], ids=lambda g: g[0])
def test_matmul_hbm_traffic_matches(grid, capacity, k_inner, model):
    jo, to = _order(*grid)
    bb = {"A": 16 * 8 * 4, "B": 8 * 16 * 4, "C": 16 * 16 * 4}
    mine = locality.matmul_hbm_traffic(to, 5, bb, model=model,
                                       capacity=capacity, k_inner=k_inner)
    want = jax_locality.matmul_hbm_traffic(jo, 5, bb, model=model,
                                           capacity=capacity,
                                           k_inner=k_inner)
    for key in ("read_bytes", "write_bytes", "total_bytes", "misses"):
        assert mine[key] == want[key], key
    assert _stats(mine["stats"]) == _stats(want["stats"])


def test_curves_pay_in_the_lru_model():
    """The reference's paper finding holds in the port's simulator too:
    with a cache of a few k-panels, row-major misses more than Morton,
    and Morton at least as much as Hilbert."""
    kt, bb = 16, {"A": 1, "B": 1, "C": 1}
    misses = {s: locality.matmul_hbm_traffic(
        schedule.grid_schedule(s, 16, 16), kt, bb, capacity=4 * kt)["misses"]
        for s in ("rowmajor", "morton", "hilbert")}
    assert misses["rowmajor"] > misses["morton"] >= misses["hilbert"], misses


@pytest.mark.parametrize("sched", ["rowmajor", "morton", "hilbert", "peano"])
@pytest.mark.parametrize("rows,cols", [(4, 4), (3, 5), (8, 2)])
def test_tile_permutation_matches(sched, rows, cols):
    mine = layout.tile_permutation(rows, cols, sched)
    want = jax_layout.tile_permutation(rows, cols, sched)
    assert mine.dtype == want.dtype
    np.testing.assert_array_equal(mine, want)


@pytest.mark.parametrize("sched", ["rowmajor", "morton", "hilbert"])
@pytest.mark.parametrize("shape,blk", [((8, 8), (2, 2)), ((16, 12), (4, 4)),
                                       ((9, 7), (4, 2))])
def test_blocked_layout_matches_and_round_trips(sched, shape, blk):
    m, n = shape
    bm, bn = blk
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jax_layout.to_blocked(jnp.asarray(x), bm, bn, sched)
    tiles = layout.to_blocked(torch.from_numpy(x), bm, bn, sched)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(want))
    back = layout.from_blocked(tiles, m, n, bm, bn, sched)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("sched", ["rowmajor", "morton", "hilbert"])
@pytest.mark.parametrize("n", [2, 8, 16])
def test_element_layout_matches_and_round_trips(sched, n):
    np.testing.assert_array_equal(layout.element_permutation(n, sched),
                                  jax_layout.element_permutation(n, sched))
    x = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    want = jax_layout.to_element_order(jnp.asarray(x), sched)
    flat = layout.to_element_order(torch.from_numpy(x), sched)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = layout.from_element_order(flat, n, sched)
    np.testing.assert_array_equal(back.numpy(), x)


def test_element_layout_rejects_bad_input():
    with pytest.raises(ValueError, match="power-of-two"):
        layout.element_permutation(12, "morton")
    with pytest.raises(ValueError, match="unsupported element schedule"):
        layout.element_permutation(8, "peano")


def test_paper_config_matches():
    """The port keeps the reference's sizes, schedules, dtype and block;
    its CPU-only settings (frequencies, threads) are dropped."""
    for field in dataclasses.fields(paper.CONFIG):
        assert getattr(paper.CONFIG, field.name) == \
            getattr(jax_paper.CONFIG, field.name), field.name
    assert {f.name for f in dataclasses.fields(paper.CONFIG)} == \
        {"sizes", "schedules", "dtype", "block"}
    assert paper.CONFIG.sizes == (10, 11, 12)
    assert paper.CONFIG.schedules == ("rowmajor", "morton", "hilbert")


def _ab(shape_a, shape_b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_a).astype(np.float32),
            rng.standard_normal(shape_b).astype(np.float32))


def test_matmul_refs_match():
    a, b = _ab((12, 20), (20, 8), 2)
    np.testing.assert_allclose(
        ref.matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_ref.matmul_ref(jnp.asarray(a), jnp.asarray(b))), **F32)
    a, b = _ab((2, 3, 12, 20), (2, 3, 20, 8), 3)
    np.testing.assert_allclose(
        ref.matmul_batched_ref(torch.from_numpy(a),
                               torch.from_numpy(b)).numpy(),
        np.asarray(jax_ref.matmul_batched_ref(jnp.asarray(a),
                                              jnp.asarray(b))), **F32)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
def test_matmul_batched_fused_ref_matches(activation):
    a, b = _ab((2, 3, 12, 20), (2, 3, 20, 8), 4)
    bias, res = _ab((8,), (2, 3, 12, 8), 5)
    want = jax_ref.matmul_batched_fused_ref(
        jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
        activation=activation, residual=jnp.asarray(res))
    mine = ref.matmul_batched_fused_ref(
        torch.from_numpy(a), torch.from_numpy(b), bias=torch.from_numpy(bias),
        activation=activation, residual=torch.from_numpy(res))
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("sched", ["rowmajor", "morton", "hilbert"])
def test_matmul_blocked_ref_matches(sched):
    a, b = _ab((32, 24), (24, 32), 6)
    order = schedule.grid_schedule(sched, 4, 4)
    want = jax_ref.matmul_blocked_ref(jnp.asarray(a), jnp.asarray(b), 8, 8,
                                      8, order)
    mine = ref.matmul_blocked_ref(torch.from_numpy(a), torch.from_numpy(b),
                                  8, 8, 8, order)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(mine.numpy(), a @ b, **F32)
