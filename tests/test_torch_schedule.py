"""Port parity: curve arithmetic and grid schedules of ``repro_torch``
equal ``repro``'s exactly (tables, encode/decode on integer tensors)."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import curves as jcurves
from repro.core.schedule import grid_schedule as jax_grid_schedule
from repro.kernels.sfc_matmul import decode_step as jax_decode_step
from repro_torch.core import curves as tcurves
from repro_torch.core.schedule import SCHEDULES, grid_schedule
from repro_torch.kernels.sfc_matmul import decode_step, tile_schedule

GRIDS = [(1, 1), (1, 16), (16, 1), (2, 3), (3, 5), (4, 4), (5, 7), (8, 8),
         (6, 10), (9, 9), (13, 4), (1, 40), (28, 16)]
# the vocab head's tile grid at full width (1 x 1187 tiles of 128
# columns), which the serving path walks in Morton order; the reference
# builds it with a Python loop over 2048**2 curve indices (~7 s here)
HEAD_GRID = (1, 1187)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_grid_schedule_tables_equal_reference(name):
    for rows, cols in GRIDS:
        mine = grid_schedule(name, rows, cols)
        ref = jax_grid_schedule(name, rows, cols)
        assert mine.dtype == np.int32
        np.testing.assert_array_equal(mine, ref, err_msg=f"{name} {rows}x{cols}")
        assert not mine.flags.writeable


def test_head_grid_morton_table_equals_reference():
    np.testing.assert_array_equal(grid_schedule("morton", *HEAD_GRID),
                                  jax_grid_schedule("morton", *HEAD_GRID))


@pytest.mark.parametrize("g", [2, 3, 4])
def test_supertile_factor_tables_equal_reference(g):
    for rows, cols in GRIDS:
        np.testing.assert_array_equal(
            grid_schedule("supertile", rows, cols, g=g),
            jax_grid_schedule("supertile", rows, cols, g=g))


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        grid_schedule("zigzag", 2, 2)


def test_morton_tensor_ops_equal_reference():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 1 << 16, size=512)
    x = rng.integers(0, 1 << 16, size=512)
    d = np.asarray(jcurves.morton_encode(y.astype(np.uint32),
                                         x.astype(np.uint32)))
    mine = tcurves.morton_encode(torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_array_equal(mine.numpy(), d.astype(np.int64))
    jy, jx = jcurves.morton_decode(d)
    ty, tx = tcurves.morton_decode(torch.from_numpy(d.astype(np.int64)))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for yy, xx in zip(y[:32].tolist(), x[:32].tolist()):
        dd = jcurves.morton_encode_py(yy, xx)
        assert tcurves.morton_encode_py(yy, xx) == dd
        assert tcurves.morton_decode_py(dd) == jcurves.morton_decode_py(dd)


@pytest.mark.parametrize("order", [1, 2, 3, 5])
def test_hilbert_tensor_ops_equal_reference(order):
    side = 1 << order
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    y, x = yy.ravel(), xx.ravel()
    d = np.asarray(jcurves.hilbert_encode(y.astype(np.uint32),
                                          x.astype(np.uint32), order))
    mine = tcurves.hilbert_encode(torch.from_numpy(y), torch.from_numpy(x),
                                  order)
    np.testing.assert_array_equal(mine.numpy(), d.astype(np.int64))
    dd = np.arange(side * side)
    jy, jx = jcurves.hilbert_decode(dd.astype(np.uint32), order)
    ty, tx = tcurves.hilbert_decode(torch.from_numpy(dd), order)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for t in range(side * side):
        assert tcurves.hilbert_decode_py(t, order) == \
            jcurves.hilbert_decode_py(t, order)
        yy_, xx_ = jcurves.hilbert_decode_py(t, order)
        assert tcurves.hilbert_encode_py(yy_, xx_, order) == \
            jcurves.hilbert_encode_py(yy_, xx_, order)


@pytest.mark.parametrize("schedule,grid", [
    ("rowmajor", (3, 5)), ("colmajor", (3, 5)), ("morton", (8, 8)),
    ("hilbert", (8, 8)), ("hilbert", (1, 1))])
def test_closed_form_decode_equals_reference(schedule, grid):
    """The B1 closed-form variant walks the reference's tile order."""
    mt, nt = grid
    t = np.arange(mt * nt, dtype=np.int32)
    ji, jj = jax_decode_step(t, schedule, mt, nt)
    ti, tj = decode_step(torch.from_numpy(t).long(), schedule, mt, nt)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    tab = tile_schedule(schedule, mt, nt, use_prefetch=False)
    assert tab.dtype == torch.int32 and tab.shape == (mt * nt, 2)


def test_closed_form_decode_rejects_non_square_curve_grids():
    with pytest.raises(ValueError, match="square power-of-two"):
        decode_step(torch.arange(12), "morton", 3, 4)
    with pytest.raises(ValueError, match="no closed-form"):
        decode_step(torch.arange(4), "peano", 2, 2)
