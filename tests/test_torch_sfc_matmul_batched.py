"""Port parity for kernel B3 (the batched SFC GEMM): ``repro_torch``'s
``sfc_matmul_batched_cuda`` and ``ops.sfc_matmul_batched`` on CPU
tensors (the plain version of the CUDA kernel: per batch element the
same tile order, the same bk-deep f32 k blocks and the same epilogue)
against ``repro``'s ``sfc_matmul_batched_pallas`` and
``ops.sfc_matmul_batched`` run in interpret mode, and ``DotEngine.
dot_batched`` against the reference engine.

Bounds: f32 outputs agree within atol = rtol = 1e-5, the reference's
own bound for the batched kernel (f32 summation order only: the Pallas
interpreter and torch add the bk-wide partial products in different
orders).  bf16 outputs agree within atol = rtol = 2e-2 (one bf16
rounding of outputs up to ~4 in magnitude, as for B1).  The batched
route and the per-element B1 route are equal exactly: both walk the
same tiles with the same f32 arithmetic."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.ops import sfc_matmul_batched as jax_sfc_matmul_batched
from repro.kernels.ref import matmul_batched_fused_ref as jax_fused_ref
from repro.kernels.sfc_matmul import sfc_matmul_batched_pallas
from repro.models.layers import DotEngine as JaxDotEngine
from repro_torch.kernels import sfc_matmul as sfc_mod
from repro_torch.kernels.ops import sfc_matmul, sfc_matmul_batched
from repro_torch.kernels.sfc_matmul import sfc_matmul_batched_cuda
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models.layers import DotEngine

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BLK = dict(bm=16, bn=16, bk=16)


def _inputs(lead, m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((*lead, m, k)).astype(np.float32)
    b = (rng.standard_normal((*lead, k, n)) / np.sqrt(k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    res = rng.standard_normal((*lead, m, n)).astype(np.float32)
    return a, b, bias, res


def _epilogue(bias, res, activation, to):
    kw = {"activation": activation}
    if bias is not None:
        kw["bias"] = to(bias)
    if res is not None:
        kw["residual"] = to(res)
    return kw


@pytest.mark.parametrize("schedule", ["rowmajor", "morton", "hilbert"])
@pytest.mark.parametrize("use_prefetch", [True, False])
def test_schedules_match_pallas_interpret(schedule, use_prefetch):
    a, b, _, _ = _inputs((3,), 64, 64, 48, 0)
    ref = sfc_matmul_batched_pallas(jnp.asarray(a), jnp.asarray(b),
                                    schedule=schedule,
                                    use_prefetch=use_prefetch,
                                    interpret=True, **BLK)
    mine = sfc_matmul_batched_cuda(torch.from_numpy(a), torch.from_numpy(b),
                                   schedule=schedule,
                                   use_prefetch=use_prefetch, **BLK)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("with_bias,with_res", [(True, True), (True, False),
                                                (False, True)])
def test_fused_epilogue_matches_pallas_interpret(activation, with_bias,
                                                 with_res):
    a, b, bias, res = _inputs((2,), 32, 48, 32, 1)
    bias = bias if with_bias else None
    res = res if with_res else None
    ref = sfc_matmul_batched_pallas(
        jnp.asarray(a), jnp.asarray(b), schedule="morton", interpret=True,
        **_epilogue(bias, res, activation, jnp.asarray), **BLK)
    mine = sfc_matmul_batched_cuda(
        torch.from_numpy(a), torch.from_numpy(b), schedule="morton",
        **_epilogue(bias, res, activation, torch.from_numpy), **BLK)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("schedule,g", [("peano", 0), ("supertile", 2),
                                        ("boustrophedon", 0)])
def test_table_schedules_on_non_square_grids(schedule, g):
    a, b, _, _ = _inputs((2,), 48, 80, 32, 2)
    ref = sfc_matmul_batched_pallas(jnp.asarray(a), jnp.asarray(b),
                                    schedule=schedule, g=g, interpret=True,
                                    **BLK)
    mine = sfc_matmul_batched_cuda(torch.from_numpy(a), torch.from_numpy(b),
                                   schedule=schedule, g=g, **BLK)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("schedule", ["hilbert", "morton", "rowmajor"])
@pytest.mark.parametrize("mnk", [(50, 28, 36), (20, 24, 12), (4, 40, 56)])
def test_ops_leading_dims_and_ragged_match_reference_ops(schedule, mnk):
    """Leading dims (2, 3) are flattened and restored; ragged M/N/K are
    masked in the port where the reference pads and crops."""
    m, n, k = mnk
    a, b, bias, res = _inputs((2, 3), m, n, k, 3)
    ref = jax_sfc_matmul_batched(
        jnp.asarray(a), jnp.asarray(b), schedule=schedule, interpret=True,
        force_pallas=True, **_epilogue(bias, res, "silu", jnp.asarray),
        **BLK)
    mine = sfc_matmul_batched(
        torch.from_numpy(a), torch.from_numpy(b), schedule=schedule,
        **_epilogue(bias, res, "silu", torch.from_numpy), **BLK)
    assert mine.shape == (2, 3, m, n)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("use_prefetch", [True, False])
def test_per_element_route_equals_batched_route(use_prefetch):
    """The reference's via_vmap=True: one B1 call per element."""
    a, b, bias, res = _inputs((3,), 64, 64, 40, 4)
    kw = dict(schedule="morton", use_prefetch=use_prefetch,
              **_epilogue(bias, res, "gelu", torch.from_numpy), **BLK)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    grid = sfc_matmul_batched(ta, tb, **kw)
    per = sfc_matmul_batched(ta, tb, per_element=True, **kw)
    assert torch.equal(grid, per)
    one = sfc_matmul(ta[1], tb[1], schedule="morton",
                     use_prefetch=use_prefetch, bias=kw["bias"],
                     activation="gelu", residual=kw["residual"][1], **BLK)
    assert torch.equal(grid[1], one)


def test_reference_via_vmap_agrees():
    a, b, bias, res = _inputs((2,), 32, 32, 32, 5)
    kw = dict(schedule="hilbert", **BLK)
    ref = jax_sfc_matmul_batched(
        jnp.asarray(a), jnp.asarray(b), via_vmap=True, interpret=True,
        force_pallas=True, **_epilogue(bias, res, "relu", jnp.asarray), **kw)
    mine = sfc_matmul_batched(
        torch.from_numpy(a), torch.from_numpy(b), per_element=True,
        **_epilogue(bias, res, "relu", torch.from_numpy), **kw)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_bf16_matches_fused_ref(out_dtype):
    a, b, bias, res = _inputs((2,), 40, 72, 56, 6)
    ja, jb, jres = (jnp.asarray(x, jnp.bfloat16) for x in (a, b, res))
    ref = jax_fused_ref(ja, jb, bias=jnp.asarray(bias), activation="silu",
                        residual=jres,
                        out_dtype=jnp.float32 if out_dtype else None)
    to = lambda x: tensor_from_numpy(np.asarray(x))  # noqa: E731
    mine = sfc_matmul_batched(
        to(ja), to(jb), schedule="hilbert", bias=torch.from_numpy(bias),
        activation="silu", residual=to(jres),
        out_dtype=torch.float32 if out_dtype else None, **BLK)
    assert mine.dtype == (torch.float32 if out_dtype else torch.bfloat16)
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(ref, np.float32), **BF16)


@pytest.mark.parametrize("schedule", ["morton", "xla"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_dot_engine_dot_batched_matches_reference(schedule, epilogue):
    a, b, bias, res = _inputs((2, 2), 24, 40, 32, 7)
    kw = (lambda to: _epilogue(bias, res, "gelu", to)) if epilogue else \
        (lambda to: {})
    ref = JaxDotEngine(schedule=schedule, block=(16, 16, 16),
                       interpret=True).dot_batched(
        jnp.asarray(a), jnp.asarray(b), **kw(jnp.asarray))
    mine = DotEngine(schedule=schedule, block=(16, 16, 16)).dot_batched(
        torch.from_numpy(a), torch.from_numpy(b), **kw(torch.from_numpy))
    assert mine.shape == (2, 2, 24, 40)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


def test_auto_raises_and_cpu_calls_do_not_count(tmp_path, monkeypatch):
    """"auto" no longer raises: it resolves through the batched keyspace
    to the winner ``repro``'s tuner persisted in the shared cache file
    and agrees with the reference's output within the f32 bound.  CPU
    calls count no launch."""
    a, b, _, _ = _inputs((2,), 16, 16, 16, 8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    ref = jax_sfc_matmul_batched(jnp.asarray(a), jnp.asarray(b),
                                 schedule="auto")
    mine = sfc_matmul_batched(ta, tb, schedule="auto")
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)
    before = (sfc_mod.launches, sfc_mod.batched_launches)
    sfc_matmul_batched(ta, tb, **BLK)
    sfc_matmul_batched(ta, tb, per_element=True, **BLK)
    assert (sfc_mod.launches, sfc_mod.batched_launches) == before


def test_batched_wrapper_rejects_bad_operands():
    a = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="bad GEMM"):
        sfc_matmul_batched_cuda(a, torch.zeros(3, 8, 4))
    with pytest.raises(ValueError, match="bad GEMM"):
        sfc_matmul_batched_cuda(a[0], torch.zeros(8, 4))
    with pytest.raises(ValueError, match="residual shape"):
        sfc_matmul_batched_cuda(a, torch.zeros(2, 8, 4),
                                residual=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="empty GEMM"):
        sfc_matmul_batched_cuda(torch.zeros(0, 4, 8), torch.zeros(0, 8, 4))
    with pytest.raises(ValueError, match="bad batched GEMM"):
        sfc_matmul_batched(a, torch.zeros(3, 8, 4))
    with pytest.raises(ValueError, match="residual shape"):
        sfc_matmul_batched(a, torch.zeros(2, 8, 4),
                           residual=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="empty GEMM batch"):
        sfc_matmul_batched(torch.zeros(0, 4, 8), torch.zeros(0, 8, 4),
                           per_element=True)
