"""Port parity for kernel B1 (the SFC GEMM): ``repro_torch``'s
``ops.sfc_matmul`` on CPU tensors (the plain version of the CUDA
kernel: same tile order, same bk-deep f32 k blocks, same epilogue)
against ``repro``'s Pallas kernel run in interpret mode, and against
``matmul_fused_ref`` at bf16.

Bounds: f32 outputs agree within atol = rtol = 1e-5 (f32 summation
order only: the Pallas interpreter and torch add the bk-wide partial
products in different orders).  bf16 outputs agree within atol = rtol =
2e-2 (one bf16 rounding of the output, 2**-8 relative, on values of
magnitude up to ~4, as tests/test_kernels.py bounds the reference)."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.ops import sfc_matmul as jax_sfc_matmul
from repro.kernels.ref import matmul_fused_ref as jax_matmul_fused_ref
from repro.kernels.sfc_matmul import sfc_matmul_pallas
from repro_torch.kernels import sfc_matmul as sfc_mod
from repro_torch.kernels.ops import sfc_matmul
from repro_torch.models.convert import tensor_from_numpy

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BLK = dict(bm=16, bn=16, bk=16)


def _inputs(m, n, k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    return a, b, bias, res


def _both(x, jdtype=jnp.float32, tdtype=torch.float32):
    return jnp.asarray(x, jdtype), torch.from_numpy(x).to(tdtype)


@pytest.mark.parametrize("schedule", ["rowmajor", "morton", "hilbert"])
@pytest.mark.parametrize("use_prefetch", [True, False])
def test_schedules_match_pallas_interpret(schedule, use_prefetch):
    a, b, _, _ = _inputs(64, 64, 48, 0)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    ref = sfc_matmul_pallas(ja, jb, schedule=schedule,
                            use_prefetch=use_prefetch, interpret=True, **BLK)
    mine = sfc_matmul(ta, tb, schedule=schedule, use_prefetch=use_prefetch,
                      **BLK)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("schedule,g", [("colmajor", 0),
                                        ("boustrophedon", 0), ("peano", 0),
                                        ("supertile", 2), ("supertile", 3)])
def test_table_schedules_on_non_square_grids(schedule, g):
    a, b, _, _ = _inputs(48, 80, 32, 1)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    ref = sfc_matmul_pallas(ja, jb, schedule=schedule, g=g, interpret=True,
                            **BLK)
    mine = sfc_matmul(ta, tb, schedule=schedule, g=g, **BLK)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
def test_fused_epilogue_matches_pallas_interpret(activation):
    a, b, bias, res = _inputs(32, 48, 32, 2)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    (jbias, tbias), (jres, tres) = _both(bias), _both(res)
    ref = sfc_matmul_pallas(ja, jb, schedule="morton", interpret=True,
                            bias=jbias, activation=activation, residual=jres,
                            **BLK)
    mine = sfc_matmul(ta, tb, schedule="morton", bias=tbias,
                      activation=activation, residual=tres, **BLK)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("mnk", [(100, 36, 52), (8, 8, 8), (4, 48, 40)])
def test_ragged_shapes_match_padded_pallas(mnk):
    """The port masks ragged edges where the reference pads and crops:
    the tile grid is the one the reference builds for the padded shape."""
    m, n, k = mnk
    a, b, bias, res = _inputs(m, n, k, 3)
    (ja, ta), (jb, tb) = _both(a), _both(b)
    (jbias, tbias), (jres, tres) = _both(bias), _both(res)
    ref = jax_sfc_matmul(ja, jb, schedule="hilbert", interpret=True,
                         force_pallas=True, bias=jbias, activation="gelu",
                         residual=jres, **BLK)
    mine = sfc_matmul(ta, tb, schedule="hilbert", bias=tbias,
                      activation="gelu", residual=tres, **BLK)
    assert mine.shape == (m, n)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_bf16_matches_fused_ref(out_dtype):
    a, b, bias, res = _inputs(40, 72, 56, 4)
    ja = jnp.asarray(a, jnp.bfloat16)
    jb = jnp.asarray(b, jnp.bfloat16)
    jres = jnp.asarray(res, jnp.bfloat16)
    jout = jnp.float32 if out_dtype else None
    ref = jax_matmul_fused_ref(ja, jb, activation="silu", residual=jres,
                               out_dtype=jout)
    to = lambda x: tensor_from_numpy(np.asarray(x))  # noqa: E731
    mine = sfc_matmul(to(ja), to(jb), schedule="morton", activation="silu",
                      residual=to(jres),
                      out_dtype=torch.float32 if out_dtype else None, **BLK)
    assert mine.dtype == (torch.float32 if out_dtype else torch.bfloat16)
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(ref, np.float32), **BF16)


def test_xla_schedule_is_the_fused_reference_and_auto_raises(tmp_path,
                                                             monkeypatch):
    """"xla" is the fused library reference.  "auto" no longer raises: on
    the CPU it resolves to the winner ``repro``'s tuner persisted for
    this (shape bucket, epilogue) in the shared cache file, and the
    output equals the reference's ``schedule="auto"`` within the f32
    bound."""
    from repro.tune import resolve_config as jax_resolve_config
    from repro.tune.cost import EpilogueSpec as JaxEpilogueSpec
    from repro_torch.tune import EpilogueSpec, resolve_config

    a, b, bias, _ = _inputs(24, 40, 16, 5)
    ta, tb, tbias = (torch.from_numpy(x) for x in (a, b, bias))
    ref = jax_matmul_fused_ref(jnp.asarray(a), jnp.asarray(b),
                               bias=jnp.asarray(bias), activation="relu")
    mine = sfc_matmul(ta, tb, schedule="xla", bias=tbias, activation="relu")
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    a, b, _, res = _inputs(128, 256, 64, 6)
    ref = jax_sfc_matmul(jnp.asarray(a), jnp.asarray(b), schedule="auto",
                         residual=jnp.asarray(res))
    mine = sfc_matmul(torch.from_numpy(a), torch.from_numpy(b),
                      schedule="auto", residual=torch.from_numpy(res))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)
    want = jax_resolve_config(128, 256, 64, "float32",
                              epilogue=JaxEpilogueSpec(residual=True))
    got = resolve_config(128, 256, 64, torch.float32, backend="cpu",
                         epilogue=EpilogueSpec(residual=True))
    assert got.to_dict() == want.to_dict()
    assert got.schedule != "xla"   # a fused epilogue: the kernel wins


@pytest.mark.parametrize("epilogue", [False, True])
def test_dot_engine_xla_matches_reference_engine(epilogue):
    """DotEngine(schedule="xla") reaches the one library baseline in
    ops.sfc_matmul; it agrees with the reference's xla engine on a
    batched (B, S, d) input, with and without the fused epilogue."""
    from repro.models.layers import DotEngine as JaxDotEngine
    from repro_torch.models.layers import DotEngine

    a, b, bias, res = _inputs(6, 24, 40, 8)
    x = a.reshape(2, 3, 40)
    kw = dict(bias=bias, activation="gelu", residual=res.reshape(2, 3, 24)) \
        if epilogue else {}
    ref = JaxDotEngine(schedule="xla").dot(
        jnp.asarray(x), jnp.asarray(b),
        **{k: jnp.asarray(v) if k != "activation" else v
           for k, v in kw.items()})
    mine = DotEngine(schedule="xla").dot(
        torch.from_numpy(x), torch.from_numpy(b),
        **{k: torch.from_numpy(v) if k != "activation" else v
           for k, v in kw.items()})
    assert mine.shape == (2, 3, 24)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32)


def test_cpu_calls_do_not_count_as_launches():
    before = sfc_mod.launches
    a, b, _, _ = _inputs(16, 16, 16, 6)
    sfc_matmul(torch.from_numpy(a), torch.from_numpy(b), **BLK)
    assert sfc_mod.launches == before


def test_wrapper_rejects_bad_operands():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="bad GEMM"):
        sfc_matmul(a, torch.zeros(4, 8))
    with pytest.raises(TypeError, match="share"):
        sfc_matmul(a, torch.zeros(8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bias shape"):
        sfc_matmul(a, torch.zeros(8, 4), bias=torch.zeros(5))
    with pytest.raises(ValueError, match="unknown activation"):
        sfc_matmul(a, torch.zeros(8, 4), activation="tanh")
