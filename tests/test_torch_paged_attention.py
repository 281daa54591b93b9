"""Port parity for kernel B2 (paged decode attention): the plain version
that ``repro_torch``'s wrapper runs on CPU tensors, against ``repro``'s
Pallas kernel in interpret mode and against its gather reference.

Bounds: f32 agrees within atol = 2e-6, rtol = 0 with both (summation
order and the Pallas kernel's online rescaling versus one direct
softmax; outputs are O(1)).  At bf16 the port follows the reference's
rounding points (scores in the cache dtype, weights cast to it before
P.V), so it agrees with the reference within one bf16 rounding of the
output: atol = rtol = 1e-2."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.paged_attention import paged_decode_attention_pallas
from repro.kernels.ref import paged_decode_attention_ref as jax_ref
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.models.convert import tensor_from_numpy

F32 = dict(rtol=0, atol=2e-6)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _case(ps, seed, *, b=3, h=4, hkv=2, dh=16, maxp=4, rows=13):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((rows, ps, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((rows, ps, hkv, dh)).astype(np.float32)
    kp[-1] = 0                                 # reserved zero row
    vp[-1] = 0
    tab = rng.integers(0, rows - 1, size=(b, maxp)).astype(np.int32)
    tab[1, 2:] = rows - 1                      # unallocated tail -> zero row
    return q, kp, vp, tab


def _positions(ps, maxp, b):
    span = ps * maxp
    scalars = [0, ps - 1, ps, span // 2 + 1, span - 1]
    vectors = [np.asarray([0, ps + 1, span - 1][:b], np.int32),
               np.asarray([span - 1, 1, ps * 2][:b], np.int32)]
    return scalars + vectors


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_plain_matches_pallas_interpret_and_ref_f32(ps):
    q, kp, vp, tab = _case(ps, ps)
    jq, jk, jv, jt = (jnp.asarray(x) for x in (q, kp, vp, tab))
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, kp, vp, tab))
    for pos in _positions(ps, tab.shape[1], q.shape[0]):
        jpos = jnp.asarray(pos, jnp.int32)
        ker = paged_decode_attention_pallas(jq, jk, jv, jt, jpos,
                                            interpret=True)
        ref = jax_ref(jq, jk, jv, jt, jpos)
        mine = paged_decode_attention_cuda(tq, tk, tv, tt,
                                           torch.as_tensor(pos))
        assert mine.shape == q.shape and mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(ker), **F32,
                                   err_msg=f"pos={pos}")
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32,
                                   err_msg=f"pos={pos}")


@pytest.mark.parametrize("ps", [4, 16])
def test_plain_matches_ref_bf16(ps):
    q, kp, vp, tab = _case(ps, 10 + ps, h=8, hkv=2)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp))
    jt = jnp.asarray(tab)
    tq, tk, tv = (tensor_from_numpy(np.asarray(x)) for x in (jq, jk, jv))
    for pos in _positions(ps, tab.shape[1], q.shape[0]):
        ref = jax_ref(jq, jk, jv, jt, jnp.asarray(pos, jnp.int32))
        mine = paged_decode_attention_cuda(tq, tk, tv, torch.from_numpy(tab),
                                           pos)
        assert mine.dtype == torch.bfloat16
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(ref, np.float32), **BF16)


def test_all_zero_row_table_gives_zero_output():
    """A table of zero-row entries behaves like a contiguous cache of
    never-written (zero) rows: uniform weights over zero values."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    kp = torch.zeros(5, 4, 2, 8)
    tab = torch.full((2, 3), 4, dtype=torch.int32)
    out = paged_decode_attention_cuda(q, kp, kp.clone(), tab, 5)
    assert torch.equal(out, torch.zeros_like(out))


def test_cpu_calls_do_not_count_and_bad_shapes_raise():
    q, kp, vp, tab = (torch.from_numpy(x) for x in _case(4, 2))
    before = pa_mod.launches
    paged_decode_attention_cuda(q, kp, vp, tab, 3)
    assert pa_mod.launches == before
    with pytest.raises(ValueError, match="does not fit"):
        paged_decode_attention_cuda(q[..., :8], kp, vp, tab, 3)
    with pytest.raises(ValueError, match="phys_tables"):
        paged_decode_attention_cuda(q, kp, vp, tab[:2], 3)
