"""The ``schedule="xla"`` library baseline (``ops.library_matmul``).

On a CUDA tensor with bf16 operands it is one bf16 GEMM with f32 output
(``torch.mm`` / ``torch.bmm`` with ``out_dtype``), then the f32
epilogue: the reference's ``jnp.dot(..., preferred_element_type=f32)``.
That branch runs only on the card (``chip_smoke.py``'s tuner phase holds
it to the plain version there).  On the CPU the baseline is
``matmul_fused_ref`` itself, bit for bit, as it was; the probe for the
``out_dtype`` overloads raises exactly where torch has no CUDA kernel
for them."""
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_fused_ref


def _inputs(lead, m, k, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(*lead, m, k, generator=g).to(dtype)
    b = torch.randn(*lead, k, n, generator=g).to(dtype)
    res = torch.randn(*lead, m, n, generator=g).to(dtype)
    bias = torch.randn(n, generator=g).to(dtype)
    return a, b, res, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)], ids=["2d", "b3", "b22"])
@pytest.mark.parametrize("epilogue", ["none", "residual", "silu_bias"])
def test_cpu_baseline_is_matmul_fused_ref(dtype, lead, epilogue):
    a, b, res, bias = _inputs(lead, 5, 24, 12, dtype)
    kw = {"none": {}, "residual": {"residual": res},
          "silu_bias": {"activation": "silu", "bias": bias}}[epilogue]
    want = matmul_fused_ref(a, b, **kw)
    got = ops.library_matmul(a, b, **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    via = (ops.sfc_matmul_batched if lead else ops.sfc_matmul)(
        a, b, schedule="xla", **kw)
    assert torch.equal(via, want)
    f32 = ops.library_matmul(a, b, out_dtype=torch.float32, **kw)
    assert f32.dtype == torch.float32
    assert torch.equal(f32, matmul_fused_ref(a, b, out_dtype=torch.float32,
                                             **kw))


def test_out_dtype_probe_raises_only_without_the_cuda_kernels():
    have = all(torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
               for op in ("aten::mm.dtype", "aten::bmm.dtype"))
    ops._check_mm_out_dtype.cache_clear()
    try:
        if have:
            ops._check_mm_out_dtype()
        else:
            with pytest.raises(RuntimeError, match="no CUDA kernel"):
                ops._check_mm_out_dtype()
    finally:
        ops._check_mm_out_dtype.cache_clear()


def test_meta_bf16_shapes_of_the_out_dtype_overloads():
    """The overloads the CUDA branch calls take bf16 operands and give
    f32 (checked on the meta device: shapes and dtypes only)."""
    a = torch.empty(4, 64, dtype=torch.bfloat16, device="meta")
    b = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    out = torch.mm(a, b, out_dtype=torch.float32)
    assert out.shape == (4, 32) and out.dtype == torch.float32
    out = torch.bmm(a[None].expand(3, 4, 64), b[None].expand(3, 64, 32),
                    out_dtype=torch.float32)
    assert out.shape == (3, 4, 32) and out.dtype == torch.float32
