"""B1 and B3's tensor-core tile path on the card: ``sfc_matmul_cuda`` and
``sfc_matmul_batched_cuda`` with bf16 16-byte-vector operands off the rows
path (TMA and wgmma, tiles in curve order) against the plain version,
``sfc_matmul_plain``, on the same card.

Marked ``card``: every test skips without a CUDA card, decided when it
runs.  On the card: ``python3 -m pytest -q tests/test_torch_sfc_matmul_card.py``.
The file imports no JAX: the card's machine has none, and the plain
version is the yardstick here.

Bounds: bf16 outputs agree within atol = rtol = 2e-2 (one bf16 rounding
of outputs up to ~4 in magnitude, as the CPU tests of B1 and B3 bound
them; both sides take the same bf16 operands and sum in f32, in another
order); f32 outputs within atol = rtol = 1e-4 (f32 summation order over
K up to 13696 terms of unit size).  A batch element equals the one-GEMM
launch on it exactly, and two launches give the same bits."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import sfc_matmul as sfc_mod
from repro_torch.kernels.sfc_matmul import sfc_matmul_batched_cuda, \
    sfc_matmul_cuda, sfc_matmul_plain, tile_schedule

pytestmark = pytest.mark.card

BF16 = dict(rtol=2e-2, atol=2e-2)
F32 = dict(rtol=1e-4, atol=1e-4)

# glm4-9b's projections in a 512-row chunk step: (name, M, N, K)
DOCQA = [("wq_wo", 512, 4096, 4096), ("wk_wv", 512, 256, 4096),
         ("w1_w3", 512, 13696, 4096), ("w2", 512, 4096, 13696)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 -m "
                    "pytest tests/test_torch_sfc_matmul_card.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, lead, m, n, k, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(*lead, m, k, generator=g)
    b = torch.randn(*lead, k, n, generator=g) / np.sqrt(k)
    bias = torch.randn(n, generator=g)
    res = torch.randn(*lead, m, n, generator=g)
    return (a.to(dev, torch.bfloat16), b.to(dev, torch.bfloat16),
            bias.to(dev), res.to(dev, torch.bfloat16))


def _plain(a, b, *, schedule="morton", bm=128, bn=128, use_prefetch=True,
           g=0, **kw):
    sched = tile_schedule(schedule, -(-a.shape[0] // bm),
                          -(-b.shape[1] // bn), use_prefetch=use_prefetch,
                          g=g, device=a.device)
    return sfc_matmul_plain(a, b, sched=sched, bm=bm, bn=bn, bk=128, **kw)


def _close(mine, ref, tol):
    assert mine.dtype == ref.dtype
    torch.testing.assert_close(mine.float(), ref.float(), **tol)


@pytest.mark.parametrize("name,m,n,k", DOCQA, ids=[d[0] for d in DOCQA])
def test_docqa_chunk_shapes(dev, name, m, n, k):
    a, b, _, res = _inputs(dev, (), m, n, k, 1)
    before = sfc_mod.tile_tc_launches
    out = sfc_matmul_cuda(a, b, residual=res)
    assert sfc_mod.tile_tc_launches == before + 1
    _close(out, _plain(a, b, residual=res), BF16)


@pytest.mark.parametrize("m,n,k", [(300, 200, 136), (77, 1000, 520),
                                   (9, 264, 72), (513, 136, 4104),
                                   (130, 8, 8), (1, 64, 64)])
@pytest.mark.parametrize("bm,bn", [(128, 128), (64, 64), (128, 64),
                                   (64, 128), (96, 80), (16, 16)])
def test_ragged_shapes_and_tiles(dev, m, n, k, bm, bn):
    a, b, bias, res = _inputs(dev, (), m, n, k, 2)
    kw = dict(bm=bm, bn=bn, bias=bias, activation="silu", residual=res)
    out = sfc_matmul_cuda(a, b, **kw)
    _close(out, _plain(a, b, **kw), BF16)


@pytest.mark.parametrize("schedule,g,use_prefetch,mnk", [
    ("rowmajor", 0, True, (640, 384, 256)),
    ("colmajor", 0, True, (640, 384, 256)),
    ("boustrophedon", 0, True, (640, 384, 256)),
    ("morton", 0, True, (640, 384, 256)),
    ("hilbert", 0, True, (640, 384, 256)),
    ("peano", 0, True, (640, 384, 256)),
    ("supertile", 2, True, (640, 384, 256)),
    ("supertile", 3, True, (384, 1280, 192)),
    ("rowmajor", 0, False, (640, 384, 256)),
    ("colmajor", 0, False, (640, 384, 256)),
    ("morton", 0, False, (512, 512, 256)),
    ("hilbert", 0, False, (1024, 1000, 136)),
])
def test_schedules_by_table_and_closed_form(dev, schedule, g, use_prefetch,
                                            mnk):
    m, n, k = mnk
    a, b, _, _ = _inputs(dev, (), m, n, k, 3)
    kw = dict(schedule=schedule, g=g, use_prefetch=use_prefetch)
    out = sfc_matmul_cuda(a, b, **kw)
    _close(out, _plain(a, b, **kw), BF16)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("with_bias,with_res", [(True, True), (False, False),
                                                (True, False)])
def test_epilogue(dev, out_dtype, activation, with_bias, with_res):
    a, b, bias, res = _inputs(dev, (), 200, 392, 1032, 4)
    kw = dict(out_dtype=out_dtype, activation=activation,
              bias=bias if with_bias else None,
              residual=res.float() if with_res else None)
    out = sfc_matmul_cuda(a, b, **kw)
    _close(out, _plain(a, b, **kw),
           F32 if out_dtype == torch.float32 else BF16)


def test_launches_repeat_bit_for_bit(dev):
    a, b, bias, res = _inputs(dev, (), 512, 13696, 4096, 5)
    kw = dict(bias=bias, activation="gelu", residual=res)
    first = sfc_matmul_cuda(a, b, **kw)
    for _ in range(3):
        assert torch.equal(sfc_matmul_cuda(a, b, **kw), first)


def test_tc_counter_counts_bf16_tiles_only(dev):
    a, b, _, _ = _inputs(dev, (), 64, 256, 128, 6)
    before = sfc_mod.tile_tc_launches
    sfc_matmul_cuda(a, b)                          # bf16, M > 8: tensor cores
    sfc_matmul_batched_cuda(a[None], b[None])      # B3 too
    sfc_matmul_cuda(a[:4], b)                      # the rows path
    sfc_matmul_cuda(a.float(), b.float())          # f32: the SIMT loop
    assert sfc_mod.tile_tc_launches == before + 2


@pytest.mark.parametrize("m,n,k,bm,bn", [(512, 4096, 4096, 128, 128),
                                         (300, 200, 136, 128, 128),
                                         (77, 264, 520, 64, 64),
                                         (130, 392, 72, 96, 80)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=str)
def test_batched_elements_equal_one_gemm(dev, m, n, k, bm, bn, out_dtype):
    a, b, bias, res = _inputs(dev, (3,), m, n, k, 7)
    kw = dict(bm=bm, bn=bn, out_dtype=out_dtype, bias=bias,
              activation="relu")
    before = sfc_mod.tile_tc_launches
    out = sfc_matmul_batched_cuda(a, b, residual=res, **kw)
    assert sfc_mod.tile_tc_launches == before + 1
    for i in range(3):
        one = sfc_matmul_cuda(a[i], b[i], residual=res[i], **kw)
        assert torch.equal(out[i], one)
    _close(out[1], _plain(a[1], b[1], residual=res[1], **kw),
           F32 if out_dtype == torch.float32 else BF16)
