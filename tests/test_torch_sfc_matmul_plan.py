"""The rows path's split plan (``repro_torch.kernels.sfc_matmul``): how
many blocks of a thread-block cluster share one 128-column output tile
of a decode-width GEMM, and which K range each sums.  Pure host
functions, held here with the H100's 132 SMs passed in; the kernel
that runs the plan is checked on the card by ``chip_smoke.py``.
"""
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels.sfc_matmul import launch_plan, split_plan, \
    split_ranges

SMS = 132  # NVIDIA H100 SXM

# (name, M, K, N, split, blocks) of every B1 launch of a qwen3-1.7b
# decode step with 4 slots
QWEN3_1_7B = [("wq", 4, 2048, 2048, 8, 128),
              ("wk|wv", 4, 2048, 1024, 8, 64),
              ("wo", 4, 2048, 2048, 8, 128),
              ("w1", 4, 2048, 6144, 4, 192),
              ("w3", 4, 2048, 6144, 4, 192),
              ("w2", 4, 6144, 2048, 8, 128),
              ("head", 4, 2048, 151936, 1, 1187)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name,m,k,n,split,blocks", QWEN3_1_7B,
                         ids=[g[0] for g in QWEN3_1_7B])
def test_qwen3_shapes_get_the_planned_split(name, m, k, n, split, blocks,
                                            dtype):
    s = split_plan(m, n, k, 128, dtype, SMS)
    assert s == split
    assert -(-n // 128) * s == blocks


@pytest.mark.parametrize("batch", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 6144, 2048),
                                   (6, 1024, 512), (4, 2048, 151936 // 16),
                                   (64, 256, 256)])
def test_batched_plan_is_the_one_gemm_plan(m, k, n, dtype, batch):
    """B3 launches each element with the split B1 gives that element,
    whatever the batch."""
    a = torch.zeros((), dtype=dtype).expand(batch, m, k)  # shapes only
    b = torch.zeros((), dtype=dtype).expand(batch, k, n)
    one = launch_plan(a[0], b[0], bk=128, bn=128, sms=SMS)
    assert launch_plan(a, b, bk=128, bn=128, sms=SMS) == one
    assert one == (1, split_plan(m, n, k, 128, dtype, SMS))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m", [1, 4, 5, 8])
@pytest.mark.parametrize("k", [8, 64, 200, 520, 1000, 2048, 2056, 6144,
                               8192, 12344])
def test_split_ranges_cover_k(m, k, dtype):
    """Every planned split gives non-empty, contiguous ranges covering
    [0, K), each starting and ending on a 16-byte vector."""
    vec_el = 16 // dtype.itemsize
    assert k % vec_el == 0
    planned = {split_plan(m, n, k, 128, dtype, SMS) for n in (128, 1024,
                                                             8192, 65536)}
    for s in planned:
        ranges = split_ranges(k, s, dtype.itemsize)
        assert len(ranges) == s
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(k, k)]):
            assert lo < hi == nxt
            assert lo % vec_el == 0 and hi % vec_el == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m", [9, 16, 64, 100, 1024])
@pytest.mark.parametrize("k,n", [(2048, 2048), (256, 128), (6144, 151936)])
def test_more_than_eight_rows_never_split(m, k, n, dtype):
    assert split_plan(m, n, k, 128, dtype, SMS) == 1


@pytest.mark.parametrize("m,k,n,bn", [(4, 2048, 2048, 64),   # bn != 128
                                      (4, 2048, 2044, 128),  # N % 8
                                      (4, 2046, 2048, 128),  # K not vectors
                                      (4, 96, 128, 128)])    # too shallow
def test_off_the_rows_path_or_too_shallow_no_split(m, k, n, bn):
    assert split_plan(m, n, k, bn, torch.bfloat16, SMS) == 1


def test_split_fills_the_card_and_stops_at_eight():
    # nt * s reaches the SM count: 48 tiles -> 4, 132 tiles -> 1
    assert split_plan(4, 48 * 128, 4096, 128, torch.bfloat16, SMS) == 4
    assert split_plan(4, 132 * 128, 4096, 128, torch.bfloat16, SMS) == 1
    # never past the portable cluster size, however few tiles
    assert split_plan(4, 128, 1 << 16, 128, torch.bfloat16, SMS) == 8
    # fewer SMs need less split
    assert split_plan(4, 2048, 2048, 128, torch.bfloat16, 32) == 2


def test_unaligned_operands_take_no_split():
    """vec needs 16-byte aligned pointers; without it the tile path runs
    and the split is 1."""
    a = torch.zeros(4 * 2048 + 1, dtype=torch.bfloat16)[1:].view(4, 2048)
    b = torch.zeros(2048, 2048, dtype=torch.bfloat16)
    assert launch_plan(a, b, bk=128, bn=128, sms=SMS) == (0, 1)
