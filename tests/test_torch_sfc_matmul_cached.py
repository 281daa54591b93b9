"""Port parity for kernel B4 (the software-cached SFC GEMM):
``repro_torch``'s ``sfc_matmul_cached`` on CPU tensors (the plain
version of the CUDA kernel: C from the same tile walk in f32, the fetch
counts from a vectorised direct-mapped oracle with the kernel's slot
mapping) against ``repro``'s ``sfc_matmul_cached`` run in interpret mode.

Bounds: C agrees within atol = rtol = 1e-5 (f32 summation order only).
The fetch counts are equal exactly: to the reference kernel's own
counter, to a loop over the reference's walk with the kernel's slot
mapping (the reference's ``_expected_dma``), and, at the paper-size
(n = 1024) settings, to the table ``B4_COUNTS`` that ``chip_smoke.py``
holds the CUDA kernel to.
They are not held against ``core.locality.simulate_direct``, which
keys its sets by a per-process string hash."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.schedule import grid_schedule
from repro.kernels.sfc_matmul_cached import \
    sfc_matmul_cached as jax_sfc_matmul_cached
from repro_torch.kernels import sfc_matmul_cached as cached_mod
from repro_torch.kernels.sfc_matmul import tile_schedule
from repro_torch.kernels.sfc_matmul_cached import RING, SMEM_LIMIT, \
    dma_counts, sfc_matmul_cached, shared_bytes

F32 = dict(rtol=1e-5, atol=1e-5)
BLK = dict(bm=16, bn=16, bk=16)


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, loaded as a module (it
    imports only the standard library at module level)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


B4_COUNTS = _chip_smoke().B4_COUNTS


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _expected_dma(schedule, mt, nt, kt, nslots):
    """Direct-mapped loop oracle with the kernel's slot mapping, over the
    reference's schedule."""
    a_tags = [-1] * nslots
    b_tags = [-1] * nslots
    a_cnt = b_cnt = 0
    for (i, j) in grid_schedule(schedule, mt, nt):
        for k in range(kt):
            a_id = int(i) * kt + k
            if a_tags[a_id % nslots] != a_id:
                a_tags[a_id % nslots] = a_id
                a_cnt += 1
            b_id = int(j) * kt + k
            if b_tags[b_id % nslots] != b_id:
                b_tags[b_id % nslots] = b_id
                b_cnt += 1
    return a_cnt, b_cnt


@pytest.mark.parametrize("schedule", ["rowmajor", "morton", "hilbert"])
def test_output_matches_reference_kernel(schedule):
    a, b = _rand((64, 64), 0), _rand((64, 64), 1)
    ref, _ = jax_sfc_matmul_cached(jnp.asarray(a), jnp.asarray(b),
                                   schedule=schedule, nslots=8,
                                   interpret=True, **BLK)
    out, _ = sfc_matmul_cached(torch.from_numpy(a), torch.from_numpy(b),
                               schedule=schedule, nslots=8, **BLK)
    assert out.dtype == torch.float32 and out.shape == (64, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(out.numpy(), a @ b, **F32)


@pytest.mark.parametrize("schedule", ["rowmajor", "morton", "hilbert"])
@pytest.mark.parametrize("nslots", [1, 2, 4, 16])
def test_counts_match_reference_kernel_and_loop_oracle(schedule, nslots):
    a, b = _rand((64, 64), 2), _rand((64, 64), 3)
    _, ref = jax_sfc_matmul_cached(jnp.asarray(a), jnp.asarray(b),
                                   schedule=schedule, nslots=nslots,
                                   interpret=True, **BLK)
    _, counts = sfc_matmul_cached(torch.from_numpy(a), torch.from_numpy(b),
                                  schedule=schedule, nslots=nslots, **BLK)
    assert counts.dtype == torch.int32
    assert tuple(counts.tolist()) == tuple(int(x) for x in np.asarray(ref))
    assert tuple(counts.tolist()) == _expected_dma(schedule, 4, 4, 4, nslots)


@pytest.mark.parametrize("schedule", ["rowmajor", "morton", "hilbert",
                                      "boustrophedon", "peano"])
@pytest.mark.parametrize("grid,kt,nslots", [((8, 8), 8, 12), ((6, 10), 5, 7),
                                            ((16, 16), 16, 32)])
def test_vectorised_oracle_equals_loop(schedule, grid, kt, nslots):
    mt, nt = grid
    sched = tile_schedule(schedule, mt, nt, use_prefetch=True)
    assert tuple(dma_counts(sched, kt, nslots).tolist()) == \
        _expected_dma(schedule, mt, nt, kt, nslots)


def test_curves_fetch_less_with_a_multi_slot_cache():
    """The reference's claim test: with 32 slots, Morton fetches fewer
    blocks than row-major, and Hilbert at most 1.05x Morton."""
    a, b = torch.from_numpy(_rand((128, 128), 4)), \
        torch.from_numpy(_rand((128, 128), 5))
    total = {}
    for s in ("rowmajor", "morton", "hilbert"):
        _, counts = sfc_matmul_cached(a, b, schedule=s, nslots=32, **BLK)
        total[s] = int(counts.sum())
    assert total["morton"] < total["rowmajor"], total
    assert total["hilbert"] <= total["morton"] * 1.05, total


@pytest.mark.parametrize("setting", sorted(B4_COUNTS))
def test_paper_size_counts(setting):
    """The counts of the n = 1024 settings (C at that size is the card's
    work): the port's oracle, the reference's loop and chip_smoke.py's
    table agree for every schedule."""
    blk, nslots = setting
    t = 1024 // blk
    for schedule, want in B4_COUNTS[setting].items():
        sched = tile_schedule(schedule, t, t, use_prefetch=True)
        counts = tuple(dma_counts(sched, t, nslots).tolist())
        assert counts == _expected_dma(schedule, t, t, t, nslots) == want, \
            schedule


def test_shared_memory_limit():
    """The paper-size settings fit one block's shared memory; the
    reference's defaults (128^3 blocks, 8 slots) do not, in f32 or bf16.
    Layout: the slots, the ring (128 entries of a 16-byte step and two
    8-byte mbarriers: 4096 bytes), then four int32 per slot (tags and
    last use of A and B)."""
    assert RING == 128
    assert shared_bytes(16, 16, 16, 16, 4) == 32768 + 4096 + 256
    assert shared_bytes(16, 16, 16, 64, 4) == 131072 + 4096 + 1024
    assert shared_bytes(8, 8, 8, 256, 4) == 131072 + 4096 + 4096
    assert shared_bytes(128, 128, 128, 8, 4) == 1048576 + 4096 + 128
    assert shared_bytes(128, 128, 128, 8, 2) == 524288 + 4096 + 128
    for blk, nslots in B4_COUNTS:
        assert shared_bytes(blk, blk, blk, nslots, 4) <= SMEM_LIMIT
    assert shared_bytes(128, 128, 128, 8, 2) > SMEM_LIMIT
    assert SMEM_LIMIT == 232448


def test_defaults_run_on_cpu_and_raise_on_other_devices():
    a = torch.from_numpy(_rand((128, 128), 6))
    out, counts = sfc_matmul_cached(a, a)
    np.testing.assert_allclose(out.numpy(), (a @ a).numpy(), **F32)
    assert counts.tolist() == [1, 1]
    meta = torch.zeros(128, 128, device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        sfc_matmul_cached(meta, meta)


def test_wrapper_rejects_bad_operands():
    a = torch.zeros(64, 48)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        sfc_matmul_cached(a, torch.zeros(48, 64), bm=16, bn=16, bk=32)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        sfc_matmul_cached(torch.zeros(60, 48), torch.zeros(48, 64), **BLK)
    with pytest.raises(ValueError, match="bad GEMM"):
        sfc_matmul_cached(a, torch.zeros(64, 64), **BLK)
    with pytest.raises(ValueError, match="nslots"):
        sfc_matmul_cached(a, torch.zeros(48, 64), nslots=0, **BLK)
    with pytest.raises(TypeError, match="dtype"):
        sfc_matmul_cached(a, torch.zeros(48, 64, dtype=torch.bfloat16),
                          **BLK)


def test_cpu_calls_do_not_count_as_launches():
    before = cached_mod.launches
    a = torch.from_numpy(_rand((32, 32), 7))
    sfc_matmul_cached(a, a, **BLK)
    assert cached_mod.launches == before
