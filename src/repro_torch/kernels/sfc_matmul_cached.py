"""SFC-ordered GEMM through a software block cache that counts its own
block fetches (B4): the wrapper of the CUDA kernel
``csrc/sfc_matmul_cached.cu`` (port of
``repro.kernels.sfc_matmul_cached.sfc_matmul_cached``) and its plain
version.

``C = A @ B`` with the output tiles visited in schedule order, k
innermost, through an ``nslots``-way direct-mapped block cache per
operand: block A(i, k) has id ``i*kt + k``, block B(k, j) has id
``j*kt + k``, and lives in slot ``id % nslots``.  Every tag miss is one
block fetched from device memory; the result is ``(C, counts)`` with
``counts = [A fetches, B fetches]`` (int32, on C's device).  The counts
are those of one sequential walk, so the kernel is one persistent
thread block (one SM of the H100) with its slots in shared memory: a
producer warp walks the schedule 32 steps at a time, keeps the tags,
counts the misses and starts each missing block's copy (TMA) ahead of
consumer warps that compute on them, through a ring of ``RING`` steps.
The slots and the walk's bookkeeping must fit the block's 232,448
bytes, and the wrapper raises rather than shrink the cache.

On a CPU tensor the wrapper runs :func:`sfc_matmul_cached_plain`: C from
the SFC GEMM's plain version (the same tile walk, f32 over bk-deep k
blocks) and the counts from :func:`dma_counts`, a vectorised
direct-mapped oracle with the kernel's slot mapping.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.sfc_matmul import _DTYPE_CODE, _device_table, \
    sfc_matmul_plain, tile_schedule
from repro_torch.kernels.sfc_matmul import _SMEM_LIMIT as SMEM_LIMIT

__all__ = ["sfc_matmul_cached", "sfc_matmul_cached_plain", "dma_counts",
           "shared_bytes", "SMEM_LIMIT", "RING", "launches"]

# kernel launches made by sfc_matmul_cached (CPU calls are not counted)
launches = 0
launch_counts.register(__name__, "launches")

_MAX_TILE = 256 * 64  # bm * bn: 256 consumer threads x 64 f32 accumulators
RING = 128            # the kernel's kRing: ring entries (steps in flight)
_RING_BYTES = RING * (16 + 2 * 8)  # per entry: a 16-byte step, two mbarriers
_SIGNATURES = {"sfc_matmul_cached_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    ctypes.c_int)}


def shared_bytes(bm: int, bn: int, bk: int, nslots: int,
                 itemsize: int) -> int:
    """Shared memory the kernel needs: ``nslots`` A slots (bm x bk) and B
    slots (bk x bn), padded to 16 bytes; the ring (``RING`` entries of one
    16-byte step and two 8-byte mbarriers); then four int32 per slot (the
    tag and the last step that used it, for A and for B)."""
    slots = nslots * (bm * bk + bk * bn) * itemsize
    return -(-slots // 16) * 16 + _RING_BYTES + 4 * 4 * nslots


def _misses(ids: torch.Tensor, nslots: int) -> torch.Tensor:
    """Misses of a direct-mapped cache over the flat id sequence: sort
    stably by slot, then an entry misses unless its predecessor in the
    same slot carries the same id (every slot starts empty)."""
    slot = ids % nslots
    order = torch.sort(slot, stable=True).indices
    s_ids, s_slot = ids[order], slot[order]
    miss = torch.ones_like(s_ids, dtype=torch.bool)
    miss[1:] = (s_slot[1:] != s_slot[:-1]) | (s_ids[1:] != s_ids[:-1])
    return miss.sum()


def dma_counts(sched: torch.Tensor, kt: int, nslots: int) -> torch.Tensor:
    """[A fetches, B fetches] (int32) of the walk of ``sched`` (T, 2), k
    innermost, through ``nslots``-slot caches with the kernel's ids."""
    k = torch.arange(kt, device=sched.device)
    i = sched[:, 0].long()[:, None]
    j = sched[:, 1].long()[:, None]
    return torch.stack([_misses((i * kt + k).reshape(-1), nslots),
                        _misses((j * kt + k).reshape(-1), nslots)]).int()


def sfc_matmul_cached_plain(a, b, *, sched: torch.Tensor, bm: int, bn: int,
                            bk: int, nslots: int, out_dtype=None):
    """The kernel's function in plain PyTorch: ``(C, counts)``."""
    c = sfc_matmul_plain(a, b, sched=sched, bm=bm, bn=bn, bk=bk,
                         out_dtype=out_dtype or a.dtype)
    return c, dma_counts(sched, a.shape[1] // bk, nslots)


def sfc_matmul_cached(a: torch.Tensor, b: torch.Tensor, *,
                      schedule: str = "morton", bm: int = 128, bn: int = 128,
                      bk: int = 128, nslots: int = 8, out_dtype=None):
    """C = A @ B through an ``nslots``-way software block cache per
    operand; returns ``(C, counts)``, counts = [A fetches, B fetches].

    a (M, K) and b (K, N) share a float32 or bfloat16 dtype and divide
    by the blocks; ``out_dtype`` defaults to ``a.dtype``.  CUDA tensors
    launch the kernel (or raise: the default 128^3 blocks with 8 slots
    need more shared memory than a block has); CPU tensors run
    :func:`sfc_matmul_cached_plain`; other devices raise."""
    global launches
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) <= 0 or m % bm or n % bn or k % bk:
        raise ValueError(f"shapes ({m}, {n}, {k}) must be positive "
                         f"multiples of the blocks ({bm}, {bn}, {bk})")
    if nslots <= 0:
        raise ValueError(f"nslots must be positive, got {nslots}")
    out_dtype = out_dtype or a.dtype
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE or \
            out_dtype not in _DTYPE_CODE:
        raise TypeError(f"operands must share a float32/bfloat16 dtype and "
                        f"out_dtype be one, got {a.dtype}, {b.dtype} -> "
                        f"{out_dtype}")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    mt, nt = m // bm, n // bn
    if a.device.type == "cpu":
        sched = tile_schedule(schedule, mt, nt, use_prefetch=True)
        return sfc_matmul_cached_plain(a, b, sched=sched, bm=bm, bn=bn,
                                       bk=bk, nslots=nslots,
                                       out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"sfc_matmul_cached runs on cuda (or the plain "
                         f"version on cpu), got {a.device}")
    need = shared_bytes(bm, bn, bk, nslots, a.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{nslots} slots of {bm}x{bk} + {bk}x{bn} {a.dtype} blocks and "
            f"their tags need {need} bytes of shared memory; one thread "
            f"block of the H100 has {SMEM_LIMIT} (227 KB)")
    if bm * bn > _MAX_TILE:
        raise ValueError(f"the kernel takes bm*bn <= {_MAX_TILE}, got "
                         f"{bm}x{bn}")
    if mt * nt * (k // bk) >= 2 ** 30:
        raise ValueError(f"the walk's {mt * nt * (k // bk)} steps must be "
                         f"fewer than 2^30")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    sched_t = _device_table(schedule, mt, nt, 0, a.device)
    vec_el = 16 // a.element_size()
    vec = int(k % vec_el == 0 and n % vec_el == 0 and bk % vec_el == 0
              and bn % vec_el == 0 and a.data_ptr() % 16 == 0
              and b.data_ptr() % 16 == 0)
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    counts = torch.empty(2, dtype=torch.int32, device=a.device)
    lib = _build.load("sfc_matmul_cached", _SIGNATURES)
    err = lib.sfc_matmul_cached_launch(
        a.data_ptr(), b.data_ptr(), sched_t.data_ptr(), out.data_ptr(),
        counts.data_ptr(), m, n, k, bm, bn, bk, nslots,
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], vec,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sfc_matmul_cached kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out, counts
