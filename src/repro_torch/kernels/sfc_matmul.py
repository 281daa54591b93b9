"""SFC-ordered blocked GEMM with a fused epilogue, one GEMM (B1) or a
batch of them (B3): the wrappers of the CUDA kernels in
``csrc/sfc_matmul.cu`` (ports of ``repro.kernels.sfc_matmul.
sfc_matmul_pallas`` and ``sfc_matmul_batched_pallas``) and their plain
version.

The output tile grid of ``C = act(A @ B + bias) + residual`` is
``ceil(M/bm) x ceil(N/bn)``, the grid the reference builds for the
padded shape, visited in the order of a space-filling curve:

* ``use_prefetch=True`` (the default) reads tile ``t``'s ``(i, j)``
  from the host-built ``(T, 2)`` int32 schedule table
  (:func:`repro_torch.core.schedule.grid_schedule`), copied to the
  device once per (schedule, grid, g, device);
* ``use_prefetch=False`` decodes ``t`` in closed form inside the kernel
  (:func:`decode_step`), the paper's trade of index computation for
  locality; Morton and Hilbert need a square power-of-two grid.

The kernel masks ragged M/N/K edges itself, so nothing is padded on the
card.  The batched kernel (:func:`sfc_matmul_batched_cuda`) runs the
same code once per batch element (grid ``(T * split, batch)``, batch
outermost, the curve on each element's tile plane), so each element
equals :func:`sfc_matmul_cuda` on it bit for bit.  On a CPU tensor both
wrappers run :func:`sfc_matmul_batched_plain`, which walks the same
tiles from the same schedule and accumulates in f32 over bk-deep k
blocks in k order.  Which body a launch takes is :func:`tile_path`'s
answer (the launcher's dispatch, mirrored):

* ``"rows"``, M <= 8 (every decode-step GEMM): each 128-column tile is
  a thread-block cluster of :func:`split_plan` blocks, each summing a
  contiguous K range (:func:`split_ranges`), whose partials rank 0 adds
  in rank order; a block multiplies bf16 on tensor cores (mma.sync, f32
  accumulate) and f32 with FFMA over 16 k-slices.
* ``"tc"``, every other bf16 launch whose operands are 16-byte vectors
  (a prefill chunk's, training's, an encoder's GEMMs): persistent
  blocks walk the curve's tile steps, TMA brings A and B into swizzled
  shared memory and wgmma multiplies them on the tensor cores (bf16 in,
  f32 accumulate, a k16 step at a time); counted in
  :data:`tile_tc_launches`.
* ``"simt"``: f32 (the paper's study; equal to cuBLAS's f32 product bit
  for bit), and bf16 operands that are not vectors: FFMA in k order.

Each path sums in f32 and differs from the plain version by summation
order only (the tensor cores add a k16 step's products inside the
instruction); every path gives the same bits run to run, and a B3
element equals B1 on it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.curves import hilbert_decode, morton_decode
from repro_torch.core.schedule import grid_schedule, is_pow2, \
    schedule_extra_kwargs
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACTIVATIONS, apply_epilogue_ref

__all__ = ["sfc_matmul_cuda", "sfc_matmul_batched_cuda", "sfc_matmul_plain",
           "sfc_matmul_batched_plain", "decode_step", "tile_schedule",
           "split_plan", "split_ranges", "launch_plan", "sm_count",
           "tile_ok", "tile_smem_bytes", "tile_path", "ROWS_MAX_M",
           "launches", "batched_launches", "tile_tc_launches"]

# kernel launches made by sfc_matmul_cuda (B1) and sfc_matmul_batched_cuda
# (B3); CPU calls are not counted
launches = 0
batched_launches = 0
# the B1 and B3 launches among them that took the tensor-core tile path
tile_tc_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
_MODE_CODE = {"rowmajor": 1, "colmajor": 2, "morton": 3, "hilbert": 4}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
_MAX_SPLIT = 8        # the portable thread-block cluster size
_ROWS_SLICES = 16     # k-slices of a rows-path block (csrc: kRowsSlices)
_ROWS_STAGES = 6      # stages of the rows path's ring of B (kRowsStages)

_SIGNATURES = {
    "sfc_matmul_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p],
        ctypes.c_int),
    "sfc_matmul_batched_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [ctypes.c_void_p],
        ctypes.c_int),
}

# device copies of schedule tables, per (schedule, mt, nt, g, device)
_DEVICE_TABLES: dict[tuple, torch.Tensor] = {}
# streaming multiprocessors per device
_SM_COUNT: dict[str, int] = {}


ROWS_MAX_M = 8        # the most rows the rows path takes (csrc: kRowsMaxM)


def tile_ok(bm: int, bn: int) -> bool:
    """Whether the kernel takes a bm x bn output tile: multiples of 16
    up to 128."""
    return bm % 16 == 0 and bn % 16 == 0 and 0 < bm <= 128 and 0 < bn <= 128


def tile_smem_bytes(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Bytes of an A (bm, bk) and a B (bk, bn) tile, which the wrapper
    holds within one block's shared memory (``_SMEM_LIMIT``)."""
    return (bm * bk + bk * bn) * itemsize


def _rows_path(m: int, n: int, k: int, bn: int, itemsize: int) -> bool:
    """Whether the kernel takes its rows path at this shape (given
    16-byte-aligned operands): M <= ROWS_MAX_M, bn = 128, N a multiple of
    8 and K of a 16-byte vector."""
    return (m <= ROWS_MAX_M and bn == 128 and n % 8 == 0
            and k % (16 // itemsize) == 0)


def tile_path(dtype: torch.dtype, m: int, n: int, bn: int, vec: int) -> str:
    """The kernel body a launch takes (csrc: rows_path, tc_path), given
    ``vec`` from :func:`launch_plan`: ``"rows"`` (M <= ROWS_MAX_M, bn =
    128, N a multiple of 8, vectors), else ``"tc"`` for bf16 vectors (TMA
    and wgmma on the tensor cores), else ``"simt"`` (f32 always; bf16
    operands that are not 16-byte vectors)."""
    if vec and m <= ROWS_MAX_M and bn == 128 and n % 8 == 0:
        return "rows"
    return "tc" if vec and dtype == torch.bfloat16 else "simt"


def split_plan(m: int, n: int, k: int, bn: int, dtype: torch.dtype,
               sms: int) -> int:
    """Cluster size of the rows path: the blocks that share one
    128-column output tile, each summing a contiguous K range.

    The smallest power of two ``s <= 8`` with ``nt * s >= sms``, such
    that every rank keeps at least one full pass of its k-slices
    (``K // s`` >= the k rows one pass of the ring of B covers); 1 off
    the rows path.  A pure function of one element's shape, so a batch
    of GEMMs (B3) splits each element as one GEMM (B1) does."""
    itemsize = dtype.itemsize
    if not _rows_path(m, n, k, bn, itemsize):
        return 1
    nt = -(-n // bn)
    # k rows one pass of the ring covers: 6 stages of 32 k rows (bf16,
    # each warp its 16 columns), or of one k row for each of 16 k-slices
    # (f32) (csrc: kMmaDepth, RowsF32::kPass)
    depth = _ROWS_STAGES * (32 if itemsize == 2 else _ROWS_SLICES)
    s = 1
    while s < _MAX_SPLIT and nt * s < sms and k // (2 * s) >= depth:
        s *= 2
    return s


def split_ranges(k: int, split: int, itemsize: int) -> list[tuple[int, int]]:
    """[start, end) of K for each rank of a rows-path cluster: ceil(K /
    split) rounded up to a whole 16-byte vector, the last range cut at
    K (csrc: split_len)."""
    vec_el = 16 // itemsize
    per = -(-k // split)
    klen = -(-per // vec_el) * vec_el
    return [(r * klen, min(k, (r + 1) * klen)) for r in range(split)]


def launch_plan(a: torch.Tensor, b: torch.Tensor, *, bk: int, bn: int,
                sms: int) -> tuple[int, int]:
    """(vec, split) that the C entry gets for operands ``a`` and ``b``
    (2-D for B1, 3-D for B3): whether K, N, bk, bn and both pointers
    are whole 16-byte vectors, and the rows path's cluster size, planned
    from one element's shape."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    vec_el = 16 // a.element_size()
    vec = int(k % vec_el == 0 and n % vec_el == 0 and bk % vec_el == 0
              and bn % vec_el == 0 and a.data_ptr() % 16 == 0
              and b.data_ptr() % 16 == 0)
    return vec, split_plan(m, n, k, bn, a.dtype, sms) if vec else 1


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    key = str(device)
    if key not in _SM_COUNT:
        _SM_COUNT[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[key]


def _check_closed_form(schedule: str, mt: int, nt: int) -> None:
    """Raise unless ``schedule`` has a closed-form decode on an mt x nt
    tile grid (host arithmetic only: the wrapper checks every launch)."""
    if schedule in ("morton", "hilbert"):
        if not (mt == nt and is_pow2(mt)):
            raise ValueError(
                f"closed-form {schedule} decode needs a square power-of-two "
                f"tile grid, got {mt}x{nt}; use use_prefetch=True otherwise")
    elif schedule not in ("rowmajor", "colmajor"):
        raise ValueError(f"no closed-form decode for schedule {schedule!r}")


def decode_step(t: torch.Tensor, schedule: str, mt: int, nt: int):
    """Closed-form tile step -> (i, j) on integer tensors; the plain
    twin of the kernel's in-kernel decode."""
    _check_closed_form(schedule, mt, nt)
    if schedule == "rowmajor":
        return t // nt, t % nt
    if schedule == "colmajor":
        return t % mt, t // mt
    if schedule == "morton":
        return morton_decode(t)
    return hilbert_decode(t, mt.bit_length() - 1)


def tile_schedule(schedule: str, mt: int, nt: int, *, use_prefetch: bool,
                  g: int = 0, device=None) -> torch.Tensor:
    """The (T, 2) int32 tile order the kernel walks, as a tensor: the
    host table, or the closed-form decode of ``arange(T)``."""
    if use_prefetch:
        tab = grid_schedule(schedule, mt, nt,
                            **schedule_extra_kwargs(schedule, g))
        return torch.from_numpy(tab.copy()).to(device)
    i, j = decode_step(torch.arange(mt * nt, device=device), schedule, mt, nt)
    return torch.stack([i, j], dim=1).to(torch.int32)


def _device_table(schedule: str, mt: int, nt: int, g: int,
                  device: torch.device) -> torch.Tensor:
    key = (schedule, mt, nt, g, str(device))
    tab = _DEVICE_TABLES.get(key)
    if tab is None:
        tab = tile_schedule(schedule, mt, nt, use_prefetch=True, g=g,
                            device=device).contiguous()
        _DEVICE_TABLES[key] = tab
    return tab


def sfc_matmul_batched_plain(a, b, *, sched: torch.Tensor, bm: int, bn: int,
                             bk: int, out_dtype=None, bias=None,
                             activation: str = "none",
                             residual=None) -> torch.Tensor:
    """The kernels' algorithm in plain PyTorch, a (batch, M, K) @ b
    (batch, K, N): for each batch element, tiles in the order of
    ``sched`` (T, 2), each an f32 sum over bk-deep k blocks in k order,
    then the fused epilogue (bias (N,) shared, residual (batch, M, N))
    and one cast."""
    bsz, m, k = a.shape
    n = b.shape[2]
    out_dtype = out_dtype or a.dtype
    mt, nt, kt = -(-m // bm), -(-n // bn), -(-k // bk)
    ap = F.pad(a.float(), (0, kt * bk - k, 0, mt * bm - m))
    bp = F.pad(b.float(), (0, nt * bn - n, 0, kt * bk - k))
    a_t = ap.view(bsz, mt, bm, kt, bk).permute(0, 1, 3, 2, 4)  # (., mt, kt, bm, bk)
    b_t = bp.view(bsz, kt, bk, nt, bn).permute(0, 1, 3, 2, 4)  # (., kt, nt, bk, bn)
    ii, jj = sched[:, 0].long(), sched[:, 1].long()
    t = len(sched)
    acc = torch.zeros(bsz * t, bm, bn, dtype=torch.float32, device=a.device)
    for kk in range(kt):
        acc += torch.bmm(a_t[:, ii, kk].reshape(bsz * t, bm, bk),
                         b_t[:, kk, jj].reshape(bsz * t, bk, bn))
    tiles = torch.empty(bsz, mt, nt, bm, bn, dtype=torch.float32,
                        device=a.device)
    tiles[:, ii, jj] = acc.view(bsz, t, bm, bn)
    c = tiles.permute(0, 1, 3, 2, 4).reshape(bsz, mt * bm, nt * bn)
    return apply_epilogue_ref(c[:, :m, :n], bias, activation, residual,
                              out_dtype)


def sfc_matmul_plain(a, b, *, sched: torch.Tensor, bm: int, bn: int, bk: int,
                     out_dtype=None, bias=None, activation: str = "none",
                     residual=None) -> torch.Tensor:
    """:func:`sfc_matmul_batched_plain` on one GEMM, a (M, K) @ b (K, N)."""
    return sfc_matmul_batched_plain(
        a[None], b[None], sched=sched, bm=bm, bn=bn, bk=bk,
        out_dtype=out_dtype, bias=bias, activation=activation,
        residual=residual[None] if residual is not None else None)[0]


def _check(a, b, bias, residual, activation, out_dtype, ndim: int):
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; choose from {ACTIVATIONS}")
    if (a.dim() != ndim or b.dim() != ndim or a.shape[:-2] != b.shape[:-2]
            or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"bad GEMM operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} (want {ndim}-D operands)")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"operands must share a float32/bfloat16 dtype, got "
                        f"{a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    m, n = a.shape[-2], b.shape[-1]
    if a.numel() == 0 or b.numel() == 0:
        raise ValueError(f"empty GEMM {tuple(a.shape)} @ {tuple(b.shape)}")
    for name, t, shape in (("bias", bias, (n,)),
                           ("residual", residual, (*a.shape[:-2], m, n))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.dtype not in _DTYPE_CODE or t.device != a.device:
            raise TypeError(f"{name} must be float32/bfloat16 on {a.device}")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def _launch(entry: str, a, b, *, schedule, bm, bn, bk, out_dtype,
            use_prefetch, g, bias, activation, residual) -> torch.Tensor:
    """Launch ``entry`` of csrc/sfc_matmul.cu on CUDA operands (2-D for
    B1, 3-D for B3) or raise; returns the output."""
    global tile_tc_launches
    if a.device.type != "cuda":
        raise ValueError(f"{entry} runs on cuda (or the plain version on "
                         f"cpu), got {a.device}")
    if not tile_ok(bm, bn):
        raise ValueError(f"the kernel takes bm and bn in multiples of 16 up "
                         f"to 128, got {bm}x{bn}")
    itemsize = a.element_size()
    if tile_smem_bytes(bm, bn, bk, itemsize) > _SMEM_LIMIT:
        # bk sizes no buffer of the kernel (it names the plain version's k
        # blocking); the bound stays so the wrapper refuses what it did
        raise ValueError(f"tiles {bm}x{bk} + {bk}x{bn} exceed shared memory")
    for name, t in (("a", a), ("b", b), ("bias", bias),
                    ("residual", residual)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    mt, nt = -(-m // bm), -(-n // bn)
    if use_prefetch:
        sched_t = _device_table(schedule, mt, nt, g, a.device)
        mode, order = 0, 0
    else:
        _check_closed_form(schedule, mt, nt)
        sched_t, mode = None, _MODE_CODE[schedule]
        order = mt.bit_length() - 1 if schedule == "hilbert" else 0
    vec, split = launch_plan(a, b, bk=bk, bn=bn, sms=sm_count(a.device))
    out = torch.empty(*a.shape[:-2], m, n, dtype=out_dtype, device=a.device)
    batch = [a.shape[0]] if a.dim() == 3 else []
    lib = _build.load("sfc_matmul", _SIGNATURES)
    err = getattr(lib, entry)(
        a.data_ptr(), b.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(),
        sched_t.data_ptr() if sched_t is not None else None,
        *batch, m, n, k, bm, bn, bk, _DTYPE_CODE[a.dtype],
        _DTYPE_CODE[out_dtype],
        _DTYPE_CODE[bias.dtype] if bias is not None else 0,
        _DTYPE_CODE[residual.dtype] if residual is not None else 0,
        _ACT_CODE[activation], mode, order, vec, split,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    if tile_path(a.dtype, m, n, bn, vec) == "tc":
        tile_tc_launches += 1
    return out


def sfc_matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                    schedule: str = "morton", bm: int = 128, bn: int = 128,
                    bk: int = 128, out_dtype=None, use_prefetch: bool = True,
                    g: int = 0, bias=None, activation: str = "none",
                    residual=None) -> torch.Tensor:
    """C = act(A @ B + bias) + residual with SFC-ordered tile traversal.

    a (M, K) and b (K, N) share a float32 or bfloat16 dtype; ``bias``
    is (N,) and ``residual`` (M, N), float32 or bfloat16; ``out_dtype``
    defaults to ``a.dtype``.  Any M/N/K: ragged edges are masked.  CUDA
    tensors launch the kernel (or raise); CPU tensors run
    :func:`sfc_matmul_plain`; other devices raise."""
    global launches
    out_dtype = out_dtype or a.dtype
    _check(a, b, bias, residual, activation, out_dtype, ndim=2)
    kw = dict(bias=bias, activation=activation, residual=residual)
    if a.device.type == "cpu":
        sched = tile_schedule(schedule, -(-a.shape[0] // bm),
                              -(-b.shape[1] // bn),
                              use_prefetch=use_prefetch, g=g)
        return sfc_matmul_plain(a, b, sched=sched, bm=bm, bn=bn, bk=bk,
                                out_dtype=out_dtype, **kw)
    out = _launch("sfc_matmul_launch", a, b, schedule=schedule, bm=bm, bn=bn,
                  bk=bk, out_dtype=out_dtype, use_prefetch=use_prefetch, g=g,
                  **kw)
    launches += 1
    return out


def sfc_matmul_batched_cuda(a: torch.Tensor, b: torch.Tensor, *,
                            schedule: str = "morton", bm: int = 128,
                            bn: int = 128, bk: int = 128, out_dtype=None,
                            use_prefetch: bool = True, g: int = 0, bias=None,
                            activation: str = "none",
                            residual=None) -> torch.Tensor:
    """C[i] = act(A[i] @ B[i] + bias) + residual[i] for each batch element
    i, SFC-ordered tiles, batch outermost.

    a (batch, M, K) and b (batch, K, N) share a float32 or bfloat16
    dtype; ``bias`` is (N,), shared; ``residual`` (batch, M, N).  Any
    M/N/K.  CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`sfc_matmul_batched_plain`; other devices raise."""
    global batched_launches
    out_dtype = out_dtype or a.dtype
    _check(a, b, bias, residual, activation, out_dtype, ndim=3)
    kw = dict(bias=bias, activation=activation, residual=residual)
    if a.device.type == "cpu":
        sched = tile_schedule(schedule, -(-a.shape[1] // bm),
                              -(-b.shape[2] // bn),
                              use_prefetch=use_prefetch, g=g)
        return sfc_matmul_batched_plain(a, b, sched=sched, bm=bm, bn=bn,
                                        bk=bk, out_dtype=out_dtype, **kw)
    out = _launch("sfc_matmul_batched_launch", a, b, schedule=schedule, bm=bm,
                  bn=bn, bk=bk, out_dtype=out_dtype,
                  use_prefetch=use_prefetch, g=g, **kw)
    batched_launches += 1
    return out
