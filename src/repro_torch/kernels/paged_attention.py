"""Paged decode attention: the wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (port of
``repro.kernels.paged_attention.paged_decode_attention_pallas``).

One query token per decode slot attends to that slot's KV pages,
resolved through its block table of physical pool rows.  CUDA tensors
launch the kernel or raise; CPU tensors take the plain version
:func:`repro_torch.kernels.ref.paged_decode_attention_ref`.  There is
no fallback: a kernel that fails to build or launch raises.  Just
before the launch the wrapper checks the ``kernel`` chaos point
(:func:`repro_torch.runtime.chaos.fire`): an injected fault raises
``InjectedFault`` with nothing launched.

On the card each (slot, kv-head) is a thread-block cluster of
:func:`attn_split_plan` blocks; each rank streams its contiguous share
of the slot's live pages (:func:`repro_torch.kernels.ref.
attn_page_ranges`, worked out on the device from the position) through
a ring of :func:`attn_stage_pages`-page stages, and the ranks' online
softmax states are merged in rank order, so the result is the same bits
run to run.  :func:`repro_torch.kernels.ref.
paged_decode_attention_split_ref` is that algorithm in plain PyTorch.
A ``window`` (a model's sliding-window layers; one per launch) starts
each slot's live pages at its first page inside the window and masks
the keys below it (the kernel's windowed overload, counted in
:data:`window_launches`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.ref import paged_decode_attention_ref
from repro_torch.kernels.sfc_matmul import sm_count
from repro_torch.runtime.chaos import fire as _chaos_fire

__all__ = ["paged_decode_attention_cuda", "attn_split_plan",
           "attn_stage_pages", "attn_smem_bytes", "attn_launch_plan",
           "head_chunks", "launches", "window_launches"]

# kernel launches made by paged_decode_attention_cuda (CPU calls are not
# counted), and those of them with a window
launches = 0
window_launches = 0
launch_counts.register(__name__, "launches", "window_launches")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"paged_attention_launch": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    ctypes.c_int)}
_SPLITS = (1, 2, 4, 8)  # cluster sizes the kernel takes
_MAX_DH = 256           # 16 lanes of 16 values hold a row (csrc: kMaxDh)
_SMEM_LIMIT = 232448    # bytes of shared memory one block may use (H100)
# csrc constants the shared-memory layout follows
_THREADS, _STAGES, _TAB = 128, 2, 1024
_STAGE_BYTES = 32768    # K and V bytes one ring stage aims at
_RANK_PAGES = 8         # fewest pages a cluster rank is planned to get
_MAX_STAGE_PAGES = 64


def _group_width(g: int) -> int:
    """Query heads one block holds (csrc: group_width)."""
    return g if g <= 2 else 4


def _lanes(d_head: int) -> int:
    """Lanes of one token group (csrc: lanes_per_token)."""
    return 8 if d_head <= 128 else 16


def head_chunks(g: int) -> int:
    """Blocks (clusters) a GQA group of ``g`` query heads is cut into."""
    return -(-g // _group_width(g))


def attn_split_plan(b: int, hkv: int, max_pages: int, sms: int,
                    chunks: int = 1) -> int:
    """Cluster size of the kernel: the smallest power of two ``s <= 8``
    with ``b * hkv * chunks * s >= sms`` blocks, but no more ranks than
    leave each at least ``_RANK_PAGES`` pages of a full table (a rank's
    start-up and the cluster merge cost more than a short share saves).
    A pure function of the shapes: the live pages are only known on the
    device, where the ranks share them."""
    blocks = b * hkv * chunks
    s = 1
    while (s < _SPLITS[-1] and blocks * s < sms
           and 2 * s * _RANK_PAGES <= max_pages):
        s *= 2
    return s


def attn_stage_pages(page_size: int, d_head: int, itemsize: int) -> int:
    """Pages in one ring stage: the largest power of two (<= 64) whose K
    and V rows of one kv-head fit in 32 KB, and at least one."""
    page = 2 * page_size * d_head * itemsize
    p = 1
    while p < _MAX_STAGE_PAGES and 2 * p * page <= _STAGE_BYTES:
        p *= 2
    return p


def attn_smem_bytes(page_size: int, d_head: int, itemsize: int,
                    stage_pages: int, g: int) -> int:
    """Dynamic shared memory of one block (csrc: area_bytes + the
    table + the barriers): the ring of K/V stages, or the merge buffers
    that reuse its bytes, whichever is larger, then kTab int32 table
    entries and one 8-byte barrier per stage."""
    gw = _group_width(g)
    ring = _STAGES * 2 * stage_pages * page_size * d_head * itemsize
    groups = _THREADS // _lanes(d_head)
    merge = 4 * ((groups + 1) * gw * d_head + 2 * (groups + 1) * gw)
    return -(-max(ring, merge) // 16) * 16 + 4 * _TAB + 8 * _STAGES


@functools.lru_cache(maxsize=256)
def attn_launch_plan(b: int, h: int, hkv: int, dh: int, page_size: int,
                     max_pages: int, itemsize: int, sms: int,
                     window: int = 0) -> tuple[int, int, bool]:
    """(stage pages, planned split, whether the shape takes TMA) of one
    launch shape, worked out once per shape: the wrapper runs on every
    layer of every decode step.  A ``window`` plans the split over the
    pages it can span, ``ceil(window / page_size) + 1`` at most.  Raises
    ValueError for shapes the kernel cannot take.  TMA copies 16-byte
    rows into 128-byte aligned page slots in boxes of <= 256 tokens (the
    operands must also be 16-byte aligned, which the wrapper checks per
    call)."""
    if dh > _MAX_DH:
        raise ValueError(f"the kernel takes d_head <= {_MAX_DH}, got {dh}")
    stage_pages = attn_stage_pages(page_size, dh, itemsize)
    smem = attn_smem_bytes(page_size, dh, itemsize, stage_pages, h // hkv)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a page of {page_size} x {dh} exceeds the kernel's "
                         f"shared memory ({smem} > {_SMEM_LIMIT} bytes)")
    pages = max_pages if not window else min(max_pages,
                                             -(-window // page_size) + 1)
    split = attn_split_plan(b, hkv, pages, sms, head_chunks(h // hkv))
    vec = (dh * itemsize % 16 == 0 and page_size * dh * itemsize % 128 == 0
           and page_size <= 256)
    return stage_pages, split, vec


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                phys_tables: torch.Tensor,
                                cur_pos, *, split: int | None = None,
                                window: int | None = None) -> torch.Tensor:
    """q: (B, H, dh); k_pages/v_pages: (R, page_size, Hkv, dh) physical
    pool (last row reserved zero); phys_tables: (B, max_pages) int32
    physical rows; cur_pos: newest position, a scalar (int or 0-d
    tensor, broadcast to every slot) or a (B,) vector; ``window``: attend
    only the keys at positions > cur_pos - window (None: every key up to
    cur_pos).  Returns (B, H, dh) in the cache dtype.  Head counts come
    from the operands.  ``split`` overrides :func:`attn_split_plan`'s
    cluster size (1, 2, 4 or 8); it does not change the result beyond
    f32 summation order."""
    global launches, window_launches
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    b, h, dh = q.shape
    _, page_size, hkv, dh2 = k_pages.shape
    if dh != dh2 or h % hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    if phys_tables.dim() != 2 or phys_tables.shape[0] != b:
        raise ValueError(f"phys_tables {tuple(phys_tables.shape)} is not "
                         f"({b}, max_pages)")
    if split is not None and split not in _SPLITS:
        raise ValueError(f"split must be one of {_SPLITS}, got {split}")
    if window is not None and window < 1:
        raise ValueError(f"a window holds at least one key, got {window}")
    dev = q.device
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, phys_tables,
                                          cur_pos, window)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda runs on cuda (or the "
                         f"plain version on cpu), got {dev}")
    if q.dtype not in _DTYPE_CODE or not (
            q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"q and pages must share a float32/bfloat16 dtype, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if phys_tables.dtype != torch.int32:
        raise TypeError(f"phys_tables must be int32, got {phys_tables.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("phys_tables", phys_tables)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    stage_pages, planned, vec = attn_launch_plan(
        b, h, hkv, dh, page_size, phys_tables.shape[1], q.element_size(),
        sm_count(dev), window or 0)
    if split is None:
        split = planned
    pos = torch.as_tensor(cur_pos, device=dev).to(torch.int32).reshape(-1)
    if pos.numel() not in (1, b):
        raise ValueError(f"cur_pos must be a scalar or ({b},), got "
                         f"{pos.numel()} values")
    pos = pos.expand(b).contiguous()
    out = torch.empty_like(q)
    vec = int(vec and all(t.data_ptr() % 16 == 0
                          for t in (q, k_pages, v_pages, out)))
    lib = _build.load("paged_attention", _SIGNATURES)
    # chaos point (host only, no device work): an injected ``kernel``
    # fault raises InjectedFault here, before the launch, for the serve
    # loop's retry; a real launch error is never turned into one
    _chaos_fire("kernel")
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        phys_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, hkv, dh, page_size, phys_tables.shape[1], k_pages.shape[0],
        1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], split, stage_pages, vec,
        window or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError {err}")
    launches += 1
    if window:
        window_launches += 1
    return out
