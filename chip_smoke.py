#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/
csrc`` (one ``nvcc`` per source, all started together) and holds each
kernel against its plain PyTorch version at its main path's shapes.
Two main paths follow, each driven with the launch counts set to 0
just before it and read just after:

* serving: full-width qwen3-1.7b (random weights from a seed) through
  ``ServeLoop`` with the Morton-scheduled SFC GEMM (B1) and the paged
  decode attention kernel (B2);
* the paper's locality study (``configs/paper.py``, n = 2^10 and 2^12):
  the batched SFC GEMM (B3) through ``DotEngine.dot_batched`` under
  row-major, Morton and Hilbert order, and the software-cached SFC GEMM
  (B4) through ``sfc_matmul_cached``, whose in-kernel fetch counts must
  equal the direct-mapped cache's counts exactly.

It checks the launch counts and the outputs, times each kernel beside
its bound, its plain version and the library call, and prints one JSON
line of them (per serving step or per study), then B2 per launch at
512, 4096 and 32768 tokens per slot on a JSON line of its own
(``b2_long_context``), and as its last line ``{"ok": true, "device":
{...}}``.  Any failed phase exits non-zero.  Without a CUDA device, or
without the repository around it, it exits non-zero and prints no
result.

Tolerances (kernel against plain version, on the card, TF32 off):

* B1 f32 output: |kernel - plain| <= 1e-4 + 1e-4 |plain|, f32 summation
  order only (values O(1), K <= 6144).
* B1 bf16 output: <= 1e-3 + 2**-7 |plain|: at most one bf16 rounding
  step apart (the two f32 sums may straddle a rounding boundary).
* B1 run to run: two launches on the same inputs equal bit for bit at
  every main-path shape, bf16 and f32 (the rows path's cluster
  reduction adds in a fixed order).
* B3: B1's bounds, and each batch element equal bit for bit to B1 on
  that element (the reference's batched-kernel == vmap claim).
* B4 f32 output: B1's f32 bound (f32 summation order only); the fetch
  counts exactly equal to the plain version's oracle and to B4_COUNTS.
  B4's hazard phase (1-3 slots at n = 256, one bf16 case with B1's bf16
  bound, one 32^3-block case, one odd block edge): counts equal to the
  oracle, C within bound, and two launches equal bit for bit.
* B2 f32: <= 2e-5 absolute (O(1) outputs; online vs direct softmax,
  the cluster's rank merge), in every case: empty and partly filled
  tables at ps 4/8/16, the serving shape, qwen3-1.7b widths at
  LONG_CONTEXTS (full, ragged one-long-three-short, past the table), a
  split larger than the live pages, and ranks of more than 1024 pages
  (32768 tokens with split 1 or 2, which restage their table).
* B2 bf16: <= 3e-2 absolute, the same cases: the plain version rounds
  the scores and the softmax weights to bf16 as the reference does; the
  kernel keeps both in f32.
* B2, both dtypes, every case: per slot, max |kernel - plain| <=
  B2_SLOT_REL x the slot's largest |plain| output.  A full slot's
  outputs shrink as 1/sqrt(tokens) (~0.009 at 32768), below the
  absolute bf16 bound; this one holds them to their own scale.  At each
  long context the script also shows that it refuses an output of
  zeros and one from rank 0's pages only.
* B2 run to run: two launches on the same inputs equal bit for bit at
  the serving shape, at 32768 tokens and where ranks restage their
  table, bf16 and f32 (the cluster's ranks are merged in a fixed order).
* One full-width decode step, kernels against plain versions from an
  identical state: max |logit difference| <= LOGIT_BOUND with bf16
  weights, <= LOGIT_BOUND_F32 with the same weights in f32 (below).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
LOGIT_BOUND = 0.25             # one bf16 decode step, see the docstring
LOGIT_BOUND_F32 = 1e-3         # the same step with f32 weights
B2_SLOT_REL = 3e-2             # B2 per slot, against its largest output
SLEEP_CYCLES = 2_000_000       # ~1 ms at the H100's 1.98 GHz boost clock

SLOTS = 4
PAGE_SIZE = 16
CACHE_LEN = 64
MAX_NEW = 16
N_REQUESTS = 6                 # > SLOTS: two requests wait in the queue
# B2 is also checked and timed at these contexts (tokens per slot, 4
# slots): 32768 is qwen3-1.7b's native context
LONG_CONTEXTS = (512, 4096, 32768)

# the locality study: sizes, schedules, dtype and tile edge come from
# configs/paper.py (see paper_study); B3 runs the smallest and the largest
# paper size with these batches, B4 the smallest
B3_BATCHES = (4, 2)
B4_SETTINGS = ((16, 16), (16, 64), (8, 256))    # (block edge, nslots)
B4_SCHEDULES = ("rowmajor", "boustrophedon", "morton", "hilbert")
# [A fetches, B fetches] at the paper's n = 2^10: the direct-mapped cache
# with the kernel's slot mapping; tests/test_torch_sfc_matmul_cached.py
# holds this table to the reference's schedules
B4_COUNTS = {
    (16, 16): {"rowmajor": (262144, 262144),
               "boustrophedon": (262144, 262144),
               "morton": (262144, 262144), "hilbert": (262144, 262144)},
    (16, 64): {"rowmajor": (4096, 262144), "boustrophedon": (4096, 258112),
               "morton": (131072, 262144), "hilbert": (131072, 131136)},
    (8, 256): {"rowmajor": (16384, 2097152),
               "boustrophedon": (16384, 2064640),
               "morton": (524288, 1048576), "hilbert": (524288, 524544)},
}


# B4's hazard phase: with 1-3 slots every fill reuses a slot that a step
# in flight may still read.  16^3 blocks take the study's consumer path,
# 32^3 the general one, and the odd edge (24-byte rows) the plain copies
HAZARD_N, HAZARD_BLOCK, HAZARD_SLOTS = 256, 16, (1, 2, 3)
HAZARD_WIDE_BLOCK = 32
HAZARD_ODD_N, HAZARD_ODD_BLOCK = 192, 6


def paper_study():
    """(config, B4's n, B3's (batch, M, K, N) shapes) of the paper's
    study, from ``configs/paper.py``."""
    from repro_torch.configs.paper import CONFIG
    lo, hi = 2 ** CONFIG.sizes[0], 2 ** CONFIG.sizes[-1]
    return CONFIG, lo, ((B3_BATCHES[0], lo, lo, lo),
                        (B3_BATCHES[1], hi, hi, hi))


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Report:
    """Collects per-case errors and fails at the end of a phase."""

    def __init__(self):
        self.failures: list[str] = []

    def check(self, name: str, got, want, atol: float, rtol: float) -> float:
        import torch
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        bad = bool((diff > atol + rtol * want.float().abs()).any()) or \
            not bool(torch.isfinite(got.float()).all())
        print(f"  {'FAIL' if bad else 'ok  '} {name}: max_abs_err {err:.3e} "
              f"(bound {atol:g} + {rtol:g}|ref|)")
        if bad:
            self.failures.append(name)
        return err

    def raise_if_failed(self, phase: str):
        if self.failures:
            raise SystemExit(f"chip_smoke: {phase} failed: {self.failures}")


# ----------------------------------------------------------- main path ----
def main_path_gemms(cfg):
    """(name, M, K, N, epilogue, out f32, launches per decode step) of
    every B1 call one decode step makes at full width."""
    d, hd, kvd, f, v = (cfg.d_model, cfg.n_heads * cfg.d_head,
                        cfg.n_kv_heads * cfg.d_head, cfg.d_ff,
                        cfg.padded_vocab)
    n_l = cfg.n_layers
    return [("wq", SLOTS, d, hd, "none", False, n_l),
            ("wk|wv", SLOTS, d, kvd, "none", False, 2 * n_l),
            ("wo+res", SLOTS, hd, d, "residual", False, n_l),
            ("w1+silu", SLOTS, d, f, "silu", False, n_l),
            ("w3", SLOTS, d, f, "none", False, n_l),
            ("w2+res", SLOTS, f, d, "residual", False, n_l),
            ("head->f32", SLOTS, d, v, "none", True, 1)]


def _gemm_inputs(m, k, n, dtype, gen, epilogue):
    import torch
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5).to(dtype)
    kw = {}
    if epilogue == "residual":
        kw["residual"] = torch.randn(m, n, generator=gen,
                                     device="cuda").to(dtype)
    elif epilogue == "bias+gelu":
        kw["bias"] = torch.randn(n, generator=gen, device="cuda")
        kw["activation"] = "gelu"
    elif epilogue in ("silu", "relu"):
        kw["activation"] = epilogue
    return a, b, kw


def check_kernels(cfg) -> dict:
    """Phase 2: every kernel against its plain version at the main-path
    shapes (and the variants around them).  Returns max errors."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_cuda, \
        sfc_matmul_plain, tile_schedule

    rep = Report()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs = {"B1": 0.0}

    def gemm_case(label, m, k, n, dtype, epilogue, out_f32=False,
                  schedule="morton", use_prefetch=True, blk=(128, 128, 128)):
        a, b, kw = _gemm_inputs(m, k, n, dtype, gen, epilogue)
        out_dtype = torch.float32 if out_f32 else None
        bm, bn, bk = blk
        got = sfc_matmul_cuda(a, b, schedule=schedule, bm=bm, bn=bn, bk=bk,
                              use_prefetch=use_prefetch, out_dtype=out_dtype,
                              **kw)
        sched = tile_schedule(schedule, -(-m // bm), -(-n // bn),
                              use_prefetch=use_prefetch, device="cuda")
        want = sfc_matmul_plain(a, b, sched=sched, bm=bm, bn=bn, bk=bk,
                                out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        if got.dtype == torch.float32:
            tol = (1e-4, 1e-4)
        else:
            tol = (1e-3, 2.0 ** -7)
        name = (f"B1 {label} {m}x{k}x{n} {str(dtype)[6:]} {schedule}"
                f"{'' if use_prefetch else ' closed-form'} {epilogue}"
                f"{' ->f32' if out_f32 else ''}")
        errs["B1"] = max(errs["B1"], rep.check(name, got, want, *tol))

    print("[kernels] B1 sfc_matmul against its plain version")
    for name, m, k, n, ep, f32, _ in main_path_gemms(cfg):
        gemm_case(name, m, k, n, torch.bfloat16, ep, f32)
        gemm_case(name, m, k, n, torch.float32, ep, f32)
        gemm_case(name, m, k, n, torch.bfloat16, ep, f32,
                  schedule="rowmajor", use_prefetch=False)
    for sched in ("hilbert", "rowmajor"):
        gemm_case("wq", SLOTS, cfg.d_model, cfg.d_model, torch.bfloat16,
                  "none", schedule=sched)
    for sched in ("morton", "hilbert"):      # square power-of-two grids
        for pf in (True, False):
            gemm_case("square", 512, 384, 512, torch.bfloat16, "relu",
                      schedule=sched, use_prefetch=pf)
            gemm_case("square", 512, 384, 512, torch.float32, "bias+gelu",
                      schedule=sched, use_prefetch=pf)
    for dtype in (torch.bfloat16, torch.float32):  # rows path, 5-8 rows
        gemm_case("rows-8", 6, 2048, 1024, dtype, "residual")
    gemm_case("ragged-N", 3, 520, 77, torch.bfloat16, "silu")  # tile path
    gemm_case("ragged", 100, 260, 300, torch.bfloat16, "bias+gelu",
              schedule="hilbert")
    gemm_case("ragged", 37, 131, 77, torch.float32, "residual",
              schedule="morton")
    gemm_case("ragged-blk64", 70, 200, 150, torch.float32, "silu",
              schedule="peano", blk=(64, 64, 64))
    # the rows path's cluster reduction adds in a fixed order: two
    # launches on the same inputs must agree bit for bit
    for name, m, k, n, ep, f32, _ in main_path_gemms(cfg):
        for dtype in (torch.bfloat16, torch.float32):
            a, b, kw = _gemm_inputs(m, k, n, dtype, gen, ep)
            out_dtype = torch.float32 if f32 else None
            one = sfc_matmul_cuda(a, b, out_dtype=out_dtype, **kw)
            two = sfc_matmul_cuda(a, b, out_dtype=out_dtype, **kw)
            same = torch.equal(one, two)
            label = f"B1 {name} {m}x{k}x{n} {str(dtype)[6:]}"
            print(f"  {'ok  ' if same else 'FAIL'} {label}: two launches "
                  f"equal bit for bit")
            if not same:
                rep.failures.append(f"{label} run to run")
    rep.raise_if_failed("B1 checks")

    errs.update(check_paged(cfg, gen))
    errs["B3"] = check_batched(gen)
    errs["B4"] = check_cached(gen)
    return errs


def long_context_inputs(cfg, ctx: int, dtype, gen, ps: int = PAGE_SIZE,
                        d_head: int | None = None):
    """(q, k_pages, v_pages, tables) of SLOTS slots with room for ``ctx``
    tokens each, in ``ps``-token pages at qwen3-1.7b widths (``d_head``
    overrides the head width): every slot's pages distinct rows of one
    pool, in random order, the last row the reserved zero row."""
    import torch
    dh = d_head or cfg.d_head
    maxp = -(-ctx // ps)
    rows = SLOTS * maxp + 1
    shape = (rows, ps, cfg.n_kv_heads, dh)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kp[-1] = 0
    vp[-1] = 0
    tab = torch.randperm(rows - 1, generator=gen, device="cuda")
    tab = tab.to(torch.int32).view(SLOTS, maxp).contiguous()
    q = torch.randn(SLOTS, cfg.n_heads, dh, generator=gen,
                    device="cuda").to(dtype)
    return q, kp, vp, tab


def serving_positions():
    """Positions of the serving shape's timed step (build_state's)."""
    import torch
    return torch.tensor([24, 29, 35, 41], dtype=torch.int32, device="cuda")


def slot_scaled_err(got, want) -> float:
    """Largest over slots of max |got - want| / max |want| in the slot
    (0 where both are all zero, inf where only ``want`` is)."""
    import torch
    diff = (got.float() - want.float()).abs().flatten(1).amax(1)
    top = want.float().abs().flatten(1).amax(1)
    ratio = torch.where(top > 0, diff / top.clamp_min(1e-30),
                        torch.where(diff > 0, float("inf"), 0.0))
    return float(ratio.max())


def check_paged(cfg, gen) -> dict:
    """B2 against its plain version: empty and partly filled tables at
    ps 4/8/16; the serving shape; qwen3-1.7b widths at LONG_CONTEXTS
    with 4 slots (full, ragged one-long-three-short, past the table); a
    split larger than the slots' live pages; ranks of more than the
    kernel's 1024 staged table entries; and two launches equal bit for
    bit at the serving shape, at the longest context and where ranks
    restage their table.  Every case also holds each slot to
    B2_SLOT_REL of its own largest output.  Returns the max absolute
    errors: "B2" over every case, and per long context."""
    import torch

    from repro_torch.kernels.paged_attention import attn_split_plan, \
        paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    rep = Report()
    errs = {"B2": 0.0, **{f"B2@{ctx}": 0.0 for ctx in LONG_CONTEXTS}}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def case(label, q, kp, vp, tab, pos, key="B2", split=None):
        got = paged_decode_attention_cuda(q, kp, vp, tab, pos, split=split)
        want = paged_decode_attention_ref(q, kp, vp, tab, pos)
        torch.cuda.synchronize()
        tol = (2e-5, 0.0) if q.dtype == torch.float32 else (3e-2, 0.0)
        name = (f"B2 {str(q.dtype)[6:]} {label}"
                f"{'' if split is None else f' split={split}'}")
        err = rep.check(name, got, want, *tol)
        scaled = slot_scaled_err(got, want)
        ok = scaled <= B2_SLOT_REL
        print(f"  {'ok  ' if ok else 'FAIL'} {name}: per slot {scaled:.3e} "
              f"of its largest output {float(want.float().abs().max()):.3e} "
              f"(bound {B2_SLOT_REL:g})")
        if not ok:
            rep.failures.append(f"{name} per slot")
        errs["B2"] = max(errs["B2"], err)
        errs[key] = max(errs[key], err)
        return want

    def refuses(label, bad, want):
        """The per-slot bound must refuse ``bad``, a wrong output."""
        scaled = slot_scaled_err(bad, want)
        err = float((bad.float() - want.float()).abs().max())
        ok = scaled > B2_SLOT_REL
        print(f"  {'ok  ' if ok else 'FAIL'} B2 {str(want.dtype)[6:]} {label}: "
              f"refused, per slot {scaled:.3e} (absolute error {err:.3e})")
        if not ok:
            rep.failures.append(f"B2 {label} not refused")

    def same_twice(label, q, kp, vp, tab, pos, split=None):
        one = paged_decode_attention_cuda(q, kp, vp, tab, pos, split=split)
        two = paged_decode_attention_cuda(q, kp, vp, tab, pos, split=split)
        same = torch.equal(one, two)
        print(f"  {'ok  ' if same else 'FAIL'} B2 {str(q.dtype)[6:]} {label}"
              f"{'' if split is None else f' split={split}'}: two launches "
              f"equal bit for bit")
        if not same:
            rep.failures.append(f"B2 {label} run to run")

    print("[kernels] B2 paged_decode_attention against its plain version")
    hkv, dh, h = cfg.n_kv_heads, cfg.d_head, cfg.n_heads
    for dtype in (torch.bfloat16, torch.float32):
        for ps in (4, 8, 16):
            rows, maxp = 64 + 1, 6
            kp = torch.randn(rows, ps, hkv, dh, generator=gen,
                             device="cuda").to(dtype)
            vp = torch.randn(rows, ps, hkv, dh, generator=gen,
                             device="cuda").to(dtype)
            kp[-1] = 0
            vp[-1] = 0
            q = torch.randn(SLOTS, h, dh, generator=gen,
                            device="cuda").to(dtype)
            tab = torch.randint(0, rows - 1, (SLOTS, maxp), generator=gen,
                                device="cuda", dtype=torch.int32)
            tab[1, 2:] = rows - 1            # partly filled table
            tab[3, :] = rows - 1             # an empty table
            span = ps * maxp
            poss = [0, span // 2 + 1, span - 1,
                    torch.tensor([span - 1, ps + 1, 3, 2 * ps],
                                 dtype=torch.int32, device="cuda")]
            for pos in poss:
                label = "vector" if torch.is_tensor(pos) else f"scalar {pos}"
                case(f"ps={ps} pos {label}", q, kp, vp, tab, pos)
            # every slot has fewer live pages than the cluster has ranks
            few = torch.tensor([3, ps + 2, 0, 2 * ps], dtype=torch.int32,
                               device="cuda")
            case(f"ps={ps} pos {few.tolist()}", q, kp, vp, tab, few, split=8)
        # head shapes off the serving path: one query head per kv-head, a
        # group of 7 (two chunks), d_head 64 and 256, and d_head 100 (rows
        # of 200 or 400 bytes: plain loads in place of TMA)
        for hh, kvh, d in ((8, 8, 64), (14, 2, 128), (8, 2, 256),
                           (16, 8, 100)):
            rows, maxp, ps = 33, 6, 16
            kp = torch.randn(rows, ps, kvh, d, generator=gen,
                             device="cuda").to(dtype)
            vp = torch.randn(rows, ps, kvh, d, generator=gen,
                             device="cuda").to(dtype)
            kp[-1] = 0
            vp[-1] = 0
            q = torch.randn(SLOTS, hh, d, generator=gen,
                            device="cuda").to(dtype)
            tab = torch.randint(0, rows - 1, (SLOTS, maxp), generator=gen,
                                device="cuda", dtype=torch.int32)
            pos = torch.tensor([95, 17, 0, 60], dtype=torch.int32,
                               device="cuda")
            case(f"H={hh} Hkv={kvh} d_head={d} pos {pos.tolist()}", q, kp,
                 vp, tab, pos)
        # the serving shape: 64-token cache, positions of the timed step
        q, kp, vp, tab = long_context_inputs(cfg, CACHE_LEN, dtype, gen)
        pos = serving_positions()
        case(f"serving {pos.tolist()}", q, kp, vp, tab, pos)
        case(f"serving {pos.tolist()}", q, kp, vp, tab, pos, split=8)
        same_twice(f"serving {pos.tolist()}", q, kp, vp, tab, pos)
        for ctx in LONG_CONTEXTS:
            q, kp, vp, tab = long_context_inputs(cfg, ctx, dtype, gen)
            key = f"B2@{ctx}"
            want = case(f"ctx {ctx} pos {ctx - 1}", q, kp, vp, tab, ctx - 1,
                        key)
            # what the per-slot bound is for: a kernel that wrote zeros,
            # or merged only rank 0's share of the pages
            split = attn_split_plan(SLOTS, kp.shape[2], tab.shape[1], sms)
            part = tab.shape[1] // split * PAGE_SIZE - 1
            refuses(f"ctx {ctx} zeros", torch.zeros_like(want), want)
            refuses(f"ctx {ctx} rank 0's {part + 1} tokens of {split} ranks",
                    paged_decode_attention_ref(q, kp, vp, tab, part), want)
            ragged = torch.tensor([ctx - 1, 5, 100, min(700, ctx - 2)],
                                  dtype=torch.int32, device="cuda")
            case(f"ctx {ctx} pos {ragged.tolist()}", q, kp, vp, tab, ragged,
                 key)
            case(f"ctx {ctx} pos {ctx + 50} (past the table)", q, kp, vp,
                 tab, ctx + 50, key)
            if ctx == LONG_CONTEXTS[-1]:
                same_twice(f"ctx {ctx} pos {ctx - 1}", q, kp, vp, tab,
                           ctx - 1)
            del q, kp, vp, tab, want
        # ranks of more than kTab = 1024 pages restage their table as
        # they go: 32768 tokens in 16-token pages on one rank (2048
        # pages), in 8-token pages on two and on one (2048 and 4096),
        # and d_head 100 (plain loads) on one rank of 1100 pages
        ctx = LONG_CONTEXTS[-1]
        for ps, d, c, split in ((16, None, ctx, 1), (8, None, ctx, 2),
                                (8, None, ctx, 1), (16, 100, 1100 * 16, 1)):
            q, kp, vp, tab = long_context_inputs(cfg, c, dtype, gen, ps, d)
            label = f"ctx {c} ps={ps} d_head={kp.shape[3]}"
            ragged = torch.tensor([c - 1, 17000, 100, 1100 * ps - 3],
                                  dtype=torch.int32, device="cuda")
            for pos in (c - 1, ragged):
                shown = pos.tolist() if torch.is_tensor(pos) else pos
                case(f"{label} pos {shown}", q, kp, vp, tab, pos,
                     split=split)
            same_twice(f"{label} pos {ragged.tolist()}", q, kp, vp, tab,
                       ragged, split=split)
            del q, kp, vp, tab
        torch.cuda.empty_cache()
    rep.raise_if_failed("B2 checks")
    return errs


def check_batched(gen) -> float:
    """B3 against its plain version and, element by element, against B1
    (bit equality): the paper shapes under the paper's schedules, a
    closed-form decode, a ragged bf16 case with the whole epilogue, and
    a batch of decode-width products with the whole epilogue (the rows
    path)."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_batched_cuda, \
        sfc_matmul_batched_plain, sfc_matmul_cuda, tile_schedule

    paper, _, shapes = paper_study()
    blk = paper.block
    rep = Report()
    err = 0.0
    f32, bf16 = getattr(torch, paper.dtype), torch.bfloat16
    cases = [(shape, f32, False, s, True) for shape in shapes
             for s in paper.schedules]
    cases += [(shapes[0], f32, False, "hilbert", False),
              ((3, 1000, 1000, 1000), bf16, True, "hilbert", True),
              ((8, 4, 2048, 2048), bf16, True, "morton", True)]
    print("[kernels] B3 sfc_matmul_batched against its plain version and "
          "per-element B1")
    for (bsz, m, k, n), dtype, epilogue, sched, pf in cases:
        a = torch.randn(bsz, m, k, generator=gen, device="cuda").to(dtype)
        b = (torch.randn(bsz, k, n, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        kw, res = {}, None
        if epilogue:
            res = torch.randn(bsz, m, n, generator=gen,
                              device="cuda").to(dtype)
            kw = dict(bias=torch.randn(n, generator=gen, device="cuda"),
                      activation="gelu")
        got = sfc_matmul_batched_cuda(a, b, schedule=sched, use_prefetch=pf,
                                      bm=blk, bn=blk, bk=blk, residual=res,
                                      **kw)
        tab = tile_schedule(sched, -(-m // blk), -(-n // blk),
                            use_prefetch=pf, device="cuda")
        want = sfc_matmul_batched_plain(a, b, sched=tab, bm=blk, bn=blk,
                                        bk=blk, residual=res, **kw)
        same = [torch.equal(got[i], sfc_matmul_cuda(
            a[i], b[i], schedule=sched, use_prefetch=pf, bm=blk, bn=blk,
            bk=blk, residual=res[i] if res is not None else None, **kw))
            for i in range(bsz)]
        torch.cuda.synchronize()
        tol = (1e-4, 1e-4) if dtype == f32 else (1e-3, 2.0 ** -7)
        name = (f"B3 {bsz}x{m}x{k}x{n} {str(dtype)[6:]} {sched}"
                f"{'' if pf else ' closed-form'}"
                f"{' bias+gelu+res' if epilogue else ''}")
        err = max(err, rep.check(name, got, want, *tol))
        print(f"  {'ok  ' if all(same) else 'FAIL'} {name}: equal to B1 "
              f"on {sum(same)}/{bsz} elements")
        if not all(same):
            rep.failures.append(f"{name} != per-element B1")
        del a, b, got, want, res
    rep.raise_if_failed("B3 checks")
    return err


def check_cached_hazards(gen):
    """B4 where every fill collides: 1-3 slots, so the producer warp's
    copy into a slot must wait for the consumers' last read of its old
    block (the slot-lifetime rule).  A copy that lands too early gives a
    wrong C here even when the counts are right.  Per case: counts equal
    to ``dma_counts`` exactly, C within B1's bound of the plain version,
    and two launches equal bit for bit (C and counts)."""
    import torch

    from repro_torch.kernels.sfc_matmul import tile_schedule
    from repro_torch.kernels.sfc_matmul_cached import sfc_matmul_cached, \
        sfc_matmul_cached_plain

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(HAZARD_N, f32, HAZARD_BLOCK, nslots, sched)
             for nslots in HAZARD_SLOTS for sched in B4_SCHEDULES]
    cases += [(HAZARD_N, bf16, HAZARD_BLOCK, 2, "hilbert"),
              (HAZARD_N, f32, HAZARD_WIDE_BLOCK, 2, "morton"),
              (HAZARD_ODD_N, f32, HAZARD_ODD_BLOCK, 2, "hilbert")]
    rep = Report()
    print("[kernels] B4 hazard phase: 1-3 slots, every fill collides")
    for n, dtype, blk, nslots, sched in cases:
        a = torch.randn(n, n, generator=gen, device="cuda").to(dtype)
        b = (torch.randn(n, n, generator=gen, device="cuda") / n ** 0.5
             ).to(dtype)
        kw = dict(bm=blk, bn=blk, bk=blk, nslots=nslots)
        got, cnt = sfc_matmul_cached(a, b, schedule=sched, **kw)
        again, cnt2 = sfc_matmul_cached(a, b, schedule=sched, **kw)
        tab = tile_schedule(sched, n // blk, n // blk, use_prefetch=True,
                            device="cuda")
        want, want_cnt = sfc_matmul_cached_plain(a, b, sched=tab, **kw)
        torch.cuda.synchronize()
        name = (f"B4 hazard {n}^3 {str(dtype)[6:]} {blk}^3 blocks "
                f"x{nslots} slots {sched}")
        tol = (1e-4, 1e-4) if dtype == f32 else (1e-3, 2.0 ** -7)
        rep.check(name, got, want, *tol)
        counts = tuple(cnt.tolist())
        ok = counts == tuple(want_cnt.tolist()) == tuple(cnt2.tolist())
        same = torch.equal(got, again)
        print(f"  {'ok  ' if ok and same else 'FAIL'} {name}: fetches A+B "
              f"{counts[0]}+{counts[1]} (plain {tuple(want_cnt.tolist())}), "
              f"two launches {'equal' if same else 'DIFFER'} bit for bit")
        if not ok:
            rep.failures.append(f"{name} counts")
        if not same:
            rep.failures.append(f"{name} not repeatable")
    rep.raise_if_failed("B4 hazard phase")


def check_cached(gen) -> float:
    """B4's hazard phase (``check_cached_hazards``), then B4 against its
    plain version at the paper's n = 2^10 for every setting and schedule
    (C within f32 order bounds, counts exact and equal to B4_COUNTS), and
    the reference's defaults refused on the card."""
    import torch

    from repro_torch.kernels.sfc_matmul import tile_schedule
    from repro_torch.kernels.sfc_matmul_cached import sfc_matmul_cached, \
        sfc_matmul_cached_plain

    check_cached_hazards(gen)
    rep = Report()
    err = 0.0
    paper, n, _ = paper_study()
    dtype = getattr(torch, paper.dtype)
    a = torch.randn(n, n, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(n, n, generator=gen, device="cuda") / n ** 0.5).to(dtype)
    print("[kernels] B4 sfc_matmul_cached against its plain version")
    for blk, nslots in B4_SETTINGS:
        for sched in B4_SCHEDULES:
            got, cnt = sfc_matmul_cached(a, b, schedule=sched, bm=blk, bn=blk,
                                         bk=blk, nslots=nslots)
            tab = tile_schedule(sched, n // blk, n // blk, use_prefetch=True,
                                device="cuda")
            want, want_cnt = sfc_matmul_cached_plain(
                a, b, sched=tab, bm=blk, bn=blk, bk=blk, nslots=nslots)
            torch.cuda.synchronize()
            name = f"B4 {n}^3 f32 {blk}^3 blocks x{nslots} slots {sched}"
            err = max(err, rep.check(name, got, want, 1e-4, 1e-4))
            counts = tuple(cnt.tolist())
            table = B4_COUNTS[(blk, nslots)][sched]
            ok = counts == tuple(want_cnt.tolist()) == table
            print(f"  {'ok  ' if ok else 'FAIL'} {name}: fetches A+B "
                  f"{counts[0]}+{counts[1]} (plain {tuple(want_cnt.tolist())}"
                  f", table {table})")
            if not ok:
                rep.failures.append(f"{name} counts")
    try:
        sfc_matmul_cached(a, b)
    except ValueError as e:
        print(f"  ok   B4 reference defaults refused on the card: {e}")
    else:
        rep.failures.append("B4 defaults ran past the shared-memory limit")
    rep.raise_if_failed("B4 checks")
    return err


# ------------------------------------------------------------- serving ----
def serve(cfg, params) -> dict:
    """Phase 3: full-width lockstep paged serving through the kernels."""
    import numpy as np
    import torch

    import repro_torch.kernels.paged_attention as pa_mod
    import repro_torch.kernels.sfc_matmul as sfc_mod
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import DotEngine
    from repro_torch.serve import ServeConfig

    rows_checked = [0]

    class CheckedLoop(ServeLoop):
        """ServeLoop whose sampler first checks the logit row."""

        def _sample(self, logits_row):
            if not np.isfinite(logits_row).all():
                raise SystemExit("chip_smoke: non-finite logits in serving")
            rows_checked[0] += 1
            return super()._sample(logits_row)

    sc = ServeConfig(slots=SLOTS, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                     eos_id=-1, layout="paged", mode="lockstep", seed=0)
    loop = CheckedLoop(cfg, params, sc, engine=DotEngine(schedule="morton"),
                       device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(16, 33, size=N_REQUESTS)]
    for r, p in enumerate(prompts):
        loop.submit(r, p)
    torch.cuda.synchronize()
    sfc_mod.launches = 0
    pa_mod.launches = 0
    t0 = time.perf_counter()
    out = loop.run(max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"B1": sfc_mod.launches, "B2": pa_mod.launches}
    steps = loop.steps
    want = {"B1": steps * (7 * cfg.n_layers + 1), "B2": steps * cfg.n_layers}
    print(f"[serve] {N_REQUESTS} requests, prompts "
          f"{[len(p) for p in prompts]}, max_new {MAX_NEW}, {SLOTS} slots, "
          f"admission order {loop.admitted}, {loop.preemptions} preemptions")
    print(f"[serve] {steps} decode_step calls ({sum(len(p) for p in prompts)}"
          f" prefill tokens); launches B1 {launches['B1']} (want "
          f"{want['B1']}), B2 {launches['B2']} (want {want['B2']})")
    if launches != want:
        raise SystemExit(f"chip_smoke: launch counts {launches} != {want}")
    for r, p in enumerate(prompts):
        if len(out[r]) != len(p) + MAX_NEW or out[r][:len(p)] != p:
            raise SystemExit(f"chip_smoke: request {r} returned "
                             f"{len(out[r])} tokens")
    if rows_checked[0] != N_REQUESTS * MAX_NEW:
        raise SystemExit("chip_smoke: not every sampled row was checked")
    gen_tokens = N_REQUESTS * MAX_NEW
    return {"launches": launches, "steps": steps, "wall_s": wall,
            "tokens": gen_tokens, "tok_per_s": gen_tokens / wall,
            "ms_per_step": wall * 1e3 / steps}


class plain_versions:
    """Context in which the model's kernel call sites run the kernels'
    plain versions on the card (the yardstick of the full-step check).
    Swaps the two names the model calls; nothing in the port reads a
    switch."""

    def __enter__(self):
        import repro_torch.kernels.ops as ops
        import repro_torch.models.attention as attention
        from repro_torch.kernels.ref import paged_decode_attention_ref
        from repro_torch.kernels.sfc_matmul import sfc_matmul_plain, \
            tile_schedule

        def gemm(a, b, *, schedule, bm, bn, bk, out_dtype, use_prefetch, g,
                 **kw):
            sched = tile_schedule(schedule, -(-a.shape[0] // bm),
                                  -(-b.shape[1] // bn),
                                  use_prefetch=use_prefetch, g=g,
                                  device=a.device)
            return sfc_matmul_plain(a, b, sched=sched, bm=bm, bn=bn, bk=bk,
                                    out_dtype=out_dtype, **kw)

        self._saved = (ops.sfc_matmul_cuda,
                       attention.paged_decode_attention_cuda)
        ops.sfc_matmul_cuda = gemm
        attention.paged_decode_attention_cuda = paged_decode_attention_ref
        return self

    def __exit__(self, *exc):
        import repro_torch.kernels.ops as ops
        import repro_torch.models.attention as attention
        ops.sfc_matmul_cuda, attention.paged_decode_attention_cuda = \
            self._saved


def build_state(cfg, params, steps: int = 24):
    """A mid-serving paged state: 4 slots at ragged positions, filled
    by ``steps`` decode steps through the kernels."""
    import numpy as np
    import torch

    from repro_torch.models import DotEngine, decode_step
    from repro_torch.serve.paged_kv import init_paged_serving

    alloc, state = init_paged_serving(cfg, SLOTS, CACHE_LEN,
                                      page_size=PAGE_SIZE, device="cuda")
    rng = np.random.default_rng(7)
    start = np.asarray([0, 5, 11, 17])
    eng = DotEngine(schedule="morton")
    for i in range(steps):
        pos = start + i
        for s in range(SLOTS):
            alloc.ensure(s, int(pos[s]))
        state["block_tables"] = torch.tensor(alloc.block_table, device="cuda")
        toks = torch.tensor(rng.integers(2, cfg.vocab, size=(SLOTS, 1)),
                            device="cuda")
        decode_step(params, cfg, state, toks,
                    torch.tensor(pos, dtype=torch.int32, device="cuda"), eng)
    pos = start + steps
    for s in range(SLOTS):
        alloc.ensure(s, int(pos[s]))
    state["block_tables"] = torch.tensor(alloc.block_table, device="cuda")
    toks = torch.tensor(rng.integers(2, cfg.vocab, size=(SLOTS, 1)),
                        device="cuda")
    return state, toks, torch.tensor(pos, dtype=torch.int32, device="cuda")


def compare_step(cfg, params, state, toks, pos, bound: float) -> dict:
    """Phase 4: one full decode step on the kernels vs on the plain
    versions, from clones of one state."""
    import torch

    from repro_torch.models import DotEngine, decode_step

    eng = DotEngine(schedule="morton")
    got, _ = decode_step(params, cfg, state.clone(), toks, pos, eng)
    with plain_versions():
        want, _ = decode_step(params, cfg, state.clone(), toks, pos, eng)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    agree = int((got[:, 0].argmax(-1) == want[:, 0].argmax(-1)).sum())
    finite = bool(torch.isfinite(got).all())
    print(f"[step] full-width {cfg.param_dtype} decode step, kernels vs "
          f"plain versions: max |logit diff| {err:.4e} (bound {bound:g}), "
          f"greedy tokens agree {agree}/{SLOTS}, logit range "
          f"[{float(want.min()):.3f}, {float(want.max()):.3f}]")
    if not finite or err > bound:
        raise SystemExit("chip_smoke: full decode step disagrees with the "
                         "plain versions")
    return {"max_abs_err": err, "agree": agree}


def to_f32(cfg, params, state):
    """The same model and state with f32 weights and KV pages."""
    import dataclasses

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    st = state.clone()
    for key in ("k_pages", "v_pages"):
        st[key] = st[key].float()
    return (dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32"), cast(params), st)


def profile_steps(cfg, params, state, toks, pos, smi: str, n: int = 3):
    """Phase 6: where a decode step's time goes on the card, from a
    torch.profiler trace of ``n`` steps (device time by kernel, device
    busy share of the traced wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import DotEngine, decode_step

    eng = DotEngine(schedule="morton")
    st = state.clone()
    decode_step(params, cfg, st, toks, pos, eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        decode_step(params, cfg, st, toks, pos, eng)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            decode_step(params, cfg, st, toks, pos, eng)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) / n
    by_kernel: dict[str, float] = {}
    by_op: dict[str, float] = {}      # host: self CPU time of torch ops
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            by_op[e.key] = float(e.self_cpu_time_total) / 1e3 / n
            continue
        us = float(e.self_device_time_total)
        if us > 0:
            name = e.key.replace("(anonymous namespace)::", "")[:72]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / n
    busy = sum(by_kernel.values())
    host_ops = sum(by_op.values())
    print(f"[profile] decode step ({smi}): {plain_wall * 1e3:.3f} ms wall "
          f"untraced, {traced_wall * 1e3:.3f} ms traced; device busy "
          f"{busy:.3f} ms per step = {busy / (traced_wall * 1e3):.1%} of the "
          f"traced wall (idle share {1 - busy / (traced_wall * 1e3):.1%})")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.4f} ms/step  {ms / busy:6.1%}  {name}")
    print(f"[profile] host, traced: torch ops' self CPU time {host_ops:.3f} "
          f"ms per step; the rest of the {traced_wall * 1e3:.3f} ms is Python "
          f"and the ctypes kernel launches outside torch ops")
    for name, ms in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.4f} ms/step  {name[:72]}")
    return {"wall_ms": plain_wall * 1e3, "busy_ms": busy}


# -------------------------------------------------------------- timing ----
def _time_ms(fn, iters: int, flush) -> float:
    """Median ms of ``fn`` over ``iters`` runs, each timed by CUDA
    events after an L2 flush (a decode step reads each weight once, so
    the kernel meets it cold) and a ~1 ms device sleep, so the host has
    enqueued ``fn``'s first launch before the start event fires: a
    single-launch ``fn`` is timed on the device alone, a multi-launch
    plain version includes the host gaps between its launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def time_kernels(cfg, state, pos, smi: str) -> tuple[list, list]:
    """Phase 5: per-kernel times at the main-path shapes, aggregated per
    decode step (launch count x per-launch time), and B2's host time per
    wrapper call; then B2 per launch at LONG_CONTEXTS.  Returns (the
    kernels line's B1 and B2 rows, the long-context rows)."""
    import torch

    from repro_torch.kernels.paged_attention import attn_launch_plan, \
        attn_split_plan, paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref
    from repro_torch.kernels.sfc_matmul import sfc_matmul_cuda, \
        sfc_matmul_plain, split_plan, tile_schedule
    from repro_torch.serve.paged_kv import physical_rows, zero_row_index

    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    gen = torch.Generator(device="cuda").manual_seed(99)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    print(f"[time] B1 sfc_matmul per launch at the main-path shapes, bf16, "
          f"morton table ({smi})")
    for name, m, k, n, ep, f32, count in main_path_gemms(cfg):
        a, b, kw = _gemm_inputs(m, k, n, torch.bfloat16, gen, ep)
        out_dtype = torch.float32 if f32 else None
        sched = tile_schedule("morton", 1, -(-n // 128), use_prefetch=True,
                              device="cuda")
        ms = _time_ms(lambda: sfc_matmul_cuda(a, b, out_dtype=out_dtype, **kw),
                      20, flush)
        plain = _time_ms(lambda: sfc_matmul_plain(
            a, b, sched=sched, bm=128, bn=128, bk=128, out_dtype=out_dtype,
            **kw), 3, flush)
        lib = _time_ms(lambda: torch.matmul(a, b), 20, flush)
        out_b = 4 if f32 else 2
        nbytes = (m * k + k * n) * 2 + m * n * out_b + \
            (m * n * 2 if ep == "residual" else 0)
        bound = max(nbytes / HBM_BYTES_PER_S,
                    2.0 * m * n * k / BF16_FLOPS_PER_S) * 1e3
        split = split_plan(m, n, k, 128, torch.bfloat16, sms)
        print(f"  {name:10s} {m}x{k}x{n}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound "
              f"{bound:.4f} ms (bytes), x{count} per step; split {split}, "
              f"{-(-n // 128) * split} blocks, {nbytes / ms / 1e6:.0f} GB/s "
              f"(torch.matmul {nbytes / lib / 1e6:.0f} GB/s)")
        b1["ms"] += count * ms
        b1["plain_ms"] += count * plain
        b1["library_ms"] += count * lib
        b1["bound_ms"] += count * bound

    # B2 at the serving shape, on the mid-serving state of phase 4
    kp, vp = state["k_pages"], state["v_pages"]
    bt = state["block_tables"]
    phys = physical_rows(state["page_perm"], bt, zero_row_index(kp))[0]
    q = torch.randn(SLOTS, cfg.n_heads, cfg.d_head, generator=gen,
                    device="cuda").to(kp.dtype)
    ms = _time_ms(lambda: paged_decode_attention_cuda(q, kp, vp, phys, pos),
                  50, flush)
    plain = _time_ms(lambda: paged_decode_attention_ref(q, kp, vp, phys, pos),
                     20, flush)
    nbytes, bound = b2_bound(q, kp, phys, pos)
    n_l = cfg.n_layers
    split = attn_split_plan(SLOTS, kp.shape[2], phys.shape[1], sms)
    print(f"[time] B2 paged_decode_attention per launch, {SLOTS} slots at "
          f"positions {pos.tolist()}, ps={kp.shape[1]}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, bound {bound:.5f} ms (bytes), x{n_l} per "
          f"step; split {split}, {nbytes / ms / 1e6:.0f} GB/s, "
          f"{bound / ms:.1%} of the bound ({smi})")
    # the wrapper's host time: wall clock over many calls in a row (each
    # checks its operands, looks up its shape's plan and launches), with
    # the plan worked out afresh as a comparison
    plan = (SLOTS, q.shape[1], kp.shape[2], q.shape[2], kp.shape[1],
            phys.shape[1], kp.element_size(), sms)
    host = {}
    for name, fn in (
            ("wrapper call", lambda: paged_decode_attention_cuda(
                q, kp, vp, phys, pos)),
            ("plan, not cached", lambda: attn_launch_plan.__wrapped__(
                *plan)),
            ("plan, cached", lambda: attn_launch_plan(*plan))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print("[time] B2 host time per call (wall clock, 2000 calls): "
          + ", ".join(f"{k} {v:.2f} us" for k, v in host.items())
          + f"; x{n_l} per step = {n_l * host['wrapper call'] / 1e3:.3f} "
          f"ms of wrapper calls per decode step")
    rows = [
        {"name": "B1 sfc_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sfc_matmul.cu",
         "replaces": "src/repro/kernels/sfc_matmul.py:148",
         "ms": b1["ms"], "plain_ms": b1["plain_ms"],
         "bound_ms": b1["bound_ms"], "bound_by": "bytes",
         "library_ms": b1["library_ms"]},
        {"name": "B2 paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:103",
         "ms": n_l * ms, "plain_ms": n_l * plain, "bound_ms": n_l * bound,
         "bound_by": "bytes", "library_ms": None},
    ]
    del q, kp, vp
    return rows, time_long_contexts(cfg, flush, smi)


def b2_bound(q, kp, phys, pos) -> tuple[int, float]:
    """(bytes, bound ms) of one B2 launch on these inputs: the live
    pages' K and V rows read once (this run's positions), q read and the
    output written once, the tables and positions; against the bytes,
    4 * d_head FLOP per query head and live token at the f32 rate."""
    import torch
    ps, hkv, dh = kp.shape[1:]
    es = kp.element_size()
    b = q.shape[0]
    poss = torch.as_tensor(pos).reshape(-1).expand(b).tolist()
    pages = sum(min(p // ps + 1, phys.shape[1]) for p in poss if p >= 0)
    nbytes = (2 * pages * ps * hkv * dh * es + 2 * q.numel() * es
              + phys.numel() * 4 + b * 4)
    flops = 4.0 * q.shape[1] * dh * pages * ps
    return nbytes, max(nbytes / HBM_BYTES_PER_S,
                       flops / F32_FLOPS_PER_S) * 1e3


def time_long_contexts(cfg, flush, smi: str) -> list[dict]:
    """B2 per launch at LONG_CONTEXTS (4 slots, every slot at its last
    token, bf16): kernel, plain version, bound, GB/s and split, and as a
    yardstick PyTorch's scaled_dot_product_attention (enable_gqa) on the
    same K/V gathered beforehand into contiguous (B, Hkv, L, dh) tensors:
    not the same function, and the gather is not timed.  One row each for
    the ``b2_long_context`` line: every time in it is per launch."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import attn_split_plan, \
        paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(512)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    print(f"[time] B2 paged_decode_attention per launch at long contexts, "
          f"{SLOTS} slots, ps={PAGE_SIZE}, bf16, L2 flushed ({smi})")
    for ctx in LONG_CONTEXTS:
        q, kp, vp, tab = long_context_inputs(cfg, ctx, torch.bfloat16, gen)
        # on the device already: a host int would be copied inside the
        # timed window, behind the device sleep
        pos = torch.full((SLOTS,), ctx - 1, dtype=torch.int32, device="cuda")
        ms = _time_ms(lambda: paged_decode_attention_cuda(q, kp, vp, tab,
                                                          pos), 20, flush)
        plain = _time_ms(lambda: paged_decode_attention_ref(q, kp, vp, tab,
                                                            pos), 3, flush)
        nbytes, bound = b2_bound(q, kp, tab, pos)
        split = attn_split_plan(SLOTS, kp.shape[2], tab.shape[1], sms)
        hkv, dh = kp.shape[2], kp.shape[3]
        kc = kp[tab.long()].reshape(SLOTS, -1, hkv, dh)[:, :ctx]
        vc = vp[tab.long()].reshape(SLOTS, -1, hkv, dh)[:, :ctx]
        kc = kc.transpose(1, 2).contiguous()
        vc = vc.transpose(1, 2).contiguous()
        qs = q[:, :, None, :]
        sdpa = _time_ms(lambda: F.scaled_dot_product_attention(
            qs, kc, vc, enable_gqa=True), 20, flush)
        print(f"  ctx {ctx:6d}: kernel {ms:.4f} ms, {nbytes / ms / 1e6:.0f} "
              f"GB/s, {bound / ms:.1%} of the bound {bound:.4f} ms (bytes, "
              f"{nbytes / 1e6:.1f} MB); split {split}, "
              f"{SLOTS * hkv * split} blocks; plain {plain:.4f} ms; "
              f"scaled_dot_product_attention {sdpa:.4f} ms (yardstick: not "
              f"the same function; gather not timed)")
        rows.append({
            "name": "B2 paged_decode_attention",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "slots": SLOTS,
            "tokens_per_slot": ctx, "split": split,
            "ms_per_launch": ms, "plain_ms_per_launch": plain,
            "bound_ms_per_launch": bound, "bound_by": "bytes",
            "share_of_bound": bound / ms, "gb_per_s": nbytes / ms / 1e6,
            "sdpa_ms_per_launch": sdpa})
        del q, kp, vp, tab, kc, vc, qs
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------- locality study ----
def locality_study():
    """Phase 7, the slice's main path: the paper's experiment on the card
    through the entry points a user calls.  B3 runs through
    ``DotEngine.dot_batched`` at each paper shape under each paper
    schedule, B4 through ``sfc_matmul_cached`` at n = 2^10 for each
    cache setting and schedule; the launch counts are set to 0 just
    before and read just after.  Returns the counts and the inputs."""
    import torch

    import repro_torch.kernels.sfc_matmul as sfc_mod
    import repro_torch.kernels.sfc_matmul_cached as cached_mod
    from repro_torch.kernels.ref import matmul_batched_ref
    from repro_torch.kernels.sfc_matmul_cached import sfc_matmul_cached
    from repro_torch.models import DotEngine

    paper, n, shapes = paper_study()
    dtype = getattr(torch, paper.dtype)
    gen = torch.Generator(device="cuda").manual_seed(2016)
    b3_in = {}
    for bsz, m, k, n3 in shapes:
        b3_in[(bsz, m, k, n3)] = (
            torch.randn(bsz, m, k, generator=gen, device="cuda").to(dtype),
            (torch.randn(bsz, k, n3, generator=gen, device="cuda")
             / k ** 0.5).to(dtype))
    b4_in = (torch.randn(n, n, generator=gen, device="cuda").to(dtype),
             (torch.randn(n, n, generator=gen, device="cuda")
              / n ** 0.5).to(dtype))
    torch.cuda.synchronize()

    sfc_mod.launches = 0
    sfc_mod.batched_launches = 0
    cached_mod.launches = 0
    b3_out = {(shape, sched): DotEngine(
        schedule=sched, block=(paper.block,) * 3).dot_batched(*ab)
        for sched in paper.schedules for shape, ab in b3_in.items()}
    b4_out = {(blk, nslots, sched): sfc_matmul_cached(
        *b4_in, schedule=sched, bm=blk, bn=blk, bk=blk, nslots=nslots)
        for blk, nslots in B4_SETTINGS for sched in B4_SCHEDULES}
    torch.cuda.synchronize()
    launches = {"B1": sfc_mod.launches, "B3": sfc_mod.batched_launches,
                "B4": cached_mod.launches}
    want = {"B1": 0, "B3": len(paper.schedules) * len(shapes),
            "B4": len(B4_SETTINGS) * len(B4_SCHEDULES)}
    print(f"[study] launches B1 {launches['B1']} (want 0: no per-element "
          f"route), B3 {launches['B3']} (want {want['B3']}), B4 "
          f"{launches['B4']} (want {want['B4']})")
    if launches != want:
        raise SystemExit(f"chip_smoke: study launch counts {launches} != "
                         f"{want}")

    bad = []
    for shape, ab in b3_in.items():
        ref = matmul_batched_ref(*ab)
        for sched in paper.schedules:
            out = b3_out[(shape, sched)]
            err = float((out - ref).abs().max())
            ok = out.shape == ref.shape and bool(torch.isfinite(out).all()) \
                and err <= 1e-4 + 1e-4 * float(ref.abs().max())
            print(f"  {'ok  ' if ok else 'FAIL'} B3 {'x'.join(map(str, shape))}"
                  f" {sched}: max |out - torch.matmul| {err:.3e}")
            if not ok:
                bad.append(f"B3 {shape} {sched}")
    c_ref = b4_in[0] @ b4_in[1]
    print(f"[study] B4 fetches A+B, n = {n} {paper.dtype} (no-reuse ceiling "
          f"2*T*kt):")
    for blk, nslots in B4_SETTINGS:
        t, kt = (n // blk) ** 2, n // blk
        line = []
        for sched in B4_SCHEDULES:
            out, cnt = b4_out[(blk, nslots, sched)]
            counts = tuple(cnt.tolist())
            err = float((out - c_ref).abs().max())
            if counts != B4_COUNTS[(blk, nslots)][sched] or err > 1e-3 or \
                    not bool(torch.isfinite(out).all()):
                bad.append(f"B4 {blk} {nslots} {sched}")
            line.append(f"{sched} {counts[0]}+{counts[1]}")
        print(f"  {blk}^3 blocks, {nslots} slots, ceiling {2 * t * kt}: "
              + "; ".join(line))
    if bad:
        raise SystemExit(f"chip_smoke: locality study failed: {bad}")
    return launches, b3_in, b4_in


def time_study(b3_in, b4_in, smi: str) -> list[dict]:
    """Phase 8: device times of the study's launches beside their bounds,
    plain versions and library calls (CUDA events, L2 flushed)."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_batched_cuda, \
        sfc_matmul_batched_plain, tile_schedule
    from repro_torch.kernels.sfc_matmul_cached import sfc_matmul_cached, \
        sfc_matmul_cached_plain

    paper, _, _ = paper_study()
    tile = paper.block

    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    def bound(flops, nbytes):
        return max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3

    b3 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    print(f"[time] B3 sfc_matmul_batched per launch, {paper.dtype}, "
          f"{tile}^3 tiles, table ({smi})")
    for (bsz, m, k, n), (a, b) in b3_in.items():
        lib = _time_ms(lambda: torch.bmm(a, b), 5, flush)
        bd = bound(2.0 * bsz * m * n * k,
                   a.element_size() * bsz * (m * k + k * n + m * n))
        by_sched = {}
        for sched in paper.schedules:
            tab = tile_schedule(sched, m // tile, n // tile, use_prefetch=True,
                                device="cuda")
            ms = _time_ms(lambda: sfc_matmul_batched_cuda(
                a, b, schedule=sched, bm=tile, bn=tile, bk=tile), 5, flush)
            plain = _time_ms(lambda: sfc_matmul_batched_plain(
                a, b, sched=tab, bm=tile, bn=tile, bk=tile), 3, flush)
            print(f"  {bsz}x{m}x{k}x{n} {sched:9s}: kernel {ms:.4f} ms "
                  f"({2.0 * bsz * m * n * k / ms / 1e9:.2f} TFLOP/s), plain "
                  f"{plain:.4f} ms, torch.bmm {lib:.4f} ms, bound {bd:.4f} "
                  f"ms (operations)")
            b3["ms"] += ms
            b3["plain_ms"] += plain
            b3["library_ms"] += lib
            b3["bound_ms"] += bd
            by_sched[sched] = ms
        fast, slow = min(by_sched.values()), max(by_sched.values())
        flops = 2.0 * bsz * m * n * k
        print(f"  {bsz}x{m}x{k}x{n}: {flops / slow / 1e9:.2f}-"
              f"{flops / fast / 1e9:.2f} TFLOP/s (torch.bmm "
              f"{flops / lib / 1e9:.2f}); schedules spread "
              f"{(slow - fast) / fast:.2%} ("
              + ", ".join(f"{k_} {v:.4f}" for k_, v in by_sched.items())
              + " ms)")

    a, b = b4_in
    n = a.shape[0]
    b4 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    card = bound(2.0 * n ** 3, a.element_size() * 3 * n * n)
    lib = _time_ms(lambda: torch.matmul(a, b), 5, flush)
    print(f"[time] B4 sfc_matmul_cached per launch, {n}^3 {paper.dtype} "
          f"({smi}); bound "
          f"{card:.4f} ms for the card (operations), {card * 132:.3f} ms for "
          f"the one SM it uses; torch.matmul (C only, no counts) {lib:.4f} ms")
    for blk, nslots in B4_SETTINGS:
        for sched in B4_SCHEDULES:
            kw = dict(bm=blk, bn=blk, bk=blk, nslots=nslots)
            tab = tile_schedule(sched, n // blk, n // blk, use_prefetch=True,
                                device="cuda")
            ms = _time_ms(lambda: sfc_matmul_cached(a, b, schedule=sched,
                                                    **kw), 3, flush)
            plain = _time_ms(lambda: sfc_matmul_cached_plain(a, b, sched=tab,
                                                             **kw), 3, flush)
            fetched = sum(B4_COUNTS[(blk, nslots)][sched])
            steps = (n // blk) ** 3     # T tiles x kt k blocks
            print(f"  {blk}^3 x{nslots:3d} {sched:13s}: kernel {ms:.3f} ms "
                  f"({fetched} fetches, {ms * 1e6 / fetched:.1f} ns each; "
                  f"{steps} steps, {ms * 1e6 / steps:.1f} ns each), "
                  f"plain {plain:.3f} ms")
            b4["ms"] += ms
            b4["plain_ms"] += plain
            b4["library_ms"] += lib
            b4["bound_ms"] += card
    return [
        {"name": "B3 sfc_matmul_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sfc_matmul.cu",
         "replaces": "src/repro/kernels/sfc_matmul.py:302",
         "bound_by": "operations", **b3},
        {"name": "B4 sfc_matmul_cached", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sfc_matmul_cached.cu",
         "replaces": "src/repro/kernels/sfc_matmul_cached.py:96",
         "bound_by": "operations", **b4},
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_model

    smi = _smi()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"[build] nvcc sm_90a in parallel: "
          f"{', '.join(f'{k} {v:.1f}s' for k, v in secs.items())}; wall "
          f"{time.perf_counter() - t0:.1f}s into {_build.build_dir()}")

    cfg = get_config("qwen3_1_7b")
    errs = check_kernels(cfg)

    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[init] {cfg.name} full width, {cfg.n_layers} layers, "
          f"{n_bytes / 1e9:.2f} GB bf16 weights on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    sv = serve(cfg, params)
    print(f"[serve] {sv['tokens']} generated tokens in {sv['wall_s']:.3f}s: "
          f"{sv['tok_per_s']:.2f} tok/s, {sv['ms_per_step']:.3f} ms per "
          f"decode_step (prefill steps included) ({smi})")
    state, toks, pos = build_state(cfg, params)
    step = compare_step(cfg, params, state, toks, pos, LOGIT_BOUND)
    cfg32, params32, state32 = to_f32(cfg, params, state)
    compare_step(cfg32, params32, state32, toks, pos, LOGIT_BOUND_F32)
    del params32, state32
    rows, long_rows = time_kernels(cfg, state, pos, smi)
    profile_steps(cfg, params, state, toks, pos, smi)
    del params, state
    torch.cuda.empty_cache()
    study, b3_in, b4_in = locality_study()
    rows += time_study(b3_in, b4_in, smi)
    launches = {**sv["launches"], "B3": study["B3"], "B4": study["B4"]}
    for row, kid in zip(rows, ("B1", "B2", "B3", "B4")):
        row["launches"] = launches[kid]
        row["max_abs_err"] = errs[kid]
    for row in long_rows:
        row["max_abs_err"] = errs[f"B2@{row['tokens_per_slot']}"]
    print("kernels: [B1 sfc_matmul, B2 paged_decode_attention, B3 "
          "sfc_matmul_batched, B4 sfc_matmul_cached], all cuda")
    print(f"[summary] step logits max err {step['max_abs_err']:.4e}, "
          f"greedy agree {step['agree']}/{SLOTS}; serve "
          f"{sv['tok_per_s']:.2f} tok/s")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"b2_long_context": long_rows}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
