#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/
csrc`` (one ``nvcc`` per source, all started together) and holds each
kernel against its plain PyTorch version at its main path's shapes.
The main paths follow, each driven with the launch counts set to 0
just before it and read just after:

* serving: full-width qwen3-1.7b (random weights from a seed) through
  ``ServeLoop`` with the Morton-scheduled SFC GEMM (B1) and the paged
  decode attention kernel (B2), the same 6 requests in lockstep and in
  continuous mode (chunked prefill under a 32-token budget, prefix
  sharing on), then a prefix-sharing run (a 64-token shared prefix with
  ragged tails and a duplicate prompt that arrives while its source
  decodes: prefix hits, shared pages, copy-on-write forks), then the
  same requests with observability on (an enabled span tracer and a
  metrics registry: TTFT, TPOT and end-to-end latency per mode; obs on
  and off in turns) and through faults in continuous mode (a chaos
  schedule of retried faults -- alloc, step, kernel, straggler, power
  -- restored and replayed; a NaN quarantine; a snapshot and a restore
  in memory and through the checkpoint store on disk; the guards on and
  off in turns);
* the paper's locality study (``configs/paper.py``, n = 2^10 and 2^12):
  the batched SFC GEMM (B3) through ``DotEngine.dot_batched`` under
  row-major, Morton and Hilbert order, and the software-cached SFC GEMM
  (B4) through ``sfc_matmul_cached``, whose in-kernel fetch counts must
  equal the direct-mapped cache's counts exactly;
* both KV layouts and the dense archs, last: qwen3-1.7b again (the same
  seed) served contiguous, lockstep and continuous, beside the paged
  runs (per-request token agreement printed); h2o-danube-3-4b at full
  width and depth (sliding window 4096) served contiguous and lockstep,
  then its ring of one window (``swa_ring``: four slots prefilled to
  4092, 4094, 100 and 300 tokens by ``prefill_kv``, 8 decode steps on
  per-row positions, rows 0 and 1 wrapping); glm4-9b at full width and
  depth (GQA group 16) served continuous, paged and contiguous, 4
  requests of 8 new tokens; deepseek-coder-33b at full width and all
  62 layers (group 7; 66.7 GB of bf16 weights, drawn a layer at a time;
  its peak memory printed), its f32 paged-against-contiguous step on
  its first 4 layers (an f32 copy of 62 would take 133 GB).  Each
  model's B1 shapes (and B2 head widths where it serves paged) are held
  against the plain versions first; one decode step per (arch, layout)
  against the plain versions (``layout_step``), timed; each model is
  freed before the next;
* the moe, ssm and hybrid families (``families_phase``), at full width
  and depth the same way: granite-moe-1b-a400m (32 experts top 8, B2
  at d_head 64, group 2) the 6 requests lockstep and continuous, paged;
  granite-moe-3b-a800m (40 experts) 4 requests of 8 new tokens,
  continuous, paged and contiguous (token agreement printed);
  mamba2-780m and hymba-1.5b (B1's tile path at hymba's in_proj, N =
  3257) 4 requests of 16 new tokens, lockstep and contiguous, as the
  reference serves them;
* mellum2-12b-a2.5b (``mellum2_phase``) at full width and depth, 64
  experts top 8 and 21 window layers of 1024 keys beside 7 full ones:
  B5 (``sfc_matmul_grouped``) at the codectx cell's decode (7 tokens,
  8-row tiles) and chunk (256 tokens, 64-row tiles) shapes and B2 with
  and without the window at 8 rows of 2233-7512 keys, each against its
  plain version, twice bit for bit and timed beside its bytes bound;
  then 4 requests (3 past the window) served continuous and paged with
  B1, B2, windowed B2 and B5 launches counted from 0 and held exact;
* training, after them (``train_phase``): qwen3-1.7b at full width and
  depth in bf16 (random weights from seed 0, ``PackedSyntheticData``
  seed 0 batches of 4 x 256 tokens), 4 steps of ``make_train_step``
  under Morton, every projection's forward, dgrad and wgrad GEMM
  through B1 (``repro_torch.kernels.grad``), and the same 4 steps under
  ``"xla"`` from the same state; B1's backward GEMMs against the plain
  version first; an f32 step at 2 of 28 layers against the plain
  versions; the SMOKE config through ``launch/train.py``'s ``main``
  with a failure injected and a resume (a qwen3-1.7b checkpoint, ~24
  GB of f32 optimizer state, is too large to write in a smoke run);
  then timings: ms and J per step, B1 per step by role beside
  ``torch.matmul`` and the bound, a profile of one step per schedule;
  then granite-moe-1b-a400m, mamba2-780m and hymba-1.5b at full width
  on FAMILY_TRAIN_LAYERS (8) of their 24, 48 and 32 layers (a depth cut
  that keeps the script well inside its time limit; their layers are
  uniform, and they serve at full depth above) through the same
  ``train_arch``: B1's forward, dgrad and
  wgrad GEMMs at their shapes against the plain version, the same
  step-0 gradient checks, and 2 steps of each schedule from the seed-0
  state with their joules and a profiled step;
* the dry-run's counter (``dryrun_phase``, after qwen3's training):
  ``launch/opcount.py``'s ``count_step`` around one real qwen3-1.7b
  Morton train step at full width and depth (4 x 256 tokens, seed 0)
  and one contiguous decode step, and around each step's meta twin (the
  same builders' meta tensors, as the dry-run runs them): FLOPs, GEMM
  shapes, collectives and traffic must be equal, and B1's launches 619
  and 197 on both and in the kernel wrapper's own counter; the meta
  argument + temp memory printed beside ``max_memory_allocated``, and
  the step's roofline fraction, model FLOPs over the measured step time
  at the H100 model's peak; then ``examples_torch/quickstart.py`` and
  ``serve_lm.py --layout paged`` as subprocesses (``examples_phase``),
  a non-zero exit failing the run;
* the frontend archs, last (``frontends_phase``): hubert-xlarge (the
  encoder) at full width and all 48 layers, B1 at its encode shapes
  (``frontend_proj`` at M = 4096, K = 512; the layers; the head at N =
  512) against the plain version, 4 clips of 1024 frames encoded under
  Morton and ``"xla"`` (ms, frames/s, J, peak memory, the logits against
  the plain versions), then 2 training steps of 4 x 256 frames through
  ``train_arch``; llava-next-34b (the vlm) at full width and all 60
  layers (68.8 GB of bf16 weights, drawn a layer at a time; its peak
  memory printed), its B1 decode and chunk shapes, B2 at group 7 and B1
  at ``frontend_proj``'s 576-patch shape against the plain versions, 4
  requests of 8 new tokens served continuous, paged and contiguous, its
  decode steps against the plain versions, the f32 layouts check on its
  first 4 layers, then training at full width on 4 of its 60 layers, 2 x
  2048 tokens a step (each row carries the 576-patch prefix under its
  loss mask);
* the distributed layer, last (``distributed_phase``), in a world of one
  NCCL rank (the machine has one card; NCCL takes one rank a card)
  joined through a ``FileStore`` in a temporary directory: B1 at the
  shapes one tensor-parallel rank of qwen3-1.7b launches on a 2- and an
  8-way model axis (decode M = 4 and chunk M = 128: N / m for wq, wk,
  wv, w1, w3 and the head, K / m for wo and w2) and B2 at such a rank's
  4 and 1 kv-heads (group 2, 4096 tokens a slot), against the plain
  versions and timed; ``launch/train.py``'s ``main`` with --mesh 1,1,1
  (the sharded step: tensor-parallel layers, ZeRO-1 AdamW) and without,
  2 steps of 4 x 256 tokens each from the seed-0 state; then
  ``build_serve_step`` at world size 1, paged and contiguous (the
  sequence-parallel attention), 8 greedy steps beside the unsharded
  ``decode_step``; the collectives a step issues, by kind.

Energy is read from the card itself, through the port's
``NvmlBackend`` (NVML's cumulative energy counter, bound with ctypes),
named explicitly: auto-detection prefers RAPL, the CPU package's.  An
idle phase first reads the counter's update interval and the idle
watts; the serving runs meter every step on a backend whose counter
is read by a sampling thread, off the serving loop's path (joules per
generated token, the decode and chunk steps' shares, requests charged
in full, the meter's host time a step); the
paper's energy experiment runs B3 through ``DotEngine.dot_batched`` at
both study shapes in row-major, Morton and Hilbert order (table and
closed-form decode), each variant in NVML windows of >= 1 s taken in
turns; and the tuner resolves ``schedule="auto"`` on the card for every
serving, chunk and study GEMM under objective "time" and "edp",
measuring every candidate, then runs one auto GEMM per serving shape.
A missing NVML library or counter fails the run.

It checks the launch counts and the outputs, times each kernel beside
its bound, its plain version and the library call, and prints one JSON
line of them (per serving decode step or per study; launches those
of the main path, the continuous serving run's B1/B2 and the study's
B3/B4, each read just after its own zeroing; B1's and B2's rows also
carry ``by_arch``, each other arch's and layout's decode step with its
launches), then B2 per launch at
512, 4096 and 32768 tokens per slot on a JSON line of its own
(``b2_long_context``), the NVML phase (``nvml``), the two serving modes
side by side with their joules (``serve_modes``), B1 per launch at a
prefill chunk's shapes (``b1_prefill``), the energy per schedule
(``study_energy``), the tuner's winners beside the analytic prediction
and the library time, with the ``"xla"`` baseline checked at every
serving GEMM (``tuner``), the observed runs (``serve_obs``: latency
percentiles, counters, tok/s with obs on and off), the faulted runs
(``serve_faults``: the schedules' faults, restores, errors, snapshot and
restore ms, tok/s with the guards on and off), the layouts and archs
(``serve_layouts``: tok/s, ms per decode and chunk step, J per token,
token agreement with the paged run; ``layout_step``: logit errors,
launches, B1 and B2 per step beside their bounds, qwen3's device busy
time per layout; ``swa_ring``: prefill and decode ms, the ring's
checks), the training path (``train``: losses, ms, tok/s, J and peak
memory per step per schedule, B1 by role, the profiles, the gates'
errors), every path's launches (``launches_by_path``: the serving runs,
the observed and faulted runs, the study, its energy windows, the
tuner, the layouts' runs and the families' runs and train steps), the
families (``families``: tok/s, ms a step and J per token of each serving
run, each arch's decode step against the plain versions and B1 and B2
beside their bounds, each trained arch's record as on the ``train``
line: losses, ms, J and peak memory per step per schedule, the
profiles, the gradient errors per leaf, pinned and not), mellum2's
(``mellum2``: B5 a decode and a chunk step and B2 with and without its
window, each with its error, ms and bound, and the served run's steps,
ms a step and launches; the ``kernels`` line gains a B5 row and a
windowed-B2 row, a codectx decode step's), the frontend
archs (``frontends``: hubert's encodes per schedule with their ms,
frames/s, J, peak memory and logit error, B1 per encode beside its
bound, its training record; llava's serving runs, decode steps, peak
memory, ``frontend_proj``'s time and its training record at its depth
cut), the dry-run's counts (``dryrun``: each step's FLOPs, traffic,
kernels by route and launches on the card, whether the meta twin
equals them, both memories, the allocator's peak, the roofline
fraction), the examples' exits and seconds (``examples``), the wall
seconds of each part of the run (``phase_seconds``; each
part also printed as it ends), the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero.  Without a CUDA device, or
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
* B1 at a prefill chunk's shapes (M = SLOTS x PREFILL_BUDGET = 128, the
  tile path): B1's bf16 and f32 bounds above, and two launches equal
  bit for bit.
* One full-width prefill chunk (ragged rows reading back an earlier
  chunk's pages, one pad row), kernels against plain versions from an
  identical state: every K/V entry of the pool within KV_BOUND in bf16
  (O(1) values; a bf16 rounding step of the activations, 2**-8
  relative, flipped in a layer is carried by the ones after it, as in
  the logits' bound) and KV_BOUND_F32 in f32.  A 48-token prompt's K/V
  from two chunks against one single-shot ``prefill_kv``: the same
  bounds (the chunk attends over its slot's gathered pages, the single
  shot over the prompt, so the attention sums differ in order).
* The study's energy variants: each output within B1's f32 bound of
  ``torch.bmm`` before its windows; B3's launches in the windows exact.
* Serving energy: the joules charged to requests equal the report's
  total within 1e-6 relative (every reading is charged in full).
* The tuner's auto GEMMs: a curve winner's output within B1's bf16
  bound of the plain version with the winner's tiles and order, with
  exactly one B1 launch; an "xla" winner equal to the library call
  (``ops.library_matmul``: bf16 GEMM, f32 output, f32 epilogue), with
  none.  The library call itself within B1's bf16 bound of the plain
  version (f32 products) at every serving GEMM.
* Observability: the trace written as JSONL passes the port's
  ``validate_trace``; the X spans' joules sum to the energy report's
  total within 1e-6 relative; tokens with obs on equal tokens with obs
  off (lockstep and continuous).
* Faults (continuous): under RETRY_SPEC every request's tokens equal
  the clean run's exactly (B1 and B2 are bit-equal run to run and a
  replay runs the same batches), the schedule is spent, each point is
  counted, >= 3 restores, the allocator's invariants hold, and the
  launches equal ``steps * 197 + chunks * 196`` B1 and ``steps * 28``
  B2 with the replayed steps counted; under NAN_SPEC ``errors == {1:
  "nan"}`` and the other 5 requests finish (their token agreement with
  the clean run is printed: a quarantined slot changes later batches);
  after a restore from disk the run ends with an uninterrupted run's
  tokens; tokens with the guards on equal tokens with them off.
* Layouts and archs: every served run's launches exact (7 B1 a layer
  and the head a decode step, 7 B1 a layer a chunk, one B2 a layer a
  paged decode step, none contiguous); each (arch, layout) decode step
  within LOGIT_BOUND of the plain versions; qwen3's and deepseek's f32
  decode step (deepseek's first 4 layers) paged against contiguous from
  the same K/V within LOGIT_BOUND_F32; the new archs' B1 and B2 shapes
  within the bounds above, two B1 launches bit-equal.  ``swa_ring``:
  each slot's K/V from ``prefill_kv`` over [0, L) within KV_BOUND of
  the same prefill on the plain versions (B1 at M = 4092, 4094, 100 and
  300 with N = 3840, 960 and 10240); every step within LOGIT_BOUND of
  the plain versions, and after each step layer 0's
  entry at ``pos % 4096`` of every row equal to its K and V computed
  anew (exactly) with no other entry of any layer moved.  Token
  agreement between layouts in bf16 is printed, not gated (B2 keeps
  scores and weights in f32, the contiguous torch attention rounds
  them to bf16 as the reference does).
* Training: B1's dgrad and wgrad at one qwen3 layer's 7 projections
  (bf16, 1024 tokens) and the vocab head's pair (f32, K or N = 151936)
  within B1's bf16 and f32 bounds above, two launches bit-equal.  The
  step-0 loss within LOSS0_BOUND (1.0) of ln(vocab): random logits of
  unit variance add ~0.5.  The loss falls over the 4 steps.  |loss
  Morton - loss "xla"| <= TRAIN_LOSS_BOUND (0.1) at every step: the
  two differ in f32 summation order, rounded to bf16 at every
  activation, and Adam's first update is lr x sign(g), so an element
  whose tiny gradient changes sign moves 2 lr the other way.  Step-0
  gradients per leaf ||Morton - "xla"|| / ||"xla"|| <= TRAIN_GRAD_REL
  (0.1; bf16 gradients through 28 layers).  One step repeated from the
  same state, remat off and the other policy ("full" beside "dots",
  "dots" beside "full") give loss and gradients bit-equal to the
  config's own.  B1's launches exactly 22 L + 3 a step (29 L + 3 under
  "full"), none under "xla", and no torch GEMM but the ``bmm`` of the
  attention, the SSD and the experts (and the moe router's product) on
  the Morton path.  f32 at 2
  layers: every gradient leaf within TRAIN_F32_REL (1e-3) of the plain
  versions' largest magnitude.  Through the CLI (SMOKE): a run with a
  failure injected ends with the clean run's loss and parameters bit
  for bit; the resumed run ends at optimizer count 12; B1's launches
  exact.
* The families: each arch's B1 decode shapes (bf16 and f32; hymba's N
  = 3257 on the tile path) and, where it serves paged, B2 at its head
  width within the bounds above, two B1 launches bit-equal; its serving
  runs' launches exact (B1_PER_LAYER a layer: the moe's experts are
  torch einsums, as they are XLA in the reference), every logit row
  finite; its decode step within LOGIT_BOUND of the plain versions.
  Training per arch: B1's forward, dgrad and wgrad at one layer's shapes
  (hymba's dgrad at K = 3257) within B1's bounds and bit-equal twice;
  then qwen3's gates but the falling loss (2 steps): the step-0 loss,
  |loss Morton - "xla"| at both steps, the step-0 gradients within
  TRAIN_GRAD_REL, the step repeated and the remat policies bit-equal,
  B1's launches a step exactly ``train_launches_per_step`` (moe 12 L +
  3; ssm and hybrid under remat "full" 8 L + 3 and 37 L + 3), none
  under "xla".  The moe's gradient gate holds Morton to "xla" under the
  top-k "xla" chose (``pinned_routing``): a bf16 difference that flips
  a token's top-8 moves the router's gradient by more than any kernel
  rounding, so the unpinned error, printed beside, measures the flips.
* The frontends: hubert's B1 encode shapes and llava's ``frontend_proj``
  (bf16 and f32) within B1's bounds and two launches bit-equal; an
  encode's launches exactly 7 L + 2 B1 under Morton and none under
  "xla", its logits finite and, under Morton, within LOGIT_BOUND of the
  same encode on the plain versions (the "xla" error printed); llava's
  serving runs' and decode steps' launches exact (7 B1 a layer, as
  dense: serving takes no vision prefix), its steps within LOGIT_BOUND
  and its f32 layouts check within LOGIT_BOUND_F32; both archs' training
  under the families' gates, B1's launches a step exactly
  ``train_launches_per_step`` with ``frontend_proj``'s forward and
  wgrad (hubert 22 L + 5 under "dots", llava 29 L + 5 under "full").
* The distributed layer: B1 at the shard shapes within B1's bounds
  (decode bf16 and f32, bit-equal twice; chunk bf16), B2 at the local
  kv-heads within B2's bounds, both dtypes; the --mesh 1,1,1 train
  step's losses within DIST_LOSS_REL (1e-3) of the unsharded step's,
  both with ``train_launches_per_step`` B1 launches a step; the sharded
  serve step's logits within LOGIT_BOUND of the unsharded step's at
  every one of its 8 steps, its greedy tokens equal, its launches 7 L +
  1 B1 (and L B2 paged) a step as the unsharded step's.
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
KV_BOUND = 0.25                # one bf16 prefill chunk's K/V, see above
KV_BOUND_F32 = 1e-3            # the same chunk with f32 weights
B2_SLOT_REL = 3e-2             # B2 per slot, against its largest output
SLEEP_CYCLES = 2_000_000       # ~1 ms at the H100's 1.98 GHz boost clock
NVML_IDLE_S = 2.0              # idle read of the NVML energy counter
ENERGY_WINDOW_S = 2.0          # least work in one metered study window
ENERGY_WINDOWS = 3             # windows per study variant, in turns
TUNER_TOPK = 10_000            # the tuner measures every candidate

SLOTS = 4
PAGE_SIZE = 16
CACHE_LEN = 64
MAX_NEW = 16
N_REQUESTS = 6                 # > SLOTS: two requests wait in the queue
PREFILL_BUDGET = 32            # continuous mode: prompt tokens per step
# the prefix-sharing run: a 64-token prefix, tails of these lengths, a
# cache long enough for prefix + tail + MAX_NEW
SHARED_PREFIX = 64
SHARED_TAILS = (7, 19, 30)
SHARED_CACHE_LEN = 128
# B2 is also checked and timed at these contexts (tokens per slot, 4
# slots): 32768 is qwen3-1.7b's native context
LONG_CONTEXTS = (512, 4096, 32768)

# mellum2-12b-a2.5b (mellum2_phase), at the benchmark's codectx shapes:
# B5 at a decode step's routed tokens (at most 8: its 8-row tiles) and a
# chunk's prompt tokens (256: its 64-row tiles); B2 at 8 rows whose keys
# are the cell's prompt lengths, the 8 quantiles of a log-uniform law on
# 2048-8192 tokens.  Its served run: 4 slots, 16-token pages, 256 prompt
# tokens a step, 3 of the 4 prompts longer than the 1024-key window
MELLUM = "mellum2_12b_a2_5b"
MELLUM_B5_TOKENS = (("decode", 7), ("chunk", 256))
MELLUM_KEYS = tuple(round(2048 * 4 ** ((i + 0.5) / 8)) for i in range(8))
MELLUM_PAGES = 521                 # codectx's cache_len 8320 / 16 + 1
MELLUM_PROMPTS = (2233, 1400, 1100, 600)
MELLUM_NEW = 8
MELLUM_CACHE_LEN = 2304
MELLUM_BUDGET = 256
B5_BF16 = 2e-2          # B5's bf16 outputs (atol = rtol): one rounding
B5_F32 = 1e-3           # B5's f32 outputs: f32 order over K <= 2304

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
# B1 launches a layer of a decode step and of a prefill chunk, by family:
# the attention's wq, wk, wv, wo; the SSD's in_proj and out_proj; the
# SwiGLU MLP's w1, w3, w2 (the moe's experts are torch einsums, as they
# are XLA in the reference); the vlm's and the encoder's layers are dense
B1_PER_LAYER = {"dense": 7, "moe": 4, "ssm": 2, "hybrid": 9, "vlm": 7,
                "encoder": 7}
# the families whose layers end in a SwiGLU MLP
MLP_FAMILIES = ("dense", "hybrid", "vlm", "encoder")


def main_path_gemms(cfg):
    """(name, M, K, N, epilogue, out f32, launches per decode step) of
    every B1 call one decode step makes at full width, by family: the
    attention's projections (the hybrid's out-projection takes no
    residual), the SSD's in_proj and out_proj, the SwiGLU MLP's three,
    and the vocab head."""
    d, v, n_l = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    rows = []
    if cfg.has_attention:
        hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
        wo = ("wo", "none") if cfg.family == "hybrid" \
            else ("wo+res", "residual")
        rows += [("wq", SLOTS, d, hd, "none", False, n_l),
                 ("wk|wv", SLOTS, d, kvd, "none", False, 2 * n_l),
                 (wo[0], SLOTS, hd, d, wo[1], False, n_l)]
    if cfg.has_ssm:
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        proj = 2 * d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        rows += [("in_proj", SLOTS, d, proj, "none", False, n_l),
                 ("out_proj", SLOTS, d_inner, d, "none", False, n_l)]
    if cfg.family in MLP_FAMILIES:
        f = cfg.d_ff
        rows += [("w1+silu", SLOTS, d, f, "silu", False, n_l),
                 ("w3", SLOTS, d, f, "none", False, n_l),
                 ("w2+res", SLOTS, f, d, "residual", False, n_l)]
    rows.append(("head->f32", SLOTS, d, v, "none", True, 1))
    assert sum(r[-1] for r in rows) == B1_PER_LAYER[cfg.family] * n_l + 1
    return rows


def chunk_gemms(cfg):
    """(name, M, K, N, epilogue, out f32, launches per chunk step) of
    every B1 call one prefill chunk makes at full width: M = SLOTS x
    PREFILL_BUDGET rows (the tile path), every projection but the head."""
    m = SLOTS * PREFILL_BUDGET
    return [(name, m, k, n, ep, f32, count)
            for name, _, k, n, ep, f32, count in main_path_gemms(cfg)
            if name != "head->f32"]


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


def b1_check(rep: Report, gen, label, m, k, n, dtype, epilogue,
             out_f32=False, schedule="morton", use_prefetch=True,
             blk=(128, 128, 128)) -> float:
    """B1 against its plain version on inputs drawn from ``gen``, within
    B1's f32 or bf16 bound (the docstring); returns the max error."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_cuda, \
        sfc_matmul_plain, tile_schedule

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
    return rep.check(name, got, want, *tol)


def b1_same_twice(rep: Report, gen, label, m, k, n, dtype, epilogue,
                  out_f32=False) -> None:
    """Two B1 launches on the same inputs must agree bit for bit."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_cuda

    a, b, kw = _gemm_inputs(m, k, n, dtype, gen, epilogue)
    out_dtype = torch.float32 if out_f32 else None
    one = sfc_matmul_cuda(a, b, out_dtype=out_dtype, **kw)
    two = sfc_matmul_cuda(a, b, out_dtype=out_dtype, **kw)
    same = torch.equal(one, two)
    label = f"B1 {label} {m}x{k}x{n} {str(dtype)[6:]}"
    print(f"  {'ok  ' if same else 'FAIL'} {label}: two launches equal bit "
          f"for bit")
    if not same:
        rep.failures.append(f"{label} run to run")


def check_kernels(cfg) -> dict:
    """Phase 2: every kernel against its plain version at the main-path
    shapes (and the variants around them).  Returns max errors."""
    import torch

    rep = Report()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs = {"B1": 0.0}

    def gemm_case(label, m, k, n, dtype, epilogue, out_f32=False,
                  schedule="morton", use_prefetch=True, blk=(128, 128, 128),
                  generator=gen):
        errs["B1"] = max(errs["B1"], b1_check(
            rep, generator, label, m, k, n, dtype, epilogue, out_f32,
            schedule, use_prefetch, blk))

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
            b1_same_twice(rep, gen, name, m, k, n, dtype, ep, f32)
    # a prefill chunk's GEMMs (M = 128, the tile path), from a generator
    # of their own so the later phases draw the inputs they always drew
    print("[kernels] B1 at a prefill chunk's shapes (tile path)")
    gen_chunk = torch.Generator(device="cuda").manual_seed(4321)
    for name, m, k, n, ep, f32, _ in chunk_gemms(cfg):
        for dtype in (torch.bfloat16, torch.float32):
            gemm_case(name, m, k, n, dtype, ep, f32, generator=gen_chunk)
            b1_same_twice(rep, gen_chunk, name, m, k, n, dtype, ep)
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
def checked_loop(cfg, params, sc, power=None, **kw):
    """A ServeLoop whose sampler first checks each logit row (finite),
    and which marks each decode step and each prefill chunk with CUDA
    events (no host sync added): the device-timeline span of each.
    ``power`` meters every step (default: the loop's own detection);
    ``kw`` (metrics, tracer) go to the loop."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import DotEngine

    class CheckedLoop(ServeLoop):
        rows_checked = 0

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.marks = {"decode": [], "chunk": []}

        def _sample(self, logits_row):
            if not np.isfinite(logits_row).all():
                raise SystemExit("chip_smoke: non-finite logits in serving")
            self.rows_checked += 1
            return super()._sample(logits_row)

        def _mark(self, kind, fn, *a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.marks[kind].append((s, e, out))
            return out

        def _step(self, *a, **kw):
            return self._mark("decode", super()._step, *a, **kw)

        def _prefill_step(self):
            return self._mark("chunk", super()._prefill_step)

        def spans_ms(self, kind):
            """ms of each marked call (chunks: those that prefilled)."""
            return [s.elapsed_time(e) for s, e, out in self.marks[kind]
                    if kind == "decode" or out]

    return CheckedLoop(cfg, params, sc, engine=DotEngine(schedule="morton"),
                       power_backend=power, device="cuda", **kw)


def serving_prompts(cfg):
    """The serving phases' 6 requests: 16-32 random prompt tokens."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(2, cfg.vocab, size=int(n)).tolist()
            for n in rng.integers(16, 33, size=N_REQUESTS)]


def _kernel_launches():
    import repro_torch.kernels.paged_attention as pa_mod
    import repro_torch.kernels.sfc_matmul as sfc_mod
    return {"B1": sfc_mod.launches, "B2": pa_mod.launches}


def _zero_launches():
    import repro_torch.kernels.paged_attention as pa_mod
    import repro_torch.kernels.sfc_matmul as sfc_mod
    sfc_mod.launches = 0
    pa_mod.launches = 0


def want_launches(cfg, loop) -> dict:
    """B1 and B2 launches of a serving run: the family's projections a
    layer (``B1_PER_LAYER``) and the head per decode step, the
    projections a layer per prefill chunk, one B2 a layer per paged
    decode step (the contiguous decode attention is torch)."""
    n_l = cfg.n_layers
    n = B1_PER_LAYER[cfg.family] * n_l
    return {"B1": loop.steps * (n + 1) + loop.chunk_steps * n,
            "B2": loop.steps * n_l if loop.paged else 0}


class TimedNvml:
    """The NVML backend the serving loop is given, its counter read on a
    sampling thread (``poll_s=NVML_POLL_S``, as ``detect_backend``
    builds it), with the host time of its ``start``/``stop`` counted:
    the cost the meter adds to each serving step."""

    def __init__(self):
        from repro_torch.power import NVML_POLL_S, NvmlBackend
        self.inner = NvmlBackend(poll_s=NVML_POLL_S)
        self.name = self.inner.name
        self.primary_domains = self.inner.primary_domains
        self.seconds = 0.0
        self.calls = 0

    def start(self):
        t0 = time.perf_counter()
        tok = self.inner.start()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        if tok[0][0] is None:
            raise SystemExit("chip_smoke: the NVML energy counter stopped "
                             "answering during serving")
        return tok

    def stop(self, token, elapsed_s, hints=None):
        t0 = time.perf_counter()
        out = self.inner.stop(token, elapsed_s, hints)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    def close(self):
        self.inner.close()


def serve_energy(loop, power: TimedNvml, run, gen_tokens: int,
                 tag: str) -> dict:
    """The serving run's joules (NVML, the card): the steps' total, per
    generated token, the shares of decode steps, chunks and lockstep
    prefills, sum(request_joules) against the report's total (equal
    within 1e-6 relative, or the run fails), and the whole run's own
    reading ``run`` (the steps' windows leave out the host work between
    steps)."""
    totals = loop.energy.totals()
    joules = totals["joules"]
    by_label = {}
    for r in loop.energy.readings:
        by_label[r.label] = by_label.get(r.label, 0.0) + r.joules
    charged = sum(loop.request_joules.values())
    if loop.energy.backend != "nvml" or joules <= 0 or \
            abs(charged - joules) > 1e-6 * joules:
        raise SystemExit(f"chip_smoke: {tag} energy report backend "
                         f"{loop.energy.backend}, {joules} J, requests "
                         f"charged {charged} J")
    steps = len(loop.energy.readings)
    rec = {"joules": joules, "j_per_token": joules / gen_tokens,
           "mean_watts": joules / totals["seconds"],
           "share": {k: v / joules for k, v in by_label.items()},
           "request_joules_sum": charged, "readings": steps,
           "zero_readings": sum(1 for r in loop.energy.readings
                                if r.joules == 0.0),
           "nvml_us_per_step": power.seconds * 1e6 / max(steps, 1),
           "nvml_us_per_call": power.seconds * 1e6 / max(power.calls, 1),
           "nvml_share_of_wall": power.seconds / run.seconds,
           "run_joules": run.joules, "run_seconds": run.seconds,
           "run_j_per_token": run.joules / gen_tokens,
           "run_watts": run.watts,
           "steps_share_of_run": joules / run.joules}
    print(f"{tag} energy (nvml, the card): {joules:.3f} J over {steps} "
          f"metered steps, {rec['j_per_token']:.4f} J per generated token, "
          f"{rec['mean_watts']:.1f} W mean; shares "
          + ", ".join(f"{k} {v:.1%}" for k, v in rec["share"].items())
          + f"; requests charged {charged:.6f} J (equal to the total); "
          f"{rec['zero_readings']} steps read 0 J (the counter's update "
          f"interval); NVML {rec['nvml_us_per_step']:.1f} us a step "
          f"({rec['nvml_share_of_wall']:.1%} of the run); the whole run "
          f"{run.joules:.3f} J in {run.seconds:.3f} s ({run.watts:.1f} W, "
          f"{rec['run_j_per_token']:.4f} J per token), the steps "
          f"{rec['steps_share_of_run']:.1%} of it")
    return rec


def serve(cfg, params, mode: str = "lockstep", layout: str = "paged",
          prompts=None, max_new: int = MAX_NEW, tag: str | None = None) -> dict:
    """Phase 3: full-width serving through the kernels, lockstep or
    continuous (chunked prefill under PREFILL_BUDGET, prefix sharing on
    when paged), in ``layout``, the N_REQUESTS requests of
    ``serving_prompts`` unless ``prompts`` are given, every step metered
    on NVML (the card's energy counter)."""
    import torch

    from repro_torch.serve import ServeConfig

    if tag is None:
        tag = "[serve]" if mode == "lockstep" else f"[serve {mode}]"
    sc = ServeConfig(slots=SLOTS, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                     eos_id=-1, layout=layout, mode=mode,
                     prefill_budget=PREFILL_BUDGET, seed=0)
    from repro_torch.power import EnergyMeter, NvmlBackend

    power = TimedNvml()
    loop = checked_loop(cfg, params, sc, power)
    prompts = prompts or serving_prompts(cfg)
    n_req = len(prompts)
    for r, p in enumerate(prompts):
        loop.submit(r, p)
    torch.cuda.synchronize()
    _zero_launches()
    # the whole run on a meter of its own: the steps' readings against it
    with EnergyMeter("run", backend=NvmlBackend()) as run_em:
        t0 = time.perf_counter()
        out = loop.run(max_new=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _kernel_launches()
    steps, chunks = loop.steps, loop.chunk_steps
    want = want_launches(cfg, loop)
    print(f"{tag} {cfg.name}, {layout}, {n_req} requests, prompts "
          f"{[len(p) for p in prompts]}, max_new {max_new}, {SLOTS} slots, "
          f"admission order {loop.admitted}, {loop.preemptions} preemptions")
    if mode == "lockstep":
        print(f"{tag} {steps} decode_step calls ({sum(len(p) for p in prompts)}"
              f" prefill tokens); launches B1 {launches['B1']} (want "
              f"{want['B1']}), B2 {launches['B2']} (want {want['B2']})")
    else:
        per = loop.prefill_tokens_per_step
        print(f"{tag} {steps} decode_step calls and {chunks} prefill chunks "
              f"of {SLOTS}x{PREFILL_BUDGET} ({sum(per)} prefill tokens, "
              f"at most {max(per)} a step: {[n for n in per if n]}); "
              f"launches B1 {launches['B1']} (want {want['B1']}), B2 "
              f"{launches['B2']} (want {want['B2']})")
        if max(per) > PREFILL_BUDGET:
            raise SystemExit(f"chip_smoke: a step prefilled {max(per)} > "
                             f"{PREFILL_BUDGET} tokens")
    if launches != want:
        raise SystemExit(f"chip_smoke: launch counts {launches} != {want}")
    for r, p in enumerate(prompts):
        if len(out[r]) != len(p) + max_new or out[r][:len(p)] != p:
            raise SystemExit(f"chip_smoke: request {r} returned "
                             f"{len(out[r])} tokens")
    if loop.rows_checked != n_req * max_new:
        raise SystemExit("chip_smoke: not every sampled row was checked")
    if loop.paged:
        loop.alloc.check_invariants()
        if loop.alloc.pages_in_use:
            raise SystemExit(f"chip_smoke: {loop.alloc.pages_in_use} pages "
                             f"still in use after the drain")
    gen_tokens = n_req * max_new
    decode_ms = loop.spans_ms("decode")
    chunk_ms = loop.spans_ms("chunk")
    power.close()
    energy = serve_energy(loop, power, run_em.reading, gen_tokens, tag)
    return {"mode": mode, "layout": layout, "arch": cfg.name,
            "launches": launches, "steps": steps, "energy": energy,
            "chunk_steps": chunks, "wall_s": wall, "tokens": gen_tokens,
            "tok_per_s": gen_tokens / wall,
            "ms_per_step": wall * 1e3 / (steps + chunks),
            "ms_per_decode_step": sum(decode_ms) / len(decode_ms),
            "ms_per_chunk_step": (sum(chunk_ms) / len(chunk_ms)
                                  if chunk_ms else None),
            "out": out, "prompts": prompts}


def token_agreement(lock: dict, cont: dict) -> list[int]:
    """Per request: generated tokens of the continuous run equal to the
    lockstep run's at the same index (printed, not gated: the chunk's
    tile-path GEMMs and the decode's rows path sum bf16 products in
    different orders, so greedy tokens may part at a near tie)."""
    agree = []
    for r, p in enumerate(lock["prompts"]):
        a, b = lock["out"][r][len(p):], cont["out"][r][len(p):]
        agree.append(sum(x == y for x, y in zip(a, b)))
    first = [next((i for i, (x, y) in enumerate(zip(
        lock["out"][r][len(p):], cont["out"][r][len(p):])) if x != y), None)
        for r, p in enumerate(lock["prompts"])]
    print(f"[serve] continuous against lockstep: generated tokens agreeing "
          f"per request {agree} of {MAX_NEW} (first difference at "
          f"{first}; printed, not gated)")
    return agree


def serve_shared(cfg, params) -> dict:
    """Phase 3b: prefix sharing at full width.  One prompt of a
    SHARED_PREFIX-token prefix and a tail (several chunks) is served
    until it decodes; then its duplicate (a whole-table clone, whose
    first write into the shared tail page forks it) and two prompts of
    the same prefix with other tails (adopted from the prefix index,
    tails prefilled in chunks) arrive, driven through the loop's
    scheduler iterations.  Checks hits, shared pages, forks, launch
    counts, the budget and the allocator's invariants."""
    import numpy as np
    import torch

    from repro_torch.serve import ServeConfig

    sc = ServeConfig(slots=SLOTS, cache_len=SHARED_CACHE_LEN,
                     page_size=PAGE_SIZE, eos_id=-1, layout="paged",
                     mode="continuous", prefill_budget=PREFILL_BUDGET,
                     prefix_sharing=True, seed=0)
    loop = checked_loop(cfg, params, sc)
    rng = np.random.default_rng(64)
    prefix = rng.integers(2, cfg.vocab, size=SHARED_PREFIX).tolist()
    tails = [rng.integers(2, cfg.vocab, size=n).tolist()
             for n in SHARED_TAILS]
    source = prefix + tails[0]
    later = [list(source), prefix + tails[1], prefix + tails[2]]
    span = loop.alloc.max_pages_per_slot * PAGE_SIZE
    torch.cuda.synchronize()
    _zero_launches()
    loop.submit(0, source)
    iters = 0
    while not loop.active.any():
        loop._iteration_body(MAX_NEW)
        iters += 1
    for r, p in enumerate(later, start=1):
        loop.submit(r, p)
    out = loop.run(max_new=MAX_NEW)
    torch.cuda.synchronize()
    close = getattr(loop.power, "close", None)   # an NVML sampling thread
    if close is not None:
        close()
    launches = _kernel_launches()
    want = want_launches(cfg, loop)
    st = loop.alloc.stats
    per = loop.prefill_tokens_per_step
    print(f"[serve shared] prompts {[len(source)] + [len(p) for p in later]}"
          f" ({SHARED_PREFIX}-token prefix), the source decoding after "
          f"{iters} iterations; chunk attention span {span} tokens a slot "
          f"({loop.alloc.max_pages_per_slot} pages of {PAGE_SIZE}); "
          f"{loop.steps} decode steps, {loop.chunk_steps} chunks, prefill "
          f"tokens {[n for n in per if n]}; {loop.preemptions} preemptions")
    print(f"[serve shared] prefix_hits {st['prefix_hits']}, shared_pages "
          f"{st['shared_pages']}, cow_forks {st['cow_forks']}, revived "
          f"{st['revived']}; launches B1 {launches['B1']} (want "
          f"{want['B1']}), B2 {launches['B2']} (want {want['B2']}); the "
          f"duplicate's tokens equal its source's: "
          f"{out[1][len(source):] == out[0][len(source):]} (printed, not "
          f"gated)")
    bad = []
    if not (st["prefix_hits"] > 0 and st["shared_pages"] > 0
            and st["cow_forks"] > 0):
        bad.append("no prefix hit, shared page or fork")
    if launches != want:
        bad.append(f"launch counts {launches} != {want}")
    if max(per) > PREFILL_BUDGET:
        bad.append(f"a step prefilled {max(per)} tokens")
    if loop.rows_checked != (len(later) + 1) * MAX_NEW:
        bad.append("not every sampled row was checked")
    try:
        loop.alloc.check_invariants()
    except RuntimeError as e:
        bad.append(str(e))
    if loop.alloc.pages_in_use:
        bad.append(f"{loop.alloc.pages_in_use} pages in use after the drain")
    if bad:
        raise SystemExit(f"chip_smoke: prefix-sharing run failed: {bad}")
    print("[serve shared] allocator invariants hold after the drain")
    return {"stats": dict(st), "steps": loop.steps, "launches": launches,
            "chunk_steps": loop.chunk_steps}


# ------------------------------------------------- observability, faults --
RETRY_SPEC = ("alloc@step=2,step@step=4,kernel@step=6,"
              "straggler@step=8:delay=0.2,power@step=10")
NAN_SPEC = "nan@step=3:req=1"
SNAPSHOT_AT = 8                # iteration of the disk snapshot/restore


def serve_run(cfg, params, mode: str, **fields) -> dict:
    """One full-width run of the serving requests (``ServeConfig``
    fields, the loop's ``metrics``/``tracer`` in ``fields`` too), every
    step metered on NVML; launches read just after the zeroing before
    it and checked against the loop's own step counts (retried steps
    included: a replay relaunches B1 and B2)."""
    import torch

    from repro_torch.serve import ServeConfig

    loop_kw = {k: fields.pop(k) for k in ("metrics", "tracer")
               if k in fields}
    sc = ServeConfig(slots=SLOTS, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                     eos_id=-1, layout="paged", mode=mode,
                     prefill_budget=PREFILL_BUDGET, seed=0, **fields)
    power = TimedNvml()
    loop = checked_loop(cfg, params, sc, power, **loop_kw)
    prompts = serving_prompts(cfg)
    for r, p in enumerate(prompts):
        loop.submit(r, p)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    out = loop.run(max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_launches()
    power.close()
    want = want_launches(cfg, loop)
    if launches != want:
        raise SystemExit(f"chip_smoke: {mode} run {fields}: launch counts "
                         f"{launches} != {want}")
    loop.alloc.check_invariants()
    gen = sum(len(out[r]) - len(p) for r, p in enumerate(prompts)
              if r in out)
    return {"loop": loop, "out": out, "prompts": prompts, "wall_s": wall,
            "tok_per_s": gen / wall, "launches": launches}


def _tokens(run) -> dict:
    return {r: run["out"][r] for r in sorted(run["out"])}


def _latency(loop) -> dict:
    lat = loop.latency_summary()
    keep = ("count", "p50", "p95", "p99", "max")
    return {k: {q: v[q] for q in keep if q in v}
            for k, v in lat.items() if k != "slo"}


def _counters(loop) -> dict:
    return {k: v["value"] for k, v in
            loop.metrics.snapshot()["series"].items()
            if v["type"] == "counter"}


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def serve_obs_phase(cfg, params, smi: str) -> tuple[dict, dict]:
    """Observability at full width.  Lockstep and continuous with obs on
    (a fresh registry and an enabled Tracer): TTFT, TPOT and e2e from
    ``latency_summary`` and the registry's counters; gates: the written
    JSONL validates (the port's validator), the X spans' joules sum to
    the energy report's total within 1e-6 relative, and the tokens equal
    an obs-off run's.  Continuous runs in turns on, off, off, on for
    tok/s."""
    import os
    import tempfile

    from repro_torch.obs import MetricsRegistry, Tracer, load_events, \
        validate_trace

    rec, launches, bad = {"card": smi}, {}, []

    def observed(mode):
        tracer = Tracer()
        run = serve_run(cfg, params, mode, metrics=MetricsRegistry(),
                        tracer=tracer)
        _add(launches, run["launches"])
        loop = run["loop"]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.jsonl")
            tracer.write_jsonl(path)
            errors = validate_trace(load_events(path))
        total = loop.energy.totals()["joules"]
        span_j = sum(e["args"].get("joules", 0.0) for e in tracer.events
                     if e["ph"] == "X")
        if errors:
            bad.append(f"{mode} trace: {errors[:3]}")
        if not (total > 0 and abs(span_j - total) <= 1e-6 * total):
            bad.append(f"{mode} span joules {span_j} != total {total}")
        return run, {"latency_ms": _latency(loop),
                     "counters": _counters(loop),
                     "trace_events": len(tracer.events),
                     "trace_errors": len(errors), "span_joules": span_j,
                     "report_joules": total}

    lock_on, rec["lockstep"] = observed("lockstep")
    lock_off = serve_run(cfg, params, "lockstep", obs=False)
    _add(launches, lock_off["launches"])
    if _tokens(lock_on) != _tokens(lock_off):
        bad.append("lockstep tokens differ with obs on and off")
    rec["lockstep"]["tok_per_s"] = {"on": lock_on["tok_per_s"],
                                    "off": lock_off["tok_per_s"]}
    turns = []
    for on in (True, False, False, True):
        if on:
            run, info = observed("continuous")
            rec.setdefault("continuous", info)
        else:
            run = serve_run(cfg, params, "continuous", obs=False)
            _add(launches, run["launches"])
        turns.append(run)
    if any(_tokens(t) != _tokens(turns[0]) for t in turns):
        bad.append("continuous tokens differ with obs on and off")
    tps = [t["tok_per_s"] for t in turns]
    rec["continuous"]["tok_per_s_turns"] = {"order": "on off off on",
                                            "tok_per_s": tps}
    on_mean, off_mean = (tps[0] + tps[3]) / 2, (tps[1] + tps[2]) / 2
    rec["continuous"]["obs_cost"] = 1 - on_mean / off_mean
    for mode in ("lockstep", "continuous"):
        lat = rec[mode]["latency_ms"]
        print(f"[serve_obs {mode}] " + "; ".join(
            f"{k} n={v['count']} p50 {v.get('p50', 0):.2f} p95 "
            f"{v.get('p95', 0):.2f} p99 {v.get('p99', 0):.2f} max "
            f"{v.get('max', 0):.2f} ms" for k, v in lat.items())
            + f"; {rec[mode]['trace_events']} trace events, valid; span "
            f"joules {rec[mode]['span_joules']:.6f} = report "
            f"{rec[mode]['report_joules']:.6f} J ({smi})")
        print(f"[serve_obs {mode}] counters {rec[mode]['counters']}")
    print(f"[serve_obs] continuous tok/s on, off, off, on: "
          f"{', '.join(f'{t:.2f}' for t in tps)} (obs costs "
          f"{rec['continuous']['obs_cost']:.2%}); lockstep on "
          f"{lock_on['tok_per_s']:.2f}, off {lock_off['tok_per_s']:.2f}; "
          f"tokens equal on and off ({smi})")
    if bad:
        raise SystemExit(f"chip_smoke: serve_obs failed: {bad}")
    return rec, launches


def check_b2_chaos_hook(cfg):
    """B2's host wrapper checks the ``kernel`` chaos point just before
    its launch: an injected fault raises InjectedFault with nothing
    launched (and no device work), at the serving shape."""
    import torch

    import repro_torch.kernels.paged_attention as pa_mod
    from repro_torch.runtime import chaos

    gen = torch.Generator(device="cuda").manual_seed(9)
    q, kp, vp, phys = long_context_inputs(cfg, CACHE_LEN, torch.bfloat16,
                                          gen)
    before = pa_mod.launches
    inj = chaos.ChaosInjector([chaos.ChaosEvent("kernel")])
    with chaos.install(inj):
        try:
            pa_mod.paged_decode_attention_cuda(q, kp, vp, phys,
                                               CACHE_LEN - 1)
        except chaos.InjectedFault:
            raised = True
        else:
            raised = False
    torch.cuda.synchronize()
    if not raised or pa_mod.launches != before or not inj.exhausted():
        raise SystemExit("chip_smoke: B2's kernel chaos point did not raise "
                         "before its launch")
    print("[serve_faults] B2's wrapper raised InjectedFault on an injected "
          "kernel fault, before any launch")


def serve_faults_phase(cfg, params, smi: str) -> tuple[dict, dict]:
    """Serving through faults, continuous mode at full width.
    (a) the retry-only spec RETRY_SPEC: every request's tokens equal the
    clean run's, the schedule is spent, each raising point is counted on
    ``serve.faults.<point>`` (power on ``power.faults``), >= 3 restores,
    the allocator's invariants hold.  (b) NAN_SPEC: request 1 fails with
    "nan", the other 5 finish; their agreement with the clean run is
    printed (a quarantined slot changes later batches, so exact equality
    is not gated).  (c) one snapshot and one restore at SNAPSHOT_AT, in
    memory (device clones) and through ``snapshot_dir`` (the disk),
    timed; after the disk restore the run ends with an uninterrupted
    run's tokens.  Guards on and off in turns for tok/s."""
    import tempfile

    from repro_torch.obs import MetricsRegistry, default_registry

    rec, launches, bad = {"card": smi}, {}, []
    check_b2_chaos_hook(cfg)
    turns = []
    for guards in (True, False, False, True):
        run = serve_run(cfg, params, "continuous", fault_guards=guards)
        _add(launches, run["launches"])
        turns.append(run)
    clean = _tokens(turns[0])
    if any(_tokens(t) != clean for t in turns):
        bad.append("tokens differ with guards on and off")
    tps = [t["tok_per_s"] for t in turns]
    rec["guards_tok_per_s_turns"] = {"order": "on off off on",
                                     "tok_per_s": tps}
    rec["guards_cost"] = 1 - (tps[0] + tps[3]) / (tps[1] + tps[2])

    # (a) faults that are retried: restore and replay, tokens exact
    power_faults = default_registry().counter("power.faults")
    pf0 = power_faults.value
    run = serve_run(cfg, params, "continuous", chaos=RETRY_SPEC,
                    metrics=MetricsRegistry())
    _add(launches, run["launches"])
    loop, c = run["loop"], _counters(run["loop"])
    faults = {p: c.get(f"serve.faults.{p}", 0)
              for p in ("alloc", "step", "kernel", "straggler")}
    faults["power"] = power_faults.value - pf0
    rec["retry"] = {"spec": RETRY_SPEC, "fired": loop.chaos.fired,
                    "faults": faults, "counters": c,
                    "restores": loop.snapshotter.restores,
                    "snapshots": loop.snapshotter.snapshots,
                    "steps": loop.steps, "chunk_steps": loop.chunk_steps,
                    "launches": run["launches"],
                    "tok_per_s": run["tok_per_s"],
                    "tokens_equal_clean": _tokens(run) == clean}
    if _tokens(run) != clean:
        bad.append("retry-spec tokens differ from the clean run's")
    if not loop.chaos.exhausted() or min(faults.values()) < 1:
        bad.append(f"retry spec not spent: fired {loop.chaos.fired}, "
                   f"counted {faults}")
    if loop.snapshotter.restores < 3 or loop.errors:
        bad.append(f"{loop.snapshotter.restores} restores, errors "
                   f"{loop.errors}")

    # (b) the NaN quarantine: one request fails, the others finish
    run = serve_run(cfg, params, "continuous", chaos=NAN_SPEC,
                    metrics=MetricsRegistry())
    _add(launches, run["launches"])
    loop = run["loop"]
    others = [r for r in range(N_REQUESTS) if r != 1]
    agree = {r: sum(x == y for x, y in zip(
        run["out"][r][len(run["prompts"][r]):],
        clean[r][len(run["prompts"][r]):])) for r in others}
    rec["nan"] = {"spec": NAN_SPEC, "errors": loop.errors,
                  "agree_with_clean": agree,
                  "counters": _counters(loop)}
    if loop.errors != {1: "nan"} or any(
            len(run["out"][r]) != len(run["prompts"][r]) + MAX_NEW
            for r in others):
        bad.append(f"nan spec: errors {loop.errors}")

    # (c) one snapshot and one restore, device and disk, timed
    with tempfile.TemporaryDirectory() as tmp:
        sc_run = serve_run_partial(cfg, params, tmp, clean)
    rec["snapshot"] = sc_run
    if not sc_run["tokens_equal_uninterrupted"]:
        bad.append("tokens after the disk restore differ")

    print(f"[serve_faults] guards on, off, off, on: "
          f"{', '.join(f'{t:.2f}' for t in tps)} tok/s (guards cost "
          f"{rec['guards_cost']:.2%}); tokens equal ({smi})")
    r = rec["retry"]
    print(f"[serve_faults] {RETRY_SPEC}: fired {r['fired']}, counted "
          f"{faults}, {r['snapshots']} snapshots, {r['restores']} restores, "
          f"{r['steps']} decode steps and {r['chunk_steps']} chunks "
          f"(retries included), launches {r['launches']}; tokens equal "
          f"the clean run's: {r['tokens_equal_clean']}; "
          f"{r['tok_per_s']:.2f} tok/s")
    print(f"[serve_faults] {NAN_SPEC}: errors {loop.errors}; the others' "
          f"tokens agreeing with the clean run {agree} of {MAX_NEW} "
          f"(printed, not gated)")
    s = rec["snapshot"]
    print(f"[serve_faults] snapshot / restore at iteration {SNAPSHOT_AT}: "
          f"device {s['device_snapshot_ms']:.3f} / "
          f"{s['device_restore_ms']:.3f} ms (host enqueue "
          f"{s['device_snapshot_host_ms']:.3f} / "
          f"{s['device_restore_host_ms']:.3f}), disk "
          f"{s['disk_snapshot_ms']:.3f} / {s['disk_restore_ms']:.3f} ms "
          f"({s['state_mb']:.1f} MB of pool); tokens after the disk restore "
          f"equal the uninterrupted run's: "
          f"{s['tokens_equal_uninterrupted']} ({smi})")
    if bad:
        raise SystemExit(f"chip_smoke: serve_faults failed: {bad}")
    return rec, launches


def serve_run_partial(cfg, params, root: str, clean: dict) -> dict:
    """Phase (c) of serve_faults: a continuous run with
    ``snapshot_dir=root`` driven to SNAPSHOT_AT, one snapshot in each
    form (device clones; device clones plus the disk), the run to its
    end, then a restore in each form (synced around each for the device
    time) and, after the disk restore, the run to its end again: its
    tokens must equal those of the run's first end and of ``clean``, an
    uninterrupted run of the same requests."""
    import torch

    from repro_torch.runtime import ServeSnapshotter
    from repro_torch.serve import ServeConfig

    sc = ServeConfig(slots=SLOTS, cache_len=CACHE_LEN, page_size=PAGE_SIZE,
                     eos_id=-1, layout="paged", mode="continuous",
                     prefill_budget=PREFILL_BUDGET, seed=0,
                     snapshot_dir=root)
    loop = checked_loop(cfg, params, sc)
    for r, p in enumerate(serving_prompts(cfg)):
        loop.submit(r, p)
    for _ in range(SNAPSHOT_AT):
        loop._run_iteration(MAX_NEW)
    mem = ServeSnapshotter(loop)
    disk = ServeSnapshotter(loop, root=root)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rec = {"device_snapshot_ms": synced(lambda: mem.snapshot(SNAPSHOT_AT)),
           "device_snapshot_host_ms": mem.last_snapshot_ms,
           "disk_snapshot_ms": synced(lambda: disk.snapshot(SNAPSHOT_AT)),
           "state_mb": sum(t.numel() * t.element_size()
                           for t in loop.state.values()) / 1e6}
    want = loop.run(max_new=MAX_NEW)
    want = {r: list(t) for r, t in want.items()}
    rec["device_restore_ms"] = synced(mem.restore)
    rec["device_restore_host_ms"] = mem.last_restore_ms
    rec["disk_restore_ms"] = synced(lambda: disk.restore(from_disk=True))
    got = loop.run(max_new=MAX_NEW)
    close = getattr(loop.power, "close", None)
    if close is not None:
        close()
    rec["tokens_equal_uninterrupted"] = got == want == clean
    return rec


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


def build_state(cfg, params, steps: int = 24, layout: str = "paged"):
    """A mid-serving state in ``layout``: 4 slots at ragged positions,
    filled by ``steps`` decode steps (per-row positions) through the
    kernels."""
    import numpy as np
    import torch

    from repro_torch.models import DotEngine, decode_step, init_decode_state
    from repro_torch.serve.paged_kv import init_paged_serving

    if layout == "paged":
        alloc, state = init_paged_serving(cfg, SLOTS, CACHE_LEN,
                                          page_size=PAGE_SIZE, device="cuda")
    else:
        alloc = None
        state = init_decode_state(cfg, SLOTS, CACHE_LEN, layout=layout,
                                  device="cuda")

    def ensure(pos):
        if alloc is not None:
            for s in range(SLOTS):
                alloc.ensure(s, int(pos[s]))
            state["block_tables"] = torch.tensor(alloc.block_table,
                                                 device="cuda")

    rng = np.random.default_rng(7)
    start = np.asarray([0, 5, 11, 17])
    eng = DotEngine(schedule="morton")
    for i in range(steps):
        pos = start + i
        ensure(pos)
        toks = torch.tensor(rng.integers(2, cfg.vocab, size=(SLOTS, 1)),
                            device="cuda")
        decode_step(params, cfg, state, toks,
                    torch.tensor(pos, dtype=torch.int32, device="cuda"), eng)
    pos = start + steps
    ensure(pos)
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
    real = want[..., :cfg.vocab]     # the padded columns read -1e30
    print(f"[step] {cfg.name} ({cfg.n_layers} layers) {state.layout.value} "
          f"{cfg.param_dtype} decode step, kernels vs "
          f"plain versions: max |logit diff| {err:.4e} (bound {bound:g}), "
          f"greedy tokens agree {agree}/{SLOTS}, logit range "
          f"[{float(real.min()):.3f}, {float(real.max()):.3f}]")
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

    return (dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32"), cast(params),
            state_f32(state))


def state_f32(state):
    """A clone of ``state`` with f32 KV pages."""
    st = state.clone()
    for key in ("k_pages", "v_pages"):
        st[key] = st[key].float()
    return st


def chunk_gang(cfg, alloc, state, rows):
    """The inputs of one prefill chunk, (tokens, slots, starts, lengths)
    on the card, for ``rows`` = [(slot, prompt, start, length)], the
    other rows pads (length 0) on spare slots, as the serving loop
    builds them; allocates the pages and uploads the block tables."""
    import numpy as np
    import torch

    toks = np.zeros((SLOTS, PREFILL_BUDGET), np.int32)
    sl, st, ln = (np.zeros(SLOTS, np.int32) for _ in range(3))
    for i, (slot, prompt, start, n) in enumerate(rows):
        alloc.ensure_range(slot, start + n)
        toks[i, :n] = prompt[start:start + n]
        sl[i], st[i], ln[i] = slot, start, n
    spare = iter(s for s in range(SLOTS) if s not in {r[0] for r in rows})
    for i in range(len(rows), SLOTS):
        sl[i] = next(spare)
    state["block_tables"] = torch.tensor(alloc.block_table, device="cuda")
    return tuple(torch.tensor(x, device="cuda") for x in (toks, sl, st, ln))


def chunk_state(cfg, params):
    """A paged state after one prefill chunk through the kernels (slot 0
    positions [0, 16), slot 1 [0, 9)), and the next chunk's inputs:
    slot 0 [16, 32), slot 1 [9, 21), slot 2 [0, 4) and a pad row, 32
    tokens; the first two rows attend back over the first chunk's
    pages."""
    import numpy as np

    from repro_torch.models import DotEngine, prefill_kv_chunk
    from repro_torch.serve.paged_kv import init_paged_serving

    alloc, state = init_paged_serving(cfg, SLOTS, CACHE_LEN,
                                      page_size=PAGE_SIZE, device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, cfg.vocab, size=n).tolist()
               for n in (32, 21, 4)]
    first = chunk_gang(cfg, alloc, state, [(0, prompts[0], 0, 16),
                                           (1, prompts[1], 0, 9)])
    prefill_kv_chunk(params, cfg, state, *first, DotEngine(schedule="morton"))
    second = chunk_gang(cfg, alloc, state, [(0, prompts[0], 16, 16),
                                            (1, prompts[1], 9, 12),
                                            (2, prompts[2], 0, 4)])
    return state, second


def _pool_err(a, b) -> float:
    return max(float((a[key].float() - b[key].float()).abs().max())
               for key in ("k_pages", "v_pages"))


def compare_chunk(cfg, params, state, gang, bound: float) -> dict:
    """Phase 4b: one full-width prefill chunk on the kernels vs on the
    plain versions, from clones of one state: every K/V entry of the
    pool (the chunk writes 32 of 4 slots x 64 positions a layer)."""
    import torch

    from repro_torch.models import DotEngine, prefill_kv_chunk

    eng = DotEngine(schedule="morton")
    got = prefill_kv_chunk(params, cfg, state.clone(), *gang, eng)
    with plain_versions():
        want = prefill_kv_chunk(params, cfg, state.clone(), *gang, eng)
    torch.cuda.synchronize()
    err = _pool_err(got, want)
    finite = all(bool(torch.isfinite(got[k]).all())
                 for k in ("k_pages", "v_pages"))
    top = max(float(want[k].float().abs().max())
              for k in ("k_pages", "v_pages"))
    print(f"[chunk] full-width {cfg.param_dtype} prefill chunk "
          f"({SLOTS}x{PREFILL_BUDGET}, rows {gang[3].tolist()} tokens), "
          f"kernels vs plain versions: max |K/V diff| {err:.4e} over the "
          f"pool (bound {bound:g}; largest |K/V| {top:.3f})")
    if not finite or err > bound:
        raise SystemExit("chip_smoke: prefill chunk disagrees with the "
                         "plain versions")
    return {"max_abs_err": err}


def compare_chunked_single(cfg, params, bound: float) -> float:
    """Phase 4c: a 48-token prompt's K/V from two chunks (32 + 16,
    the other rows pads) against one single-shot ``prefill_kv``, both
    through the kernels."""
    import numpy as np
    import torch

    from repro_torch.models import DotEngine, prefill_kv, prefill_kv_chunk
    from repro_torch.serve.paged_kv import init_paged_serving

    eng = DotEngine(schedule="morton")
    prompt = np.random.default_rng(48).integers(2, cfg.vocab,
                                                size=48).tolist()
    alloc, chunked = init_paged_serving(cfg, SLOTS, CACHE_LEN,
                                        page_size=PAGE_SIZE, device="cuda")
    for start, n in ((0, PREFILL_BUDGET), (PREFILL_BUDGET, 16)):
        gang = chunk_gang(cfg, alloc, chunked, [(0, prompt, start, n)])
        prefill_kv_chunk(params, cfg, chunked, *gang, eng)
    alloc1, single = init_paged_serving(cfg, SLOTS, CACHE_LEN,
                                        page_size=PAGE_SIZE, device="cuda")
    alloc1.ensure_range(0, len(prompt))
    single["block_tables"] = torch.tensor(alloc1.block_table, device="cuda")
    prefill_kv(params, cfg, single, prompt, slot=0, engine=eng)
    torch.cuda.synchronize()
    err = _pool_err(chunked, single)
    same_tables = alloc.state_dict() == alloc1.state_dict()
    print(f"[chunk] {cfg.param_dtype} 48-token prompt, K/V of two chunks "
          f"against one prefill_kv: max |diff| {err:.4e} (bound {bound:g}); "
          f"block tables equal: {same_tables}")
    if err > bound or not same_tables:
        raise SystemExit("chip_smoke: chunked K/V disagree with the single "
                         "shot")
    return err


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

    from repro_torch.kernels.ops import library_matmul
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
    # the "xla" baseline (ops.library_matmul) and its GEMM alone
    xla = {"xla_ms": 0.0, "xla_gemm_ms": 0.0}
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
        x_ms = _time_ms(lambda: library_matmul(a, b, out_dtype=out_dtype,
                                               **kw), 20, flush)
        x_gemm = _time_ms(lambda: torch.mm(a, b, out_dtype=torch.float32),
                          20, flush)
        xla["xla_ms"] += count * x_ms
        xla["xla_gemm_ms"] += count * x_gemm
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
              f"(torch.matmul {nbytes / lib / 1e6:.0f} GB/s); 'xla' "
              f"{x_ms:.4f} ms, of which torch.mm(out_dtype=f32) {x_gemm:.4f}")
        b1["ms"] += count * ms
        b1["plain_ms"] += count * plain
        b1["library_ms"] += count * lib
        b1["bound_ms"] += count * bound

    print(f"[time] per decode step: B1 {b1['ms']:.3f} ms, torch.matmul "
          f"(bf16 out, no epilogue) {b1['library_ms']:.3f} ms, 'xla' "
          f"(ops.library_matmul: bf16 GEMM, f32 out, f32 epilogue, cast) "
          f"{xla['xla_ms']:.3f} ms, of which the GEMMs "
          f"{xla['xla_gemm_ms']:.3f} ms ({smi})")
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


def time_chunk_gemms(cfg, smi: str) -> dict:
    """Phase 5b: B1 per launch at a prefill chunk's shapes (bf16, M =
    128, the tile path) beside its bound, its plain version and
    ``torch.matmul``, L2 flushed; and the sums over one chunk step's
    196 launches.  Returns the ``b1_prefill`` line's object."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_cuda, \
        sfc_matmul_plain, tile_schedule

    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    gen = torch.Generator(device="cuda").manual_seed(128)
    rows = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "bytes": 0, "flop": 0.0, "launches": 0}
    print(f"[time] B1 sfc_matmul per launch at a prefill chunk's shapes, "
          f"bf16, morton table, tile path ({smi})")
    for name, m, k, n, ep, f32, count in chunk_gemms(cfg):
        a, b, kw = _gemm_inputs(m, k, n, torch.bfloat16, gen, ep)
        sched = tile_schedule("morton", -(-m // 128), -(-n // 128),
                              use_prefetch=True, device="cuda")
        ms = _time_ms(lambda: sfc_matmul_cuda(a, b, **kw), 20, flush)
        plain = _time_ms(lambda: sfc_matmul_plain(
            a, b, sched=sched, bm=128, bn=128, bk=128, **kw), 3, flush)
        lib = _time_ms(lambda: torch.matmul(a, b), 20, flush)
        nbytes = (m * k + k * n + m * n) * 2 + \
            (m * n * 2 if ep == "residual" else 0)
        flop = 2.0 * m * n * k
        bound = max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flop / BF16_FLOPS_PER_S \
            else "operations"
        print(f"  {name:10s} {m}x{k}x{n}: kernel {ms:.4f} ms "
              f"({flop / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"torch.matmul {lib:.4f} ms ({flop / lib / 1e9:.2f} TFLOP/s), "
              f"bound {bound:.4f} ms ({by}); x{count} per chunk step; "
              f"{ms / lib:.2f}x torch.matmul")
        rows.append({"name": name, "m": m, "k": k, "n": n,
                     "launches_per_chunk_step": count, "ms": ms,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "bound_by": by})
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain
        tot["library_ms"] += count * lib
        tot["bound_ms"] += count * bound
        tot["bytes"] += count * nbytes
        tot["flop"] += count * flop
        tot["launches"] += count
    print(f"[time] B1 per prefill chunk step ({tot['launches']} launches, "
          f"{tot['bytes'] / 1e6:.1f} MB, {tot['flop'] / 1e9:.1f} GFLOP): "
          f"kernel {tot['ms']:.3f} ms ({tot['flop'] / tot['ms'] / 1e9:.2f} "
          f"TFLOP/s), torch.matmul {tot['library_ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms; kernel "
          f"{tot['ms'] / tot['library_ms']:.2f}x torch.matmul, "
          f"{tot['bound_ms'] / tot['ms']:.1%} of the bound ({smi})")
    return {"b1_prefill": {"per_launch": rows, "per_chunk_step": tot,
                           "card": smi}}


def profile_chunk(cfg, params, state, gang, smi: str, n: int = 3) -> dict:
    """Phase 6b: where a prefill chunk step's time goes on the card, from
    a torch.profiler trace of ``n`` chunks on one state (device time by
    kernel, device busy share of the traced wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import DotEngine, prefill_kv_chunk

    eng = DotEngine(schedule="morton")
    st = state.clone()
    prefill_kv_chunk(params, cfg, st, *gang, eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        prefill_kv_chunk(params, cfg, st, *gang, eng)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            prefill_kv_chunk(params, cfg, st, *gang, eng)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) / n
    by_kernel: dict[str, float] = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = float(e.self_device_time_total)
        if us > 0:
            name = e.key.replace("(anonymous namespace)::", "")[:72]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / n
    busy = sum(by_kernel.values())
    print(f"[profile] prefill chunk step ({smi}): {plain_wall * 1e3:.3f} ms "
          f"wall untraced, {traced_wall * 1e3:.3f} ms traced; device busy "
          f"{busy:.3f} ms per chunk = {busy / (traced_wall * 1e3):.1%} of "
          f"the traced wall (idle share {1 - busy / (traced_wall * 1e3):.1%})")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.4f} ms/chunk  {ms / busy:6.1%}  {name}")
    return {"wall_ms": plain_wall * 1e3, "traced_ms": traced_wall * 1e3,
            "busy_ms": busy}


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


# ------------------------------------------------------------- energy ----
def nvml_phase(smi: str) -> dict:
    """Phase 1b: the card's energy counter, read through the port's
    ``NvmlBackend`` (ctypes over ``libnvidia-ml.so.1``), built
    directly and through ``detect_backend("nvml")``.  With the card
    idle, reads the cumulative counter in a loop for NVML_IDLE_S: its
    update interval (median time between changes), the idle watts (mJ
    between the first and last change over that time) and the host cost
    of one read.  Fails if the library, the handle or the counter is
    missing, or if the counter does not move."""
    import torch

    from repro_torch.power import NvmlBackend, detect_backend

    direct = NvmlBackend()
    named = detect_backend("nvml")
    auto = detect_backend()
    bad = [f"{b.name} {b.primary_domains}" for b in (direct, named)
           if b.name != "nvml" or b.primary_domains[:1] != ("gpu0",)]
    if bad:
        raise SystemExit(f"chip_smoke: NVML backend missing: {bad}")
    handle = direct._handles[0]
    torch.cuda.synchronize()
    samples = []
    t_end = time.perf_counter() + NVML_IDLE_S
    while time.perf_counter() < t_end:
        samples.append((time.perf_counter(), direct._energy_mj(handle)))
    if any(e is None for _, e in samples):
        raise SystemExit("chip_smoke: NVML has no total-energy counter")
    changes = [(t, e) for (t, e), (_, prev) in zip(samples[1:], samples)
               if e != prev]
    if len(changes) < 2:
        raise SystemExit(f"chip_smoke: the NVML energy counter moved "
                         f"{len(changes)} times in {NVML_IDLE_S} s")
    gaps = sorted(b[0] - a[0] for a, b in zip(changes, changes[1:]))
    interval = gaps[len(gaps) // 2]
    idle_w = (changes[-1][1] - changes[0][1]) * 1e-3 / \
        (changes[-1][0] - changes[0][0])
    power_w = direct._power_w(handle)
    rec = {"backend": direct.name, "domain": direct.primary_domains[0],
           "auto_detected": auto.name, "update_interval_ms": interval * 1e3,
           "updates": len(changes), "idle_watts": idle_w,
           "power_usage_watts": power_w,
           "read_us": NVML_IDLE_S * 1e6 / len(samples),
           "counter_mj": changes[-1][1]}
    print(f"[nvml] NvmlBackend and detect_backend('nvml'): backend nvml, "
          f"domain gpu0 (auto-detection picks {auto.name!r}); idle "
          f"{NVML_IDLE_S} s: counter updated {len(changes)} times, every "
          f"{interval * 1e3:.1f} ms (median), idle {idle_w:.2f} W "
          f"(nvmlDeviceGetPowerUsage {power_w} W), one read "
          f"{rec['read_us']:.2f} us ({smi})")
    return rec


STUDY_VARIANTS = (("rowmajor", True), ("morton", True), ("morton", False),
                  ("hilbert", True), ("hilbert", False))


def wait_tick(nvml) -> None:
    """Return just after NVML's energy counter next updates (it moves
    every ~100 ms: a window that starts and ends on an update holds no
    part-interval of the counter)."""
    h = nvml._handles[0]
    e = nvml._energy_mj(h)
    while nvml._energy_mj(h) == e:
        pass


def study_energy(b3_in, idle_w: float, smi: str) -> tuple[dict, int]:
    """Phase 9: the paper's energy experiment on the card.  B3 through
    ``DotEngine.dot_batched`` at the study's shapes (f32, TF32 off) in
    row-major, Morton and Hilbert order, Morton and Hilbert also by
    closed-form decode (``use_prefetch=False``).  Each variant's
    launches repeat inside one ``EnergyMeter`` window on NVML of at
    least ENERGY_WINDOW_S of work; ENERGY_WINDOWS windows per variant,
    taken in turns across variants and shapes, each turn starting one
    variant later (the card warms over the phase, and a variant's place
    in a turn would otherwise bias it).  A window opens just
    after a counter update and closes just after the first update past
    the work's end (``wait_tick``); the card's idle draw (``idle_w``,
    the NVML phase's) over the window's time outside the work is taken
    off.  Per variant: J per launch, mean W, EDP per launch, J per
    GFLOP, the windows' spread, its joules against row-major's in the
    same turn (each turn's ratio and their mean), and the H100
    ModelBackend's (unfitted) joules for the same hints and work time.
    Returns the ``study_energy`` line's object and the B3 launches."""
    import torch

    import repro_torch.kernels.sfc_matmul as sfc_mod
    from repro_torch.models import DotEngine
    from repro_torch.power import EnergyMeter, ModelBackend, NvmlBackend, \
        WorkloadHints

    paper, _, _ = paper_study()
    tile = paper.block
    nvml, model = NvmlBackend(), ModelBackend()
    engines = {(sched, pf): DotEngine(schedule=sched, block=(tile,) * 3,
                                      use_prefetch=pf)
               for sched, pf in STUDY_VARIANTS}
    plan, bad = {}, []
    for shape, (a, b) in b3_in.items():
        ref = torch.bmm(a, b)
        for key, eng in engines.items():
            out = eng.dot_batched(a, b)
            err = float((out - ref).abs().max())
            if not (bool(torch.isfinite(out).all())
                    and err <= 1e-4 + 1e-4 * float(ref.abs().max())):
                bad.append(f"{shape} {key}")
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(3):
                eng.dot_batched(a, b)
            e.record()
            e.synchronize()
            per = s.elapsed_time(e) / 3e3
            plan[(shape, key)] = max(1, int(ENERGY_WINDOW_S / per) + 1)
    if bad:
        raise SystemExit(f"chip_smoke: study energy outputs wrong: {bad}")
    torch.cuda.synchronize()
    sfc_mod.batched_launches = 0
    readings = {k: [] for k in plan}
    variants = list(engines.items())
    for turn in range(ENERGY_WINDOWS):
        for si, (shape, (a, b)) in enumerate(b3_in.items()):
            bsz, m, k, n = shape
            rot = (turn + si) % len(variants)
            for key, eng in variants[rot:] + variants[:rot]:
                reps = plan[(shape, key)]
                hints = WorkloadHints(
                    flops=2.0 * bsz * m * n * k * reps,
                    hbm_bytes=4.0 * bsz * (m * k + k * n + m * n) * reps)
                torch.cuda.synchronize()
                wait_tick(nvml)
                with EnergyMeter(f"B3 {key[0]}", backend=nvml,
                                 hints=hints) as em:
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        eng.dot_batched(a, b)
                    torch.cuda.synchronize()
                    work_s = time.perf_counter() - t0
                    wait_tick(nvml)
                r = em.reading
                work_j = r.joules - idle_w * (r.seconds - work_s)
                predicted = sum(model.stop(None, work_s, hints).values())
                readings[(shape, key)].append(
                    (work_j, work_s, r, reps, predicted))
    torch.cuda.synchronize()
    launches = sfc_mod.batched_launches
    want = sum(plan.values()) * ENERGY_WINDOWS
    if launches != want:
        raise SystemExit(f"chip_smoke: study energy B3 launches {launches} "
                         f"!= {want}")
    rows = []
    print(f"[energy] B3 through DotEngine.dot_batched, f32, {tile}^3 tiles: "
          f"{ENERGY_WINDOWS} NVML windows of >= {ENERGY_WINDOW_S} s of work "
          f"per variant, in turns, each from one counter update to the "
          f"first after the work, less {idle_w:.1f} W idle outside the work "
          f"({smi})")
    for (shape, (sched, pf)), rs in readings.items():
        bsz, m, k, n = shape
        jl = [j / reps for j, _, _, reps, _ in rs]
        sl = [s_ / reps for _, s_, _, reps, _ in rs]
        jpl = sum(jl) / len(jl)
        spl = sum(sl) / len(sl)
        gflop = 2.0 * bsz * m * n * k / 1e9
        pred = sum(p / reps for _, _, _, reps, p in rs) / len(rs)
        row = {"shape": list(shape), "schedule": sched,
               "index": "table" if pf else "closed-form decode",
               "launches_per_window": rs[0][3], "windows": len(rs),
               "j_per_launch": jpl, "ms_per_launch": spl * 1e3,
               "watts": sum(j / s_ for j, s_, _, _, _ in rs) / len(rs),
               "edp_per_launch": jpl * spl, "j_per_gflop": jpl / gflop,
               "spread": (max(jl) - min(jl)) / jpl,
               "j_per_launch_windows": jl,
               "raw_j_per_launch_windows": [r.joules / reps
                                            for _, _, r, reps, _ in rs],
               "idle_tail_s_windows": [r.seconds - s_
                                       for _, s_, r, _, _ in rs],
               "model_j_per_launch": pred}
        rows.append(row)
        print(f"  {'x'.join(map(str, shape))} {sched:8s} "
              f"{row['index']:18s}: {jpl:.4f} J/launch "
              f"({row['ms_per_launch']:.4f} ms, {row['watts']:.1f} W, "
              f"{row['j_per_gflop']:.5f} J/GFLOP, EDP {row['edp_per_launch']:.3e}"
              f" J*s), windows spread {row['spread']:.2%}; H100 model "
              f"(unfitted) {pred:.4f} J")
    for shape in b3_in:
        base = next(r for r in rows if r["shape"] == list(shape)
                    and r["schedule"] == "rowmajor")
        for r in rows:
            if r["shape"] == list(shape) and r is not base:
                turns = [j / jb - 1 for j, jb in zip(
                    r["j_per_launch_windows"], base["j_per_launch_windows"])]
                r["vs_rowmajor_turns"] = turns
                r["vs_rowmajor"] = sum(turns) / len(turns)
        print(f"  {'x'.join(map(str, shape))} J against row-major's in the "
              f"same turn, mean [range]: " + ", ".join(
                  f"{r['schedule']} {r['index'].split()[0]} "
                  f"{r['vs_rowmajor']:+.2%} [{min(r['vs_rowmajor_turns']):+.2%}"
                  f", {max(r['vs_rowmajor_turns']):+.2%}]"
                  for r in rows if "vs_rowmajor" in r
                  and r["shape"] == list(shape))
              + f" (row-major's windows spread {base['spread']:.2%})")
    return {"study_energy": rows, "card": smi}, launches


def tuner_phase(cfg, smi: str) -> tuple[dict, dict]:
    """Phase 10: ``schedule="auto"`` on the card.  With a fresh cache
    (a temporary ``REPRO_TUNE_CACHE``), the tuner searches each distinct
    serving GEMM (M = SLOTS, bf16), each chunk GEMM (M = SLOTS x
    PREFILL_BUDGET) and the study's B3 shapes (batched, f32) under
    objective "time" and "edp", measuring every candidate with CUDA
    events (B1/B3 launches, and torch.matmul for "xla").  Every search
    shares the one cache, and none may hit another's entry: on "cuda"
    a decode GEMM (M <= 8, the kernel's rows path) and a chunk GEMM of
    the same N and K have different keys.  Then one
    ``DotEngine(schedule="auto")`` GEMM per serving shape resolves from
    that cache: a curve winner must launch B1 and agree with the plain
    version within B1's bf16 bound; an "xla" winner launches nothing.
    Returns the ``tuner`` line's object and the launches made."""
    import os
    import tempfile

    import torch

    import repro_torch.kernels.sfc_matmul as sfc_mod
    from repro_torch.kernels.ops import library_matmul
    from repro_torch.kernels.ref import matmul_fused_ref
    from repro_torch.kernels.sfc_matmul import sfc_matmul_plain, \
        tile_schedule
    from repro_torch.models import DotEngine
    from repro_torch.tune import EpilogueSpec, GemmSpec, TuneCache, \
        TuneConfig, resolve

    ep_spec = {"none": None, "residual": EpilogueSpec(residual=True),
               "silu": EpilogueSpec(activation="silu")}
    paper, _, b3_shapes = paper_study()
    problems = []
    for group, gemms in (("serve", main_path_gemms(cfg)),
                         ("chunk", chunk_gemms(cfg))):
        for name, m, k, n, ep, _, _ in gemms:
            problems.append((group, name, GemmSpec(
                m, n, k, "bfloat16", epilogue=ep_spec[ep])))
    for bsz, m, k, n in b3_shapes:
        problems.append(("study", f"{bsz}x{m}x{k}x{n}", GemmSpec(
            m, n, k, paper.dtype, batched=True)))
    xla = repr(TuneConfig("xla"))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tune.json")
        old = os.environ.get("REPRO_TUNE_CACHE")
        os.environ["REPRO_TUNE_CACHE"] = path
        try:
            cache = TuneCache(path)
            torch.cuda.synchronize()
            sfc_mod.launches = sfc_mod.batched_launches = 0
            t0 = time.perf_counter()
            for objective in ("time", "edp"):
                for group, name, spec in problems:
                    r = resolve(spec, backend="cuda", cache=cache,
                                objective=objective, search=True,
                                measure=True, topk=TUNER_TOPK)
                    if r.from_cache:
                        raise SystemExit(
                            f"chip_smoke: the {group} GEMM {name} "
                            f"({objective}) hit entry {r.key} of another "
                            f"GEMM in a fresh cache")
                    won = r.config.kernel_config()
                    est = r.best_estimate
                    rows.append({
                        "group": group, "gemm": name, "objective": objective,
                        "mnk": [spec.m, spec.n, spec.k], "dtype": spec.dtype,
                        "winner": r.config.to_dict(),
                        "winner_ms": r.measured[repr(won)] * 1e3,
                        "predicted_ms": est.time * 1e3,
                        "xla_ms": r.measured[xla] * 1e3,
                        "candidates_measured": len(r.measured),
                        "best_kernel_ms": min(
                            (v for c, v in r.measured.items() if c != xla),
                            default=float("nan")) * 1e3})
            search_s = time.perf_counter() - t0
            search = {"B1": sfc_mod.launches, "B3": sfc_mod.batched_launches}
            # one auto GEMM per serving shape, from the "time" winners
            gen = torch.Generator(device="cuda").manual_seed(77)
            checks, bad = [], []
            sfc_mod.launches = 0
            for name, m, k, n, ep, f32, _ in main_path_gemms(cfg):
                a, b, kw = _gemm_inputs(m, k, n, torch.bfloat16, gen, ep)
                od = torch.float32 if f32 else None
                won = next(r["winner"] for r in rows
                           if r["gemm"] == name and r["group"] == "serve"
                           and r["objective"] == "time")
                before = sfc_mod.launches
                out = DotEngine(schedule="auto").dot(a, b, out_dtype=od, **kw)
                torch.cuda.synchronize()
                launched = sfc_mod.launches - before
                if won["schedule"] == "xla":
                    want = library_matmul(a, b, out_dtype=od, **kw)
                    ok = launched == 0 and torch.equal(out, want)
                else:
                    sched = tile_schedule(
                        won["schedule"], -(-m // won["bm"]),
                        -(-n // won["bn"]), use_prefetch=won["use_prefetch"],
                        g=won["g"], device="cuda")
                    want = sfc_matmul_plain(a, b, sched=sched, bm=won["bm"],
                                            bn=won["bn"], bk=won["bk"],
                                            out_dtype=od, **kw)
                    diff = (out.float() - want.float()).abs()
                    ok = launched == 1 and bool(
                        (diff <= 1e-3 + 2 ** -7 * want.float().abs()).all())
                checks.append({"gemm": name, "winner": won["schedule"],
                               "b1_launches": launched, "ok": ok})
                if not ok:
                    bad.append(name)
            engine_b1 = sfc_mod.launches
            # C2: the "xla" baseline (bf16 GEMM, f32 output, f32
            # epilogue) against the plain version at every serving GEMM
            xla_checks = []
            for name, m, k, n, ep, f32, _ in main_path_gemms(cfg):
                a, b, kw = _gemm_inputs(m, k, n, torch.bfloat16, gen, ep)
                od = torch.float32 if f32 else None
                got = library_matmul(a, b, out_dtype=od, **kw)
                want = matmul_fused_ref(a, b, out_dtype=od, **kw).float()
                diff = (got.float() - want).abs()
                row = next(r for r in rows if r["gemm"] == name
                           and r["group"] == "serve"
                           and r["objective"] == "time")
                ok = bool((diff <= 1e-3 + 2 ** -7 * want.abs()).all()) \
                    and got.dtype == (od or torch.bfloat16)
                xla_checks.append({
                    "gemm": name, "xla_ms": row["xla_ms"],
                    "best_kernel_ms": row["best_kernel_ms"],
                    "winner": row["winner"]["schedule"],
                    "max_abs_err": float(diff.max()), "ok": ok})
                if not ok:
                    bad.append(f"xla {name}")
        finally:
            if old is None:
                os.environ.pop("REPRO_TUNE_CACHE", None)
            else:
                os.environ["REPRO_TUNE_CACHE"] = old
    print(f"[tuner] schedule='auto' on the card, fresh cache: "
          f"{len(problems)} GEMMs x 2 objectives searched in {search_s:.1f} s,"
          f" every candidate measured (CUDA events, L2 flushed); launches "
          f"B1 {search['B1']}, B3 {search['B3']} ({smi})")
    for r in rows:
        w = r["winner"]
        print(f"  {r['group']:5s} {r['gemm']:10s} {r['objective']:4s}: "
              f"{w['schedule']}"
              + (f" {w['bm']}x{w['bn']}x{w['bk']}"
                 f"{'' if w['use_prefetch'] else ' decode'}"
                 if w["schedule"] != "xla" else "")
              + f" f{w['f_scale']:g} {r['winner_ms']:.4f} ms (model "
              f"{r['predicted_ms']:.4f}); xla {r['xla_ms']:.4f} ms, best "
              f"kernel {r['best_kernel_ms']:.4f} ms of "
              f"{r['candidates_measured']} measured")
    print(f"[tuner] DotEngine(schedule='auto') per serving shape: "
          + ", ".join(f"{c['gemm']} {c['winner']} (B1 {c['b1_launches']})"
                      f"{'' if c['ok'] else ' FAIL'}" for c in checks))
    print(f"[C2] 'xla' = torch.mm/bmm(bf16, out_dtype=float32) + f32 "
          f"epilogue (torch {torch.__version__}); per serving GEMM, time "
          f"objective: " + "; ".join(
              f"{c['gemm']} xla {c['xla_ms']:.4f} ms vs B1 "
              f"{c['best_kernel_ms']:.4f} ms -> {c['winner']}, max err "
              f"{c['max_abs_err']:.3e}{'' if c['ok'] else ' FAIL'}"
              for c in xla_checks) + f" ({smi})")
    if bad:
        raise SystemExit(f"chip_smoke: auto GEMMs failed: {bad}")
    launches = {"B1": search["B1"] + engine_b1, "B3": search["B3"]}
    return {"tuner": rows, "auto_gemms": checks, "xla_serving": xla_checks,
            "search_s": search_s, "card": smi}, launches

# ------------------------------------------- layouts and dense archs ----
GLM4_REQUESTS = 4              # glm4-9b serving: 4 of the 6 prompts
GLM4_MAX_NEW = 8
F32_CHECK_LAYERS = 4           # deepseek's and llava's f32 layouts check
SWA_CACHE = 4096               # h2o-danube-3-4b's window: one whole ring
SWA_PREFILL = (4092, 4094, 100, 300)
SWA_STEPS = 8                  # rows 0 and 1 wrap, rows 2 and 3 do not


def init_arch(name: str, n_layers: int | None = None):
    """(cfg, params) of a registered arch at full width, random bf16
    weights from seed 0 on the card; ``n_layers`` cuts the depth."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_model

    cfg = get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[init] {cfg.name} full width, {cfg.n_layers} layers, "
          f"{n_bytes / 1e9:.2f} GB bf16 weights on the card in "
          f"{time.perf_counter() - t0:.1f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({resident / 1e9:.2f} GB resident before)")
    return cfg, params


def b2_check(rep: Report, label, q, kp, vp, tab, pos) -> float:
    """B2 against its plain version within its absolute bound and, per
    slot, B2_SLOT_REL of the slot's largest output; two launches equal
    bit for bit.  Returns the max absolute error."""
    import torch

    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    got = paged_decode_attention_cuda(q, kp, vp, tab, pos)
    again = paged_decode_attention_cuda(q, kp, vp, tab, pos)
    want = paged_decode_attention_ref(q, kp, vp, tab, pos)
    torch.cuda.synchronize()
    tol = (2e-5, 0.0) if q.dtype == torch.float32 else (3e-2, 0.0)
    name = f"B2 {str(q.dtype)[6:]} {label}"
    err = rep.check(name, got, want, *tol)
    scaled = slot_scaled_err(got, want)
    same = torch.equal(got, again)
    print(f"  {'ok  ' if scaled <= B2_SLOT_REL and same else 'FAIL'} {name}: "
          f"per slot {scaled:.3e} (bound {B2_SLOT_REL:g}); two launches "
          f"equal bit for bit: {same}")
    if scaled > B2_SLOT_REL or not same:
        rep.failures.append(f"{name} per slot or run to run")
    return err


def check_arch_kernels(cfg, paged: bool, chunk: bool = True) -> dict:
    """B1 against its plain version at ``cfg``'s decode shapes (M =
    SLOTS, bf16 and f32) and, with ``chunk``, its prefill-chunk shapes
    (M = 128, bf16), two launches bit-equal at each decode shape; with
    ``paged``, B2 at its head widths (the serving shape, bf16 and f32).
    Returns max errors."""
    import torch

    rep = Report()
    gen = torch.Generator(device="cuda").manual_seed(2024)
    errs = {"B1": 0.0, "B2": None}
    print(f"[kernels] {cfg.name}: B1 at its decode"
          + (" and chunk" if chunk else "") + " shapes"
          + (", B2 at its head widths" if paged else ""))
    for name, m, k, n, ep, f32, _ in main_path_gemms(cfg):
        for dtype in (torch.bfloat16, torch.float32):
            errs["B1"] = max(errs["B1"], b1_check(rep, gen, name, m, k, n,
                                                  dtype, ep, f32))
        b1_same_twice(rep, gen, name, m, k, n, torch.bfloat16, ep, f32)
    for name, m, k, n, ep, f32, _ in chunk_gemms(cfg) if chunk else ():
        errs["B1"] = max(errs["B1"], b1_check(rep, gen, name, m, k, n,
                                              torch.bfloat16, ep, f32))
    if paged:
        errs["B2"] = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tab = long_context_inputs(cfg, CACHE_LEN, dtype, gen)
            pos = serving_positions()
            errs["B2"] = max(errs["B2"], b2_check(
                rep, f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} serving "
                f"{pos.tolist()}", q, kp, vp, tab, pos))
    rep.raise_if_failed(f"{cfg.name} kernel checks")
    return errs


def time_b1(label: str, rows, flush, iters: int = 20) -> dict:
    """B1 over ``rows`` (name, M, K, N, epilogue, out f32, launches) in
    bf16: per-launch CUDA-event times (L2 flushed) times the launches,
    summed, beside its plain version, ``torch.matmul`` on the same
    operands (bf16 out, no epilogue) and its bound, the larger of the
    bytes (each operand read once, the output written once) over the
    memory rate and the operations over the bf16 tensor-core peak;
    ``bound_by`` names the larger side of the sum."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_cuda, \
        sfc_matmul_plain, tile_schedule

    gen = torch.Generator(device="cuda").manual_seed(98)
    b1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    by_bytes = by_ops = 0.0
    for name, m, k, n, ep, f32, count in rows:
        a, b, kw = _gemm_inputs(m, k, n, torch.bfloat16, gen, ep)
        out_dtype = torch.float32 if f32 else None
        sched = tile_schedule("morton", -(-m // 128), -(-n // 128),
                              use_prefetch=True, device="cuda")
        ms = _time_ms(lambda: sfc_matmul_cuda(a, b, out_dtype=out_dtype, **kw),
                      iters, flush)
        plain = _time_ms(lambda: sfc_matmul_plain(
            a, b, sched=sched, bm=128, bn=128, bk=128, out_dtype=out_dtype,
            **kw), 3, flush)
        lib = _time_ms(lambda: torch.matmul(a, b), iters, flush)
        nbytes = (m * k + k * n) * 2 + m * n * (4 if f32 else 2) + \
            (m * n * 2 if ep == "residual" else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m * n * k / BF16_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by_bytes += count * t_bytes
        by_ops += count * t_ops
        print(f"  {label} {name:13s} {m}x{k}x{n}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f}, torch.matmul {lib:.4f}, bound "
              f"{bound:.4f} ({'bytes' if t_bytes >= t_ops else 'operations'}"
              f"), x{count}")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound)):
            b1[key] += count * v
        del a, b, kw
    return {**b1, "bound_by": "bytes" if by_bytes >= by_ops
            else "operations"}


def time_arch_step(cfg, state, pos, smi: str) -> dict:
    """B1 per decode step at ``cfg``'s shapes (``time_b1``: per-launch
    CUDA-event times, L2 flushed, times the launches a step) beside its
    bound, its plain version and ``torch.matmul``; B2 per launch on a
    paged ``state`` at ``pos`` beside its bound."""
    import torch

    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref
    from repro_torch.serve.paged_kv import physical_rows, zero_row_index

    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    b1 = time_b1(cfg.name, main_path_gemms(cfg), flush)
    rec = {"B1": b1}
    print(f"[time] {cfg.name} B1 per decode step: {b1['ms']:.3f} ms against "
          f"a {b1['bound_ms']:.3f} ms bound ({b1['bound_ms'] / b1['ms']:.1%}),"
          f" torch.matmul {b1['library_ms']:.3f} ms ({smi})")
    gen = torch.Generator(device="cuda").manual_seed(99)
    if state is not None and state.layout.is_paged:
        kp, vp = state["k_pages"], state["v_pages"]
        phys = physical_rows(state["page_perm"], state["block_tables"],
                             zero_row_index(kp))[0]
        q = torch.randn(SLOTS, cfg.n_heads, cfg.d_head, generator=gen,
                        device="cuda").to(kp.dtype)
        ms = _time_ms(lambda: paged_decode_attention_cuda(q, kp, vp, phys,
                                                          pos), 50, flush)
        plain = _time_ms(lambda: paged_decode_attention_ref(q, kp, vp, phys,
                                                            pos), 20, flush)
        nbytes, bound = b2_bound(q, kp, phys, pos)
        n_l = cfg.n_layers
        rec["B2"] = {"ms": n_l * ms, "plain_ms": n_l * plain,
                     "bound_ms": n_l * bound, "bound_by": "bytes",
                     "per_launch_ms": ms, "group": cfg.n_heads
                     // cfg.n_kv_heads}
        print(f"[time] {cfg.name} B2 per launch (group {rec['B2']['group']}"
              f", positions {pos.tolist()}): {ms:.4f} ms, plain "
              f"{plain:.4f}, bound {bound:.5f} ms; x{n_l} a step ({smi})")
    return rec


def layout_step(cfg, params, layout: str, smi: str, cut: str = "",
                timed: bool = True) -> dict:
    """One decode step from a mid-serving state in ``layout``, kernels
    against plain versions (``compare_step``) within LOGIT_BOUND, its
    launches exact (the family's B1 a layer, ``B1_PER_LAYER``, and the
    head; one B2 a layer when paged, none contiguous), then B1 (and B2)
    per step timed."""
    state, toks, pos = build_state(cfg, params, layout=layout)
    import torch

    from repro_torch.models import DotEngine, decode_step
    torch.cuda.synchronize()
    _zero_launches()
    decode_step(params, cfg, state.clone(), toks, pos,
                DotEngine(schedule="morton"))
    torch.cuda.synchronize()
    launches = _kernel_launches()
    n_l = cfg.n_layers
    want = {"B1": B1_PER_LAYER[cfg.family] * n_l + 1,
            "B2": n_l if layout == "paged" else 0}
    if launches != want:
        raise SystemExit(f"chip_smoke: {cfg.name} {layout} decode step "
                         f"launched {launches}, want {want}")
    rec = {"arch": cfg.name, "layout": layout, "layers": n_l, "cut": cut,
           "launches": launches,
           **compare_step(cfg, params, state, toks, pos, LOGIT_BOUND)}
    if timed:
        rec["times"] = time_arch_step(cfg, state, pos, smi)
    return rec


def strips_from_pages(state):
    """The contiguous state holding a paged state's K/V: entry p of slot
    s's strips is the pool row its block table maps position p to (the
    zero row where unallocated); ``kv_pos`` = 0 .. CACHE_LEN - 1."""
    import torch

    from repro_torch.serve import DecodeState, KVLayout
    from repro_torch.serve.paged_kv import physical_rows, zero_row_index

    kp, vp = state["k_pages"], state["v_pages"]
    ps = kp.shape[1]
    phys = physical_rows(state["page_perm"], state["block_tables"],
                         zero_row_index(kp)).long()        # (L, B, pages)
    pos = torch.arange(CACHE_LEN, device=kp.device)
    rows = phys[:, :, pos // ps]                           # (L, B, C)
    return DecodeState({"k": kp[rows, pos % ps], "v": vp[rows, pos % ps],
                        "kv_pos": pos.to(torch.int32)}, KVLayout.CONTIGUOUS)


def layouts_agree_f32(cfg, params) -> dict:
    """One f32 decode step through the kernels from a mid-serving paged
    state and from the contiguous strips holding the same K/V: the two
    layouts' logits within LOGIT_BOUND_F32 (B2's online softmax against
    torch's over the strips, in f32)."""
    import torch

    from repro_torch.models import DotEngine, decode_step

    state, toks, pos = build_state(cfg, params)
    cfg32, params32, paged = to_f32(cfg, params, state)
    del state
    strips = strips_from_pages(paged)
    eng = DotEngine(schedule="morton")
    got_p, _ = decode_step(params32, cfg32, paged, toks, pos, eng)
    got_c, _ = decode_step(params32, cfg32, strips, toks, pos, eng)
    torch.cuda.synchronize()
    err = float((got_p - got_c).abs().max())
    agree = int((got_p[:, 0].argmax(-1) == got_c[:, 0].argmax(-1)).sum())
    print(f"[layout_step] {cfg.name} ({cfg.n_layers} layers) f32 decode "
          f"step, paged against contiguous from the same K/V: max |logit "
          f"diff| {err:.4e} (bound {LOGIT_BOUND_F32:g}), greedy tokens agree "
          f"{agree}/{SLOTS}")
    if not bool(torch.isfinite(got_c).all()) or err > LOGIT_BOUND_F32:
        raise SystemExit(f"chip_smoke: {cfg.name} paged and contiguous "
                         f"decode steps disagree")
    return {"max_abs_err": err, "agree": agree}


def swa_ring(cfg, params, smi: str) -> tuple[dict, dict]:
    """h2o at full width in one ring of SWA_CACHE = its window: four
    slots prefilled by ``prefill_kv`` to SWA_PREFILL tokens (B1's tile
    path at M = each prompt, N ragged at 960), each slot's strips over
    [0, L) held to the same prefill on the plain versions from a clone
    within KV_BOUND (its logits' difference printed), then SWA_STEPS
    decode steps on per-row positions (rows 0 and 1 wrap the
    ring), each against the plain versions from a clone within
    LOGIT_BOUND; after each step every row's entry at ``pos % c`` of
    layer 0 equals its K computed anew (exactly) and no other entry of
    any layer moved.  Returns (record, launches)."""
    import numpy as np
    import torch

    from repro_torch.models import DotEngine, decode_step, \
        init_decode_state, prefill_kv
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import _decode_rope

    eng = DotEngine(schedule="morton")
    state = init_decode_state(cfg, SLOTS, SWA_CACHE, device="cuda")
    c = state["k"].shape[2]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(2, cfg.vocab, size=n).tolist()
               for n in SWA_PREFILL]
    n_l = cfg.n_layers
    plain_state = state.clone()
    torch.cuda.synchronize()
    _zero_launches()
    prefill_ms, logits = [], []
    for s, p in enumerate(prompts):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got, _ = prefill_kv(params, cfg, state, p, slot=s, engine=eng)
        e1.record()
        e1.synchronize()
        prefill_ms.append(e0.elapsed_time(e1))
        logits.append(got)
    pre_launches = _kernel_launches()
    want = {"B1": SLOTS * (7 * n_l + 1), "B2": 0}
    if pre_launches != want:
        raise SystemExit(f"chip_smoke: swa_ring prefill launched "
                         f"{pre_launches}, want {want}")
    kv_errs, logit_errs, top = [], [], 0.0
    for s, p in enumerate(prompts):
        with plain_versions():
            want_l, _ = prefill_kv(params, cfg, plain_state, p, slot=s,
                                   engine=eng)
        logit_errs.append(float((logits[s] - want_l).abs().max()))
        err = 0.0
        for key in ("k", "v"):
            a = state[key][:, s, :len(p)].float()
            b = plain_state[key][:, s, :len(p)].float()
            if not bool(torch.isfinite(a).all()):
                err = float("inf")
            err = max(err, float((a - b).abs().max()))
            top = max(top, float(b.abs().max()))
            del a, b
        kv_errs.append(err)
        del want_l
    del logits, plain_state
    print(f"[swa_ring] prefill_kv on the kernels against the plain "
          f"versions, per slot: max |K/V diff| over [0, L) of every layer "
          f"{', '.join(f'{e:.4e}' for e in kv_errs)} (bound {KV_BOUND:g}; "
          f"largest |K/V| {top:.3f}); max |logit diff| "
          f"{', '.join(f'{e:.4e}' for e in logit_errs)}")
    if max(kv_errs) > KV_BOUND:
        raise SystemExit("chip_smoke: swa_ring prefill K/V disagree with "
                         "the plain versions")
    print(f"[swa_ring] {cfg.name}, {c}-entry ring (window "
          f"{cfg.swa_window}), prefill_kv of {list(SWA_PREFILL)} tokens: "
          f"{', '.join(f'{ms:.1f}' for ms in prefill_ms)} ms (CUDA events; "
          f"B1's tile path at M = the prompt) ({smi})")
    pos = np.asarray(SWA_PREFILL)
    toks = np.asarray([[p[-1]] for p in prompts])
    dec = {"B1": 0, "B2": 0}
    errs, decode_ms, ring_ok = [], [], True
    lp0 = {k: v[0] for k, v in params["layers"]["attn"].items()}
    rows = torch.arange(SLOTS, device="cuda")
    for step in range(SWA_STEPS):
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        tok_t = torch.tensor(toks, dtype=torch.int32, device="cuda")
        before = state.clone()
        plain_state = state.clone()
        torch.cuda.synchronize()
        _zero_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got, _ = decode_step(params, cfg, state, tok_t, pos_t, eng)
        e1.record()
        e1.synchronize()
        decode_ms.append(e0.elapsed_time(e1))
        for kid, v in _kernel_launches().items():
            dec[kid] += v
        with plain_versions():
            want_l, _ = decode_step(params, cfg, plain_state, tok_t, pos_t,
                                    eng)
        err = float((got - want_l).abs().max())
        errs.append(err)
        if not bool(torch.isfinite(got).all()) or err > LOGIT_BOUND:
            raise SystemExit(f"chip_smoke: swa_ring step {step} logits "
                             f"{err} from the plain versions")
        # the ring write: layer 0's K of each row, anew, at pos % c
        slot = torch.remainder(pos_t.long(), c)
        x = params["embed"][tok_t.long()].to(cfg.act_torch_dtype())
        cos, sin = _decode_rope(cfg, pos_t, "cuda")
        _, k0, v0 = attn_mod._project_qkv(
            rms_norm(x, params["layers"]["norm1"][0]), lp0, cfg, eng, cos,
            sin)
        exact = torch.equal(state["k"][0, rows, slot], k0[:, 0]) and \
            torch.equal(state["v"][0, rows, slot], v0[:, 0])
        moved = torch.zeros(SLOTS, c, dtype=torch.bool, device="cuda")
        for key in ("k", "v"):
            moved |= (state[key] != before[key]).flatten(3).any(-1).any(0)
        allowed = torch.zeros_like(moved)
        allowed[rows, slot] = True
        only = not bool((moved & ~allowed).any())
        ring_ok &= exact and only
        print(f"  step {step}: positions {pos.tolist()} -> entries "
              f"{slot.tolist()}; logits vs plain {err:.4e} (bound "
              f"{LOGIT_BOUND:g}); layer-0 entries exact {exact}, nothing "
              f"else moved {only}; {decode_ms[-1]:.3f} ms")
        del before, plain_state
        toks = got[:, 0].argmax(-1).cpu().numpy()[:, None]
        pos = pos + 1
    if not ring_ok:
        raise SystemExit("chip_smoke: swa_ring wrote a ring entry it should "
                         "not have, or a wrong value")
    want = {"B1": SWA_STEPS * (7 * n_l + 1), "B2": 0}
    if dec != want:
        raise SystemExit(f"chip_smoke: swa_ring decode launched {dec}, "
                         f"want {want}")
    wrapped = [r for r in range(SLOTS) if SWA_PREFILL[r] + SWA_STEPS > c]
    rec = {"arch": cfg.name, "layout": "contiguous", "ring": c,
           "window": cfg.swa_window, "cut": "none (full width and depth)",
           "prefill_tokens": list(SWA_PREFILL), "prefill_ms": prefill_ms,
           "decode_steps": SWA_STEPS, "decode_ms": decode_ms,
           "rows_wrapped": wrapped, "max_abs_err": max(errs),
           "prefill_kv_err": kv_errs, "prefill_logit_err": logit_errs,
           "ring_entries_exact": ring_ok,
           "launches": {"prefill": pre_launches, "decode": dec},
           "strips_gb": 2 * state["k"].numel() * state["k"].element_size()
           / 1e9, "card": smi}
    print(f"[swa_ring] {SWA_STEPS} decode steps, rows {wrapped} wrapped: "
          f"{np.mean(decode_ms):.3f} ms a step (CUDA events, host gaps "
          f"included); logits max err {max(errs):.4e}; ring entries exact; "
          f"launches B1 {dec['B1']} (want {want['B1']}), B2 0 ({smi})")
    del state
    total = {k: pre_launches[k] + dec[k] for k in dec}
    return rec, total


def serve_row(run, against=None) -> dict:
    """A serving run's record for the JSON lines: tok/s, steps, ms and J
    per token; with ``against`` (the same requests served paged), the
    generated tokens agreeing with it per request."""
    keep = ("arch", "layout", "mode", "tok_per_s", "tokens", "wall_s",
            "steps", "chunk_steps", "ms_per_decode_step",
            "ms_per_chunk_step", "launches")
    rec = {k: run[k] for k in keep}
    rec["j_per_token"] = run["energy"]["j_per_token"]
    rec["run_j_per_token"] = run["energy"]["run_j_per_token"]
    if against is not None:
        rec["agree_with_paged"] = [
            sum(x == y for x, y in zip(against["out"][r][len(p):],
                                       run["out"][r][len(p):]))
            for r, p in enumerate(against["prompts"])]
    return rec


def deepseek_phase(smi: str) -> tuple[dict, list]:
    """deepseek-coder-33b at full width and all 62 layers (66.7 GB of
    bf16 weights, drawn a layer at a time): its B1 shapes and B2 head
    width against the plain versions, its paged and contiguous decode
    steps (``layout_step``) and the peak memory; then its f32 layouts
    check on the first F32_CHECK_LAYERS layers (an f32 copy of all 62
    would take 133 GB).  Returns (kernel checks, layout_step rows)."""
    import dataclasses

    import torch

    from repro_torch.optim.adamw import _tree_map

    cfg, params = init_arch("deepseek_coder_33b")
    init_peak = torch.cuda.max_memory_allocated()
    errs = {cfg.name: check_arch_kernels(cfg, paged=True)}
    rows = [layout_step(cfg, params, layout, smi, cut="none",
                        timed=layout == "paged")
            for layout in ("paged", "contiguous")]
    rows[-1]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rows[-1]["init_peak_gb"] = init_peak / 1e9
    print(f"[layout_step] {cfg.name} at all {cfg.n_layers} layers: peak "
          f"memory {init_peak / 1e9:.2f} GB after init, "
          f"{rows[-1]['peak_gb']:.2f} GB after its steps ({smi})")
    cut = dataclasses.replace(cfg, n_layers=F32_CHECK_LAYERS)
    params = {**params, "layers": _tree_map(
        lambda t: t[:F32_CHECK_LAYERS].clone(), params["layers"])}
    torch.cuda.empty_cache()
    rows[-1]["paged_vs_contiguous_f32"] = {
        **layouts_agree_f32(cut, params),
        "cut": f"{F32_CHECK_LAYERS} of {cfg.n_layers} layers"}
    del params
    torch.cuda.empty_cache()
    return errs, rows


def layouts_phase(sv: dict, cv: dict, prof_paged: dict,
                  smi: str) -> tuple[list, list, dict, dict]:
    """Slice 9's phases, after the others: qwen3-1.7b served contiguous
    (lockstep and continuous) beside the paged runs ``sv``/``cv``, its
    contiguous decode step against the plain versions and profiled
    beside ``prof_paged``; h2o-danube-3-4b served contiguous at full
    width and depth, its step and its SWA ring; glm4-9b served
    continuous paged and contiguous, its paged step; deepseek-coder-33b
    at all 62 layers, its paged and contiguous steps and its peak
    memory, then its f32 layouts check on its first 4 layers.  Each
    model is freed before the next.  Returns (serve_layouts rows,
    layout_step rows, swa_ring record, launches by path)."""
    import torch

    serve_rows, step_rows, by_path = [], [], {}
    cfg, params = init_arch("qwen3_1_7b")
    for mode, paged in (("lockstep", sv), ("continuous", cv)):
        run = serve(cfg, params, mode, "contiguous",
                    tag=f"[serve {mode} contiguous]")
        serve_rows.append({**serve_row(run, paged), "cut": "none"})
        by_path[f"qwen3 {mode} contiguous"] = run["launches"]
        print(f"[serve_layouts] qwen3-1.7b {mode}: contiguous "
              f"{run['tok_per_s']:.2f} tok/s, {run['ms_per_decode_step']:.3f}"
              f" ms a decode step, against paged {paged['tok_per_s']:.2f} / "
              f"{paged['ms_per_decode_step']:.3f}; generated tokens agreeing "
              f"with the paged run {serve_rows[-1]['agree_with_paged']} of "
              f"{MAX_NEW} (printed, not gated) ({smi})")
    rec = layout_step(cfg, params, "contiguous", smi, timed=False)
    rec["paged_vs_contiguous_f32"] = layouts_agree_f32(cfg, params)
    torch.cuda.empty_cache()
    state, toks, pos = build_state(cfg, params, layout="contiguous")
    rec["profile"] = profile_steps(cfg, params, state, toks, pos, smi)
    rec["profile_paged"] = prof_paged
    step_rows.append(rec)
    print(f"[layout_step] qwen3-1.7b decode step device busy: contiguous "
          f"{rec['profile']['busy_ms']:.3f} ms, paged "
          f"{prof_paged['busy_ms']:.3f} ms ({smi})")
    del params, state
    torch.cuda.empty_cache()

    cfg, params = init_arch("h2o_danube_3_4b")
    errs = {cfg.name: check_arch_kernels(cfg, paged=False)}
    run = serve(cfg, params, "lockstep", "contiguous", tag="[serve h2o]")
    serve_rows.append({**serve_row(run), "cut": "none (full width and depth)"})
    by_path["h2o lockstep contiguous"] = run["launches"]
    step_rows.append(layout_step(cfg, params, "contiguous", smi,
                                 cut="none"))
    ring, ring_launches = swa_ring(cfg, params, smi)
    by_path["h2o swa_ring"] = ring_launches
    del params
    torch.cuda.empty_cache()

    cfg, params = init_arch("glm4_9b")
    errs[cfg.name] = check_arch_kernels(cfg, paged=True)
    prompts = serving_prompts(cfg)[:GLM4_REQUESTS]
    runs = {}
    for layout in ("paged", "contiguous"):
        runs[layout] = serve(cfg, params, "continuous", layout, prompts,
                             GLM4_MAX_NEW, tag=f"[serve glm4 {layout}]")
        by_path[f"glm4 continuous {layout}"] = runs[layout]["launches"]
    serve_rows.append({**serve_row(runs["paged"]), "cut": "none"})
    serve_rows.append({**serve_row(runs["contiguous"], runs["paged"]),
                       "cut": "none"})
    step_rows.append(layout_step(cfg, params, "paged", smi, cut="none"))
    del params, runs
    torch.cuda.empty_cache()

    ds_errs, ds_rows = deepseek_phase(smi)
    errs.update(ds_errs)
    step_rows += ds_rows
    for r in step_rows:
        r["kernel_checks"] = errs.get(r["arch"])
        by_path[f"{r['arch']} {r['layout']} step"] = r["launches"]
    return serve_rows, step_rows, ring, by_path



# ------------------------------------------------------------ families ----
# slice 11: the moe, ssm and hybrid archs at full width and depth.
# Serving: granite-moe-1b the N_REQUESTS prompts, lockstep and continuous,
# paged; granite-moe-3b FAMILY_REQUESTS requests of FAMILY_MAX_NEW tokens,
# continuous, paged and contiguous; mamba2 and hymba (contiguous and
# lockstep only, as in the reference) FAMILY_REQUESTS requests of
# MAX_NEW tokens.  Training: FAMILY_TRAIN_STEPS steps of each trained arch
# on its first FAMILY_TRAIN_LAYERS layers (at full depth it took 112 s of a
# 677 s run on an H100, the largest part; the host's time a step follows
# the depth).
FAMILY_REQUESTS = 4
FAMILY_MAX_NEW = 8
FAMILY_TRAIN = ("granite_moe_1b_a400m", "mamba2_780m", "hymba_1_5b")
FAMILY_TRAIN_STEPS = 2
FAMILY_TRAIN_LAYERS = 8


def families_phase(smi: str) -> tuple[dict, dict]:
    """Slice 11's serving: each new arch at full width and depth (random
    bf16 weights from seed 0), its B1 shapes (and B2 head width where it
    serves paged) against the plain versions, its serving runs (launches
    exact, every logit row finite, tok/s and J per token from NVML),
    one decode step against the plain versions and timed beside the
    bounds (``layout_step``); each model freed before the next.
    Returns (the ``families`` line's serving part, launches by path)."""
    import torch

    serve_rows, step_rows, errs, by_path = [], [], {}, {}
    plan = (("granite_moe_1b_a400m", True),
            ("granite_moe_3b_a800m", True),
            ("mamba2_780m", False), ("hymba_1_5b", False))
    for name, paged in plan:
        cfg, params = init_arch(name)
        errs[cfg.name] = check_arch_kernels(cfg, paged=paged, chunk=paged)
        tag = f"[serve {cfg.name}"
        if name == "granite_moe_1b_a400m":
            for mode in ("lockstep", "continuous"):
                run = serve(cfg, params, mode, "paged",
                            tag=f"{tag} {mode} paged]")
                serve_rows.append(serve_row(run))
                by_path[f"{cfg.name} {mode} paged"] = run["launches"]
        elif name == "granite_moe_3b_a800m":
            prompts = serving_prompts(cfg)[:FAMILY_REQUESTS]
            runs = {}
            for layout in ("paged", "contiguous"):
                runs[layout] = serve(cfg, params, "continuous", layout,
                                     prompts, FAMILY_MAX_NEW,
                                     tag=f"{tag} continuous {layout}]")
                by_path[f"{cfg.name} continuous {layout}"] = \
                    runs[layout]["launches"]
            serve_rows.append(serve_row(runs["paged"]))
            serve_rows.append(serve_row(runs["contiguous"], runs["paged"]))
            print(f"[families] {cfg.name} contiguous: generated tokens "
                  f"agreeing with the paged run per request "
                  f"{serve_rows[-1]['agree_with_paged']} of "
                  f"{FAMILY_MAX_NEW} (printed, not gated)")
        else:
            prompts = serving_prompts(cfg)[:FAMILY_REQUESTS]
            run = serve(cfg, params, "lockstep", "contiguous", prompts,
                        MAX_NEW, tag=f"{tag} lockstep contiguous]")
            serve_rows.append(serve_row(run))
            by_path[f"{cfg.name} lockstep contiguous"] = run["launches"]
        print(f"[families] {cfg.name}: "
              + "; ".join(f"{r['mode']} {r['layout']} {r['tok_per_s']:.2f} "
                          f"tok/s, {r['ms_per_decode_step']:.3f} ms a decode "
                          f"step, {r['j_per_token']:.4f} J/token"
                          for r in serve_rows if r["arch"] == cfg.name)
              + f" ({smi})")
        rec = layout_step(cfg, params, "paged" if paged else "contiguous",
                          smi, cut="none")
        rec["kernel_checks"] = errs[cfg.name]
        step_rows.append(rec)
        by_path[f"{cfg.name} {rec['layout']} step"] = rec["launches"]
        del params
        torch.cuda.empty_cache()
    return {"serve": serve_rows, "step": step_rows}, by_path


# ------------------------------------------------------------- mellum2 ----
def _b5_operands(cfg, tokens: int, gen):
    """``tokens`` tokens' top-k experts of random router logits, sorted by
    expert: the rows (bf16), their (E + 1,) int32 offsets on the card and
    the experts touched."""
    import torch

    e, k = cfg.moe_experts, cfg.moe_topk
    idx = torch.randn(tokens, e, generator=gen, device="cuda").topk(
        k, dim=-1).indices.reshape(-1)
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=e)
    off = torch.zeros(e + 1, dtype=torch.int32, device="cuda")
    off[1:] = torch.cumsum(counts, 0)
    x = torch.randn(tokens, cfg.d_model, generator=gen, device="cuda")
    return x[order // k].bfloat16(), off, int((counts > 0).sum())


def b5_bound_ms(cfg, tokens: int, touched: int) -> float:
    """B5's least time for one moe layer (both launches): the larger of
    the assignments' 2 x 3 x d x F operations at the bf16 peak and the
    touched experts' weights read once plus the rows (in, hidden out and
    in, f32 out) at HBM's peak."""
    d, f = cfg.d_model, cfg.moe_dff
    r = tokens * cfg.moe_topk
    ops = 2.0 * r * 3 * d * f
    nbytes = touched * 3.0 * d * f * 2 + r * (2 * d + 4 * f + 4 * d)
    return max(ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def mellum_b5(cfg, rep: Report, gen, flush, smi: str) -> list[dict]:
    """B5 at codectx's decode and chunk shapes: the gated up-projection
    (bf16 out) and the down-projection (f32 out) against
    ``sfc_matmul_grouped_plain`` within B5_BF16 and B5_F32 (which refuse
    rows sent to the wrong expert), each twice bit for bit, then timed
    (both launches, a moe layer) beside :func:`b5_bound_ms`."""
    import torch

    from repro_torch.kernels.sfc_matmul_grouped import grouped_row_tile, \
        sfc_matmul_grouped, sfc_matmul_grouped_plain

    d, f, e = cfg.d_model, cfg.moe_dff, cfg.moe_experts

    def draw(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * shape[-2] ** -0.5).bfloat16()

    w1, w3, w2 = draw(e, d, f), draw(e, d, f), draw(e, f, d)
    rows = []
    print(f"[mellum2] B5 sfc_matmul_grouped against its plain version, then "
          f"a moe layer's two launches timed ({smi})")
    for kind, t in MELLUM_B5_TOKENS:
        x, off, touched = _b5_operands(cfg, t, gen)
        bm = grouped_row_tile(t)

        def layer(plain=False):
            if plain:
                h = sfc_matmul_grouped_plain(x, w1, off, w3=w3)
                return h, sfc_matmul_grouped_plain(h, w2, off,
                                                   out_dtype=torch.float32)
            h = sfc_matmul_grouped(x, w1, off, w3=w3, seg_max=t)
            return h, sfc_matmul_grouped(h, w2, off, seg_max=t,
                                         out_dtype=torch.float32)

        h, y = layer()
        hp = sfc_matmul_grouped_plain(x, w1, off, w3=w3)
        yp = sfc_matmul_grouped_plain(h, w2, off, out_dtype=torch.float32)
        err_h = rep.check(f"B5 {kind} up {t}x{d}->{f} (bm {bm})", h, hp,
                          B5_BF16, B5_BF16)
        err_y = rep.check(f"B5 {kind} down {t}x{f}->{d} (bm {bm})", y, yp,
                          B5_F32, B5_F32)
        # the bound refuses each row sent to its neighbour expert
        wrong = sfc_matmul_grouped_plain(x, w1.roll(1, 0), off,
                                         w3=w3.roll(1, 0))
        if not bool(((wrong.float() - hp.float()).abs() > B5_BF16 + B5_BF16
                     * hp.float().abs()).any()):
            rep.failures.append(f"B5 {kind}: a wrong expert not refused")
        del wrong
        h2, y2 = layer()
        same = torch.equal(h, h2) and torch.equal(y, y2)
        print(f"  {'ok  ' if same else 'FAIL'} B5 {kind}: two launches "
              f"{'equal' if same else 'DIFFER'} bit for bit")
        if not same:
            rep.failures.append(f"B5 {kind} not bit-equal")
        ms = _time_ms(layer, 20, flush)
        plain = _time_ms(lambda: layer(True), 3, flush)
        bound = b5_bound_ms(cfg, t, touched)
        n_l = cfg.n_layers
        print(f"[time] B5 {kind}: {t} tokens x top-{cfg.moe_topk}, {touched} "
              f"of {e} experts touched, bm {bm}: {ms:.4f} ms a moe layer "
              f"(bound {bound:.4f} ms, {bound / ms:.1%}; plain {plain:.3f} "
              f"ms), x{n_l} = {n_l * ms:.3f} ms a {kind} step (bound "
              f"{n_l * bound:.3f}) ({smi})")
        rows.append({"step": kind, "tokens": t, "touched": touched, "bm": bm,
                     "max_abs_err": max(err_h, err_y), "ms": n_l * ms,
                     "bound_ms": n_l * bound, "plain_ms": n_l * plain})
    return rows


def mellum_b2(cfg, rep: Report, gen, flush, smi: str) -> list[dict]:
    """B2 at 8 rows whose keys are MELLUM_KEYS, with the window (a window
    layer) and without (a full layer), against
    ``paged_decode_attention_ref`` per slot within B2_SLOT_REL (which
    refuses the full attention as the window's answer) and twice bit for
    bit, then timed beside the K/V bytes it must read (a window layer's
    last ``sliding_window`` keys)."""
    import torch

    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    b, ps = len(MELLUM_KEYS), PAGE_SIZE
    hkv, dh, h = cfg.n_kv_heads, cfg.d_head, cfg.n_heads
    n_rows = b * MELLUM_PAGES + 1
    kp = (torch.randn(n_rows, ps, hkv, dh, generator=gen, device="cuda")
          * 0.5).bfloat16()
    vp = torch.randn(n_rows, ps, hkv, dh, generator=gen,
                     device="cuda").bfloat16()
    kp[-1] = 0
    vp[-1] = 0
    tables = torch.randperm(n_rows - 1, generator=gen, device="cuda")[
        :b * MELLUM_PAGES].reshape(b, MELLUM_PAGES).to(torch.int32)
    q = torch.randn(b, h, dh, generator=gen, device="cuda").bfloat16()
    pos = torch.tensor(MELLUM_KEYS, device="cuda") - 1
    rows = []
    kinds = (("window", cfg.sliding_window, cfg.layer_types.count(
        "sliding_attention")), ("full", None, cfg.layer_types.count(
            "full_attention")))
    for kind, window, count in kinds:
        def launch():
            return paged_decode_attention_cuda(q, kp, vp, tables, pos,
                                               window=window)
        out = launch()
        want = paged_decode_attention_ref(q, kp, vp, tables, pos, window)
        err = float((out.float() - want.float()).abs().max())
        scaled = slot_scaled_err(out, want)
        ok = scaled <= B2_SLOT_REL
        print(f"  {'ok  ' if ok else 'FAIL'} B2 {kind} ({window} keys) at "
              f"keys {MELLUM_KEYS}: per slot {scaled:.3e} (bound "
              f"{B2_SLOT_REL:g}), max_abs_err {err:.3e}")
        if not ok:
            rep.failures.append(f"B2 {kind}")
        if window:
            # every row holds more keys than the window: the full output
            # is a wrong answer that the bound must refuse
            wrong = slot_scaled_err(paged_decode_attention_cuda(
                q, kp, vp, tables, pos), want)
            print(f"  {'ok  ' if wrong > B2_SLOT_REL else 'FAIL'} B2 {kind}"
                  f": attention over every key refused, per slot "
                  f"{wrong:.3e}")
            if wrong <= B2_SLOT_REL:
                rep.failures.append("B2 window: full attention not refused")
        same = torch.equal(out, launch())
        print(f"  {'ok  ' if same else 'FAIL'} B2 {kind}: two launches "
              f"{'equal' if same else 'DIFFER'} bit for bit")
        if not same:
            rep.failures.append(f"B2 {kind} not bit-equal")
        keys = [min(n, window or n) for n in MELLUM_KEYS]
        nbytes = sum(keys) * hkv * dh * 2 * 2 + 2 * b * h * dh * 2
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms = _time_ms(launch, 50, flush)
        print(f"[time] B2 {kind}: {ms:.4f} ms a launch (bound {bound:.5f} "
              f"ms, {nbytes / 1e6:.1f} MB of K/V, {bound / ms:.1%}), x{count}"
              f" = {count * ms:.3f} ms a decode step ({smi})")
        rows.append({"layers": kind, "window": window, "launches_a_step":
                     count, "max_abs_err": err, "ms": count * ms,
                     "bound_ms": count * bound})
    return rows


def _mellum_counts() -> dict:
    import repro_torch.kernels.paged_attention as pa_mod
    import repro_torch.kernels.sfc_matmul_grouped as b5_mod
    return {**_kernel_launches(), "B2 window": pa_mod.window_launches,
            "B5": b5_mod.grouped_launches}


def _zero_mellum_counts() -> None:
    import repro_torch.kernels.paged_attention as pa_mod
    import repro_torch.kernels.sfc_matmul_grouped as b5_mod
    _zero_launches()
    pa_mod.window_launches = 0
    b5_mod.grouped_launches = 0


def mellum_want_launches(cfg, steps: int, chunks: int) -> dict:
    """The launches of a routed moe with window layers served paged over
    ``steps`` decode steps and ``chunks`` prefill chunks: B1 the
    attention's wq, wk, wv, wo and the router a layer (and the head a
    decode step), B2 one a layer a decode step, the window layers'
    windowed, B5 the experts' up and down projections a layer a step."""
    n_l = cfg.n_layers
    return {"B1": steps * (5 * n_l + 1) + chunks * 5 * n_l,
            "B2": steps * n_l,
            "B2 window": steps * sum(cfg.layer_window(i) is not None
                                     for i in range(n_l)),
            "B5": 2 * n_l * (steps + chunks)}


def mellum2_phase(smi: str) -> tuple[dict, dict]:
    """mellum2-12b-a2.5b at full width and depth (random bf16 weights
    from seed 0): B5 (:func:`mellum_b5`) and B2 with and without its
    window (:func:`mellum_b2`) at the codectx cell's shapes, then its main
    path: MELLUM_PROMPTS served continuous and paged through
    ``ServeLoop`` with every launch counted from 0 just before the run and
    held exact (:func:`mellum_want_launches`), every logit row finite and
    every page freed.  Returns (the ``mellum2`` line, the
    launches)."""
    import numpy as np
    import torch

    from repro_torch.serve import ServeConfig

    gen = torch.Generator(device="cuda").manual_seed(32)
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rep = Report()
    cfg, params = init_arch(MELLUM)
    b5_rows = mellum_b5(cfg, rep, gen, scratch.zero_, smi)
    b2_rows = mellum_b2(cfg, rep, gen, scratch.zero_, smi)
    del scratch
    torch.cuda.empty_cache()
    rep.raise_if_failed("mellum2 kernel checks")

    sc = ServeConfig(slots=SLOTS, cache_len=MELLUM_CACHE_LEN,
                     page_size=PAGE_SIZE, eos_id=-1, layout="paged",
                     mode="continuous", prefill_budget=MELLUM_BUDGET, seed=0)
    loop = checked_loop(cfg, params, sc)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=n).tolist()
               for n in MELLUM_PROMPTS]
    for r, p in enumerate(prompts):
        loop.submit(r, p)
    torch.cuda.synchronize()
    _zero_mellum_counts()
    t0 = time.perf_counter()
    out = loop.run(max_new=MELLUM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _mellum_counts()
    steps, chunks = loop.steps, loop.chunk_steps
    want = mellum_want_launches(cfg, steps, chunks)
    print(f"[serve mellum2] prompts {list(MELLUM_PROMPTS)}, max_new "
          f"{MELLUM_NEW}, {SLOTS} slots, {steps} decode steps and {chunks} "
          f"prefill chunks of at most {MELLUM_BUDGET} tokens in {wall:.2f} s"
          f"; launches {got} (want {want})")
    bad = []
    if got != want:
        bad.append(f"launch counts {got} != {want}")
    for r, p in enumerate(prompts):
        if len(out[r]) != len(p) + MELLUM_NEW or out[r][:len(p)] != p:
            bad.append(f"request {r} returned {len(out[r])} tokens")
    if loop.rows_checked != len(prompts) * MELLUM_NEW:
        bad.append("not every sampled row was checked")
    loop.alloc.check_invariants()
    if loop.alloc.pages_in_use:
        bad.append(f"{loop.alloc.pages_in_use} pages in use after the drain")
    if bad:
        raise SystemExit(f"chip_smoke: mellum2 serving: {bad}")
    decode_ms, chunk_ms = loop.spans_ms("decode"), loop.spans_ms("chunk")
    rec = {"arch": cfg.name, "b5": b5_rows, "b2": b2_rows,
           "serve": {"prompts": list(MELLUM_PROMPTS), "steps": steps,
                     "chunk_steps": chunks, "wall_s": wall,
                     "tok_per_s": len(prompts) * MELLUM_NEW / wall,
                     "ms_per_decode_step": float(np.median(decode_ms)),
                     "ms_per_chunk_step": float(np.median(chunk_ms)),
                     "launches": got},
           "card": smi}
    del loop, params
    torch.cuda.empty_cache()
    return rec, got


# ------------------------------------------------------------ training ----
TRAIN_BATCH, TRAIN_SEQ = 4, 256   # 1024 tokens a step
TRAIN_STEPS = 4
TRAIN_LR = 3e-4         # Adam's first updates move every weight by ~lr
LOSS0_BOUND = 1.0       # |step-0 loss - ln(vocab)|, see train_phase
TRAIN_LOSS_BOUND = 0.1  # |loss morton - loss xla| at every step, bf16
TRAIN_GRAD_REL = 0.1    # per leaf ||g morton - g xla|| / ||g xla||, bf16
TRAIN_F32_REL = 1e-3    # per leaf max|g kernels - g plain| / max|g plain|
TRAIN_F32_LAYERS = 2
CLI_STEPS, CLI_FAIL_AT, CLI_RESUME_STEPS = 8, 5, 4


def frontend_tokens(cfg, shape) -> int:
    """Rows ``frontend_proj`` projects in a batch of ``shape`` = (batch,
    seq): every frame of an encoder's, the vlm's ``min(frontend_tokens,
    seq // 2)`` patches a row (``make_batch``); none without a frontend."""
    b, s = shape
    if cfg.family == "encoder":
        return b * s
    if cfg.family == "vlm":
        return b * min(cfg.frontend_tokens, s // 2)
    return 0


def train_gemms(cfg, shape=(TRAIN_BATCH, TRAIN_SEQ)):
    """(role, name, M, K, N, operand dtype, out f32, count per step) of
    every B1 launch of one train step on a (batch, seq) ``shape`` (remat
    "dots" or none): each projection of the family's decode step
    (``main_path_gemms``, M = batch x seq) forward, its dgrad (dz @ w^T)
    and wgrad (x^T @ dz), w1's pre-activation recomputed (f32 out) for
    silu's derivative where there is a SwiGLU MLP, the vocab head's
    forward (bf16, f32 out) and its dgrad and wgrad in f32 (dLogits is
    f32), and a frontend's ``frontend_proj`` forward and wgrad (its
    input, the stub's embeddings, needs no gradient).  Dense: 22 L + 3;
    the encoder and the vlm 22 L + 5."""
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    t, d, v = shape[0] * shape[1], cfg.d_model, cfg.padded_vocab
    rows = []
    for name, _, k, n, ep, _, c in main_path_gemms(cfg):
        if name == "head->f32":
            continue
        name = name.split("+")[0]
        rows += [("fwd", name, t, k, n, bf, False, c),
                 ("dgrad", name, t, n, k, bf, False, c),
                 ("wgrad", name, k, t, n, bf, False, c)]
        if ep == "silu":
            rows.append(("recompute", name, t, k, n, bf, True, c))
    rows += [("fwd", "head", t, d, v, bf, True, 1),
             ("dgrad", "head", t, v, d, f32, False, 1),
             ("wgrad", "head", d, t, v, f32, False, 1)]
    tf = frontend_tokens(cfg, shape)
    if tf:
        fd = cfg.frontend_dim
        rows += [("fwd", "frontend_proj", tf, fd, d, bf, False, 1),
                 ("wgrad", "frontend_proj", fd, tf, d, bf, False, 1)]
    return rows


def train_launches_per_step(cfg, remat_full: bool = False) -> int:
    """B1 launches of one train step: per layer the family's n forward
    GEMMs (``B1_PER_LAYER``), n dgrad, n wgrad and w1's recompute where
    there is a SwiGLU MLP, and the head's three; a "full" remat
    recomputes the layer's n forward GEMMs in the backward too; a
    frontend adds ``frontend_proj``'s forward and wgrad (outside the
    checkpointed layers: never recomputed).  Dense 22 L + 3 (29 L + 3
    under "full"), moe 12 L + 3, ssm 6 L + 3 (8 L + 3), hybrid 28 L + 3
    (37 L + 3), the encoder 22 L + 5, the vlm 22 L + 5 (29 L + 5)."""
    n = B1_PER_LAYER[cfg.family]
    mlp = 1 if cfg.family in MLP_FAMILIES else 0
    front = 2 if cfg.frontend else 0
    return cfg.n_layers * (3 * n + mlp + (n if remat_full else 0)) + 3 + front


def check_train_gemms(cfg, roles=("dgrad", "wgrad"),
                      shape=(TRAIN_BATCH, TRAIN_SEQ)) -> float:
    """Train phase (a): B1's GEMMs of ``roles`` at the train step's
    shapes against the plain version (B1's bf16 and f32 bounds) and two
    launches bit-equal: one layer's projections in bf16 at ``shape``'s
    batch x seq tokens, the vocab head's in f32 (bf16 operands, f32 out,
    forward), a frontend's projection in bf16."""
    import torch

    rep = Report()
    gen = torch.Generator(device="cuda").manual_seed(2323)
    t = shape[0] * shape[1]
    err = 0.0
    print(f"[train] (a) {cfg.name}: B1's {'/'.join(roles)} GEMMs against "
          f"the plain version, {t} tokens")
    for role, name, m, k, n, dtype, out_f32, _ in train_gemms(cfg, shape):
        if role not in roles:
            continue
        label = f"{role} {name}"
        err = max(err, b1_check(rep, gen, label, m, k, n, dtype, "none",
                                out_f32))
        b1_same_twice(rep, gen, label, m, k, n, dtype, "none", out_f32)
    rep.raise_if_failed(f"train (a) {cfg.name} GEMMs")
    return err


def train_batches(cfg, n: int, seed: int = 0,
                  shape=(TRAIN_BATCH, TRAIN_SEQ)):
    from repro_torch.data import PackedSyntheticData
    from repro_torch.data.pipeline import batch_to_device
    from repro_torch.models.config import ShapeSpec

    data = PackedSyntheticData(cfg, ShapeSpec(
        "chip", seq_len=shape[1], global_batch=shape[0], kind="train"),
        seed=seed)
    return [batch_to_device(data.batch(i), "cuda") for i in range(n)]


def train_params(cfg):
    """Parameters from seed 0 on the card."""
    import torch

    from repro_torch.models import init_model

    return init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")


def _grad_errors(got, want) -> tuple[float, float]:
    """(largest per-leaf ||got - want|| / ||want||, largest per-leaf
    max|got - want| / max|want|), in f32."""
    import torch

    norm_rel = max_rel = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        nb = float(torch.linalg.vector_norm(b))
        dn = float(torch.linalg.vector_norm(a - b)) / max(nb, 1e-30)
        dm = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        norm_rel, max_rel = max(norm_rel, dn), max(max_rel, dm)
    return norm_rel, max_rel


def pinned_routing(table: dict, replay: bool):
    """A context in which the moe router records each layer's top-k in
    ``table`` (keyed by the address of the layer's router weights,
    which a checkpoint's recomputation sees too) or, with ``replay``,
    takes the recorded top-k instead of its own: the gate weights, the
    load-balance loss and their gradients stay this run's functions of
    its own logits.  ``table["flips"]`` counts, per layer, the tokens
    whose own top-k differs from the recorded one."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe as moe_mod

    own = moe_mod._router

    def router(xf, params, cfg):
        key = params["router"].data_ptr()
        w, idx, aux = own(xf, params, cfg)
        if not replay:
            table[key] = idx.detach()
            return w, idx, aux
        idx_own, idx = idx, table[key]
        table.setdefault("flips", {})[key] = int(
            (idx_own.sort(-1).values != idx.sort(-1).values).any(-1).sum())
        probs = torch.softmax(xf.float() @ params["router"], dim=-1)
        w = probs.gather(-1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        fe = F.one_hot(idx[:, 0], probs.shape[-1]).float().mean(0)
        return w, idx, cfg.moe_experts * torch.sum(fe * probs.mean(0))

    @contextlib.contextmanager
    def ctx():
        moe_mod._router = router
        try:
            yield
        finally:
            moe_mod._router = own

    return ctx()


def _leaf_errors(got, want, names) -> dict:
    """Per leaf name, ||got - want|| / ||want|| in f32."""
    return {n: _grad_errors([a], [b])[0]
            for a, b, n in zip(got, want, names)}


def train_grads_checks(cfg, params, batch) -> dict:
    """Train phase (b), before any step: one step's loss and gradients
    from the initial state, Morton, computed again (bit-equal), with
    remat off and under the other policy ("full" where the config runs
    "dots", "dots" where it runs "full"), all bit-equal to the config's
    own, each with its exact B1 launches; and the same gradients under
    "xla", held to Morton's per leaf within TRAIN_GRAD_REL.  A moe
    arch's gate is Morton's gradients under the top-k that "xla" chose
    (``pinned_routing``): a bf16 rounding that flips a token's top-k
    moves its router gradient by far more than the kernels' error, and
    the unpinned errors are printed beside."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import grads_of
    from repro_torch.models import DotEngine
    from repro_torch.optim.adamw import tree_leaves

    morton, xla = DotEngine(schedule="morton"), DotEngine(schedule="xla")
    names = _leaf_names(params)
    fails = []
    wall = {}

    def timed(label, c, eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grads_of(c, params, batch, eng)
        torch.cuda.synchronize()
        wall[label] = (time.perf_counter() - t0) * 1e3
        return out

    def want(c) -> int:
        return train_launches_per_step(
            c, remat_full=c.remat and c.remat_policy == "full")

    base = cfg.remat_policy
    other = "dots" if base == "full" else "full"
    _zero_launches()
    loss, metrics, g = timed(base, cfg, morton)
    ref = tree_leaves(g)
    runs = {base: _kernel_launches()["B1"]}
    if runs[base] != want(cfg):
        fails.append(f"{base} launches {runs[base]} != {want(cfg)}")
    for label, c in (("again", cfg),
                     ("none", dataclasses.replace(cfg, remat=False)),
                     (other, dataclasses.replace(cfg, remat_policy=other))):
        _zero_launches()
        l2, _, g2 = timed(label, c, morton)
        runs[label] = _kernel_launches()["B1"]
        same = torch.equal(l2, loss) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g2), ref))
        print(f"  {'ok  ' if same else 'FAIL'} {cfg.name} remat {label}: "
              f"loss and {len(ref)} gradient leaves bit-equal to the first "
              f"(remat {base}) run; {runs[label]} B1 launches (want "
              f"{want(c)}); forward and backward {wall[label]:.1f} ms wall "
              f"({base} {wall[base]:.1f})")
        if not same:
            fails.append(f"remat {label} not bit-equal")
        if runs[label] != want(c):
            fails.append(f"remat {label} launches {runs[label]} != "
                         f"{want(c)}")
        del g2
    moe = cfg.family == "moe"
    table: dict = {}
    _zero_launches()
    if moe:
        with pinned_routing(table, replay=False):
            lx, _, gx = timed("xla", cfg, xla)
    else:
        lx, _, gx = timed("xla", cfg, xla)
    xla_launches = _kernel_launches()["B1"]
    gx = tree_leaves(gx)
    norm_rel, max_rel = _grad_errors(ref, gx)
    leaf_rel = _leaf_errors(ref, gx, names)
    rec = {"launches": runs, "wall_ms": wall, "grad_rel_norm": norm_rel,
           "grad_rel_max": max_rel, "leaf_rel": leaf_rel,
           "loss0_morton": float(loss), "loss0_xla": float(lx),
           "aux0": float(metrics["aux"])}
    gate = norm_rel
    if moe:
        with pinned_routing(table, replay=True):
            lp, _, gp = grads_of(cfg, params, batch, morton)
        gp = tree_leaves(gp)
        gate, pin_max = _grad_errors(gp, gx)
        flips = sorted(table["flips"].values())
        rec["pinned"] = {"grad_rel_norm": gate, "grad_rel_max": pin_max,
                         "leaf_rel": _leaf_errors(gp, gx, names),
                         "loss0": float(lp), "flipped_tokens": flips}
        print(f"  {cfg.name} under \"xla\"'s top-{cfg.moe_topk}: Morton "
              f"chose another top-{cfg.moe_topk} for "
              f"{min(flips)}-{max(flips)} of {batch['tokens'].numel()} "
              f"tokens a layer; router leaf ||diff|| / ||xla|| unpinned "
              f"{leaf_rel['layers.moe.router']:.3e}, pinned "
              f"{rec['pinned']['leaf_rel']['layers.moe.router']:.3e}")
        del gp
    worst = sorted(((e, n) for n, e in (rec["pinned"]["leaf_rel"] if moe
                                        else leaf_rel).items()),
                   reverse=True)[:3]
    ok = gate <= TRAIN_GRAD_REL and xla_launches == 0
    print(f"  {'ok  ' if ok else 'FAIL'} {cfg.name} step-0 gradients, "
          f"morton{' (pinned)' if moe else ''} against xla: largest per-leaf "
          f"||diff|| / ||xla|| {gate:.3e} (bound {TRAIN_GRAD_REL:g}; at "
          + ", ".join(f"{n} {e:.3e}" for e, n in worst)
          + f"), largest per-leaf max|diff| / max|xla| {max_rel:.3e}; loss "
          f"{float(loss):.6f} against {float(lx):.6f}; xla made "
          f"{xla_launches} B1 launches")
    if not ok:
        fails.append("morton against xla gradients")
    if fails:
        raise SystemExit(f"chip_smoke: train (b) {cfg.name} gradient checks "
                         f"failed: {fails}")
    return rec


def profile_train_step(cfg, step, params, opt, batch, step_ms: float,
                       smi: str, schedule: str) -> dict:
    """Train phase (e): one step under torch.profiler: device busy and
    idle share (of the traced wall time and of the untraced step,
    ``step_ms``), the kernels by device time, B1's device time by kernel
    name and by role (the ``sfc_matmul.fwd``/``.recompute``/``.dgrad``/
    ``.wgrad`` ranges of ``repro_torch.kernels.grad``, which the trace
    also carries on the device), and the GEMM ops torch ran: on the
    Morton path the ``bmm`` of the attention, the SSD and the experts'
    einsums only, and a moe arch's router product (``matmul``/``mm``,
    XLA in the reference), never a projection."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = b1 = 0.0
    roles, ops_count, kernels, host = {}, {}, {}, {}
    host_calls = 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") and \
                e.key.startswith("aten::"):
            host[e.key] = float(e.self_cpu_time_total) / 1e3
            host_calls += e.count
        if str(e.device_type).endswith("CUDA"):
            ms = float(e.self_device_time_total) / 1e3
            if e.key.startswith("sfc_matmul."):     # a range, not a kernel
                roles[e.key[len("sfc_matmul."):]] = ms
                continue
            busy += ms
            if "sfc_matmul" in e.key:
                b1 += ms
            name = e.key.replace("(anonymous namespace)::", "")[:60]
            kernels[name] = kernels.get(name, 0.0) + ms
        elif e.key in ("aten::mm", "aten::addmm", "aten::bmm",
                       "aten::matmul", "aten::linear", "aten::_scaled_mm"):
            ops_count[e.key] = e.count
    print(f"[train] (e) profile of one {cfg.name} {schedule} step ({smi}): "
          f"{wall:.1f} "
          f"ms traced ({step_ms:.1f} untraced), device busy {busy:.1f} ms "
          f"(idle share {1 - busy / wall:.1%} of the traced wall, "
          f"{1 - busy / step_ms:.1%} of the untraced step); B1 kernels "
          f"{b1:.1f} ms; B1 by role "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in roles.items())
          + f"; torch GEMM ops {ops_count}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms  {ms / busy:6.1%}  {name}")
    host_ms = sum(host.values())
    print(f"[train] (e) host, traced: {host_calls} aten calls, their self "
          f"CPU time {host_ms:.1f} ms; the rest of the {wall:.1f} ms is "
          f"Python, autograd and the ctypes launches")
    for name, ms in sorted(host.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:9.3f} ms  {name[:60]}")
    torch_ops = {"aten::bmm"} | ({"aten::matmul", "aten::mm"}
                                 if cfg.family == "moe" else set())
    library = {k: v for k, v in ops_count.items() if k not in torch_ops}
    if schedule == "morton" and library:
        raise SystemExit(f"chip_smoke: library GEMMs on the Morton train "
                         f"path: {library}")
    return {"traced_ms": wall, "busy_ms": busy,
            "idle_share_traced": 1 - busy / wall,
            "idle_share": max(0.0, 1 - busy / step_ms), "b1_ms": b1,
            "host_aten_calls": host_calls, "host_aten_self_ms": host_ms,
            "b1_by_role_ms": roles, "torch_gemm_ops": ops_count,
            "top_kernels_ms": dict(sorted(kernels.items(),
                                          key=lambda kv: -kv[1])[:10])}


def run_train_steps(cfg, schedule: str, batches, smi: str,
                    shape=(TRAIN_BATCH, TRAIN_SEQ)) -> dict:
    """Train phase (b)/(e): one step of ``make_train_step`` a batch from
    the seed-0 state under ``schedule``: each step's loss, ms (CUDA
    events) and B1 launches; joules over the steps after the first
    (NVML, windows aligned to the counter's updates); peak memory;
    then one more step under the profiler."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import DotEngine
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.power import NvmlBackend

    params = train_params(cfg)
    opt = init_opt_state(params)
    step = make_train_step(cfg, None, AdamWConfig(
        peak_lr=TRAIN_LR, warmup=1, total_steps=len(batches)),
        engine=DotEngine(schedule=schedule))
    nvml = NvmlBackend()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, joules = [], [], [], None
    t_steady = time.perf_counter()
    for i, batch in enumerate(batches):
        if i == 1:
            wait_tick(nvml)
            e0 = nvml._energy_mj(nvml._handles[0])
            t_steady = time.perf_counter()
        _zero_launches()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        params, opt, met = step(params, opt, batch)
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
        launches.append(_kernel_launches()["B1"])
        losses.append(float(met["loss"]))
    wait_tick(nvml)
    joules = (nvml._energy_mj(nvml._handles[0]) - e0) * 1e-3 / \
        (len(batches) - 1)
    nvml.close()
    steady_s = (time.perf_counter() - t_steady) / (len(batches) - 1)
    peak = torch.cuda.max_memory_allocated()
    tokens = shape[0] * shape[1]
    mean_ms = sum(ms[1:]) / len(ms[1:])
    rec = {"schedule": schedule, "losses": losses, "ms": ms,
           "ms_per_step": mean_ms, "tok_per_s": tokens / mean_ms * 1e3,
           "launches": launches, "j_per_step": joules,
           "watts": joules / steady_s, "peak_gb": peak / 1e9}
    print(f"[train] (b) {cfg.name} {schedule}: losses "
          + ", ".join(f"{x:.6f}" for x in losses)
          + f"; ms per step " + ", ".join(f"{x:.1f}" for x in ms)
          + f" (steady {mean_ms:.1f} ms, {rec['tok_per_s']:.0f} tok/s); B1 "
          f"launches {launches}; {joules:.1f} J/step ({rec['watts']:.0f} W, "
          f"NVML); peak memory {peak / 1e9:.2f} GB ({smi})")
    extra = train_batches(cfg, len(batches) + 1, shape=shape)[-1]
    rec["profile"] = profile_train_step(cfg, step, params, opt, extra,
                                        mean_ms, smi, schedule)
    del params, opt
    torch.cuda.empty_cache()
    return rec


def time_train_gemms(cfg, n_params: int, smi: str) -> dict:
    """Train phase (e): B1 per launch at every train-step GEMM shape (L2
    flushed, CUDA events) beside ``torch.matmul`` on the same operands
    and the bound, summed over one step by role; and the step's bound
    (bytes of the GEMMs' operands and outputs and of AdamW's state,
    against the time of the GEMMs' operations at the bf16 tensor-core
    and the f32 rates)."""
    import torch

    from repro_torch.kernels.sfc_matmul import sfc_matmul_cuda

    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    gen = torch.Generator(device="cuda").manual_seed(256)
    by_role: dict[str, dict] = {}
    rows = []
    gemm_bytes = ops_s = 0.0
    for role, name, m, k, n, dtype, out_f32, count in train_gemms(cfg):
        a, b, _ = _gemm_inputs(m, k, n, dtype, gen, "none")
        out_dtype = torch.float32 if out_f32 else None
        ms = _time_ms(lambda: sfc_matmul_cuda(a, b, out_dtype=out_dtype), 5,
                      flush)
        lib = _time_ms(lambda: torch.matmul(a, b), 5, flush)
        size = a.element_size()
        out_size = 4 if out_f32 else size
        nbytes = (m * k + k * n) * size + m * n * out_size
        flop = 2.0 * m * n * k
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
            else F32_FLOPS_PER_S
        bound = max(nbytes / HBM_BYTES_PER_S, flop / peak) * 1e3
        rows.append({"role": role, "name": name, "m": m, "k": k, "n": n,
                     "dtype": str(dtype)[6:], "count": count, "ms": ms,
                     "library_ms": lib, "bound_ms": bound,
                     "tflops": flop / ms / 1e9})
        r = by_role.setdefault(role, {"ms": 0.0, "library_ms": 0.0,
                                      "bound_ms": 0.0, "flop": 0.0,
                                      "launches": 0})
        r["ms"] += count * ms
        r["library_ms"] += count * lib
        r["bound_ms"] += count * bound
        r["flop"] += count * flop
        r["launches"] += count
        gemm_bytes += count * nbytes
        ops_s += count * flop / peak
        del a, b
    tot = {key: sum(r[key] for r in by_role.values())
           for key in ("ms", "library_ms", "bound_ms", "flop", "launches")}
    adam_bytes = 30.0 * n_params   # bf16 p r/w, grad r, f32 master/m/v r/w
    step_bytes = gemm_bytes + adam_bytes
    step_bound = max(step_bytes / HBM_BYTES_PER_S, ops_s) * 1e3
    print(f"[train] (e) B1 per train step at its shapes, by role ({smi}):")
    for role, r in by_role.items():
        print(f"  {role:9s} {r['launches']:4d} launches: B1 {r['ms']:.1f} ms "
              f"({r['flop'] / r['ms'] / 1e9:.1f} TFLOP/s), torch.matmul "
              f"{r['library_ms']:.1f} ms, bound {r['bound_ms']:.2f} ms")
    print(f"  total     {tot['launches']:4d} launches: B1 {tot['ms']:.1f} ms, "
          f"torch.matmul {tot['library_ms']:.1f} ms "
          f"({tot['ms'] / tot['library_ms']:.1f}x), GEMM bound "
          f"{tot['bound_ms']:.2f} ms; "
          f"step bound {step_bound:.2f} ms (operations {ops_s * 1e3:.2f} ms, "
          f"bytes {step_bytes / 1e9:.1f} GB = "
          f"{step_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms, AdamW "
          f"{adam_bytes / 1e9:.1f} GB of it)")
    return {"per_shape": rows, "by_role": by_role, "total": tot,
            "step_bound_ms": step_bound, "step_ops_ms": ops_s * 1e3,
            "step_bytes": step_bytes, "card": smi}


def train_f32_check(cfg) -> dict:
    """Train phase (c): one step's gradients in f32 at full width and
    TRAIN_F32_LAYERS layers, Morton against the same step through the
    plain versions on the card: every leaf within TRAIN_F32_REL of the
    plain gradients' largest magnitude."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import grads_of
    from repro_torch.models import DotEngine
    from repro_torch.optim.adamw import tree_leaves

    c32 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                              param_dtype="float32", act_dtype="float32")
    params = train_params(c32)
    batch = train_batches(c32, 1)[0]
    eng = DotEngine(schedule="morton")
    lk, _, gk = grads_of(c32, params, batch, eng)
    with plain_versions():
        lp, _, gp = grads_of(c32, params, batch, eng)
    torch.cuda.synchronize()
    norm_rel, max_rel = _grad_errors(tree_leaves(gk), tree_leaves(gp))
    ok = max_rel <= TRAIN_F32_REL
    print(f"[train] (c) f32, full width, {TRAIN_F32_LAYERS} layers: "
          f"{'ok' if ok else 'FAIL'}: gradients Morton against the plain "
          f"versions, largest per-leaf max|diff| / max|plain| {max_rel:.3e} "
          f"(bound {TRAIN_F32_REL:g}), ||diff|| / ||plain|| {norm_rel:.3e}; "
          f"loss {float(lk):.7f} against {float(lp):.7f}")
    del params, gk, gp
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("chip_smoke: train (c) f32 gradients off the plain "
                         "versions")
    return {"grad_rel_max": max_rel, "grad_rel_norm": norm_rel,
            "loss_kernels": float(lk), "loss_plain": float(lp)}


def train_cli_phase() -> dict:
    """Train phase (d): the SMOKE config through ``launch/train.py``'s
    ``main`` on the card: a clean run, a run with a failure injected at
    CLI_FAIL_AT and a checkpoint every step (the final loss and every
    parameter bit-equal to the clean run's), then a second invocation
    on the same directory that resumes from its last checkpoint; B1's
    launches exact (the failed attempt makes none).  The cut: a
    qwen3-1.7b checkpoint (f32 master, m and v, ~24 GB) is too large to
    write in a smoke run."""
    import tempfile

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim.adamw import tree_leaves

    common = ["--arch", "qwen3_1_7b", "--smoke", "--batch", "4", "--seq",
              "32", "--log-every", "4", "--power-backend", "model",
              "--no-obs"]
    _zero_launches()
    clean = train_main(common + ["--steps", str(CLI_STEPS)])
    with tempfile.TemporaryDirectory() as d:
        ck = ["--ckpt-dir", d, "--ckpt-every", "1"]
        failed = train_main(common + ["--steps", str(CLI_STEPS),
                                      "--inject-failure-at",
                                      str(CLI_FAIL_AT)] + ck)
        resumed = train_main(common + ["--steps", str(CLI_RESUME_STEPS)]
                             + ck)
    torch.cuda.synchronize()
    launches = _kernel_launches()["B1"]
    per_step = train_launches_per_step(get_smoke_config("qwen3_1_7b"))
    want = (2 * CLI_STEPS + CLI_RESUME_STEPS) * per_step
    same = clean["last_loss"] == failed["last_loss"] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(clean["params"]),
                                          tree_leaves(failed["params"])))
    count = int(resumed["opt"]["count"])
    ok = same and count == CLI_STEPS + CLI_RESUME_STEPS and \
        launches == want and resumed["last_loss"] is not None
    print(f"[train] (d) SMOKE through launch/train.py: "
          f"{'ok' if ok else 'FAIL'}: clean loss {clean['last_loss']!r}, "
          f"with a failure at step {CLI_FAIL_AT} {failed['last_loss']!r} "
          f"({'bit-equal, every parameter too' if same else 'DIFFERENT'}); "
          f"resumed run ends at optimizer count {count} (want "
          f"{CLI_STEPS + CLI_RESUME_STEPS}), loss {resumed['last_loss']!r}; "
          f"B1 launches {launches} (want {want})")
    if not ok:
        raise SystemExit("chip_smoke: train (d) retry and resume failed")
    return {"clean_loss": clean["last_loss"],
            "failed_loss": failed["last_loss"],
            "resumed_loss": resumed["last_loss"], "resumed_count": count,
            "launches": launches}


def train_arch(cfg, smi: str, steps: int, roles,
               shape=(TRAIN_BATCH, TRAIN_SEQ),
               cut: str = "none") -> tuple[dict, dict]:
    """One arch's training at full width in bf16, at ``cfg``'s depth
    (``cut`` names a depth cut; seed-0 weights, ``PackedSyntheticData``
    seed-0 batches of ``shape`` = (batch, seq), TRAIN_BATCH x TRAIN_SEQ
    unless given): (a) B1's ``roles`` GEMMs at the train step's
    shapes against the plain version; (b) the step-0 gradient checks
    (``train_grads_checks``), then ``steps`` steps of
    ``make_train_step`` under Morton (every projection's forward, dgrad
    and wgrad through B1) and under "xla" from the same state, each with
    its joules and a profiled step.  Gates: the step-0 loss within
    LOSS0_BOUND of ln(vocab) (unit-variance random logits add ~0.5); the
    loss falling where there are more than 2 steps (Adam's first update
    is lr x sign(g), too early to call a trend); |loss Morton - loss
    "xla"| <= TRAIN_LOSS_BOUND at every step (bf16 roundings; an element
    whose tiny gradient differs in sign moves 2 lr the other way); B1's
    launches per step exactly ``train_launches_per_step`` under the
    config's remat, none under "xla".  Returns (record, the path's
    launches)."""
    import math

    import torch

    import repro_torch.kernels.grad as grad_mod

    torch.cuda.empty_cache()
    gemm_err = check_train_gemms(cfg, roles, shape)
    batches = train_batches(cfg, steps, shape=shape)
    params = train_params(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    want = train_launches_per_step(cfg,
                                   remat_full=cfg.remat_policy == "full")
    print(f"[train] (b) {cfg.name} full width, {cfg.n_layers} layers, bf16, "
          f"{n_params / 1e9:.3f}e9 parameters, seed 0, remat "
          f"{cfg.remat_policy}; {steps} steps of {shape[0]} x "
          f"{shape[1]} tokens; B1 launches per step {want}; depth cut: "
          f"{cut}")
    grads = train_grads_checks(cfg, params, batches[0])
    del params
    torch.cuda.empty_cache()
    grad_mod.transpose_bytes = 0
    morton = run_train_steps(cfg, "morton", batches, smi, shape)
    t_bytes = grad_mod.transpose_bytes / (steps + 1)
    xla = run_train_steps(cfg, "xla", batches, smi, shape)
    fails = []
    ln_v = math.log(cfg.vocab)
    if abs(morton["losses"][0] - ln_v) > LOSS0_BOUND:
        fails.append(f"step-0 loss {morton['losses'][0]} not near {ln_v}")
    if steps > 2 and not morton["losses"][-1] < morton["losses"][0]:
        fails.append(f"loss did not fall: {morton['losses']}")
    dl = [abs(a - b) for a, b in zip(morton["losses"], xla["losses"])]
    if max(dl) > TRAIN_LOSS_BOUND:
        fails.append(f"|loss morton - xla| {dl}")
    if any(n != want for n in morton["launches"]) or any(xla["launches"]):
        fails.append(f"launches morton {morton['launches']}, xla "
                     f"{xla['launches']}")
    print(f"[train] (b) {cfg.name} gates: step-0 loss "
          f"{morton['losses'][0]:.4f} against ln(vocab) {ln_v:.4f} (bound "
          f"{LOSS0_BOUND}); |loss morton - xla| per step "
          + ", ".join(f"{x:.2e}" for x in dl)
          + f" (bound {TRAIN_LOSS_BOUND}); transposed operand copies "
          f"{t_bytes / 1e9:.3f} GB a step; "
          f"{'ok' if not fails else 'FAIL ' + str(fails)}")
    if fails:
        raise SystemExit(f"chip_smoke: train (b) {cfg.name} failed: {fails}")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "cut": cut,
           "batch": shape[0], "seq": shape[1], "params": n_params,
           "remat": cfg.remat_policy, "gemm_max_abs_err": gemm_err,
           "grads": grads, "morton": morton, "xla": xla,
           "launches_per_step": want, "transpose_gb_per_step": t_bytes / 1e9,
           "card": smi}
    return rec, {"B1": sum(morton["launches"])}


def train_phase(smi: str) -> tuple[dict, dict]:
    """The training path: qwen3-1.7b through ``train_arch`` (B1's
    backward GEMMs, TRAIN_STEPS steps), then (c) f32 gradients against
    the plain versions, (d) retry and resume through the CLI, (e) B1's
    timings at the step's shapes.  Returns the ``train`` line's object
    and the path's launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3_1_7b")
    rec, launches = train_arch(cfg, smi, TRAIN_STEPS, ("dgrad", "wgrad"))
    rec["f32"] = train_f32_check(cfg)
    rec["cli"] = train_cli_phase()
    rec["b1"] = time_train_gemms(cfg, rec["params"], smi)
    return rec, launches


# ----------------------------------------------------------- frontends ----
# slice 12: the encoder and the vlm at full width.  hubert-xlarge (all 48
# layers) encodes ENCODE_BATCH clips of ENCODE_FRAMES frames (20 s at
# HuBERT's 50 Hz frame rate) and trains FRONTEND_TRAIN_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ frames; llava-next-34b serves FAMILY_REQUESTS
# requests of FAMILY_MAX_NEW tokens at all 60 layers, and trains on
# LLAVA_TRAIN_LAYERS of them (4 layers with embed, head and AdamW's f32
# state take ~57 GB; 60 would not fit a card) on LLAVA_TRAIN_SHAPE
# tokens, so each row carries the whole 576-patch prefix under its loss
# mask.
ENCODE_BATCH, ENCODE_FRAMES = 4, 1024
ENCODE_REPS = 5                # timed encodes a schedule
ENCODE_WINDOW_S = 1.0          # least work in one metered encode window
FRONTEND_TRAIN_STEPS = 2
LLAVA_TRAIN_LAYERS = 4
LLAVA_TRAIN_SHAPE = (2, 2048)


def encode_gemms(cfg, tokens: int):
    """(name, M, K, N, epilogue, out f32, launches per forward) of every
    B1 call of an encoder's forward over ``tokens`` frames:
    ``frontend_proj`` (the stub's frame features into the model), each
    layer's projections (the decode step's, ``main_path_gemms``, at M =
    ``tokens``) and the vocab head: 7 L + 2."""
    rows = [("frontend_proj", tokens, cfg.frontend_dim, cfg.d_model, "none",
             False, 1)]
    rows += [(name, tokens, k, n, ep, f32, c)
             for name, _, k, n, ep, f32, c in main_path_gemms(cfg)]
    assert sum(r[-1] for r in rows) == \
        B1_PER_LAYER[cfg.family] * cfg.n_layers + 2
    return rows


def encode_run(cfg, params, batch, schedule: str, plain, smi: str) -> dict:
    """hubert's forward over ``batch`` under ``schedule``: its launches
    exact (7 L + 2 B1 under Morton, none under "xla", no B2), its logits
    finite and within LOGIT_BOUND of ``plain`` (the same forward on the
    plain versions), then ENCODE_REPS timed forwards (CUDA events), the
    joules of one (NVML, a window of >= ENCODE_WINDOW_S aligned to the
    counter's updates) and the peak memory."""
    import torch

    from repro_torch.models import DotEngine, forward
    from repro_torch.power import NvmlBackend

    eng = DotEngine(schedule=schedule)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    logits, _ = forward(params, cfg, batch, eng)
    torch.cuda.synchronize()
    launches = _kernel_launches()
    want = {"B1": 0 if schedule == "xla" else
            B1_PER_LAYER[cfg.family] * cfg.n_layers + 2, "B2": 0}
    real = slice(0, cfg.vocab)      # the padded columns read -1e30
    err = float((logits[..., real] - plain[..., real]).abs().max())
    finite = bool(torch.isfinite(logits[..., real]).all())
    frames = batch["features"].shape[0] * batch["features"].shape[1]
    ms = []
    for _ in range(ENCODE_REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        forward(params, cfg, batch, eng)
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    nvml = NvmlBackend()
    wait_tick(nvml)
    e0 = nvml._energy_mj(nvml._handles[0])
    t0 = time.perf_counter()
    n = 0
    while n < 2 or time.perf_counter() - t0 < ENCODE_WINDOW_S:
        forward(params, cfg, batch, eng)
        torch.cuda.synchronize()
        n += 1
    wait_tick(nvml)
    joules = (nvml._energy_mj(nvml._handles[0]) - e0) * 1e-3 / n
    window = time.perf_counter() - t0
    nvml.close()
    peak = torch.cuda.max_memory_allocated()
    mean_ms = sorted(ms)[len(ms) // 2]
    rec = {"schedule": schedule, "launches": launches,
           "logit_err_vs_plain": err, "ms": ms, "ms_per_encode": mean_ms,
           "frames_per_s": frames / mean_ms * 1e3, "j_per_encode": joules,
           "watts": joules * n / window, "metered_encodes": n,
           "peak_gb": peak / 1e9}
    ok = finite and launches == want and (schedule == "xla"
                                          or err <= LOGIT_BOUND)
    print(f"[frontends] {cfg.name} encode {batch['features'].shape[0]} x "
          f"{batch['features'].shape[1]} frames, {schedule}: "
          f"{'ok' if ok else 'FAIL'}: launches {launches} (want {want}); "
          f"max |logit diff| against the plain versions {err:.4e} (bound "
          f"{LOGIT_BOUND:g}{', printed, not gated' if schedule == 'xla' else ''}"
          f"); {mean_ms:.2f} ms an encode (median of "
          + ", ".join(f"{x:.2f}" for x in ms)
          + f"), {rec['frames_per_s']:.0f} frames/s; {joules:.2f} J an "
          f"encode over {n} ({rec['watts']:.0f} W, NVML); peak memory "
          f"{peak / 1e9:.2f} GB ({smi})")
    if not ok:
        raise SystemExit(f"chip_smoke: {cfg.name} encode under {schedule} "
                         f"failed")
    return rec


def hubert_phase(smi: str) -> tuple[dict, dict]:
    """hubert-xlarge at full width and all 48 layers (bf16, seed 0): B1 at
    its encode shapes against the plain version and bit-equal twice, the
    encode under Morton and "xla" (``encode_run``), B1 per encode timed
    beside its bound, the plain version and ``torch.matmul``, then
    training through ``train_arch`` (22 L + 5 B1 a step under "dots").
    Returns (record, launches by path)."""
    import torch

    from repro_torch.models import DotEngine, forward, make_batch
    from repro_torch.models.config import ShapeSpec

    cfg, params = init_arch("hubert_xlarge")
    tokens = ENCODE_BATCH * ENCODE_FRAMES
    rows = encode_gemms(cfg, tokens)
    rep = Report()
    gen = torch.Generator(device="cuda").manual_seed(2026)
    err = 0.0
    print(f"[kernels] {cfg.name}: B1 at its encode shapes ({tokens} frames)")
    for name, m, k, n, ep, f32, _ in rows:
        err = max(err, b1_check(rep, gen, name, m, k, n, torch.bfloat16, ep,
                                f32))
        b1_same_twice(rep, gen, name, m, k, n, torch.bfloat16, ep, f32)
    rep.raise_if_failed(f"{cfg.name} kernel checks")
    batch = make_batch(cfg, ShapeSpec("encode", seq_len=ENCODE_FRAMES,
                                      global_batch=ENCODE_BATCH,
                                      kind="prefill"), device="cuda")
    runs, by_path = {}, {}
    with torch.no_grad():
        with plain_versions():
            plain, _ = forward(params, cfg, batch,
                               DotEngine(schedule="morton"))
        for schedule in ("morton", "xla"):
            runs[schedule] = encode_run(cfg, params, batch, schedule, plain,
                                        smi)
            by_path[f"{cfg.name} encode {schedule}"] = \
                runs[schedule]["launches"]
    del plain
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    b1 = time_b1(cfg.name, rows, scratch.zero_, iters=10)
    del scratch
    print(f"[time] {cfg.name} B1 per encode ({tokens} frames): "
          f"{b1['ms']:.2f} ms against a {b1['bound_ms']:.2f} ms bound "
          f"({b1['bound_by']}, {b1['bound_ms'] / b1['ms']:.1%}), "
          f"torch.matmul {b1['library_ms']:.2f} ms, plain "
          f"{b1['plain_ms']:.2f} ms; the encode {runs['morton']['ms_per_encode']:.2f}"
          f" ms, \"xla\" {runs['xla']['ms_per_encode']:.2f} ms ({smi})")
    del params, batch
    torch.cuda.empty_cache()
    train, n = train_arch(cfg, smi, FRONTEND_TRAIN_STEPS,
                          ("fwd", "dgrad", "wgrad"))
    by_path[f"train {cfg.name}"] = n
    step = {"arch": cfg.name,
            "layout": f"encode {ENCODE_BATCH}x{ENCODE_FRAMES}",
            "times": {"B1": b1}, "launches": runs["morton"]["launches"]}
    return {"arch": cfg.name, "layers": cfg.n_layers, "cut": "none",
            "frames": [ENCODE_BATCH, ENCODE_FRAMES], "kernel_max_abs_err": err,
            "encode": runs, "train": train, "step": step}, by_path


def llava_phase(smi: str) -> tuple[dict, dict]:
    """llava-next-34b at full width and all 60 layers (68.8 GB of bf16
    weights drawn a layer at a time, seed 0; its peak memory printed): its
    B1 decode and chunk shapes and B2 at group 7 against the plain
    versions (``check_arch_kernels``), B1 at ``frontend_proj``'s shape
    (the 576-patch prefix, the tile path) likewise and bit-equal twice,
    4 requests of 8 new tokens continuous, paged and contiguous (token
    agreement printed), its paged and contiguous decode steps against the
    plain versions (``layout_step``, the paged one timed), ``frontend_proj``
    timed, the f32 layouts check on its first F32_CHECK_LAYERS layers;
    then training at full width on LLAVA_TRAIN_LAYERS layers through
    ``train_arch`` (29 L + 5 B1 a step under its remat "full").  Returns
    (record, launches by path)."""
    import dataclasses

    import torch

    from repro_torch.optim.adamw import _tree_map

    cfg, params = init_arch("llava_next_34b")
    init_peak = torch.cuda.max_memory_allocated()
    errs = check_arch_kernels(cfg, paged=True)
    front = ("frontend_proj", cfg.frontend_tokens, cfg.frontend_dim,
             cfg.d_model, "none", False, 1)
    rep = Report()
    gen = torch.Generator(device="cuda").manual_seed(2027)
    _, m, k, n, ep, f32, _ = front
    errs["frontend_proj"] = max(
        b1_check(rep, gen, "frontend_proj", m, k, n, dtype, ep, f32)
        for dtype in (torch.bfloat16, torch.float32))
    b1_same_twice(rep, gen, "frontend_proj", m, k, n, torch.bfloat16, ep, f32)
    rep.raise_if_failed(f"{cfg.name} frontend_proj checks")
    by_path = {}
    prompts = serving_prompts(cfg)[:FAMILY_REQUESTS]
    runs = {}
    for layout in ("paged", "contiguous"):
        runs[layout] = serve(cfg, params, "continuous", layout, prompts,
                             FAMILY_MAX_NEW,
                             tag=f"[serve {cfg.name} continuous {layout}]")
        by_path[f"{cfg.name} continuous {layout}"] = runs[layout]["launches"]
    serve_rows = [serve_row(runs["paged"]),
                  serve_row(runs["contiguous"], runs["paged"])]
    print(f"[frontends] {cfg.name} contiguous: generated tokens agreeing "
          f"with the paged run per request "
          f"{serve_rows[-1]['agree_with_paged']} of {FAMILY_MAX_NEW} "
          f"(printed, not gated); "
          + "; ".join(f"{r['layout']} {r['tok_per_s']:.2f} tok/s, "
                      f"{r['ms_per_decode_step']:.3f} ms a decode step, "
                      f"{r['j_per_token']:.4f} J/token" for r in serve_rows)
          + f" ({smi})")
    del runs
    steps = [layout_step(cfg, params, layout, smi, cut="none",
                         timed=layout == "paged")
             for layout in ("paged", "contiguous")]
    for r in steps:
        r["kernel_checks"] = errs
        by_path[f"{cfg.name} {r['layout']} step"] = r["launches"]
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    front_t = time_b1(cfg.name, [front], scratch.zero_)
    del scratch
    peak = torch.cuda.max_memory_allocated()
    print(f"[frontends] {cfg.name} at all {cfg.n_layers} layers: peak memory "
          f"{init_peak / 1e9:.2f} GB after init, {peak / 1e9:.2f} GB after "
          f"its steps; frontend_proj {m}x{k}x{n} {front_t['ms']:.4f} ms "
          f"(bound {front_t['bound_ms']:.4f}, torch.matmul "
          f"{front_t['library_ms']:.4f}) ({smi})")
    cut = dataclasses.replace(cfg, n_layers=F32_CHECK_LAYERS)
    params = {**params, "layers": _tree_map(
        lambda t: t[:F32_CHECK_LAYERS].clone(), params["layers"])}
    torch.cuda.empty_cache()
    f32 = {**layouts_agree_f32(cut, params),
           "cut": f"{F32_CHECK_LAYERS} of {cfg.n_layers} layers"}
    del params
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, n_layers=LLAVA_TRAIN_LAYERS)
    train, n = train_arch(
        tcfg, smi, FRONTEND_TRAIN_STEPS, ("fwd", "dgrad", "wgrad"),
        shape=LLAVA_TRAIN_SHAPE,
        cut=f"{LLAVA_TRAIN_LAYERS} of {cfg.n_layers} layers")
    by_path[f"train {cfg.name} ({LLAVA_TRAIN_LAYERS} layers)"] = n
    return {"arch": cfg.name, "layers": cfg.n_layers, "cut": "none",
            "init_peak_gb": init_peak / 1e9, "peak_gb": peak / 1e9,
            "kernel_checks": errs, "serve": serve_rows, "step": steps,
            "frontend_proj": front_t, "paged_vs_contiguous_f32": f32,
            "train": train}, by_path


def frontends_phase(smi: str) -> tuple[dict, dict]:
    """Slice 12: hubert-xlarge (``hubert_phase``), then llava-next-34b
    (``llava_phase``), each freed before the next.  Returns (the
    ``frontends`` line's object, launches by path)."""
    import torch

    torch.cuda.empty_cache()
    hubert, by_path = hubert_phase(smi)
    torch.cuda.empty_cache()
    llava, llava_paths = llava_phase(smi)
    by_path.update(llava_paths)
    torch.cuda.empty_cache()
    return {"hubert": hubert, "llava": llava, "card": smi}, by_path


# --------------------------------------------------------- distributed ----
# slice 13: the distributed layer on the card at world size 1 (one card
# on the machine; NCCL takes one rank per card).  B1 at the shapes one
# tensor-parallel rank of qwen3-1.7b launches on a TP_WAYS-way model axis
# and B2 at its local kv-heads; the sharded train step through the CLI's
# --mesh 1,1,1 beside the unsharded one from the same state; the sharded
# serve step in both layouts beside the unsharded decode step.
TP_WAYS = (2, 8)
DIST_TRAIN_STEPS = 2
DIST_LOSS_REL = 1e-3    # |loss sharded - loss unsharded| / |unsharded|
DIST_SERVE_STEPS = 8
SHARD_TOKENS = 4096     # B2's tokens per slot at the local kv-heads


def shard_gemms(cfg, ways: int, rows: int):
    """(name, M, K, N, epilogue, out f32, launches a step) of one
    tensor-parallel rank's B1 calls on a ``ways``-way model axis at M =
    ``rows``: N / ways for the column-parallel wq, wk, wv, w1, w3 and the
    head, K / ways for the row-parallel wo and w2, whose partial products
    leave in f32 (the residual is added after the all-reduce).  The head
    runs in a decode step only (a chunk's count is 0)."""
    d, n_l = cfg.d_model, cfg.n_layers
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    f, v = cfg.d_ff, cfg.padded_vocab
    return [("wq", rows, d, hd // ways, "none", False, n_l),
            ("wk|wv", rows, d, kvd // ways, "none", False, 2 * n_l),
            ("wo", rows, hd // ways, d, "none", True, n_l),
            ("w1+silu", rows, d, f // ways, "silu", False, n_l),
            ("w3", rows, d, f // ways, "none", False, n_l),
            ("w2", rows, f // ways, d, "none", True, n_l),
            ("head->f32", rows, d, v // ways, "none", True,
             1 if rows == SLOTS else 0)]


def shard_kernels(cfg, smi: str) -> tuple[dict, dict]:
    """B1 at every shard shape (decode M = SLOTS, bf16 and f32, two
    launches bit-equal; chunk M = SLOTS x PREFILL_BUDGET, bf16) and B2 at
    each shard's local kv-heads (group 2, SHARD_TOKENS a slot, bf16 and
    f32) against the plain versions, then timed (CUDA events, L2
    flushed) beside ``torch.matmul`` and the bound.  Returns the B1 and B2
    records by shard."""
    import dataclasses

    import torch

    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    rep = Report()
    gen = torch.Generator(device="cuda").manual_seed(1313)
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    b1, b2 = {}, {}
    for ways in TP_WAYS:
        print(f"[distributed] B1 at a {ways}-way model axis' shard shapes")
        for rows, what in ((SLOTS, "decode"),
                           (SLOTS * PREFILL_BUDGET, "chunk")):
            gemms = shard_gemms(cfg, ways, rows)
            for name, m, k, n, ep, f32, _ in gemms:
                for dtype in ((torch.bfloat16, torch.float32)
                              if what == "decode" else (torch.bfloat16,)):
                    b1_check(rep, gen, f"tp{ways} {name}", m, k, n, dtype,
                             ep, f32)
                if what == "decode":
                    b1_same_twice(rep, gen, f"tp{ways} {name}", m, k, n,
                                  torch.bfloat16, ep, f32)
            rec = time_b1(f"tp{ways} {what}", gemms, flush)
            rec["launches"] = sum(g[-1] for g in gemms)
            b1[f"qwen3-1.7b tp{ways} shard {what}"] = rec
            print(f"[time] tp{ways} shard B1 a {what} step: {rec['ms']:.3f} "
                  f"ms, bound {rec['bound_ms']:.3f} ({rec['bound_by']}), "
                  f"torch.matmul {rec['library_ms']:.3f} ({smi})")
        kv = cfg.n_kv_heads // ways
        scfg = dataclasses.replace(cfg, n_heads=2 * kv, n_kv_heads=kv)
        pos = torch.full((SLOTS,), SHARD_TOKENS - 1, dtype=torch.int32,
                         device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tab = long_context_inputs(scfg, SHARD_TOKENS, dtype,
                                                 gen)
            b2_check(rep, f"tp{ways} shard {kv} kv-heads group 2 "
                     f"{SHARD_TOKENS} tokens", q, kp, vp, tab, pos)
            if dtype is torch.bfloat16:
                ms = _time_ms(lambda: paged_decode_attention_cuda(
                    q, kp, vp, tab, pos), 20, flush)
                plain = _time_ms(lambda: paged_decode_attention_ref(
                    q, kp, vp, tab, pos), 3, flush)
                _, bound = b2_bound(q, kp, tab, pos)
                b2[f"qwen3-1.7b tp{ways} shard {kv} kv-heads "
                   f"{SHARD_TOKENS} tokens"] = {
                    "ms": ms, "plain_ms": plain, "bound_ms": bound,
                    "bound_by": "bytes", "library_ms": None,
                    "launches": cfg.n_layers}
                print(f"[time] tp{ways} shard B2 ({kv} kv-heads, group 2, "
                      f"{SHARD_TOKENS} tokens): {ms:.4f} ms a launch, plain "
                      f"{plain:.4f}, bound {bound:.5f} ({smi})")
            del q, kp, vp, tab
        torch.cuda.empty_cache()
    rep.raise_if_failed("distributed shard kernels")
    return b1, b2


def dist_train(cfg, smi: str) -> tuple[dict, dict]:
    """``launch/train.py``'s ``main`` with --mesh 1,1,1 (the sharded step
    on this world of one rank) and without (the unsharded
    ``make_train_step``), each from the seed-0 state on the same
    PackedSyntheticData batches: losses within DIST_LOSS_REL, B1's
    launches ``train_launches_per_step`` a step on both, the sharded
    step's collectives by kind; host ms and NVML joules a step from the
    CLI's history."""
    import torch

    from repro_torch.distributed import ctx as dctx
    from repro_torch.launch.train import main as train_main

    common = ["--arch", "qwen3_1_7b",
              "--steps", str(DIST_TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--log-every", "1",
              "--power-backend", "nvml", "--no-obs"]
    per_step = train_launches_per_step(cfg)
    runs = {}
    for name, extra in (("sharded", ["--mesh", "1,1,1"]), ("unsharded", [])):
        _zero_launches()
        dctx.COLLECTIVES.clear()
        state = train_main(common + extra)
        torch.cuda.synchronize()
        hist = state["history"]
        runs[name] = {
            "losses": [h["loss"] for h in hist],
            "ms": [h["ms"] for h in hist],
            "joules": [h["joules"] for h in hist],
            "launches": _kernel_launches()["B1"],
            "collectives_per_step": {k: v / DIST_TRAIN_STEPS for k, v in
                                     sorted(dctx.COLLECTIVES.items())},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    s, u = runs["sharded"], runs["unsharded"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(s["losses"], u["losses"]))
    want = DIST_TRAIN_STEPS * per_step
    ok = rel <= DIST_LOSS_REL and s["launches"] == u["launches"] == want \
        and len(s["losses"]) == DIST_TRAIN_STEPS
    print(f"[distributed] train --mesh 1,1,1 {'ok' if ok else 'FAIL'}: "
          f"losses {s['losses']} against {u['losses']} (max rel "
          f"{rel:.3e}, bound {DIST_LOSS_REL:g}); B1 {s['launches']} and "
          f"{u['launches']} launches (want {want}, {per_step} a step); ms a "
          f"step {[round(x, 1) for x in s['ms']]} against "
          f"{[round(x, 1) for x in u['ms']]}; J a step "
          f"{[round(x, 1) for x in s['joules']]} against "
          f"{[round(x, 1) for x in u['joules']]}; collectives a step "
          f"{s['collectives_per_step']} ({smi})")
    if not ok:
        raise SystemExit("chip_smoke: distributed train failed")
    return {"sharded": s, "unsharded": u, "max_loss_rel": rel,
            "launches_per_step": per_step}, {"B1": s["launches"]}


def dist_serve(cfg, smi: str) -> tuple[dict, dict]:
    """``build_serve_step`` at world size 1, paged (B2 on the kv-head
    shard, here every head) and contiguous (the sequence-parallel
    attention), DIST_SERVE_STEPS greedy steps of SLOTS slots from the
    same state beside the unsharded ``decode_step``: every step's logits
    within LOGIT_BOUND, the greedy tokens equal, B1 7 L + 1 and B2 L (paged)
    launches a step; host ms a step on both."""
    import torch

    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import SHAPES, decode_step, init_decode_state
    from repro_torch.models.config import ShapeSpec
    from repro_torch.serve.paged_kv import init_paged_serving

    SHAPES["chip_dist"] = ShapeSpec("chip_dist", CACHE_LEN, SLOTS, "decode")
    mesh = make_smoke_mesh((1, 1, 1))
    params = train_params(cfg)
    out, launches = {}, {}
    first = torch.tensor([[p[0]] for p in serving_prompts(cfg)[:SLOTS]],
                         dtype=torch.int32, device="cuda")
    for layout in ("paged", "contiguous"):
        fn, (ps, ss, ts, ls), _ = build_serve_step(
            cfg, mesh, "chip_dist", cache_len=CACHE_LEN, layout=layout,
            page_size=PAGE_SIZE)
        if layout == "paged":
            alloc, state = init_paged_serving(cfg, SLOTS, CACHE_LEN,
                                              page_size=PAGE_SIZE,
                                              device="cuda")
            for slot in range(SLOTS):
                alloc.ensure_range(slot, DIST_SERVE_STEPS)
            state["block_tables"] = torch.as_tensor(alloc.block_table,
                                                    device="cuda")
        else:
            state = init_decode_state(cfg, SLOTS, CACHE_LEN, device="cuda")
        local = shard_tree(params, ps, mesh)
        sstate = shard_tree(state, ss, mesh)
        rec = {}
        for name in ("sharded", "unsharded"):
            toks, logits, tokens, ms = first.clone(), [], [], []
            _zero_launches()
            dctx.COLLECTIVES.clear()
            with torch.no_grad():
                for pos in range(DIST_SERVE_STEPS):
                    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if name == "sharded":
                        lg, sstate = fn(local, sstate, toks, p)
                    else:
                        lg, state = decode_step(params, cfg, state, toks, p)
                    toks = lg[:, 0].argmax(-1).to(torch.int32)[:, None]
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    logits.append(lg)
                    tokens.append(toks[:, 0].tolist())
            rec[name] = {"logits": logits, "tokens": tokens, "ms": ms,
                         "launches": _kernel_launches(),
                         "collectives_per_step": {
                             k: v / DIST_SERVE_STEPS for k, v in
                             sorted(dctx.COLLECTIVES.items())}}
        s, u = rec["sharded"], rec["unsharded"]
        err = max(float((a - b).abs().max())
                  for a, b in zip(s["logits"], u["logits"]))
        n_l = cfg.n_layers
        want = {"B1": DIST_SERVE_STEPS * (7 * n_l + 1),
                "B2": DIST_SERVE_STEPS * n_l if layout == "paged" else 0}
        ok = err <= LOGIT_BOUND and s["tokens"] == u["tokens"] and \
            s["launches"] == u["launches"] == want
        print(f"[distributed] serve {layout} {'ok' if ok else 'FAIL'}: "
              f"{DIST_SERVE_STEPS} steps, logits max err {err:.4e} (bound "
              f"{LOGIT_BOUND}), greedy tokens equal "
              f"{s['tokens'] == u['tokens']}; launches {s['launches']} and "
              f"{u['launches']} (want {want}); ms a step "
              f"{sum(s['ms'][1:]) / (DIST_SERVE_STEPS - 1):.2f} against "
              f"{sum(u['ms'][1:]) / (DIST_SERVE_STEPS - 1):.2f}; "
              f"collectives a step {s['collectives_per_step']} ({smi})")
        if not ok:
            raise SystemExit(f"chip_smoke: distributed serve {layout} failed")
        out[layout] = {"max_logit_err": err, "tokens": s["tokens"],
                       "ms": s["ms"], "unsharded_ms": u["ms"],
                       "collectives_per_step": s["collectives_per_step"]}
        launches[f"serve {layout}"] = s["launches"]
        del local, sstate, state, rec
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out, launches


def distributed_phase(smi: str) -> tuple[dict, dict, dict, dict]:
    """Slice 13, last: a world of one NCCL rank through a ``FileStore``
    in a temporary directory (no network); the shard kernels
    (``shard_kernels``), the sharded train step (``dist_train``) and
    serve step (``dist_serve``) on qwen3-1.7b at full width and depth,
    bf16, seed 0; the world closed after.  Returns (the ``distributed``
    line's object, launches by path, B1's and B2's shard records)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.ctx import init_world

    t0 = time.perf_counter()
    cfg = get_config("qwen3_1_7b")
    with tempfile.TemporaryDirectory() as d:
        init_world(0, 1, f"{d}/store", "cuda")
        try:
            nccl = ".".join(str(x) for x in torch.cuda.nccl.version())
            print(f"[distributed] backend {dist.get_backend()}, NCCL {nccl}, "
                  f"world size {dist.get_world_size()} ({smi})")
            b1, b2 = shard_kernels(cfg, smi)
            train, train_launches = dist_train(cfg, smi)
            serve_rec, serve_launches = dist_serve(cfg, smi)
        finally:
            dist.destroy_process_group()
    secs = time.perf_counter() - t0
    print(f"[distributed] phase took {secs:.1f} s")
    rec = {"backend": "nccl", "nccl": nccl, "world_size": 1,
           "train": train, "serve": serve_rec, "seconds": secs, "card": smi}
    return rec, {"distributed train --mesh 1,1,1": train_launches,
                 **{f"distributed {k}": v for k, v in
                    serve_launches.items()}}, b1, b2


# ------------------------------------------------------------- dry-run ----
# slice 14: the step counter (launch/opcount.py, the dry-run's) around one
# real step on the card and around the same step's meta twin.  The two
# must agree exactly; the meta twin's memory is an estimate, held beside
# torch's allocator peak (a gap over DRYRUN_MEM_REL is printed and
# explained in PERF.md, not a gate).
DRYRUN_POS = 5           # the decode step's position
DRYRUN_MEM_REL = 0.2
DRYRUN_EQUAL = ("flops", "traffic_bytes", "traffic_bytes_upper",
                "collectives", "gemms", "kernels")


def dryrun_twins(cfg, device: str = "cuda") -> dict:
    """``cfg``'s train step (Morton, seed 0 weights and a seed 0
    ``PackedSyntheticData`` batch of TRAIN_BATCH x TRAIN_SEQ, AdamW as
    ``run_train_steps`` builds it) and its contiguous decode step
    (SLOTS slots of CACHE_LEN entries, position DRYRUN_POS), each
    counted by ``count_step`` on ``device`` and on its meta twin (the
    same builders' meta tensors).  On the card also the allocator's
    peak over the train step and the memory allocated before it."""
    import torch

    from repro_torch.data import PackedSyntheticData
    from repro_torch.data.pipeline import batch_to_device
    from repro_torch.launch.opcount import count_step
    from repro_torch.launch.steps import abstract_train_state, \
        make_train_step
    from repro_torch.models import DotEngine, init_decode_state, init_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.transformer import decode_step
    from repro_torch.optim import AdamWConfig, init_opt_state

    cuda = device == "cuda"
    engine = DotEngine(schedule="morton")
    step = make_train_step(cfg, None, AdamWConfig(
        peak_lr=TRAIN_LR, warmup=1, total_steps=TRAIN_STEPS), engine=engine)
    data = PackedSyntheticData(cfg, ShapeSpec(
        "chip", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, kind="train"),
        seed=0)
    batch = batch_to_device(data.batch(0), device)
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    opt = init_opt_state(params)
    out = {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["allocated_before"] = torch.cuda.memory_allocated()
    out["train"] = count_step(step, params, opt, batch)
    if cuda:
        torch.cuda.synchronize()
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params, opt
    p_m, o_m = abstract_train_state(cfg)
    b_m = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    out["train_meta"] = count_step(step, p_m, o_m, b_m)

    def decode(p, st, toks, pos):
        with torch.no_grad():
            return decode_step(p, cfg, st, toks, pos, engine)

    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    g = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(2, cfg.vocab, (SLOTS, 1), generator=g,
                         dtype=torch.int32).to(device)
    state = init_decode_state(cfg, SLOTS, CACHE_LEN, device=device)
    pos = torch.tensor(DRYRUN_POS, dtype=torch.int32, device=device)
    out["decode"] = count_step(decode, params, state, toks, pos)
    del params, state
    if cuda:
        torch.cuda.empty_cache()
    out["decode_meta"] = count_step(
        decode, init_model(cfg, device="meta"),
        init_decode_state(cfg, SLOTS, CACHE_LEN, device="meta"),
        torch.empty_like(toks, device="meta"),
        torch.empty_like(pos, device="meta"))
    return out


def _b1(count: dict) -> int:
    return sum(v["launches"] for k, v in count["kernels"].items()
               if k.startswith("b1"))


def dryrun_phase(smi: str, train_ms: float) -> tuple[dict, dict]:
    """Slice 14: ``dryrun_twins`` on qwen3-1.7b at full width and depth
    in bf16.  Gates: for the train step and the decode step, the card's
    count and the meta twin's equal in FLOPs, GEMM shapes (and routes),
    collectives and both traffic models; B1's launches, as the kernel
    wrapper counted them on the card and as both counts route them,
    ``train_launches_per_step`` (619) a train step and 7 L + 1 a decode
    step.  Printed: the meta twin's argument + temp beside the card's
    ``max_memory_allocated`` over the train step, and the train step's
    roofline fraction, ``model_flops`` / (``train_ms`` x the H100
    model's peak), ``train_ms`` being ``train_phase``'s steady Morton
    step.  Returns (the ``dryrun`` line's object, the path's launches)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.energy import H100
    from repro_torch.launch.roofline import model_flops

    t0 = time.perf_counter()
    cfg = get_config("qwen3_1_7b")
    torch.cuda.empty_cache()
    _zero_launches()
    tw = dryrun_twins(cfg)
    fails = []
    want = {"train": train_launches_per_step(cfg),
            "decode": B1_PER_LAYER[cfg.family] * cfg.n_layers + 1}
    rec = {}
    for kind in ("train", "decode"):
        card, meta = tw[kind], tw[f"{kind}_meta"]
        diff = [k for k in DRYRUN_EQUAL if card[k] != meta[k]]
        launched = card["launched"]["b1"]
        if diff:
            fails.append(f"{kind}: card and meta differ in {diff}")
        if not launched == _b1(card) == _b1(meta) == want[kind]:
            fails.append(f"{kind}: B1 launched {launched}, counted "
                         f"{_b1(card)} (card) and {_b1(meta)} (meta), "
                         f"want {want[kind]}")
        census = {k: (card["op_census"].get(k), meta["op_census"].get(k))
                  for k in set(card["op_census"]) | set(meta["op_census"])
                  if card["op_census"].get(k) != meta["op_census"].get(k)}
        rec[kind] = {"flops": card["flops"],
                     "traffic_bytes": card["traffic_bytes"],
                     "traffic_bytes_upper": card["traffic_bytes_upper"],
                     "collectives": card["collectives"]["total_count"],
                     "kernels": card["kernels"], "launched": card["launched"],
                     "equal": not diff, "census_diff": census,
                     "memory_card": card["memory"],
                     "memory_meta": meta["memory"]}
        print(f"[dryrun] {cfg.name} {kind} step: card {card['flops']:.6e} "
              f"FLOPs, traffic {card['traffic_bytes']:.6e} B fused / "
              f"{card['traffic_bytes_upper']:.6e} B upper, "
              f"{len(card['gemms'])} GEMM shapes, "
              f"{card['collectives']['total_count']} collectives; meta twin "
              f"{'equal' if not diff else 'DIFFERS in ' + str(diff)}; B1 "
              f"launched {launched}, routed {_b1(card)} (card) / "
              f"{_b1(meta)} (meta), want {want[kind]}; op census "
              f"differences {census or 'none'}")
    mem = tw["train_meta"]["memory"]
    meta_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    card_peak = tw["max_memory_allocated"]
    other = tw["allocated_before"] - \
        tw["train"]["memory"]["argument_size_in_bytes"]
    rel = meta_peak / card_peak - 1.0
    mf = model_flops({"kind": "train", "active_params":
                      cfg.active_params_count(), "seq_len": TRAIN_SEQ,
                      "global_batch": TRAIN_BATCH})
    frac = mf / (train_ms * 1e-3 * H100.peak_flops)
    hw_frac = tw["train"]["flops"] / (train_ms * 1e-3 * H100.peak_flops)
    secs = time.perf_counter() - t0
    print(f"[dryrun] {cfg.name} train step memory: meta argument + temp "
          f"{meta_peak / 1e9:.3f} GB beside the card's "
          f"max_memory_allocated {card_peak / 1e9:.3f} GB ({rel:+.1%}; "
          f"{other / 1e9:.3f} GB of it allocated before the step and not "
          f"an argument; stated bound {DRYRUN_MEM_REL:.0%}, not a gate) "
          f"({smi})")
    print(f"[dryrun] {cfg.name} train step roofline fraction: model_flops "
          f"{mf:.6e} / ({train_ms:.1f} ms measured x H100 model peak "
          f"{H100.peak_flops:.4g} FLOP/s) = {frac:.4f}; counted FLOPs "
          f"{tw['train']['flops']:.6e} give {hw_frac:.4f}; phase "
          f"{secs:.1f} s ({smi})")
    rec.update({"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "meta_argument_plus_temp": meta_peak,
                "card_max_memory_allocated": card_peak,
                "card_allocated_before_not_argument": other,
                "memory_rel": rel, "model_flops": mf, "train_ms": train_ms,
                "roofline_fraction": frac, "counted_flops_fraction": hw_frac,
                "seconds": secs, "card": smi})
    if fails:
        raise SystemExit(f"chip_smoke: dryrun failed: {fails}")
    return rec, {"B1": _kernel_launches()["B1"]}


def examples_phase(smi: str) -> dict:
    """``examples_torch/quickstart.py`` and ``serve_lm.py`` (paged, so B1
    and B2 run) on the card, as subprocesses of this checkout (the
    kernels already built, a tuner cache of their own); a non-zero exit
    fails the run.  Returns each one's seconds and the last lines it
    printed."""
    import os
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_TUNE_CACHE=f"{d}/tune.json")
        for name, args in (("quickstart", []),
                           ("serve_lm", ["--layout", "paged"])):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
                 *args], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            secs = time.perf_counter() - t0
            tail = run.stdout.strip().splitlines()[-4:]
            print(f"[examples] {name}.py {' '.join(args)}: exit "
                  f"{run.returncode} in {secs:.1f} s ({smi})")
            for line in tail:
                print(f"[examples]   {line}")
            if run.returncode != 0:
                raise SystemExit(f"chip_smoke: examples_torch/{name}.py "
                                 f"exited {run.returncode}:\n"
                                 f"{run.stderr[-4000:]}")
            out[name] = {"seconds": secs, "tail": tail}
    return out


def main() -> int:
    import dataclasses

    import torch

    phase_s: dict[str, float] = {}   # wall seconds of each part of main()
    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        """Record the wall time since the previous lap under ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        print(f"[time] {name}: {phase_s[name]:.1f} s", flush=True)

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
    lap("start and build")

    nvml = nvml_phase(smi)
    cfg = get_config("qwen3_1_7b")
    errs = check_kernels(cfg)
    lap("nvml and kernel checks")

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
    cv = serve(cfg, params, "continuous")
    print(f"[serve continuous] {cv['tokens']} generated tokens in "
          f"{cv['wall_s']:.3f}s: {cv['tok_per_s']:.2f} tok/s "
          f"({cv['tok_per_s'] / sv['tok_per_s']:.2f}x lockstep), "
          f"{cv['steps']} decode steps of {cv['ms_per_decode_step']:.3f} ms "
          f"and {cv['chunk_steps']} prefill chunks of "
          f"{cv['ms_per_chunk_step']:.3f} ms (device-timeline spans; "
          f"lockstep {sv['ms_per_decode_step']:.3f} ms a step) ({smi})")
    agree = token_agreement(sv, cv)
    shared = serve_shared(cfg, params)
    lap("serve lockstep, continuous, shared")
    obs, obs_launches = serve_obs_phase(cfg, params, smi)
    lap("serve obs")
    faults, fault_launches = serve_faults_phase(cfg, params, smi)
    lap("serve faults")
    state, toks, pos = build_state(cfg, params)
    step = compare_step(cfg, params, state, toks, pos, LOGIT_BOUND)
    cstate, gang = chunk_state(cfg, params)
    chunk = compare_chunk(cfg, params, cstate, gang, KV_BOUND)
    compare_chunked_single(cfg, params, KV_BOUND)
    cfg32, params32, state32 = to_f32(cfg, params, state)
    compare_step(cfg32, params32, state32, toks, pos, LOGIT_BOUND_F32)
    compare_chunk(cfg32, params32, state_f32(cstate), gang, KV_BOUND_F32)
    compare_chunked_single(cfg32, params32, KV_BOUND_F32)
    del params32, state32
    torch.cuda.empty_cache()
    lap("step and chunk checks")
    rows, long_rows = time_kernels(cfg, state, pos, smi)
    b1_prefill = time_chunk_gemms(cfg, smi)
    prof_paged = profile_steps(cfg, params, state, toks, pos, smi)
    chunk_prof = profile_chunk(cfg, params, cstate, gang, smi)
    del params, state
    torch.cuda.empty_cache()
    lap("timings and profiles")
    study, b3_in, b4_in = locality_study()
    rows += time_study(b3_in, b4_in, smi)
    energy, energy_b3 = study_energy(b3_in, nvml["idle_watts"], smi)
    del b3_in, b4_in
    torch.cuda.empty_cache()
    lap("locality study")
    tuner, tuner_launches = tuner_phase(cfg, smi)
    lap("tuner")
    serve_layouts, layout_steps, ring, layout_launches = layouts_phase(
        sv, cv, prof_paged, smi)
    lap("layouts and dense archs")
    families, family_launches = families_phase(smi)
    layout_launches.update(family_launches)
    lap("families serving")
    mellum, mellum_launches = mellum2_phase(smi)
    layout_launches[f"{mellum['arch']} continuous paged"] = mellum_launches
    lap("mellum2")
    train, train_launches = train_phase(smi)
    lap("train qwen3-1.7b")
    dryrun, dryrun_launches = dryrun_phase(
        smi, train["morton"]["ms_per_step"])
    lap("dryrun")
    examples = examples_phase(smi)
    lap("examples")
    fam_train = []
    for name in FAMILY_TRAIN:
        full = get_config(name)
        rec, n = train_arch(
            dataclasses.replace(full, n_layers=FAMILY_TRAIN_LAYERS), smi,
            FAMILY_TRAIN_STEPS, ("fwd", "dgrad", "wgrad"),
            cut=f"{FAMILY_TRAIN_LAYERS} of {full.n_layers} layers")
        fam_train.append(rec)
        layout_launches[f"train {rec['arch']}"] = n
    families["train"] = fam_train
    families["card"] = smi
    lap("families training")
    frontends, frontend_launches = frontends_phase(smi)
    layout_launches.update(frontend_launches)
    lap("frontends")
    distributed, dist_launches, shard_b1, shard_b2 = distributed_phase(smi)
    layout_launches.update(dist_launches)
    lap("distributed")
    # every path's launches, each read just after its own zeroing: the
    # three serving runs, the observed and the faulted runs (summed over
    # each phase's runs), the study, the study's energy windows and the
    # tuner's search and auto GEMMs.  The kernels line keeps the main
    # path's: the continuous run's B1/B2 and the study's B3/B4, in the
    # units of its times (per step, per study)
    by_path = {"lockstep": sv["launches"], "continuous": cv["launches"],
               "shared": shared["launches"], "obs": obs_launches,
               "faults": fault_launches, "study": study,
               "study_energy": {"B3": energy_b3}, "tuner": tuner_launches,
               **layout_launches, "train": train_launches,
               "dryrun": dryrun_launches}
    launches = {**cv["launches"], "B3": study["B3"], "B4": study["B4"]}
    print(f"[launches] by path: {json.dumps(by_path)}; main path "
          f"{launches}")
    for row, kid in zip(rows, ("B1", "B2", "B3", "B4")):
        row["launches"] = launches[kid]
        row["max_abs_err"] = errs[kid]
    # per decode step of every other arch and layout (the families' new
    # shapes included), beside the serving shape's above
    for r in (layout_steps + families["step"] + [frontends["hubert"]["step"]]
              + frontends["llava"]["step"]):
        for row, kid in zip(rows[:2], ("B1", "B2")):
            if kid in r.get("times", {}):
                row.setdefault("by_arch", {})[
                    f"{r['arch']} {r['layout']}"] = {
                    **r["times"][kid], "launches": r["launches"][kid]}
    # one tensor-parallel rank's shapes (slice 13)
    for row, shard in zip(rows[:2], (shard_b1, shard_b2)):
        row.setdefault("by_arch", {}).update(shard)
    for row in long_rows:
        row["max_abs_err"] = errs[f"B2@{row['tokens_per_slot']}"]
    # mellum2's: B5 and the windowed B2, a codectx decode step's (B5 also
    # a chunk step's under by_step), launches those of its served run
    b5_dec = mellum["b5"][0]
    rows.append({"name": "B5 sfc_matmul_grouped", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/"
                           "sfc_matmul_grouped.cu",
                 "replaces": "src/repro/models/moe.py::_expert_ffn",
                 "launches": mellum_launches["B5"],
                 "max_abs_err": max(r["max_abs_err"] for r in mellum["b5"]),
                 "ms": b5_dec["ms"], "plain_ms": b5_dec["plain_ms"],
                 "bound_ms": b5_dec["bound_ms"], "bound_by": "bytes",
                 "library_ms": None, "by_step": mellum["b5"]})
    b2_win = mellum["b2"][0]
    rows.append({"name": "B2 paged_decode_attention (window)",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                 "replaces": "src/repro/kernels/paged_attention.py:103",
                 "launches": mellum_launches["B2 window"],
                 "max_abs_err": b2_win["max_abs_err"], "ms": b2_win["ms"],
                 "plain_ms": None, "bound_ms": b2_win["bound_ms"],
                 "bound_by": "bytes", "library_ms": None})
    print("kernels: [B1 sfc_matmul, B2 paged_decode_attention, B3 "
          "sfc_matmul_batched, B4 sfc_matmul_cached, B5 "
          "sfc_matmul_grouped, B2 with a window], all cuda")
    print(f"[summary] step logits max err {step['max_abs_err']:.4e}, "
          f"greedy agree {step['agree']}/{SLOTS}; serve "
          f"{sv['tok_per_s']:.2f} tok/s; chunk K/V max err "
          f"{chunk['max_abs_err']:.4e}; continuous {cv['tok_per_s']:.2f} "
          f"tok/s, agreeing with lockstep {sum(agree)}/{N_REQUESTS * MAX_NEW}"
          f" tokens; prefix sharing: {shared['stats']['prefix_hits']} hits, "
          f"{shared['stats']['cow_forks']} forks")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"b2_long_context": long_rows}))
    modes = []
    for run in (sv, cv):
        modes.append({k: run[k] for k in (
            "mode", "tok_per_s", "tokens", "wall_s", "steps", "chunk_steps",
            "ms_per_decode_step", "ms_per_chunk_step", "energy")})
    modes[1]["agree_with_lockstep"] = agree
    modes[1]["chunk_profile"] = chunk_prof
    print(json.dumps({"nvml": nvml, "card": smi}))
    print(json.dumps({"serve_modes": modes, "card": smi}))
    print(json.dumps(b1_prefill))
    print(json.dumps(energy))
    print(json.dumps(tuner))
    print(json.dumps({"serve_obs": obs}))
    print(json.dumps({"serve_faults": faults}))
    print(json.dumps({"serve_layouts": serve_layouts, "card": smi}))
    print(json.dumps({"layout_step": layout_steps, "card": smi}))
    print(json.dumps({"swa_ring": ring}))
    print(json.dumps({"train": train}))
    print(json.dumps({"families": families}))
    print(json.dumps({"mellum2": mellum}))
    print(json.dumps({"frontends": frontends}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"dryrun": dryrun}))
    print(json.dumps({"examples": examples, "card": smi}))
    print(json.dumps({"launches_by_path": by_path}))
    print(json.dumps({"phase_seconds": phase_s, "card": smi}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys + (
        "by_arch", "by_step") if k in r} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """Dotted paths of a parameter tree's leaves in ``tree_leaves``'s
    (sorted-key) order."""
    return [n for k in sorted(tree) for n in (
        _leaf_names(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
        else [prefix + k])]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
