// SFC-ordered GEMM through a software block cache that counts its own
// device-memory block fetches, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sfc_matmul_cached.py::sfc_matmul_cached (the
// TPU Pallas kernel _kernel: VMEM slots, SMEM tags, explicit HBM->VMEM
// copies and a DMA counter).
//
//   C = A @ B, A (M, K), B (K, N), shapes divisible by the blocks; one cast
//   to the output dtype.  The output tiles are visited in the order of the
//   host-built (T, 2) int32 schedule table, k innermost.  Each operand has
//   an nslots-way direct-mapped block cache: block A(i, k) has id
//   i*kt + k, block B(k, j) has id j*kt + k, and lives in slot id % nslots
//   with the id as its tag (the reference's mapping).  A tag miss copies
//   the block from device memory into its slot and counts one fetch; the
//   kernel writes [A fetches, B fetches] as int32.
//
// Why one block: the Pallas grid runs its steps in order on one core, so
// the cache state carries from tile to tile, and the counts are those of
// one sequential walk.  Blocks of a CUDA grid run in parallel and in no
// order, so the faithful port is ONE persistent thread block that walks
// the whole schedule itself.  It uses 1 of the H100's 132 SMs by design:
// its counts mean what the reference's mean, and a multi-block variant
// would count something else.
//
// What bounds it on the H100: for square f32 n = 1024 GEMMs, 2 n^3 FLOP
// over the 67 TFLOP/s f32 peak is 0.032 ms for the card and 4.2 ms for one
// SM (67/132 TFLOP/s); the bytes (3 n^2 f32) bound is 0.004 ms.  A walk
// that copies a block only when it is needed is latency-bound long before
// that: each miss is a round trip to device memory (or L2), and each step
// of the walk is a chain of shared-memory operations.
//
// What the design does about it: the walk is split between a producer
// warp and consumer warps, so that the copies of later steps are in
// flight while earlier steps compute, and the producer decides 32 steps
// at a time.
//
// * The producer warp (the block's last warp) owns the cache model: the
//   tags and last uses live in shared memory and only it reads or writes
//   them.  Its lane l decides step s0 + l of each round of 32 steps in
//   schedule order, exactly as the sequential walk does: the state of a
//   slot before step s is that of the round's last earlier step on the
//   same slot (__match_any_sync, __shfl_sync), or else the one in shared
//   memory; the round's last step on each slot writes the slot's state
//   back.  The misses are counted from the round's ballots, so the counts
//   are the kernel's own and equal the sequential walk's.
// * A missing block is one TMA copy (cp.async.bulk.tensor.2d, a bm x bk or
//   bk x bn box of the operand's tensor map) issued by the step's lane; it
//   completes on the step's "ready" mbarrier by complete_tx.  Blocks that
//   TMA cannot take (rows that are not 16-byte multiples, slots that are
//   not 128-byte multiples, boxes over 256) are copied by the warp with
//   plain loads and stores before the step is announced.
// * Step s uses ring entry s % kRing: the step's lane writes (i, j, k,
//   a_slot, b_slot) into it and arrives on its "ready" mbarrier, expecting
//   the bytes of the step's copies.  Consumers wait on "ready" with parity
//   (s / kRing) & 1, read the entry (never the tags or the schedule), and
//   each consumer warp arrives once on the entry's "done" mbarrier after
//   its last shared-memory read of the step.  Consumers finish the steps
//   in order, so "done" of step u means every step <= u is done; the
//   producer keeps that mark as ``covered``.
// * The slot-lifetime rule (write after read): no copy into slot x starts
//   until the consumers are done with the last step that read slot x's
//   old block.  Step s may start once the step it needs is covered: the
//   last use (hit or miss) of each slot it fills, and s - kRing, whose
//   ring entry it takes over.  The producer starts the round's steps in
//   order up to the first one that may not start yet, then waits for
//   "done" of min(that step's need + kSlack, the step before it), and
//   goes on.  A and B have separate slots, so a fill for step s never
//   waits on step s itself.  The rule keeps the slots at every step what
//   the sequential walk has there; with few slots it also caps the
//   lookahead.
// * No block-wide barrier runs inside the walk: the roles diverge, and the
//   consumers never need to meet (each owns its outputs).
//
// Consumers keep the sequential kernel's arithmetic: each output element
// is an f32 FMA chain in k order from 0 over the bk-deep blocks, kept in
// registers and cast once when the tile's last k block is done, so C
// repeats bit for bit.  Two consumer paths:
// * the study's blocks (bk = 8 or 16, TMA): each thread owns kFastNC
//   adjacent outputs of one row.  A step's operands go from the slots into
//   registers (the A row and pieces of the B rows as vector loads), and the
//   warp arrives on "done" before its FMAs, so the producer may refill
//   those slots meanwhile.  While step s's FMAs run, step s + 1 is tested
//   for readiness without blocking; its entry and operands are then loaded
//   into a second set of registers;
// * any other shape: element e = tid + q * consumers (q < kMaxAcc), read
//   from the slots inside the FMA loop, "done" after the step's FMAs.
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::kBF16;
using repro_torch::kF32;
using repro_torch::mbar_arrive;
using repro_torch::mbar_arrive_expect;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_u32;
using repro_torch::store_from_f32;
using repro_torch::to_f32;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxConsumers = 256;
constexpr int kMaxAcc = 64;       // accumulators per thread: bm*bn <= 16384
constexpr int kSmemMax = 232448;  // bytes of shared memory one block may use
constexpr int kRing = 128;        // ring entries: steps the producer may lead
constexpr int kRingLog2 = 7;
static_assert(1 << kRingLog2 == kRing, "kRing is a power of two");
constexpr int kSlack = 3;         // steps past the needed one a wait covers
constexpr int kFastNC = 2;        // outputs per thread, the study's blocks
constexpr int kMaxSlots = 1 << 15;  // b_slot << 16 stays positive

// one ring entry: what the consumers need of step s
struct Step {
  int i, j, k, slots;  // slots = a_slot | b_slot << 16
};
// shared-memory layout after the slots (16-byte aligned): kRing entries,
// kRing "ready" and kRing "done" mbarriers, then the A and B slot states
// (nslots int2 each: the tag and the last step that used the slot);
// kernels/sfc_matmul_cached.py::shared_bytes mirrors it
constexpr size_t kRingBytes = kRing * (sizeof(Step) + 2 * sizeof(uint64_t));

// the phase of ring barrier ``bars`` that belongs to step u
__device__ __forceinline__ void wait_step(uint64_t* bars, int u) {
  mbar_wait(&bars[u & (kRing - 1)], (u >> kRingLog2) & 1);
}

// has the phase of parity ``parity`` of ``bar`` completed?  (acquire, no
// blocking)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// the box at column c0, row c1 of ``map``'s tensor into shared memory at
// ``dst`` (128-byte aligned); completes on ``bar`` by complete_tx
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Copy the blocks of the steps in lane mask ``m`` with plain loads and
// stores, every lane taking part in each: a block is rows x cols elements
// at ``base`` + off (row stride ld) into ``slots`` + slot * rows * cols,
// with off and slot those of the step's lane.
template <typename T>
__device__ __forceinline__ void copy_blocks(unsigned m, int rows, int cols,
                                            long ld, T* slots,
                                            const T* base, long off,
                                            int slot) {
  const int lane = threadIdx.x & 31;
  for (; m; m &= m - 1) {
    const int g = __ffs(m) - 1;
    const T* src = base + __shfl_sync(kAll, off, g);
    T* dst = slots +
             static_cast<size_t>(__shfl_sync(kAll, slot, g)) * rows * cols;
    for (int c = lane; c < rows * cols; c += 32) {
      const int r = c / cols;
      dst[c] = src[r * ld + c - r * cols];
    }
  }
}

template <typename T, bool kTma>
__device__ __forceinline__ void produce(
    const T* __restrict__ a, const T* __restrict__ b,
    const CUtensorMap* map_a, const CUtensorMap* map_b,
    const int* __restrict__ sched, int* __restrict__ counts, T* a_slots,
    T* b_slots, Step* ring, uint64_t* ready, uint64_t* done, int2* a_state,
    int2* b_state, int N, int K, int bm, int bn, int bk, int nslots,
    int tiles) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  const int kt = K / bk;
  const int steps = tiles * kt;
  const uint32_t a_bytes = bm * bk * sizeof(T);
  const uint32_t b_bytes = bk * bn * sizeof(T);
  int a_fetches = 0, b_fetches = 0;
  int covered = -1;  // every step <= covered is done

  // lane l decides step s0 + l of each round of 32 steps; its (t, k)
  int t = lane / kt;
  int k = lane - t * kt;
  int2 ij = t < tiles ? reinterpret_cast<const int2*>(sched)[t]
                      : make_int2(0, 0);
  for (int s0 = 0; s0 < steps; s0 += 32) {
    const int s = s0 + lane;
    const int n = min(32, steps - s0);
    const bool live = lane < n;
    const int i = ij.x;
    const int j = ij.y;
    const int kk = k;
    // the next round's step: prefetch its schedule entry
    k += 32;
    t += k / kt;
    k %= kt;
    if (t < tiles) ij = reinterpret_cast<const int2*>(sched)[t];

    // the sequential walk's decision for step s
    const int a_id = i * kt + kk;
    const int b_id = j * kt + kk;
    const int a_slot = a_id % nslots;
    const int b_slot = b_id % nslots;
    const unsigned a_same = __match_any_sync(kAll, live ? a_slot : -1 - lane);
    const unsigned b_same = __match_any_sync(kAll, live ? b_slot : -1 - lane);
    const int a_prev = (a_same & below) ? 31 - __clz(a_same & below) : -1;
    const int b_prev = (b_same & below) ? 31 - __clz(b_same & below) : -1;
    const int a_prev_id = __shfl_sync(kAll, a_id, a_prev < 0 ? lane : a_prev);
    const int b_prev_id = __shfl_sync(kAll, b_id, b_prev < 0 ? lane : b_prev);
    int2 a_old = make_int2(a_prev_id, s0 + a_prev);  // {tag, last use}
    int2 b_old = make_int2(b_prev_id, s0 + b_prev);
    if (live && a_prev < 0) a_old = a_state[a_slot];
    if (live && b_prev < 0) b_old = b_state[b_slot];
    const bool miss_a = live && a_old.x != a_id;
    const bool miss_b = live && b_old.x != b_id;
    // the step that must be done before step s starts
    const int need = live ? max(max(miss_a ? a_old.y : -1,
                                    miss_b ? b_old.y : -1),
                                s - kRing)
                          : -1;
    const unsigned a_miss = __ballot_sync(kAll, miss_a);
    const unsigned b_miss = __ballot_sync(kAll, miss_b);
    a_fetches += __popc(a_miss);
    b_fetches += __popc(b_miss);
    // the round's last step on each slot leaves the slot's state
    if (live && (a_same & ~((2u << lane) - 1u)) == 0)
      a_state[a_slot] = make_int2(a_id, s);
    if (live && (b_same & ~((2u << lane) - 1u)) == 0)
      b_state[b_slot] = make_int2(b_id, s);
    __syncwarp();  // the next round reads these states

    // start the round's steps in order, waiting where one may not start yet
    for (int g0 = 0; g0 < n;) {
      const unsigned blocked =
          __ballot_sync(kAll, lane >= g0 && live && need > covered);
      const int g1 = blocked ? __ffs(blocked) - 1 : n;
      const bool mine = lane >= g0 && lane < g1;
      const int e = s & (kRing - 1);
      T* a_dst = a_slots + static_cast<size_t>(a_slot) * bm * bk;
      T* b_dst = b_slots + static_cast<size_t>(b_slot) * bk * bn;
      if (mine) ring[e] = Step{i, j, kk, a_slot | b_slot << 16};
      if constexpr (kTma) {
        if (mine) {
          mbar_arrive_expect(&ready[e],
                             (miss_a ? a_bytes : 0u) + (miss_b ? b_bytes : 0u));
          if (miss_a) tma_load(a_dst, map_a, kk * bk, i * bm, &ready[e]);
          if (miss_b) tma_load(b_dst, map_b, j * bn, kk * bk, &ready[e]);
        }
      } else {
        const unsigned seg = __ballot_sync(kAll, mine);
        copy_blocks(a_miss & seg, bm, bk, K, a_slots, a,
                    static_cast<long>(i) * bm * K + static_cast<long>(kk) * bk,
                    a_slot);
        copy_blocks(b_miss & seg, bk, bn, N, b_slots, b,
                    static_cast<long>(kk) * bk * N + static_cast<long>(j) * bn,
                    b_slot);
        __syncwarp();  // every lane's stores happen before the arrivals
        if (mine) mbar_arrive(&ready[e]);
      }
      if (g1 < n) {
        // every step before g1 has started; wait for the one g1 needs (a
        // few further on, so that the next steps find it covered too)
        covered = min(__shfl_sync(kAll, need, g1) + kSlack, s0 + g1 - 1);
        wait_step(done, covered);
      }
      g0 = g1;
    }
  }
  if (lane == 0) {
    counts[0] = a_fetches;
    counts[1] = b_fetches;
  }
}

// N consecutive elements from shared memory aligned to their size, as f32
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int x = 0; x < N; x += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + x);
      v[x] = f.x;
      v[x + 1] = f.y;
      v[x + 2] = f.z;
      v[x + 3] = f.w;
    }
  } else {
    static_assert(N == 2, "2 or a multiple of 4");
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  static_assert(N % 2 == 0, "pairs of bf16");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int x = 0; x < N; x += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + x);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = __bfloat1622float2(h[m]);
        v[x + 2 * m] = f.x;
        v[x + 2 * m + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int x = 0; x < N; x += 2) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + x));
      v[x] = f.x;
      v[x + 1] = f.y;
    }
  }
}

// One step's operands as a fast consumer thread holds them: the entry,
// its A row and kFastNC-wide pieces of the B rows, as f32.
template <int BK>
struct Operands {
  Step st;
  float a[BK];
  float b[BK][kFastNC];
};

// The study's blocks: thread tid owns outputs (r, c0 .. c0 + kFastNC - 1)
// of the tile; consumers * kFastNC == bm * bn.  Step s + 1 is tested for
// readiness (without blocking) before step s's FMAs and loaded after
// them, into a second set of registers (the loop unrolled by two, so that
// the sets trade places without copies).
template <typename T, int BK>
__device__ __forceinline__ void consume_fast(const T* a_slots,
                                             const T* b_slots,
                                             const Step* ring,
                                             uint64_t* ready, uint64_t* done,
                                             void* out, int out_dt, int N,
                                             int K, int bm, int bn,
                                             int tiles) {
  constexpr int NC = kFastNC;
  const int tid = threadIdx.x;
  const int kt = K / BK;
  const int per_row = bn / NC;
  const int r = tid / per_row;
  const int c0 = (tid - r * per_row) * NC;
  const int steps = tiles * kt;
  float acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.0f;

  // step s's entry and operands (step s is ready)
  auto load = [&](Operands<BK>& o, int s) {
    o.st = ring[s & (kRing - 1)];
    const T* As = a_slots + static_cast<size_t>(o.st.slots & 0xffff) * bm * BK;
    const T* Bs = b_slots + static_cast<size_t>(o.st.slots >> 16) * BK * bn;
    load_vec<BK>(As + r * BK, o.a);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) load_vec<NC>(Bs + kk * bn + c0, o.b[kk]);
  };
  // step s, whose operands are in ``cur``
  auto step = [&](Operands<BK>& cur, Operands<BK>& next, int s) {
    __syncwarp();  // the warp's reads of the step's slots are done
    if ((tid & 31) == 0) mbar_arrive(&done[s & (kRing - 1)]);
    // only after the arrival: the producer may be waiting for step s
    // before it starts step s + 1
    const bool more = s + 1 < steps;
    const bool known = more && mbar_test(&ready[(s + 1) & (kRing - 1)],
                                         ((s + 1) >> kRingLog2) & 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int n = 0; n < NC; ++n)
        acc[n] = fmaf(cur.a[kk], cur.b[kk][n], acc[n]);
    }
    if (more) {
      if (!known) wait_step(ready, s + 1);
      load(next, s + 1);
    }
    if (cur.st.k == kt - 1) {
      const long o =
          static_cast<long>(cur.st.i * bm + r) * N + cur.st.j * bn + c0;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        store_from_f32(out, o + n, out_dt, acc[n]);
        acc[n] = 0.0f;
      }
    }
  };
  Operands<BK> x, y;
  wait_step(ready, 0);
  load(x, 0);
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(x, y, s);
    step(y, x, s + 1);
  }
  if (s < steps) step(x, y, s);
}

// Any shape: element e = tid + q * consumers, read from the slots in the
// FMA loop.
template <typename T>
__device__ __forceinline__ void consume(const T* a_slots, const T* b_slots,
                                        const Step* ring, uint64_t* ready,
                                        uint64_t* done, void* out, int out_dt,
                                        int N, int K, int bm, int bn, int bk,
                                        int tiles, int consumers) {
  const int tid = threadIdx.x;
  const int kt = K / bk;
  const int tile = bm * bn;
  const int nq = (tile + consumers - 1) / consumers;
  const int steps = tiles * kt;
  float acc[kMaxAcc];
#pragma unroll
  for (int q = 0; q < kMaxAcc; ++q) acc[q] = 0.0f;
  for (int s = 0; s < steps; ++s) {
    wait_step(ready, s);
    const Step st = ring[s & (kRing - 1)];
    const T* As = a_slots + static_cast<size_t>(st.slots & 0xffff) * bm * bk;
    const T* Bs = b_slots + static_cast<size_t>(st.slots >> 16) * bk * bn;
#pragma unroll
    for (int q = 0; q < kMaxAcc; ++q) {
      if (q >= nq) break;
      const int el = tid + q * consumers;
      if (el < tile) {
        const int r = el / bn;
        const int c = el % bn;
        float v = acc[q];
        for (int kk = 0; kk < bk; ++kk) {
          v = fmaf(to_f32(As[r * bk + kk]), to_f32(Bs[kk * bn + c]), v);
        }
        acc[q] = v;
      }
    }
    __syncwarp();  // the warp's last reads of the step's slots are done
    if ((tid & 31) == 0) mbar_arrive(&done[s & (kRing - 1)]);
    if (st.k == kt - 1) {
#pragma unroll
      for (int q = 0; q < kMaxAcc; ++q) {
        if (q >= nq) break;
        const int el = tid + q * consumers;
        if (el < tile) {
          const long o = static_cast<long>(st.i * bm + el / bn) * N +
                         st.j * bn + el % bn;
          store_from_f32(out, o, out_dt, acc[q]);
        }
        acc[q] = 0.0f;
      }
    }
  }
}

// kTma: blocks copied by TMA, else by plain loads and stores; kBK > 0:
// consume_fast with bk == kBK, else consume
template <typename T, bool kTma, int kBK>
__global__ void __launch_bounds__(kMaxConsumers + 32, 1)
sfc_matmul_cached_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const int* __restrict__ sched, void* out, int out_dt,
                         int* __restrict__ counts, int N, int K, int bm,
                         int bn, int bk, int nslots, int tiles,
                         size_t ring_offset) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* a_slots = reinterpret_cast<T*>(smem);                // nslots x bm x bk
  T* b_slots = a_slots + static_cast<size_t>(nslots) * bm * bk;  // x bk x bn
  Step* ring = reinterpret_cast<Step*>(smem + ring_offset);
  uint64_t* ready = reinterpret_cast<uint64_t*>(ring + kRing);
  uint64_t* done = ready + kRing;
  int2* a_state = reinterpret_cast<int2*>(done + kRing);
  int2* b_state = a_state + nslots;

  // TMA writes 128-byte aligned boxes
  if (kTma && (smem_u32(smem) & 127u) != 0) __trap();
  const int consumers = blockDim.x - 32;
  for (int x = threadIdx.x; x < 2 * nslots; x += blockDim.x)
    a_state[x] = make_int2(-1, -1);  // empty, never used
  if (threadIdx.x == 0) {
    for (int x = 0; x < kRing; ++x) {
      mbar_init(&ready[x], 1);               // the step's producer lane
      mbar_init(&done[x], consumers / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier: the roles split here

  if (threadIdx.x >= consumers) {
    produce<T, kTma>(a, b, &map_a, &map_b, sched, counts, a_slots, b_slots,
                     ring, ready, done, a_state, b_state, N, K, bm, bn, bk,
                     nslots, tiles);
  } else if constexpr (kBK > 0) {
    consume_fast<T, kBK>(a_slots, b_slots, ring, ready, done, out, out_dt, N,
                         K, bm, bn, tiles);
  } else {
    consume<T>(a_slots, b_slots, ring, ready, done, out, out_dt, N, K, bm, bn,
               bk, tiles, consumers);
  }
}

// the map of a row-major rows x cols tensor of T, read in box_rows x
// box_cols boxes
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows, int box_cols) {
  const auto encode = repro_torch::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const int* sched, void* out,
                   int out_dt, int* counts, int M, int N, int K, int bm,
                   int bn, int bk, int nslots, int vec, cudaStream_t stream) {
  const size_t a_slot_bytes = static_cast<size_t>(bm) * bk * sizeof(T);
  const size_t b_slot_bytes = static_cast<size_t>(bk) * bn * sizeof(T);
  const size_t slot_bytes = nslots * (a_slot_bytes + b_slot_bytes);
  const size_t ring_offset = (slot_bytes + 15) / 16 * 16;
  const size_t smem = ring_offset + kRingBytes + 2 * sizeof(int2) * nslots;
  const long tiles = static_cast<long>(M / bm) * (N / bn);
  if (smem > static_cast<size_t>(kSmemMax) || nslots >= kMaxSlots ||
      tiles * (K / bk) >= (1 << 30)) {
    return cudaErrorInvalidValue;
  }
  // TMA takes 16-byte rows into 128-byte aligned slots, boxes of <= 256
  const bool tma = vec && a_slot_bytes % 128 == 0 && b_slot_bytes % 128 == 0 &&
                   bm <= 256 && bn <= 256 && bk <= 256;
  CUtensorMap map_a{}, map_b{};
  if (tma && !(tensor_map<T>(&map_a, a, M, K, bm, bk) &&
               tensor_map<T>(&map_b, b, K, N, bk, bn))) {
    return cudaErrorInvalidValue;
  }
  const int tile = bm * bn;
  // the study's consumers: bk of 8 or 16 in 16-byte rows, kFastNC outputs
  // of one row per thread, whole warps
  const bool fast = tma && (bk == 8 || bk == 16) && bn % kFastNC == 0 &&
                    tile % (32 * kFastNC) == 0 &&
                    tile / kFastNC <= kMaxConsumers;
  int consumers = fast ? tile / kFastNC : (tile + 31) / 32 * 32;
  if (consumers > kMaxConsumers) consumers = kMaxConsumers;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  auto kernel = fast      ? (bk == 8 ? sfc_matmul_cached_kernel<T, true, 8>
                                     : sfc_matmul_cached_kernel<T, true, 16>)
                : tma     ? sfc_matmul_cached_kernel<T, true, 0>
                          : sfc_matmul_cached_kernel<T, false, 0>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, consumers + 32, smem, stream>>>(
      pa, pb, map_a, map_b, sched, out, out_dt, counts, N, K, bm, bn, bk,
      nslots, static_cast<int>(tiles), ring_offset);
  return cudaGetLastError();
}

}  // namespace

// C entry bound by ctypes (kernels/sfc_matmul_cached.py).  Returns a
// cudaError_t.  a (M, K), b (K, N) and out (M, N) are contiguous; M, N, K
// divide by bm, bn, bk; bm*bn <= 16384; sched is the (M/bm * N/bn, 2)
// int32 tile order; counts receives [A fetches, B fetches].  vec says that
// bk, bn, K and N are multiples of 16 bytes' worth of elements and a, b
// are 16-byte aligned; such blocks go by TMA when their slots are
// 128-byte multiples and no block edge exceeds 256.
extern "C" int sfc_matmul_cached_launch(const void* a, const void* b,
                                        const void* sched, void* out,
                                        void* counts, int M, int N, int K,
                                        int bm, int bn, int bk, int nslots,
                                        int in_dt, int out_dt, int vec,
                                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      nslots <= 0 || M % bm != 0 || N % bn != 0 || K % bk != 0 ||
      bm * bn > kMaxConsumers * kMaxAcc || sched == nullptr ||
      counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counts);
  const int* tab = static_cast<const int*>(sched);
  cudaError_t err;
  if (in_dt == kF32) {
    err = launch<float>(a, b, tab, out, out_dt, cnt, M, N, K, bm, bn, bk,
                        nslots, vec, st);
  } else if (in_dt == kBF16) {
    err = launch<__nv_bfloat16>(a, b, tab, out, out_dt, cnt, M, N, K, bm, bn,
                                bk, nslots, vec, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
