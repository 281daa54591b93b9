// SFC-ordered GEMM with a fused epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sfc_matmul.py::sfc_matmul_pallas (the TPU
// Pallas kernel _mm_kernel / _mm_kernel_prefetch, its flush _fused_flush
// and its closed-form tile decode decode_step), and, batched, B3
// src/repro/kernels/sfc_matmul.py::sfc_matmul_batched_pallas (_bmm_kernel
// over a (batch, T, kt) grid, batch outermost).
//
//   C = act(A @ B + bias) + residual, one cast and one store per element.
//   The output tile grid (mt x nt, with bm x bn tiles) is visited in the
//   order of a space-filling curve: unit of work t maps to tile (i, j)
//   through the (T, 2) int32 schedule table the host builds with
//   core/schedule.py::grid_schedule (mode 0, the table variant), or
//   through a closed-form decode of t inside the kernel (modes 1-4:
//   rowmajor, colmajor, morton, hilbert; morton and hilbert need a
//   square power-of-two grid, as decode_step asserts).  The closed form
//   is the paper's trade of index computation for locality.  The
//   epilogue (bias -> act -> residual) runs on the f32 accumulator, then
//   one cast and one store; ragged M/N/K edges are masked here, so the
//   wrapper never pads.  The launcher picks a path from the dtype and the
//   shapes (kernels/sfc_matmul.py::tile_path mirrors it).
//
// Rows path (M <= 8, bn = 128, N % 8 == 0, 16-byte aligned rows): every
// serving-path GEMM (M = 4 decode slots).  The work is ~4 FLOP per weight
// byte, so the bound is reading B from HBM: one qwen3-1.7b decode step
// reads ~3.44 GB of bf16 weights here, ~1.03 ms at 3.35 TB/s.  What the
// design does about it:
//
//  * Fill the card.  An output tile of 128 columns is a thread-block
//    cluster of `split` blocks (1, 2, 4 or 8, chosen on the host from the
//    element's shape: kernels/sfc_matmul.py::split_plan; refused here if
//    it is not one of those or leaves a rank empty), so a 2048-wide
//    output runs 128 blocks instead of 16.  Rank r sums the contiguous K
//    range [r * klen, min(K, (r + 1) * klen)), klen = ceil(K / split)
//    rounded up to 16 bytes of elements.
//  * Keep bytes in flight.  B streams through a 6-stage shared-memory
//    ring filled by 16-byte cp.async, five stages in flight while one is
//    multiplied; A's rows for the rank's range are staged once per chunk
//    with cp.async, and the epilogue's bias and residual are fetched
//    before the loop.  Six stages (64 KB a bf16 block) let three
//    blocks share an SM, which the 1187-block vocab head needs: on the
//    H100 it ran faster than with four or eight.
//  * bf16 (the serving path): tensor cores, so the multiply does not
//    hold back the stream.  Each warp owns 16 of the 128 columns for the
//    rank's whole range and runs mma.sync.m16n8k16 (bf16 in, f32
//    accumulate) on C^T = B^T A^T, B^T by ldmatrix.trans from the ring;
//    the block fills each 8 KB stage in whole 256-byte rows of B.
//  * f32: SIMT FFMA, 16 column groups of 8 x 16 k-slices, each thread
//    reading back only the ring slots it filled; the k-slice partials are
//    added by warp shuffle, then warp by warp in warp order.
//  * The cluster reduction: each rank leaves its [M][128] f32 partial in
//    its own shared memory; after cluster.sync() rank 0 reads ranks 1, 2,
//    ..., split - 1 through cluster.map_shared_rank and adds them to its
//    own in that rank order, applies the epilogue and stores; a second
//    cluster.sync() keeps the partials alive until it has read them.
//    Every sum has a fixed order, so results are identical run to run;
//    no atomics.
//
// Tile path, bf16 on tensor cores (every other bf16 launch whose operands
// are 16-byte vectors: a prefill chunk's projections, training's forward,
// dgrad and wgrad, an encoder's).  An M x N x K GEMM does 2 M N K
// operations on ~2 (M K + K N) bytes, so past M ~ 300 (the H100's ridge,
// 989 TFLOP/s bf16 over 3.35 TB/s) it is bound by operations, which only
// the tensor cores deliver.  What the design does about it:
//
//  * One persistent block per SM walks units u = blockIdx.x, + gridDim.x,
//    ... of the batch x T tile steps, batch outermost, the tile of step t
//    from decode_tile: the tiles in flight are gridDim.x consecutive steps
//    of the curve, neighbours on the card's L2 as the paper's order wants.
//  * A producer warp keeps a ring of six 64-deep k stages filled by TMA
//    (cp.async.bulk.tensor, A K-major and B N-major, 128-byte swizzle,
//    zero-filled past the matrix, so nothing is padded), full and empty
//    mbarriers handing stages between it and the consumers; its next
//    tile's loads run under the current tile's epilogue.
//  * One or two consumer warpgroups (64 block rows each) run
//    wgmma.mma_async m64 x 64|128 x k16 (bf16 in, f32 accumulate) straight
//    from the swizzled stages, one stage's wgmmas in flight while the next
//    is awaited; bias and residual are fetched into registers while the
//    k-loop runs, and the epilogue stores two columns at a time.
//  * The block is bm x bn rounded up to 64 (at most 128 x 128, the grid
//    of tiles the caller's bm and bn make); only the tile's elements are
//    stored.  Each element's k-blocks are summed in order, so results
//    repeat bit for bit; no split K.
//
// Tile path, SIMT (f32 always: the study's GEMMs, bound by the f32 FFMA
// rate, 67 TFLOP/s; bf16 operands that are not 16-byte vectors, which TMA
// cannot describe, such as hymba's N = 3257): one 256-thread block per bm
// x bn tile (up to 128 x 128), each thread an 8 x 8 register micro-tile in
// the 2 x 2 quadrant placement (rows 4ty..4ty+3 and 64+4ty.., columns
// likewise by tx).  k advances in slices 16 deep in f32, 32 in bf16,
// through a ring of 4 shared-memory stages: B arrives by 16-byte cp.async
// (zero-filled past the ragged edge) or, without vectors, through
// registers, A through registers so it can be stored k-major (transposed,
// rows padded to 132), and the inner loop reads each thread's 8 A and 8 B
// values as four vector loads without bank conflicts.  Three slices are in
// flight while one is multiplied; 66,560 bytes of shared memory and <= 128
// registers a thread let two blocks share an SM.  Each element is still
// summed by sequential FMAs in k order into one f32 accumulator, bf16
// widened to f32 in registers.  `bk` sets no path's shared memory: it
// names only the plain version's k blocking, and the entry refuses the
// bm/bn/bk it refused before.
//
// Batched (B3): the same kernels, instantiated with kBatched, take the
// batch element from blockIdx.y and offset A (b, M, K), B (b, K, N), the
// residual and the output (b, M, N) by it in 64-bit arithmetic; bias
// (N,) is shared.  The grid is (T * split, batch), tile step in x, so
// blocks are dispatched batch outermost with the curve inside each
// element, as in the reference; the tensor-core tile kernel walks the
// same order as its units, and its tensor maps carry the batch as their
// third dimension.  The split is the one-GEMM one for the
// element's shape, and the per-element arithmetic is the one-GEMM
// kernel's, so each element equals B1 on it bit for bit.  The one-GEMM
// instantiations (kBatched false) compile without the offsets: moving
// them in unconditionally made the old rows path ~1.8x slower per launch
// on the H100.  Batches beyond gridDim.y's 65535 are launched in chunks.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using repro_torch::kBF16;
using repro_torch::kF32;
using repro_torch::load_as_f32;
using repro_torch::mbar_arrive;
using repro_torch::mbar_arrive_expect;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_u32;
using repro_torch::store_from_f32;

constexpr int kTileThreads = 256;  // tile path: a 16 x 16 thread grid
constexpr int kTileStages = 4;     // tile path: k slices in the ring
constexpr int kTileLd = 132;       // tile path: row stride of k-major A
constexpr int kRowsThreads = 256;  // rows path: 8 warps
constexpr int kRowsSlices = kRowsThreads / 16;  // f32 rows: k-slices of 16 column groups
constexpr int kRowsMaxM = 8;       // the rows path takes M <= 8
constexpr int kRowsStages = 6;     // rows path: stages of the ring of B
constexpr int kRowsABytes = 32768; // f32 rows: A staged per chunk
constexpr int kMaxSplit = 8;       // portable cluster size
constexpr int kSmemMax = 232448;   // bytes of shared memory one block may use
constexpr int kMaxGridY = 65535;   // batch elements per launch (gridDim.y)

enum Act : int { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };
enum Mode : int { kTable = 0, kRowMajor = 1, kColMajor = 2, kMorton = 3,
                  kHilbert = 4 };

struct Epilogue {
  const void* bias;
  const void* res;
  void* out;
  int out_dt, bias_dt, res_dt, act;
};

__device__ __forceinline__ unsigned contract32(unsigned x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return x;
}

// tile step t -> tile (i, j), the device twin of kernels/sfc_matmul.py::decode_step
__device__ __forceinline__ void decode_tile(int t, int mode, int mt, int nt,
                                            int order, const int* sched,
                                            int* i, int* j) {
  switch (mode) {
    case kTable:
      *i = sched[2 * t];
      *j = sched[2 * t + 1];
      return;
    case kRowMajor:
      *i = t / nt;
      *j = t % nt;
      return;
    case kColMajor:
      *i = t % mt;
      *j = t / mt;
      return;
    case kMorton:
      *i = static_cast<int>(contract32(static_cast<unsigned>(t) >> 1));
      *j = static_cast<int>(contract32(static_cast<unsigned>(t)));
      return;
    default: {  // kHilbert: the bit-pair scan of core/curves.py
      unsigned x = 0, y = 0, d = static_cast<unsigned>(t);
      for (int b = 0; b < order; ++b) {
        const unsigned s = 1u << b;
        const unsigned rx = 1u & (d / 2u);
        const unsigned ry = 1u & (d ^ rx);
        if (ry == 0u) {
          if (rx == 1u) {
            x = s - 1u - x;
            y = s - 1u - y;
          }
          const unsigned tmp = x;
          x = y;
          y = tmp;
        }
        x += s * rx;
        y += s * ry;
        d /= 4u;
      }
      *i = static_cast<int>(x);  // the scan's x is the major coordinate
      *j = static_cast<int>(y);
      return;
    }
  }
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.0f);
    case kGelu: {  // tanh approximation, as repro.kernels.ref
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
    }
    case kSilu:
      return x / (1.0f + expf(-x));
    default:
      return x;
  }
}

// +bias -> act -> +residual on the f32 accumulator, then one cast + store;
// ``base`` is the batch element's offset into the residual and output
__device__ __forceinline__ void finish(const Epilogue& ep, float v, long base,
                                       int gm, int gn, int N) {
  const long o = base + static_cast<long>(gm) * N + gn;
  if (ep.bias != nullptr) v += load_as_f32(ep.bias, gn, ep.bias_dt);
  v = activate(v, ep.act);
  if (ep.res != nullptr) v += load_as_f32(ep.res, o, ep.res_dt);
  store_from_f32(ep.out, o, ep.out_dt, v);
}

// 16-byte copy global -> shared that bypasses registers; zero-fills when
// ``pred`` is false (then nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 consecutive elements from 16-byte (f32) or 8-byte (bf16) aligned
// shared memory, widened to f32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// 16 bytes of elements from ``p``, of which the first ``valid`` exist
// (kVec: all or none, from a 16-byte-aligned address); the rest are zero
template <typename TI, bool kVec>
__device__ __forceinline__ uint4 load16(const TI* p, int valid) {
  constexpr int VEC = 16 / sizeof(TI);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kVec) {
    if (valid > 0) u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    TI* e = reinterpret_cast<TI*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < valid) e[i] = p[i];
  }
  return u;
}

// K range length of one cluster rank (the host's split_ranges)
__host__ __device__ __forceinline__ int split_len(int K, int split, int vec) {
  const int per = (K + split - 1) / split;
  return (per + vec - 1) / vec * vec;
}

// ---------------------------------------------------------------- rows path
// Both rows kernels stream B through a ring of kRowsStages stages in
// shared memory, filled by 16-byte cp.async (zero-filled past the ragged
// edge), with kRowsStages - 1 stages of copies in flight while one is
// multiplied.  A's rows for the rank's K range are staged once per chunk
// with cp.async and read from shared memory.

// The epilogue's bias and residual for the elements e = tid + i * threads
// of the [M][128] tile a thread finishes, fetched while B streams.
template <int kEpi>
__device__ __forceinline__ void rows_prefetch(const Epilogue& ep, bool live,
                                              int M, int N, int col0,
                                              long base, float (&bias)[kEpi],
                                              float (&res)[kEpi]) {
#pragma unroll
  for (int i = 0; i < kEpi; ++i) {
    const int e = threadIdx.x + i * kRowsThreads;
    const int gn = col0 + e % 128;
    const bool in = live && e < M * 128 && gn < N;
    bias[i] = in && ep.bias != nullptr ? load_as_f32(ep.bias, gn, ep.bias_dt) : 0.0f;
    res[i] = in && ep.res != nullptr
                 ? load_as_f32(ep.res, base + static_cast<long>(e / 128) * N + gn, ep.res_dt)
                 : 0.0f;
  }
}

// The block's [M][128] partial is in red[0, M * 128), element e of it in
// part[i] of thread e % threads.  With a cluster, rank 0 reads the
// partials of ranks 1, ..., split - 1 through distributed shared memory
// and adds them to its own in that rank order; then the epilogue and one
// store per element.
template <int kEpi>
__device__ __forceinline__ void rows_tail(float* red, float (&part)[kEpi],
                                          const float (&bias)[kEpi],
                                          const float (&res)[kEpi], int M,
                                          int N, int col0, long base, int rank,
                                          int split, const Epilogue& ep) {
  const int tid = threadIdx.x;
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's partial is in its red
    if (rank == 0) {
#pragma unroll
      for (int i = 0; i < kEpi; ++i) {
        const int e = tid + i * kRowsThreads;
        if (e < M * 128)
          for (int q = 1; q < split; ++q) part[i] += cluster.map_shared_rank(red, q)[e];
      }
    }
    cluster.sync();  // every rank's partial stays until rank 0 has read it
    if (rank != 0) return;
  }
#pragma unroll
  for (int i = 0; i < kEpi; ++i) {
    const int e = tid + i * kRowsThreads;
    const int gn = col0 + e % 128;
    if (e < M * 128 && gn < N) {
      const float v = activate(part[i] + bias[i], ep.act) + res[i];
      store_from_f32(ep.out, base + static_cast<long>(e / 128) * N + gn, ep.out_dt, v);
    }
  }
}

// f32 (SIMT): thread = (column group cg of 8 columns, k-slice ks); a
// stage is one k row of the thread's 8 columns, 32 bytes in two copies
// that only this thread reads back, so it waits for its own copies and
// needs no block barrier; the 16 k-slice partials are added by warp
// shuffle and then warp by warp in warp order.
template <int R>
struct RowsF32 {
  static constexpr int kDepth = kRowsSlices;              // k rows a stage
  static constexpr int kPass = kDepth * kRowsStages;      // k rows a ring
  static constexpr int kChunk = kRowsABytes / (R * 4);    // A's k per chunk
  static constexpr int kRing = kRowsStages * kRowsThreads * 32;
  static constexpr size_t kSmem = kRing + kRowsABytes;
  static_assert(4 * (kRowsThreads / 32) * R * 128 <= kRing,
                "the warps' partials reuse the ring");
};

// block = rank (blockIdx.x % split) of the cluster of tile step
// blockIdx.x / split; M <= R rows, bn = 128
template <int R, bool kBatched>
__global__ void __launch_bounds__(kRowsThreads, 2)
sfc_matmul_rows_f32(const float* __restrict__ a, const float* __restrict__ b,
                    const int* __restrict__ sched, int M, int N, int K, int mt,
                    int nt, int order, int mode, int split, Epilogue ep) {
  using C = RowsF32<R>;
  constexpr int S = kRowsStages;
  constexpr int kEpi = R * 128 / kRowsThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);  // [S][2][threads]
  float* red = reinterpret_cast<float*>(smem_raw);   // after the loop: [8 warps][R][128]
  float* as = reinterpret_cast<float*>(smem_raw + C::kRing);  // [R][kChunk]

  long base = 0;  // the batch element's offset into residual and output
  if constexpr (kBatched) {
    const long bz = blockIdx.y;
    a += bz * M * K;
    b += bz * K * N;
    base = bz * M * N;
  }
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % split;
  const int klen = split_len(K, split, 4);
  const int k0 = rank * klen;
  const int k1 = min(K, k0 + klen);
  auto stage_a = [&](int kc0) {  // needs no tile index
    const int vpr = (min(k1, kc0 + C::kChunk) - kc0) / 4;
    for (int e = tid; e < M * vpr; e += kRowsThreads) {
      const int r = e / vpr;
      const int c = (e % vpr) * 4;
      cp_async16(as + r * C::kChunk + c, a + static_cast<long>(r) * K + kc0 + c, true);
    }
    cp_async_commit();
  };
  stage_a(k0);

  int ti, tj;
  decode_tile(blockIdx.x / split, mode, mt, nt, order, sched, &ti, &tj);
  const int col0 = tj * 128;  // mt == 1: M <= 8 < bm
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cgi = lane % 16;
  const int ks = warp * 2 + lane / 16;
  const int c0 = col0 + cgi * 8;
  const bool col_ok = c0 < N;  // N % 8 == 0: a group is wholly in or out
  float pre_bias[kEpi], pre_res[kEpi];
  rows_prefetch(ep, split == 1 || rank == 0, M, N, col0, base, pre_bias, pre_res);

  auto fill = [&](int g) {  // stage g: k row k0 + g * kDepth + ks
    const int kk = k0 + g * C::kDepth + ks;
    const bool in = col_ok && kk < k1;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      cp_async16(ring + ((g % S) * 2 + q) * kRowsThreads + tid,
                 in ? b + static_cast<long>(kk) * N + c0 + 4 * q : b, in);
  };

  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  const int nst = (k1 - k0 + C::kDepth - 1) / C::kDepth;
  constexpr int kStagesPerChunk = C::kChunk / C::kDepth;
#pragma unroll
  for (int g = 0; g < S - 1; ++g) {
    if (g < nst) fill(g);
    cp_async_commit();
  }
  for (int g = 0; g < nst; ++g) {
    const int kc0 = k0 + (g / kStagesPerChunk) * C::kChunk;
    if (g > 0 && g % kStagesPerChunk == 0) {  // the next chunk of A
      __syncthreads();
      stage_a(kc0);
      cp_async_wait<0>();
      __syncthreads();
    }
    cp_async_wait<S - 2>();  // this thread's stage g has landed
    if (g == 0) __syncthreads();  // ... and A's first chunk, from every thread
    if (g + S - 1 < nst) fill(g + S - 1);  // into the slot stage g - 1 used
    cp_async_commit();
    const int kk = k0 + g * C::kDepth + ks;
    if (kk < k1) {
      const uint4* slot = ring + (g % S) * 2 * kRowsThreads + tid;
      const float4 lo = *reinterpret_cast<const float4*>(slot);
      const float4 hi = *reinterpret_cast<const float4*>(slot + kRowsThreads);
      const float bv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < M) {
          const float av = as[r * C::kChunk + kk - kc0];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av, bv[c], acc[r][c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring: red reuses it

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  if (lane < 16) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) red[(warp * R + r) * 128 + cgi * 8 + c] = acc[r][c];
  }
  __syncthreads();
  float part[kEpi];
#pragma unroll
  for (int i = 0; i < kEpi; ++i) {
    const int e = tid + i * kRowsThreads;
    part[i] = 0.0f;
    if (e < M * 128) {
#pragma unroll
      for (int w = 0; w < kRowsThreads / 32; ++w) part[i] += red[(w * R + e / 128) * 128 + e % 128];
      red[e] = part[i];  // plane 0: only this thread reads element e there
    }
  }
  rows_tail(red, part, pre_bias, pre_res, M, N, col0, base, rank, split, ep);
}

// bf16 (tensor cores): warp w owns columns 16w..16w+15 of the tile for
// the rank's whole K range, so no k partials meet inside a block.  Per 16
// k rows it runs one mma.sync.m16n8k16 (bf16 in, f32 accumulate) on
// C^T[16 columns][8 rows] += B^T[16 x 16] A^T[16 x 8]: B^T comes from the
// ring by ldmatrix.trans, A^T from staged A (rows >= M are zero).  The
// block fills a stage together, 32 k rows of the tile's 128 columns
// (8 KB), each warp copying whole 256-byte rows (full 128-byte lines of
// B); one barrier a stage hands the stage to the warps that read it.  The
// sixteen 16-byte chunks of a stage row are stored in the order chunk ^
// (row & 7), so ldmatrix reads 8 rows of one chunk without bank
// conflicts.
constexpr int kMmaDepth = 32;                        // k rows a stage
constexpr int kMmaStage = kMmaDepth * 256;           // bytes a stage
constexpr int kMmaChunk = 1024;                      // A's k per chunk
constexpr int kMmaLdA = kMmaChunk + 8;               // padded A row
constexpr int kMmaRing = kRowsStages * kMmaStage;
constexpr size_t kMmaSmem = kMmaRing + kRowsMaxM * kMmaLdA * 2;

// byte offset of (row, 16-byte chunk) in a stage
__device__ __forceinline__ int mma_slot(int row, int chunk) {
  return row * 256 + ((chunk ^ (row & 7)) << 4);
}

template <bool kBatched>
__global__ void __launch_bounds__(kRowsThreads, 2)
sfc_matmul_rows_bf16(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ b,
                     const int* __restrict__ sched, int M, int N, int K,
                     int mt, int nt, int order, int mode, int split,
                     Epilogue ep) {
  constexpr int S = kRowsStages;
  constexpr int kEpi = kRowsMaxM * 128 / kRowsThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // after the loop: [M][128]
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw + kMmaRing);  // [M][kMmaLdA]

  long base = 0;  // the batch element's offset into residual and output
  if constexpr (kBatched) {
    const long bz = blockIdx.y;
    a += bz * M * K;
    b += bz * K * N;
    base = bz * M * N;
  }
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rank = blockIdx.x % split;
  const int klen = split_len(K, split, 8);
  const int k0 = rank * klen;
  const int k1 = min(K, k0 + klen);
  auto stage_a = [&](int kc0) {  // needs no tile index
    const int vpr = (min(k1, kc0 + kMmaChunk) - kc0) / 8;
    for (int e = tid; e < M * vpr; e += kRowsThreads) {
      const int r = e / vpr;
      const int c = (e % vpr) * 8;
      cp_async16(as + r * kMmaLdA + c, a + static_cast<long>(r) * K + kc0 + c, true);
    }
    cp_async_commit();
  };
  stage_a(k0);

  int ti, tj;
  decode_tile(blockIdx.x / split, mode, mt, nt, order, sched, &ti, &tj);
  const int col0 = tj * 128;  // mt == 1: M <= 8 < bm
  float pre_bias[kEpi], pre_res[kEpi];
  rows_prefetch(ep, split == 1 || rank == 0, M, N, col0, base, pre_bias, pre_res);

  auto fill = [&](int g) {  // stage g: k rows k0 + kMmaDepth g ..
#pragma unroll
    for (int i = 0; i < kMmaDepth * 16 / kRowsThreads; ++i) {
      const int c = tid + kRowsThreads * i;
      const int row = c >> 4;
      const int chunk = c & 15;
      const int kk = k0 + g * kMmaDepth + row;
      const int gn = col0 + 8 * chunk;
      const bool in = kk < k1 && gn < N;  // N % 8 == 0: a chunk is in or out
      cp_async16(smem_raw + (g % S) * kMmaStage + mma_slot(row, chunk),
                 in ? b + static_cast<long>(kk) * N + gn : b, in);
    }
  };

  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int nst = (k1 - k0 + kMmaDepth - 1) / kMmaDepth;
  constexpr int kStagesPerChunk = kMmaChunk / kMmaDepth;
  const int m = lane >> 2;  // A^T column (a row of A) this lane feeds
#pragma unroll
  for (int g = 0; g < S - 1; ++g) {
    if (g < nst) fill(g);
    cp_async_commit();
  }
  for (int g = 0; g < nst; ++g) {
    const int kc0 = k0 + (g / kStagesPerChunk) * kMmaChunk;
    if (g > 0 && g % kStagesPerChunk == 0) {  // the next chunk of A
      __syncthreads();
      stage_a(kc0);
      cp_async_wait<0>();
      __syncthreads();
    }
    cp_async_wait<S - 2>();  // this thread's copies of stage g have landed
    __syncthreads();  // ... everyone's (A's first chunk too), and stage g - 1 is read
    if (g + S - 1 < nst) fill(g + S - 1);  // into the slot stage g - 1 used
    cp_async_commit();
    const unsigned st = smem_u32(smem_raw + (g % S) * kMmaStage);
#pragma unroll
    for (int h = 0; h < kMmaDepth / 16; ++h) {  // 16 k rows each
      const int j = lane >> 3;     // the 8 x 8 matrix whose row this lane names
      const int row = h * 16 + (j >> 1) * 8 + (lane & 7);
      unsigned a0, a1, a2, a3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
          : "r"(st + mma_slot(row, 2 * warp + (j & 1))));
      const int kk = k0 + g * kMmaDepth + h * 16 + (lane & 3) * 2;
      unsigned b0 = 0u, b1 = 0u;
      if (m < M) {
        const __nv_bfloat16* ar = as + m * kMmaLdA + (kk - kc0);
        if (kk < k1) b0 = *reinterpret_cast<const unsigned*>(ar);
        if (kk + 8 < k1) b1 = *reinterpret_cast<const unsigned*>(ar + 8);
      }
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: red reuses it

  // d[i] is C[row (lane & 3) * 2 + (i & 1)][column 16 w + lane / 4 + 8 (i / 2)]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (lane & 3) * 2 + (i & 1);
    if (r < M) red[r * 128 + 16 * warp + (lane >> 2) + 8 * (i >> 1)] = d[i];
  }
  __syncthreads();
  float part[kEpi];
#pragma unroll
  for (int i = 0; i < kEpi; ++i) {
    const int e = tid + i * kRowsThreads;
    part[i] = e < M * 128 ? red[e] : 0.0f;
  }
  rows_tail(red, part, pre_bias, pre_res, M, N, col0, base, rank, split, ep);
}

// ---------------------------------------------------------------- tile path
template <typename TI>
struct TileCfg {
  static constexpr int VEC = 16 / sizeof(TI);  // elements per 16 bytes
  static constexpr int BK = 4 * VEC;           // k slice: 16 f32, 32 bf16
  static constexpr int kA = BK * kTileLd;      // one A stage, k-major
  static constexpr int kB = BK * 128;          // one B stage, k rows
  static constexpr size_t kSmem = sizeof(TI) * kTileStages * (kA + kB);
};

// bm, bn multiples of 16 up to 128; thread (ty, tx) owns rows 4ty + i and
// 64 + 4ty + i and columns 4tx + j and 64 + 4tx + j (i, j < 4) of the
// tile; rows and columns past the tile or the matrix are zero-filled and
// not stored
template <typename TI, bool kVec, bool kBatched>
__global__ void __launch_bounds__(kTileThreads, 2)
sfc_matmul_tile(const TI* __restrict__ a, const TI* __restrict__ b,
                const int* __restrict__ sched, int M, int N, int K, int bm,
                int bn, int mt, int nt, int order, int mode, Epilogue ep) {
  using C = TileCfg<TI>;
  constexpr int VEC = C::VEC;
  constexpr int BK = C::BK;
  constexpr int S = kTileStages;
  constexpr int BV = 128 / VEC;  // 16-byte vectors per B row of a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TI* As = reinterpret_cast<TI*>(smem_raw);  // [S][BK][kTileLd]
  TI* Bs = As + S * C::kA;                    // [S][BK][128]

  long base = 0;  // the batch element's offset into residual and output
  if constexpr (kBatched) {
    const long bz = blockIdx.y;
    a += bz * M * K;
    b += bz * K * N;
    base = bz * M * N;
  }
  int ti, tj;
  decode_tile(blockIdx.x, mode, mt, nt, order, sched, &ti, &tj);
  const int row0 = ti * bm;
  const int col0 = tj * bn;
  const int rows = min(bm, M - row0);
  const int cols = min(bn, N - col0);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  // this thread's share of a slice: A rows ar, ar + 64 at k offset ak;
  // B k rows bq, bq + 256 / BV at column bc
  const int ar = tid / 4;
  const int ak = (tid % 4) * VEC;
  const int bq = tid / BV;
  const int bc = (tid % BV) * VEC;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  uint4 ra[2], rb[2];  // A (and, without kVec, B) in flight through registers
  auto load = [&](int kt, int stage) {
    const int k0 = kt * BK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ar + 64 * h;
      const int gk = k0 + ak;
      ra[h] = load16<TI, kVec>(a + static_cast<long>(row0 + r) * K + gk,
                               r < rows ? K - gk : 0);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = bq + h * (kTileThreads / BV);
      const int gk = k0 + q;
      const TI* src = b + static_cast<long>(gk) * N + col0 + bc;
      if constexpr (kVec) {
        const bool in = gk < K && bc < cols;
        cp_async16(Bs + stage * C::kB + q * 128 + bc, in ? src : b, in);
      } else {
        rb[h] = load16<TI, false>(src, gk < K ? cols - bc : 0);
      }
    }
  };
  auto store = [&](int stage) {
    TI* as = As + stage * C::kA;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const TI* v = reinterpret_cast<const TI*>(&ra[h]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) as[(ak + i) * kTileLd + ar + 64 * h] = v[i];
    }
    if constexpr (!kVec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = bq + h * (kTileThreads / BV);
        *reinterpret_cast<uint4*>(Bs + stage * C::kB + q * 128 + bc) = rb[h];
      }
    }
  };

  const int kt = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < kt) {
      load(s, s);
      store(s);
    }
    cp_async_commit();
  }
  for (int kk = 0; kk < kt; ++kk) {
    cp_async_wait<S - 2>();  // slice kk's B has landed
    __syncthreads();         // ... for every thread, and stage kk - 1 is free
    const int nxt = kk + S - 1;
    if (nxt < kt) load(nxt, nxt % S);
    cp_async_commit();
    const TI* as = As + (kk % S) * C::kA;
    const TI* bs = Bs + (kk % S) * C::kB;
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      float av[8], bv[8];
      load4(as + q * kTileLd + 4 * ty, av);
      load4(as + q * kTileLd + 64 + 4 * ty, av + 4);
      load4(bs + q * 128 + 4 * tx, bv);
      load4(bs + q * 128 + 64 + 4 * tx, bv + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (nxt < kt) store(nxt % S);  // stage kk - 1: read by no one now
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 4 * ty + (i & 3) + 64 * (i >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 4 * tx + (j & 3) + 64 * (j >> 2);
      if (r < rows && c < cols) finish(ep, acc[i][j], base, row0 + r, col0 + c, N);
    }
  }
}

// ------------------------------------------------ tile path, tensor cores
// bf16 operands that are 16-byte vectors, off the rows path (the file's
// header gives the design).  Every element is one f32 sum in a fixed order
// (k-blocks in order, four k16 steps each), so results repeat bit for bit,
// and a batch element (kBatched) equals the one-GEMM launch on it.
constexpr int kTcBK = 64;        // k per stage: one 128-byte swizzle row of bf16
constexpr int kTcStages = 6;     // stages of the ring
constexpr int kTcThreads = 3 * 128;  // up to two consumer warpgroups, then the producer's
// registers a thread: the producer warpgroup gives back what the consumers
// take (setmaxnreg), 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int kTcProducerRegs = 40;
constexpr int kTcConsumerRegs = 232;

template <int kBN>
struct TcCfg {
  static constexpr int kA = 128 * kTcBK * 2;    // bytes of a stage's A (up to 128 rows)
  static constexpr int kB = kBN * kTcBK * 2;    // bytes of a stage's B
  static constexpr int kStage = kA + kB;
  // 1024 bytes to align the ring (the swizzle's period), then the ring
  // and its 2 x kTcStages mbarriers
  static constexpr size_t kSmem = 1024 + kTcStages * kStage + 2 * kTcStages * 8;
};

// the box at (c0, c1, c2) of ``map``'s tensor into shared memory at
// ``dst``; completes on ``bar`` by complete_tx
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at
// ``addr``: ``lbo`` and ``sbo`` in bytes (for K-major A the stride of 8-row
// groups is sbo, lbo unused; for N-major B lbo steps 64 columns and sbo 8
// k rows)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d (+)= A (64 x 16, K-major) B (16 x N, N-major), f32 accumulate; the
// accumulator is zeroed first when scale_d is 0
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int kN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (kN == 128) {
    wgmma_n128(d, da, db, scale_d);
  } else {
    wgmma_n64(d, da, db, scale_d);
  }
}

// keeps the compiler from moving accumulator accesses across a wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two neighbouring output elements o, o + 1 (o even), one paired store
__device__ __forceinline__ void store2(void* out, long o, int dt, float v0, float v1) {
  if (dt == kF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// map_a: A as (K, M, batch), boxes of 64 x (64 per consumer warpgroup);
// map_b: B as (N, K, batch), boxes of 64 x 64; both 128-byte swizzled
template <typename TI, int kBN, int kStages, bool kBatched>
__global__ void __launch_bounds__(kTcThreads, 1)
sfc_matmul_tile(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const int* __restrict__ sched,
                int M, int N, int K, int bm, int bn, int mt, int nt, int order, int mode,
                int units, Epilogue ep) {
  static_assert(sizeof(TI) == 2, "the tensor-core tile path takes bf16");
  using C = TcCfg<kBN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * C::kStage);
  uint64_t* empty = full + kStages;
  const int nc = blockDim.x / 128 - 1;  // consumer warpgroups
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles = mt * nt;
  const int kt = (K + kTcBK - 1) / kTcBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);            // the producer's arrival, then the bytes
      mbar_init(&empty[s], 4 * nc);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier

  // the roles split here and never meet again (setmaxnreg needs it)
  if (warp >= 4 * nc) {  // the producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTcProducerRegs));
    if (warp != 4 * nc || lane != 0) return;
    const uint32_t bytes = nc * 64 * kTcBK * 2 + C::kB;
    int s = 0;
    uint32_t ph = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int bz = kBatched ? u / tiles : 0;
      int ti, tj;
      decode_tile(u - bz * tiles, mode, mt, nt, order, sched, &ti, &tj);
      for (int kb = 0; kb < kt; ++kb) {
        mbar_wait(&empty[s], ph ^ 1u);  // the consumers are done with stage s
        unsigned char* st = ring + s * C::kStage;
        mbar_arrive_expect(&full[s], bytes);
        tma_load3(st, &map_a, kb * kTcBK, ti * bm, bz, &full[s]);
#pragma unroll
        for (int c = 0; c < kBN / 64; ++c)
          tma_load3(st + C::kA + c * 64 * kTcBK * 2, &map_b, tj * bn + 64 * c, kb * kTcBK, bz,
                    &full[s]);
        if (++s == kStages) {
          s = 0;
          ph ^= 1u;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTcConsumerRegs));

  // a consumer warpgroup: rows 64 g .. 64 g + 63 of the block; acc[4 q +
  // 2 h + e] is row r_in + 8 h, column 8 q + c_in + e of the tile
  const int g = warp / 4;
  const int r_in = 64 * g + 16 * (warp % 4) + lane / 4;
  const int c_in = 2 * (lane % 4);
  float acc[kBN / 2] = {};
  int s = 0;
  uint32_t ph = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int bz = kBatched ? u / tiles : 0;
    int ti, tj;
    decode_tile(u - bz * tiles, mode, mt, nt, order, sched, &ti, &tj);
    const long base = static_cast<long>(bz) * M * N;
    const int row0 = ti * bm;
    const int col0 = tj * bn;
    const int rows = min(bm, M - row0);
    const int cols = min(bn, N - col0);
    // the epilogue's bias (by column) and residual, fetched while the
    // k-loop runs; zero where absent or outside the tile
    float bv[kBN / 4], rv[kBN / 2];
#pragma unroll
    for (int q = 0; q < kBN / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * q + c_in + e;
        bv[2 * q + e] = ep.bias != nullptr && c < cols
                            ? load_as_f32(ep.bias, col0 + c, ep.bias_dt) : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_in + 8 * h;
          rv[4 * q + 2 * h + e] =
              ep.res != nullptr && c < cols && r < rows
                  ? load_as_f32(ep.res, base + static_cast<long>(row0 + r) * N + col0 + c,
                                ep.res_dt)
                  : 0.0f;
        }
      }
    }

    int prev = 0;
    for (int kb = 0; kb < kt; ++kb) {
      mbar_wait(&full[s], ph);
      const uint32_t st = smem_u32(ring + s * C::kStage);
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < kTcBK / 16; ++k16) {
        // A: +32 bytes a k16 step inside the swizzled 128-byte rows; B: 16 k rows
        const uint64_t da = wgmma_desc(st + g * 64 * 128 + 32 * k16, 16, 1024);
        const uint64_t db = wgmma_desc(st + C::kA + 2048 * k16, 64 * kTcBK * 2, 1024);
        wgmma_tile<kBN>(acc, da, db, kb > 0 || k16 > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_regs(acc);
      if (kb > 0) {  // k-block kb - 1's wgmmas are done: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == kStages) {
        s = 0;
        ph ^= 1u;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // +bias -> act -> +residual on the f32 sum, one cast and one store an
    // element (finish's arithmetic), two columns a store
#pragma unroll
    for (int q = 0; q < kBN / 8; ++q) {
      const int c = 8 * q + c_in;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_in + 8 * h;
        if (c >= cols || r >= rows) continue;
        const int i = 4 * q + 2 * h;
        const float v0 = activate(acc[i] + bv[2 * q], ep.act) + rv[i];
        const float v1 = activate(acc[i + 1] + bv[2 * q + 1], ep.act) + rv[i + 1];
        const long o = base + static_cast<long>(row0 + r) * N + col0 + c;
        if (c + 1 < cols) {
          store2(ep.out, o, ep.out_dt, v0, v1);
        } else {
          store_from_f32(ep.out, o, ep.out_dt, v0);
        }
      }
    }
  }
}

// Raise a kernel's dynamic shared memory limit to the ``bytes`` it
// always asks for, once per kernel.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  return err;
}

bool rows_path(int M, int N, int bn, int vec) {
  return M <= kRowsMaxM && bn == 128 && N % 8 == 0 && vec;
}

// the tile path on tensor cores: bf16 16-byte vectors off the rows path
// (kernels/sfc_matmul.py::tile_path mirrors it)
bool tc_path(int M, int N, int bn, int vec, size_t isz) {
  return isz == 2 && vec && !rows_path(M, N, bn, vec);
}

// streaming multiprocessors of the current device (cached per device)
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 1;
  }
  return counts[dev];
}

// the map of a (batch, rows, cols) row-major bf16 tensor, read in boxes of
// box_cols (128 bytes: the swizzle's span) x box_rows x 1, 128-byte
// swizzled; TMA zero-fills past the tensor
bool tc_map(CUtensorMap* map, const void* base, int batch, int rows, int cols,
            int box_rows) {
  const repro_torch::EncodeTiled encode = repro_torch::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kTcBK),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor-core tile kernel over ``batch`` elements: one persistent
// block per SM (fewer if there are fewer steps), 64 block rows per
// consumer warpgroup
template <int kBN, bool kB>
cudaError_t launch_tc(const void* a, const void* b, const int* sched, int batch, int M,
                      int N, int K, int bm, int bn, int mt, int nt, int order, int mode,
                      const Epilogue& ep, cudaStream_t stream) {
  constexpr auto kernel = sfc_matmul_tile<__nv_bfloat16, kBN, kTcStages, kB>;
  const int nc = bm > 64 ? 2 : 1;
  const long units = static_cast<long>(batch) * mt * nt;
  if (units > 0x7fffffffL) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tc_map(&map_a, a, batch, M, K, 64 * nc) || !tc_map(&map_b, b, batch, K, N, kTcBK))
    return cudaErrorInvalidValue;
  const size_t smem = TcCfg<kBN>::kSmem;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(units < sm_count() ? units : sm_count());
  kernel<<<grid, 128 * (nc + 1), smem, stream>>>(map_a, map_b, sched, M, N, K, bm, bn, mt, nt,
                                                order, mode, static_cast<int>(units), ep);
  return cudaGetLastError();
}

// a rows kernel over (T * split, batch) blocks, clusters of ``split``
template <auto Kernel, typename TI>
cudaError_t launch_rows(size_t smem, const TI* a, const TI* b,
                        const int* sched, int batch, int M, int N, int K,
                        int nt, int order, int mode, int split,
                        const Epilogue& ep, cudaStream_t stream) {
  cudaError_t err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt * split, batch);
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, Kernel, a, b, sched, M, N, K, 1, nt, order,
                           mode, split, ep);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the SIMT tile kernel: one block per tile step, per batch element
template <typename TI, bool kVec, bool kB>
cudaError_t launch_tile(const TI* a, const TI* b, const int* sched, int batch, int M, int N,
                        int K, int bm, int bn, int mt, int nt, int order, int mode,
                        const Epilogue& ep, cudaStream_t stream) {
  const size_t smem = TileCfg<TI>::kSmem;
  const cudaError_t err = allow_smem<sfc_matmul_tile<TI, kVec, kB>>(smem);
  if (err != cudaSuccess) return err;
  sfc_matmul_tile<TI, kVec, kB><<<dim3(mt * nt, batch), kTileThreads, smem, stream>>>(
      a, b, sched, M, N, K, bm, bn, mt, nt, order, mode, ep);
  return cudaGetLastError();
}

template <typename TI, bool kB>
cudaError_t launch(const void* a, const void* b, const int* sched, int batch,
                   int M, int N, int K, int bm, int bn, int mt, int nt,
                   int order, int mode, int vec, int split, const Epilogue& ep,
                   cudaStream_t stream) {
  const TI* pa = static_cast<const TI*>(a);
  const TI* pb = static_cast<const TI*>(b);
  if (rows_path(M, N, bn, vec)) {
    if constexpr (sizeof(TI) == 2) {
      return launch_rows<sfc_matmul_rows_bf16<kB>>(
          kMmaSmem, pa, pb, sched, batch, M, N, K, nt, order, mode, split, ep, stream);
    } else if (M <= 4) {
      return launch_rows<sfc_matmul_rows_f32<4, kB>>(
          RowsF32<4>::kSmem, pa, pb, sched, batch, M, N, K, nt, order, mode, split, ep,
          stream);
    } else {
      return launch_rows<sfc_matmul_rows_f32<8, kB>>(
          RowsF32<8>::kSmem, pa, pb, sched, batch, M, N, K, nt, order, mode, split, ep,
          stream);
    }
  }
  if constexpr (sizeof(TI) == 2) {
    if (tc_path(M, N, bn, vec, sizeof(TI))) {
      return bn > 64 ? launch_tc<128, kB>(pa, pb, sched, batch, M, N, K, bm, bn, mt, nt, order,
                                          mode, ep, stream)
                     : launch_tc<64, kB>(pa, pb, sched, batch, M, N, K, bm, bn, mt, nt, order,
                                         mode, ep, stream);
    }
    // bf16 on the SIMT loop: only operands that are not 16-byte vectors
    return launch_tile<TI, false, kB>(pa, pb, sched, batch, M, N, K, bm, bn, mt, nt, order,
                                      mode, ep, stream);
  } else if (vec) {
    return launch_tile<TI, true, kB>(pa, pb, sched, batch, M, N, K, bm, bn, mt, nt, order,
                                     mode, ep, stream);
  } else {
    return launch_tile<TI, false, kB>(pa, pb, sched, batch, M, N, K, bm, bn, mt, nt, order,
                                      mode, ep, stream);
  }
}

size_t dtype_size(int dt) { return dt == kF32 ? 4 : 2; }

// ``split`` is a cluster size the rows path can take: 1, 2, 4 or 8, and
// above 1 only on the rows path with a non-empty K range on every rank
bool split_ok(int split, int M, int N, int K, int bn, int vec, size_t isz) {
  if (split != 1 && split != 2 && split != 4 && split != kMaxSplit) return false;
  if (split == 1) return true;
  const int v = static_cast<int>(16 / isz);
  return rows_path(M, N, bn, vec) && (split - 1) * split_len(K, split, v) < K;
}

// One launch per chunk of at most kMaxGridY batch elements; ``batched``
// picks the kBatched instantiations (B3), otherwise batch must be 1 (B1).
cudaError_t launch_all(const void* a, const void* b, const void* bias,
                       const void* res, void* out, const void* sched,
                       bool batched, int batch, int M, int N, int K, int bm,
                       int bn, int bk, int in_dt, int out_dt, int bias_dt,
                       int res_dt, int act, int mode, int order, int vec,
                       int split, cudaStream_t stream) {
  const size_t isz = dtype_size(in_dt);
  // bk sizes no buffer of the kernels any more; the bm x bk + bk x bn
  // bound is kept so the entry refuses what it always refused
  if (batch <= 0 || (!batched && batch != 1) || M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 ||
      bk <= 0 || bm % 16 != 0 || bn % 16 != 0 || bm > 128 || bn > 128 ||
      static_cast<size_t>(bm * bk + bk * bn) * isz > kSmemMax ||
      (mode == kTable && sched == nullptr) ||
      (in_dt != kF32 && in_dt != kBF16) ||
      !split_ok(split, M, N, K, bn, vec, isz)) {
    return cudaErrorInvalidValue;
  }
  const int mt = (M + bm - 1) / bm;
  const int nt = (N + bn - 1) / bn;
  const int* tab = static_cast<const int*>(sched);
  const size_t mk = static_cast<size_t>(M) * K;
  const size_t kn = static_cast<size_t>(K) * N;
  const size_t mn = static_cast<size_t>(M) * N;
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const int nb = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    const char* pa = static_cast<const char*>(a) + b0 * mk * isz;
    const char* pb = static_cast<const char*>(b) + b0 * kn * isz;
    const void* pr = res == nullptr ? nullptr
                                    : static_cast<const char*>(res) +
                                          b0 * mn * dtype_size(res_dt);
    void* po = static_cast<char*>(out) + b0 * mn * dtype_size(out_dt);
    const Epilogue ep{bias, pr, po, out_dt, bias_dt, res_dt, act};
    cudaError_t err;
    if (in_dt == kF32) {
      err = batched ? launch<float, true>(pa, pb, tab, nb, M, N, K, bm, bn,
                                          mt, nt, order, mode, vec, split, ep,
                                          stream)
                    : launch<float, false>(pa, pb, tab, nb, M, N, K, bm, bn,
                                           mt, nt, order, mode, vec, split, ep,
                                           stream);
    } else {
      err = batched ? launch<__nv_bfloat16, true>(pa, pb, tab, nb, M, N, K,
                                                  bm, bn, mt, nt, order, mode,
                                                  vec, split, ep, stream)
                    : launch<__nv_bfloat16, false>(pa, pb, tab, nb, M, N, K,
                                                   bm, bn, mt, nt, order, mode,
                                                   vec, split, ep, stream);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// C entries bound by ctypes (kernels/sfc_matmul.py).  Each returns a
// cudaError_t.  bias, res and sched may be null; order is log2(mt) for
// mode 4; vec says that K and N are multiples of 16 bytes' worth of
// elements and a, b are 16-byte aligned.  bm and bn must be multiples of
// 16 up to 128.  split is the rows path's cluster size (1, 2, 4 or 8;
// kernels/sfc_matmul.py::split_plan); anything else is refused with
// cudaErrorInvalidValue.
//
// B1: one GEMM, a (M, K) @ b (K, N) -> out (M, N).
extern "C" int sfc_matmul_launch(const void* a, const void* b,
                                 const void* bias, const void* res, void* out,
                                 const void* sched, int M, int N, int K,
                                 int bm, int bn, int bk, int in_dt, int out_dt,
                                 int bias_dt, int res_dt, int act, int mode,
                                 int order, int vec, int split, void* stream) {
  return static_cast<int>(launch_all(
      a, b, bias, res, out, sched, false, 1, M, N, K, bm, bn, bk, in_dt, out_dt,
      bias_dt, res_dt, act, mode, order, vec, split,
      static_cast<cudaStream_t>(stream)));
}

// B3: ``batch`` GEMMs, a (batch, M, K) @ b (batch, K, N) -> out (batch, M,
// N); bias (N,) shared, res (batch, M, N); split as for one element.
extern "C" int sfc_matmul_batched_launch(
    const void* a, const void* b, const void* bias, const void* res,
    void* out, const void* sched, int batch, int M, int N, int K, int bm,
    int bn, int bk, int in_dt, int out_dt, int bias_dt, int res_dt, int act,
    int mode, int order, int vec, int split, void* stream) {
  return static_cast<int>(launch_all(
      a, b, bias, res, out, sched, true, batch, M, N, K, bm, bn, bk, in_dt, out_dt,
      bias_dt, res_dt, act, mode, order, vec, split,
      static_cast<cudaStream_t>(stream)));
}
