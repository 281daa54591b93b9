// Grouped SFC GEMM over a moe layer's experts (B5), for Hopper (sm_90a).
//
// Replaces: the routed experts of a moe layer, which the TPU reference
// runs as XLA einsums over every expert (src/repro/models/moe.py::
// _expert_ffn); the port serves each token through its own top-k experts.
//
//   A (R, K) holds the routed rows sorted by expert: expert e's segment is
//   rows [off[e], off[e + 1]), off (E + 1,) int32 on the device (a cumsum
//   of the counts; the host never reads it).  For every segment,
//   C_e = A_e @ W[e] with W (E, K, N); gated, C_e = silu(A_e @ W[e]) *
//   (A_e @ W3[e]) from one pass over A_e (the SwiGLU's up-projection and
//   gate), summed in f32, then one cast and one store an element.
//
// What bounds it on the H100: bytes.  A touched expert's weights are read
// once for all of its rows: at a decode step's <= 8 rows an expert does
// ~2 FLOP a weight byte, at a prefill chunk's ~32 rows ~32, both far
// below the ~295 FLOP/byte balance point.  Untouched experts are never
// read.  What the design does about it:
//
//  * One launch covers every expert.  Output tiles are bm rows (of one
//    segment) x 128 columns; expert e has mt_e = ceil(c_e / bm) row tiles
//    and the launch's grid covers the worst case, (ceil(R / bm) + min(E, R))
//    x nt blocks, since sum_e mt_e <= ceil(R / bm) + (experts touched).
//    Each block stages off[] in shared memory, forms the tiles' prefix
//    sum over experts, finds its expert and tile there, and exits if it
//    has none.
//  * The paper's order inside an expert.  Block u's tile (i, j) in its
//    expert's mt_e x nt grid comes from the host-built table of that grid
//    (core/schedule.py::grid_schedule of the caller's curve; the tables of
//    mt = 1 .. mt_max are concatenated, the grid of mt rows at entry
//    nt * mt * (mt - 1) / 2), so consecutive blocks walk the curve over
//    one expert's weights, experts in order.
//  * Stream each weight tile once, as B1's rows path does: a 6-stage ring
//    of 32 k rows x 128 columns (8 KB, both W and W3 when gated) filled by
//    16-byte cp.async, five stages in flight while one is multiplied; the
//    tile's rows of A are staged a k chunk at a time.  Warp w owns columns
//    16 w .. 16 w + 15 for all of K (no split, no reduction across
//    blocks) and runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) on C^T =
//    W^T A^T, W^T by ldmatrix.trans from the ring, one n8 group of A's
//    rows per 8 rows: bm = 8 (one group, a decode step: every segment
//    holds <= 8 rows) or 64 (eight groups, a prefill chunk).
//  * Every element is one f32 sum in a fixed order (k in order, a k16
//    step inside the instruction), with no split and no atomics: the same
//    bits run to run.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::kBF16;
using repro_torch::kF32;
using repro_torch::smem_u32;
using repro_torch::store_from_f32;

constexpr int kThreads = 256;  // 8 warps, 16 columns each
constexpr int kStages = 6;     // stages of the ring of W
constexpr int kDepth = 32;     // k rows a stage
constexpr int kStage = kDepth * 256;  // bytes of one matrix's stage (128 bf16 columns)
constexpr int kMaxE = 1024;    // experts a launch takes (off[] in shared memory)
constexpr int kSmemMax = 232448;

// A's k chunk and its padded row (the bank offset of 4 words a row keeps
// the B-fragment loads of 8 rows conflict-free)
template <int kRG>
struct Cfg {
  static constexpr int kBM = 8 * kRG;
  static constexpr int kChunk = kRG == 1 ? 1024 : 512;
  static constexpr int kLd = kChunk + 8;
};

template <int kRG, bool kGated>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * kStage * (kGated ? 2 : 1) +
         static_cast<size_t>(Cfg<kRG>::kBM) * Cfg<kRG>::kLd * 2 + 2 * (kMaxE + 1) * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
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

// byte offset of (k row, 16-byte chunk) in a stage: chunk ^ (row & 7), so
// ldmatrix reads 8 rows of one chunk without bank conflicts
__device__ __forceinline__ int slot(int row, int chunk) {
  return row * 256 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mma16816(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid: (ceil(R / bm) + min(E, R)) * nt blocks of kThreads
template <int kRG, bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
sfc_matmul_grouped(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ w3, const int* __restrict__ off,
                   const int* __restrict__ sched, void* __restrict__ out, int out_dt, int E,
                   int K, int N, int nt) {
  using C = Cfg<kRG>;
  constexpr int kMats = kGated ? 2 : 1;
  constexpr int kRing = kStages * kStage * kMats;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw + kRing);  // [bm][kLd]
  int* off_s = reinterpret_cast<int*>(smem_raw + kRing + C::kBM * C::kLd * 2);
  int* cum_s = off_s + kMaxE + 1;  // row tiles x nt before expert e
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int e = tid; e <= E; e += kThreads) off_s[e] = off[e];
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int e = 0; e < E; ++e) {
      cum_s[e] = c;
      c += (off_s[e + 1] - off_s[e] + C::kBM - 1) / C::kBM * nt;
    }
    cum_s[E] = c;
  }
  __syncthreads();
  const int u = blockIdx.x;
  if (u >= cum_s[E]) return;  // an empty tile of the worst case
  int lo = 0, hi = E - 1;     // the expert whose units hold u
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (cum_s[mid] <= u) lo = mid; else hi = mid - 1;
  }
  const int e = lo;
  const int seg0 = off_s[e];
  const int ce = off_s[e + 1] - seg0;
  const int mte = (ce + C::kBM - 1) / C::kBM;
  const int t = (u - cum_s[e]) + nt * mte * (mte - 1) / 2;
  const int ti = sched[2 * t];
  const int tj = sched[2 * t + 1];
  const int row0 = seg0 + ti * C::kBM;
  const int rows = min(C::kBM, ce - ti * C::kBM);
  const int col0 = tj * 128;
  const __nv_bfloat16* we = w + static_cast<long>(e) * K * N;
  const __nv_bfloat16* w3e = kGated ? w3 + static_cast<long>(e) * K * N : nullptr;

  auto stage_a = [&](int kc0) {  // the tile's rows of A, k in [kc0, kc0 + kChunk)
    const int vpr = (min(K, kc0 + C::kChunk) - kc0) / 8;
    for (int i = tid; i < rows * vpr; i += kThreads) {
      const int r = i / vpr;
      const int c = (i % vpr) * 8;
      cp_async16(as + r * C::kLd + c, a + static_cast<long>(row0 + r) * K + kc0 + c, true);
    }
    cp_async_commit();
  };
  auto fill = [&](int g) {  // stage g: k rows kDepth g .. of the tile's 128 columns
#pragma unroll
    for (int i = 0; i < kDepth * 16 / kThreads; ++i) {
      const int c = tid + kThreads * i;
      const int row = c >> 4;
      const int chunk = c & 15;
      const int kk = g * kDepth + row;
      const int gn = col0 + 8 * chunk;
      const bool in = kk < K && gn < N;  // N % 8 == 0: a chunk is in or out
      const long at = static_cast<long>(kk) * N + gn;
      unsigned char* st = smem_raw + (g % kStages) * kStage * kMats;
      cp_async16(st + slot(row, chunk), in ? we + at : we, in);
      if constexpr (kGated) cp_async16(st + kStage + slot(row, chunk), in ? w3e + at : w3e, in);
    }
  };
  stage_a(0);

  float d[kRG][4] = {};
  float d3[kGated ? kRG : 1][4] = {};
  const int nst = (K + kDepth - 1) / kDepth;
  constexpr int kStagesPerChunk = C::kChunk / kDepth;
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < nst) fill(g);
    cp_async_commit();
  }
  for (int g = 0; g < nst; ++g) {
    const int kc0 = (g / kStagesPerChunk) * C::kChunk;
    if (g > 0 && g % kStagesPerChunk == 0) {  // the next chunk of A
      __syncthreads();
      stage_a(kc0);
      cp_async_wait<0>();
      __syncthreads();
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of stage g have landed
    __syncthreads();  // ... everyone's (A's first chunk too), and stage g - 1 is read
    if (g + kStages - 1 < nst) fill(g + kStages - 1);  // into the slot stage g - 1 used
    cp_async_commit();
    const unsigned st = smem_u32(smem_raw + (g % kStages) * kStage * kMats);
#pragma unroll
    for (int h = 0; h < kDepth / 16; ++h) {  // 16 k rows each
      const int j = lane >> 3;  // the 8 x 8 matrix whose row this lane names
      const int row = h * 16 + (j >> 1) * 8 + (lane & 7);
      const unsigned addr = st + slot(row, 2 * warp + (j & 1));
      unsigned a0, a1, a2, a3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
          : "r"(addr));
      unsigned g0 = 0u, g1 = 0u, g2 = 0u, g3 = 0u;
      if constexpr (kGated) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(g0), "=r"(g1), "=r"(g2), "=r"(g3)
            : "r"(addr + kStage));
      }
      const int kk = g * kDepth + h * 16 + (lane & 3) * 2;
#pragma unroll
      for (int rg = 0; rg < kRG; ++rg) {
        const int m = 8 * rg + (lane >> 2);  // A^T column (a row of the tile)
        unsigned b0 = 0u, b1 = 0u;
        if (m < rows) {
          const __nv_bfloat16* ar = as + m * C::kLd + (kk - kc0);
          if (kk < K) b0 = *reinterpret_cast<const unsigned*>(ar);
          if (kk + 8 < K) b1 = *reinterpret_cast<const unsigned*>(ar + 8);
        }
        mma16816(d[rg], a0, a1, a2, a3, b0, b1);
        if constexpr (kGated) mma16816(d3[rg], g0, g1, g2, g3, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // d[rg][i] is C[row 8 rg + (lane & 3) * 2 + (i & 1)][column 16 w + lane / 4 + 8 (i / 2)]
#pragma unroll
  for (int rg = 0; rg < kRG; ++rg) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 8 * rg + (lane & 3) * 2 + (i & 1);
      const int c = col0 + 16 * warp + (lane >> 2) + 8 * (i >> 1);
      if (r >= rows || c >= N) continue;
      float v = d[rg][i];
      if constexpr (kGated) v = v / (1.0f + expf(-v)) * d3[rg][i];
      store_from_f32(out, static_cast<long>(row0 + r) * N + c, out_dt, v);
    }
  }
}

template <int kRG, bool kGated>
cudaError_t launch(const void* a, const void* w, const void* w3, const int* off,
                   const int* sched, void* out, int out_dt, int R, int E, int K, int N,
                   cudaStream_t stream) {
  constexpr auto kernel = sfc_matmul_grouped<kRG, kGated>;
  constexpr size_t smem = smem_bytes<kRG, kGated>();
  static_assert(smem <= kSmemMax, "B5's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int bm = Cfg<kRG>::kBM;
  const int nt = (N + 127) / 128;
  const long blocks = (static_cast<long>(R + bm - 1) / bm + (E < R ? E : R)) * nt;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(w3), off, sched, out, out_dt, E, K, N, nt);
  return cudaGetLastError();
}

}  // namespace

// C entry bound by ctypes (kernels/sfc_matmul_grouped.py).  Returns a
// cudaError_t.  a (R, K) bf16 rows in expert order; w and, gated, w3 (E,
// K, N) bf16; off (E + 1,) int32 segment offsets and sched the
// concatenated (i, j) int32 tables of the mt x nt grids, mt = 1 .. the
// most row tiles a segment can have, all on the device; out (R, N) in
// out_dt (f32 or bf16).  bm is 8 (``rows8`` true: every segment holds at
// most 8 rows) or 64.  K and N must be multiples of 8 and every pointer
// 16-byte aligned.
extern "C" int sfc_matmul_grouped_launch(const void* a, const void* w, const void* w3,
                                         const void* off, const void* sched, void* out,
                                         int R, int E, int K, int N, int out_dt, int rows8,
                                         void* stream) {
  if (R <= 0 || E <= 0 || E > kMaxE || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 ||
      (out_dt != kF32 && out_dt != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* o = static_cast<const int*>(off);
  const int* s = static_cast<const int*>(sched);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows8) {
    err = w3 != nullptr ? launch<1, true>(a, w, w3, o, s, out, out_dt, R, E, K, N, st)
                        : launch<1, false>(a, w, w3, o, s, out, out_dt, R, E, K, N, st);
  } else {
    err = w3 != nullptr ? launch<8, true>(a, w, w3, o, s, out, out_dt, R, E, K, N, st)
                        : launch<8, false>(a, w, w3, o, s, out, out_dt, R, E, K, N, st);
  }
  return static_cast<int>(err);
}
