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
//   order of a space-filling curve: block t of the launch maps to tile
//   (i, j) through the (T, 2) int32 schedule table the host builds with
//   core/schedule.py::grid_schedule (mode 0, the table variant), or
//   through a closed-form decode of t inside the kernel (modes 1-4:
//   rowmajor, colmajor, morton, hilbert; morton and hilbert need a
//   square power-of-two grid, as decode_step asserts).  The closed form
//   is the paper's trade of index computation for locality.
//
// What bounds it on the H100: at the serving path's shapes A has S = 4
// rows (one per decode slot), so the work is ~4 FLOP per weight byte
// and the kernel is bound by reading B (the weights) from HBM: one
// qwen3-1.7b decode step reads ~3.44 GB of bf16 weights through this
// kernel, a bound of ~1.03 ms at 3.35 TB/s.
//
// What the design does about it: one thread block per output tile
// (the grid and schedule the JAX wrapper builds for the padded shape),
// an f32 accumulator in registers and the epilogue applied in registers
// before the single store; ragged M/N/K edges are masked here, so the
// wrapper never pads.  The block takes one of two paths, chosen from
// the shapes by the launcher:
//
//  * rows path (M <= 8, bn = 128, 16-byte aligned rows): a 128-row tile
//    holds at most 8 live rows, so staging B in shared memory buys no
//    reuse.  512 threads stream B straight from HBM with 16-byte loads,
//    each thread owning 8 columns and a strided 1/32 slice of K with
//    eight loads in flight; the 32 k-slice partials are reduced through
//    warp shuffles and shared memory.  All serving-path GEMMs take it.
//  * tile path (everything else): a k-loop over bk-deep tiles of A and B
//    staged in shared memory; 256 threads each own an (bm/16) x (bn/16)
//    register micro-tile; rows >= M are skipped.
//
// Batched (B3): the same kernels, instantiated with kBatched, take the
// batch element from blockIdx.y and offset A (b, M, K), B (b, K, N), the
// residual and the output (b, M, N) by it in 64-bit arithmetic; bias
// (N,) is shared.  The grid is (mt*nt, batch), tile step in x, so blocks
// are dispatched batch outermost with the curve inside each element, as
// in the reference.  The per-element arithmetic is the one-GEMM kernel's,
// so each element equals B1 on it bit for bit.  The one-GEMM
// instantiations (kBatched false) compile without the offsets: moving
// them in unconditionally made the rows path ~1.8x slower per launch on
// the H100.  Batches beyond gridDim.y's 65535 are launched in chunks.
//
// Known limit: a 2048-wide output has only 16 tiles of 128 columns, so
// the projections run on 16 of the 132 SMs; filling the card (split-K
// across blocks, wgmma, TMA) is later work.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::kBF16;
using repro_torch::kF32;
using repro_torch::load_as_f32;
using repro_torch::store_from_f32;
using repro_torch::to_f32;

constexpr int kTileThreads = 256;  // tile path: a 16 x 16 thread grid
constexpr int kRowsThreads = 512;  // rows path: 16 column groups x 32 k-slices
constexpr int kRowsMaxM = 8;       // the rows path takes M <= 8
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

// block t -> tile (i, j), the device twin of kernels/sfc_matmul.py::decode_step
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

// 8 consecutive elements of B, loaded raw from a 16-byte-aligned address
// (kept raw so a thread holds many loads in flight in few registers)
template <typename TI>
struct Raw8;
template <>
struct Raw8<float> {
  float4 x, y;
  __device__ __forceinline__ void load(const float* p) {
    x = __ldg(reinterpret_cast<const float4*>(p));
    y = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    x = make_float4(0.f, 0.f, 0.f, 0.f);
    y = x;
  }
  __device__ __forceinline__ void widen(float* v) const {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  }
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void widen(float* v) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  }
};

// ---------------------------------------------------------------- rows path
// M <= R rows, bn = 128: thread = (column group cg of 8 columns, k-slice ks)
template <typename TI, int R, bool kBatched>
__global__ void __launch_bounds__(kRowsThreads)
sfc_matmul_rows(const TI* __restrict__ a, const TI* __restrict__ b,
                const int* __restrict__ sched, int M, int N, int K, int mt,
                int nt, int order, int mode, Epilogue ep) {
  constexpr int kSlices = kRowsThreads / 16;  // 32 k-slices
  constexpr int U = 16 / sizeof(TI);          // 128 bytes of B in flight
  extern __shared__ __align__(16) float red[];  // [16 warps][R][128]

  long base = 0;  // the batch element's offset into residual and output
  if constexpr (kBatched) {
    const long bz = blockIdx.y;
    a += bz * M * K;
    b += bz * K * N;
    base = bz * M * N;
  }
  int ti, tj;
  decode_tile(blockIdx.x, mode, mt, nt, order, sched, &ti, &tj);
  const int col0 = tj * 128;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cg = lane % 16;
  const int ks = warp * 2 + lane / 16;
  const int c0 = col0 + cg * 8;
  const bool col_ok = c0 < N;  // N % 8 == 0: a group is wholly in or out

  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int k = ks; k < K; k += kSlices * U) {
    Raw8<TI> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * kSlices;
      if (col_ok && kk < K) {
        raw[u].load(b + static_cast<long>(kk) * N + c0);
      } else {
        raw[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * kSlices;
      if (kk < K) {
        float bv[8];
        raw[u].widen(bv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < M) {
            const float av = to_f32(a[static_cast<long>(r) * K + kk]);
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av, bv[c], acc[r][c]);
          }
        }
      }
    }
  }

  // reduce the two k-slices of a warp by shuffle, then the 16 warps
  // through shared memory
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  if (lane < 16) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) red[(warp * R + r) * 128 + cg * 8 + c] = acc[r][c];
  }
  __syncthreads();
  for (int e = tid; e < M * 128; e += kRowsThreads) {
    const int r = e / 128;
    const int c = e % 128;
    if (col0 + c < N) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kRowsThreads / 32; ++w) v += red[(w * R + r) * 128 + c];
      finish(ep, v, base, r, col0 + c, N);
    }
  }
}

// ---------------------------------------------------------------- tile path
// bm, bn multiples of 16 up to 128; thread (ty, tx) owns rows ty + 16 i
// and columns tx + 16 j of the tile
template <typename TI, bool kVec, bool kBatched>
__global__ void __launch_bounds__(kTileThreads)
sfc_matmul_tile(const TI* __restrict__ a, const TI* __restrict__ b,
                const int* __restrict__ sched, int M, int N, int K, int bm,
                int bn, int bk, int mt, int nt, int order, int mode,
                Epilogue ep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TI* As = reinterpret_cast<TI*>(smem_raw);  // bm x bk (live rows only)
  TI* Bs = As + bm * bk;                      // bk x bn

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
  const int rows = min(bm, M - row0);  // rows >= M are skipped
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int mi = bm / 16;
  const int nj = bn / 16;
  const TI zero = from_f32<TI>(0.0f);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int kt = (K + bk - 1) / bk;
  for (int kk = 0; kk < kt; ++kk) {
    const int k0 = kk * bk;
    if (kVec) {
      // K, N, bk, bn are multiples of VEC: a vector is wholly in or out
      constexpr int VEC = 16 / sizeof(TI);
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const int cpa = bk / VEC;
      for (int e = tid; e < rows * cpa; e += kTileThreads) {
        const int r = e / cpa;
        const int c = (e % cpa) * VEC;
        const int gk = k0 + c;
        *reinterpret_cast<uint4*>(As + r * bk + c) =
            gk < K ? *reinterpret_cast<const uint4*>(
                         a + static_cast<long>(row0 + r) * K + gk)
                   : z;
      }
      const int cpb = bn / VEC;
#pragma unroll 4
      for (int e = tid; e < bk * cpb; e += kTileThreads) {
        const int r = e / cpb;
        const int c = (e % cpb) * VEC;
        const int gk = k0 + r;
        const int gn = col0 + c;
        *reinterpret_cast<uint4*>(Bs + r * bn + c) =
            (gk < K && gn < N) ? *reinterpret_cast<const uint4*>(
                                     b + static_cast<long>(gk) * N + gn)
                               : z;
      }
    } else {
      for (int e = tid; e < rows * bk; e += kTileThreads) {
        const int r = e / bk;
        const int gk = k0 + e % bk;
        As[e] = gk < K ? a[static_cast<long>(row0 + r) * K + gk] : zero;
      }
#pragma unroll 4
      for (int e = tid; e < bk * bn; e += kTileThreads) {
        const int gk = k0 + e / bn;
        const int gn = col0 + e % bn;
        Bs[e] = (gk < K && gn < N) ? b[static_cast<long>(gk) * N + gn] : zero;
      }
    }
    __syncthreads();
    for (int q = 0; q < bk; ++q) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        av[i] = (i < mi && r < rows) ? to_f32(As[r * bk + q]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = j < nj ? to_f32(Bs[q * bn + tx + 16 * j]) : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (i < mi && j < nj && r < rows && gn < N) finish(ep, acc[i][j], base, row0 + r, gn, N);
    }
  }
}

// Raise a kernel's dynamic shared memory limit, once per kernel.
template <auto Kernel>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return err;
}

template <typename TI, bool kB>
cudaError_t launch(const void* a, const void* b, const int* sched, int batch,
                   int M, int N, int K, int bm, int bn, int bk, int mt,
                   int nt, int order, int mode, int vec, const Epilogue& ep,
                   cudaStream_t stream) {
  const TI* pa = static_cast<const TI*>(a);
  const TI* pb = static_cast<const TI*>(b);
  const dim3 grid(mt * nt, batch);
  cudaError_t err;
  if (M <= kRowsMaxM && bn == 128 && N % 8 == 0 && vec) {
    if (M <= 4) {
      const size_t smem = sizeof(float) * (kRowsThreads / 32) * 4 * 128;
      if ((err = allow_smem<sfc_matmul_rows<TI, 4, kB>>()) != cudaSuccess) return err;
      sfc_matmul_rows<TI, 4, kB><<<grid, kRowsThreads, smem, stream>>>(
          pa, pb, sched, M, N, K, mt, nt, order, mode, ep);
    } else {
      const size_t smem = sizeof(float) * (kRowsThreads / 32) * 8 * 128;
      if ((err = allow_smem<sfc_matmul_rows<TI, 8, kB>>()) != cudaSuccess) return err;
      sfc_matmul_rows<TI, 8, kB><<<grid, kRowsThreads, smem, stream>>>(
          pa, pb, sched, M, N, K, mt, nt, order, mode, ep);
    }
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(bm * bk + bk * bn) * sizeof(TI);
  if (vec) {
    if ((err = allow_smem<sfc_matmul_tile<TI, true, kB>>()) != cudaSuccess) return err;
    sfc_matmul_tile<TI, true, kB><<<grid, kTileThreads, smem, stream>>>(
        pa, pb, sched, M, N, K, bm, bn, bk, mt, nt, order, mode, ep);
  } else {
    if ((err = allow_smem<sfc_matmul_tile<TI, false, kB>>()) != cudaSuccess) return err;
    sfc_matmul_tile<TI, false, kB><<<grid, kTileThreads, smem, stream>>>(
        pa, pb, sched, M, N, K, bm, bn, bk, mt, nt, order, mode, ep);
  }
  return cudaGetLastError();
}

size_t dtype_size(int dt) { return dt == kF32 ? 4 : 2; }

// One launch per chunk of at most kMaxGridY batch elements; ``batched``
// picks the kBatched instantiations (B3), otherwise batch must be 1 (B1).
cudaError_t launch_all(const void* a, const void* b, const void* bias,
                       const void* res, void* out, const void* sched,
                       bool batched, int batch, int M, int N, int K, int bm,
                       int bn, int bk, int in_dt, int out_dt, int bias_dt,
                       int res_dt, int act, int mode, int order, int vec,
                       cudaStream_t stream) {
  const size_t isz = dtype_size(in_dt);
  if (batch <= 0 || (!batched && batch != 1) || M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 ||
      bk <= 0 || bm % 16 != 0 || bn % 16 != 0 || bm > 128 || bn > 128 ||
      static_cast<size_t>(bm * bk + bk * bn) * isz > kSmemMax ||
      (mode == kTable && sched == nullptr) ||
      (in_dt != kF32 && in_dt != kBF16)) {
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
                                          bk, mt, nt, order, mode, vec, ep,
                                          stream)
                    : launch<float, false>(pa, pb, tab, nb, M, N, K, bm, bn,
                                           bk, mt, nt, order, mode, vec, ep,
                                           stream);
    } else {
      err = batched ? launch<__nv_bfloat16, true>(pa, pb, tab, nb, M, N, K,
                                                  bm, bn, bk, mt, nt, order,
                                                  mode, vec, ep, stream)
                    : launch<__nv_bfloat16, false>(pa, pb, tab, nb, M, N, K,
                                                   bm, bn, bk, mt, nt, order,
                                                   mode, vec, ep, stream);
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
// 16 up to 128.
//
// B1: one GEMM, a (M, K) @ b (K, N) -> out (M, N).
extern "C" int sfc_matmul_launch(const void* a, const void* b,
                                 const void* bias, const void* res, void* out,
                                 const void* sched, int M, int N, int K,
                                 int bm, int bn, int bk, int in_dt, int out_dt,
                                 int bias_dt, int res_dt, int act, int mode,
                                 int order, int vec, void* stream) {
  return static_cast<int>(launch_all(
      a, b, bias, res, out, sched, false, 1, M, N, K, bm, bn, bk, in_dt, out_dt,
      bias_dt, res_dt, act, mode, order, vec,
      static_cast<cudaStream_t>(stream)));
}

// B3: ``batch`` GEMMs, a (batch, M, K) @ b (batch, K, N) -> out (batch, M,
// N); bias (N,) shared, res (batch, M, N).
extern "C" int sfc_matmul_batched_launch(
    const void* a, const void* b, const void* bias, const void* res,
    void* out, const void* sched, int batch, int M, int N, int K, int bm,
    int bn, int bk, int in_dt, int out_dt, int bias_dt, int res_dt, int act,
    int mode, int order, int vec, void* stream) {
  return static_cast<int>(launch_all(
      a, b, bias, res, out, sched, true, batch, M, N, K, bm, bn, bk, in_dt, out_dt,
      bias_dt, res_dt, act, mode, order, vec,
      static_cast<cudaStream_t>(stream)));
}
