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
// SM (67/132 TFLOP/s); the bytes (3 n^2 f32) bound is 0.004 ms.  The
// walk is latency-bound long before that: every miss is a round trip to
// device memory (or L2) followed by a barrier.
//
// What the design does about it: slots and tags live in shared memory
// (at most 232,448 bytes; the wrapper raises past it).  The tags are read
// by every thread, so the hit/miss decision is uniform across the block;
// a step whose two blocks both hit passes no barrier at all.  A miss
// waits until every thread is done with the slots, copies the block with
// 16-byte loads where the shapes allow (scalar loads otherwise), updates
// the tag and the count, and waits again.  The bm x bn accumulator lives
// in f32 registers (element tid + q * threads for q < kMaxAcc) and is
// written once after the last k block.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::kBF16;
using repro_torch::kF32;
using repro_torch::store_from_f32;
using repro_torch::to_f32;

constexpr int kMaxThreads = 256;
constexpr int kMaxAcc = 64;       // accumulators per thread: bm*bn <= 16384
constexpr int kSmemMax = 232448;  // bytes of shared memory one block may use

// rows x cols block at src (row stride ld elements) -> dst (dense)
template <typename T, bool kVec>
__device__ __forceinline__ void copy_block(T* dst, const T* __restrict__ src,
                                           int rows, int cols, long ld) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  if (kVec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = cols / V;
    for (int e = tid; e < rows * per_row; e += nthr) {
      const int r = e / per_row;
      const int c = (e % per_row) * V;
      *reinterpret_cast<uint4*>(dst + r * cols + c) =
          __ldg(reinterpret_cast<const uint4*>(src + r * ld + c));
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthr) {
      dst[e] = src[(e / cols) * ld + e % cols];
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
sfc_matmul_cached_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const int* __restrict__ sched, void* out, int out_dt,
                         int* __restrict__ counts, int M, int N, int K, int bm,
                         int bn, int bk, int nslots, int tiles,
                         size_t tag_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_slots = reinterpret_cast<T*>(smem);                // nslots x bm x bk
  T* b_slots = a_slots + static_cast<size_t>(nslots) * bm * bk;  // x bk x bn
  int* a_tags = reinterpret_cast<int*>(smem + tag_offset);
  int* b_tags = a_tags + nslots;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int kt = K / bk;
  const int tile = bm * bn;
  const int nq = (tile + nthr - 1) / nthr;
  for (int s = tid; s < nslots; s += nthr) {
    a_tags[s] = -1;
    b_tags[s] = -1;
  }
  __syncthreads();

  int a_fetches = 0, b_fetches = 0;  // kept by thread 0
  for (int t = 0; t < tiles; ++t) {
    const int i = sched[2 * t];
    const int j = sched[2 * t + 1];
    float acc[kMaxAcc];
#pragma unroll
    for (int q = 0; q < kMaxAcc; ++q) acc[q] = 0.0f;

    for (int k = 0; k < kt; ++k) {
      const int a_id = i * kt + k;
      const int b_id = j * kt + k;
      const int a_slot = a_id % nslots;
      const int b_slot = b_id % nslots;
      // uniform: tags change only between the two barriers below
      const bool miss_a = a_tags[a_slot] != a_id;
      const bool miss_b = b_tags[b_slot] != b_id;
      if (miss_a || miss_b) {
        __syncthreads();  // every thread is done with the slots and tags
        if (miss_a) {
          copy_block<T, kVec>(a_slots + static_cast<size_t>(a_slot) * bm * bk,
                              a + static_cast<long>(i) * bm * K +
                                  static_cast<long>(k) * bk,
                              bm, bk, K);
        }
        if (miss_b) {
          copy_block<T, kVec>(b_slots + static_cast<size_t>(b_slot) * bk * bn,
                              b + static_cast<long>(k) * bk * N +
                                  static_cast<long>(j) * bn,
                              bk, bn, N);
        }
        if (tid == 0) {
          if (miss_a) {
            a_tags[a_slot] = a_id;
            ++a_fetches;
          }
          if (miss_b) {
            b_tags[b_slot] = b_id;
            ++b_fetches;
          }
        }
        __syncthreads();  // the copies and tags are visible
      }
      const T* As = a_slots + static_cast<size_t>(a_slot) * bm * bk;
      const T* Bs = b_slots + static_cast<size_t>(b_slot) * bk * bn;
#pragma unroll
      for (int q = 0; q < kMaxAcc; ++q) {
        if (q >= nq) break;
        const int e = tid + q * nthr;
        if (e < tile) {
          const int r = e / bn;
          const int c = e % bn;
          float s = acc[q];
          for (int kk = 0; kk < bk; ++kk) {
            s = fmaf(to_f32(As[r * bk + kk]), to_f32(Bs[kk * bn + c]), s);
          }
          acc[q] = s;
        }
      }
    }

#pragma unroll
    for (int q = 0; q < kMaxAcc; ++q) {
      if (q >= nq) break;
      const int e = tid + q * nthr;
      if (e < tile) {
        const long o = static_cast<long>(i * bm + e / bn) * N + j * bn + e % bn;
        store_from_f32(out, o, out_dt, acc[q]);
      }
    }
  }
  if (tid == 0) {
    counts[0] = a_fetches;
    counts[1] = b_fetches;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const int* sched, void* out,
                   int out_dt, int* counts, int M, int N, int K, int bm,
                   int bn, int bk, int nslots, int vec, cudaStream_t stream) {
  const size_t slot_bytes =
      static_cast<size_t>(nslots) * (bm * bk + bk * bn) * sizeof(T);
  const size_t tag_offset = (slot_bytes + 15) / 16 * 16;
  const size_t smem = tag_offset + 2 * sizeof(int) * nslots;
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  const int tiles = (M / bm) * (N / bn);
  int threads = (bm * bn + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  auto kernel = vec ? sfc_matmul_cached_kernel<T, true>
                    : sfc_matmul_cached_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<1, threads, smem, stream>>>(pa, pb, sched, out, out_dt, counts, M,
                                       N, K, bm, bn, bk, nslots, tiles,
                                       tag_offset);
  return cudaGetLastError();
}

}  // namespace

// C entry bound by ctypes (kernels/sfc_matmul_cached.py).  Returns a
// cudaError_t.  a (M, K), b (K, N) and out (M, N) are contiguous; M, N, K
// divide by bm, bn, bk; bm*bn <= 16384; sched is the (M/bm * N/bn, 2)
// int32 tile order; counts receives [A fetches, B fetches].  vec says that
// bk, bn, K and N are multiples of 16 bytes' worth of elements and a, b
// are 16-byte aligned.
extern "C" int sfc_matmul_cached_launch(const void* a, const void* b,
                                        const void* sched, void* out,
                                        void* counts, int M, int N, int K,
                                        int bm, int bn, int bk, int nslots,
                                        int in_dt, int out_dt, int vec,
                                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      nslots <= 0 || M % bm != 0 || N % bn != 0 || K % bk != 0 ||
      bm * bn > kMaxThreads * kMaxAcc || sched == nullptr ||
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
