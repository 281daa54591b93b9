// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_attention_pallas
// (the TPU Pallas kernel _paged_attn_kernel).
//
//   For slot b and logical page p the kernel reads physical pool row
//   phys_tables[b, p] and skips pages with p * page_size > pos[b]; within
//   a page it masks positions t > pos[b] with -1e30.  Per query head it
//   keeps an f32 online softmax (running max m, denominator l and the
//   unnormalised output acc) and writes acc / l cast to the value dtype.
//   The pool's last row is the reserved zero row: unallocated table
//   entries point at it and take part in the softmax with zero scores,
//   exactly as never-written rows of a contiguous cache would.
//
// What bounds it on the H100: bytes.  Per step it reads each visited
// K/V page once (page_size x d_head values per kv-head) and does ~4
// FLOP per value read, far below the card's ~295 FLOP/byte balance
// point.  At the serving path's shapes (4 slots, 8 kv-heads, d_head 128,
// 16-token pages, <= 48 live tokens) that is ~100-200 KB per layer, so
// the launch itself dominates.
//
// What the design does about it: one block per (slot, kv-head), so the
// query heads of a GQA group share every K/V load; lanes walk d_head
// contiguously (coalesced 32-wide loads) and a warp reduces each
// (head, token) score by shuffles.  Page sizes 4/8/16 are below any MMA
// tile, so scores and P.V are FMA loops.  Head counts come from the
// operands, never from a model config.
#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::kBF16;
using repro_torch::kF32;
using repro_torch::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages, const int* __restrict__ tables,
                  const int* __restrict__ pos, T* __restrict__ out, int H,
                  int hkv, int dh, int ps, int max_pages, float scale) {
  extern __shared__ float sm[];
  const int G = H / hkv;
  float* qs = sm;               // G x dh, the group's queries in f32
  float* acc = qs + G * dh;     // G x dh, unnormalised output
  float* sc = acc + G * dh;     // G x ps, scores then probabilities
  float* m = sc + G * ps;       // G, running max
  float* l = m + G;             // G, running denominator
  float* alpha = l + G;         // G, this page's rescale factor

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int last = pos[b];
  const long q0 = (static_cast<long>(b) * H + static_cast<long>(h) * G) * dh;

  for (int e = tid; e < G * dh; e += kThreads) {
    qs[e] = to_f32(q[q0 + e]);
    acc[e] = 0.0f;
  }
  if (tid < G) {
    m[tid] = -1e30f;
    l[tid] = 0.0f;
  }
  __syncthreads();

  const long tok_stride = static_cast<long>(hkv) * dh;
  for (int p = 0; p < max_pages && p * ps <= last; ++p) {
    const long row = tables[static_cast<long>(b) * max_pages + p];
    const long base = (row * ps * hkv + h) * static_cast<long>(dh);
    const T* kb = k_pages + base;
    const T* vb = v_pages + base;
    // scores: one warp per (query head, token) pair
    for (int pair = warp; pair < G * ps; pair += kWarps) {
      const int g = pair / ps;
      const int t = pair - g * ps;
      const T* kr = kb + t * tok_stride;
      float s = 0.0f;
      for (int d = lane; d < dh; d += 32) s = fmaf(qs[g * dh + d], to_f32(kr[d]), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) sc[pair] = (p * ps + t <= last) ? s * scale : -1e30f;
    }
    __syncthreads();
    // online softmax update, one thread per query head
    if (tid < G) {
      float* sg = sc + tid * ps;
      float mc = sg[0];
      for (int t = 1; t < ps; ++t) mc = fmaxf(mc, sg[t]);
      const float mn = fmaxf(m[tid], mc);
      const float a = expf(m[tid] - mn);
      float sum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const float e = expf(sg[t] - mn);
        sg[t] = e;
        sum += e;
      }
      m[tid] = mn;
      l[tid] = a * l[tid] + sum;
      alpha[tid] = a;
    }
    __syncthreads();
    // acc = acc * alpha + P.V, each thread on its own (head, d) entries
    for (int e = tid; e < G * dh; e += kThreads) {
      const int g = e / dh;
      const int d = e - g * dh;
      const float* pg = sc + g * ps;
      float pv = 0.0f;
      for (int t = 0; t < ps; ++t) pv = fmaf(pg[t], to_f32(vb[t * tok_stride + d]), pv);
      acc[e] = acc[e] * alpha[g] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * dh; e += kThreads) {
    out[q0 + e] = from_f32<T>(acc[e] / l[e / dh]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* pos, void* out, int B, int H,
                   int hkv, int dh, int ps, int max_pages, float scale,
                   cudaStream_t stream) {
  const int G = H / hkv;
  const size_t smem = sizeof(float) * (2 * G * dh + G * ps + 3 * G);
  // ~2 KB at the serving shapes: raise the limit only past the 48 KB
  // default, so the common launch makes no extra CUDA API call.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_attn_kernel<T><<<B * hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, pos, static_cast<T*>(out), H, hkv,
      dh, ps, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry bound by ctypes (kernels/paged_attention.py).  Returns a
// cudaError_t.  q, k/v pages and out share the dtype ``dt``; tables is
// (B, max_pages) int32 and pos (B,) int32, both on the device; scale is
// 1/sqrt(dh) rounded once to f32, as the reference kernel applies it.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* pos, void* out, int B, int H,
                                      int hkv, int dh, int ps, int max_pages,
                                      float scale, int dt, void* stream) {
  if (B <= 0 || hkv <= 0 || H % hkv != 0 || dh <= 0 || ps <= 0 ||
      max_pages <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* tab = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dt == kF32) {
    err = launch<float>(q, k_pages, v_pages, tab, p, out, B, H, hkv, dh, ps,
                        max_pages, scale, st);
  } else if (dt == kBF16) {
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, tab, p, out, B, H, hkv, dh,
                                ps, max_pages, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
