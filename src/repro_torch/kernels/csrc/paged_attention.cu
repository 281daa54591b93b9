// One-token GQA decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_attention_pallas
// (the TPU Pallas kernel _paged_attn_kernel).
//
//   For slot b and logical page p the kernel reads physical pool row
//   phys_tables[b, p] and skips pages with p * page_size > pos[b]; within
//   a page it masks positions t > pos[b] (weight 0, as the reference's
//   -1e30 score gives).  Per query head it keeps an f32 online softmax
//   (running max m, denominator l and the unnormalised output acc) and
//   writes acc / l cast to the value dtype.  The pool's last row is the
//   reserved zero row: unallocated table entries point at it and take
//   part in the softmax with zero scores, exactly as never-written rows of
//   a contiguous cache would.  A position past the table reads every page.
//
// What bounds it on the H100: bytes.  Each live K/V page is read once
// (page_size x d_head values per kv-head, twice) for ~4 FLOP per value,
// far below the card's ~295 FLOP/byte balance point.  At qwen3-1.7b
// widths, 4 slots and 32,768 tokens, one launch reads 537 MB (0.160 ms at
// 3.35 TB/s); at the serving path's <= 48 live tokens it reads ~0.2 MB and
// the chain of dependent loads (position, table, page, merge) is the time.
//
// What the design does about it:
//
//  * Fill the card.  Each (slot, kv-head, head chunk) is a thread-block
//    cluster of `split` blocks (1, 2, 4 or 8, from the host's
//    kernels/paged_attention.py::attn_split_plan).  Each rank takes a
//    contiguous share of the slot's live pages, worked out here from
//    pos[b]: live = min(pos // ps + 1, max_pages) and rank r takes
//    [r * live / split, (r + 1) * live / split).  No host sync, and ragged
//    per-slot positions balance themselves; a rank with no page keeps
//    m = -1e30, l = 0, acc = 0.
//  * Keep bytes in flight without threads.  A block stages its table
//    entries in shared memory up front (the whole row when it has <= kTab
//    entries, so that load does not wait for pos).  Thread 0 then copies
//    each page's K and V rows of the block's kv-head with one TMA box each
//    (cp.async.bulk.tensor.3d over the pool seen as (dh, hkv, rows * ps)),
//    `stage_pages` pages (~32 KB) to a stage, into a ring of kStages
//    stages; a stage completes on its mbarrier by complete_tx.  One stage
//    lands while the other is computed; one block barrier per stage frees
//    the slot for the next copy.  (On the H100, 16-byte cp.async from every
//    thread, a deeper ring of smaller stages, a producer warp with
//    empty/full barriers in place of the block barrier, and TMA prefetches
//    of later stages into L2 were each measured no faster.)
//  * Compute from shared memory.  The G query heads of a GQA group (up to
//    4 per block; larger groups are split into chunks of 4, each chunk a
//    cluster of its own) share every K/V row.  A block's 128 threads form
//    token groups of 8 lanes (16 for d_head > 128); a lane holds 16
//    d_head values of a row in 16-byte chunks, so a token's dot product is
//    16 FMAs a lane and log2(8) xor shuffles.  A group takes kJ tokens at
//    once (independent loads, FMAs and shuffles) and keeps its own online
//    softmax in registers (scores in the log2 domain, exp2), rescaling
//    only when the max grows; P.V accumulates in the same registers.
//  * Merge in a fixed order.  The block's token groups are merged in
//    group order in shared memory; then each rank leaves (m, l, acc)
//    there, and after a cluster barrier rank r reads ranks 0..split-1
//    over distributed shared memory in rank order for its 1/split share
//    of the (head, d) outputs, rescales, sums, divides and stores.  A
//    second cluster barrier keeps the peers' shared memory alive until
//    every rank has read it.  Every sum has a fixed order: the result is
//    identical run to run, with no atomics.
//  * Shapes TMA cannot take (d_head * sizeof(T) not a multiple of 16, a
//    page slot not a multiple of 128 bytes, or operands not 16-byte
//    aligned) take the same kernel with plain loads and stores by every
//    thread (kVec false).  Head counts come from the operands.
//  * A sliding window of W keys (one per launch: a model's window layers)
//    is the overload of paged_attn_kernel that takes `window` (kWin):
//    slot b's live pages start at its first page inside the window,
//    max(0, pos[b] - W + 1) / ps, so the ranks share only those, and the
//    keys of that page below the window are masked like those past pos.
//    Both kernels inline one body; the one without a window compiles to
//    the code it had before windows existed.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using repro_torch::from_f32;
using repro_torch::kBF16;
using repro_torch::kF32;
using repro_torch::mbar_arrive_expect;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;
using repro_torch::smem_u32;

constexpr int kThreads = 128;
constexpr int kStages = 2;    // ring depth: one stage lands while one is computed
constexpr int kTab = 1024;    // table entries staged in shared memory at once
constexpr int kMaxSplit = 8;  // portable cluster size
constexpr int kMaxDh = 256;   // 16 lanes of 16 values hold a row
constexpr int kSmemMax = 232448;  // bytes of shared memory one block may use
constexpr float kNeg = -1e30f;

// the (dh, 1, ps) box at (0, head, token row) of ``map``'s (dh, hkv,
// rows * ps) pool into shared memory at ``dst`` (128-byte aligned);
// completes on ``bar`` by complete_tx
__device__ __forceinline__ void tma_page(void* dst, const CUtensorMap* map,
                                         int head, int row0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(head), "r"(row0),
      "r"(smem_u32(bar))
      : "memory");
}

// Lanes of a token group hold a row's d_head values in 16-byte chunks:
// lane li of a group of kLpt lanes holds chunk k (k < kNv / C, C = 16 /
// sizeof(T) elements) at d = k * kLpt * C + li * C, so the group's lanes
// read a row as contiguous 16-byte pieces (no bank conflict).  A lane
// keeps its values raw (kWords 32-bit words) and widens each to f32 where
// it is used.  Values past dh are zero.  kVec: the row is 16-byte aligned
// and dh a multiple of C, so a chunk is all in or all out and is one
// 16-byte load.
constexpr int kNv = 16;  // d_head values a lane holds

template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {  // bf16: the value's bits are the high half of an f32
    return __uint_as_float((e & 1) ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
}

template <typename T, int kLpt, bool kVec>
__device__ __forceinline__ void load_raw(const T* row, int li, int dh,
                                         uint32_t (&w)[kNv * sizeof(T) / 4]) {
  constexpr int C = 16 / sizeof(T);
  constexpr int kW = 4;  // words per chunk
#pragma unroll
  for (int k = 0; k < kNv / C; ++k) {
    const int d = k * kLpt * C + li * C;
    if constexpr (kVec) {
      const uint4 u = d < dh ? *reinterpret_cast<const uint4*>(row + d)
                             : make_uint4(0u, 0u, 0u, 0u);
      w[k * kW] = u.x; w[k * kW + 1] = u.y; w[k * kW + 2] = u.z; w[k * kW + 3] = u.w;
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) w[k * kW + i] = 0u;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (d + i >= dh) continue;
        if constexpr (sizeof(T) == 4) {
          w[k * kW + i] = __float_as_uint(row[d + i]);
        } else {
          w[k * kW + i / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(row[d + i]))
                               << (16 * (i & 1));
        }
      }
    }
  }
}

// Query heads per block for a GQA group of G heads (the host's
// _group_width): 1, 2, or chunks of 4 (a last chunk of fewer is masked).
__host__ __device__ __forceinline__ int group_width(int G) {
  return G <= 2 ? G : 4;
}
// Lanes per token group (the host's _lanes): 8 for d_head <= 128, else 16.
__host__ __device__ __forceinline__ int lanes_per_token(int dh) {
  return dh <= 8 * kNv ? 8 : 16;
}

// Shared memory of one block (the host's attn_smem_bytes): the ring, or,
// after the loop, the merge buffers in the same bytes; then the table.
__host__ __device__ __forceinline__ size_t ring_bytes(int dh, int ps,
                                                      int stage_pages, int es) {
  return static_cast<size_t>(kStages) * 2 * stage_pages * ps * dh * es;
}
__host__ __device__ __forceinline__ size_t merge_bytes(int gw, int dh) {
  const size_t groups = kThreads / lanes_per_token(dh);
  return sizeof(float) * ((groups + 1) * gw * dh + 2 * (groups + 1) * gw);
}
__host__ __device__ __forceinline__ size_t area_bytes(int gw, int dh, int ps,
                                                      int stage_pages, int es) {
  const size_t a = ring_bytes(dh, ps, stage_pages, es);
  const size_t m = merge_bytes(gw, dh);
  return ((a > m ? a : m) + 15) / 16 * 16;
}

// grid: B * hkv * chunks * split blocks, clusters of `split` along x;
// kWin: keys at positions <= pos[b] - window are not attended
template <typename T, int GW, int kLpt, bool kVec, bool kWin>
__device__ __forceinline__ void
attn_body(const T* __restrict__ q, const T* __restrict__ k_pages,
          const T* __restrict__ v_pages, const CUtensorMap& map_k,
          const CUtensorMap& map_v, const int* __restrict__ tables,
          const int* __restrict__ pos, T* __restrict__ out, int H, int hkv,
          int dh, int ps, int max_pages, int split, int stage_pages,
          float scale_log2, int window) {
  constexpr int kGroups = kThreads / kLpt;  // token groups of a block
  constexpr int C = 16 / sizeof(T);
  constexpr int kWords = kNv * sizeof(T) / 4;
  constexpr int kJ = GW <= 2 ? 4 : 2;  // tokens a group takes at once
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = H / hkv;
  const int chunks = (G + GW - 1) / GW;
  const int rank = blockIdx.x % split;
  int unit = blockIdx.x / split;
  const int c = unit % chunks;
  unit /= chunks;
  const int h = unit % hkv;
  const int b = unit / hkv;
  const int tid = threadIdx.x;
  const int grp = tid / kLpt;
  const int li = tid % kLpt;
  const int T_tok = stage_pages * ps;  // token rows of one stage
  T* ring = reinterpret_cast<T*>(smem);
  int* tab_s = reinterpret_cast<int*>(
      smem + area_bytes(GW, dh, ps, stage_pages, sizeof(T)));
  uint64_t* full = reinterpret_cast<uint64_t*>(tab_s + kTab);  // [kStages]
  if constexpr (kVec) {
    if ((smem_u32(smem) & 127u) != 0) __trap();  // TMA writes 128-byte aligned
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // table entries, the slot's position and the queries, all in flight
  // together: a short row is staged whole, without waiting for pos
  const int* trow = tables + static_cast<long>(b) * max_pages;
  const bool whole = max_pages <= kTab;
  if (whole)
    for (int e = tid; e < max_pages; e += kThreads) tab_s[e] = trow[e];
  const int last = pos[b];
  float qr[GW][kNv];
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    uint32_t w[kWords];
    if (c * GW + g < G) {
      load_raw<T, kLpt, kVec>(q + (static_cast<long>(b) * H + h * G + c * GW + g) * dh,
                              li, dh, w);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = 0u;
    }
#pragma unroll
    for (int e = 0; e < kNv; ++e) qr[g][e] = elem<T>(w, e);
  }
  const int live = last < 0 ? 0 : min(last / ps + 1, max_pages);
  int lo, hi;
  long wlo = 0;  // the window's first position (kWin)
  if constexpr (kWin) {
    wlo = static_cast<long>(last) - window + 1;
    const int first = wlo > 0 ? min(static_cast<int>(wlo / ps), live) : 0;
    lo = first + static_cast<int>(static_cast<long>(rank) * (live - first) / split);
    hi = first + static_cast<int>(static_cast<long>(rank + 1) * (live - first) / split);
  } else {
    lo = static_cast<int>(static_cast<long>(rank) * live / split);
    hi = static_cast<int>(static_cast<long>(rank + 1) * live / split);
  }
  int tab_base = whole ? 0 : lo;
  if (!whole)
    for (int e = tid; e < min(kTab, hi - lo); e += kThreads) tab_s[e] = trow[lo + e];
  __syncthreads();

  const long tok_stride = static_cast<long>(hkv) * dh;  // between a page's tokens
  const long page_stride = ps * tok_stride;
  const int n_stages = (hi - lo + stage_pages - 1) / stage_pages;
  // copies of stage st (pages lo + st * stage_pages ...) into ring slot
  // st % kStages, called by every thread: kVec, one TMA box per page for
  // K and for V from thread 0, landing on full[slot]; else plain loads
  // and stores by every thread
  auto issue = [&](int st) {
    if (st >= n_stages) return;
    const int p0 = lo + st * stage_pages;
    if (min(p0 + stage_pages, hi) > tab_base + kTab) {
      // never for a whole row, nor in the prologue (stage_pages <= 64
      // divides kTab); every earlier reader of tab_s is behind the
      // caller's barrier
      tab_base = p0;
      for (int e = tid; e < min(kTab, hi - p0); e += kThreads)
        tab_s[e] = trow[p0 + e];
      __syncthreads();
    }
    const int np = min(stage_pages, hi - p0);
    T* stage = ring + static_cast<size_t>(st % kStages) * 2 * T_tok * dh;
    if constexpr (kVec) {
      if (tid == 0) {
        uint64_t* bar = &full[st % kStages];
        mbar_arrive_expect(bar, static_cast<uint32_t>(2 * np * ps * dh * sizeof(T)));
        for (int pi = 0; pi < np; ++pi) {
          const int row0 = tab_s[p0 + pi - tab_base] * ps;
          T* dk = stage + static_cast<size_t>(pi) * ps * dh;
          tma_page(dk, &map_k, h, row0, bar);
          tma_page(dk + static_cast<size_t>(T_tok) * dh, &map_v, h, row0, bar);
        }
      }
    } else {
      for (int pp = tid; pp < ps * dh; pp += kThreads) {
        const int t = pp / dh;
        const int d = pp - t * dh;
        const long src = t * tok_stride + static_cast<long>(h) * dh + d;
        for (int pi = 0; pi < np; ++pi) {
          const long at = tab_s[p0 + pi - tab_base] * page_stride + src;
          T* dk = stage + static_cast<size_t>(pi * ps + t) * dh + d;
          dk[0] = k_pages[at];
          dk[static_cast<size_t>(T_tok) * dh] = v_pages[at];
        }
      }
    }
  };

  // each token group's own online softmax over its tokens, in the log2
  // domain (scores times scale * log2(e)), in every lane of the group
  float m[GW], l[GW], acc[GW][kNv];
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kNv; ++e) acc[g][e] = 0.0f;
  }
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  const int tg = (T_tok + kGroups - 1) / kGroups;  // a group's tokens per stage
  const int j0 = grp * tg;
  for (int st = 0; st < n_stages; ++st) {
    if constexpr (kVec) mbar_wait(&full[st % kStages], (st / kStages) & 1);
    __syncthreads();  // stage st is in; slot (st - 1) % kStages is free
    issue(st + kStages - 1);
    const T* ks = ring + static_cast<size_t>(st % kStages) * 2 * T_tok * dh;
    const T* vs = ks + static_cast<size_t>(T_tok) * dh;
    // tokens [0, tend) of the stage count: inside the rank's pages and
    // at or before pos
    const long tok0 = static_cast<long>(lo + st * stage_pages) * ps;
    const long lim = static_cast<long>(hi) * ps < static_cast<long>(last) + 1
                         ? static_cast<long>(hi) * ps
                         : static_cast<long>(last) + 1;
    const int tend = lim - tok0 < T_tok ? static_cast<int>(lim - tok0) : T_tok;
    // kWin: the stage's tokens below tbeg are outside the window
    const int tbeg = kWin && wlo > tok0 ? static_cast<int>(wlo - tok0) : 0;
    // a group takes kJ tokens at once: their loads, dot products and
    // shuffles are independent, and one softmax update covers them.  Every
    // lane of a warp runs the same iterations (the shuffles need the whole
    // warp); a group's tokens past tend are computed on and dropped.
    for (int i0 = 0; i0 < tg; i0 += kJ) {
      const int jb = j0 + i0;
      const int nv = max(0, min(min(kJ, tg - i0), tend - jb));
      if (!__any_sync(0xffffffffu, nv > 0)) break;
      uint32_t w[kJ][kWords];
      float s[kJ][GW];
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        const int j = jb + u < T_tok ? jb + u : T_tok - 1;
        load_raw<T, kLpt, kVec>(ks + static_cast<size_t>(j) * dh, li, dh, w[u]);
      }
#pragma unroll
      for (int u = 0; u < kJ; ++u)
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
          for (int e = 0; e < kNv; e += 2) {
            d0 = fmaf(qr[g][e], elem<T>(w[u], e), d0);
            d1 = fmaf(qr[g][e + 1], elem<T>(w[u], e + 1), d1);
          }
          s[u][g] = d0 + d1;
        }
#pragma unroll
      for (int off = kLpt / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < kJ; ++u)
#pragma unroll
          for (int g = 0; g < GW; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        const int j = jb + u < T_tok ? jb + u : T_tok - 1;
        load_raw<T, kLpt, kVec>(vs + static_cast<size_t>(j) * dh, li, dh, w[u]);
      }
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        float mc = kNeg;
#pragma unroll
        for (int u = 0; u < kJ; ++u) {
          s[u][g] *= scale_log2;
          if (u < nv && (!kWin || jb + u >= tbeg)) mc = fmaxf(mc, s[u][g]);
        }
        if (mc > m[g]) {  // a new max: rescale (skipped, exactly, otherwise)
          const float a = exp2f(m[g] - mc);
          l[g] *= a;
#pragma unroll
          for (int e = 0; e < kNv; ++e) acc[g][e] *= a;
          m[g] = mc;
        }
#pragma unroll
        for (int u = 0; u < kJ; ++u) {
          s[u][g] = u < nv && (!kWin || jb + u >= tbeg) ? exp2f(s[u][g] - m[g]) : 0.0f;
          l[g] += s[u][g];
        }
      }
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        if (u >= nv) continue;  // its row may hold anything (a token below
                                // the window has weight 0 and a real row)
#pragma unroll
        for (int g = 0; g < GW; ++g)
#pragma unroll
          for (int e = 0; e < kNv; ++e)
            acc[g][e] = fmaf(s[u][g], elem<T>(w[u], e), acc[g][e]);
      }
    }
  }
  __syncthreads();  // the ring is free: the merge buffers take its bytes

  float* acc_w = reinterpret_cast<float*>(smem);  // [kGroups][GW][dh]
  float* m_w = acc_w + kGroups * GW * dh;         // [kGroups][GW]
  float* l_w = m_w + kGroups * GW;
  float* racc = l_w + kGroups * GW;               // [GW][dh], the rank's
  float* rm = racc + GW * dh;                     // [GW]
  float* rl = rm + GW;
#pragma unroll
  for (int g = 0; g < GW; ++g) {
#pragma unroll
    for (int k = 0; k < kNv / C; ++k)
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int d = k * kLpt * C + li * C + i;
        if (d < dh) acc_w[(grp * GW + g) * dh + d] = acc[g][k * C + i];
      }
    if (li == 0) {
      m_w[grp * GW + g] = m[g];
      l_w[grp * GW + g] = l[g];
    }
  }
  __syncthreads();
  // the block's token groups in group order
  for (int e = tid; e < GW * dh; e += kThreads) {
    const int g = e / dh;
    float M = m_w[g];
    for (int w = 1; w < kGroups; ++w) M = fmaxf(M, m_w[w * GW + g]);
    float L = 0.0f, A = 0.0f;
    for (int w = 0; w < kGroups; ++w) {
      const float f = exp2f(m_w[w * GW + g] - M);
      L += l_w[w * GW + g] * f;
      A += acc_w[w * GW * dh + e] * f;
    }
    if (split == 1) {
      if (c * GW + g < G)
        out[(static_cast<long>(b) * H + h * G + c * GW + g) * dh + e - g * dh] =
            from_f32<T>(A / L);
    } else {
      racc[e] = A;
      if (e == g * dh) {
        rm[g] = M;
        rl[g] = L;
      }
    }
  }
  if (split > 1) {
    // the cluster's ranks in rank order; rank r finishes entries
    // [r * per, (r + 1) * per) of the GW x dh outputs.  The loops run to
    // kMaxSplit so that a thread's remote loads are all in flight at once.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's (m, l, acc) is in its shared memory
    const int per = (GW * dh + split - 1) / split;
    const int e1 = min(GW * dh, (rank + 1) * per);
    for (int e = rank * per + tid; e < e1; e += kThreads) {
      const int g = e / dh;
      float mr[kMaxSplit], lr[kMaxSplit], ar[kMaxSplit];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r) {
        if (r < split) {
          mr[r] = cluster.map_shared_rank(rm, r)[g];
          lr[r] = cluster.map_shared_rank(rl, r)[g];
          ar[r] = cluster.map_shared_rank(racc, r)[e];
        }
      }
      float M = mr[0];
#pragma unroll
      for (int r = 1; r < kMaxSplit; ++r)
        if (r < split) M = fmaxf(M, mr[r]);
      float L = 0.0f, A = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r) {
        if (r < split) {
          const float f = exp2f(mr[r] - M);
          L += lr[r] * f;
          A += ar[r] * f;
        }
      }
      if (c * GW + g < G)
        out[(static_cast<long>(b) * H + h * G + c * GW + g) * dh + e - g * dh] =
            from_f32<T>(A / L);
    }
    cluster.sync();  // peers' shared memory stays until every rank has read it
  }
}

template <typename T, int GW, int kLpt, bool kVec>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const int* __restrict__ tables, const int* __restrict__ pos,
                  T* __restrict__ out, int H, int hkv, int dh, int ps,
                  int max_pages, int split, int stage_pages, float scale_log2) {
  attn_body<T, GW, kLpt, kVec, false>(q, k_pages, v_pages, map_k, map_v, tables, pos, out,
                                      H, hkv, dh, ps, max_pages, split, stage_pages,
                                      scale_log2, 0);
}

// the same with a sliding window of `window` keys
template <typename T, int GW, int kLpt, bool kVec, bool kWin>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const int* __restrict__ tables, const int* __restrict__ pos,
                  T* __restrict__ out, int H, int hkv, int dh, int ps,
                  int max_pages, int split, int stage_pages, float scale_log2,
                  int window) {
  static_assert(kWin, "the windowed overload");
  attn_body<T, GW, kLpt, kVec, true>(q, k_pages, v_pages, map_k, map_v, tables, pos, out,
                                     H, hkv, dh, ps, max_pages, split, stage_pages,
                                     scale_log2, window);
}

// the map of a (rows, ps, hkv, dh) pool seen as (dh, hkv, rows * ps), read
// in (dh, 1, ps) boxes: one kv-head of one page
template <typename T>
bool pool_map(CUtensorMap* map, const void* pool, int rows, int ps, int hkv,
              int dh) {
  const auto encode = repro_torch::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(rows) * ps};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * sizeof(T),
                                 static_cast<cuuint64_t>(hkv) * dh * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(dh), 1,
                             static_cast<cuuint32_t>(ps)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(pool), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k_pages, *v_pages;
  const int *tables, *pos;
  void* out;
  int B, H, hkv, dh, ps, max_pages, rows, split, stage_pages;
  float scale;
  cudaStream_t stream;
  int window;  // 0: none
};

template <typename T, int GW, int kLpt, bool kVec, bool kWin>
cudaError_t launch_k(const Args& a) {
  void (*kernel)(const T*, const T*, const T*, const CUtensorMap, const CUtensorMap,
                 const int*, const int*, T*, int, int, int, int, int, int, int,
                 float) = nullptr;
  void (*kernel_w)(const T*, const T*, const T*, const CUtensorMap, const CUtensorMap,
                   const int*, const int*, T*, int, int, int, int, int, int, int, float,
                   int) = nullptr;
  const void* fn;
  if constexpr (kWin) {
    kernel_w = paged_attn_kernel<T, GW, kLpt, kVec, true>;
    fn = reinterpret_cast<const void*>(kernel_w);
  } else {
    kernel = paged_attn_kernel<T, GW, kLpt, kVec>;
    fn = reinterpret_cast<const void*>(kernel);
  }
  const size_t smem = area_bytes(GW, a.dh, a.ps, a.stage_pages, sizeof(T)) +
                      sizeof(int) * kTab + sizeof(uint64_t) * kStages;
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  CUtensorMap map_k{}, map_v{};
  if (kVec && !(pool_map<T>(&map_k, a.k_pages, a.rows, a.ps, a.hkv, a.dh) &&
                pool_map<T>(&map_v, a.v_pages, a.rows, a.ps, a.hkv, a.dh))) {
    return cudaErrorInvalidValue;
  }
  // raise the dynamic limit once per kernel, and only past the default
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const int G = a.H / a.hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.hkv * ((G + GW - 1) / GW) * a.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  cudaError_t err;
  if constexpr (kWin) {
    err = cudaLaunchKernelEx(
        &cfg, kernel_w, static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
        static_cast<const T*>(a.v_pages), map_k, map_v, a.tables, a.pos,
        static_cast<T*>(a.out), a.H, a.hkv, a.dh, a.ps, a.max_pages, a.split,
        a.stage_pages, a.scale * 1.4426950408889634f, a.window);
  } else {
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
        static_cast<const T*>(a.v_pages), map_k, map_v, a.tables, a.pos,
        static_cast<T*>(a.out), a.H, a.hkv, a.dh, a.ps, a.max_pages, a.split,
        a.stage_pages, a.scale * 1.4426950408889634f);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int GW, int kLpt>
cudaError_t launch_lpt(const Args& a, bool vec) {
  if (a.window > 0)
    return vec ? launch_k<T, GW, kLpt, true, true>(a) : launch_k<T, GW, kLpt, false, true>(a);
  return vec ? launch_k<T, GW, kLpt, true, false>(a) : launch_k<T, GW, kLpt, false, false>(a);
}

template <typename T, int GW>
cudaError_t launch_gw(const Args& a, bool vec) {
  if (lanes_per_token(a.dh) == 8) return launch_lpt<T, GW, 8>(a, vec);
  return launch_lpt<T, GW, 16>(a, vec);
}

template <typename T>
cudaError_t launch(const Args& a, bool vec) {
  switch (group_width(a.H / a.hkv)) {
    case 1:
      return launch_gw<T, 1>(a, vec);
    case 2:
      return launch_gw<T, 2>(a, vec);
    default:
      return launch_gw<T, 4>(a, vec);
  }
}

}  // namespace

// C entry bound by ctypes (kernels/paged_attention.py).  Returns a
// cudaError_t.  q, k/v pages and out share the dtype ``dt``; the pools
// are (rows, ps, hkv, dh); tables is (B, max_pages) int32 and pos (B,)
// int32, both on the device; scale is 1/sqrt(dh) rounded once to f32, as
// the reference kernel applies it.  ``split`` is the cluster size (1, 2,
// 4 or 8), ``stage_pages`` the pages of one ring stage (1..64, a power of
// two), and ``vec`` whether pages go by TMA (dh * sizeof(T) a multiple
// of 16, ps * dh * sizeof(T) of 128, ps <= 256, q, the pools and out
// 16-byte aligned); otherwise plain loads.  d_head is at most 256.
// ``window`` > 0 attends only the keys at positions > pos[b] - window (0:
// every key up to pos[b]).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* pos, void* out, int B, int H,
                                      int hkv, int dh, int ps, int max_pages,
                                      int rows, float scale, int dt, int split,
                                      int stage_pages, int vec, int window,
                                      void* stream) {
  if (B <= 0 || hkv <= 0 || H % hkv != 0 || dh <= 0 || dh > kMaxDh || window < 0 ||
      ps <= 0 || max_pages <= 0 || rows <= 0 ||
      (split != 1 && split != 2 && split != 4 && split != 8) ||
      stage_pages <= 0 || stage_pages > 64 ||
      (stage_pages & (stage_pages - 1)) != 0 || (vec && ps > 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, v_pages, static_cast<const int*>(tables),
               static_cast<const int*>(pos), out, B, H, hkv, dh, ps, max_pages,
               rows, split, stage_pages, scale, static_cast<cudaStream_t>(stream),
               window};
  cudaError_t err;
  if (dt == kF32) {
    err = launch<float>(a, vec != 0);
  } else if (dt == kBF16) {
    err = launch<__nv_bfloat16>(a, vec != 0);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
