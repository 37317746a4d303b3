// One-token decode attention over a paged KV cache, for Hopper (sm_90a):
// K15 (d-major k pages, GQA), K14 (token-major pages, a bulk-copy ring)
// and K16 (K14's function over a two-stage cp.async ring).
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/decode_attention.py::_paged_decode_mxu_kernel (K15)
//   paddle_tpu/ops/pallas/decode_attention.py::_paged_decode_kernel     (K14)
//   paddle_tpu/ops/pallas/decode_attention.py::_paged_decode_dma_kernel (K16)
// q [B, nq, d] (one token per sequence, in the page dtype), block_table
// [B, mb] int32 (the physical page of each logical block), seq_lens [B]
// int32; o [B, nq, d]. Per page of a sequence, in table order:
// s = (q k^T) * scale in fp32, + -1e30 at positions >= seq_len, the online
// softmax m' = max(m, max s), p = exp(s - m'), alpha = exp(m - m'),
// l = l alpha + sum p, acc = acc alpha + p v; o = acc / max(l, 1e-30).
//
// K15: k pages d-major [P, nkv, d, bs], v pages token-major [P, nkv, bs, d];
// the G = nq / nkv query heads of a kv head are served together (no
// repeated cache), and p is rounded to the page dtype before the value
// product (the TPU kernel's cast point), while l sums the unrounded p.
// K14, K16: k and v pages token-major [P, nh, bs, d] with nh == nq, every
// product in fp32 (the TPU kernels' mul-reduce), p not rounded.
//
// Reading fewer pages. The TPU kernels visit all mb pages of a sequence.
// A page past ceil(seq_len / bs) adds p = 0 with alpha = 1, which changes
// nothing for finite pages, so these kernels stop there. A sequence of
// length 0 is the exception: every score is -1e30 + s = -1e30, p = 1
// throughout, and the output is the mean of the v rows of all mb pages; so
// for it every page is read.
//
// Design. The TPU grid walks (sequence, page group) in order, all heads of
// a page vectorised in one program. Here one block owns one (kv head,
// sequence) and walks its pages in table order with the online state in
// shared memory and registers; a sequence is never split across blocks
// (a split-K combine would change the softmax's sums). All three kernels
// keep pages flowing into shared memory while they compute:
// - K15 (paged_mxu_kernel, 4 computing warps + 1 producer warp): one
//   kv head's d-major k page is d * bs contiguous values, a run of d-rows
//   of it one contiguous run, and so is a run of tokens of its v page.
//   One producer thread issues a 1-D bulk copy (cp.async.bulk, completing
//   on an mbarrier: no tensor map) per stage into a ring of 2-16 slots
//   and runs ahead across pages: a page's k stages (64 d-rows of 128
//   tokens at bf16 and llama2-7b's page), then its v stages (64 tokens),
//   at most 16 KB each, the ring as deep as leaves two blocks on an SM
//   (decode_attention.py::paged_mxu_plan: 6 slots, ~96 KB in flight a
//   block). The scores: a thread per token, the loop over d, the partial
//   dot products carried from one k stage to the next; the values: a
//   thread per element of d, the loop over tokens, carried likewise;
//   fp32 FMAs, never TF32, G query heads up to eight at a time (a pass of
//   1, 2, 4 or 8, the launcher's choice by G). Each sum runs in the order
//   of a walk over the whole page, so the ring changes no bit of the
//   output.
// K14 and K16 share one per-page function (score_rows, page_softmax,
// value_rows): a warp per token for the scores, one warp for the page's
// max and sum, a thread per element of d for the values, each sum in a
// fixed order that does not depend on how the rows are tiled. They
// differ in how rows reach shared memory:
// - K14 (paged_ring_kernel, K15's warps and ring): in the token-major
//   pages one head's page is bs * d contiguous values, so a tile of its
//   rows is one contiguous run, copied into a ring of 3-16 stages of 64,
//   32, 16 or 8 rows (at most 16 KB; decode_attention.py::
//   paged_ring_geometry): at llama2-7b's width 6 stages of 64 rows, for
//   the grid of nh x B = 256 blocks over 132 SMs in one wave.
// - K16 (paged_dma_kernel, 128 threads): tiles of 32 (or 16, 8) rows that
//   every thread copies with cp.async into a two-stage ring, the next
//   tile's copy in flight while this one computes.
// The TPU's DMA variant copies groups of gk whole pages of all heads (gk =
// _paged_pages_per_program); at llama2-7b's width a page of all heads is
// 1 MiB, beyond the 227 KB of a block's shared memory, so the unit here
// is a tile of one head's page. Since both kernels run the same function
// on the same rows in the same order, K14 gives K16's bits.
//
// Bound on the H100: bytes. A decode step reads the valid tokens' k and v,
// 2 * seq_len * nkv * d values per sequence, and does 4 * nq * seq_len * d
// flop: G flop per byte in bf16 (4 at llama3-8b), far under the ~295 the
// tensor cores need. At llama2-7b (B 8, 32 heads of 128, bf16) with 1088
// tokens a sequence that is 143 MB per layer, 0.043 ms at 3.35 TB/s. What
// decides the time is the bytes in flight: K16 keeps one tile in flight a
// block; the rings of K15 and K14 up to a page and a half (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGc = 8;              // K15: query heads per pass
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Pages of a sequence the kernels read (see "Reading fewer pages").
__device__ __forceinline__ int pages_to_read(int seq_len, int bs, int mb) {
  return seq_len > 0 ? min((seq_len + bs - 1) / bs, mb) : mb;
}

// ---- K15: d-major k pages, GQA, over a ring of 1-D bulk copies ----------
//
// Warps 0-3 compute; warp 4 is the producer, one thread of which issues
// the copies (as K14's). A page's stages in the order the producer issues
// them: its k stages (k_rows d-rows of bs tokens each, a contiguous run of
// the d-major page), then its v stages (v_rows tokens of d values each).
// Every sum keeps the order of a walk over the whole page: a score sums
// over dd = 0..D-1 and a value sum over the page's tokens in order, the
// partial carried from one stage to the next through shared memory (each
// partial is written and read again by the same thread).

// s[g][t] for this stage's rows dd0 .. dd0 + n - 1 (rows [n][bs]): a
// thread per token, HC query heads at a time; on the page's last k stage
// the score is scaled and masked.
template <typename T, int D, int HC>
__device__ __forceinline__ void mxu_score_stage(const float* q_s,
                                                const T* rows, int n,
                                                int dd0, int bs, int G,
                                                bool first, bool last,
                                                int base, int seq_len,
                                                float scale, float* s_s) {
  for (int t = threadIdx.x; t < bs; t += kThreads) {
    const float mask = base + t < seq_len ? 0.f : kMaskFill;
    for (int g0 = 0; g0 < G; g0 += HC) {
      float s[HC];
#pragma unroll
      for (int c = 0; c < HC; ++c)
        s[c] = first || g0 + c >= G ? 0.f : s_s[(g0 + c) * bs + t];
#pragma unroll 8
      for (int r = 0; r < n; ++r) {
        const float kv = to_f(rows[(size_t)r * bs + t]);
#pragma unroll
        for (int c = 0; c < HC; ++c)
          if (g0 + c < G) s[c] = fmaf(q_s[(g0 + c) * D + dd0 + r], kv, s[c]);
      }
#pragma unroll
      for (int c = 0; c < HC; ++c)
        if (g0 + c < G) s_s[(g0 + c) * bs + t] = last ? s[c] * scale + mask
                                                       : s[c];
    }
  }
}

// The page's max and sum: a warp per query head; p in place, rounded to
// the page dtype before p v, while l sums the unrounded p.
template <typename T>
__device__ __forceinline__ void mxu_softmax(float* s_s, int bs, int G,
                                            float* m_s, float* l_s,
                                            float* a_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kWarps) {
    float* row = s_s + g * bs;
    float mx = kMaskFill;
    for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, row[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_prev = m_s[g];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < bs; t += 32) {
      const float p = expf(row[t] - m_new);
      sum += p;
      row[t] = round_to<T>(p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
  }
}

// pv[g][dd] over this stage's tokens t0 .. t0 + n - 1 (rows [n][D]): a
// thread per element of d, HC query heads at a time; on the page's last
// v stage acc = acc alpha + pv.
template <typename T, int D, int HC>
__device__ __forceinline__ void mxu_value_stage(const float* p_s,
                                                const T* rows, int n,
                                                int t0, int bs, int G,
                                                bool first, bool last,
                                                const float* a_s,
                                                float* pv_s, float* acc_s) {
  for (int dd = threadIdx.x; dd < D; dd += kThreads) {
    for (int g0 = 0; g0 < G; g0 += HC) {
      float pv[HC];
#pragma unroll
      for (int c = 0; c < HC; ++c)
        pv[c] = first || g0 + c >= G ? 0.f : pv_s[(g0 + c) * D + dd];
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float vv = to_f(rows[(size_t)t * D + dd]);
#pragma unroll
        for (int c = 0; c < HC; ++c)
          if (g0 + c < G)
            pv[c] = fmaf(p_s[(g0 + c) * bs + t0 + t], vv, pv[c]);
      }
#pragma unroll
      for (int c = 0; c < HC; ++c)
        if (g0 + c < G) {
          const int e = (g0 + c) * D + dd;
          if (last) acc_s[e] = acc_s[e] * a_s[g0 + c] + pv[c];
          else pv_s[e] = pv[c];
        }
    }
  }
}

constexpr int kRingThreads = kThreads + 32;   // + the producer warp
constexpr int kMaxStages = 16;

__device__ __forceinline__ void compute_sync() { named_barrier(1, kThreads); }

// smem: full[kMaxStages], empty[kMaxStages] (256 B), the ring: stages x
// slot T (from byte 256), then fp32 q [G][D], s [G][bs], pv [G][D],
// acc [G][D], m [G], l [G], alpha [G] (mxu_plan's layout).
template <typename T, int D, int HC>
__global__ void __launch_bounds__(kRingThreads)
paged_mxu_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                 const T* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ seq_lens, T* __restrict__ out,
                 int nkv, int G, int bs, int mb, int k_rows, int v_rows,
                 int stages, int slot, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  T* ring = reinterpret_cast<T*>(smem_raw + 256);
  float* q_s = reinterpret_cast<float*>(ring + (size_t)stages * slot);
  float* s_s = q_s + G * D;
  float* pv_s = s_s + G * bs;
  float* acc_s = pv_s + G * D;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nq = nkv * G;
  const int seq_len = seq_lens[b];
  const int n_pages = pages_to_read(seq_len, bs, mb);
  const int nk = D / k_rows, per_page = nk + bs / v_rows;
  const int n_stages = n_pages * per_page;
  if (tid < kThreads) {
    const T* qb = q + ((size_t)b * nq + (size_t)kh * G) * D;
    for (int e = tid; e < G * D; e += kThreads) {
      q_s[e] = to_f(qb[e]);
      acc_s[e] = 0.f;
    }
    for (int g = tid; g < G; g += kThreads) {
      m_s[g] = kMaskFill;
      l_s[g] = 0.f;
    }
  } else if (tid == kThreads) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kThreads) {                     // producer
    if (tid != kThreads) return;
    for (int i = 0; i < n_stages; ++i) {
      const int s = i % stages;
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      const int j = i / per_page, r = i % per_page;
      const size_t page = (size_t)table[(size_t)b * mb + j];
      const T* src;
      uint32_t bytes;
      if (r < nk) {                          // d-rows r * k_rows ..
        src = kt + ((page * nkv + kh) * D + (size_t)r * k_rows) * bs;
        bytes = (uint32_t)(k_rows * bs * sizeof(T));
      } else {                               // tokens (r - nk) * v_rows ..
        src = vp + ((page * nkv + kh) * bs + (size_t)(r - nk) * v_rows) * D;
        bytes = (uint32_t)(v_rows * D * sizeof(T));
      }
      mbar_expect_tx(&full[s], bytes);
      bulk_load(smem_u32(ring + (size_t)s * slot), src, bytes, &full[s]);
    }
    return;
  }

  const int lane = tid % 32;
  for (int i = 0; i < n_stages; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const int j = i / per_page, r = i % per_page;
    const T* rows = ring + (size_t)s * slot;
    if (r < nk) {
      mxu_score_stage<T, D, HC>(q_s, rows, k_rows, r * k_rows, bs, G, r == 0,
                                r == nk - 1, j * bs, seq_len, scale, s_s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (r == nk - 1) {
        compute_sync();
        mxu_softmax<T>(s_s, bs, G, m_s, l_s, a_s);
        compute_sync();
      }
    } else {
      mxu_value_stage<T, D, HC>(s_s, rows, v_rows, (r - nk) * v_rows, bs, G,
                                r == nk, r == per_page - 1, a_s, pv_s, acc_s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (r == per_page - 1) compute_sync();   // p, alpha, acc read
    }
  }
  T* ob = out + ((size_t)b * nq + (size_t)kh * G) * D;
  for (int e = tid; e < G * D; e += kThreads)
    ob[e] = from_f<T>(acc_s[e] / fmaxf(l_s[e / D], 1e-30f));
}

// ---- K14 / K16: token-major pages, one head -------------------------------
//
// The per-page function, in three steps, on rows [n][D] with row stride D
// in shared memory (a stage of either kernel's ring).

// s[t0 + t] = (q . row t) * scale + mask for the n rows: a warp per row,
// the lanes over d, a fixed shuffle tree.
template <typename T, int D>
__device__ __forceinline__ void score_rows(const float* q_s, const T* rows,
                                           int n, int t0, int base,
                                           int seq_len, float scale,
                                           float* s_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < n; t += kWarps) {
    const T* row = rows + (size_t)t * D;
    float s = 0.f;
#pragma unroll
    for (int dd = lane; dd < D; dd += 32) s = fmaf(q_s[dd], to_f(row[dd]), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0)
      s_s[t0 + t] = s * scale + (base + t0 + t < seq_len ? 0.f : kMaskFill);
  }
}

// The page's max, p (in place, fp32) and the state update, by warp 0; the
// caller synchronises before and after.
__device__ __forceinline__ void page_softmax(float* s_s, int bs, float* st) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float mx = kMaskFill;
  for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, s_s[t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_prev = st[0];
  const float m_new = fmaxf(m_prev, mx);
  float sum = 0.f;
  for (int t = lane; t < bs; t += 32) {
    const float p = expf(s_s[t] - m_new);
    sum += p;
    s_s[t] = p;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    const float alpha = expf(m_prev - m_new);
    st[1] = st[1] * alpha + sum;     // l
    st[0] = m_new;                   // m
    st[2] = alpha;
  }
}

// pv[k] += sum over the n rows of p[t0 + t] * row t [dd], dd = tid + k*128,
// tokens in order.
template <typename T, int D>
__device__ __forceinline__ void value_rows(const float* p_s, const T* rows,
                                           int n, int t0,
                                           float (&pv)[(D + kThreads - 1) /
                                                       kThreads]) {
#pragma unroll
  for (int k = 0; k < (D + kThreads - 1) / kThreads; ++k) {
    const int dd = threadIdx.x + k * kThreads;
    if (dd >= D) break;
    float a = pv[k];
#pragma unroll 4
    for (int t = 0; t < n; ++t)
      a = fmaf(p_s[t0 + t], to_f(rows[(size_t)t * D + dd]), a);
    pv[k] = a;
  }
}

template <int D>
__device__ __forceinline__ void update_acc(
    float (&acc)[(D + kThreads - 1) / kThreads],
    const float (&pv)[(D + kThreads - 1) / kThreads], float alpha) {
#pragma unroll
  for (int k = 0; k < (D + kThreads - 1) / kThreads; ++k)
    acc[k] = acc[k] * alpha + pv[k];
}

template <typename T, int D>
__device__ __forceinline__ void store_out(
    T* ob, const float (&acc)[(D + kThreads - 1) / kThreads], float l) {
#pragma unroll
  for (int k = 0; k < (D + kThreads - 1) / kThreads; ++k) {
    const int dd = threadIdx.x + k * kThreads;
    if (dd < D) ob[dd] = from_f<T>(acc[k] / fmaxf(l, 1e-30f));
  }
}

// ---- K14: the per-page function over a ring of 1-D bulk copies ------------
//
// Warps 0-3 compute (the per-page function above, which reads threadIdx.x
// in 0..127 and synchronises with named barrier 1 of 128 threads); warp 4
// is the producer, of which one thread issues the copies. full[s] counts
// the producer's arrival and the stage's bytes; empty[s] the four
// computing warps' releases.

// smem: full[kMaxStages], empty[kMaxStages] (256 B), the ring: stages x
// [tile][D] T (from byte 256), then q [D], s [bs], state (m, l, alpha).
// The walk is K16's: per page its k tiles, then its v tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kRingThreads)
paged_ring_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ table,
                  const int* __restrict__ seq_lens, T* __restrict__ out,
                  int nh, int bs, int mb, int tile, int stages, float scale) {
  constexpr int NK = (D + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  T* ring = reinterpret_cast<T*>(smem_raw + 256);
  float* q_s = reinterpret_cast<float*>(ring + (size_t)stages * tile * D);
  float* s_s = q_s + D;
  float* st = s_s + bs;
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int seq_len = seq_lens[b];
  const int n_pages = pages_to_read(seq_len, bs, mb);
  const int per_page = 2 * (bs / tile);     // k tiles, then v tiles
  const int half = per_page / 2;
  const int n_tiles = n_pages * per_page;
  if (tid < kThreads) {
    const T* qb = q + ((size_t)b * nh + hh) * D;
    for (int e = tid; e < D; e += kThreads) q_s[e] = to_f(qb[e]);
    if (tid == 0) {
      st[0] = kMaskFill;
      st[1] = 0.f;
    }
  } else if (tid == kThreads) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kThreads) {                     // producer
    if (tid != kThreads) return;
    const uint32_t bytes = (uint32_t)(tile * D * sizeof(T));
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % stages;
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      const int j = i / per_page, r = i % per_page;
      const size_t page = (size_t)table[(size_t)b * mb + j];
      const T* src = (r < half ? kp : vp) +
                     ((page * nh + hh) * (size_t)bs +
                      (size_t)(r % half) * tile) * D;
      mbar_expect_tx(&full[s], bytes);
      bulk_load(smem_u32(ring + (size_t)s * tile * D), src, bytes, &full[s]);
    }
    return;
  }

  float acc[NK], pv[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) acc[k] = pv[k] = 0.f;
  const int lane = tid % 32;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const int j = i / per_page, r = i % per_page;
    const T* rows = ring + (size_t)s * tile * D;
    if (r < half) {
      score_rows<T, D>(q_s, rows, tile, r * tile, j * bs, seq_len, scale,
                       s_s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (r == half - 1) {
        compute_sync();
        page_softmax(s_s, bs, st);
        compute_sync();
      }
    } else {
      value_rows<T, D>(s_s, rows, tile, (r - half) * tile, pv);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (r == per_page - 1) {
        update_acc<D>(acc, pv, st[2]);
#pragma unroll
        for (int k = 0; k < NK; ++k) pv[k] = 0.f;
        compute_sync();        // s and alpha read before the next page
      }
    }
  }
  store_out<T, D>(out + ((size_t)b * nh + hh) * D, acc, st[1]);
}

// smem: q [D], s [bs], state (m, l, alpha), then the ring: 2 x [tile][D] T.
// The walk is, per page, its k tiles then its v tiles; tile i + 1's copy is
// issued before tile i is computed.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_dma_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ seq_lens, T* __restrict__ out,
                 int nh, int bs, int mb, int tile, float scale) {
  constexpr int NK = (D + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* s_s = q_s + D;
  float* st = s_s + bs;
  T* ring = reinterpret_cast<T*>(st + 4);   // 16-byte aligned: D, bs % 8 == 0
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* qb = q + ((size_t)b * nh + hh) * D;
  for (int e = tid; e < D; e += kThreads) q_s[e] = to_f(qb[e]);
  if (tid == 0) {
    st[0] = kMaskFill;
    st[1] = 0.f;
  }
  float acc[NK], pv[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) acc[k] = pv[k] = 0.f;
  const int seq_len = seq_lens[b];
  const int n_pages = pages_to_read(seq_len, bs, mb);
  const int per_page = 2 * (bs / tile);     // k tiles, then v tiles
  const int n_tiles = n_pages * per_page;
  constexpr int kVec = 16 / sizeof(T);
  auto issue = [&](int i) {
    const int j = i / per_page, r = i % per_page;
    const size_t page = (size_t)table[(size_t)b * mb + j];
    const T* src = (r < per_page / 2 ? kp : vp) +
                   ((page * nh + hh) * (size_t)bs +
                    (size_t)(r % (per_page / 2)) * tile) * D;
    T* dst = ring + (size_t)(i % 2) * tile * D;
    for (int e = tid; e < tile * D / kVec; e += kThreads)
      cp_async16(dst + e * kVec, src + (size_t)e * kVec);
    cp_commit();
  };
  if (n_tiles > 0) issue(0);
  __syncthreads();
  for (int i = 0; i < n_tiles; ++i) {
    cp_wait_all();
    __syncthreads();                          // tile i landed, i - 1 consumed
    if (i + 1 < n_tiles) issue(i + 1);
    const int j = i / per_page, r = i % per_page, half = per_page / 2;
    const T* rows = ring + (size_t)(i % 2) * tile * D;
    if (r < half) {
      score_rows<T, D>(q_s, rows, tile, r * tile, j * bs, seq_len, scale,
                       s_s);
      if (r == half - 1) {
        __syncthreads();
        page_softmax(s_s, bs, st);
        __syncthreads();
      }
    } else {
      value_rows<T, D>(s_s, rows, tile, (r - half) * tile, pv);
      if (r == per_page - 1) {
        update_acc<D>(acc, pv, st[2]);
#pragma unroll
        for (int k = 0; k < NK; ++k) pv[k] = 0.f;
      }
    }
  }
  __syncthreads();
  store_out<T, D>(out + ((size_t)b * nh + hh) * D, acc, st[1]);
}

// ---- launchers ------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kSmSmem = 233472;        // an H100 SM's shared memory
constexpr size_t kBlockReserved = 1024;   // held back by the card a block
constexpr size_t kStageBytes = 16384;     // a ring stage at most

// K15's ring, as decode_attention.py::paged_mxu_plan sizes it: d-rows a k
// stage (the most of 64, 32, .., 1 within 16 KB), tokens a v stage (the
// most of 64, 32, 16, 8 that divides the page within 16 KB), stages (2 to
// 16, as many as leave two blocks on an SM beside the fixed part, else a
// block's whole shared memory) and the shared bytes; false where no
// two-stage ring fits.
struct MxuPlan {
  int k_rows, v_rows, stages;
  size_t smem;
};
bool mxu_plan(int D, int bs, int G, size_t itemsize, MxuPlan& p) {
  p.k_rows = 1;
  for (int r = 64; r > 1; r /= 2)
    if ((size_t)r * bs * itemsize <= kStageBytes) {
      p.k_rows = r;
      break;
    }
  p.v_rows = 0;
  for (int r = 64; r >= 8; r /= 2)
    if (bs % r == 0 && (size_t)r * D * itemsize <= kStageBytes) {
      p.v_rows = r;
      break;
    }
  if (p.v_rows == 0 || G < 1) return false;
  const size_t slot = (size_t)std::max(p.k_rows * bs, p.v_rows * D) * itemsize;
  const size_t fixed = 256 + sizeof(float) * ((size_t)3 * G * D +
                                              (size_t)G * bs + 3 * (size_t)G);
  const size_t rooms[2] = {kSmSmem / 2 - kBlockReserved, kMaxSmem};
  for (size_t room : rooms) {
    if (room <= fixed) continue;
    p.stages = (int)std::min((size_t)kMaxStages, (room - fixed) / slot);
    if (p.stages >= 2) {
      p.smem = fixed + (size_t)p.stages * slot;
      return true;
    }
  }
  return false;
}

// One launch of K15 with HC query heads a pass. The kernel's limit on
// dynamic shared memory is raised once, to a block's whole 227 KB.
template <typename T, int D, int HC>
int launch_mxu_hc(const void* q, const void* kt, const void* vp,
                  const int* tb, const int* sl, void* out, int B, int nkv,
                  int G, int bs, int mb, float scale, const MxuPlan& p,
                  cudaStream_t st) {
  static const cudaError_t attr =
      set_smem(paged_mxu_kernel<T, D, HC>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  paged_mxu_kernel<T, D, HC><<<dim3(nkv, B), kRingThreads, p.smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt),
      static_cast<const T*>(vp), tb, sl, static_cast<T*>(out), nkv, G, bs,
      mb, p.k_rows, p.v_rows, p.stages, std::max(p.k_rows * bs, p.v_rows * D),
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_mxu(const void* q, const void* kt, const void* vp, const int* tb,
               const int* sl, void* out, int B, int nkv, int G, int bs,
               int mb, float scale, cudaStream_t st) {
  MxuPlan p;
  if (!mxu_plan(D, bs, G, sizeof(T), p)) return (int)cudaErrorInvalidValue;
#define ARGS q, kt, vp, tb, sl, out, B, nkv, G, bs, mb, scale, p, st
  if (G == 1) return launch_mxu_hc<T, D, 1>(ARGS);
  if (G == 2) return launch_mxu_hc<T, D, 2>(ARGS);
  if (G <= 4) return launch_mxu_hc<T, D, 4>(ARGS);
  return launch_mxu_hc<T, D, 8>(ARGS);
#undef ARGS
}

// K14's ring geometry, as decode_attention.py::paged_ring_geometry sizes
// it: the bytes of shared memory, or 0 for a geometry the ring refuses.
size_t ring_smem(int d, int bs, int tile, int stages, size_t itemsize) {
  if (tile < 8 || tile % 8 || bs % tile || stages < 3 || stages > kMaxStages)
    return 0;
  return 256 + (size_t)stages * tile * d * itemsize +
         sizeof(float) * ((size_t)d + bs + 4);
}

template <typename T, int D>
int launch_tok(bool dma, const void* q, const void* kp, const void* vp,
               const int* tb, const int* sl, void* out, int B, int nh,
               int bs, int mb, int tile, int stages, float scale,
               cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kp);
  const T* vt = static_cast<const T*>(vp);
  T* ot = static_cast<T*>(out);
  const dim3 grid(nh, B);
  if (!dma) {
    const size_t smem = ring_smem(D, bs, tile, stages, sizeof(T));
    if (smem == 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem(paged_ring_kernel<T, D>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_ring_kernel<T, D><<<grid, kRingThreads, smem, st>>>(
        qt, kt, vt, tb, sl, ot, nh, bs, mb, tile, stages, scale);
    return (int)cudaGetLastError();
  }
  tile = bs % 32 == 0 ? 32 : bs % 16 == 0 ? 16 : 8;
  const size_t smem = sizeof(float) * ((size_t)D + bs + 4) +
                      sizeof(T) * 2 * (size_t)tile * D;
  cudaError_t err = set_smem(paged_dma_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_dma_kernel<T, D><<<grid, kThreads, smem, st>>>(
      qt, kt, vt, tb, sl, ot, nh, bs, mb, tile, scale);
  return (int)cudaGetLastError();
}

bool geometry_ok(int B, int heads, int d, int bs, int mb, int dtype) {
  return B > 0 && heads > 0 && mb > 0 && bs > 0 && bs % 8 == 0 &&
         (d == 64 || d == 128 || d == 256) && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and o alike); d in {64, 128,
// 256}; bs % 8 == 0. Return cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a geometry the kernels do not take).

// K15: q [B, nkv * G, d], kt [P, nkv, d, bs], v [P, nkv, bs, d].
extern "C" int paged_decode_mxu(const void* q, const void* kt, const void* v,
                                const int* table, const int* seq_lens,
                                void* out, int B, int nkv, int G, int d,
                                int bs, int mb, float scale, int dtype,
                                void* stream) {
  if (!geometry_ok(B, nkv, d, bs, mb, dtype) || G < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS q, kt, v, table, seq_lens, out, B, nkv, G, bs, mb, scale, st
  if (dtype == 1) {
    if (d == 64) return launch_mxu<__nv_bfloat16, 64>(ARGS);
    if (d == 128) return launch_mxu<__nv_bfloat16, 128>(ARGS);
    return launch_mxu<__nv_bfloat16, 256>(ARGS);
  }
  if (d == 64) return launch_mxu<float, 64>(ARGS);
  if (d == 128) return launch_mxu<float, 128>(ARGS);
  return launch_mxu<float, 256>(ARGS);
#undef ARGS
}

// K15's ring as its launcher plans it (mxu_plan): out = {d-rows a k
// stage, tokens a v stage, stages, shared bytes}; cudaErrorInvalidValue
// where no ring fits.
extern "C" int paged_mxu_plan_c(int d, int bs, int G, int itemsize,
                                int* out) {
  MxuPlan p;
  if (!mxu_plan(d, bs, G, (size_t)itemsize, p))
    return (int)cudaErrorInvalidValue;
  out[0] = p.k_rows;
  out[1] = p.v_rows;
  out[2] = p.stages;
  out[3] = (int)p.smem;
  return 0;
}

// K14 (dma = 0) and K16 (dma = 1): q [B, nh, d], k and v [P, nh, bs, d].
// tile and stages are K14's ring (rows a stage, stages); K16 sizes its own.
extern "C" int paged_decode_tok(int dma, const void* q, const void* k,
                                const void* v, const int* table,
                                const int* seq_lens, void* out, int B, int nh,
                                int d, int bs, int mb, int tile, int stages,
                                float scale, int dtype, void* stream) {
  if (!geometry_ok(B, nh, d, bs, mb, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m = dma != 0;
#define ARGS m, q, k, v, table, seq_lens, out, B, nh, bs, mb, tile, stages, \
    scale, st
  if (dtype == 1) {
    if (d == 64) return launch_tok<__nv_bfloat16, 64>(ARGS);
    if (d == 128) return launch_tok<__nv_bfloat16, 128>(ARGS);
    return launch_tok<__nv_bfloat16, 256>(ARGS);
  }
  if (d == 64) return launch_tok<float, 64>(ARGS);
  if (d == 128) return launch_tok<float, 128>(ARGS);
  return launch_tok<float, 256>(ARGS);
#undef ARGS
}
