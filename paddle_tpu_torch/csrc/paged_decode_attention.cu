// One-token decode attention over a paged KV cache, for Hopper (sm_90a):
// K15 (d-major k pages, GQA), K14 (token-major pages, a bulk-copy ring)
// and K16 (K14's function, warp-specialised: two producer warps, a score
// warpgroup a page ahead of a value warpgroup).
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
// K14 and K16 compute one per-page function in one order of operations:
// a token's score is K14's 32 lane partials (lane l sums d = l, l + 32,
// .. in order) over a fixed xor tree, scaled and masked (masked_score);
// the page's max, p and state update on one warp (page_softmax_warp); a
// thread per element of d walks the page's tokens in order for p v
// (value_rows) and updates acc (update_acc). In the token-major pages one
// head's page is bs * d contiguous values, so a tile of its rows is one
// contiguous run, copied by a 1-D bulk copy. They differ in how the work
// is laid out:
// - K14 (paged_ring_kernel, K15's warps and ring): one producer thread
//   streams a page's k tiles, then its v tiles, into a ring of 3-16
//   stages of 64, 32, 16 or 8 rows (at most 16 KB; decode_attention.py::
//   paged_ring_geometry: at llama2-7b's width 6 stages of 64 rows, for
//   the grid of nh x B = 256 blocks over 132 SMs in one wave); four warps
//   take the scores a warp a token, the softmax, then the values.
// - K16 (paged_dma_kernel, 320 threads): a k producer warp and a v
//   producer warp keep the pages' k and v tiles flowing into a k ring and
//   a v ring (decode_attention.py::paged_dma_plan: three stages of 64
//   rows each at llama2-7b's width, 96 KB in flight a block, two blocks
//   an SM). The score warpgroup computes page j + 1's scores while
//   the value warpgroup runs page j's p v: four threads a token, each
//   holding eight of K14's lane partials (four 16-byte loads of a bf16
//   row at d 128), K14's tree levels 16 and 8 by shuffle among them and
//   levels 4, 2, 1 in registers, eight tokens a warp at once; its warp 0
//   runs the page's softmax into one of two score buffers, which the
//   value warpgroup frees when it has read them.
// The TPU's DMA variant copies groups of gk whole pages of all heads (gk =
// _paged_pages_per_program); at llama2-7b's width a page of all heads is
// 1 MiB, beyond the 227 KB of a block's shared memory, so the unit here
// is a tile of one head's page. Both kernels compute every sum in the
// same order, so K14 gives K16's bits.
//
// Bound on the H100: bytes. A decode step reads the valid tokens' k and v,
// 2 * seq_len * nkv * d values per sequence, and does 4 * nq * seq_len * d
// flop: G flop per byte in bf16 (4 at llama3-8b), far under the ~295 the
// tensor cores need. At llama2-7b (B 8, 32 heads of 128, bf16) with 1088
// tokens a sequence that is 143 MB per layer, 0.043 ms at 3.35 TB/s. What
// decides the time is the bytes in flight and how fast the consumers free
// them: K15's and K14's rings hold up to a page and a half, their four
// warps compute each page's steps in turn; K16's two rings hold as much,
// and its warpgroups overlap (PERF.md).

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

// A token's score from its dot product: scaled, -1e30 added past seq_len.
__device__ __forceinline__ float masked_score(float s, float scale, int pos,
                                              int seq_len) {
  return s * scale + (pos < seq_len ? 0.f : kMaskFill);
}

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
      s_s[t0 + t] = masked_score(s, scale, base + t0 + t, seq_len);
  }
}

// The page's max, p (in place, fp32) and the state update (m = ml[0],
// l = ml[1]; alpha into *alpha), by one warp.
__device__ __forceinline__ void page_softmax_warp(float* s_s, int bs,
                                                  float* ml, float* alpha,
                                                  int lane) {
  float mx = kMaskFill;
  for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, s_s[t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_prev = ml[0];
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
    const float a = expf(m_prev - m_new);
    ml[1] = ml[1] * a + sum;         // l
    ml[0] = m_new;                   // m
    *alpha = a;
  }
}

// K14's: warp 0, state st = (m, l, alpha); the caller synchronises before
// and after.
__device__ __forceinline__ void page_softmax(float* s_s, int bs, float* st) {
  if (threadIdx.x >= 32) return;
  page_softmax_warp(s_s, bs, st, st + 2, threadIdx.x);
}

// pv[k] += sum over the n rows of p[t0 + t] * row t [dd], dd = vt + k*128
// (vt the thread's index among the 128 that walk the values), tokens in
// order.
template <typename T, int D>
__device__ __forceinline__ void value_rows(const float* p_s, const T* rows,
                                           int n, int t0,
                                           float (&pv)[(D + kThreads - 1) /
                                                       kThreads],
                                           int vt) {
#pragma unroll
  for (int k = 0; k < (D + kThreads - 1) / kThreads; ++k) {
    const int dd = vt + k * kThreads;
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
    T* ob, const float (&acc)[(D + kThreads - 1) / kThreads], float l,
    int vt) {
#pragma unroll
  for (int k = 0; k < (D + kThreads - 1) / kThreads; ++k) {
    const int dd = vt + k * kThreads;
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
// The walk: per page its k tiles, then its v tiles.
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
      value_rows<T, D>(s_s, rows, tile, (r - half) * tile, pv, tid);
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
  store_out<T, D>(out + ((size_t)b * nh + hh) * D, acc, st[1], tid);
}

// ---- K16: K14's per-page function, warp-specialised ----------------------
//
// Warps 0-3 (the score warpgroup) take each page's scores and, on warp 0,
// its softmax; warps 4-7 (the value warpgroup) its p v, a page behind;
// warp 8's lane 0 streams the pages' k tiles into the k ring, warp 9's the
// v tiles into the v ring, each in table order. kfull / vfull count a
// producer's arrival and the stage's bytes, kempty / vempty the four
// consuming warps' releases; sfull[b] says the score buffer b holds a
// page's p and alpha (warp 0's 32 lanes), sempty[b] that the value warps
// have read them.

constexpr int kDmaThreads = 2 * kThreads + 64;   // + two producer warps
constexpr int kDmaBarBytes = 640;                // 4 x 16 + 4 mbarriers

// Eight consecutive values widened to fp32 (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

// smem: kfull, kempty, vfull, vempty [kMaxStages] each, sfull [2], sempty
// [2] (from byte 0); the k ring: k_stages x [tile][D] T (from byte 640),
// the v ring: v_stages x [tile][D] T; then fp32 q [D], s [2][bs], (m, l),
// alpha [2] (paged_dma_plan's layout).
template <typename T, int D>
__global__ void __launch_bounds__(kDmaThreads, D == 256 ? 1 : 2)
paged_dma_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ seq_lens, T* __restrict__ out,
                 int nh, int bs, int mb, int tile, int k_stages,
                 int v_stages, float scale) {
  constexpr int NK = (D + kThreads - 1) / kThreads;
  constexpr int KD = D / 32;                 // K14's terms a lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* kempty = kfull + kMaxStages;
  uint64_t* vfull = kempty + kMaxStages;
  uint64_t* vempty = vfull + kMaxStages;
  uint64_t* sfull = vempty + kMaxStages;
  uint64_t* sempty = sfull + 2;
  T* kring = reinterpret_cast<T*>(smem_raw + kDmaBarBytes);
  T* vring = kring + (size_t)k_stages * tile * D;
  float* q_s = reinterpret_cast<float*>(vring + (size_t)v_stages * tile * D);
  float* s_s = q_s + D;
  float* ml = s_s + 2 * bs;
  float* alpha_s = ml + 2;
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int seq_len = seq_lens[b];
  const int n_pages = pages_to_read(seq_len, bs, mb);
  const int tpp = bs / tile;                 // tiles a page
  const T* qb = q + ((size_t)b * nh + hh) * D;
  for (int e = tid; e < D; e += 2 * kThreads) q_s[e] = to_f(qb[e]);
  if (tid == 0) {
    ml[0] = kMaskFill;
    ml[1] = 0.f;
  } else if (tid == 2 * kThreads) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], kWarps);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], kWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sfull[i], 32);
      mbar_init(&sempty[i], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {                           // producers
    if (lane != 0) return;
    const bool v = warp == 9;
    T* ring = v ? vring : kring;
    const T* src0 = v ? vp : kp;
    uint64_t* full = v ? vfull : kfull;
    uint64_t* empty = v ? vempty : kempty;
    const int stages = v ? v_stages : k_stages;
    const uint32_t bytes = (uint32_t)(tile * D * sizeof(T));
    for (int i = 0; i < n_pages * tpp; ++i) {
      const int s = i % stages;
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      const size_t page = (size_t)table[(size_t)b * mb + i / tpp];
      const T* src = src0 + ((page * nh + hh) * (size_t)bs +
                             (size_t)(i % tpp) * tile) * D;
      mbar_expect_tx(&full[s], bytes);
      bulk_load(smem_u32(ring + (size_t)s * tile * D), src, bytes, &full[s]);
    }
    return;
  }

  if (warp < 4) {                            // scores and softmax
    // four threads a token: part g holds K14's lanes 8g .. 8g + 7
    const int g = tid % 4, tq = tid / 4;
    float qr[KD][8];
#pragma unroll
    for (int k = 0; k < KD; ++k) load8(q_s + 32 * k + 8 * g, qr[k]);
    for (int j = 0; j < n_pages; ++j) {
      const int sb = j & 1;
      float* sj = s_s + sb * bs;
      mbar_wait(&sempty[sb], ((j >> 1) & 1) ^ 1);
      for (int r = 0; r < tpp; ++r) {
        const int i = j * tpp + r, st = i % k_stages;
        mbar_wait(&kfull[st], (i / k_stages) & 1);
        const T* rows = kring + (size_t)st * tile * D;
        for (int t = tq; t < tile; t += 32) {     // whole warps in or out
          const T* row = rows + (size_t)t * D + 8 * g;
          float c[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) c[e] = 0.f;
#pragma unroll
          for (int k = 0; k < KD; ++k) {
            float x[8];
            load8(row + 32 * k, x);
#pragma unroll
            for (int e = 0; e < 8; ++e) c[e] = fmaf(qr[k][e], x[e], c[e]);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e)            // level 16: lanes l, l ^ 16
            c[e] += __shfl_xor_sync(0xffffffffu, c[e], 2);
#pragma unroll
          for (int e = 0; e < 8; ++e)            // level 8
            c[e] += __shfl_xor_sync(0xffffffffu, c[e], 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] += c[e + 4];   // level 4
#pragma unroll
          for (int e = 0; e < 2; ++e) c[e] += c[e + 2];   // level 2
          const float s = c[0] + c[1];                      // level 1
          if (g == 0)
            sj[r * tile + t] = masked_score(s, scale, j * bs + r * tile + t,
                                            seq_len);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&kempty[st]);
      }
      named_barrier(1, kThreads);            // the page's scores are in
      if (warp == 0) {
        page_softmax_warp(sj, bs, ml, &alpha_s[sb], lane);
        mbar_arrive(&sfull[sb]);
      }
    }
    return;
  }

  const int vt = tid - kThreads;             // values, a page behind
  float acc[NK], pv[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) acc[k] = pv[k] = 0.f;
  for (int j = 0; j < n_pages; ++j) {
    const int sb = j & 1;
    const float* pj = s_s + sb * bs;
    mbar_wait(&sfull[sb], (j >> 1) & 1);
    for (int r = 0; r < tpp; ++r) {
      const int i = j * tpp + r, st = i % v_stages;
      mbar_wait(&vfull[st], (i / v_stages) & 1);
      value_rows<T, D>(pj, vring + (size_t)st * tile * D, tile, r * tile, pv,
                       vt);
      __syncwarp();
      if (lane == 0) mbar_arrive(&vempty[st]);
    }
    update_acc<D>(acc, pv, alpha_s[sb]);
#pragma unroll
    for (int k = 0; k < NK; ++k) pv[k] = 0.f;
    __syncwarp();
    if (lane == 0) mbar_arrive(&sempty[sb]);
  }
  store_out<T, D>(out + ((size_t)b * nh + hh) * D, acc, ml[1], vt);
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
int launch_tok(const void* q, const void* kp, const void* vp, const int* tb,
               const int* sl, void* out, int B, int nh, int bs, int mb,
               int tile, int stages, float scale, cudaStream_t st) {
  const size_t smem = ring_smem(D, bs, tile, stages, sizeof(T));
  if (smem == 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(paged_ring_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_ring_kernel<T, D><<<dim3(nh, B), kRingThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tb, sl, static_cast<T*>(out), nh, bs, mb,
      tile, stages, scale);
  return (int)cudaGetLastError();
}

// K16's rings, as decode_attention.py::paged_dma_plan sizes them: rows a
// stage (the most of 64, 32, 16, 8 that divides the page within 16 KB),
// stages of the k ring and of the v ring (as many between them as leave
// two blocks on an SM beside the fixed part, half each, the v ring the
// odd one, 2 to 16 each; else a block's whole shared memory), threads
// and shared bytes; false where no two-stage rings fit.
struct DmaPlan {
  int tile, k_stages, v_stages, threads;
  size_t smem;
};
bool dma_plan(int D, int bs, size_t itemsize, DmaPlan& p) {
  const size_t row = (size_t)D * itemsize;
  p.tile = 0;
  for (int t = 64; t >= 8; t /= 2)
    if (bs % t == 0 && t * row <= kStageBytes) {
      p.tile = t;
      break;
    }
  if (p.tile == 0) return false;
  const size_t slot = p.tile * row;
  const size_t fixed = kDmaBarBytes + sizeof(float) * ((size_t)D + 2 * bs + 4);
  const size_t rooms[2] = {kSmSmem / 2 - kBlockReserved, kMaxSmem};
  for (size_t room : rooms) {
    if (room <= fixed) continue;
    const int total =
        (int)std::min((size_t)2 * kMaxStages, (room - fixed) / slot);
    p.k_stages = total / 2;
    p.v_stages = total - p.k_stages;
    if (p.k_stages >= 2) {
      p.threads = kDmaThreads;
      p.smem = fixed + (size_t)total * slot;
      return true;
    }
  }
  return false;
}

// One launch of K16. The kernel's limit on dynamic shared memory is
// raised once, to a block's whole 227 KB.
template <typename T, int D>
int launch_dma(const void* q, const void* kp, const void* vp, const int* tb,
               const int* sl, void* out, int B, int nh, int bs, int mb,
               float scale, cudaStream_t st) {
  DmaPlan p;
  if (!dma_plan(D, bs, sizeof(T), p)) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = set_smem(paged_dma_kernel<T, D>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  paged_dma_kernel<T, D><<<dim3(nh, B), p.threads, p.smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tb, sl, static_cast<T*>(out), nh, bs, mb,
      p.tile, p.k_stages, p.v_stages, scale);
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

// K14: q [B, nh, d], k and v [P, nh, bs, d]; tile and stages are its
// ring (rows a stage, stages: paged_ring_geometry).
extern "C" int paged_decode_tok(const void* q, const void* k, const void* v,
                                const int* table, const int* seq_lens,
                                void* out, int B, int nh, int d, int bs,
                                int mb, int tile, int stages, float scale,
                                int dtype, void* stream) {
  if (!geometry_ok(B, nh, d, bs, mb, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, table, seq_lens, out, B, nh, bs, mb, tile, stages, \
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

// K16: K14's function and operands; it sizes its own rings (dma_plan).
extern "C" int paged_decode_dma(const void* q, const void* k, const void* v,
                                const int* table, const int* seq_lens,
                                void* out, int B, int nh, int d, int bs,
                                int mb, float scale, int dtype,
                                void* stream) {
  if (!geometry_ok(B, nh, d, bs, mb, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, table, seq_lens, out, B, nh, bs, mb, scale, st
  if (dtype == 1) {
    if (d == 64) return launch_dma<__nv_bfloat16, 64>(ARGS);
    if (d == 128) return launch_dma<__nv_bfloat16, 128>(ARGS);
    return launch_dma<__nv_bfloat16, 256>(ARGS);
  }
  if (d == 64) return launch_dma<float, 64>(ARGS);
  if (d == 128) return launch_dma<float, 128>(ARGS);
  return launch_dma<float, 256>(ARGS);
#undef ARGS
}

// K16's rings as its launcher plans them (dma_plan): out = {rows a stage,
// k stages, v stages, threads, shared bytes}; cudaErrorInvalidValue where
// none fit.
extern "C" int paged_dma_plan_c(int d, int bs, int itemsize, int* out) {
  DmaPlan p;
  if (!dma_plan(d, bs, (size_t)itemsize, p)) return (int)cudaErrorInvalidValue;
  out[0] = p.tile;
  out[1] = p.k_stages;
  out[2] = p.v_stages;
  out[3] = p.threads;
  out[4] = (int)p.smem;
  return 0;
}
