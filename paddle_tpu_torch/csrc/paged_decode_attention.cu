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
// (a split-K combine would change the softmax's sums). K15 (128 threads)
// reads its d-major k page coalesced along the page's tokens (a thread per
// token, the loop over d) and the token-major v page along d (a thread per
// element of d, the loop over tokens): fp32 FMAs, never TF32, G query
// heads eight at a time. K14 and K16 share one per-page function
// (score_rows, page_softmax, value_rows): a warp per token for the scores,
// one warp for the page's max and sum, a thread per element of d for the
// values, each sum in a fixed order that does not depend on how the rows
// are tiled. They differ in how rows reach shared memory:
// - K14 (paged_ring_kernel, 4 computing warps + 1 producer warp): in the
//   token-major pages one head's page is bs * d contiguous values, so a
//   tile of its rows is one contiguous run. One producer thread issues a
//   1-D bulk copy (cp.async.bulk, completing on an mbarrier: no tensor
//   map) per tile into a ring of 3-16 stages and runs ahead across pages,
//   so the next page's k tiles and this page's v tiles are in flight while
//   scores and values are computed. A stage is 64, 32, 16 or 8 rows (at
//   most 16 KB), and the ring as deep as leaves two blocks on an SM
//   (decode_attention.py::paged_ring_geometry): at llama2-7b's width 6
//   stages of 64 rows, ~96 KB in flight a block, for the grid of nh x B =
//   256 blocks over 132 SMs in one wave.
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
// decides the time is the bytes in flight: K15 reads each page with plain
// loads, a few bytes in flight per thread; K16 keeps one tile in flight a
// block; K14's ring keeps up to a page and a half (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// ---- K15: d-major k pages, GQA ------------------------------------------

// smem: q [G][D], s [G][bs], m [G], l [G], alpha [G], acc [G][D].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_mxu_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                 const T* __restrict__ vp, const int* __restrict__ table,
                 const int* __restrict__ seq_lens, T* __restrict__ out,
                 int nkv, int G, int bs, int mb, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [G][D]
  float* s_s = q_s + G * D;          // [G][bs]
  float* m_s = s_s + G * bs;         // [G]
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* acc_s = a_s + G;            // [G][D]
  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = nkv * G;
  const T* qb = q + ((size_t)b * nq + (size_t)kh * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    q_s[e] = to_f(qb[e]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMaskFill;
    l_s[g] = 0.f;
  }
  const int seq_len = seq_lens[b];
  const int n_pages = pages_to_read(seq_len, bs, mb);
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    const size_t page = (size_t)table[(size_t)b * mb + j];
    const T* kpg = kt + (page * nkv + kh) * (size_t)D * bs;   // [D][bs]
    const T* vpg = vp + (page * nkv + kh) * (size_t)bs * D;   // [bs][D]
    const int base = j * bs;
    // scores: a thread per token, the loop over d (coalesced along bs)
    for (int t = tid; t < bs; t += kThreads) {
      const float mask = base + t < seq_len ? 0.f : kMaskFill;
      for (int g0 = 0; g0 < G; g0 += kGc) {
        float s[kGc];
#pragma unroll
        for (int c = 0; c < kGc; ++c) s[c] = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) {
          const float kv = to_f(kpg[(size_t)dd * bs + t]);
#pragma unroll
          for (int c = 0; c < kGc; ++c)
            if (g0 + c < G) s[c] = fmaf(q_s[(g0 + c) * D + dd], kv, s[c]);
        }
#pragma unroll
        for (int c = 0; c < kGc; ++c)
          if (g0 + c < G) s_s[(g0 + c) * bs + t] = s[c] * scale + mask;
      }
    }
    __syncthreads();
    // the page's max and sum: a warp per query head
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
        row[t] = round_to<T>(p);           // p in the page dtype before p v
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
    __syncthreads();
    // values: a thread per element of d, the loop over tokens
    for (int dd = tid; dd < D; dd += kThreads) {
      for (int g0 = 0; g0 < G; g0 += kGc) {
        float pv[kGc];
#pragma unroll
        for (int c = 0; c < kGc; ++c) pv[c] = 0.f;
#pragma unroll 4
        for (int t = 0; t < bs; ++t) {
          const float vv = to_f(vpg[(size_t)t * D + dd]);
#pragma unroll
          for (int c = 0; c < kGc; ++c)
            if (g0 + c < G) pv[c] = fmaf(s_s[(g0 + c) * bs + t], vv, pv[c]);
        }
#pragma unroll
        for (int c = 0; c < kGc; ++c)
          if (g0 + c < G) {
            const int e = (g0 + c) * D + dd;
            acc_s[e] = acc_s[e] * a_s[g0 + c] + pv[c];
          }
      }
    }
    __syncthreads();
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// One contiguous run of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

constexpr int kRingThreads = kThreads + 32;   // + the producer warp
constexpr int kMaxStages = 16;

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
      bulk_copy(ring + (size_t)s * tile * D, src, bytes, &full[s]);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

template <typename T, int D>
int launch_mxu(const void* q, const void* kt, const void* vp, const int* tb,
               const int* sl, void* out, int B, int nkv, int G, int bs,
               int mb, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)2 * G * D + (size_t)G * bs +
                                       3 * (size_t)G);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(paged_mxu_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_mxu_kernel<T, D><<<dim3(nkv, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt),
      static_cast<const T*>(vp), tb, sl, static_cast<T*>(out), nkv, G, bs,
      mb, scale);
  return (int)cudaGetLastError();
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
