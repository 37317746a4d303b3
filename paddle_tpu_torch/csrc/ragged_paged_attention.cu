// Unified ragged paged attention for Hopper (sm_90a): K8 and K8q.
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/ragged_paged_attention.py::_rpa_kernel
// (launched by ragged_paged_attention_kernel). Same contract: q [C, qb, nH, d];
// d-major k pages [P, nKV, d, bs]; v pages [P, nKV, bs, d]; rows [C, mb],
// pos0 [C], n_valid [C] int32. Query row r of chunk c is token r / G, group
// head r % G (G = nH / nKV), so a page is read once for all G heads that
// share it. Row i attends keys kpos <= pos0 + min(i, n_valid - 1): padding
// rows repeat the last valid row. Masked scores are s + (-1e30); p is
// rounded to the q dtype before p v; the output is acc / max(l, 1e-30).
//
// K8q, the int8-page arm of the same TPU kernel (quant=True,
// serving_kv_quant): int8 pages of the same layouts with fp32 scale planes
// k_scales / v_scales [P, nKV]. Each int8 tile element is multiplied in
// fp32 by its page's scale, scales[rows[c, j] * nKV + h], and rounded to
// the q dtype before the products (ops/quant.py::dequantize_int8, the TPU
// kernel's order); the rest is K8's code, so on pages dequantized
// beforehand K8 gives the same bits.
//
// Bound on the H100: bytes. Each (chunk, kv head) reads its pages once
// (2 * ctx * d * itemsize bytes) and does ~4 * G * qb flops per byte read,
// far under the ~295 flop/byte at which bf16 tensor cores would be the
// limit; int8 pages halve the bytes.
//
// Design of the route the engine takes (rpa_wg_kernel: bf16, head dim 64
// or 128, pages of a multiple of 64 tokens). The TPU grid walks (chunk,
// kv head, page) in order with the online softmax in scratch. Here:
//
// - Splits fixed by key position. Split s of a (chunk, kv head) covers
//   pages [s Sp, (s + 1) Sp) of rows[c]; Sp and the number of splits come
//   from rpa_plan, a function of (mb, bs, d, G, qb, dtype, quant) alone,
//   never of pos0, n_valid, C or the page ids. One block a split, the
//   splits of a (chunk, kv head, 64-row tile) one cluster of at most 8.
//   A split that lies wholly past the chunk's last valid key loads
//   nothing: its block takes part in the cluster's first barrier (every
//   block's mbarriers are initialised before any is signalled) and exits;
//   the active splits are ranks 0 .. n_act - 1. A split holds at least
//   1024 keys, a ring of 2 stages of 32 KB, 3 blocks an SM (168
//   registers): at the engine's step (mb 16, 2 splits of 8 pages) this
//   beat splits of 256 keys (8 a cluster: 30 clusters of ~97 KB blocks
//   fit the card at once, so 256 clusters ran in ~9 waves), 512 and 2048
//   keys, and 3 stages at 2 blocks an SM (obs/rpa_timing.py's mixes).
// - A ring of TMA loads. Thread 0 keeps `stages` tiles of 64 keys in
//   flight, each a k box (64 keys x d, from the d-major page) and a v box
//   (d x 64 keys) in the 128-byte swizzle, completing on the stage's
//   mbarrier; the page of a tile is read from rows[]. A stage is issued
//   again once the warpgroup's products have read it. K8q's int8 boxes
//   land in the same ring (no swizzle, half the bytes); the warpgroup
//   dequantizes each into one bf16 tile in the swizzled layout the
//   products read (dequant16's arithmetic), so its bits are K8's.
// - wgmma. The block's one warpgroup holds 64 query rows: q k^T is a
//   m64n64k16 chain with q in registers (register A) and the k box an
//   MN-major B; after the masked online softmax in registers, p (rounded
//   to bf16) is register A of p v against the v box, MN-major. No wgmma
//   sits in a data-dependent branch and none has its registers touched in
//   flight (ptxas C7515/C7518). The tile's steps run in turn: neither
//   removing both products nor pipelining tile j + 1's q k^T under tile
//   j's p v made the kernel faster, nor an L2 prefetch ahead of the ring
//   (the step's K8 moves ~2.3 TB/s of the bytes it reads; K8q is bound by
//   its dequant).
// - The combine. Each active block leaves (m, l, acc) of its 64 rows in
//   its shared memory and signals every active rank's mbarrier; each
//   takes a share of the rows and combines the splits in split order
//   through distributed shared memory: M = max_s m_s, w_s = exp(m_s - M),
//   o = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30); then it signals
//   that it has read, and no block leaves before every reader has. One
//   active split writes o / l from registers (the same arithmetic: w = 1).
//
// Row independence: a query row's output bits do not depend on the chunk
// that carries it. Its splits and tiles are fixed by key position; within
// a split the row's state depends only on its own scores (a fully masked
// tile after its last key adds exp(-1e30 - m) = 0 with rescale 1). A split
// with no key of the row (past its position) ends with m = -1e30 and
// combines with weight exp(-1e30 - M) = 0, and a split past the chunk's
// last key is skipped: both add exactly 0. Split 0 holds key 0, so M is a
// real score. What remains is the row's own positions and keys.
//
// Other routes: bf16 at head dim 64 or 128 with pages of 16, 32 or 48
// tokens (bs % 16 == 0, bs % 64 != 0) keep the mma.sync kernel
// (rpa_tc_kernel: one block a (chunk, kv head, 64 rows) walking all its
// pages); fp32, and bf16 at head dim 256, the CUDA-core kernel with fp32
// FMAs (rpa_kernel). Each C entry reports the variant it launched.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;      // query rows (token x group head) per block
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// A page element as the dots see it: fp pages as they are, int8 pages
// times the page's scale in fp32, rounded to the q dtype T.
template <typename T>
__device__ __forceinline__ float tile_val(const T* p, size_t i, float) {
  return to_f(p[i]);
}
template <typename T>
__device__ __forceinline__ float tile_val(const int8_t* p, size_t i,
                                          float s) {
  return to_f(from_f<T>(__fmul_rn((float)p[i], s)));
}

// PT: the page element type, T for fp pages or int8_t (then ksc / vsc are
// the [P, nKV] scale planes; unused for fp pages).
template <typename T, typename PT, int D, int BK>
__global__ void __launch_bounds__(kThreads)
rpa_kernel(const T* __restrict__ q, const PT* __restrict__ kp,
           const PT* __restrict__ vp, const float* __restrict__ ksc,
           const float* __restrict__ vsc, const int* __restrict__ rows,
           const int* __restrict__ pos0, const int* __restrict__ nval,
           T* __restrict__ out, int qb, int nH, int nKV, int bs, int mb,
           float sm_scale) {
  constexpr int kAcc = kRows * D / kThreads;
  extern __shared__ float smem[];
  float* qs = smem;               // [kRows][D]
  float* ks = qs + kRows * D;     // [D][BK]   (d-major, as in the page)
  float* vs = ks + D * BK;        // [BK][D]
  float* ss = vs + BK * D;        // [kRows][BK] scores, then probabilities
  float* m_s = ss + kRows * BK;   // [kRows] running max
  float* l_s = m_s + kRows;       // [kRows] running sum
  float* a_s = l_s + kRows;       // [kRows] rescale factor of this tile

  const int G = nH / nKV;
  const int c = blockIdx.x / nKV;
  const int h = blockIdx.x % nKV;
  const int r0 = blockIdx.y * kRows;
  const int n_rows = qb * G;
  const int tid = threadIdx.x;
  const int p0 = pos0[c];
  const int nv = nval[c];
  const int last = p0 + nv - 1;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int rr = e / D, dd = e % D, r = r0 + rr;
    float v = 0.f;
    if (r < n_rows) {
      const int i = r / G, g = r % G;
      v = to_f(q[(((size_t)c * qb + i) * nH + h * G + g) * D + dd]);
    }
    qs[e] = v;
  }
  for (int rr = tid; rr < kRows; rr += kThreads) {
    m_s[rr] = -1e30f;
    l_s[rr] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int n_pages = min(mb, last / bs + 1);
  const int warp = tid / 32, lane = tid % 32;
  for (int j = 0; j < n_pages; ++j) {
    const int page = rows[c * mb + j];
    const PT* kpg = kp + ((size_t)page * nKV + h) * D * bs;
    const PT* vpg = vp + ((size_t)page * nKV + h) * bs * D;
    const float k_s = ksc ? ksc[(size_t)page * nKV + h] : 1.f;
    const float v_s = vsc ? vsc[(size_t)page * nKV + h] : 1.f;
    for (int t0 = 0; t0 < bs && j * bs + t0 <= last; t0 += BK) {
      for (int e = tid; e < D * BK; e += kThreads) {
        const int dd = e / BK, t = e % BK;
        ks[e] = tile_val<T>(kpg, (size_t)dd * bs + t0 + t, k_s);
      }
      for (int e = tid; e < BK * D; e += kThreads) {
        const int t = e / D, dd = e % D;
        vs[e] = tile_val<T>(vpg, (size_t)(t0 + t) * D + dd, v_s);
      }
      __syncthreads();
      for (int e = tid; e < kRows * BK; e += kThreads) {
        const int rr = e / BK, t = e % BK;
        float s = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) s = fmaf(qs[rr * D + dd], ks[dd * BK + t], s);
        s *= sm_scale;
        const int i = (r0 + rr) / G;
        const int qpos = p0 + min(i, nv - 1);
        const int kpos = j * bs + t0 + t;
        ss[e] = kpos <= qpos ? s : s + (-1e30f);
      }
      __syncthreads();
      for (int rr = warp; rr < kRows; rr += kThreads / 32) {
        float mx = -INFINITY;
        for (int t = lane; t < BK; t += 32) mx = fmaxf(mx, ss[rr * BK + t]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[rr];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < BK; t += 32) {
          const float p = expf(ss[rr * BK + t] - m_new);
          ss[rr * BK + t] = p;
          sum += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[rr] = l_s[rr] * alpha + sum;
          m_s[rr] = m_new;
          a_s[rr] = alpha;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        const int e = tid + k * kThreads;
        const int rr = e / D, dd = e % D;
        float a = acc[k] * a_s[rr];
#pragma unroll 8
        for (int t = 0; t < BK; ++t) a = fmaf(ss[rr * BK + t], vs[t * D + dd], a);
        acc[k] = a;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kThreads;
    const int rr = e / D, dd = e % D, r = r0 + rr;
    if (r < n_rows) {
      const int i = r / G, g = r % G;
      out[(((size_t)c * qb + i) * nH + h * G + g) * D + dd] =
          from_f<T>(acc[k] / fmaxf(l_s[rr], 1e-30f));
    }
  }
}

template <typename T, typename PT, int D, int BK>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ksc, const float* vsc, const int* rows,
                   const int* pos0, const int* nval, void* out, int C, int qb,
                   int nH, int nKV, int bs, int mb, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kRows * D + 2 * D * BK + kRows * BK + 3 * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      rpa_kernel<T, PT, D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int G = nH / nKV;
  dim3 grid(C * nKV, (qb * G + kRows - 1) / kRows);
  rpa_kernel<T, PT, D, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), ksc, vsc, rows, pos0, nval,
      static_cast<T*>(out), qb, nH, nKV, bs, mb, sm_scale);
  return cudaGetLastError();
}

// ---- bf16, head dim 64 or 128, pages of 16, 32 or 48 tokens: mma.sync ------
//
// The route for pages the wgmma kernel's 64-key boxes do not tile (bs % 64
// != 0). One block of 4 warps per (chunk, kv head, 64 query rows) walks
// all of the chunk's pages; each warp owns 16 rows and keeps their q
// fragments, running max/sum and output accumulator in registers. Per key
// tile (KT keys of one page) the block stages k ([d][KT], as in the d-major
// page) and v ([KT][d]) in shared memory with 16-byte loads; S = q k^T and
// O += P v run as mma.sync m16n8k16 bf16 with fp32 accumulators, P rounded
// to bf16 for the second product as the TPU kernel rounds it.

constexpr int kTcThreads = 128;

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
__device__ __forceinline__ uint16_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 int8 values times ``s`` in fp32, rounded to bf16 (the reference's
// dequantize_int8), into two 16-byte units. Each byte is made an exact
// fp32 without a conversion instruction: w xor 0x80 in the mantissa of
// 2^23, minus 2^23 + 128 (as K9 does, quant_matmul.cu); the product is
// rounded to nearest even, two at a time (cvt.rn.bf16x2.f32).
__device__ __forceinline__ float i8_to_f(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | j)) -
         8388736.f;
}
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void dequant16_regs(const void* src, float s,
                                               uint4& lo, uint4& hi) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t in[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                          raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = bf16x2_rn(__fmul_rn(i8_to_f(in[i], 0), s),
                         __fmul_rn(i8_to_f(in[i], 1), s));
    w[2 * i + 1] = bf16x2_rn(__fmul_rn(i8_to_f(in[i], 2), s),
                             __fmul_rn(i8_to_f(in[i], 3), s));
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}
// The same, stored as two 16-byte vectors at ``dst``.
__device__ __forceinline__ void dequant16(const int8_t* src, float s,
                                          uint16_t* dst) {
  dequant16_regs(src, s, reinterpret_cast<uint4*>(dst)[0],
                 reinterpret_cast<uint4*>(dst)[1]);
}

// Q: int8 pages (kp, vp int8; ksc, vsc the scale planes), else bf16 pages.
template <int D, int KT, bool Q>
__global__ void __launch_bounds__(kTcThreads)
rpa_tc_kernel(const uint16_t* __restrict__ q, const void* __restrict__ kp,
              const void* __restrict__ vp, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ rows,
              const int* __restrict__ pos0, const int* __restrict__ nval,
              uint16_t* __restrict__ out, int qb, int nH, int nKV, int bs,
              int mb, float sm_scale) {
  constexpr int NB = KT / 8;     // n8 key blocks per tile
  constexpr int KD = D / 16;     // k16 steps over the head dim
  constexpr int ND = D / 8;      // n8 blocks over the head dim
  constexpr int KS = KT + 8;     // ks row stride (halves)
  constexpr int VS = D + 8;      // vs row stride (halves)
  __shared__ __align__(16) uint16_t ks[D * KS];
  __shared__ __align__(16) uint16_t vs[KT * VS];

  const int G = nH / nKV;
  const int c = blockIdx.x / nKV, h = blockIdx.x % nKV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_rows = qb * G;
  const int r_lo = blockIdx.y * kRows + warp * 16 + g, r_hi = r_lo + 8;
  const int p0 = pos0[c], nv = nval[c];
  const int last = p0 + nv - 1;
  const int qpos_lo = p0 + min(r_lo / G, nv - 1);
  const int qpos_hi = p0 + min(r_hi / G, nv - 1);

  const uint16_t* q_lo = r_lo < n_rows
      ? q + (((size_t)c * qb + r_lo / G) * nH + h * G + r_lo % G) * D
      : nullptr;
  const uint16_t* q_hi = r_hi < n_rows
      ? q + (((size_t)c * qb + r_hi / G) * nH + h * G + r_hi % G) * D
      : nullptr;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int d = kd * 16 + t * 2;
    qa[kd][0] = q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + d) : 0u;
    qa[kd][1] = q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + d) : 0u;
    qa[kd][2] = q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + d + 8) : 0u;
    qa[kd][3] = q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + d + 8) : 0u;
  }
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nd][r] = 0.f;
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;

  const int n_pages = min(mb, last / bs + 1);
  for (int j = 0; j < n_pages; ++j) {
    const int page = rows[c * mb + j];
    const size_t k_off = ((size_t)page * nKV + h) * D * bs;
    const size_t v_off = ((size_t)page * nKV + h) * bs * D;
    for (int t0 = 0; t0 < bs && j * bs + t0 <= last; t0 += KT) {
      if constexpr (Q) {
        const int8_t* kpg = static_cast<const int8_t*>(kp) + k_off;
        const int8_t* vpg = static_cast<const int8_t*>(vp) + v_off;
        const float k_s = ksc[(size_t)page * nKV + h];
        const float v_s = vsc[(size_t)page * nKV + h];
        for (int e = tid; e < D * KT / 16; e += kTcThreads) {
          const int d = e / (KT / 16), k16 = (e % (KT / 16)) * 16;
          dequant16(kpg + (size_t)d * bs + t0 + k16, k_s, &ks[d * KS + k16]);
        }
        for (int e = tid; e < KT * D / 16; e += kTcThreads) {
          const int key = e / (D / 16), d16 = (e % (D / 16)) * 16;
          dequant16(vpg + (size_t)(t0 + key) * D + d16, v_s,
                    &vs[key * VS + d16]);
        }
      } else {
        const uint16_t* kpg = static_cast<const uint16_t*>(kp) + k_off;
        const uint16_t* vpg = static_cast<const uint16_t*>(vp) + v_off;
        for (int e = tid; e < D * KT / 8; e += kTcThreads) {
          const int d = e / (KT / 8), k8 = (e % (KT / 8)) * 8;
          *reinterpret_cast<uint4*>(&ks[d * KS + k8]) =
              *reinterpret_cast<const uint4*>(kpg + (size_t)d * bs + t0 + k8);
        }
        for (int e = tid; e < KT * D / 8; e += kTcThreads) {
          const int key = e / (D / 8), d8 = (e % (D / 8)) * 8;
          *reinterpret_cast<uint4*>(&vs[key * VS + d8]) =
              *reinterpret_cast<const uint4*>(vpg + (size_t)(t0 + key) * D +
                                              d8);
        }
      }
      __syncthreads();
      float sc[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[nb][r] = 0.f;
        const int key = nb * 8 + g;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const int d = kd * 16 + t * 2;
          const uint32_t b0 = pack2(ks[d * KS + key], ks[(d + 1) * KS + key]);
          const uint32_t b1 =
              pack2(ks[(d + 8) * KS + key], ks[(d + 9) * KS + key]);
          mma_bf16(sc[nb], qa[kd], b0, b1);
        }
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kpos = j * bs + t0 + nb * 8 + t * 2 + (r & 1);
          const int qpos = r < 2 ? qpos_lo : qpos_hi;
          const float s = sc[nb][r] * sm_scale;
          sc[nb][r] = kpos <= qpos ? s : s + (-1e30f);
          if (r < 2) mx_lo = fmaxf(mx_lo, sc[nb][r]);
          else mx_hi = fmaxf(mx_hi, sc[nb][r]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = expf(sc[nb][r] - (r < 2 ? mn_lo : mn_hi));
          sc[nb][r] = p;
          if (r < 2) sum_lo += p;
          else sum_hi += p;
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
      }
      const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][0] *= a_lo;
        o[nd][1] *= a_lo;
        o[nd][2] *= a_hi;
        o[nd][3] *= a_hi;
      }
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        const uint32_t pa[4] = {
            pack2(bf16_bits(sc[2 * kk][0]), bf16_bits(sc[2 * kk][1])),
            pack2(bf16_bits(sc[2 * kk][2]), bf16_bits(sc[2 * kk][3])),
            pack2(bf16_bits(sc[2 * kk + 1][0]), bf16_bits(sc[2 * kk + 1][1])),
            pack2(bf16_bits(sc[2 * kk + 1][2]), bf16_bits(sc[2 * kk + 1][3]))};
        const int key = kk * 16 + t * 2;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const int d = nd * 8 + g;
          const uint32_t b0 = pack2(vs[key * VS + d], vs[(key + 1) * VS + d]);
          const uint32_t b1 =
              pack2(vs[(key + 8) * VS + d], vs[(key + 9) * VS + d]);
          mma_bf16(o[nd], pa, b0, b1);
        }
      }
      __syncthreads();
    }
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  uint16_t* o_lo = r_lo < n_rows
      ? out + (((size_t)c * qb + r_lo / G) * nH + h * G + r_lo % G) * D
      : nullptr;
  uint16_t* o_hi = r_hi < n_rows
      ? out + (((size_t)c * qb + r_hi / G) * nH + h * G + r_hi % G) * D
      : nullptr;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int d = nd * 8 + t * 2;
    if (o_lo) {
      o_lo[d] = bf16_bits(o[nd][0] / den_lo);
      o_lo[d + 1] = bf16_bits(o[nd][1] / den_lo);
    }
    if (o_hi) {
      o_hi[d] = bf16_bits(o[nd][2] / den_hi);
      o_hi[d + 1] = bf16_bits(o[nd][3] / den_hi);
    }
  }
}

template <int D, int KT, bool Q>
cudaError_t launch_tc(const void* q, const void* kp, const void* vp,
                      const float* ksc, const float* vsc, const int* rows,
                      const int* pos0, const int* nval, void* out, int C,
                      int qb, int nH, int nKV, int bs, int mb, float sm_scale,
                      cudaStream_t stream) {
  const int G = nH / nKV;
  dim3 grid(C * nKV, (qb * G + kRows - 1) / kRows);
  rpa_tc_kernel<D, KT, Q><<<grid, kTcThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), kp, vp, ksc, vsc, rows, pos0, nval,
      static_cast<uint16_t*>(out), qb, nH, nKV, bs, mb, sm_scale);
  return cudaGetLastError();
}


// ---- bf16, head dim 64 or 128, bs % 64 == 0: splits, TMA ring, wgmma -----

constexpr int kWgThreads = 128;     // one warpgroup: 64 query rows
constexpr int kTileKeys = 64;       // keys a ring stage (a TMA box)
constexpr int kSplitKeys = 1024;    // keys a split at the least
constexpr int kMaxCluster = 8;      // a portable cluster
constexpr int kBlocksPerSm = 3;
constexpr int kMaxStages = 4;
constexpr size_t kSmSmem = 233472;        // shared memory of an SM
constexpr size_t kBlockReserved = 1024;   // held back for every block
constexpr size_t kMaxSmem = 227 * 1024;   // what one block may take
constexpr int kSmemFixed = 1024 + 128;    // base alignment, barriers
constexpr int kVChunk = kTileKeys * 128;  // 64 keys x 64 values of v, bf16

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
// The combine's shared memory (it reuses the ring): acc [64][d + 8], m
// [64], l [64], the weights [kMaxCluster][64] and the denominators [64],
// fp32.
__host__ __device__ constexpr int combine_bytes(int d) {
  return 4 * (kRows * (d + 8) + 2 * kRows + kMaxCluster * kRows + kRows);
}
// A ring stage: the k box then the v box, int8 or bf16.
__host__ __device__ constexpr int stage_bytes(int d, bool quant) {
  return 2 * kTileKeys * d * (quant ? 1 : 2);
}
// K8q's dequantized tile: k [d rows][64 keys], then v in 64-value chunks
// [64 keys][64], bf16.
__host__ __device__ constexpr int tile_bytes(int d) {
  return 2 * kTileKeys * d * 2;
}

// The launch a geometry takes (ragged_paged_attention.py::rpa_plan):
// variant 2 TMA + wgmma (rpa_wg_kernel), 1 mma.sync (rpa_tc_kernel), 0 FMA
// (rpa_kernel); keys a tile; pages a split and splits (the cluster; one
// split of every page for the other variants); 64-row tiles; ring stages;
// shared bytes a block; blocks an SM by shared memory.
struct RpaPlan {
  int variant, tile_keys, pages_per_split, splits, row_tiles, stages;
  size_t smem;
  int blocks_per_sm;
};

bool rpa_plan(int mb, int bs, int D, int G, int qb, int dtype, bool quant,
              RpaPlan& p) {
  if (mb <= 0 || bs <= 0 || bs % 16 || G <= 0 || qb <= 0 ||
      (D != 64 && D != 128 && D != 256) || (dtype != 0 && dtype != 1))
    return false;
  p.row_tiles = ceil_div(qb * G, kRows);
  if (dtype == 1 && D != 256 && bs % kTileKeys == 0) {
    p.variant = 2;
    p.tile_keys = kTileKeys;
    p.pages_per_split =
        std::max(ceil_div(kSplitKeys, bs), ceil_div(mb, kMaxCluster));
    p.splits = ceil_div(mb, p.pages_per_split);
    const int tiles = p.pages_per_split * (bs / kTileKeys);
    const int extra = quant ? tile_bytes(D) : 0;
    const int budget = (int)(kSmSmem / kBlocksPerSm - kBlockReserved) -
                       kSmemFixed - extra;
    p.stages = std::min({kMaxStages, tiles, budget / stage_bytes(D, quant)});
    if (p.stages < 1) return false;
    p.smem = kSmemFixed + std::max(p.stages * stage_bytes(D, quant) + extra,
                                   combine_bytes(D));
  } else if (dtype == 1 && D != 256) {
    p.variant = 1;
    p.tile_keys = bs % 32 == 0 ? 32 : 16;
    p.pages_per_split = mb;
    p.splits = 1;
    p.stages = 1;
    p.smem = 2 * (D * (p.tile_keys + 8) + p.tile_keys * (D + 8));
  } else {
    p.variant = 0;
    p.tile_keys = bs % 32 == 0 ? 32 : 16;
    p.pages_per_split = mb;
    p.splits = 1;
    p.stages = 1;
    p.smem = sizeof(float) * (kRows * D + 2 * D * p.tile_keys +
                              kRows * p.tile_keys + 3 * kRows);
  }
  if (p.smem > kMaxSmem) return false;
  p.blocks_per_sm = (int)(kSmSmem / (p.smem + kBlockReserved));
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2(bf16_bits(lo), bf16_bits(hi));
}
// wgmma's accumulator layout (m64nN, fp32): register i of a thread holds
// row 16 w + g + 8 ((i >> 1) & 1) of the warpgroup's 64 (w the warp, g =
// lane / 4) and column acc_col(i, t) (t = lane % 4).
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// K8q: an int8 stage (k [D][64] then v [64][D] bytes, as TMA wrote them)
// times the page's scales into the bf16 tile in the 128-byte swizzle
// (16-byte unit u of a 128-byte row r at unit u ^ (r & 7)): k rows are d,
// v rows are keys in 64-value chunks.
template <int D>
__device__ __forceinline__ void dequant_tile(const unsigned char* st,
                                             unsigned char* tile, float ks,
                                             float vs, int tid) {
  constexpr int kKeyUnits = kTileKeys / 16;
  for (int e = tid; e < D * kKeyUnits; e += kWgThreads) {
    const int dd = e / kKeyUnits, u = (e % kKeyUnits) * 2;
    uint4 lo, hi;
    dequant16_regs(st + dd * kTileKeys + u * 8, ks, lo, hi);
    unsigned char* row = tile + dd * 128;
    *reinterpret_cast<uint4*>(row + ((u ^ (dd & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((u + 1) ^ (dd & 7)) << 4)) = hi;
  }
  constexpr int kDUnits = D / 16;
  const unsigned char* sv = st + kTileKeys * D;
  unsigned char* tv = tile + kTileKeys * D * 2;
  for (int e = tid; e < kTileKeys * kDUnits; e += kWgThreads) {
    const int key = e / kDUnits, d16 = (e % kDUnits) * 16;
    uint4 lo, hi;
    dequant16_regs(sv + key * D + d16, vs, lo, hi);
    unsigned char* row = tv + (d16 / 64) * kVChunk + key * 128;
    const int u = (d16 % 64) / 8;
    *reinterpret_cast<uint4*>(row + ((u ^ (key & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((u + 1) ^ (key & 7)) << 4)) = hi;
  }
}

// grid (splits, C * nKV, row tiles), clusters of (splits, 1, 1): block s
// of a cluster is split s of (chunk, kv head) blockIdx.y and 64-row tile
// blockIdx.z. kmap / vmap: the k and v pages as 4-D maps, boxes of 64
// keys x D (k) and 64 values (bf16; D bytes int8) x 64 keys (v). Q: int8
// pages with the scale planes ksc / vsc [P, nKV].
template <int D, bool Q>
__global__ void __launch_bounds__(kWgThreads, kBlocksPerSm)
rpa_wg_kernel(const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const uint16_t* __restrict__ q, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ rows,
              const int* __restrict__ pos0, const int* __restrict__ nval,
              uint16_t* __restrict__ out, int qb, int nH, int nKV, int bs,
              int mb, int pps, int stages, float sm_scale) {
  static_assert(D == 64 || D == 128, "head dim");
  constexpr int kStage = stage_bytes(D, Q);
  constexpr int kKBox = kStage / 2;          // the k box; the v box follows
  constexpr int KD = D / 16, NK = kTileKeys / 16;
  constexpr int kAccStride = D + 8;          // floats a combine row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int ring = stages * kStage + (Q ? tile_bytes(D) : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      sm + (ring > combine_bytes(D) ? ring : combine_bytes(D)));
  uint64_t* ready = full + kMaxStages;       // the partials are written
  uint64_t* done = ready + 1;                // the partials are read

  const int G = nH / nKV, n_rows = qb * G;
  const int s = blockIdx.x, splits = gridDim.x;
  const int c = blockIdx.y / nKV, h = blockIdx.y % nKV, rt = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = pos0[c], nv = nval[c], last = p0 + nv - 1;
  const int split_keys = pps * bs;
  const int n_act = min(splits, last / split_keys + 1);
  const int key0 = s * split_keys;
  const int n_tiles =
      s < n_act ? min(min(split_keys, mb * bs - key0), last - key0 + 1 +
                                                        kTileKeys - 1) /
                      kTileKeys
                : 0;
  const int tpp = bs / kTileKeys;
  const int* pages = rows + (size_t)c * mb + s * pps;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&full[i], 1);
    mbar_init(ready, n_act);
    mbar_init(done, n_act);
    mbar_init_fence();
  }
  __syncthreads();
  // tile j of the split (page j / tpp, keys (j % tpp) * 64 ..) into stage
  // j % stages
  auto issue = [&](int j) {
    const int st = j % stages, page = pages[j / tpp];
    const int t0 = (j % tpp) * kTileKeys;
    const uint32_t dst = base + st * kStage;
    mbar_expect_tx(&full[st], kStage);
    tma_load_4d(dst, &kmap, t0, 0, h, page, &full[st]);
#pragma unroll
    for (int cc = 0; cc < (Q ? 1 : D / 64); ++cc)
      tma_load_4d(dst + kKBox + cc * kVChunk, &vmap, cc * 64, t0, h, page,
                  &full[st]);
  };
  if (tid == 0)
    for (int j = 0; j < min(stages, n_tiles); ++j) issue(j);

  // this thread's query rows (lo, hi) of the 64, and q as register A
  const int row_lo = 16 * warp + g, row_hi = row_lo + 8;
  const int r_lo = rt * kRows + row_lo, r_hi = rt * kRows + row_hi;
  auto q_row = [&](int r) -> const uint16_t* {
    return r < n_rows
        ? q + (((size_t)c * qb + r / G) * nH + h * G + r % G) * D
        : nullptr;
  };
  const uint16_t* q_lo = q_row(r_lo);
  const uint16_t* q_hi = q_row(r_hi);
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int d = kd * 16 + t * 2;
    qa[kd][0] = q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + d) : 0u;
    qa[kd][1] = q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + d) : 0u;
    qa[kd][2] = q_lo ? *reinterpret_cast<const uint32_t*>(q_lo + d + 8) : 0u;
    qa[kd][3] = q_hi ? *reinterpret_cast<const uint32_t*>(q_hi + d + 8) : 0u;
  }
  const int qpos_lo = p0 + min(r_lo / G, nv - 1);
  const int qpos_hi = p0 + min(r_hi / G, nv - 1);

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();            // every block's mbarriers are initialised
  if (n_tiles == 0) return;  // past the chunk's last key: never read

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;
  const uint32_t tile_k = base + stages * kStage;   // K8q's bf16 tile
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % stages;
    mbar_wait(&full[st], (j / stages) & 1);
    uint32_t kt = base + st * kStage;
    if constexpr (Q) {
      const int page = pages[j / tpp];
      dequant_tile<D>(sm + st * kStage, sm + stages * kStage,
                      ksc[(size_t)page * nKV + h],
                      vsc[(size_t)page * nKV + h], tid);
      fence_proxy_async();   // the tile's generic writes before wgmma
      __syncthreads();       // the tile is whole; the int8 stage is free
      if (tid == 0 && j + stages < n_tiles) issue(j + stages);
      kt = tile_k;
    }
    const uint32_t vt = kt + (Q ? kTileKeys * D * 2 : kKBox);
    float sc[kTileKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)      // d rows 16 kd.. of the k box
      wgmma_rs<kTileKeys, 1>(sc, qa[kd],
                             sw128_mn_desc(kt + kd * 2048, kVChunk), kd > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // the masked online softmax of the tile, each thread its 16 columns
    // of rows lo and hi (the four threads of a row reduce the max)
    const int k0 = key0 + j * kTileKeys;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < kTileKeys / 2; ++i) {
      const int kpos = k0 + acc_col(i, t);
      const float v = sc[i] * sm_scale;
      sc[i] = kpos <= ((i & 2) ? qpos_hi : qpos_lo) ? v : v + (-1e30f);
      if (i & 2) mx_hi = fmaxf(mx_hi, sc[i]);
      else mx_lo = fmaxf(mx_lo, sc[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < kTileKeys / 2; ++i) {
      const float p = expf(sc[i] - ((i & 2) ? mn_hi : mn_lo));
      sc[i] = p;
      if (i & 2) sum_hi += p;
      else sum_lo += p;
    }
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a_hi : a_lo;
    uint32_t pa[NK][4];                  // p rounded to bf16, register A
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)      // keys 16 kk.. of the v box
      wgmma_rs<D, 1>(o, pa[kk], sw128_mn_desc(vt + kk * 2048, kVChunk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    __syncthreads();         // every warp's products have read the stage
    if (!Q && tid == 0 && j + stages < n_tiles) issue(j + stages);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {   // the row sums, whole
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  auto out_row = [&](int r) -> uint16_t* {
    return r < n_rows
        ? out + (((size_t)c * qb + r / G) * nH + h * G + r % G) * D
        : nullptr;
  };

  if (n_act == 1) {          // one split: o / l from the registers
    uint16_t* o_lo = out_row(r_lo);
    uint16_t* o_hi = out_row(r_hi);
    const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      uint16_t* dst = (i & 2) ? o_hi : o_lo;
      const float den = (i & 2) ? den_hi : den_lo;
      if (dst)
        *reinterpret_cast<uint32_t*>(dst + acc_col(i, t)) =
            pack_bf16(o[i] / den, o[i + 1] / den);
    }
    return;
  }

  // the partials into this block's shared memory (the ring is read out)
  float* acc_s = reinterpret_cast<float*>(sm);          // [64][D + 8]
  float* m_s = acc_s + kRows * kAccStride;               // [64]
  float* l_s = m_s + kRows;                              // [64]
  float* w_s = l_s + kRows;                              // [8][64]
  float* den_s = w_s + kMaxCluster * kRows;              // [64]
#pragma unroll
  for (int i = 0; i < D / 2; i += 2)
    *reinterpret_cast<float2*>(acc_s + ((i & 2) ? row_hi : row_lo) *
                                           kAccStride + acc_col(i, t)) =
        make_float2(o[i], o[i + 1]);
  if (t == 0) {
    m_s[row_lo] = m_lo;
    l_s[row_lo] = l_lo;
    m_s[row_hi] = m_hi;
    l_s[row_hi] = l_hi;
  }
  fence_cluster();
  __syncthreads();
  if (tid < n_act) mbar_arrive_cluster(ready, tid);
  mbar_wait_cluster(ready, 0);

  // rows [r0, r1) of the 64 are this block's: the splits' weights in
  // split order, then the rows' elements
  const int r0 = s * kRows / n_act, r1 = (s + 1) * kRows / n_act;
  if (tid < r1 - r0) {
    const int r = r0 + tid;
    float mr[kMaxCluster];
    float M = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_act) {
        mr[k] = *cluster.map_shared_rank(m_s + r, k);
        M = fmaxf(M, mr[k]);
      }
    float L = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_act) {
        const float w = expf(mr[k] - M);
        w_s[k * kRows + r] = w;
        L = fmaf(*cluster.map_shared_rank(l_s + r, k), w, L);
      }
    den_s[r] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  constexpr int kVecs = D / 4;
  for (int e = tid; e < (r1 - r0) * kVecs; e += kWgThreads) {
    const int r = r0 + e / kVecs, c4 = (e % kVecs) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < n_act) {
        const float w = w_s[k * kRows + r];
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc_s + r * kAccStride + c4, k));
        a.x = fmaf(x.x, w, a.x);
        a.y = fmaf(x.y, w, a.y);
        a.z = fmaf(x.z, w, a.z);
        a.w = fmaf(x.w, w, a.w);
      }
    uint16_t* dst = out_row(rt * kRows + r);
    if (dst) {
      const float den = den_s[r];
      *reinterpret_cast<uint2*>(dst + c4) =
          make_uint2(pack_bf16(a.x / den, a.y / den),
                     pack_bf16(a.z / den, a.w / den));
    }
  }
  __syncthreads();           // every read of the other blocks is done
  if (tid < n_act) mbar_arrive_cluster(done, tid);
  mbar_wait_cluster(done, 0);   // and every reader of this block's
}

// A 4-D map over pages [P, nKV, outer, inner] (inner contiguous), bf16 in
// the 128-byte swizzle or int8 unswizzled, with boxes {box_inner,
// box_outer, 1, 1}. Encoding one costs microseconds on the host, a visible
// share of a short kernel's launch, so the last 256 are kept, direct-mapped
// on their arguments, in a cache of each host thread's own.
inline bool page_map(CUtensorMap* map, const void* ptr, bool int8,
                     int inner, int outer, int nKV, int P, int box_inner,
                     int box_outer) {
  struct Entry {
    const void* ptr;
    int key[7];
    CUtensorMap map;
  };
  static thread_local Entry cache[256] = {};
  const int key[7] = {int8, inner, outer, nKV, P, box_inner, box_outer};
  uint64_t hsh = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (int k : key) hsh = hsh * 1000003u ^ (uint64_t)k;
  Entry& e = cache[(hsh ^ (hsh >> 29)) & 255];
  bool same = e.ptr == ptr;
  for (int i = 0; i < 7 && same; ++i) same = e.key[i] == key[i];
  if (!same) {
    const uint64_t el = int8 ? 1 : 2;
    const uint64_t dims[4] = {(uint64_t)inner, (uint64_t)outer,
                              (uint64_t)nKV, (uint64_t)P};
    const uint64_t strides[3] = {inner * el, inner * el * outer,
                                 inner * el * outer * nKV};
    const uint32_t box[4] = {(uint32_t)box_inner, (uint32_t)box_outer, 1,
                             1};
    if (!make_map(&e.map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  ptr, 4, dims, strides, box,
                  int8 ? CU_TENSOR_MAP_SWIZZLE_NONE
                       : CU_TENSOR_MAP_SWIZZLE_128B)) {
      e.ptr = nullptr;
      return false;
    }
    e.ptr = ptr;
    for (int i = 0; i < 7; ++i) e.key[i] = key[i];
  }
  *map = e.map;
  return true;
}

// The launch configuration of rpa_wg_kernel for plan ``p``.
struct WgLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  void set(const RpaPlan& p, int C, int nKV, cudaStream_t st) {
    cfg = {};
    cfg.gridDim = dim3(p.splits, C * nKV, p.row_tiles);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int D, bool Q>
cudaError_t wg_attr() {
  static const cudaError_t err = cudaFuncSetAttribute(
      rpa_wg_kernel<D, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  return err;
}

template <int D, bool Q>
int launch_wg(const RpaPlan& p, const void* q, const void* kp,
              const void* vp, const float* ksc, const float* vsc,
              const int* rows, const int* pos0, const int* nval, void* out,
              int C, int qb, int nH, int nKV, int bs, int mb, int P,
              float sm_scale, cudaStream_t st) {
  CUtensorMap km, vm;
  if (!page_map(&km, kp, Q, bs, D, nKV, P, kTileKeys, D) ||
      !page_map(&vm, vp, Q, D, bs, nKV, P, Q ? D : 64, kTileKeys))
    return (int)cudaErrorNotSupported;
  const cudaError_t attr = wg_attr<D, Q>();
  if (attr != cudaSuccess) return (int)attr;
  WgLaunch l;
  l.set(p, C, nKV, st);
  return (int)cudaLaunchKernelEx(
      &l.cfg, rpa_wg_kernel<D, Q>, km, vm, static_cast<const uint16_t*>(q),
      ksc, vsc, rows, pos0, nval, static_cast<uint16_t*>(out), qb, nH, nKV,
      bs, mb, p.pages_per_split, p.stages, sm_scale);
}

// The clusters of plan ``p`` that the card holds at once
// (cudaOccupancyMaxActiveClusters), into ``n``.
template <int D, bool Q>
cudaError_t wg_clusters(const RpaPlan& p, int& n) {
  const cudaError_t attr = wg_attr<D, Q>();
  if (attr != cudaSuccess) return attr;
  WgLaunch l;
  l.set(p, 1, 1, nullptr);
  return cudaOccupancyMaxActiveClusters(&n, (void*)rpa_wg_kernel<D, Q>,
                                        &l.cfg);
}

// PT: the page element type (T, or int8_t with scale planes).
template <typename T, typename PT>
cudaError_t dispatch(int d, int bs, const void* q, const void* kp,
                     const void* vp, const float* ksc, const float* vsc,
                     const int* rows, const int* pos0, const int* nval,
                     void* out, int C, int qb, int nH, int nKV, int mb,
                     float sm_scale, cudaStream_t st) {
#define RPA_CASE(DD, BKK)                                                   \
  if (d == DD && bs % BKK == 0)                                            \
    return launch<T, PT, DD, BKK>(q, kp, vp, ksc, vsc, rows, pos0, nval,   \
                                  out, C, qb, nH, nKV, bs, mb, sm_scale, st);
  RPA_CASE(64, 32) RPA_CASE(64, 16)
  RPA_CASE(128, 32) RPA_CASE(128, 16)
  RPA_CASE(256, 32) RPA_CASE(256, 16)
#undef RPA_CASE
  return cudaErrorInvalidValue;
}

// The variant rpa_plan gives the geometry, written to *variant before the
// launch; Q: int8 pages.
template <bool Q>
int forward(const void* q, const void* kp, const void* vp, const float* ksc,
            const float* vsc, const int* rows, const int* pos0,
            const int* nval, void* out, int C, int qb, int nH, int nKV, int d,
            int bs, int mb, int P, float sm_scale, int dtype,
            cudaStream_t st, int* variant) {
  if (variant == nullptr || C <= 0 || nKV <= 0 || P <= 0 || nH % nKV)
    return (int)cudaErrorInvalidValue;
  RpaPlan p;
  if (!rpa_plan(mb, bs, d, nH / nKV, qb, dtype, Q, p))
    return (int)cudaErrorInvalidValue;
  *variant = p.variant;
  using P32 = typename std::conditional<Q, int8_t, float>::type;
  using P16 = typename std::conditional<Q, int8_t, __nv_bfloat16>::type;
  if (p.variant == 2) {
    if (d == 128)
      return launch_wg<128, Q>(p, q, kp, vp, ksc, vsc, rows, pos0, nval, out,
                               C, qb, nH, nKV, bs, mb, P, sm_scale, st);
    return launch_wg<64, Q>(p, q, kp, vp, ksc, vsc, rows, pos0, nval, out, C,
                            qb, nH, nKV, bs, mb, P, sm_scale, st);
  }
  if (p.variant == 1) {
#define RPA_TC_CASE(DD, KTT)                                               \
  if (d == DD && p.tile_keys == KTT)                                       \
    return (int)launch_tc<DD, KTT, Q>(q, kp, vp, ksc, vsc, rows, pos0,     \
                                      nval, out, C, qb, nH, nKV, bs, mb,   \
                                      sm_scale, st);
    RPA_TC_CASE(128, 32) RPA_TC_CASE(128, 16)
    RPA_TC_CASE(64, 32) RPA_TC_CASE(64, 16)
#undef RPA_TC_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return (int)dispatch<float, P32>(d, bs, q, kp, vp, ksc, vsc, rows, pos0,
                                     nval, out, C, qb, nH, nKV, mb, sm_scale,
                                     st);
  return (int)dispatch<__nv_bfloat16, P16>(d, bs, q, kp, vp, ksc, vsc, rows,
                                           pos0, nval, out, C, qb, nH, nKV,
                                           mb, sm_scale, st);
}

}  // namespace

// The launch as ragged_paged_attention.py plans it (rpa_plan): out =
// {variant (0 FMA, 1 mma.sync, 2 TMA + wgmma), keys a tile, pages a
// split, splits (blocks a cluster), 64-row tiles, ring stages, shared
// bytes a block, blocks an SM by shared memory, and (wgmma, else 0) the
// clusters the card holds at once by cudaOccupancyMaxActiveClusters};
// cudaErrorInvalidValue for a geometry no variant takes. dtype as below;
// quant 1 for int8 pages.
extern "C" int rpa_plan_c(int mb, int bs, int d, int G, int qb, int dtype,
                          int quant, int* out) {
  RpaPlan p;
  if (!rpa_plan(mb, bs, d, G, qb, dtype, quant != 0, p))
    return (int)cudaErrorInvalidValue;
  int clusters = 0;
  if (p.variant == 2) {
    const cudaError_t err =
        d == 128 ? (quant ? wg_clusters<128, true>(p, clusters)
                          : wg_clusters<128, false>(p, clusters))
                 : (quant ? wg_clusters<64, true>(p, clusters)
                          : wg_clusters<64, false>(p, clusters));
    if (err != cudaSuccess) return (int)err;
  }
  const int vals[9] = {p.variant, p.tile_keys, p.pages_per_split, p.splits,
                       p.row_tiles, p.stages, (int)p.smem, p.blocks_per_sm,
                       clusters};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; P pages. Writes the variant it
// launches to *variant (rpa_plan's) and returns the launch's error
// (cudaErrorInvalidValue for a geometry no variant takes,
// cudaErrorNotSupported when no tensor map could be made).
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const int* rows,
                           const int* pos0, const int* n_valid, void* out,
                           int C, int qb, int nH, int nKV, int d, int bs,
                           int mb, int P, float sm_scale, int dtype,
                           void* stream, int* variant) {
  return forward<false>(q, k_pages, v_pages, nullptr, nullptr, rows, pos0,
                        n_valid, out, C, qb, nH, nKV, d, bs, mb, P, sm_scale,
                        dtype, static_cast<cudaStream_t>(stream), variant);
}

// K8q: int8 k/v pages with fp32 scale planes k_scales / v_scales [P, nKV];
// q and out in `dtype` as above.
extern "C" int rpa_forward_int8(const void* q, const void* k_pages,
                                const void* v_pages, const float* k_scales,
                                const float* v_scales, const int* rows,
                                const int* pos0, const int* n_valid,
                                void* out, int C, int qb, int nH, int nKV,
                                int d, int bs, int mb, int P, float sm_scale,
                                int dtype, void* stream, int* variant) {
  return forward<true>(q, k_pages, v_pages, k_scales, v_scales, rows, pos0,
                       n_valid, out, C, qb, nH, nKV, d, bs, mb, P, sm_scale,
                       dtype, static_cast<cudaStream_t>(stream), variant);
}
