// Unified ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/ragged_paged_attention.py::_rpa_kernel
// (launched by ragged_paged_attention_kernel). Same contract: q [C, qb, nH, d];
// d-major k pages [P, nKV, d, bs]; v pages [P, nKV, bs, d]; rows [C, mb],
// pos0 [C], n_valid [C] int32. Query row r of chunk c is token r / G, group
// head r % G (G = nH / nKV), so a page is read once for all G heads that
// share it. Row i attends keys kpos <= pos0 + min(i, n_valid - 1): padding
// rows repeat the last valid row. Masked scores are s + (-1e30); the output
// is acc / max(l, 1e-30).
//
// K8q, the int8-page arm of the same TPU kernel (quant=True,
// serving_kv_quant): int8 pages of the same layouts with fp32 scale planes
// k_scales / v_scales [P, nKV]. Each int8 tile element is multiplied in
// fp32 by its page's scale, scales[rows[c, j] * nKV + h], and rounded to
// the q dtype as it is staged in shared memory (ops/quant.py::
// dequantize_int8, the TPU kernel's order); the rest of each kernel is the
// fp pages' code. Run on pages dequantized beforehand, K8 gives the same
// bits. int8 tiles have their own 16-byte loader: a d x 32 tile of int8 is
// half the bytes of the bf16 one.
//
// Design. The TPU grid walks (chunk, kv-head, page) in order and carries the
// online-softmax state in scratch between grid steps. Blocks on a GPU run in
// no order, so one thread block owns one (chunk, kv-head, 64-row tile) and
// loops over the chunk's pages itself, stopping at the last page that holds
// a key at or before the chunk's last valid position (skipped keys would be
// fully masked: exp(-1e30 - m) == 0 in fp32, so skipping is exact). Keys
// are staged through shared memory one tile of a page at a time. Two
// kernels: bf16 with head dim 64 or 128 (the engine's case) runs both dots
// on the tensor cores (mma.sync, rpa_tc_kernel); fp32, and bf16 at head dim
// 256, run a CUDA-core kernel with fp32 FMAs (rpa_kernel).
//
// Bound on the H100: bytes. Each chunk reads its pages once per kv head
// (2 * ctx * d * itemsize bytes per (chunk, kv head)) and does ~4 * G * qb
// flops per byte read, far under the ~295 flop/byte at which bf16 tensor
// cores would be the limit. This version still computes padding rows (the
// output contract pins them), loads each tile synchronously (no cp.async or
// TMA ring overlapping loads with the dots) and runs one block per
// (chunk, kv head) however long the context; splitting long contexts across
// blocks and pipelining the page loads is later work. int8 pages halve
// the page bytes, the term that dominates.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ---- bf16, head dim 64 or 128: tensor cores -------------------------------
//
// One block of 4 warps per (chunk, kv head, 64 query rows); each warp owns
// 16 rows and keeps their q fragments, running max/sum and output
// accumulator in registers, FlashAttention-2 style. Per key tile (KT keys
// of one page) the block stages k ([d][KT], as in the d-major page) and v
// ([KT][d]) in shared memory with 16-byte loads; S = q k^T and O += P v run
// as mma.sync m16n8k16 bf16 with fp32 accumulators, P rounded to bf16 for
// the second product as the TPU kernel rounds it.

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

// 16 int8 page values (16 bytes) times the page's scale in fp32, rounded
// to bf16 and stored as two 16-byte vectors.
__device__ __forceinline__ void dequant16(const int8_t* src, float s,
                                          uint16_t* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack2(bf16_bits(__fmul_rn((float)v[2 * i], s)),
                 bf16_bits(__fmul_rn((float)v[2 * i + 1], s)));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
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

// bf16 q at head dim 64 or 128 runs the tensor-core kernel, everything
// else (fp32, d 256) the FMA one; Q: int8 pages.
template <bool Q>
int forward(const void* q, const void* kp, const void* vp, const float* ksc,
            const float* vsc, const int* rows, const int* pos0,
            const int* nval, void* out, int C, int qb, int nH, int nKV, int d,
            int bs, int mb, float sm_scale, int dtype, cudaStream_t st) {
  using P32 = typename std::conditional<Q, int8_t, float>::type;
  using P16 = typename std::conditional<Q, int8_t, __nv_bfloat16>::type;
  if (dtype == 0)
    return (int)dispatch<float, P32>(d, bs, q, kp, vp, ksc, vsc, rows, pos0,
                                     nval, out, C, qb, nH, nKV, mb, sm_scale,
                                     st);
  if (dtype == 1 && (d == 64 || d == 128)) {
#define RPA_TC_CASE(DD, KTT)                                               \
  if (d == DD && bs % KTT == 0)                                            \
    return (int)launch_tc<DD, KTT, Q>(q, kp, vp, ksc, vsc, rows, pos0,     \
                                      nval, out, C, qb, nH, nKV, bs, mb,   \
                                      sm_scale, st);
    RPA_TC_CASE(128, 32) RPA_TC_CASE(128, 16)
    RPA_TC_CASE(64, 32) RPA_TC_CASE(64, 16)
#undef RPA_TC_CASE
  }
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16, P16>(d, bs, q, kp, vp, ksc, vsc,
                                             rows, pos0, nval, out, C, qb, nH,
                                             nKV, mb, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a geometry the kernel does not take).
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const int* rows,
                           const int* pos0, const int* n_valid, void* out,
                           int C, int qb, int nH, int nKV, int d, int bs,
                           int mb, float sm_scale, int dtype, void* stream) {
  return forward<false>(q, k_pages, v_pages, nullptr, nullptr, rows, pos0,
                        n_valid, out, C, qb, nH, nKV, d, bs, mb, sm_scale,
                        dtype, static_cast<cudaStream_t>(stream));
}

// K8q: int8 k/v pages with fp32 scale planes k_scales / v_scales [P, nKV];
// q and out in `dtype` as above.
extern "C" int rpa_forward_int8(const void* q, const void* k_pages,
                                const void* v_pages, const float* k_scales,
                                const float* v_scales, const int* rows,
                                const int* pos0, const int* n_valid,
                                void* out, int C, int qb, int nH, int nKV,
                                int d, int bs, int mb, float sm_scale,
                                int dtype, void* stream) {
  return forward<true>(q, k_pages, v_pages, k_scales, v_scales, rows, pos0,
                       n_valid, out, C, qb, nH, nKV, d, bs, mb, sm_scale,
                       dtype, static_cast<cudaStream_t>(stream));
}
