// Causal flash attention on the fused qkv projection, forward (K1) and
// merged backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_kernel_native
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_bwd_fused_kernel_native
// (the fused-qkv entry flash_attention_qkv_raw). qkv is [B, S, 3*h*d]: q, k
// and v sit at lane offsets 0, H and 2H (H = h*d), head j at j*d, and are
// read in place. Forward: o [B, S, h, d] and lse [B, h, S] fp32, with
// s = (q k^T) * scale in fp32, causal fill -1e30, p = exp(s - m), l summed
// over the fp32 p, p cast to the input dtype before p v, o = acc / l and
// lse = m + log(l). Backward: dqkv [B, S, 3H] written at the same lane
// offsets (no concatenate), from p = exp(s * scale - lse) masked to 0,
// dp = do v^T, ds = p (dp - delta) cast to the input dtype, dq = ds k *
// scale, dk = ds^T q * scale, dv = cast(p)^T do. delta = rowsum(do * o) is
// computed by the caller in fp32.
//
// Design. The TPU grid walks q blocks in order with the hp-heads lane
// fusion and an 8-row lse packing, both artefacts of its (8, 128) tiling.
// Here one thread block owns one (batch, head, 64-row block): the forward
// loops over key tiles up to the causal bound (tiles wholly above the
// diagonal are never visited, so causal work is half the square) with the
// online softmax in registers. The backward is the TPU's merged form: the
// block first runs the dq loop over key tiles 0..i for its 64 query rows,
// then the dk/dv loop over query tiles i..S/64 for its 64 keys. The two
// loops are complementary under causality, so every block does S/64 + 1
// tiles, and each output element is summed by one thread in a fixed order:
// no atomics, bitwise-reproducible gradients. bf16 with head dim 64 or 128
// runs every product on the tensor cores (mma.sync m16n8k16, fp32
// accumulators, 4 warps of 16 rows); fp32, and bf16 at head dim 256, run
// CUDA-core kernels with fp32 FMAs and the same cast points.
//
// Bound on the H100. At the GPT-3 350M shape (B 16, S 1024, h 16, d 64)
// the forward moves ~134 MB and does ~34 GFLOP causal: byte-bound at
// ~0.04 ms, operation-bound close behind; the backward does ~86 GFLOP.
// Here key (query) tiles stream through a 2-stage cp.async ring and the
// products are mma.sync fed by ldmatrix, with 64-row blocks of 4 warps;
// wgmma on 128-row tiles fed by TMA, as FlashAttention-3 does, is the
// later work that closes the gap to those bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskFill = -1e30f;
constexpr int kRows = 64;   // query rows (or keys) per thread block

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
// round to T's precision: the kernels' cast points
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// ---- CUDA-core kernels: fp32, and bf16 at head dim 256 -------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaTile = 32;    // keys (or queries) per inner tile

// Stage rows [r0, r0 + n) of D values, global row stride `stride` (3H
// for a head of qkv, H for do), as floats with row pitch P.
template <typename T, int D, int P>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t stride, int r0, int n,
                                           int tid, int nthreads) {
  for (int e = tid; e < n * D; e += nthreads) {
    const int r = e / D, dd = e % D;
    dst[r * P + dd] = to_f(src[(size_t)(r0 + r) * stride + dd]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFmaThreads)
fwd_fma_kernel(const T* __restrict__ qkv, T* __restrict__ out,
               float* __restrict__ lse, int S, int h, int causal,
               float scale) {
  constexpr int P = D + 1;
  constexpr int kAcc = kRows * D / kFmaThreads;
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][P]
  float* ks = qs + kRows * P;           // [kFmaTile][P]
  float* vs = ks + kFmaTile * P;        // [kFmaTile][P]
  float* ss = vs + kFmaTile * P;        // [kRows][kFmaTile]
  float* m_s = ss + kRows * kFmaTile;   // [kRows]
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  const int q0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int H = h * D;
  const size_t row3 = 3 * (size_t)H;
  const T* base = qkv + (size_t)b * S * row3 + hh * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_rows<T, D, P>(qs, base, row3, q0, kRows, tid, kFmaThreads);
  for (int r = tid; r < kRows; r += kFmaThreads) {
    m_s[r] = kMaskFill;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int n_tiles = causal ? (q0 + kRows) / kFmaTile : S / kFmaTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFmaTile;
    stage_rows<T, D, P>(ks, base + H, row3, k0, kFmaTile, tid, kFmaThreads);
    stage_rows<T, D, P>(vs, base + 2 * H, row3, k0, kFmaTile, tid,
                        kFmaThreads);
    __syncthreads();
    for (int e = tid; e < kRows * kFmaTile; e += kFmaThreads) {
      const int r = e / kFmaTile, c = e % kFmaTile;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) s = fmaf(qs[r * P + dd], ks[c * P + dd], s);
      s *= scale;
      ss[e] = (causal && k0 + c > q0 + r) ? kMaskFill : s;
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kFmaThreads / 32) {
      float mx = ss[r * kFmaTile + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(ss[r * kFmaTile + lane] - m_new);
      ss[r * kFmaTile + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int e = tid + k * kFmaThreads;
      const int r = e / D, dd = e % D;
      float a = acc[k] * a_s[r];
#pragma unroll 8
      for (int c = 0; c < kFmaTile; ++c)
        a = fmaf(round_to<T>(ss[r * kFmaTile + c]), vs[c * P + dd], a);
      acc[k] = a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kFmaThreads;
    const int r = e / D, dd = e % D;
    out[(((size_t)b * S + q0 + r) * h + hh) * D + dd] =
        from_f<T>(acc[k] / l_s[r]);
  }
  for (int r = tid; r < kRows; r += kFmaThreads)
    lse[((size_t)b * h + hh) * S + q0 + r] = m_s[r] + logf(l_s[r]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFmaThreads)
bwd_fma_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dqkv, int S, int h, int causal, float scale) {
  constexpr int P = D + 1;
  constexpr int kAcc = kRows * D / kFmaThreads;
  extern __shared__ float smem[];
  float* a1 = smem;                     // [kRows][P]: q, then k (own)
  float* a2 = a1 + kRows * P;           // [kRows][P]: do, then v (own)
  float* t1 = a2 + kRows * P;           // [kFmaTile][P]: k, then q tile
  float* t2 = t1 + kFmaTile * P;        // [kFmaTile][P]: v, then do tile
  float* ps = t2 + kFmaTile * P;        // [kRows][kFmaTile] cast p^T
  float* ds = ps + kRows * kFmaTile;    // [kRows][kFmaTile] cast ds
  float* lse_s = ds + kRows * kFmaTile; // [kRows]
  float* dlt_s = lse_s + kRows;         // [kRows]

  const int i0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int H = h * D;
  const size_t row3 = 3 * (size_t)H;
  const T* base = qkv + (size_t)b * S * row3 + hh * D;
  const T* dob = dout + (size_t)b * S * H + hh * D;
  const float* lse_b = lse + ((size_t)b * h + hh) * S;
  const float* dlt_b = delta + ((size_t)b * h + hh) * S;
  T* dbase = dqkv + (size_t)b * S * row3 + hh * D;
  const int tid = threadIdx.x;
  float acc[kAcc], acc2[kAcc];

  // ---- dq for query rows i0.. over key tiles ----
  stage_rows<T, D, P>(a1, base, row3, i0, kRows, tid, kFmaThreads);
  stage_rows<T, D, P>(a2, dob, H, i0, kRows, tid, kFmaThreads);
  for (int r = tid; r < kRows; r += kFmaThreads) {
    lse_s[r] = lse_b[i0 + r];
    dlt_s[r] = dlt_b[i0 + r];
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  __syncthreads();
  const int n_k = causal ? (i0 + kRows) / kFmaTile : S / kFmaTile;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kFmaTile;
    stage_rows<T, D, P>(t1, base + H, row3, k0, kFmaTile, tid, kFmaThreads);
    stage_rows<T, D, P>(t2, base + 2 * H, row3, k0, kFmaTile, tid,
                        kFmaThreads);
    __syncthreads();
    for (int e = tid; e < kRows * kFmaTile; e += kFmaThreads) {
      const int r = e / kFmaTile, c = e % kFmaTile;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(a1[r * P + dd], t1[c * P + dd], s);
        dp = fmaf(a2[r * P + dd], t2[c * P + dd], dp);
      }
      float p = expf(s * scale - lse_s[r]);
      if (causal && k0 + c > i0 + r) p = 0.f;
      ds[e] = round_to<T>(p * (dp - dlt_s[r]));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int e = tid + k * kFmaThreads;
      const int r = e / D, dd = e % D;
      float a = acc[k];
#pragma unroll 8
      for (int c = 0; c < kFmaTile; ++c)
        a = fmaf(ds[r * kFmaTile + c], t1[c * P + dd], a);
      acc[k] = a;
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kFmaThreads;
    const int r = e / D, dd = e % D;
    dbase[(size_t)(i0 + r) * row3 + dd] = from_f<T>(acc[k] * scale);
  }
  __syncthreads();

  // ---- dk, dv for keys i0.. over query tiles ----
  stage_rows<T, D, P>(a1, base + H, row3, i0, kRows, tid, kFmaThreads);
  stage_rows<T, D, P>(a2, base + 2 * H, row3, i0, kRows, tid, kFmaThreads);
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = acc2[k] = 0.f;
  __syncthreads();
  for (int qt = causal ? i0 / kFmaTile : 0; qt < S / kFmaTile; ++qt) {
    const int q0 = qt * kFmaTile;
    stage_rows<T, D, P>(t1, base, row3, q0, kFmaTile, tid, kFmaThreads);
    stage_rows<T, D, P>(t2, dob, H, q0, kFmaTile, tid, kFmaThreads);
    for (int c = tid; c < kFmaTile; c += kFmaThreads) {
      lse_s[c] = lse_b[q0 + c];
      dlt_s[c] = dlt_b[q0 + c];
    }
    __syncthreads();
    for (int e = tid; e < kRows * kFmaTile; e += kFmaThreads) {
      const int r = e / kFmaTile, c = e % kFmaTile;   // key r, query c
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(a1[r * P + dd], t1[c * P + dd], s);
        dp = fmaf(a2[r * P + dd], t2[c * P + dd], dp);
      }
      float p = expf(s * scale - lse_s[c]);
      if (causal && q0 + c < i0 + r) p = 0.f;
      ps[e] = round_to<T>(p);
      ds[e] = round_to<T>(p * (dp - dlt_s[c]));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int e = tid + k * kFmaThreads;
      const int r = e / D, dd = e % D;
      float a = acc[k], a2v = acc2[k];
#pragma unroll 8
      for (int c = 0; c < kFmaTile; ++c) {
        a = fmaf(ds[r * kFmaTile + c], t1[c * P + dd], a);
        a2v = fmaf(ps[r * kFmaTile + c], t2[c * P + dd], a2v);
      }
      acc[k] = a;
      acc2[k] = a2v;
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kFmaThreads;
    const int r = e / D, dd = e % D;
    dbase[(size_t)(i0 + r) * row3 + H + dd] = from_f<T>(acc[k] * scale);
    dbase[(size_t)(i0 + r) * row3 + 2 * H + dd] = from_f<T>(acc2[k]);
  }
}

template <int D>
constexpr size_t fwd_fma_smem() {
  return sizeof(float) * ((kRows + 2 * kFmaTile) * (D + 1) +
                          kRows * kFmaTile + 3 * kRows);
}
template <int D>
constexpr size_t bwd_fma_smem() {
  return sizeof(float) * ((2 * kRows + 2 * kFmaTile) * (D + 1) +
                          2 * kRows * kFmaTile + 2 * kRows);
}

// ---- tensor-core kernels: bf16, head dim 64 or 128 -----------------------
//
// 4 warps of 16 rows; operands reach the registers by ldmatrix, and the
// next key (query) tile is copied by cp.async into the other half of a
// 2-stage ring while this tile's products run.

constexpr int kTcThreads = 128;   // 4 warps x 16 rows

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
// Four 8x8 bf16 matrices from shared memory, one row address per lane;
// .trans delivers each transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Start copying n rows of D bf16 (global row stride `stride` halves) into
// shared memory with row pitch P halves, 16 bytes a copy.
template <int D, int P>
__device__ __forceinline__ void stage_tc(uint16_t* dst, const uint16_t* src,
                                         size_t stride, int r0, int n,
                                         int tid) {
  for (int e = tid; e < n * D / 8; e += kTcThreads) {
    const int r = e / (D / 8), c8 = (e % (D / 8)) * 8;
    cp_async16(&dst[r * P + c8], src + (size_t)(r0 + r) * stride + c8);
  }
}

// C[16 x NB*8] = A[16 x D] (rows `row`.. of tile `as`) . B^T, where B's
// rows are the NB*8 rows of tile `bs` (both [.][P], contraction over D).
template <int D, int P, int NB>
__device__ __forceinline__ void dot_rows(float (&c)[NB][4], const uint16_t* as,
                                         int row, const uint16_t* bs,
                                         int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[nb][r] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4];
    ldsm_x4(a, as + (row + lane % 16) * P + kd * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < NB / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, bs + (jp * 16 + lane % 8 + (lane / 16) * 8) * P + kd * 16 +
                     ((lane / 8) % 2) * 8);
      mma_bf16(c[2 * jp], a, b[0], b[1]);
      mma_bf16(c[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x D] += X[16 x NB*8] . V[NB*8 x D], X given as C fragments (cast to
// bf16 here), V the [NB*8][P] tile `vs`.
template <int D, int P, int NB>
__device__ __forceinline__ void acc_pv(float (&acc)[D / 8][4],
                                       const float (&x)[NB][4],
                                       const uint16_t* vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t pa[4] = {
        pack2(bf16_bits(x[2 * kk][0]), bf16_bits(x[2 * kk][1])),
        pack2(bf16_bits(x[2 * kk][2]), bf16_bits(x[2 * kk][3])),
        pack2(bf16_bits(x[2 * kk + 1][0]), bf16_bits(x[2 * kk + 1][1])),
        pack2(bf16_bits(x[2 * kk + 1][2]), bf16_bits(x[2 * kk + 1][3]))};
    const uint16_t* row =
        vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * P + (lane / 16) * 8;
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, row + np * 16);
      mma_bf16(acc[2 * np], pa, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

constexpr int kFwdTile = 64;   // keys per forward tile

template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(uint16_t) * (kRows + 4 * kFwdTile) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fwd_tc_kernel(const uint16_t* __restrict__ qkv, uint16_t* __restrict__ out,
              float* __restrict__ lse, int S, int h, int causal, float scale) {
  constexpr int KT = kFwdTile, NB = KT / 8, ND = D / 8, P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem_raw);   // [kRows][P]
  uint16_t* ring = qs + kRows * P;                         // 2 x (k, v) tiles

  const int q0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int H = h * D;
  const size_t row3 = 3 * (size_t)H;
  const uint16_t* base = qkv + (size_t)b * S * row3 + hh * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;                  // the warp's rows in the block
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const int n_tiles = causal ? (q0 + kRows) / KT : S / KT;

  stage_tc<D, P>(qs, base, row3, q0, kRows, tid);
  stage_tc<D, P>(ring, base + H, row3, 0, KT, tid);
  stage_tc<D, P>(ring + KT * P, base + 2 * H, row3, 0, KT, tid);
  cp_commit();
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nd][r] = 0.f;
  float m_lo = kMaskFill, m_hi = kMaskFill, l_lo = 0.f, l_hi = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * KT;
    cp_wait_all();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      uint16_t* nxt = ring + ((kt + 1) % 2) * 2 * KT * P;
      stage_tc<D, P>(nxt, base + H, row3, k0 + KT, KT, tid);
      stage_tc<D, P>(nxt + KT * P, base + 2 * H, row3, k0 + KT, KT, tid);
      cp_commit();
    }
    const uint16_t* ks = ring + (kt % 2) * 2 * KT * P;
    const uint16_t* vs = ks + KT * P;
    float sc[NB][4];
    dot_rows<D, P, NB>(sc, qs, wr, ks, lane);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + nb * 8 + t * 2 + (r & 1);
        const float s = sc[nb][r] * scale;
        sc[nb][r] = (causal && kpos > (r < 2 ? r_lo : r_hi)) ? kMaskFill : s;
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
    l_lo = a_lo * l_lo + sum_lo;
    l_hi = a_hi * l_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= a_lo;
      o[nd][1] *= a_lo;
      o[nd][2] *= a_hi;
      o[nd][3] *= a_hi;
    }
    acc_pv<D, P, NB>(o, sc, vs, lane);
  }
  uint16_t* o_lo = out + (((size_t)b * S + r_lo) * h + hh) * D;
  uint16_t* o_hi = out + (((size_t)b * S + r_hi) * h + hh) * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int d = nd * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(o_lo + d) =
        pack2(bf16_bits(o[nd][0] / l_lo), bf16_bits(o[nd][1] / l_lo));
    *reinterpret_cast<uint32_t*>(o_hi + d) =
        pack2(bf16_bits(o[nd][2] / l_hi), bf16_bits(o[nd][3] / l_hi));
  }
  if (t == 0) {
    float* lrow = lse + ((size_t)b * h + hh) * S;
    lrow[r_lo] = m_lo + logf(l_lo);
    lrow[r_hi] = m_hi + logf(l_hi);
  }
}

template <int D> struct BwdTile { static constexpr int KT = 64; };
template <> struct BwdTile<128> { static constexpr int KT = 32; };

template <int D>
constexpr size_t bwd_tc_smem() {
  return sizeof(uint16_t) * (2 * kRows + 4 * BwdTile<D>::KT) * (D + 8) +
         sizeof(float) * 4 * BwdTile<D>::KT;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
bwd_tc_kernel(const uint16_t* __restrict__ qkv,
              const uint16_t* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              uint16_t* __restrict__ dqkv, int S, int h, int causal,
              float scale) {
  constexpr int KT = BwdTile<D>::KT, NB = KT / 8, ND = D / 8, P = D + 8;
  constexpr int kStage = 2 * KT * P;   // one (t1, t2) pair of the ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* a1 = reinterpret_cast<uint16_t*>(smem_raw);  // q, then k (own)
  uint16_t* a2 = a1 + kRows * P;                          // do, then v (own)
  uint16_t* ring = a2 + kRows * P;     // 2 x (k, v), then 2 x (q, do) tiles
  float* stats = reinterpret_cast<float*>(ring + 2 * kStage);  // 2 x (lse,
                                                                // delta)[KT]

  const int i0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int H = h * D;
  const size_t row3 = 3 * (size_t)H;
  const uint16_t* base = qkv + (size_t)b * S * row3 + hh * D;
  const uint16_t* dob = dout + (size_t)b * S * H + hh * D;
  const float* lse_b = lse + ((size_t)b * h + hh) * S;
  const float* dlt_b = delta + ((size_t)b * h + hh) * S;
  uint16_t* dbase = dqkv + (size_t)b * S * row3 + hh * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const int r_lo = i0 + wr + g, r_hi = r_lo + 8;

  // ---- dq for query rows r_lo / r_hi over key tiles ----
  const int n_k = causal ? (i0 + kRows) / KT : S / KT;
  stage_tc<D, P>(a1, base, row3, i0, kRows, tid);
  stage_tc<D, P>(a2, dob, H, i0, kRows, tid);
  stage_tc<D, P>(ring, base + H, row3, 0, KT, tid);
  stage_tc<D, P>(ring + KT * P, base + 2 * H, row3, 0, KT, tid);
  cp_commit();
  const float lse_lo = lse_b[r_lo], lse_hi = lse_b[r_hi];
  const float dl_lo = dlt_b[r_lo], dl_hi = dlt_b[r_hi];
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nd][r] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * KT;
    cp_wait_all();
    __syncthreads();
    if (kt + 1 < n_k) {
      uint16_t* nxt = ring + ((kt + 1) % 2) * kStage;
      stage_tc<D, P>(nxt, base + H, row3, k0 + KT, KT, tid);
      stage_tc<D, P>(nxt + KT * P, base + 2 * H, row3, k0 + KT, KT, tid);
      cp_commit();
    }
    const uint16_t* t1 = ring + (kt % 2) * kStage;
    const uint16_t* t2 = t1 + KT * P;
    float sc[NB][4], dp[NB][4];
    dot_rows<D, P, NB>(sc, a1, wr, t1, lane);
    dot_rows<D, P, NB>(dp, a2, wr, t2, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool lo = r < 2;
        const int kpos = k0 + nb * 8 + t * 2 + (r & 1);
        float p = expf(sc[nb][r] * scale - (lo ? lse_lo : lse_hi));
        if (causal && kpos > (lo ? r_lo : r_hi)) p = 0.f;
        sc[nb][r] = p * (dp[nb][r] - (lo ? dl_lo : dl_hi));  // ds
      }
    acc_pv<D, P, NB>(acc, sc, t1, lane);                       // ds . k
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int d = nd * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(dbase + (size_t)r_lo * row3 + d) =
        pack2(bf16_bits(acc[nd][0] * scale), bf16_bits(acc[nd][1] * scale));
    *reinterpret_cast<uint32_t*>(dbase + (size_t)r_hi * row3 + d) =
        pack2(bf16_bits(acc[nd][2] * scale), bf16_bits(acc[nd][3] * scale));
  }
  __syncthreads();

  // ---- dk, dv for keys r_lo / r_hi over query tiles ----
  const int q_first = causal ? i0 / KT : 0;
  auto stage_q = [&](int buf, int q0) {
    uint16_t* dst = ring + buf * kStage;
    stage_tc<D, P>(dst, base, row3, q0, KT, tid);
    stage_tc<D, P>(dst + KT * P, dob, H, q0, KT, tid);
    float* st = stats + buf * 2 * KT;
    for (int c = tid; c < KT / 4; c += kTcThreads) {
      cp_async16(st + c * 4, lse_b + q0 + c * 4);
      cp_async16(st + KT + c * 4, dlt_b + q0 + c * 4);
    }
  };
  stage_tc<D, P>(a1, base + H, row3, i0, kRows, tid);
  stage_tc<D, P>(a2, base + 2 * H, row3, i0, kRows, tid);
  stage_q(0, q_first * KT);
  cp_commit();
  float acc2[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nd][r] = acc2[nd][r] = 0.f;
  for (int qt = q_first; qt < S / KT; ++qt) {
    const int q0 = qt * KT, buf = (qt - q_first) % 2;
    cp_wait_all();
    __syncthreads();
    if (qt + 1 < S / KT) {
      stage_q(1 - buf, q0 + KT);
      cp_commit();
    }
    const uint16_t* t1 = ring + buf * kStage;
    const uint16_t* t2 = t1 + KT * P;
    const float* lse_t = stats + buf * 2 * KT;
    const float* dlt_t = lse_t + KT;
    float sc[NB][4], dp[NB][4];
    dot_rows<D, P, NB>(sc, a1, wr, t1, lane);    // k . q^T
    dot_rows<D, P, NB>(dp, a2, wr, t2, lane);    // v . do^T
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qc = nb * 8 + t * 2 + (r & 1);
        float p = expf(sc[nb][r] * scale - lse_t[qc]);
        if (causal && q0 + qc < (r < 2 ? r_lo : r_hi)) p = 0.f;
        sc[nb][r] = p;
        dp[nb][r] = p * (dp[nb][r] - dlt_t[qc]);   // ds^T
      }
    acc_pv<D, P, NB>(acc2, sc, t2, lane);          // p^T . do
    acc_pv<D, P, NB>(acc, dp, t1, lane);           // ds^T . q
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int d = nd * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(dbase + (size_t)r_lo * row3 + H + d) =
        pack2(bf16_bits(acc[nd][0] * scale), bf16_bits(acc[nd][1] * scale));
    *reinterpret_cast<uint32_t*>(dbase + (size_t)r_hi * row3 + H + d) =
        pack2(bf16_bits(acc[nd][2] * scale), bf16_bits(acc[nd][3] * scale));
    *reinterpret_cast<uint32_t*>(dbase + (size_t)r_lo * row3 + 2 * H + d) =
        pack2(bf16_bits(acc2[nd][0]), bf16_bits(acc2[nd][1]));
    *reinterpret_cast<uint32_t*>(dbase + (size_t)r_hi * row3 + 2 * H + d) =
        pack2(bf16_bits(acc2[nd][2]), bf16_bits(acc2[nd][3]));
  }
}

// ---- launchers -----------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t fwd_fma(const void* qkv, void* out, float* lse, dim3 grid, int S,
                    int h, int causal, float scale, cudaStream_t st) {
  const size_t smem = fwd_fma_smem<D>();
  cudaError_t err = set_smem(fwd_fma_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  fwd_fma_kernel<T, D><<<grid, kFmaThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, S, h, causal,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_fma(const void* qkv, const void* dout, const float* lse,
                    const float* delta, void* dqkv, dim3 grid, int S, int h,
                    int causal, float scale, cudaStream_t st) {
  const size_t smem = bwd_fma_smem<D>();
  cudaError_t err = set_smem(bwd_fma_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  bwd_fma_kernel<T, D><<<grid, kFmaThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqkv), S, h, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_tc(const void* qkv, void* out, float* lse, dim3 grid, int S,
                   int h, int causal, float scale, cudaStream_t st) {
  const size_t smem = fwd_tc_smem<D>();
  cudaError_t err = set_smem(fwd_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  fwd_tc_kernel<D><<<grid, kTcThreads, smem, st>>>(
      static_cast<const uint16_t*>(qkv), static_cast<uint16_t*>(out), lse, S,
      h, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_tc(const void* qkv, const void* dout, const float* lse,
                   const float* delta, void* dqkv, dim3 grid, int S, int h,
                   int causal, float scale, cudaStream_t st) {
  const size_t smem = bwd_tc_smem<D>();
  cudaError_t err = set_smem(bwd_tc_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  bwd_tc_kernel<D><<<grid, kTcThreads, smem, st>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const uint16_t*>(dout),
      lse, delta, static_cast<uint16_t*>(dqkv), S, h, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; S % 64 == 0, d in {64, 128, 256}.
// Return cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// geometry the kernels do not take).
extern "C" int flash_fwd(const void* qkv, void* out, float* lse, int B, int S,
                         int h, int d, int causal, float scale, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % kRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kRows, h, B);
#define FWD_ARGS qkv, out, lse, grid, S, h, causal, scale, st
  if (dtype == 1) {
    if (d == 64) return (int)fwd_tc<64>(FWD_ARGS);
    if (d == 128) return (int)fwd_tc<128>(FWD_ARGS);
    if (d == 256) return (int)fwd_fma<__nv_bfloat16, 256>(FWD_ARGS);
  } else if (dtype == 0) {
    if (d == 64) return (int)fwd_fma<float, 64>(FWD_ARGS);
    if (d == 128) return (int)fwd_fma<float, 128>(FWD_ARGS);
    if (d == 256) return (int)fwd_fma<float, 256>(FWD_ARGS);
  }
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd(const void* qkv, const void* dout, const float* lse,
                         const float* delta, void* dqkv, int B, int S, int h,
                         int d, int causal, float scale, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % kRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(S / kRows, h, B);
#define BWD_ARGS qkv, dout, lse, delta, dqkv, grid, S, h, causal, scale, st
  if (dtype == 1) {
    if (d == 64) return (int)bwd_tc<64>(BWD_ARGS);
    if (d == 128) return (int)bwd_tc<128>(BWD_ARGS);
    if (d == 256) return (int)bwd_fma<__nv_bfloat16, 256>(BWD_ARGS);
  } else if (dtype == 0) {
    if (d == 64) return (int)bwd_fma<float, 64>(BWD_ARGS);
    if (d == 128) return (int)bwd_fma<float, 128>(BWD_ARGS);
    if (d == 256) return (int)bwd_fma<float, 256>(BWD_ARGS);
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
