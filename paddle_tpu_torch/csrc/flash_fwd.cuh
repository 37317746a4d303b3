// The causal flash forward shared by K1 (flash_attention.cu: the fused-qkv
// entry and the separate-q/k/v entry) and K11 (fused_rope_attention.cu: the
// same tile loop with RoPE applied to q, and optionally k, at the tile
// load), and the tile helpers that K2's backward uses as well.
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_kernel_native
//   paddle_tpu/ops/pallas/fused_rope_attention.py::_rope_flash_fwd_kernel
// o [B, S, h, d] and lse [B, h, S] fp32 (optional), with s = (q k^T) * scale
// in fp32, causal fill -1e30, p = exp(s - m), l summed over the fp32 p, p
// cast to the input dtype before p v, o = acc / l and lse = m + log(l).
//
// Operands. q, k, v and o each have h heads of d values per sequence row,
// with their own row, head and batch strides: the fused qkv projection is
// three views of one [B, S, 3*h*d] buffer (row stride 3hd, head stride d),
// separate [B, S, h, d] tensors have row stride hd and head stride d, and
// head-major [B, h, S, d] tensors (K17) row stride d and head stride S*d.
// The strides only place the rows: every layout runs the same tile loop,
// so they give the same bits on the same values.
//
// Design. One thread block owns one (batch, head, 64-row block) and loops
// over key tiles up to the causal bound (tiles wholly above the diagonal
// are never visited) with the online softmax in registers. bf16 with head
// dim 64 or 128 runs every product on the tensor cores (mma.sync
// m16n8k16, fp32 accumulators, 4 warps of 16 rows, a 2-stage cp.async ring
// of key tiles); fp32, and bf16 at head dim 256, run a CUDA-core kernel with
// fp32 FMAs and the same cast points.
//
// RoPE in the tile. With the full-width tables C = [cos, cos] and
// S = [-sin, sin] ([S, d] fp32, row = sequence position), a row x becomes
// x * C + swap(x) * S, swap(x) = [x2, x1]: each product and the sum are
// rounded on their own (__fmul_rn / __fadd_rn, no fma contraction) and the
// result is rounded to the input dtype, so the rotated tile is bit for bit
// what the eager apply_rope writes (x1*cos - x2*sin is x1*cos + x2*(-sin)
// in IEEE). q is rotated once per block, k once per tile it is read: the
// rotated tensors never reach device memory.
#pragma once

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

// One element of the rotation: x * c + xs * s, each step rounded.
__device__ __forceinline__ float rope1(float x, float xs, float c, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(xs, s));
}

// Forward operands of one launch.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  long long row_q, row_k, row_v;        // elements between sequence rows
  long long head_q, head_k, head_v;     // elements between heads
  long long batch_q, batch_k, batch_v;  // elements between batches
  void* out;
  long long row_o, head_o, batch_o;     // out's strides
  float* lse;                           // [B, h, S] fp32, or nullptr
  const float* cos_f;                   // [S, d] full-width tables (RoPE)
  const float* sin_f;
  int S, h, causal;
  float scale;
};

// ---- CUDA-core kernels: fp32, and bf16 at head dim 256 -------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaTile = 32;    // keys (or queries) per inner tile

// Stage rows [r0, r0 + n) of D values, global row stride `stride`, as
// floats with row pitch P; with `rope`, rotated by the tables' rows r0...
template <typename T, int D, int P, bool ROPE = false>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t stride, int r0, int n,
                                           int tid, int nthreads,
                                           const float* cos_f = nullptr,
                                           const float* sin_f = nullptr) {
  for (int e = tid; e < n * D; e += nthreads) {
    const int r = e / D, dd = e % D;
    const T* row = src + (size_t)(r0 + r) * stride;
    float x = to_f(row[dd]);
    if (ROPE) {
      const int sw = dd < D / 2 ? dd + D / 2 : dd - D / 2;
      const size_t t = (size_t)(r0 + r) * D + dd;
      x = round_to<T>(rope1(x, to_f(row[sw]), cos_f[t], sin_f[t]));
    }
    dst[r * P + dd] = x;
  }
}

template <typename T, int D, bool RQ, bool RK>
__global__ void __launch_bounds__(kFmaThreads)
fwd_fma_kernel(const FwdArgs a) {
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
  const int S = a.S, h = a.h, causal = a.causal;
  const float scale = a.scale;
  const T* qb = static_cast<const T*>(a.q) + b * a.batch_q + hh * a.head_q;
  const T* kb = static_cast<const T*>(a.k) + b * a.batch_k + hh * a.head_k;
  const T* vb = static_cast<const T*>(a.v) + b * a.batch_v + hh * a.head_v;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_rows<T, D, P, RQ>(qs, qb, a.row_q, q0, kRows, tid, kFmaThreads,
                          a.cos_f, a.sin_f);
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
    stage_rows<T, D, P, RK>(ks, kb, a.row_k, k0, kFmaTile, tid, kFmaThreads,
                            a.cos_f, a.sin_f);
    stage_rows<T, D, P>(vs, vb, a.row_v, k0, kFmaTile, tid, kFmaThreads);
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
      float acc_k = acc[k] * a_s[r];
#pragma unroll 8
      for (int c = 0; c < kFmaTile; ++c)
        acc_k = fmaf(round_to<T>(ss[r * kFmaTile + c]), vs[c * P + dd], acc_k);
      acc[k] = acc_k;
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kFmaThreads;
    const int r = e / D, dd = e % D;
    out[b * a.batch_o + (q0 + r) * a.row_o + hh * a.head_o + dd] =
        from_f<T>(acc[k] / l_s[r]);
  }
  if (a.lse != nullptr)
    for (int r = tid; r < kRows; r += kFmaThreads)
      a.lse[((size_t)b * h + hh) * S + q0 + r] = m_s[r] + logf(l_s[r]);
}

template <int D>
constexpr size_t fwd_fma_smem() {
  return sizeof(float) * ((kRows + 2 * kFmaTile) * (D + 1) +
                          kRows * kFmaTile + 3 * kRows);
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
__device__ __forceinline__ float bf16_val(uint16_t u) {
  return __bfloat162float(__ushort_as_bfloat16(u));
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

// Rotate n staged bf16 rows in place (rows of sequence positions r0...);
// each thread owns the pairs (c, c + D/2) it rewrites.
template <int D, int P>
__device__ __forceinline__ void rope_tc(uint16_t* t, int r0, int n,
                                        const float* cos_f,
                                        const float* sin_f, int tid) {
  constexpr int Hd = D / 2;
  for (int e = tid; e < n * Hd; e += kTcThreads) {
    const int r = e / Hd, c = e % Hd;
    uint16_t* row = t + r * P;
    const float x1 = bf16_val(row[c]), x2 = bf16_val(row[c + Hd]);
    const size_t o = (size_t)(r0 + r) * D;
    row[c] = bf16_bits(rope1(x1, x2, cos_f[o + c], sin_f[o + c]));
    row[c + Hd] = bf16_bits(rope1(x2, x1, cos_f[o + c + Hd],
                                  sin_f[o + c + Hd]));
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

template <int D, bool RQ, bool RK>
__global__ void __launch_bounds__(kTcThreads)
fwd_tc_kernel(const FwdArgs a) {
  constexpr int KT = kFwdTile, NB = KT / 8, ND = D / 8, P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem_raw);   // [kRows][P]
  uint16_t* ring = qs + kRows * P;                         // 2 x (k, v) tiles

  const int q0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, h = a.h, causal = a.causal;
  const float scale = a.scale;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + b * a.batch_q +
                       hh * a.head_q;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + b * a.batch_k +
                       hh * a.head_k;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + b * a.batch_v +
                       hh * a.head_v;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;                  // the warp's rows in the block
  const int r_lo = q0 + wr + g, r_hi = r_lo + 8;
  const int n_tiles = causal ? (q0 + kRows) / KT : S / KT;

  stage_tc<D, P>(qs, qb, a.row_q, q0, kRows, tid);
  stage_tc<D, P>(ring, kb, a.row_k, 0, KT, tid);
  stage_tc<D, P>(ring + KT * P, vb, a.row_v, 0, KT, tid);
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
      stage_tc<D, P>(nxt, kb, a.row_k, k0 + KT, KT, tid);
      stage_tc<D, P>(nxt + KT * P, vb, a.row_v, k0 + KT, KT, tid);
      cp_commit();
    }
    uint16_t* ks = ring + (kt % 2) * 2 * KT * P;
    const uint16_t* vs = ks + KT * P;
    if (RQ || RK) {
      if (RQ && kt == 0) rope_tc<D, P>(qs, q0, kRows, a.cos_f, a.sin_f, tid);
      if (RK) rope_tc<D, P>(ks, k0, KT, a.cos_f, a.sin_f, tid);
      __syncthreads();
    }
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
  uint16_t* out = static_cast<uint16_t*>(a.out) + b * a.batch_o +
                  hh * a.head_o;
  uint16_t* o_lo = out + r_lo * a.row_o;
  uint16_t* o_hi = out + r_hi * a.row_o;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int d = nd * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(o_lo + d) =
        pack2(bf16_bits(o[nd][0] / l_lo), bf16_bits(o[nd][1] / l_lo));
    *reinterpret_cast<uint32_t*>(o_hi + d) =
        pack2(bf16_bits(o[nd][2] / l_hi), bf16_bits(o[nd][3] / l_hi));
  }
  if (t == 0 && a.lse != nullptr) {
    float* lrow = a.lse + ((size_t)b * h + hh) * S;
    lrow[r_lo] = m_lo + logf(l_lo);
    lrow[r_hi] = m_hi + logf(l_hi);
  }
}

// ---- launchers -----------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D, bool RQ, bool RK>
cudaError_t fwd_fma(const FwdArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem = fwd_fma_smem<D>();
  cudaError_t err = set_smem(fwd_fma_kernel<T, D, RQ, RK>, smem);
  if (err != cudaSuccess) return err;
  fwd_fma_kernel<T, D, RQ, RK><<<grid, kFmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D, bool RQ, bool RK>
cudaError_t fwd_tc(const FwdArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem = fwd_tc_smem<D>();
  cudaError_t err = set_smem(fwd_tc_kernel<D, RQ, RK>, smem);
  if (err != cudaSuccess) return err;
  fwd_tc_kernel<D, RQ, RK><<<grid, kTcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// One forward launch over a B x h x S/64 grid. dtype: 0 = float32,
// 1 = bfloat16; S % 64 == 0; d in {64, 128, 256} without RoPE and in
// {128, 256} with it. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a geometry the kernels do not take).
template <bool RQ, bool RK>
int flash_fwd_launch(const FwdArgs& a, int B, int d, int dtype,
                     cudaStream_t st) {
  if (a.S % kRows || a.S <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.S / kRows, a.h, B);
  if constexpr (!RQ && !RK) {
    if (d == 64 && dtype == 1) return (int)fwd_tc<64, RQ, RK>(a, grid, st);
    if (d == 64 && dtype == 0)
      return (int)fwd_fma<float, 64, RQ, RK>(a, grid, st);
  }
  if (dtype == 1) {
    if (d == 128) return (int)fwd_tc<128, RQ, RK>(a, grid, st);
    if (d == 256) return (int)fwd_fma<__nv_bfloat16, 256, RQ, RK>(a, grid, st);
  } else if (dtype == 0) {
    if (d == 128) return (int)fwd_fma<float, 128, RQ, RK>(a, grid, st);
    if (d == 256) return (int)fwd_fma<float, 256, RQ, RK>(a, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
