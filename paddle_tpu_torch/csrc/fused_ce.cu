// Vocab-streaming softmax cross-entropy, forward (K4) and backward (K5),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/fused_ce.py::_fwd_kernel
//   paddle_tpu/ops/pallas/fused_ce.py::_bwd_dx_kernel, _bwd_dh_kernel
// (fused_softmax_ce). x [N, H] and the head, read through its transpose
// w [V, H] (for GPT's tied head that is wte itself), share one dtype.
// Forward: per token the logits x . w^T stream through in vocab tiles with a
// running max, sum-exp and gold logit; columns >= V are -1e30; out
// nll = lse - gold and lse = m + log(l), fp32 [N]. Backward: the logits
// tile is recomputed, dl = (exp(logit - lse) - onehot) * g, masked, cast to
// the input dtype, then dx = sum over vocab tiles of dl . w and
// dw = sum over token tiles of dl^T . x, both accumulated in fp32 and cast.
//
// Design. The TPU carries its running sums and its fp32 dx / dhead
// accumulators in VMEM across a sequential grid, with vocab tiles sized to
// a 16 MB VMEM. On the card the products dominate, so both run as tiled
// products (ce_gemm_kernel: 128 x 128 output tiles, 8 warps of 64 x 32, a
// 3-stage cp.async ring of 32-deep chunks) whose epilogues do the softmax
// work:
// - forward: one product over all of x . w^T whose epilogue reduces each
//   128-column tile to per-row (max, sum of exp, gold logit); a second
//   kernel folds the tiles in order into lse and nll. No logit is stored.
// - backward: the vocab in slabs of Vc columns; per slab, dl = cast((p -
//   onehot) g) for [N, Vc], then dx += dl . w_slab (fp32, in device
//   memory) and dw_slab = dl^T . x. At most an [N, Vc] block of dl exists.
// The element type only changes the inner product of a chunk: bf16 (the
// training path) runs mma.sync m16n8k16 with fp32 accumulators on operands
// loaded by ldmatrix; fp32 (the card-vs-CPU checks) runs fp32 FMAs into the
// same accumulator layout, so both share the tiling, the epilogues and the
// fold. Every output element is summed by one thread in a fixed order, so
// there are no atomics and the gradients are bitwise reproducible.
//
// Bound on the H100: operations. At GPT-3 350M (N 16384, H 1024, V 50304)
// the forward is 2 N H V = 1.69 TFLOP (1.7 ms at the bf16 peak) against
// ~0.14 GB of unavoidable traffic; the backward needs three such products
// (5.1 ms). The tiles here are mma.sync fed by cp.async, not wgmma fed by
// TMA, and the backward writes and reads its dl slabs once more than a
// fused form would; closing that gap is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 8 warps in every kernel
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ uint16_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}
// An fp32 value stored in the operands' element type (bf16 as its bits,
// rounded to nearest even).
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) {
  *p = bf16_bits(v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- asynchronous copies and ldmatrix ------------------------------------

// 16-byte asynchronous copy global -> shared; zero fill when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same with each matrix transposed on the way into registers: for an
// operand stored with its contraction dimension as the rows.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// ---- the tiled products. The forward is one product with the EPI_STATS
// epilogue; the backward takes the vocab in slabs of Vc columns, three
// products per slab:
//   dl[N, Vc] = cast((exp(x . w_slab^T - lse) - onehot) * g)    EPI_DL
//   dx_acc   += dl . w_slab     (fp32 in device memory; the last slab
//                                writes dx in the element type) EPI_DX
//   dw_slab   = dl^T . x        (complete: its sum runs over N)  EPI_DW
// Only a [N, Vc] slab of dl exists at a time (268 MB in bf16 at N 16384,
// Vc 8192), never the [N, V] logits. Operands are loaded transposed where
// they are stored with their rows contiguous. Each output element is
// summed by one thread in a fixed order, slab after slab: deterministic.

constexpr int kGT = 128;            // output tile rows and columns
constexpr int kGK = 32;             // contraction chunk
constexpr int kGStages = 3;

// One operand stage for element type T: [kGT rows][kGK] with pitch P when
// stored K-major, [kGK][kGT rows] with pitch Q otherwise; each pitch is
// padded by 16 bytes, which keeps the 16-byte copies aligned and spreads
// ldmatrix's rows over the banks.
template <typename T> struct Geo {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int P = kGK + kVec;
  static constexpr int Q = kGT + kVec;
  static constexpr int kStage = kGT * P;        // >= kGK * Q
};

enum { EPI_DL = 0, EPI_DX = 1, EPI_DW = 2, EPI_STATS = 3 };

struct Epi {
  const float* lse;
  const int* labels;
  const float* g;
  int n_tok, V, v0;
  void* out;          // EPI_DL: the dl slab; EPI_DX (last slab): dx; EPI_DW: dw
  int ldo;            // EPI_DL: the slab's row pitch
  float* acc;         // EPI_DX: the fp32 dx accumulator [N, H]
  int first, last;    // EPI_DX: the first / last slab
  float* part;        // EPI_STATS: (max, sum-exp, gold) [3][tiles][N]
};

// One [kGT rows] x [kGK] chunk of an operand into a stage. KMAJ: stored
// [rows][K] (K contiguous); else [K][rows] (rows contiguous).
template <typename T, bool KMAJ>
__device__ __forceinline__ void load_gemm_chunk(T* st, const T* __restrict__ P,
                                                int ld, int r0, int nrows,
                                                int k0, int K) {
  using G = Geo<T>;
  constexpr int V = G::kVec;
#pragma unroll
  for (int i = 0; i < kGT * kGK / V / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (KMAJ) {
      const int r = e / (kGK / V), c = (e % (kGK / V)) * V;
      const bool ok = r0 + r < nrows && k0 + c < K;
      cp_async16(&st[r * G::P + c],
                 ok ? P + (size_t)(r0 + r) * ld + k0 + c : P, ok);
    } else {
      const int k = e / (kGT / V), c = (e % (kGT / V)) * V;
      const bool ok = k0 + k < K && r0 + c < nrows;
      cp_async16(&st[k * G::Q + c],
                 ok ? P + (size_t)(k0 + k) * ld + r0 + c : P, ok);
    }
  }
}

// One staged chunk into the warp's 64 x 32 block of the output tile:
// acc[i][j][r] is row wm + 16 i + g + 8 (r / 2), column wn + 8 j + 2 t +
// r % 2 (g = lane / 4, t = lane % 4), the mma.sync accumulator layout.
// bf16: tensor cores.
template <bool A_KMAJ, bool B_KMAJ>
__device__ __forceinline__ void chunk_product(float (&acc)[4][4][4],
                                              const uint16_t* as,
                                              const uint16_t* bs, int wm,
                                              int wn, int lane) {
  using G = Geo<uint16_t>;
#pragma unroll
  for (int kk = 0; kk < kGK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wm + i * 16;
      if (A_KMAJ)
        ldsm_x4(a[i], &as[(m + lane % 16) * G::P + kk + (lane / 16) * 8]);
      else
        ldsm_x4_trans(a[i], &as[(kk + lane % 8 + (lane / 16) * 8) * G::Q +
                                m + ((lane / 8) % 2) * 8]);
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const int n = wn + jp * 16;
      uint32_t r[4];
      if (B_KMAJ)
        ldsm_x4(r, &bs[(n + lane % 8 + (lane / 16) * 8) * G::P + kk +
                       ((lane / 8) % 2) * 8]);
      else
        ldsm_x4_trans(r, &bs[(kk + lane % 8 + ((lane / 8) % 2) * 8) * G::Q +
                             n + (lane / 16) * 8]);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// fp32: CUDA-core FMAs, one contraction step at a time, into the same
// accumulator layout.
template <bool A_KMAJ, bool B_KMAJ>
__device__ __forceinline__ void chunk_product(float (&acc)[4][4][4],
                                              const float* as,
                                              const float* bs, int wm,
                                              int wn, int lane) {
  using G = Geo<float>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int kk = 0; kk < kGK; ++kk) {
    float a[4][2], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + i * 16 + g + h * 8;
        a[i][h] = A_KMAJ ? as[m * G::P + kk] : as[kk * G::Q + m];
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = wn + j * 8 + t * 2 + q;
        b[j][q] = B_KMAJ ? bs[n * G::P + kk] : bs[kk * G::Q + n];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] = fmaf(a[i][r / 2], b[j][r % 2], acc[i][j][r]);
  }
}

// EPI_STATS: the logits tile's per-row (max, sum of exp, gold logit) over
// its 128 columns (columns >= V are -1e30), written to ep.part for
// ce_stats_reduce_kernel. The stages' shared memory is reused for the
// reduction across the 4 column warps.
__device__ __forceinline__ void stats_epilogue(const float (&acc)[4][4][4],
                                               float* red, int m0, int n0,
                                               const Epi& ep) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm + i * 16 + g + h * 8;
      const int lab = m0 + lr < ep.n_tok ? ep.labels[m0 + lr] : -1;
      float v[8], mx = -INFINITY, gold = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = n0 + wn + j * 8 + t * 2 + q;
          const float x = col < ep.V ? acc[i][j][h * 2 + q] : kMaskFill;
          v[j * 2 + q] = x;
          mx = fmaxf(mx, x);
          if (col == lab) gold += x;
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        gold += __shfl_xor_sync(0xffffffffu, gold, o);
      }
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += expf(v[e] - mx);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (t == 0) {
        float* p = red + (lr * 4 + warp % 4) * 3;
        p[0] = mx;
        p[1] = sum;
        p[2] = gold;
      }
    }
  __syncthreads();
  const size_t plane = (size_t)gridDim.x * ep.n_tok;
  for (int lr = tid; lr < kGT; lr += kThreads) {
    const int row = m0 + lr;
    if (row >= ep.n_tok) continue;
    const float* p = red + lr * 12;
    const float mx = fmaxf(fmaxf(p[0], p[3]), fmaxf(p[6], p[9]));
    float sum = 0.f, gold = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      sum += p[w * 3 + 1] * expf(p[w * 3] - mx);
      gold += p[w * 3 + 2];
    }
    const size_t o = (size_t)blockIdx.x * ep.n_tok + row;
    ep.part[o] = mx;
    ep.part[plane + o] = sum;
    ep.part[2 * plane + o] = gold;
  }
}

// Per token, fold the vocab tiles' (max, sum, gold) in tile order:
// lse = m + log(l), nll = lse - gold.
__global__ void ce_stats_reduce_kernel(const float* __restrict__ part,
                                       int tiles, int N,
                                       float* __restrict__ nll,
                                       float* __restrict__ lse) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)tiles * N;
  float m = kMaskFill, l = 0.f, gold = 0.f;
  for (int c = 0; c < tiles; ++c) {
    const size_t o = (size_t)c * N + row;
    const float mt = part[o];
    const float m_new = fmaxf(m, mt);
    l = l * expf(m - m_new) + part[plane + o] * expf(mt - m_new);
    m = m_new;
    gold += part[2 * plane + o];
  }
  const float z = m + logf(l);
  lse[row] = z;
  nll[row] = z - gold;
}

// C[M, Nn] = A . B^T over K (A's rows m, B's rows n), then the epilogue.
template <typename T, bool A_KMAJ, bool B_KMAJ, int EPI>
__global__ void __launch_bounds__(kThreads)
ce_gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B,
               int ldb, int M, int Nn, int K, Epi ep) {
  using G = Geo<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + kGStages * G::kStage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kGT, n0 = blockIdx.x * kGT;
  const int nk = (K + kGK - 1) / kGK;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) {
      load_gemm_chunk<T, A_KMAJ>(sa + s * G::kStage, A, lda, m0, M, s * kGK,
                                 K);
      load_gemm_chunk<T, B_KMAJ>(sb + s * G::kStage, B, ldb, n0, Nn, s * kGK,
                                 K);
    }
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<kGStages - 2>();
    __syncthreads();
    const int next = kc + kGStages - 1;
    if (next < nk) {
      const int st = next % kGStages;
      load_gemm_chunk<T, A_KMAJ>(sa + st * G::kStage, A, lda, m0, M,
                                 next * kGK, K);
      load_gemm_chunk<T, B_KMAJ>(sb + st * G::kStage, B, ldb, n0, Nn,
                                 next * kGK, K);
    }
    cp_commit();
    chunk_product<A_KMAJ, B_KMAJ>(acc, sa + (kc % kGStages) * G::kStage,
                                  sb + (kc % kGStages) * G::kStage, wm, wn,
                                  lane);
  }
  cp_wait<0>();
  if (EPI == EPI_STATS) {
    stats_epilogue(acc, reinterpret_cast<float*>(smem_raw), m0, n0, ep);
    return;
  }
  T* out = static_cast<T*>(ep.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + g + (r / 2) * 8;
        const int col = n0 + wn + j * 8 + t * 2 + (r % 2);
        const float v = acc[i][j][r];
        if (EPI == EPI_DL) {
          if (row >= ep.n_tok) continue;
          const int voc = ep.v0 + col;
          float d = 0.f;
          if (voc < ep.V)
            d = (expf(v - ep.lse[row]) -
                 (ep.labels[row] == voc ? 1.f : 0.f)) * ep.g[row];
          put(out + (size_t)row * ep.ldo + col, d);
        } else if (EPI == EPI_DX) {
          if (row >= M || col >= Nn) continue;
          const size_t o = (size_t)row * Nn + col;
          const float sum = (ep.first ? 0.f : ep.acc[o]) + v;
          if (ep.last) put(out + o, sum);
          else ep.acc[o] = sum;
        } else {
          if (row >= M || col >= Nn) continue;
          put(out + (size_t)(ep.v0 + row) * Nn + col, v);
        }
      }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, bool A_KMAJ, bool B_KMAJ, int EPI>
cudaError_t gemm(const T* A, int lda, const T* B, int ldb, int M, int Nn,
                 int K, dim3 grid, const Epi& ep, cudaStream_t st) {
  const size_t smem = sizeof(T) * 2 * kGStages * Geo<T>::kStage;
  cudaError_t err = cudaFuncSetAttribute(
      ce_gemm_kernel<T, A_KMAJ, B_KMAJ, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ce_gemm_kernel<T, A_KMAJ, B_KMAJ, EPI><<<grid, kThreads, smem, st>>>(
      A, lda, B, ldb, M, Nn, K, ep);
  return cudaGetLastError();
}

// The forward: the logits tiles' statistics, then their fold.
template <typename T>
cudaError_t fwd(const T* x, const T* w, const int* labels, float* nll,
                float* lse, float* part, int N, int H, int V,
                cudaStream_t st) {
  Epi ep{};
  ep.labels = labels;
  ep.n_tok = N;
  ep.V = V;
  ep.part = part;
  const int tiles = cdiv(V, kGT);
  cudaError_t err = gemm<T, true, true, EPI_STATS>(
      x, H, w, H, N, V, H, dim3(tiles, cdiv(N, kGT)), ep, st);
  if (err != cudaSuccess) return err;
  ce_stats_reduce_kernel<<<cdiv(N, 256), 256, 0, st>>>(part, tiles, N, nll,
                                                      lse);
  return cudaGetLastError();
}

// The backward, slab by slab (see ce_gemm_kernel).
template <typename T>
cudaError_t bwd(const T* x, const T* w, const int* labels, const float* lse,
                const float* g, T* dx, T* dw, T* dl, float* acc, int N,
                int H, int V, int Vc, cudaStream_t st) {
  for (int v0 = 0; v0 < V; v0 += Vc) {
    const int wc = V - v0 < Vc ? V - v0 : Vc;     // vocab rows in the slab
    const int wp = cdiv(wc, kGT) * kGT;           // dl columns written
    Epi ep{lse, labels, g, N, V, v0, dl, Vc, acc, v0 == 0, v0 + Vc >= V,
           nullptr};
    const T* ws = w + (size_t)v0 * H;
    cudaError_t err = gemm<T, true, true, EPI_DL>(
        x, H, ws, H, N, wc, H, dim3(wp / kGT, cdiv(N, kGT)), ep, st);
    if (err != cudaSuccess) return err;
    ep.out = dx;
    err = gemm<T, true, false, EPI_DX>(dl, Vc, ws, H, N, H, wc,
                                       dim3(H / kGT, cdiv(N, kGT)), ep, st);
    if (err != cudaSuccess) return err;
    ep.out = dw;
    err = gemm<T, false, false, EPI_DW>(dl, Vc, x, H, wc, H, N,
                                        dim3(H / kGT, cdiv(wc, kGT)), ep, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool bad_shape(int N, int H, int V) {
  return N <= 0 || H <= 0 || H % 128 != 0 || V <= 0 || V % 8 != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x [N, H], w [V, H] row-major, labels
// int32 [N]; H % 128 == 0 and V % 8 == 0. Each entry returns
// cudaGetLastError() after its launches.
// nll, lse fp32 [N]; part, a [3, ceil(V / 128), N] fp32 scratch for the
// tiles' statistics. Two launches.
extern "C" int ce_fwd(const void* x, const void* w, const int* labels,
                      float* nll, float* lse, float* part, int N, int H,
                      int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, H, V)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)fwd(static_cast<const float*>(x),
                    static_cast<const float*>(w), labels, nll, lse, part, N,
                    H, V, st);
  if (dtype == 1)
    return (int)fwd(static_cast<const uint16_t*>(x),
                    static_cast<const uint16_t*>(w), labels, nll, lse, part,
                    N, H, V, st);
  return (int)cudaErrorInvalidValue;
}

// dx [N, H] and dw [V, H] in x's dtype; dl, an [N, Vc] scratch slab in
// x's dtype (Vc % 128 == 0), and acc, an [N, H] fp32 scratch (unused when
// one slab covers V). Three launches per slab of Vc vocab columns.
extern "C" int ce_bwd(const void* x, const void* w, const int* labels,
                      const float* lse, const float* g, void* dx, void* dw,
                      void* dl, float* acc, int N, int H, int V, int Vc,
                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, H, V) || Vc <= 0 || Vc % kGT != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd(static_cast<const float*>(x),
                    static_cast<const float*>(w), labels, lse, g,
                    static_cast<float*>(dx), static_cast<float*>(dw),
                    static_cast<float*>(dl), acc, N, H, V, Vc, st);
  if (dtype == 1)
    return (int)bwd(static_cast<const uint16_t*>(x),
                    static_cast<const uint16_t*>(w), labels, lse, g,
                    static_cast<uint16_t*>(dx), static_cast<uint16_t*>(dw),
                    static_cast<uint16_t*>(dl), acc, N, H, V, Vc, st);
  return (int)cudaErrorInvalidValue;
}
