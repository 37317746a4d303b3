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
// products whose epilogues do the softmax work:
// - forward: one product over all of x . w^T whose epilogue reduces each
//   vocab tile to per-row (max, sum of exp, gold logit); a second kernel
//   folds the tiles in order into lse and nll. No logit is stored.
// - backward: the vocab in slabs of Vc columns; per slab, dl = cast((p -
//   onehot) g) for [N, Vc], then dx += dl . w_slab (fp32, in device
//   memory) and dw_slab = dl^T . x. At most an [N, Vc] block of dl exists.
// Every output element is summed by one thread in a fixed order, so there
// are no atomics and the gradients are bitwise reproducible.
//
// The bf16 route (the training path), ce_wg_kernel: a persistent block a
// SM walks the product's 128 x BN output tiles (BN 256, or 128 where 256
// fills less than a wave and 128 takes less time; ce_plan in
// ops/kernels/fused_ce.py) in
// the plan's order, with three warpgroups:
// - warpgroup 2 is the producer: one thread keeps a ring of 4 (BN 256) or
//   6 (BN 128) stages full with TMA loads of 64 x 64 boxes, 64 deep in the
//   contraction (a 128-byte row), 128-byte swizzled, on full/empty
//   mbarriers; TMA writes zeros past each operand's edges, so ragged N, V
//   and slabs need no masks in the loop;
// - warpgroups 0 and 1 each own 64 rows of the tile: wgmma m64nBNk16 with
//   both operands read from shared memory through descriptors and fp32
//   accumulators in registers. The four products' operands lie in three
//   layouts, all taken as stored: x and w K-major (EPI_STATS, EPI_DL:
//   x . w^T), w_slab MN-major (EPI_DX: dl . w_slab, imm-trans-b), and both
//   MN-major (EPI_DW: dl^T . x, imm-trans-a and imm-trans-b, which 16-bit
//   types allow in the shared-memory form). Nothing is transposed in
//   device memory or in registers;
// - a stage is released as soon as the products that read it have
//   finished, so the producer fills the ring with the next tile's stages
//   while the consumers run the epilogue; dl leaves through a 2 KB
//   staging tile a warp, in 16-byte stores of whole 128-byte rows (4-byte
//   stores straight from the accumulators cost K5 ~0.5-1 ms);
// - setmaxnreg gives the consumers 232 registers and the producer 40; the
//   launcher checks ptxas's allocation at entry first (check_entry_regs).
// The order: the tile index along the operand that fits in L2 runs
// fastest (the columns when w's slab or x is the smaller operand), so the
// larger operand streams from device memory once.
//
// The fp32 route (the card-vs-CPU checks), ce_fma_kernel: 128 x 128
// output tiles over 8 warps of 64 x 32, a 3-stage cp.async ring of
// 32-deep chunks, fp32 FMAs; the same epilogues in the mma.sync
// accumulator layout.
//
// Bound on the H100: operations. At GPT-3 350M (N 16384, H 1024, V 50304)
// the forward is 2 N H V = 1.69 TFLOP (1.7 ms at the bf16 peak) against
// ~0.14 GB of unavoidable traffic; the backward needs three such products
// (5.1 ms), and writes its dl slabs once and reads them twice on top.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps, setmaxnreg

namespace {

constexpr float kMaskFill = -1e30f;

enum { EPI_DL = 0, EPI_DX = 1, EPI_DW = 2, EPI_STATS = 3 };

struct Epi {
  const float* lse;
  const int* labels;
  const float* g;
  int n_tok, V, v0;
  void* out;          // EPI_DL: the dl slab; EPI_DX (last slab): dx;
                      // EPI_DW: dw
  int ldo;            // EPI_DL: the slab's row pitch
  float* acc;         // EPI_DX: the fp32 dx accumulator [N, H]
  int first, last;    // EPI_DX: the first / last slab
  float* part;        // EPI_STATS: (max, sum-exp, gold) [3][tiles][N]
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

// ---- the bf16 route: a persistent TMA ring feeding wgmma -----------------

constexpr int kWgBM = 128;          // rows of C a tile: 2 consumer warpgroups
constexpr int kWgBK = 64;           // contraction a stage: a 128-byte row
constexpr int kBox = 64;            // TMA boxes of 64 x 64 bf16
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kWgMaxStages = 8;
constexpr int kWgThreads = 384;     // 2 consumer warpgroups, 1 producer
constexpr int kRegsAtEntry = 168;   // 65536 / 384, what ptxas gives
constexpr int kRegsProducer = 40;   // setmaxnreg after the role split:
constexpr int kRegsConsumer = 232;  // 128 x 40 + 256 x 232 <= 384 x 168
static_assert(128 * kRegsProducer + 256 * kRegsConsumer <=
              kWgThreads * kRegsAtEntry, "setmaxnreg over the block's pool");
constexpr int kSmemMax = 232448;    // 227 KB a block
// dl's staging: a [16 rows][64 columns] bf16 tile a consumer warp (2 KB)
constexpr int kDlStaging = 2048;
constexpr int kSmemFixed =             // alignment, barriers, dl staging
    1024 + 16 * kWgMaxStages + 8 * kDlStaging;

// Column of accumulator i of a thread (t = lane % 4) in the wgmma layout;
// its row is 16 warp + lane / 4, + 8 when i & 2.
__device__ __forceinline__ int wg_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// The origin of tile ``tile`` among mt x nt tiles: with raster_n the
// column tiles of a row of tiles are consecutive, else the row tiles of a
// column.
__device__ __forceinline__ void wg_place(int tile, int mt, int nt,
                                         int raster_n, int bn, int& m0,
                                         int& n0) {
  m0 = (raster_n ? tile / nt : tile % mt) * kWgBM;
  n0 = (raster_n ? tile % nt : tile / mt) * bn;
}

// C[M, Nn] = A . B^T over K, then the epilogue, tile after tile. A is
// [M][K] (TA 0) or [K][M] (TA 1) in ``amap``, B [Nn][K] (TB 0) or [K][Nn]
// (TB 1) in ``bmap``; both maps have 64 x 64 boxes in the 128-byte
// swizzle. Stage s: A's 128 rows (two boxes: K-major rows 64 c.., or
// MN-major m 64 c..), then B's BN (BN / 64 boxes); each box is a swizzled
// [64][128 bytes] atom run, so a warpgroup's A slice starts 8 KB on.
template <int BN, int TA, int TB, int EPI>
__global__ void __launch_bounds__(kWgThreads, 1)
ce_wg_kernel(const __grid_constant__ CUtensorMap amap,
             const __grid_constant__ CUtensorMap bmap, int M, int Nn, int K,
             int stages, int raster_n, Epi ep) {
  constexpr int kA = kWgBM * kWgBK * 2;
  constexpr int kStage = kA + BN * kWgBK * 2;
  constexpr int NA = BN / 2;          // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + (size_t)stages * kStage);
  uint64_t* empty = full + kWgMaxStages;
  unsigned char* staging = reinterpret_cast<unsigned char*>(empty +
                                                            kWgMaxStages);
  const int tid = threadIdx.x;
  const int mt = (M + kWgBM - 1) / kWgBM, nt = (Nn + BN - 1) / BN;
  const int tiles = mt * nt, nk = (K + kWgBK - 1) / kWgBK;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // the consumers' eight warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {                     // producer warpgroup
    setmaxnreg_dec<kRegsProducer>();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        wg_place(tile, mt, nt, raster_n, BN, m0, n0);
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % stages;
          mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          const uint32_t a = base + (uint32_t)(s * kStage), b = a + kA;
          const int k0 = kc * kWgBK;
          mbar_expect_tx(&full[s], kStage);
#pragma unroll
          for (int c = 0; c < kWgBM / kBox; ++c) {
            if (TA)
              tma_load_2d(a + c * kBoxBytes, &amap, m0 + c * kBox, k0,
                          &full[s]);
            else
              tma_load_2d(a + c * kBoxBytes, &amap, k0, m0 + c * kBox,
                          &full[s]);
          }
#pragma unroll
          for (int c = 0; c < BN / kBox; ++c) {
            if (TB)
              tma_load_2d(b + c * kBoxBytes, &bmap, n0 + c * kBox, k0,
                          &full[s]);
            else
              tma_load_2d(b + c * kBoxBytes, &bmap, k0, n0 + c * kBox,
                          &full[s]);
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kRegsConsumer>();
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int t = lane % 4;
  float acc[NA];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    wg_place(tile, mt, nt, raster_n, BN, m0, n0);
    // K step kc: its four k16 products are issued as one group; once the
    // previous step's group has finished, that step's stage is released
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const uint32_t a = base + (uint32_t)(s * kStage) + wg * kBoxBytes;
      const uint32_t b = base + (uint32_t)(s * kStage) + kA;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // K-major: + 32 bytes a k16; MN-major: + 16 k rows of 128 bytes,
        // the next 64 of M or N one box (8 KB) on
        const uint64_t da = TA ? sw128_mn_desc(a + kk * 2048, kBoxBytes)
                               : sw128_desc(a + kk * 32);
        const uint64_t db = TB ? sw128_mn_desc(b + kk * 2048, kBoxBytes)
                               : sw128_desc(b + kk * 32);
        wgmma_ss<BN, TA, TB>(acc, da, db, kc > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(acc);
      if (kc > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);

    // the epilogue: this thread's rows r_lo and r_hi = r_lo + 8, columns
    // n0 + wg_col(i, t); accumulators i and i + 1 (i even) are adjacent
    const int r_lo = m0 + 64 * wg + 16 * warp + lane / 4, r_hi = r_lo + 8;
    if constexpr (EPI == EPI_STATS) {
      const int lab_lo = r_lo < ep.n_tok ? ep.labels[r_lo] : -1;
      const int lab_hi = r_hi < ep.n_tok ? ep.labels[r_hi] : -1;
      float mx_lo = -INFINITY, mx_hi = -INFINITY, gd_lo = 0.f, gd_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int col = n0 + wg_col(i, t);
        const float v = col < ep.V ? acc[i] : kMaskFill;
        acc[i] = v;
        if (i & 2) {
          mx_hi = fmaxf(mx_hi, v);
          if (col == lab_hi) gd_hi += v;
        } else {
          mx_lo = fmaxf(mx_lo, v);
          if (col == lab_lo) gd_lo += v;
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
        gd_lo += __shfl_xor_sync(0xffffffffu, gd_lo, o);
        gd_hi += __shfl_xor_sync(0xffffffffu, gd_hi, o);
      }
      float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if (i & 2) s_hi += expf(acc[i] - mx_hi);
        else s_lo += expf(acc[i] - mx_lo);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
      }
      if (t == 0) {
        const size_t plane = (size_t)nt * ep.n_tok;
        const size_t o = (size_t)(n0 / BN) * ep.n_tok;
        if (r_lo < ep.n_tok) {
          ep.part[o + r_lo] = mx_lo;
          ep.part[plane + o + r_lo] = s_lo;
          ep.part[2 * plane + o + r_lo] = gd_lo;
        }
        if (r_hi < ep.n_tok) {
          ep.part[o + r_hi] = mx_hi;
          ep.part[plane + o + r_hi] = s_hi;
          ep.part[2 * plane + o + r_hi] = gd_hi;
        }
      }
    } else if constexpr (EPI == EPI_DL) {
      // the slab's columns [0, Nn) are vocab v0.. (Nn <= V - v0)
      float lse_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
      int lab_r[2] = {-1, -1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? r_hi : r_lo;
        if (row < ep.n_tok) {
          lse_r[h] = ep.lse[row];
          g_r[h] = ep.g[row];
          lab_r[h] = ep.labels[row] - ep.v0;
        }
      }
      // 64 columns at a time through the warp's staging tile (16-byte
      // units XOR-swizzled by row, so that neither the 4-byte writes of
      // the accumulator layout nor the 16-byte reads conflict on banks),
      // then out in whole 128-byte rows: the accumulator layout would
      // store 4 bytes a thread, 16-byte pieces of 8 rows a warp
      uint16_t* out = static_cast<uint16_t*>(ep.out);
      unsigned char* stg = staging + (wg * 4 + warp) * kDlStaging;
      const int g = lane / 4;
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int i = 32 * c + 2 * k;   // columns 8 (i / 4) + 2 t, + 1
          const int h = k & 1, u = k >> 1, rl = g + 8 * h;
          const int col = n0 + wg_col(i, t);
          const float d0 = (expf(acc[i] - lse_r[h]) -
                            (lab_r[h] == col ? 1.f : 0.f)) * g_r[h];
          const float d1 = (expf(acc[i + 1] - lse_r[h]) -
                            (lab_r[h] == col + 1 ? 1.f : 0.f)) * g_r[h];
          *reinterpret_cast<uint32_t*>(stg + rl * 128 +
                                       ((u ^ (rl & 7)) << 4) + 4 * t) =
              pack_bf16(d0, d1);
        }
        __syncwarp();
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int rl = 4 * v + lane / 8, u = lane % 8;
          const int row = m0 + 64 * wg + 16 * warp + rl;
          const int col = n0 + 64 * c + 8 * u;
          const uint4 val = *reinterpret_cast<const uint4*>(
              stg + rl * 128 + ((u ^ (rl & 7)) << 4));
          if (row < ep.n_tok && col < Nn)
            *reinterpret_cast<uint4*>(out + (size_t)row * ep.ldo + col) = val;
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        const int row = (i & 2) ? r_hi : r_lo;
        const int col = n0 + wg_col(i, t);
        if (row >= M || col >= Nn) continue;
        if constexpr (EPI == EPI_DX) {
          const size_t o = (size_t)row * Nn + col;
          float s0 = acc[i], s1 = acc[i + 1];
          if (!ep.first) {
            const float2 prev = *reinterpret_cast<const float2*>(ep.acc + o);
            s0 += prev.x;
            s1 += prev.y;
          }
          if (ep.last)
            *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(ep.out) +
                                         o) = pack_bf16(s0, s1);
          else
            *reinterpret_cast<float2*>(ep.acc + o) = make_float2(s0, s1);
        } else {                        // EPI_DW
          *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(ep.out) +
                                       (size_t)(ep.v0 + row) * Nn + col) =
              pack_bf16(acc[i], acc[i + 1]);
        }
      }
    }
  }
}

// ---- the fp32 route: cp.async ring, CUDA-core FMAs ------------------------

constexpr int kThreads = 256;       // 8 warps
constexpr int kGT = 128;            // output tile rows and columns
constexpr int kGK = 32;             // contraction chunk
constexpr int kGStages = 3;
constexpr int kVec = 4;             // fp32 elements per 16-byte copy
// One operand stage: [kGT rows][kGK] with pitch P when stored K-major,
// [kGK][kGT rows] with pitch Q otherwise; each pitch is padded by 16
// bytes, which keeps the 16-byte copies aligned and spreads the rows over
// the banks.
constexpr int kP = kGK + kVec;
constexpr int kQ = kGT + kVec;
constexpr int kGStage = kGT * kP;   // >= kGK * kQ
constexpr int kFmaSmem = 4 * 2 * kGStages * kGStage;

// 16-byte asynchronous copy global -> shared; zero fill when !pred.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0));
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// One [kGT rows] x [kGK] chunk of an operand into a stage. KMAJ: stored
// [rows][K] (K contiguous); else [K][rows] (rows contiguous).
template <bool KMAJ>
__device__ __forceinline__ void load_gemm_chunk(float* st,
                                                const float* __restrict__ P,
                                                int ld, int r0, int nrows,
                                                int k0, int K) {
#pragma unroll
  for (int i = 0; i < kGT * kGK / kVec / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (KMAJ) {
      const int r = e / (kGK / kVec), c = (e % (kGK / kVec)) * kVec;
      const bool ok = r0 + r < nrows && k0 + c < K;
      cp_async16_zfill(&st[r * kP + c],
                       ok ? P + (size_t)(r0 + r) * ld + k0 + c : P, ok);
    } else {
      const int k = e / (kGT / kVec), c = (e % (kGT / kVec)) * kVec;
      const bool ok = k0 + k < K && r0 + c < nrows;
      cp_async16_zfill(&st[k * kQ + c],
                       ok ? P + (size_t)(k0 + k) * ld + r0 + c : P, ok);
    }
  }
}

// One staged chunk into the warp's 64 x 32 block of the output tile:
// acc[i][j][r] is row wm + 16 i + g + 8 (r / 2), column wn + 8 j + 2 t +
// r % 2 (g = lane / 4, t = lane % 4), one contraction step at a time.
template <bool A_KMAJ, bool B_KMAJ>
__device__ __forceinline__ void chunk_product(float (&acc)[4][4][4],
                                              const float* as,
                                              const float* bs, int wm,
                                              int wn, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int kk = 0; kk < kGK; ++kk) {
    float a[4][2], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + i * 16 + g + h * 8;
        a[i][h] = A_KMAJ ? as[m * kP + kk] : as[kk * kQ + m];
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = wn + j * 8 + t * 2 + q;
        b[j][q] = B_KMAJ ? bs[n * kP + kk] : bs[kk * kQ + n];
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

// C[M, Nn] = A . B^T over K (A's rows m, B's rows n), then the epilogue;
// block (x, y) is the output tile at column x, row y.
template <bool A_KMAJ, bool B_KMAJ, int EPI>
__global__ void __launch_bounds__(kThreads)
ce_fma_kernel(const float* __restrict__ A, int lda,
              const float* __restrict__ B, int ldb, int M, int Nn, int K,
              Epi ep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + kGStages * kGStage;
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
      load_gemm_chunk<A_KMAJ>(sa + s * kGStage, A, lda, m0, M, s * kGK, K);
      load_gemm_chunk<B_KMAJ>(sb + s * kGStage, B, ldb, n0, Nn, s * kGK, K);
    }
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<kGStages - 2>();
    __syncthreads();
    const int next = kc + kGStages - 1;
    if (next < nk) {
      const int st = next % kGStages;
      load_gemm_chunk<A_KMAJ>(sa + st * kGStage, A, lda, m0, M, next * kGK,
                              K);
      load_gemm_chunk<B_KMAJ>(sb + st * kGStage, B, ldb, n0, Nn, next * kGK,
                              K);
    }
    cp_commit();
    chunk_product<A_KMAJ, B_KMAJ>(acc, sa + (kc % kGStages) * kGStage,
                                  sb + (kc % kGStages) * kGStage, wm, wn,
                                  lane);
  }
  cp_wait<0>();
  if (EPI == EPI_STATS) {
    stats_epilogue(acc, reinterpret_cast<float*>(smem_raw), m0, n0, ep);
    return;
  }
  float* out = static_cast<float*>(ep.out);
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
          out[(size_t)row * ep.ldo + col] = d;
        } else if (EPI == EPI_DX) {
          if (row >= M || col >= Nn) continue;
          const size_t o = (size_t)row * Nn + col;
          const float sum = (ep.first ? 0.f : ep.acc[o]) + v;
          if (ep.last) out[o] = sum;
          else ep.acc[o] = sum;
        } else {
          if (row >= M || col >= Nn) continue;
          out[(size_t)(ep.v0 + row) * Nn + col] = v;
        }
      }
}

// ---- plans and launchers --------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

// One product of a call: C[M, Nn] over K. ``product``: EPI_STATS (the
// forward), or the backward's EPI_DL, EPI_DX, EPI_DW of slab ``slab``.
struct Shape {
  int M, Nn, K, v0, wc;
};
Shape product_shape(int N, int H, int V, int Vc, int product, int slab) {
  if (product == EPI_STATS) return {N, V, H, 0, V};
  const int v0 = slab * Vc;
  const int wc = V - v0 < Vc ? V - v0 : Vc;     // vocab rows in the slab
  if (product == EPI_DL) return {N, wc, H, v0, wc};
  if (product == EPI_DX) return {N, H, wc, v0, wc};
  return {wc, H, N, v0, wc};
}

struct Plan {
  int wgmma, bm, bn, bk, stages, smem, tiles, grid, raster_n;
};

// The bf16 route's plan on ``sms`` SMs: BN 256, or 128 where 256-column
// tiles fill less than one wave of the card and 128-column ones take less
// time (waves times width; the forward's statistics keep 256: their
// partials are laid out by it); as many stages as 227 KB holds, up to 8;
// one block a SM; the tiles along the smaller operand fastest.
Plan wg_plan(const Shape& s, int product, int sms) {
  const int mt = cdiv(s.M, kWgBM);
  const int tiles256 = mt * cdiv(s.Nn, 256);
  int bn = 256;
  if (product != EPI_STATS && tiles256 < sms &&
      cdiv(mt * cdiv(s.Nn, 128), sms) * 128 < cdiv(tiles256, sms) * 256)
    bn = 128;
  const int stage = (kWgBM + bn) * kWgBK * 2;
  int stages = (kSmemMax - kSmemFixed) / stage;
  if (stages > kWgMaxStages) stages = kWgMaxStages;
  const int tiles = mt * cdiv(s.Nn, bn);
  return {1, kWgBM, bn, kWgBK, stages, kSmemFixed + stages * stage, tiles,
          tiles < sms ? tiles : sms, s.Nn <= s.M ? 1 : 0};
}

Plan fma_plan(const Shape& s) {
  const int tiles = cdiv(s.M, kGT) * cdiv(s.Nn, kGT);
  return {0, kGT, kGT, kGK, kGStages, kFmaSmem, tiles, tiles, 1};
}

// The current device's SMs, 0 when they cannot be read.
int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// A 2-D bf16 map over a row-major [outer][inner] operand whose rows are
// ``pitch`` elements apart, in 64 x 64 boxes.
bool bf16_map(CUtensorMap* map, const void* ptr, int inner, int outer,
              int pitch) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, inner, outer,
                  (uint64_t)pitch * 2, kBox, kBox);
}

template <int BN, int TA, int TB, int EPI>
cudaError_t wg_launch(const CUtensorMap& amap, const CUtensorMap& bmap,
                      const Shape& s, const Plan& p, const Epi& ep,
                      cudaStream_t st) {
  auto kernel = ce_wg_kernel<BN, TA, TB, EPI>;
  static bool ready = false;          // once per instantiation
  if (!ready) {
    // the roles' setmaxnreg must fit what the block got at launch
    cudaError_t err = check_entry_regs(kernel, kRegsAtEntry);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<p.grid, kWgThreads, p.smem, st>>>(amap, bmap, s.M, s.Nn, s.K,
                                             p.stages, p.raster_n, ep);
  return cudaGetLastError();
}

template <int TA, int TB, int EPI>
cudaError_t wg_product(const CUtensorMap& amap, const CUtensorMap& bmap,
                       const Shape& s, const Plan& p, const Epi& ep,
                       cudaStream_t st) {
  if (p.bn == 256)
    return wg_launch<256, TA, TB, EPI>(amap, bmap, s, p, ep, st);
  return wg_launch<128, TA, TB, EPI>(amap, bmap, s, p, ep, st);
}

template <bool A_KMAJ, bool B_KMAJ, int EPI>
cudaError_t fma_product(const float* A, int lda, const float* B, int ldb,
                        const Shape& s, const Epi& ep, cudaStream_t st) {
  auto kernel = ce_fma_kernel<A_KMAJ, B_KMAJ, EPI>;
  static bool ready = false;          // once per instantiation
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFmaSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(cdiv(s.Nn, kGT), cdiv(s.M, kGT));
  kernel<<<grid, kThreads, kFmaSmem, st>>>(A, lda, B, ldb, s.M, s.Nn, s.K,
                                           ep);
  return cudaGetLastError();
}

// The forward: the logits tiles' statistics, then their fold.
cudaError_t fwd_bf16(const void* x, const void* w, int N, int H, int V,
                     const Epi& ep, float* nll, float* lse,
                     cudaStream_t st) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const Shape s = product_shape(N, H, V, 0, EPI_STATS, 0);
  const Plan p = wg_plan(s, EPI_STATS, sms);
  CUtensorMap xmap, wmap;
  if (!bf16_map(&xmap, x, H, N, H) || !bf16_map(&wmap, w, H, V, H))
    return cudaErrorNotSupported;
  cudaError_t err =
      wg_launch<256, 0, 0, EPI_STATS>(xmap, wmap, s, p, ep, st);
  if (err != cudaSuccess) return err;
  ce_stats_reduce_kernel<<<cdiv(N, 256), 256, 0, st>>>(
      ep.part, cdiv(V, p.bn), N, nll, lse);
  return cudaGetLastError();
}

cudaError_t fwd_fp32(const float* x, const float* w, int N, int H, int V,
                     const Epi& ep, float* nll, float* lse,
                     cudaStream_t st) {
  const Shape s = product_shape(N, H, V, 0, EPI_STATS, 0);
  cudaError_t err = fma_product<true, true, EPI_STATS>(x, H, w, H, s, ep, st);
  if (err != cudaSuccess) return err;
  ce_stats_reduce_kernel<<<cdiv(N, 256), 256, 0, st>>>(
      ep.part, cdiv(V, kGT), N, nll, lse);
  return cudaGetLastError();
}

// The backward, slab by slab: dl (x . w_slab^T), dx (dl . w_slab), dw
// (dl^T . x). The bf16 maps: x [N][H]; w_slab [wc][H], K-major for dl and
// MN-major for dx; dl [N][wc] (pitch Vc), K-major for dx and MN-major for
// dw.
cudaError_t bwd_bf16(const uint16_t* x, const uint16_t* w, Epi ep,
                     uint16_t* dx, uint16_t* dw, uint16_t* dl, int N, int H,
                     int V, int Vc, cudaStream_t st) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  CUtensorMap xmap;
  if (!bf16_map(&xmap, x, H, N, H)) return cudaErrorNotSupported;
  for (int slab = 0; slab * Vc < V; ++slab) {
    const Shape sl = product_shape(N, H, V, Vc, EPI_DL, slab);
    const Shape sx = product_shape(N, H, V, Vc, EPI_DX, slab);
    const Shape sw = product_shape(N, H, V, Vc, EPI_DW, slab);
    CUtensorMap wmap, dlmap;
    if (!bf16_map(&wmap, w + (size_t)sl.v0 * H, H, sl.wc, H) ||
        !bf16_map(&dlmap, dl, sl.wc, N, Vc))
      return cudaErrorNotSupported;
    ep.v0 = sl.v0;
    ep.first = slab == 0;
    ep.last = sl.v0 + Vc >= V;
    ep.out = dl;
    cudaError_t err = wg_product<0, 0, EPI_DL>(
        xmap, wmap, sl, wg_plan(sl, EPI_DL, sms), ep, st);
    if (err != cudaSuccess) return err;
    ep.out = dx;
    err = wg_product<0, 1, EPI_DX>(dlmap, wmap, sx,
                                   wg_plan(sx, EPI_DX, sms), ep, st);
    if (err != cudaSuccess) return err;
    ep.out = dw;
    err = wg_product<1, 1, EPI_DW>(dlmap, xmap, sw,
                                   wg_plan(sw, EPI_DW, sms), ep, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t bwd_fp32(const float* x, const float* w, Epi ep, float* dx,
                     float* dw, float* dl, int N, int H, int V, int Vc,
                     cudaStream_t st) {
  for (int slab = 0; slab * Vc < V; ++slab) {
    // the dl product's last tile writes zeros past the slab's wc columns
    const Shape sl = product_shape(N, H, V, Vc, EPI_DL, slab);
    const Shape sx = product_shape(N, H, V, Vc, EPI_DX, slab);
    const Shape sw = product_shape(N, H, V, Vc, EPI_DW, slab);
    const float* ws = w + (size_t)sl.v0 * H;
    ep.v0 = sl.v0;
    ep.first = slab == 0;
    ep.last = sl.v0 + Vc >= V;
    ep.out = dl;
    cudaError_t err =
        fma_product<true, true, EPI_DL>(x, H, ws, H, sl, ep, st);
    if (err != cudaSuccess) return err;
    ep.out = dx;
    err = fma_product<true, false, EPI_DX>(dl, Vc, ws, H, sx, ep, st);
    if (err != cudaSuccess) return err;
    ep.out = dw;
    err = fma_product<false, false, EPI_DW>(dl, Vc, x, H, sw, ep, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool bad_shape(int N, int H, int V) {
  return N <= 0 || H <= 0 || H % 128 != 0 || V <= 0 || V % 8 != 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x [N, H], w [V, H] row-major, labels
// int32 [N]; H % 128 == 0 and V % 8 == 0, x and w 16-byte aligned. Each
// entry returns cudaGetLastError() after its launches
// (cudaErrorInvalidValue for what it does not take, cudaErrorNotSupported
// when no tensor map could be made) and writes the route it launched to
// *variant: 1 the TMA + wgmma kernel (bf16), 0 the FMA one (fp32).
// nll, lse fp32 [N]; part, a [3, ceil(V / BN), N] fp32 scratch for the
// tiles' statistics (BN: 256 for bf16, 128 for fp32). Two launches.
extern "C" int ce_fwd(const void* x, const void* w, const int* labels,
                      float* nll, float* lse, float* part, int N, int H,
                      int V, int dtype, void* stream, int* variant) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, H, V) || variant == nullptr || !aligned16(x) ||
      !aligned16(w))
    return (int)cudaErrorInvalidValue;
  Epi ep{};
  ep.labels = labels;
  ep.n_tok = N;
  ep.V = V;
  ep.part = part;
  if (dtype == 0) {
    *variant = 0;
    return (int)fwd_fp32(static_cast<const float*>(x),
                         static_cast<const float*>(w), N, H, V, ep, nll, lse,
                         st);
  }
  if (dtype == 1) {
    *variant = 1;
    return (int)fwd_bf16(x, w, N, H, V, ep, nll, lse, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dx [N, H] and dw [V, H] in x's dtype; dl, an [N, Vc] scratch slab in
// x's dtype (Vc % 128 == 0), and acc, an [N, H] fp32 scratch (unused when
// one slab covers V). Three launches per slab of Vc vocab columns.
extern "C" int ce_bwd(const void* x, const void* w, const int* labels,
                      const float* lse, const float* g, void* dx, void* dw,
                      void* dl, float* acc, int N, int H, int V, int Vc,
                      int dtype, void* stream, int* variant) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, H, V) || Vc <= 0 || Vc % kGT != 0 || variant == nullptr ||
      !aligned16(x) || !aligned16(w) || !aligned16(dl))
    return (int)cudaErrorInvalidValue;
  Epi ep{lse, labels, g, N, V, 0, nullptr, Vc, acc, 1, 1, nullptr};
  if (dtype == 0) {
    *variant = 0;
    return (int)bwd_fp32(static_cast<const float*>(x),
                         static_cast<const float*>(w), ep,
                         static_cast<float*>(dx), static_cast<float*>(dw),
                         static_cast<float*>(dl), N, H, V, Vc, st);
  }
  if (dtype == 1) {
    *variant = 1;
    return (int)bwd_bf16(static_cast<const uint16_t*>(x),
                         static_cast<const uint16_t*>(w), ep,
                         static_cast<uint16_t*>(dx),
                         static_cast<uint16_t*>(dw),
                         static_cast<uint16_t*>(dl), N, H, V, Vc, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The plan the launchers follow for one product of a call (product 3: the
// forward's statistics; 0, 1, 2: the backward's dl, dx, dw of slab
// ``slab``), on this device's SMs, for holding ce_plan to the source:
// out = {variant (1: TMA + wgmma, 0: FMA), bm, bn, bk, stages, smem bytes,
// tiles, grid, raster_n (the column tiles run fastest), M, Nn, K}.
extern "C" int ce_plan_c(int N, int H, int V, int Vc, int dtype,
                         int product, int slab, int* out) {
  if (bad_shape(N, H, V) || Vc <= 0 || Vc % kGT != 0 || product < 0 ||
      product > 3 || slab < 0 || (long long)slab * Vc >= V ||
      (dtype != 0 && dtype != 1) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const Shape s = product_shape(N, H, V, Vc, product, slab);
  const Plan p = dtype == 1 ? wg_plan(s, product, sms) : fma_plan(s);
  const int v[12] = {p.wgmma, p.bm,   p.bn,       p.bk, p.stages, p.smem,
                     p.tiles, p.grid, p.raster_n, s.M,  s.Nn,     s.K};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}
