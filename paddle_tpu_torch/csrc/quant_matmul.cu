// Weight-only int8 matmul with the dequant scale in the epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/quant_matmul.py::_qmm_kernel
// (launched by quant_matmul_kernel): y[M, N] = (x[M, K] @ W[K, N]) * s[N],
// x bf16 or fp32, W int8 in the reference's row-major [K, N], s fp32, y
// fp32. Per-output-column scales commute with the contraction, so the
// int8 values are converted exactly (|w| <= 127) and the scale multiplies
// the fp32 accumulator once, at the end. No repacked copy of W is kept.
//
// Bound on the H100. At the engine's M = 512 the function does 2 * M =
// 1024 flop per weight byte, above the ~295 flop/byte of the bf16 tensor
// cores: operation-bound. At the head's M = 32 it is byte-bound (W, 525
// MB at llama3-8b's vocabulary).
//
// Design of the main variant (bf16 x, K % 8 == 0, N % 16 == 0: the
// alignments TMA needs), qmm_wgmma_kernel. The operands are swapped:
// y^T = W^T x^T, so W is wgmma's A operand, read from registers, and x is
// its B operand, read from shared memory through a descriptor. That way
// the int8 tile is converted in the registers that feed the tensor cores
// (no bf16 copy of W is written back to shared memory, no proxy fence),
// and x's M, 32 at the head, is the instruction's N, which may be as
// small as 8, while W's N takes the instruction's 64 rows. Three
// warpgroups:
// - warpgroup 2 is the producer: one thread keeps a ring of 5-8 stages
//   full with TMA loads, each stage x's [BM, 64] bf16 tile (K-major,
//   128-byte swizzle: wgmma's canonical B layout) and W's [64, 128 SL]
//   int8 tile (row-major, 128-byte swizzle, as stored), on full/empty
//   mbarriers; TMA writes zeros past the tensor's edges;
// - warpgroups 0 and 1 each own SL 64-row A slices, SL x 64 columns of
//   y. A thread's 2 SL A rows are adjacent columns of W, so one 16-bit
//   (SL 1) or 32-bit (SL 2) shared load of a swizzled k row gives a value
//   for each (conflict-free: the swizzle spreads the 4 k rows a warp
//   reads over distinct banks). int8 -> bf16 is exact: a byte permute
//   into the mantissa of 2^23, a subtraction of 2^23 + 128, and a permute
//   that packs the two upper halves (the integers have at most 8
//   significant bits); no conversion instruction;
// - wgmma.mma_async m64nBMk16, fp32 accumulators, a K step of 64 (4 k16
//   x SL products) committed as one group; the next step's tile is
//   converted into a second register set while the group runs, and a
//   stage is released once its group has finished;
// - epilogue: for each x row m a thread's accumulators are 2 SL adjacent
//   columns: times s[n..], one 8- or 16-byte store.
// quant_matmul.py::qmm_plan picks the tile from (M, K, N): BM 256 x 128
// columns (SL 1, n256 products: half the conversions a product of SL 2)
// for the engine's M 512; BM 32 or 64 x 256 columns (SL 2) for small M,
// the head's byte-bound case; shapes with too few tiles for 132 SMs (N
// 1024 and 4096 at M 512) split K across blocks into fp32 partials that
// a second kernel sums in split order and scales. At M 512 it stays
// above the bf16 product's time: a warpgroup's next products wait for its
// own conversion, and 224 tiles take two waves of 132 SMs (PERF.md).
//
// The other variants: shapes TMA cannot take (unaligned K or N) keep the
// mma.sync m16n8k16 kernel (qmm_tc_kernel: 64 x 128 tiles, a register
// prefetch of the next K step); fp32 x takes a CUDA-core kernel
// (qmm_kernel). Both mask the ragged edges.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps, setmaxnreg

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

// fp32 x: CUDA-core FMA tiles.
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ s, float* __restrict__ y, int M, int K,
           int N) {
  __shared__ float xs[kBK][kBM + 4];
  __shared__ float ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < (kBM * kBK) / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int row = e / kBK, kk = e % kBK;
      const int gm = m0 + row, gk = k0 + kk;
      xs[kk][row] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < (kBK * kBN) / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / kBN, col = e % kBN;
      const int gk = k0 + kk, gn = n0 + col;
      ws[kk][col] = (gk < K && gn < N) ? (float)w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) y[(size_t)gm * N + gn] = acc[i][j] * s[gn];
    }
  }
}

constexpr int kTM = 64, kTN = 128, kTK = 32;
constexpr int kXS = kTK + 8;   // xs row stride (halves): 80 B, conflict-free
constexpr int kWS = kTN + 8;   // ws row stride (halves): 272 B

union Bf16x8 {
  uint4 v;
  uint16_t h[8];
};
union Int8x16 {
  uint4 v;
  int8_t b[16];
};

__device__ __forceinline__ uint16_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

// One thread's share of a K step: 8 bf16 of x (row tid / 4) and 16 int8
// of W (k row tid / 8), read as 16-byte vectors where the tile is whole
// and aligned, element by element with zero fill at the ragged edges.
__device__ __forceinline__ void load_tile(
    const uint16_t* __restrict__ x, const int8_t* __restrict__ w, int M,
    int K, int N, int m0, int n0, int k0, int tid, Bf16x8& xr,
    Int8x16& wr) {
  const int xm = m0 + tid / 4, xk = k0 + (tid % 4) * 8;
  if (xm < M && xk + 8 <= K && K % 8 == 0) {
    xr.v = *reinterpret_cast<const uint4*>(x + (size_t)xm * K + xk);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xr.h[i] = (xm < M && xk + i < K) ? x[(size_t)xm * K + xk + i] : 0;
  }
  const int wk = k0 + tid / 8, wn = n0 + (tid % 8) * 16;
  if (wk < K && wn + 16 <= N && N % 16 == 0) {
    wr.v = *reinterpret_cast<const uint4*>(w + (size_t)wk * N + wn);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      wr.b[i] = (wk < K && wn + i < N) ? w[(size_t)wk * N + wn + i] : 0;
  }
}

// bf16 x: tensor-core tiles (mma.sync m16n8k16, fp32 accumulate). The next
// K step's global loads are issued before this step's products, so their
// latency overlaps the tensor-core work.
__global__ void __launch_bounds__(kThreads)
qmm_tc_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ s, float* __restrict__ y, int M,
              int K, int N) {
  __shared__ __align__(16) uint16_t xs[kTM * kXS];   // [m][k] bf16 bits
  __shared__ __align__(16) uint16_t ws[kTK * kWS];   // [k][n] bf16 bits
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  Bf16x8 xr;
  Int8x16 wr;
  load_tile(x, w, M, K, N, m0, n0, 0, tid, xr, wr);
  for (int k0 = 0; k0 < K; k0 += kTK) {
    *reinterpret_cast<uint4*>(&xs[(tid / 4) * kXS + (tid % 4) * 8]) = xr.v;
    Bf16x8 w0, w1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w0.h[i] = bf16_bits((float)wr.b[i]);
      w1.h[i] = bf16_bits((float)wr.b[8 + i]);
    }
    uint16_t* wdst = &ws[(tid / 8) * kWS + (tid % 8) * 16];
    *reinterpret_cast<uint4*>(wdst) = w0.v;
    *reinterpret_cast<uint4*>(wdst + 8) = w1.v;
    __syncthreads();
    if (k0 + kTK < K)
      load_tile(x, w, M, K, N, m0, n0, k0 + kTK, tid, xr, wr);
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint16_t* p = &xs[(wm + i * 16 + g) * kXS + kk + t * 2];
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kXS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kXS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint16_t* p = &ws[(kk + t * 2) * kWS + wn + j * 8 + g];
        b[j][0] = (uint32_t)p[0] | ((uint32_t)p[kWS] << 16);
        b[j][1] = (uint32_t)p[8 * kWS] | ((uint32_t)p[9 * kWS] << 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
                "+f"(acc[i][j][3])
              : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
                "r"(b[j][0]), "r"(b[j][1]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm + i * 16 + g + (r / 2) * 8;
        const int gn = n0 + wn + j * 8 + t * 2 + (r % 2);
        if (gm < M && gn < N) y[(size_t)gm * N + gn] = acc[i][j][r] * s[gn];
      }
}

// ---- the main variant: TMA ring, int8 converted in registers, wgmma ----

constexpr int kWSlice = 64;           // columns of y a 64-row A slice
constexpr int kWgBK = 64;             // K a stage: a 128-byte row of x
constexpr int kWgThreads = 384;       // 2 consumer warpgroups, 1 producer
constexpr int kRegsAtEntry = 168;     // 65536 / 384, what ptxas gives
constexpr int kRegsProducer = 40;     // setmaxnreg after the role split:
constexpr int kRegsConsumer = 232;    // 128 x 40 + 256 x 232 <= 384 x 168
static_assert(128 * kRegsProducer + 256 * kRegsConsumer <=
              kWgThreads * kRegsAtEntry, "setmaxnreg over the block's pool");
constexpr int kWBox = kWgBK * 128;    // a [64 k, 128 n] int8 tile of W
constexpr int kWgMaxStages = 8;

// Byte j of a word of int8 values already offset by 128 (xor 0x80): the
// exact float, 2^23 + (w + 128) put together bitwise, minus 2^23 + 128.
// With the pair packing below, 2.5 integer or fp32 instructions a value
// and no conversion instruction.
__device__ __forceinline__ float i8_at(uint32_t wu, int j) {
  return __uint_as_float(__byte_perm(wu, 0x4B000000u, 0x7540 | j)) -
         8388736.f;
}
// bf16 pair (byte j of lo, byte j of hi), lo in the low half: the upper
// halves of the two floats, exact since an integer of magnitude <= 128
// has at most 8 significant bits.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi,
                                              int j) {
  return __byte_perm(__float_as_uint(i8_at(lo, j)),
                     __float_as_uint(i8_at(hi, j)), 0x7632);
}

// The 4 (SL 2) or 2 (SL 1) int8 of k row r at byte ``byte`` of 16-byte
// unit ``chunk`` of a swizzled [64, 128] tile, offset by 128 (xor 0x80).
template <int SL>
__device__ __forceinline__ uint32_t w_bytes(const unsigned char* tile,
                                            int r, int chunk, int byte) {
  const unsigned char* p = tile + r * 128 + ((chunk ^ (r & 7)) << 4) + byte;
  if constexpr (SL == 2)
    return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  else
    return (uint32_t)*reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
}

// smem: the ring, stages x [x tile BM x 128 B | SL W tiles 64 x 128 B]
// from a 1024-byte aligned base, then full[8] and empty[8]. Each of the
// two consumer warpgroups owns SL 64-row A slices (SL x 64 columns of
// y); block (mt, nt, z): rows [mt BM, +BM), columns [nt 128 SL, +128 SL),
// K steps [z per, (z+1) per); with gridDim.z > 1 it writes its fp32
// partial (unscaled) at z M N.
template <int BM, int SL>
__global__ void __launch_bounds__(kWgThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int M, int K, int N, int stages, int kb_per_split) {
  constexpr int NA = BM / 2;          // accumulators of one slice
  constexpr int kCols = 2 * SL * kWSlice;
  constexpr int kXBytes = BM * 128;
  constexpr int kStage = kXBytes + SL * kWBox;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + (size_t)stages * kStage);
  uint64_t* empty = full + kWgMaxStages;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kCols;
  const int kb_total = (K + kWgBK - 1) / kWgBK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nkb = max(0, min(kb_total, kb0 + kb_per_split) - kb0);
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
      for (int i = 0; i < nkb; ++i) {
        const int s = i % stages;
        mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        const uint32_t dst = base + (uint32_t)(s * kStage);
        const int k0 = (kb0 + i) * kWgBK;
        mbar_expect_tx(&full[s], kStage);
        tma_load_2d(dst, &xmap, k0, m0, &full[s]);
#pragma unroll
        for (int c = 0; c < SL; ++c)
          tma_load_2d(dst + kXBytes + c * kWBox, &wmap, n0 + 128 * c, k0,
                      &full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<kRegsConsumer>();
  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's A rows (slice h, row 16 w + g + 8 e) are 2 SL adjacent
  // columns, n0 + col + 2 h + e with col = 64 SL wg + SL (16 w + 2 g): one
  // word (SL 2) or pair (SL 1) of a k row of W tile col / 128
  const int col = 64 * SL * wg + SL * (16 * w + 2 * g);
  const int chunk = (col % 128) / 16, byte = col % 16;
  float acc[SL][NA];
#pragma unroll
  for (int h = 0; h < SL; ++h)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[h][i] = 0.f;

  // A fragments of one K step (4 k16 x SL slices), converted from stage s
  auto convert = [&](int s, uint32_t (&a)[4][SL][4]) {
    const unsigned char* wt =
        sm + (size_t)s * kStage + kXBytes + (col / 128) * kWBox;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int r = 16 * ks + 2 * t;
      const uint32_t w0 = w_bytes<SL>(wt, r, chunk, byte);
      const uint32_t w1 = w_bytes<SL>(wt, r + 1, chunk, byte);
      const uint32_t w2 = w_bytes<SL>(wt, r + 8, chunk, byte);
      const uint32_t w3 = w_bytes<SL>(wt, r + 9, chunk, byte);
#pragma unroll
      for (int h = 0; h < SL; ++h) {
        a[ks][h][0] = bf16_pair(w0, w1, 2 * h);
        a[ks][h][1] = bf16_pair(w0, w1, 2 * h + 1);
        a[ks][h][2] = bf16_pair(w2, w3, 2 * h);
        a[ks][h][3] = bf16_pair(w2, w3, 2 * h + 1);
      }
    }
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int h = 0; h < SL; ++h) fence_operands(acc[h]);
  };
  // K step i: its products from ``cur`` are issued; once step i - 1's
  // have finished, its stage is freed and step i + 1's stage is awaited
  // and converted into ``nxt`` (step i - 1's registers) while step i's
  // products run.
  auto step = [&](int i, const uint32_t (&cur)[4][SL][4],
                  uint32_t (&nxt)[4][SL][4]) {
    const int s = i % stages;
    const uint64_t dx = sw128_desc(base + (uint32_t)(s * kStage));
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < SL; ++h)     // + 32 bytes a k16
        wgmma_rs<BM, 0>(acc[h], cur[ks][h], dx + 2 * ks);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % stages]);
    }
    if (i + 1 < nkb) {
      mbar_wait(&full[(i + 1) % stages], ((i + 1) / stages) & 1);
      convert((i + 1) % stages, nxt);
    }
  };
  uint32_t a0[4][SL][4], a1[4][SL][4];
  if (nkb > 0) {
    mbar_wait(&full[0], 0);
    convert(0, a0);
  }
  for (int i = 0; i < nkb; i += 2) {
    step(i, a0, a1);
    if (i + 1 < nkb) step(i + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_acc();

  // accumulator i of slice h: A row g + 8 e (e = (i / 2) % 2), column
  // n + 2 h + e; x row m = 8 (i / 4) + 2 t + i % 2
  const int n = n0 + col;
  if (n >= N) return;
  const bool whole = gridDim.z == 1;
  float sc[2 * SL];
#pragma unroll
  for (int j = 0; j < 2 * SL; ++j) sc[j] = whole ? scale[n + j] : 1.f;
  float* ob = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * i + 2 * t + c;
      if (m >= M) continue;
      float* dst = ob + (size_t)m * N + n;
      if constexpr (SL == 2) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[0][4 * i + c] * sc[0], acc[0][4 * i + 2 + c] * sc[1],
            acc[1][4 * i + c] * sc[2], acc[1][4 * i + 2 + c] * sc[3]);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(
            acc[0][4 * i + c] * sc[0], acc[0][4 * i + 2 + c] * sc[1]);
      }
    }
}

// y = (sum of the split-K partials, in split order) * s, 4 columns a
// thread.
__global__ void qmm_splitk_sum(const float4* __restrict__ part,
                               const float* __restrict__ scale,
                               float4* __restrict__ y, int M, int N,
                               int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = (size_t)M * N / 4;
  if (e >= n4) return;
  float4 a = part[e];
  for (int z = 1; z < splits; ++z) {
    const float4 b = part[z * n4 + e];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  const float4 sc =
      reinterpret_cast<const float4*>(scale)[(e * 4 % (size_t)N) / 4];
  y[e] = make_float4(a.x * sc.x, a.y * sc.y, a.z * sc.z, a.w * sc.w);
}

template <int BM, int SL>
int launch_wgmma(const void* x, const void* w, const float* scale, float* y,
                 float* part, int M, int K, int N, int splits, int stages,
                 cudaStream_t st) {
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                (uint64_t)K * 2, kWgBK, BM) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, 128,
                kWgBK))
    return (int)cudaErrorNotSupported;
  const size_t smem = (size_t)stages * (BM * 128 + SL * kWBox) + 1024 +
                      16 * kWgMaxStages;
  static size_t smem_set = 0;        // the attribute only ever grows
  if (smem_set == 0) {
    // the roles' setmaxnreg must fit what the block got at launch
    cudaError_t err = check_entry_regs(qmm_wgmma_kernel<BM, SL>,
                                       kRegsAtEntry);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_wgmma_kernel<BM, SL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int kb_total = (K + kWgBK - 1) / kWgBK;
  const int per = (kb_total + splits - 1) / splits;
  const int bn = 2 * SL * kWSlice;
  const dim3 grid((M + BM - 1) / BM, (N + bn - 1) / bn, splits);
  qmm_wgmma_kernel<BM, SL><<<grid, kWgThreads, smem, st>>>(
      xmap, wmap, scale, splits > 1 ? part : y, M, K, N, stages, per);
  if (splits > 1) {
    const size_t n4 = (size_t)M * N / 4;
    qmm_splitk_sum<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(part), scale,
        reinterpret_cast<float4*>(y), M, N, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch.
extern "C" int qmm_forward(const void* x, const void* w, const float* scale,
                           float* y, int M, int K, int N, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (dtype == 0) {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    qmm_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), wq,
                                          scale, y, M, K, N);
  } else if (dtype == 1) {
    dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
    qmm_tc_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), wq, scale, y, M, K, N);
  } else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The main variant: bf16 x [M, K] with K % 8 == 0, int8 W [K, N] with
// N % 16 == 0, all pointers 16-byte aligned; bm in {32, 64, 128, 256}
// rows a block, splits >= 1 (with part, [splits, M, N] fp32, when > 1), stages
// in [2, 8]. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for what it does not take, cudaErrorNotSupported
// when no tensor map could be made).
extern "C" int qmm_forward_wgmma(const void* x, const void* w,
                                 const float* scale, float* y, float* part,
                                 int M, int K, int N, int bm, int splits,
                                 int stages, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(part)) % 16) == 0;
  if (M < 1 || K < 8 || K % 8 || N < 16 || N % 16 || splits < 1 ||
      (splits > 1 && part == nullptr) || stages < 2 ||
      stages > kWgMaxStages || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS x, w, scale, y, part, M, K, N, splits, stages, st
  // two slices a warpgroup (256 columns a block) for small M, where the
  // block's W tile is all the work; one (128) with n256 products for large
  if (bm == 256) return launch_wgmma<256, 1>(ARGS);
  if (bm == 128) return launch_wgmma<128, 1>(ARGS);
  if (bm == 64) return launch_wgmma<64, 2>(ARGS);
  if (bm == 32) return launch_wgmma<32, 2>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
