// Weight-only int8 matmul with the dequant scale in the epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/quant_matmul.py::_qmm_kernel
// (launched by quant_matmul_kernel): y[M, N] = (x[M, K] @ W[K, N]) * s[N],
// x bf16 or fp32, W int8, s fp32, y fp32. Per-output-column scales commute
// with the contraction, so the int8 tile is converted exactly (|w| <= 127)
// and the scale multiplies the fp32 accumulator once, at the end.
//
// Design. bf16 x (the engine's case) takes the tensor cores: one 256-thread
// block per 64 x 128 output tile, 8 warps of 32 x 32, a K loop that stages
// a 64 x 32 tile of x and a 32 x 128 tile of W (16-byte loads, int8
// converted exactly to bf16) through shared memory, mma.sync m16n8k16 bf16
// with fp32 accumulators in registers, and the next tile's loads in flight
// during this tile's products. fp32 x takes a CUDA-core kernel: 64 x 64
// tiles, 16-deep K steps, a 4 x 4 FMA sub-tile per thread. Ragged M, N and
// K edges are masked with zeros in both.
//
// Bound on the H100. The weight bytes (K * N, int8) are the traffic that
// matters: at the head's M = 32 the function is byte-bound; at the layers'
// M = 512 it does 2 * M = 1024 flop per weight byte, above the ~295
// flop/byte of the bf16 tensor cores, so it is operation-bound there. The
// mma.sync loop here, with one tile of register prefetch, stays far below
// the wgmma rate; wgmma with TMA-fed int8 tiles is
// the later PR that closes that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
