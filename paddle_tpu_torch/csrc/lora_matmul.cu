// Grouped per-row LoRA delta (K13, grouped BGMV) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/lora_matmul.py::_lora_kernel
// (launched by lora_matmul_kernel): x [C, qb, H]; adapter stacks
// a [S, H, r], b [S, r, N]; ids [C] int32; out [C, qb, N] fp32 with
//   out[c] = (x[c] @ a[ids[c]]) @ b[ids[c]],
// both products in fp32 (bf16 inputs are widened exactly).
//
// Bound on the H100: bytes. At r = 8 each x element takes part in 2 r
// flops and each output element in 2 r: x, the touched adapters and the
// fp32 output have to cross memory once, at well under one flop per byte,
// so CUDA-core fp32 FMAs do.
//
// Design. The TPU grid is (row c, N block) with the adapter blocks picked
// by the scalar-prefetched ids. Here one block of 256 threads owns (N tile
// of 512 columns, row c). It forms t = x[c] @ a[ids[c]] (qb x r) in shared
// memory: a[ids[c]] is staged 256 rows of H at a time as fp32, each warp
// takes two rows of x, its lanes stride over H with r partial sums each
// (lane-blocked summation), then a warp reduction. Then each thread owns
// two output columns: it keeps b[ids[c]][:, n] in registers and writes
// out[c, i, n] = sum_j t[i][j] b[j][n] for every row i. Rows go 16 at a
// time. Every N tile of a row recomputes t from x[c] and a[ids[c]], which
// then come from L2: a second pass writing t once would read them once
// (later work), as would cp.async staging of the next H chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowGroup = kWarps * kRowsPerWarp;   // rows of x per pass
constexpr int kChunkH = 256;                        // rows of a staged
constexpr int kTileN = 2 * kThreads;                // output columns

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
lora_kernel(const T* __restrict__ x, const T* __restrict__ a,
            const T* __restrict__ b, const int* __restrict__ ids,
            float* __restrict__ out, int qb, int H, int N) {
  __shared__ float as[kChunkH][R + 1];     // +1: lanes read rows apart
  __shared__ float ts[kRowGroup][R];
  const int n0 = blockIdx.x * kTileN;
  const int c = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int id = ids[c];
  const T* ap = a + (size_t)id * H * R;
  const T* bp = b + (size_t)id * R * N;

  float bcol[2][R];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n = n0 + tid + u * kThreads;
#pragma unroll
    for (int j = 0; j < R; ++j)
      bcol[u][j] = n < N ? to_f(bp[(size_t)j * N + n]) : 0.f;
  }

  for (int i0 = 0; i0 < qb; i0 += kRowGroup) {
    float acc[kRowsPerWarp][R];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[rr][j] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kChunkH) {
      const int nh = min(kChunkH, H - h0);
      __syncthreads();                     // as is free again
      for (int e = tid; e < nh * R; e += kThreads)
        as[e / R][e % R] = to_f(ap[(size_t)h0 * R + e]);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int i = i0 + warp * kRowsPerWarp + rr;
        if (i >= qb) continue;
        const T* xr = x + ((size_t)c * qb + i) * H + h0;
        for (int hh = lane; hh < nh; hh += 32) {
          const float xv = to_f(xr[hh]);
#pragma unroll
          for (int j = 0; j < R; ++j) acc[rr][j] = fmaf(xv, as[hh][j], acc[rr][j]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float v = acc[rr][j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) ts[warp * kRowsPerWarp + rr][j] = v;
      }
    __syncthreads();
    const int ni = min(kRowGroup, qb - i0);
    for (int r = 0; r < ni; ++r) {
      float* orow = out + ((size_t)c * qb + i0 + r) * N;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = n0 + tid + u * kThreads;
        if (n >= N) continue;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) s = fmaf(ts[r][j], bcol[u][j], s);
        orow[n] = s;
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const int* ids,
           float* out, int C, int qb, int H, int r, int N, cudaStream_t st) {
  const dim3 grid((N + kTileN - 1) / kTileN, C);
#define LORA_CASE(RR)                                                      \
  if (r == RR) {                                                           \
    lora_kernel<T, RR><<<grid, kThreads, 0, st>>>(                         \
        static_cast<const T*>(x), static_cast<const T*>(a),                \
        static_cast<const T*>(b), ids, out, qb, H, N);                     \
    return (int)cudaGetLastError();                                        \
  }
  LORA_CASE(4) LORA_CASE(8) LORA_CASE(16)
#undef LORA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a and b alike); r in {4, 8, 16}.
// x [C, qb, H]; a [S, H, r]; b [S, r, N]; ids [C] in [0, S); out
// [C, qb, N] fp32. Returns cudaGetLastError() after the launch.
extern "C" int lora_matmul(const void* x, const void* a, const void* b,
                           const int* ids, float* out, int C, int qb, int H,
                           int r, int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || qb <= 0 || H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, a, b, ids, out, C, qb, H, r, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, ids, out, C, qb, H, r, N, st);
  return (int)cudaErrorInvalidValue;
}
