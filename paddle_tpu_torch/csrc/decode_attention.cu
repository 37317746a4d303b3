// One-token GQA attention over a dense kv-head-major cache (K10), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/decode_attention.py::_decode_kernel
// (launched by decode_attention, fp cache): q [B, nH, d] (one token per
// row), cache_k / cache_v [B, nKV, S, d], pos the last valid cache index;
// o [B, nH, d]. The G = nH / nKV query heads that share a kv head are
// served together, so each kv head's cache is read once and the repeated
// [B, nH, S, d] cache never exists; positions past pos are never read
// (the TPU kernel's k loop runs to ceil((pos + 1) / block)). s = (q k^T) *
// scale in fp32, p = exp(s - m) with l summed over the fp32 p and p cast to
// the cache dtype before p v (the TPU kernel's cast points), o = acc / l.
//
// Bound on the H100: bytes. Each step reads 2 * nKV * (pos + 1) * d cache
// values per batch row and does 4 * nH * (pos + 1) * d flop: one flop per
// byte in bf16, far under the ~295 the tensor cores need. At LLaMA-1B
// (nKV 4, d 128, bf16) with pos 2047 that is 4.2 MB per row, 1.3 us at
// 3.35 TB/s.
//
// Design. The TPU walks the cache in order in one program per (b, kv
// head); one block per (b, kv head) would occupy 4 of 132 SMs at batch 1.
// So the cache is split into chunks of 64 positions: one block per (chunk,
// kv head, b) stages its chunk's k and v rows in shared memory, scores the
// G heads against them and writes a partial (m, l, acc[G][d]) to scratch;
// a second kernel combines the partials of a (b, kv head) in chunk order,
// o = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M). No atomics: the
// output is bitwise reproducible.
//
// K10q, the int8-cache arm of the same TPU kernel (quant=True): int8
// caches with fp32 per-position scales k_scale / v_scale [B, nKV, S]. Each
// int8 element is multiplied in fp32 by its position's scale and rounded
// to the q dtype as the chunk is staged in shared memory (ops/quant.py::
// dequantize_int8, the TPU kernel's order); the rest is K10's code, so on
// a cache dequantized beforehand K10 gives the same bits. The int8 cache
// halves the bytes that bound the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;        // cache positions per block
constexpr int kMaxG = 16;

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

size_t chunk_smem(int G, int D) {
  return sizeof(float) * ((size_t)G * D + (size_t)kChunk * (D + 1) +
                          (size_t)kChunk * D + (size_t)G * kChunk);
}

// A cache element as the dots see it: fp caches as they are, int8 caches
// times the position's scale in fp32, rounded to the q dtype T.
template <typename T>
__device__ __forceinline__ float cache_val(const T* p, size_t i,
                                           const float*, size_t) {
  return to_f(p[i]);
}
template <typename T>
__device__ __forceinline__ float cache_val(const int8_t* p, size_t i,
                                           const float* sc, size_t r) {
  return round_to<T>(__fmul_rn((float)p[i], sc[r]));
}

// part: per (b, kv head, chunk): m[G], l[G], acc[G][D], fp32. CT: the
// cache element type, T, or int8_t with the scales ksc / vsc [B, nKV, S].
template <typename T, typename CT, int D>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const T* __restrict__ q, const CT* __restrict__ ck,
                    const CT* __restrict__ cv, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, float* __restrict__ part,
                    int nKV, int G, int S, int pos, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                         // [G][D]
  float* ks = qs + G * D;                   // [kChunk][D + 1]
  float* vs = ks + kChunk * (D + 1);        // [kChunk][D]
  float* ss = vs + kChunk * D;              // [G][kChunk]
  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int p0 = j * kChunk;
  const int n = min(kChunk, pos + 1 - p0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const T* qb = q + ((size_t)b * nKV * G + (size_t)kh * G) * D;
  for (int e = tid; e < G * D; e += kThreads) qs[e] = to_f(qb[e]);
  const size_t row0 = ((size_t)b * nKV + kh) * S + p0;
  const CT* kb = ck + row0 * D;
  const CT* vb = cv + row0 * D;
  for (int e = tid; e < n * D; e += kThreads) {
    const int c = e / D, dd = e % D;
    ks[c * (D + 1) + dd] = cache_val<T>(kb, e, ksc, row0 + c);
    vs[e] = cache_val<T>(vb, e, vsc, row0 + c);
  }
  __syncthreads();

  for (int e = tid; e < G * kChunk; e += kThreads) {
    const int g = e / kChunk, c = e % kChunk;
    float s = -INFINITY;
    if (c < n) {
      s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd)
        s = fmaf(qs[g * D + dd], ks[c * (D + 1) + dd], s);
      s *= scale;
    }
    ss[e] = s;
  }
  __syncthreads();

  float* pb = part + (((size_t)b * nKV + kh) * n_chunks + j) * G * (D + 2);
  for (int g = warp; g < G; g += kThreads / 32) {
    float* row = ss + g * kChunk;
    float mx = fmaxf(row[lane], row[lane + 32]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float p_a = expf(row[lane] - mx), p_b = expf(row[lane + 32] - mx);
    float sum = p_a + p_b;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    row[lane] = round_to<T>(p_a);         // p cast before p v
    row[lane + 32] = round_to<T>(p_b);
    if (lane == 0) {
      pb[g] = mx;
      pb[G + g] = sum;
    }
  }
  __syncthreads();

  float* accb = pb + 2 * G;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, dd = e % D;
    const float* prow = ss + g * kChunk;
    float a = 0.f;
    for (int c = 0; c < n; ++c) a = fmaf(prow[c], vs[c * D + dd], a);
    accb[e] = a;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      int nKV, int G, int n_chunks) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const float* base = part + ((size_t)b * nKV + kh) * n_chunks * G * (D + 2);
  T* ob = out + ((size_t)b * nKV * G + (size_t)kh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D;
    float M = -INFINITY;
    for (int j = 0; j < n_chunks; ++j)
      M = fmaxf(M, base[(size_t)j * G * (D + 2) + g]);
    float L = 0.f, A = 0.f;
    for (int j = 0; j < n_chunks; ++j) {
      const float* pj = base + (size_t)j * G * (D + 2);
      const float w = expf(pj[g] - M);
      L = fmaf(pj[G + g], w, L);
      A = fmaf(pj[2 * G + e], w, A);
    }
    ob[e] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename CT, int D>
int launch(const void* q, const void* ck, const void* cv, const float* ksc,
           const float* vsc, float* part, void* out, int B, int nKV, int G,
           int S, int pos, float scale, cudaStream_t st) {
  const int n_chunks = (pos + kChunk) / kChunk;    // ceil((pos + 1) / 64)
  const size_t smem = chunk_smem(G, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_chunk_kernel<T, CT, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_chunk_kernel<T, CT, D>
      <<<dim3(n_chunks, nKV, B), kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const CT*>(ck),
          static_cast<const CT*>(cv), ksc, vsc, part, nKV, G, S, pos, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<dim3(nKV, B), kThreads, 0, st>>>(
      part, static_cast<T*>(out), nKV, G, n_chunks);
  return (int)cudaGetLastError();
}

// Q: int8 caches with scales; q and out in `dtype`.
template <bool Q>
int forward(const void* q, const void* ck, const void* cv, const float* ksc,
            const float* vsc, float* part, void* out, int B, int nKV, int G,
            int S, int d, int pos, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || nKV <= 0 || G < 1 || G > kMaxG || pos < 0 || pos >= S)
    return (int)cudaErrorInvalidValue;
  using C16 = typename std::conditional<Q, int8_t, __nv_bfloat16>::type;
  using C32 = typename std::conditional<Q, int8_t, float>::type;
#define ARGS q, ck, cv, ksc, vsc, part, out, B, nKV, G, S, pos, scale, st
  if (dtype == 1) {
    if (d == 64) return launch<__nv_bfloat16, C16, 64>(ARGS);
    if (d == 128) return launch<__nv_bfloat16, C16, 128>(ARGS);
    if (d == 256) return launch<__nv_bfloat16, C16, 256>(ARGS);
  } else if (dtype == 0) {
    if (d == 64) return launch<float, C32, 64>(ARGS);
    if (d == 128) return launch<float, C32, 128>(ARGS);
    if (d == 256) return launch<float, C32, 256>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Scratch floats the wrapper allocates for `part`.
extern "C" long long decode_attention_scratch(int B, int nKV, int G, int d,
                                              int pos) {
  return (long long)B * nKV * ((pos + kChunk) / kChunk) * G * (d + 2);
}

// dtype: 0 = float32, 1 = bfloat16; d in {64, 128, 256}; 1 <= G <= 16;
// 0 <= pos < S. q [B, nKV * G, d]; cache_k / cache_v [B, nKV, S, d];
// out [B, nKV * G, d]. Returns cudaGetLastError() after the launches.
extern "C" int decode_attention(const void* q, const void* ck, const void* cv,
                                float* part, void* out, int B, int nKV, int G,
                                int S, int d, int pos, float scale, int dtype,
                                void* stream) {
  return forward<false>(q, ck, cv, nullptr, nullptr, part, out, B, nKV, G, S,
                        d, pos, scale, dtype, stream);
}

// K10q: int8 cache_k / cache_v with fp32 per-position scales k_scale /
// v_scale [B, nKV, S]; the rest as decode_attention.
extern "C" int decode_attention_int8(const void* q, const void* ck,
                                     const void* cv, const float* k_scale,
                                     const float* v_scale, float* part,
                                     void* out, int B, int nKV, int G, int S,
                                     int d, int pos, float scale, int dtype,
                                     void* stream) {
  return forward<true>(q, ck, cv, k_scale, v_scale, part, out, B, nKV, G, S,
                       d, pos, scale, dtype, stream);
}
