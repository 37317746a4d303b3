// Fused residual + bias + norm (+ tanh gelu) epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/fused_norm_epilogue.py::_epilogue_kernel
// (launched by _epilogue_call): over rows of x [N, H],
//   r = x + sub + bias                     (x's dtype)
//   y = norm(r) * gain (+ beta) (+ gelu)   (x's dtype)
// with norm "rms" (r * rsqrt(mean(r^2) + eps)) or "layer"
// ((r - mean) * rsqrt(var + eps), population variance), statistics in
// fp32. Every operand but x and gain may be absent (a null pointer); the
// [H] vectors come in their own dtype (fp32 or bf16). Without sub and
// bias r is x itself and is not written.
//
// Rounding follows the eager composition the kernel replaces: x + sub
// rounds to x's dtype, the bias rounds to x's dtype and is added, rounding
// again (so r is bit-equal to the composition); the norm's products and
// sums run in fp32 without fma contraction (__fmul_rn / __fadd_rn), y
// rounds once to x's dtype, and the gelu runs in fp32 on that rounded y
// and rounds once, as PyTorch's aten.gelu does on bf16.
//
// Bound on the H100: bytes. Per row it reads x and sub and writes r and y
// (4 H elements; the vectors stay in L1/L2), about 2 flop per byte, far
// under the ~295 flop/byte where the tensor cores would bind. At GPT-3
// 350M's [16384, 1024] bf16 that is 134 MB, 0.040 ms at 3.35 TB/s.
//
// Design. One 128-thread block per row; the row stays in registers
// between the two reductions: each thread holds VPT 16-byte vectors
// (8 bf16 or 4 fp32 values, the vectors of one thread 128 vectors apart
// so a warp's loads are contiguous), VPT in {1, 2, 4, 8}, so H is at most
// 8192 (bf16) or 4096 (fp32). Two-pass statistics (the mean, then the sum
// of squared deviations), each a warp-shuffle tree and a 4-entry shared
// sum read by every thread in the same order, so every thread holds the
// same bits. No atomics, no scratch in device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

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
// v rounded to T's grid, as a float
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// element j of an [H] vector stored as fp32 (code 0) or bf16 (code 1)
__device__ __forceinline__ float vec_at(const void* p, int code, int j) {
  return code == 0
             ? __ldg(static_cast<const float*>(p) + j)
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[j]);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // PyTorch's tanh gelu: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
  const float kBeta = 0.7978845608028654f;
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// sum over the block; every thread returns the same bits
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // sh is reused by the next call
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sh[w];
  return s;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
norm_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ sub,
                     const void* __restrict__ bias, int bias_code,
                     const void* __restrict__ gain, int gain_code,
                     const void* __restrict__ beta, int beta_code,
                     T* __restrict__ r_out, T* __restrict__ y_out, int h,
                     int layer, int gelu, float eps) {
  constexpr int E = Vec<T>::N;
  __shared__ float sh[kWarps];
  const size_t base = (size_t)blockIdx.x * h;
  float v[VPT][E];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * kThreads + threadIdx.x) * E;
    if (c < h) {
      load_vec(x + base + c, v[k]);
      if (sub != nullptr) {
        float t[E];
        load_vec(sub + base + c, t);
#pragma unroll
        for (int i = 0; i < E; ++i) v[k][i] = rnd<T>(__fadd_rn(v[k][i], t[i]));
      }
      if (bias != nullptr) {
#pragma unroll
        for (int i = 0; i < E; ++i)
          v[k][i] = rnd<T>(
              __fadd_rn(v[k][i], rnd<T>(vec_at(bias, bias_code, c + i))));
      }
      if (r_out != nullptr) store_vec(r_out + base + c, v[k]);
#pragma unroll
      for (int i = 0; i < E; ++i)
        s = __fadd_rn(s, layer ? v[k][i] : __fmul_rn(v[k][i], v[k][i]));
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) v[k][i] = 0.f;
    }
  }
  float mean = 0.f, rstd;
  if (layer) {
    mean = block_sum(s, sh) / (float)h;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if ((k * kThreads + threadIdx.x) * E < h) {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const float d = __fsub_rn(v[k][i], mean);
          q = __fadd_rn(q, __fmul_rn(d, d));
        }
      }
    }
    rstd = rsqrtf(__fadd_rn(block_sum(q, sh) / (float)h, eps));
  } else {
    rstd = rsqrtf(__fadd_rn(block_sum(s, sh) / (float)h, eps));
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (k * kThreads + threadIdx.x) * E;
    if (c < h) {
      float out[E];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float nv = layer ? __fmul_rn(__fsub_rn(v[k][i], mean), rstd)
                               : __fmul_rn(v[k][i], rstd);
        float yv = __fmul_rn(nv, vec_at(gain, gain_code, c + i));
        if (layer) yv = __fadd_rn(yv, vec_at(beta, beta_code, c + i));
        yv = rnd<T>(yv);
        out[i] = gelu ? gelu_tanh(yv) : yv;
      }
      store_vec(y_out + base + c, out);
    }
  }
}

template <typename T>
int launch(const void* x, const void* sub, const void* bias, int bias_code,
           const void* gain, int gain_code, const void* beta, int beta_code,
           void* r, void* y, int n, int h, int layer, int gelu, float eps,
           cudaStream_t st) {
  const int vectors = h / Vec<T>::N;
  const int vpt = (vectors + kThreads - 1) / kThreads;
#define K6_LAUNCH(V)                                                       \
  norm_epilogue_kernel<T, V><<<n, kThreads, 0, st>>>(                      \
      static_cast<const T*>(x), static_cast<const T*>(sub), bias,          \
      bias_code, gain, gain_code, beta, beta_code, static_cast<T*>(r),     \
      static_cast<T*>(y), h, layer, gelu, eps)
  if (vpt <= 1)
    K6_LAUNCH(1);
  else if (vpt <= 2)
    K6_LAUNCH(2);
  else if (vpt <= 4)
    K6_LAUNCH(4);
  else if (vpt <= 8)
    K6_LAUNCH(8);
  else
    return (int)cudaErrorInvalidValue;
#undef K6_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype / *_code: 0 fp32, 1 bf16. layer: 0 rms, 1 layer (beta required).
// gelu: 1 applies the tanh gelu to y. sub, bias, beta and r may be null.
extern "C" int norm_epilogue(const void* x, const void* sub, const void* bias,
                             int bias_code, const void* gain, int gain_code,
                             const void* beta, int beta_code, void* r,
                             void* y, int n, int h, int dtype, int layer,
                             int gelu, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || gain == nullptr || (layer && beta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (h % Vec<float>::N) return (int)cudaErrorInvalidValue;
    return launch<float>(x, sub, bias, bias_code, gain, gain_code, beta,
                         beta_code, r, y, n, h, layer, gelu, eps, st);
  }
  if (dtype == 1) {
    if (h % Vec<__nv_bfloat16>::N) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(x, sub, bias, bias_code, gain, gain_code,
                                 beta, beta_code, r, y, n, h, layer, gelu,
                                 eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
