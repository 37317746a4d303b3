// Fused FFN activations, for Hopper (sm_90a): bias + tanh gelu (K7) and
// swiglu (K12).
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/fused_bias_act.py::_bias_gelu_kernel
//   paddle_tpu/ops/pallas/fused_bias_act.py::_swiglu_kernel
// bias_gelu (launched by _bias_gelu_call): y = gelu_tanh(x + bias) over
// x [N, F] with bias [F] broadcast over rows. The bias rounds to x's dtype,
// the add rounds to x's dtype, and the gelu runs in fp32 and rounds once: the
// eager composition F.gelu(x + bias.to(x.dtype), approximate="tanh"),
// whose aten.gelu computes a bf16 input in fp32. swiglu (launched by
// _swiglu_call): y = silu(gate in fp32) rounded to the input dtype, times
// up in the input dtype, over gate and up [N, F]: LLaMA's FFN gating
// silu(gate.float()).to(dtype) * up, with silu(x) = x / (1 + exp(-x)) as
// PyTorch computes it.
//
// Bound on the H100: bytes. bias_gelu: x in and y out (the bias stays in
// L1/L2), about 10 flop per element against 4 bytes in bf16, far under the
// tensor cores' ~295 flop/byte; at GPT-3 350M's [16384, 4096] bf16 that is
// 268 MB, 0.080 ms at 3.35 TB/s. swiglu: gate and up in, y out, 6 bytes an
// element in bf16; at LLaMA-1B's prefill [8192, 5504] 271 MB, 0.081 ms.
//
// Design. A grid-stride loop over 16-byte vectors (8 bf16 or 4 fp32
// values of one row: F is a multiple of the vector width), 256 threads a
// block, at most 16 blocks per SM's worth of the grid; each thread loads
// its vector of each input (and, for the gelu, the matching bias values)
// and stores one vector.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

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
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_gelu_kernel(const T* __restrict__ x, const void* __restrict__ bias,
                 int bias_code, T* __restrict__ y, long long n_vec, int f) {
  constexpr int E = Vec<T>::N;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long e0 = i * E;
    const int c = (int)(e0 % f);
    const uint4 u = *reinterpret_cast<const uint4*>(x + e0);
    const T* xe = reinterpret_cast<const T*>(&u);
    uint4 o;
    T* ye = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float b = rnd<T>(vec_at(bias, bias_code, c + j));
      const float v = rnd<T>(__fadd_rn(to_f(xe[j]), b));
      ye[j] = from_f<T>(gelu_tanh(v));
    }
    *reinterpret_cast<uint4*>(y + e0) = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ gate, const T* __restrict__ up,
              T* __restrict__ y, long long n_vec) {
  constexpr int E = Vec<T>::N;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const uint4 ug = *reinterpret_cast<const uint4*>(gate + i * E);
    const uint4 uu = *reinterpret_cast<const uint4*>(up + i * E);
    const T* ge = reinterpret_cast<const T*>(&ug);
    const T* ue = reinterpret_cast<const T*>(&uu);
    uint4 o;
    T* ye = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float g = to_f(ge[j]);
      const float h = rnd<T>(g / (1.f + expf(-g)));
      ye[j] = from_f<T>(__fmul_rn(h, to_f(ue[j])));
    }
    *reinterpret_cast<uint4*>(y + i * E) = o;
  }
}

template <typename T>
long long grid_for(int n, int f, long long* n_vec) {
  *n_vec = (long long)n * f / Vec<T>::N;
  long long blocks = (*n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

template <typename T>
int launch(const void* x, const void* bias, int bias_code, void* y, int n,
           int f, cudaStream_t st) {
  if (f % Vec<T>::N) return (int)cudaErrorInvalidValue;
  long long n_vec;
  const long long blocks = grid_for<T>(n, f, &n_vec);
  bias_gelu_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), bias, bias_code, static_cast<T*>(y), n_vec,
      f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_swiglu(const void* gate, const void* up, void* y, int n, int f,
                  cudaStream_t st) {
  if (f % Vec<T>::N) return (int)cudaErrorInvalidValue;
  long long n_vec;
  const long long blocks = grid_for<T>(n, f, &n_vec);
  swiglu_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<T*>(y), n_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype / bias_code: 0 fp32, 1 bf16.
extern "C" int bias_gelu(const void* x, const void* bias, int bias_code,
                         void* y, int n, int f, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f <= 0 || bias == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, bias, bias_code, y, n, f, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bias, bias_code, y, n, f, st);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 fp32, 1 bf16; gate, up and y [n, f], f % (16 / itemsize) == 0.
extern "C" int swiglu(const void* gate, const void* up, void* y, int n, int f,
                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_swiglu<float>(gate, up, y, n, f, st);
  if (dtype == 1) return launch_swiglu<__nv_bfloat16>(gate, up, y, n, f, st);
  return (int)cudaErrorInvalidValue;
}
