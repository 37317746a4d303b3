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
// Design of bias_gelu: a 2-D walk over 16-byte vectors (8 bf16 or 4 fp32
// values of one row: F is a multiple of the vector width). A block of 256
// threads covers ``cols`` vectors of a row (up to 256) and ``rows`` rows
// (256 / cols); gridDim.x blocks span a row, gridDim.y walk the rows. Each
// thread owns one column vector for the whole call: it reads and rounds
// its bias values once, into registers (the bias dtype is a template
// parameter, not a branch per element), then strides over rows with
// kUnroll independent 16-byte loads in flight before any arithmetic.
// Offsets within a row are 32-bit; a row's start is one 64-bit product.
// The grid is kWaves times what the card holds at once (the occupancy it
// reports for the kernel, times its SMs), capped so that each thread has
// at least kUnroll rows: on the H100 one wave of long-lived blocks ran at
// 0.109 ms at [16384, 4096] bf16 and 8 or 16 waves at 0.094, a grid that
// leaves threads less than a full pass slower again (PERF.md).
// bias_gelu_plan in ops/kernels/fused_bias_act.py mirrors the walk. The
// arithmetic of an element is the eager composition's, as above, whatever
// the walk.
//
// swiglu: a grid-stride loop over 16-byte vectors, 256 threads a block,
// at most 16 blocks per SM's worth of the grid; each thread loads its
// vector of each input and stores one vector.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // swiglu's grid-stride cap
constexpr int kUnroll = 4;   // bias_gelu: 16-byte loads in flight a thread
constexpr int kWaves = 8;    // bias_gelu: blocks, in units of the card's fill

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

__device__ __forceinline__ float gelu_tanh(float x) {
  // PyTorch's tanh gelu: 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
  const float kBeta = 0.7978845608028654f;
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// Thread (tr, tc) = (threadIdx.x / cols, threadIdx.x % cols) of block
// (bx, by) owns the 16-byte vector bx cols + tc of rows by rows + tr + j
// gridDim.y rows, j = 0, 1, ...; threads past rows x cols or past the row
// idle.
template <typename T, typename B>
__global__ void __launch_bounds__(kThreads)
bias_gelu_kernel(const T* __restrict__ x, const B* __restrict__ bias,
                 T* __restrict__ y, int n, int f, int cols, int rows) {
  constexpr int E = Vec<T>::N;
  const int tr = threadIdx.x / cols;
  const int c = (blockIdx.x * cols + threadIdx.x % cols) * E;
  if (tr >= rows || c >= f) return;
  float b[E];
#pragma unroll
  for (int j = 0; j < E; ++j) b[j] = rnd<T>(to_f(bias[c + j]));
  const int stride = gridDim.y * rows;
  for (int r = blockIdx.y * rows + tr; r < n; r += kUnroll * stride) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rk = r + k * stride;
      if (rk < n)
        u[k] = *reinterpret_cast<const uint4*>(x + (size_t)rk * f + c);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rk = r + k * stride;
      if (rk >= n) break;
      const T* xe = reinterpret_cast<const T*>(&u[k]);
      uint4 o;
      T* ye = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float v = rnd<T>(__fadd_rn(to_f(xe[j]), b[j]));
        ye[j] = from_f<T>(gelu_tanh(v));
      }
      *reinterpret_cast<uint4*>(y + (size_t)rk * f + c) = o;
    }
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

// bias_gelu's walk for [n, f]: out = {cols, rows, gridDim.x, gridDim.y,
// kUnroll, resident blocks}. ``resident`` is the card's capacity for the
// kernel (blocks an SM at full occupancy, times the SMs), queried once per
// instantiation; gridDim.y is kWaves times it over the row's column
// blocks, up to a pass of kUnroll rows a thread.
template <typename T, typename B>
cudaError_t walk(int n, int f, int* out) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bias_gelu_kernel<T, B>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms;
  }
  const int vecs = f / Vec<T>::N;
  const int cols = vecs < kThreads ? vecs : kThreads;
  const int rows = kThreads / cols;
  const int gx = (vecs + cols - 1) / cols;
  const int passes = (n + rows * kUnroll - 1) / (rows * kUnroll);
  int gy = kWaves * resident / gx;
  if (gy > passes) gy = passes;
  if (gy < 1) gy = 1;
  const int v[6] = {cols, rows, gx, gy, kUnroll, resident};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

template <typename T, typename B>
int launch(const void* x, const void* bias, void* y, int n, int f,
           cudaStream_t st) {
  if (f % Vec<T>::N) return (int)cudaErrorInvalidValue;
  int w[6];
  cudaError_t err = walk<T, B>(n, f, w);
  if (err != cudaSuccess) return (int)err;
  bias_gelu_kernel<T, B><<<dim3(w[2], w[3]), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const B*>(bias),
      static_cast<T*>(y), n, f, w[0], w[1]);
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

// dtype / bias_code: 0 fp32, 1 bf16; x and y [n, f], f % (16 / itemsize)
// == 0, 16-byte aligned.
extern "C" int bias_gelu(const void* x, const void* bias, int bias_code,
                         void* y, int n, int f, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || f <= 0 || bias == nullptr) return (int)cudaErrorInvalidValue;
  using BF = __nv_bfloat16;
  if (dtype == 0 && bias_code == 0)
    return launch<float, float>(x, bias, y, n, f, st);
  if (dtype == 0 && bias_code == 1)
    return launch<float, BF>(x, bias, y, n, f, st);
  if (dtype == 1 && bias_code == 0)
    return launch<BF, float>(x, bias, y, n, f, st);
  if (dtype == 1 && bias_code == 1)
    return launch<BF, BF>(x, bias, y, n, f, st);
  return (int)cudaErrorInvalidValue;
}

// The walk bias_gelu launches for [n, f] (see walk), for holding
// bias_gelu_plan to the source: out = {cols, rows, gridDim.x, gridDim.y,
// unroll, resident blocks}.
extern "C" int bias_gelu_plan_c(int n, int f, int dtype, int bias_code,
                                int* out) {
  if (n <= 0 || f <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  using BF = __nv_bfloat16;
  if (dtype == 0 && f % 4 == 0)
    return (int)(bias_code ? walk<float, BF>(n, f, out)
                           : walk<float, float>(n, f, out));
  if (dtype == 1 && f % 8 == 0)
    return (int)(bias_code ? walk<BF, BF>(n, f, out)
                           : walk<BF, float>(n, f, out));
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
