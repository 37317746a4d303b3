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
// values per batch row and does 4 * nH * (pos + 1) * d flop: G flop per
// byte in bf16, far under the ~295 the tensor cores need. At LLaMA-1B
// (nKV 4, d 128, bf16) with pos 2047 that is 4.2 MB per row, 1.3 us at
// 3.35 TB/s.
//
// Design. The TPU walks the cache in order in one program per (b, kv
// head); one block per (b, kv head) would occupy 4 of 132 SMs at batch 1.
// So the cache is cut into chunks of 32 positions, and one (b, kv head) is
// served by a thread-block cluster of 1-8 blocks (decode_plan): block r of
// the
// cluster walks chunks [r n / c, (r + 1) n / c) in order with the online
// softmax (m, l, acc[G][d] in shared memory). Each chunk's k and v rows
// (and, int8, their scales) are staged in their own dtype with cp.async,
// two stages deep, the next chunk's copy in flight while this one is
// computed. The scores: eight lanes a position (four positions a warp),
// each lane four elements of d at a time against q in fp32, a fixed
// shuffle tree; the values: a thread per element of d and four query
// heads, the chunk's positions in order. Then the cluster combines its
// blocks' partials through distributed shared memory in rank order, which
// is chunk order, M = max_r m_r, o = sum_r acc_r e^(m_r - M) /
// sum_r l_r e^(m_r - M), each block a share of the (head, d) outputs.
// One launch a call, nothing in device memory but the output, no atomics:
// the output is bitwise reproducible.
//
// K10q, the int8-cache arm of the same TPU kernel (quant=True): int8
// caches with fp32 per-position scales k_scale / v_scale [B, nKV, S]. Each
// int8 element is multiplied in fp32 by its position's scale and rounded
// to the q dtype where a row is read (ops/quant.py::dequantize_int8, the
// TPU kernel's order); the rest is K10's code, so on a cache dequantized
// beforehand K10 gives the same bits. The int8 cache halves the bytes
// that bound the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;          // cache positions a chunk
constexpr int kMaxG = 16;
constexpr int kMaxCluster = 8;      // a portable cluster
constexpr int kTargetBlocks = 528;  // four blocks on each of 132 SMs
constexpr size_t kMaxSmem = 227 * 1024;

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

// A cache element as the dots see it: fp caches as they are, int8 caches
// times the position's scale in fp32, rounded to the q dtype T.
template <typename T>
__device__ __forceinline__ float cache_val(T v, float) {
  return to_f(v);
}
template <typename T>
__device__ __forceinline__ float cache_val(int8_t v, float sc) {
  return round_to<T>(__fmul_rn((float)v, sc));
}

// Four consecutive cache elements of a row (8, 16 or 4 bytes, aligned).
template <typename T>
__device__ __forceinline__ void cache4(const __nv_bfloat16* p, float sc,
                                       float (&k)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  k[0] = __low2float(a);
  k[1] = __high2float(a);
  k[2] = __low2float(b);
  k[3] = __high2float(b);
}
template <typename T>
__device__ __forceinline__ void cache4(const float* p, float sc,
                                       float (&k)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  k[0] = raw.x;
  k[1] = raw.y;
  k[2] = raw.z;
  k[3] = raw.w;
}
template <typename T>
__device__ __forceinline__ void cache4(const int8_t* p, float sc,
                                       float (&k)[4]) {
  const char4 raw = *reinterpret_cast<const char4*>(p);
  k[0] = cache_val<T>((int8_t)raw.x, sc);
  k[1] = cache_val<T>((int8_t)raw.y, sc);
  k[2] = cache_val<T>((int8_t)raw.z, sc);
  k[3] = cache_val<T>((int8_t)raw.w, sc);
}

// Bytes a k row takes in a stage: the row and a pad that puts the rows
// read together by one shared-memory phase (four positions of one byte,
// two of two bytes) in different banks.
__host__ __device__ constexpr int k_row_bytes(int D, int cbytes) {
  return D * cbytes + (32 * cbytes) % 128;
}

// One stage: k rows [chunk][k_row_bytes], v rows [chunk][D], and with
// int8 caches the k and v scales [chunk] each.
__host__ __device__ constexpr size_t stage_bytes(int D, int cbytes,
                                                 int chunk, bool quant) {
  return (size_t)chunk * (k_row_bytes(D, cbytes) + D * cbytes) +
         (quant ? 2 * sizeof(float) * chunk : 0);
}

// The shared bytes of a block: two stages, then fp32 q [G][D], s
// [G][chunk], p [chunk][G4] (G4 = G rounded up to 4), acc [G][D], and m,
// l, alpha [G] each.
size_t block_smem(int D, int G, int cbytes, int chunk, bool quant) {
  const int G4 = (G + 3) / 4 * 4;
  return 2 * stage_bytes(D, cbytes, chunk, quant) +
         sizeof(float) * ((size_t)2 * G * D + (size_t)G * chunk +
                          (size_t)chunk * G4 + 3 * (size_t)G);
}

// The launch (decode_attention.py::decode_plan): positions a chunk, the
// chunks, blocks a cluster and the shared bytes a block. A cluster has
// the most blocks, a power of two, at most kMaxCluster and the chunks,
// that keeps the B x nKV clusters within kTargetBlocks (one wave: at
// llama1b's width a block takes ~42 KB, and the card holds 77 clusters of
// 8 such blocks, 154 of 4, at once).
struct DecodePlan {
  int chunk, n_chunks, cluster;
  size_t smem;
};
bool decode_plan(int B, int nKV, int G, int D, int pos, int qbytes,
                 bool quant, DecodePlan& p) {
  p.chunk = kChunk;
  p.smem = block_smem(D, G, quant ? 1 : qbytes, p.chunk, quant);
  if (p.smem > kMaxSmem) return false;
  p.n_chunks = (pos + p.chunk) / p.chunk;       // ceil((pos + 1) / chunk)
  const long long pairs = (long long)B * nKV;
  p.cluster = 1;
  while (p.cluster * 2 <= std::min(kMaxCluster, p.n_chunks) &&
         pairs * p.cluster * 2 <= kTargetBlocks)
    p.cluster *= 2;
  return true;
}

// grid (cluster, nKV, B), clusters of (cluster, 1, 1): one cluster a
// (b, kv head), block r of it chunks [r n / c, (r + 1) n / c). CT: the
// cache element type, T, or int8_t with the scales ksc / vsc [B, nKV, S].
template <typename T, typename CT, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const CT* __restrict__ ck,
              const CT* __restrict__ cv, const float* __restrict__ ksc,
              const float* __restrict__ vsc, T* __restrict__ out, int nKV,
              int G, int S, int pos, int chunk, float scale) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr int kRow = k_row_bytes(D, sizeof(CT));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stage = stage_bytes(D, sizeof(CT), chunk, kQuant);
  const int G4 = (G + 3) / 4 * 4;
  float* q_s = reinterpret_cast<float*>(smem_raw + 2 * stage);
  float* s_s = q_s + G * D;              // [G][chunk]
  float* p_s = s_s + G * chunk;          // [chunk][G4]
  float* acc_s = p_s + chunk * G4;       // [G][D]
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_chunks = (pos + chunk) / chunk;
  const int c_first = rank * n_chunks / csize;
  const int c_end = (rank + 1) * n_chunks / csize;

  const size_t row0 = ((size_t)b * nKV + kh) * S;
  auto issue = [&](int j) {
    unsigned char* st = smem_raw + (size_t)(j % 2) * stage;
    const int p0 = j * chunk, n = min(chunk, pos + 1 - p0);
    const unsigned char* kb =
        reinterpret_cast<const unsigned char*>(ck + (row0 + p0) * D);
    const unsigned char* vb =
        reinterpret_cast<const unsigned char*>(cv + (row0 + p0) * D);
    constexpr int kVecs = D * (int)sizeof(CT) / 16;   // 16-byte vectors a row
    for (int e = tid; e < n * kVecs; e += kThreads) {
      const int c = e / kVecs, x = e % kVecs;
      cp_async16(st + c * kRow + x * 16, kb + (size_t)e * 16);
      cp_async16(st + (size_t)chunk * kRow + (size_t)e * 16,
                 vb + (size_t)e * 16);
    }
    if (kQuant) {
      float* sc = reinterpret_cast<float*>(
          st + (size_t)chunk * (kRow + D * sizeof(CT)));
      for (int c = tid; c < n; c += kThreads) {
        cp_async4(sc + c, ksc + row0 + p0 + c);
        cp_async4(sc + chunk + c, vsc + row0 + p0 + c);
      }
    }
    cp_commit();
  };
  if (c_first < c_end) issue(c_first);     // in flight while q is read
  const T* qb = q + ((size_t)b * nKV * G + (size_t)kh * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    q_s[e] = to_f(qb[e]);
    acc_s[e] = 0.f;
  }
  for (int e = tid; e < chunk * G4; e += kThreads) p_s[e] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const int grp = lane / 8, sub = lane % 8;
  for (int j = c_first; j < c_end; ++j) {
    cp_wait_all();
    __syncthreads();          // chunk j landed; chunk j - 1 consumed
    if (j + 1 < c_end) issue(j + 1);
    const unsigned char* st = smem_raw + (size_t)(j % 2) * stage;
    const CT* ks = reinterpret_cast<const CT*>(st);
    const CT* vs = reinterpret_cast<const CT*>(st + (size_t)chunk * kRow);
    const float* ksc_s = reinterpret_cast<const float*>(
        st + (size_t)chunk * (kRow + D * sizeof(CT)));
    const float* vsc_s = ksc_s + chunk;
    const int n = min(chunk, pos + 1 - j * chunk);

    // scores: positions c (eight lanes each), lanes over d four at a time
    for (int c = warp * 4 + grp; c < chunk; c += 4 * (kThreads / 32)) {
      const CT* krow = reinterpret_cast<const CT*>(
          reinterpret_cast<const unsigned char*>(ks) + c * kRow);
      const float sc = kQuant && c < n ? ksc_s[c] : 0.f;
      for (int g0 = 0; g0 < G; g0 += 4) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (c < n) {
#pragma unroll
          for (int i = 0; i < D / 32; ++i) {
            const int dd = 32 * i + 4 * sub;
            float kv[4];
            cache4<T>(krow + dd, sc, kv);
#pragma unroll
            for (int gg = 0; gg < 4; ++gg) {
              if (g0 + gg >= G) break;
              const float4 qv = *reinterpret_cast<const float4*>(
                  q_s + (g0 + gg) * D + dd);
              a[gg] = fmaf(qv.x, kv[0], a[gg]);
              a[gg] = fmaf(qv.y, kv[1], a[gg]);
              a[gg] = fmaf(qv.z, kv[2], a[gg]);
              a[gg] = fmaf(qv.w, kv[3], a[gg]);
            }
          }
        }
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
#pragma unroll
          for (int o = 4; o > 0; o >>= 1)
            a[gg] += __shfl_xor_sync(0xffffffffu, a[gg], o);
          if (sub == 0 && g0 + gg < G)
            s_s[(g0 + gg) * chunk + c] = c < n ? a[gg] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // the online softmax: a warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      const float* row = s_s + g * chunk;
      float mx = -INFINITY;
      for (int c = lane; c < chunk; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < chunk; c += 32) {
        const float p = expf(row[c] - m_new);
        sum += p;
        p_s[c * G4 + g] = round_to<T>(p);     // p cast before p v
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // values: a thread per (element of d, four query heads)
    for (int e = tid; e < D * (G4 / 4); e += kThreads) {
      const int dd = e % D, g0 = e / D * 4;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        const float vv = cache_val<T>(vs[(size_t)c * D + dd],
                                      kQuant ? vsc_s[c] : 0.f);
        const float4 p = *reinterpret_cast<const float4*>(p_s + c * G4 + g0);
        pv[0] = fmaf(p.x, vv, pv[0]);
        pv[1] = fmaf(p.y, vv, pv[1]);
        pv[2] = fmaf(p.z, vv, pv[2]);
        pv[3] = fmaf(p.w, vv, pv[3]);
      }
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
        if (g0 + gg < G) {
          const int i = (g0 + gg) * D + dd;
          acc_s[i] = acc_s[i] * a_s[g0 + gg] + pv[gg];
        }
    }
  }

  // the cluster's partials, combined in rank (= chunk) order
  cluster.sync();
  for (int e = rank * kThreads + tid; e < G * D; e += csize * kThreads) {
    const int g = e / D;
    float M = -INFINITY;
    for (int r = 0; r < csize; ++r)
      M = fmaxf(M, *cluster.map_shared_rank(m_s + g, r));
    float L = 0.f, A = 0.f;
    for (int r = 0; r < csize; ++r) {
      const float w = expf(*cluster.map_shared_rank(m_s + g, r) - M);
      L = fmaf(*cluster.map_shared_rank(l_s + g, r), w, L);
      A = fmaf(*cluster.map_shared_rank(acc_s + e, r), w, A);
    }
    out[((size_t)b * nKV * G + (size_t)kh * G) * D + e] =
        from_f<T>(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();             // no block leaves while others read it
}

template <typename T, typename CT, int D>
int launch(const void* q, const void* ck, const void* cv, const float* ksc,
           const float* vsc, void* out, int B, int nKV, int G, int S, int pos,
           float scale, cudaStream_t st) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  DecodePlan p;
  if (!decode_plan(B, nKV, G, D, pos, sizeof(T), kQuant, p))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, CT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, nKV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, decode_kernel<T, CT, D>, static_cast<const T*>(q),
      static_cast<const CT*>(ck), static_cast<const CT*>(cv), ksc, vsc,
      static_cast<T*>(out), nKV, G, S, pos, p.chunk, scale);
}

bool shape_ok(int B, int nKV, int G, int S, int d, int pos) {
  return B > 0 && nKV > 0 && G >= 1 && G <= kMaxG && pos >= 0 && pos < S &&
         (d == 64 || d == 128 || d == 256);
}

// Q: int8 caches with scales; q and out in `dtype`.
template <bool Q>
int forward(const void* q, const void* ck, const void* cv, const float* ksc,
            const float* vsc, void* out, int B, int nKV, int G, int S, int d,
            int pos, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, nKV, G, S, d, pos)) return (int)cudaErrorInvalidValue;
  using C16 = typename std::conditional<Q, int8_t, __nv_bfloat16>::type;
  using C32 = typename std::conditional<Q, int8_t, float>::type;
#define ARGS q, ck, cv, ksc, vsc, out, B, nKV, G, S, pos, scale, st
  if (dtype == 1) {
    if (d == 64) return launch<__nv_bfloat16, C16, 64>(ARGS);
    if (d == 128) return launch<__nv_bfloat16, C16, 128>(ARGS);
    return launch<__nv_bfloat16, C16, 256>(ARGS);
  }
  if (dtype == 0) {
    if (d == 64) return launch<float, C32, 64>(ARGS);
    if (d == 128) return launch<float, C32, 128>(ARGS);
    return launch<float, C32, 256>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch as decode_attention plans it (decode_plan): out = {positions
// a chunk, chunks, blocks a cluster, shared bytes a block};
// cudaErrorInvalidValue for a shape the kernel does not take. dtype as
// below; quant 1 for int8 caches.
extern "C" int decode_plan_c(int B, int nKV, int G, int S, int d, int pos,
                             int dtype, int quant, int* out) {
  if (!shape_ok(B, nKV, G, S, d, pos) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  DecodePlan p;
  if (!decode_plan(B, nKV, G, d, pos, dtype == 1 ? 2 : 4, quant != 0, p))
    return (int)cudaErrorInvalidValue;
  out[0] = p.chunk;
  out[1] = p.n_chunks;
  out[2] = p.cluster;
  out[3] = (int)p.smem;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; d in {64, 128, 256}; 1 <= G <= 16;
// 0 <= pos < S. q [B, nKV * G, d]; cache_k / cache_v [B, nKV, S, d];
// out [B, nKV * G, d]. Returns the launch's error (cudaLaunchKernelEx's).
extern "C" int decode_attention(const void* q, const void* ck, const void* cv,
                                void* out, int B, int nKV, int G, int S,
                                int d, int pos, float scale, int dtype,
                                void* stream) {
  return forward<false>(q, ck, cv, nullptr, nullptr, out, B, nKV, G, S, d,
                        pos, scale, dtype, stream);
}

// K10q: int8 cache_k / cache_v with fp32 per-position scales k_scale /
// v_scale [B, nKV, S]; the rest as decode_attention.
extern "C" int decode_attention_int8(const void* q, const void* ck,
                                     const void* cv, const float* k_scale,
                                     const float* v_scale, void* out, int B,
                                     int nKV, int G, int S, int d, int pos,
                                     float scale, int dtype, void* stream) {
  return forward<true>(q, ck, cv, k_scale, v_scale, out, B, nKV, G, S, d,
                       pos, scale, dtype, stream);
}
