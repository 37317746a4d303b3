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
// fp32 output have to cross memory once, at well under one flop per byte.
// At the llama3-8b multi-tenant step (C 32, qb 16, H 4096, bf16) that is
// 4 MB of x and 8 MB (N 4096) or 2 MB (N 1024) of output.
//
// Design. The TPU grid is (row c, N block), the adapter blocks picked by
// the scalar-prefetched ids, and every program forms t = x[c] @ a[ids[c]]
// for its N block. Here a thread-block cluster of 1-8 blocks serves one
// packed row c (lora_plan: the most blocks, a power of two, that divide
// H / 128), and block k of the cluster owns the k-th slice of H and the
// k-th slice of N, so x and a cross memory once and the shrink is done
// once; three blocks fit an SM, so the step's 256 blocks run at once.
// The kernel is a chain of short steps, each waiting on the last, so what
// it does is start every copy first and keep the chain short:
// - a producer warp copies, for each group of 16 rows of x[c] and each
//   chunk of the block's H slice, the rows' runs of the chunk and the
//   chunk's rows of a[ids[c]] into a ring of 2-4 stages, and the block's
//   N slice of b[ids[c]] (1-D bulk copies on mbarriers, a copy a lane,
//   all of a stage issued by one instruction), before it waits for the
//   cluster's other blocks; at the step's shapes that is every byte the
//   block reads, in flight at once;
// - the shrink of the group's 16 rows over the slice: for bf16 at r 8 and
//   16 on the tensor cores (mma.sync m16n8k16, fp32 sums of the exact
//   products; warp w takes an eighth of each chunk, the warps' sums added
//   in warp order), else in fp32 FMAs (two rows a warp, lane l summing
//   h = l, l + 32, .. in order, then a fixed xor tree over the lanes);
//   the tensor cores read x and a from shared memory once (ldmatrix; x
//   rows 16 bytes apart beyond the chunk, so no bank is read twice),
//   where the FMA warps read a once a warp, which bounded the shrink;
// - the block's partials go to every block of the cluster as
//   asynchronous stores into its shared memory that complete bytes on its
//   mbarrier (no fence, no cluster barrier): when its mbarrier has every
//   block's bytes, a block sums the partials in rank order, so every
//   block of the cluster holds the same t [16][r];
// - each block writes its N slice of the group's rows: a thread a run of
//   four columns, sum over j in order, one 16-byte store a row.
// A row's bits depend on x[c, i], its adapter and the plan, which is a
// function of (H, N, r, dtype) alone: not on C, qb, ids or the row's place
// (c, i) in the call (an mma row's sums do not read other rows). Slot 0,
// the all-zero adapter, gives exactly 0.0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowGroup = 16;             // rows of x a pass, 2 a warp
constexpr int kWarps = 8;                 // the shrink and expand warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32; // + the producer warp
constexpr int kMaxCluster = 8;            // a portable cluster
constexpr int kMaxStages = 4;
constexpr int kBlocksPerSm = 3;
constexpr int kBarBytes = 128;            // full, empty [4], ready [2], b
constexpr int kBStageBytes = 16384;       // b's slice in shared memory
constexpr int kXPad = 8;                  // x rows 16 bytes further apart
constexpr size_t kSmSmem = 233472;        // an H100 SM's shared memory
constexpr size_t kBlockReserved = 1024;   // held back by the card a block
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// n consecutive values (n * sizeof(T) a multiple of 8 bytes, as aligned)
// widened to fp32.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[w];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 16 / (int)sizeof(T); ++i)
        v[w * (16 / (int)sizeof(T)) + i] = to_f(e[i]);
    }
  } else {
    static_assert(kBytes == 8, "8 or a multiple of 16 bytes");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(e[i]);
  }
}

// The launch plan (ops/kernels/lora_matmul.py::lora_plan): blocks a
// cluster, the H and N slices a block, the H chunk a stage, stages,
// whether b's slice is staged in shared memory, threads and shared bytes;
// false outside the gate (H % 128, N % 128, r in {4, 8, 16}).
struct LoraPlan {
  int cluster, h_slice, n_slice, h_chunk, stages, b_stage, threads;
  size_t smem;
};

bool lora_plan(int H, int N, int r, size_t itemsize, LoraPlan& p) {
  if (H <= 0 || N <= 0 || H % 128 || N % 128 || (r != 4 && r != 8 && r != 16)
      || (itemsize != 2 && itemsize != 4))
    return false;
  p.cluster = kMaxCluster;
  while ((H / 128) % p.cluster) p.cluster /= 2;
  p.h_slice = H / p.cluster;
  p.n_slice = N / p.cluster;       // a multiple of 16
  const size_t b_bytes = (size_t)r * p.n_slice * itemsize;
  p.b_stage = b_bytes <= kBStageBytes;
  const size_t fixed =
      kBarBytes + (p.b_stage ? b_bytes : 0) +
      sizeof(float) * (2 * kMaxCluster + 1 + kWarps) * kRowGroup * r;
  const size_t room = kSmSmem / kBlocksPerSm - kBlockReserved;
  for (int c = 512; c >= 128; c /= 2) {
    const size_t stage =
        ((size_t)kRowGroup * (c + kXPad) + (size_t)c * r) * itemsize;
    if (p.h_slice % c || fixed + 2 * stage > room) continue;
    p.h_chunk = c;
    p.stages = (int)std::min((size_t)kMaxStages, (room - fixed) / stage);
    p.threads = kThreads;
    p.smem = fixed + (size_t)p.stages * stage;
    return true;
  }
  return false;
}

// The shrink's two routes (lora_wg_kernel): bf16 at r 8 and 16 on the
// tensor cores, the rest in fp32 FMAs.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// smem: full[4], empty[4], ready[2], bfull (from byte 0); the ring of
// stages, each x rows [16][h_chunk + kXPad] then a rows [h_chunk][R] (from
// byte 128); b's slice [R][n_slice] where the plan stages it; fp32
// partials [2][kMaxCluster ranks][16][R], t [16][R] and the warps' sums
// [8][16][R] (the tensor-core route).
// grid (cluster, C), clusters of (cluster, 1, 1): block k of row c's
// cluster owns H slice k and N slice k.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lora_wg_kernel(const T* __restrict__ x, const T* __restrict__ a,
               const T* __restrict__ b, const int* __restrict__ ids,
               float* __restrict__ out, int qb, int H, int N, int h_slice,
               int n_slice, int h_chunk, int stages, int b_stage) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  uint64_t* ready = empty + kMaxStages;
  uint64_t* bfull = ready + 2;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && R >= 8;
  T* ring = reinterpret_cast<T*>(smem_raw + kBarBytes);
  const int xstride = h_chunk + kXPad;
  const int stage_elems = kRowGroup * xstride + h_chunk * R;
  T* b_s = ring + (size_t)stages * stage_elems;
  float* part = reinterpret_cast<float*>(b_s + (b_stage ? R * n_slice : 0));
  float* t_s = part + 2 * kMaxCluster * kRowGroup * R;
  float* red = t_s + kRowGroup * R;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int c = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int h0 = rank * h_slice, n0 = rank * n_slice;
  const int id = ids[c];
  const int n_chunks = h_slice / h_chunk;
  const int n_groups = (qb + kRowGroup - 1) / kRowGroup;
  if (tid == kConsumers) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init(&ready[0], 1);
    mbar_init(&ready[1], 1);
    mbar_init(bfull, 1);
    mbar_init_fence();
  }
  __syncthreads();
  cluster_arrive_relaxed();  // waited for before the first push

  if (warp == kWarps) {      // producer: a copy a lane, issued together
    const uint32_t row_bytes = (uint32_t)(h_chunk * sizeof(T));
    const uint32_t a_bytes = row_bytes * R;
    const uint32_t b_bytes = (uint32_t)(n_slice * sizeof(T));
    for (int i = 0; i < n_groups * n_chunks; ++i) {
      const int s = i % stages;
      const int g = i / n_chunks, hk = h0 + (i % n_chunks) * h_chunk;
      const int rows = min(kRowGroup, qb - g * kRowGroup);
      T* xs = ring + (size_t)s * stage_elems;
      if (lane == 0) {
        mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], rows * row_bytes + a_bytes);
        if (i == 0 && b_stage) mbar_expect_tx(bfull, b_bytes * R);
      }
      __syncwarp();
      if (lane < rows)           // x rows (lanes 0-15), then a's chunk
        bulk_load(smem_u32(xs + lane * xstride),
                  x + ((size_t)c * qb + g * kRowGroup + lane) * H + hk,
                  row_bytes, &full[s]);
      if (lane == 0)
        bulk_load(smem_u32(xs + kRowGroup * xstride),
                  a + ((size_t)id * H + hk) * R, a_bytes, &full[s]);
      // b's slice with the first stage, before any wait on the consumers
      if (i == 0 && b_stage && lane >= 16 && lane < 16 + R)
        bulk_load(smem_u32(b_s + (lane - 16) * n_slice),
                  b + ((size_t)id * R + lane - 16) * N + n0, b_bytes, bfull);
    }
    __syncwarp();
    cluster_wait();
    return;
  }

  // the expand's threads: runs of four columns along N, rows of the group
  // across the rest; b's values from shared memory where staged
  const int runs = n_slice / 4;
  const int run_threads = min(runs, kConsumers);
  const int row_step = kConsumers / run_threads;
  const bool expands = tid < run_threads * row_step;
  const T* bsrc = b_stage ? b_s : b + (size_t)id * R * N + n0;
  const size_t bstride = b_stage ? n_slice : N;
  const uint32_t part_bytes =
      (uint32_t)(csize * kRowGroup * R * sizeof(float));

  int i = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int buf = g & 1;
    if (tid == 0) mbar_expect_tx(&ready[buf], part_bytes);
    if constexpr (kMma) {
      // the tensor cores: warp w takes h_chunk / 8 of each chunk for all
      // 16 rows (m16n8k16, fp32 sums); the warps' sums then add in warp
      // order
      float cf[R / 8][4] = {};
      const int kw = h_chunk / kWarps;
      for (int k = 0; k < n_chunks; ++k, ++i) {
        const int s = i % stages;
        mbar_wait(&full[s], (i / stages) & 1);
        const T* xs = ring + (size_t)s * stage_elems;
        const T* as = xs + kRowGroup * xstride;
        for (int kk = warp * kw; kk < (warp + 1) * kw; kk += 16) {
          uint32_t af[4];
          const int m = lane >> 3;
          ldsm_x4(af, smem_u32(xs + ((lane & 7) + (m & 1) * 8) * xstride +
                               kk + (m >> 1) * 8));
#pragma unroll
          for (int nb = 0; nb < R / 8; ++nb) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1,
                          smem_u32(as + (kk + (lane & 15)) * R + nb * 8));
            mma_bf16(cf[nb], af, b0, b1);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int nb = 0; nb < R / 8; ++nb) {
        float* r0 = red + (warp * kRowGroup + gq) * R + nb * 8 + 2 * tq;
        r0[0] = cf[nb][0];
        r0[1] = cf[nb][1];
        r0[8 * R] = cf[nb][2];
        r0[8 * R + 1] = cf[nb][3];
      }
      named_barrier(1, kConsumers);
      if (g == 0) cluster_wait();   // every block's mbarriers are ready
      // thread (row, 4 columns) pushes the block's sums to every block:
      // [buf][this rank][row]
      if (tid < kRowGroup * R / 4) {
        const int row = tid / (R / 4), j0 = (tid % (R / 4)) * 4;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = red[row * R + j0 + e];
#pragma unroll
          for (int w = 1; w < kWarps; ++w)
            v[e] += red[(w * kRowGroup + row) * R + j0 + e];
        }
        float* dst = part + ((buf * kMaxCluster + rank) * kRowGroup + row) * R
                     + j0;
        for (int k = 0; k < csize; ++k)
          st_async_v4(mapa(smem_u32(dst), k), v[0], v[1], v[2], v[3],
                      mapa(smem_u32(&ready[buf]), k));
      }
    } else {
      const bool two = g * kRowGroup + warp + kWarps < qb;   // warp-uniform
      float acc0[R], acc1[R];
#pragma unroll
      for (int j = 0; j < R; ++j) acc0[j] = acc1[j] = 0.f;
      for (int k = 0; k < n_chunks; ++k, ++i) {
        const int s = i % stages;
        mbar_wait(&full[s], (i / stages) & 1);
        const T* xr = ring + (size_t)s * stage_elems + warp * xstride;
        const T* as = ring + (size_t)s * stage_elems + kRowGroup * xstride;
#pragma unroll 4
        for (int h = lane; h < h_chunk; h += 32) {
          float av[R];
          load_f<T, R>(as + h * R, av);
          const float x0 = to_f(xr[h]);
#pragma unroll
          for (int j = 0; j < R; ++j) acc0[j] = fmaf(x0, av[j], acc0[j]);
          if (two) {
            const float x1 = to_f(xr[kWarps * xstride + h]);
#pragma unroll
            for (int j = 0; j < R; ++j) acc1[j] = fmaf(x1, av[j], acc1[j]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          acc0[j] += __shfl_xor_sync(0xffffffffu, acc0[j], o);
          acc1[j] += __shfl_xor_sync(0xffffffffu, acc1[j], o);
        }
      if (g == 0) cluster_wait();   // every block's mbarriers are ready
      // lane k pushes the rows' partials to block k: [buf][this rank][row]
      if (lane < csize) {
        float* dst =
            part + ((buf * kMaxCluster + rank) * kRowGroup + warp) * R;
        const uint32_t d = mapa(smem_u32(dst), lane);
        const uint32_t bar = mapa(smem_u32(&ready[buf]), lane);
#pragma unroll
        for (int j = 0; j < R; j += 4) {
          st_async_v4(d + 4 * j, acc0[j], acc0[j + 1], acc0[j + 2],
                      acc0[j + 3], bar);
          st_async_v4(d + 4 * (kWarps * R + j), acc1[j], acc1[j + 1],
                      acc1[j + 2], acc1[j + 3], bar);
        }
      }
    }
    if (g == 0 && b_stage) mbar_wait(bfull, 0);
    mbar_wait_cluster(&ready[buf], (g >> 1) & 1);
    // t: the cluster's partials in rank order
    if (tid < kRowGroup * R) {
      const float* p = part + buf * kMaxCluster * kRowGroup * R + tid;
      float v = p[0];
      for (int k = 1; k < csize; ++k) v += p[k * kRowGroup * R];
      t_s[tid] = v;
    }
    named_barrier(1, kConsumers);
    if (expands) {
      for (int run = tid % run_threads; run < runs; run += run_threads) {
        float bcol[R][4];
#pragma unroll
        for (int j = 0; j < R; ++j)
          load_f<T, 4>(bsrc + (size_t)j * bstride + 4 * run, bcol[j]);
        for (int rr = tid / run_threads; rr < kRowGroup; rr += row_step) {
          if (g * kRowGroup + rr >= qb) break;
          const float* tr = t_s + rr * R;
          float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < R; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[e] = fmaf(tr[j], bcol[j][e], o[e]);
          *reinterpret_cast<float4*>(
              out + ((size_t)c * qb + g * kRowGroup + rr) * N + n0 + 4 * run) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
  // a block leaves once every block's partials have reached it: nothing
  // is written into its shared memory after that
}

template <typename T, int R>
int launch_r(const LoraPlan& p, const void* x, const void* a, const void* b,
             const int* ids, float* out, int C, int qb, int H, int N,
             cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      lora_wg_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, C);
  cfg.blockDim = dim3(p.threads);
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
      &cfg, lora_wg_kernel<T, R>, static_cast<const T*>(x),
      static_cast<const T*>(a), static_cast<const T*>(b), ids, out, qb, H,
      N, p.h_slice, p.n_slice, p.h_chunk, p.stages, p.b_stage);
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const int* ids,
           float* out, int C, int qb, int H, int r, int N, cudaStream_t st) {
  LoraPlan p;
  if (!lora_plan(H, N, r, sizeof(T), p)) return (int)cudaErrorInvalidValue;
  if (r == 4) return launch_r<T, 4>(p, x, a, b, ids, out, C, qb, H, N, st);
  if (r == 8) return launch_r<T, 8>(p, x, a, b, ids, out, C, qb, H, N, st);
  return launch_r<T, 16>(p, x, a, b, ids, out, C, qb, H, N, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a and b alike); r in {4, 8, 16};
// qb % 8 == 0, H % 128 == 0, N % 128 == 0 (the reference's gate); every
// pointer 16-byte aligned. x [C, qb, H]; a [S, H, r]; b [S, r, N]; ids [C]
// in [0, S); out [C, qb, N] fp32. *variant: the kernel launched (0, the
// cluster kernel). Returns the launch's CUDA error
// (cudaErrorInvalidValue for a shape outside the gate).
extern "C" int lora_matmul(const void* x, const void* a, const void* b,
                           const int* ids, float* out, int C, int qb, int H,
                           int r, int N, int dtype, void* stream,
                           int* variant) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *variant = -1;
  if (C <= 0 || qb <= 0 || qb % 8) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  if (dtype == 0) err = launch<float>(x, a, b, ids, out, C, qb, H, r, N, st);
  if (dtype == 1)
    err = launch<__nv_bfloat16>(x, a, b, ids, out, C, qb, H, r, N, st);
  if (err == 0) *variant = 0;
  return err;
}

// The plan the launcher follows (lora_plan): out = {blocks a cluster, H
// slice, N slice, H chunk, stages, b staged, threads, shared bytes};
// cudaErrorInvalidValue outside the gate.
extern "C" int lora_plan_c(int H, int N, int r, int itemsize, int* out) {
  LoraPlan p;
  if (!lora_plan(H, N, r, (size_t)itemsize, p))
    return (int)cudaErrorInvalidValue;
  out[0] = p.cluster;
  out[1] = p.h_slice;
  out[2] = p.n_slice;
  out[3] = p.h_chunk;
  out[4] = p.stages;
  out[5] = p.b_stage;
  out[6] = p.threads;
  out[7] = (int)p.smem;
  return 0;
}
