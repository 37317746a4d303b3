// The causal flash forward shared by K1 (flash_attention.cu: the fused-qkv
// entry and the separate-q/k/v entry) and K11 (fused_rope_attention.cu: the
// same tile loop with RoPE applied to q, and optionally k, at the tile
// load), and the tile layout and helpers that the backward (K2, K3, K17)
// uses as well.
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_kernel_native
//   paddle_tpu/ops/pallas/fused_rope_attention.py::_rope_flash_fwd_kernel
// o [B, S, h, d] and lse [B, h, S] fp32 (optional), with s = (q k^T) * scale
// in fp32, causal fill -1e30, p = exp(s - m), l summed over the fp32 p, p
// cast to the input dtype before p v, o = acc / l and lse = m + log(l).
//
// Operands. q, k, v and o each have h heads of d values per sequence row,
// with their own row, head and batch strides: the fused qkv projection is
// three views of one [B, S, 3*h*d] buffer (row stride 3hd, head stride d),
// separate [B, S, h, d] tensors have row stride hd and head stride d, and
// head-major [B, h, S, d] tensors (K17) row stride d and head stride S*d.
// The strides only place the rows: every layout runs the same tile loop,
// so they give the same bits on the same values.
//
// Design. bf16 with head dim 64 or 128 runs fwd_wg_kernel: a block owns
// 128 query rows of one (batch, head), two consumer warpgroups of 64 rows
// and a producer warpgroup that keeps a ring of 128-key (k, v) tiles in
// flight with TMA; q k^T and p v are wgmma products with fp32
// accumulators and the online softmax runs in registers between them.
// Tiles wholly above the diagonal are never visited, the diagonal one is
// masked, and the row blocks are launched heaviest first. fp32, and bf16
// at head dim 256, run a CUDA-core kernel (a thread block a (batch, head,
// 64-row block)) with fp32 FMAs and the same cast points.
//
// RoPE in the tile. With the angle tables cos and sin ([S, d/2] fp32,
// row = sequence position), a row x = [x1, x2] becomes [x1 cos - x2 sin,
// x2 cos + x1 sin]: each product and the sum are rounded on their own
// (__fmul_rn / __fadd_rn, no fma contraction; x1 cos - x2 sin is x1 cos +
// x2 (-sin) in IEEE) and the result is rounded to the input dtype, so the
// rotated tile is bit for bit what the eager apply_rope writes. q is
// rotated once per row block, k once per tile it is read: the rotated
// tensors never reach device memory. In the wgmma kernel the producer
// warpgroup's spare warps rewrite the swizzled tile in shared memory
// after its TMA load and fence the generic proxy's writes against
// wgmma's reads before the consumers are told the tile is ready.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kMaskFill = -1e30f;
constexpr int kRows = 64;   // query rows (or keys) per thread block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
// round to T's precision: the kernels' cast points
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// One element of the rotation: x * c + xs * s, each step rounded.
__device__ __forceinline__ float rope1(float x, float xs, float c, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(xs, s));
}

// Forward operands of one launch.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  long long row_q, row_k, row_v;        // elements between sequence rows
  long long head_q, head_k, head_v;     // elements between heads
  long long batch_q, batch_k, batch_v;  // elements between batches
  void* out;
  long long row_o, head_o, batch_o;     // out's strides
  float* lse;                           // [B, h, S] fp32, or nullptr
  const float* cos_h;                   // [S, d/2] angle tables (RoPE)
  const float* sin_h;
  int S, h, causal;
  float scale;
};

// ---- CUDA-core kernels: fp32, and bf16 at head dim 256 -------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaTile = 32;    // keys (or queries) per inner tile

// Stage rows [r0, r0 + n) of D values, global row stride `stride`, as
// floats with row pitch P; with `rope`, rotated by the tables' rows r0...
// (x1 cos - x2 sin is x1 cos + x2 (-sin) in IEEE).
template <typename T, int D, int P, bool ROPE = false>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t stride, int r0, int n,
                                           int tid, int nthreads,
                                           const float* cos_h = nullptr,
                                           const float* sin_h = nullptr) {
  for (int e = tid; e < n * D; e += nthreads) {
    const int r = e / D, dd = e % D;
    const T* row = src + (size_t)(r0 + r) * stride;
    float x = to_f(row[dd]);
    if (ROPE) {
      const bool lo = dd < D / 2;
      const size_t t = (size_t)(r0 + r) * (D / 2) + (lo ? dd : dd - D / 2);
      x = round_to<T>(rope1(x, to_f(row[lo ? dd + D / 2 : dd - D / 2]),
                            cos_h[t], lo ? -sin_h[t] : sin_h[t]));
    }
    dst[r * P + dd] = x;
  }
}

template <typename T, int D, bool RQ, bool RK>
__global__ void __launch_bounds__(kFmaThreads)
fwd_fma_kernel(const FwdArgs a) {
  constexpr int P = D + 1;
  constexpr int kAcc = kRows * D / kFmaThreads;
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][P]
  float* ks = qs + kRows * P;           // [kFmaTile][P]
  float* vs = ks + kFmaTile * P;        // [kFmaTile][P]
  float* ss = vs + kFmaTile * P;        // [kRows][kFmaTile]
  float* m_s = ss + kRows * kFmaTile;   // [kRows]
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  const int q0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, h = a.h, causal = a.causal;
  const float scale = a.scale;
  const T* qb = static_cast<const T*>(a.q) + b * a.batch_q + hh * a.head_q;
  const T* kb = static_cast<const T*>(a.k) + b * a.batch_k + hh * a.head_k;
  const T* vb = static_cast<const T*>(a.v) + b * a.batch_v + hh * a.head_v;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_rows<T, D, P, RQ>(qs, qb, a.row_q, q0, kRows, tid, kFmaThreads,
                          a.cos_h, a.sin_h);
  for (int r = tid; r < kRows; r += kFmaThreads) {
    m_s[r] = kMaskFill;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int n_tiles = causal ? (q0 + kRows) / kFmaTile : S / kFmaTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFmaTile;
    stage_rows<T, D, P, RK>(ks, kb, a.row_k, k0, kFmaTile, tid, kFmaThreads,
                            a.cos_h, a.sin_h);
    stage_rows<T, D, P>(vs, vb, a.row_v, k0, kFmaTile, tid, kFmaThreads);
    __syncthreads();
    for (int e = tid; e < kRows * kFmaTile; e += kFmaThreads) {
      const int r = e / kFmaTile, c = e % kFmaTile;
      float s = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) s = fmaf(qs[r * P + dd], ks[c * P + dd], s);
      s *= scale;
      ss[e] = (causal && k0 + c > q0 + r) ? kMaskFill : s;
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kFmaThreads / 32) {
      float mx = ss[r * kFmaTile + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(ss[r * kFmaTile + lane] - m_new);
      ss[r * kFmaTile + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int e = tid + k * kFmaThreads;
      const int r = e / D, dd = e % D;
      float acc_k = acc[k] * a_s[r];
#pragma unroll 8
      for (int c = 0; c < kFmaTile; ++c)
        acc_k = fmaf(round_to<T>(ss[r * kFmaTile + c]), vs[c * P + dd], acc_k);
      acc[k] = acc_k;
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int e = tid + k * kFmaThreads;
    const int r = e / D, dd = e % D;
    out[b * a.batch_o + (q0 + r) * a.row_o + hh * a.head_o + dd] =
        from_f<T>(acc[k] / l_s[r]);
  }
  if (a.lse != nullptr)
    for (int r = tid; r < kRows; r += kFmaThreads)
      a.lse[((size_t)b * h + hh) * S + q0 + r] = m_s[r] + logf(l_s[r]);
}

template <int D>
constexpr size_t fwd_fma_smem() {
  return sizeof(float) * ((kRows + 2 * kFmaTile) * (D + 1) +
                          kRows * kFmaTile + 3 * kRows);
}

// ---- tensor-core kernels: bf16, head dim 64 or 128 (TMA + wgmma) ----------
//
// A block owns 128 rows (query rows; keys in the dk/dv loop): two consumer
// warpgroups of 64 rows each and one producer warpgroup, one thread of
// which keeps a ring of tiles in flight with TMA (mbarrier full/empty
// pairs). Operands are 4-D tensor maps over (d, S, h, B) with the
// layout's byte strides, boxes of 64 rows x 64 values (128 bytes, the
// 128-byte swizzle): a tile of R rows and head dim D is D / 64 chunks of
// R 128-byte rows. Past S (S % 128 == 64) TMA loads zeros, the keys are
// masked and TMA stores clip the rows. The products are wgmma m64nNk16
// with fp32 accumulators: q k^T with both operands in shared memory
// (K-major), p v with p in registers (the accumulator layout is register
// A's) and v MN-major (imm-trans-b). setmaxnreg gives the consumers 240
// registers and the producer 24 (216 and 72 when the producer's spare
// warps rotate for RoPE).

constexpr int kWgRows = 128;       // rows a block: 2 consumer warpgroups
constexpr int kWgThreads = 384;    // + 1 producer warpgroup
constexpr int kRegsAtEntry = 168;  // 65536 / 384, what ptxas gives
constexpr int kRegsProducer = 24;  // setmaxnreg after the role split:
constexpr int kRegsConsumer = 240; // 128 x 24 + 256 x 240 <= 384 x 168
static_assert(128 * kRegsProducer + 256 * kRegsConsumer <=
              kWgThreads * kRegsAtEntry, "setmaxnreg over the block's pool");
constexpr int kBoxRows = 64;       // rows of a TMA box (64 x 64 bf16, 8 KB)
constexpr int kFwdKeys = 128;      // keys a forward tile
constexpr int kBwdTile = 64;       // keys (dq) or queries (dk/dv) a tile
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;   // shared memory a block may take
constexpr int kSmemFixed = 1024 + 256;  // base alignment, barriers
constexpr long long kL2Chunk = 16ll << 20;  // L2 bytes a chunk's tiles take
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kFwdKeys == kWgRows, "causal forward: tile j of block j");

// The variant a shape takes: TMA + wgmma for bf16 at head dim 64 or 128.
inline bool wg_variant(int d, int dtype) {
  return dtype == 1 && (d == 64 || d == 128);
}
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return rows * d * 2;
}
__host__ __device__ constexpr int min_int(int x, int y) {
  return x < y ? x : y;
}
// (batch, head) pairs a chunk of the work order holds: as many whose two
// streamed operands (S x d bf16 each) fit in kL2Chunk, at least one.
inline int l2_chunk(int S, int d, int nbh) {
  const long long per = 2ll * S * d * 2;
  const long long c = kL2Chunk / per;
  return c < 1 ? 1 : c > nbh ? nbh : (int)c;
}

// The forward's shared memory: two q buffers (128 rows each; the next
// item's q loads while this one's runs), a ring of k tiles (a slot is
// free once its q k^T is done) and a ring of v tiles (once its p v is),
// the v ring the deeper since the loop holds v one tile longer.
template <int D> struct FwdWg {
  static constexpr int kQ = tile_bytes(kWgRows, D);
  static constexpr int kTile = tile_bytes(kFwdKeys, D);
  static constexpr int kSlots = (kSmemMax - kSmemFixed - 2 * kQ) / kTile;
  static constexpr int kVStages = min_int(kMaxStages, (kSlots + 1) / 2);
  static constexpr int kStages = min_int(kMaxStages, kSlots - kVStages);
  static constexpr int kSmem =
      kSmemFixed + 2 * kQ + (kStages + kVStages) * kTile;
};

// The row block and (batch, head) of work item ``item`` of nrb x nbh. The
// (batch, head) pairs go in chunks of ``chunk`` whose k and v (or q and
// do) fit in L2 together; within a chunk the row blocks vary slowest,
// from the last (the heaviest under causality: the forward, dq) when
// ``reverse``, and every pair of the chunk takes a row block before the
// next: a chunk's row blocks run side by side and read its tiles from L2.
__device__ __forceinline__ void block_place(int item, int nrb, int h, int nbh,
                                            int chunk, bool reverse, int& rb,
                                            int& hh, int& b) {
  const int c = item / (nrb * chunk), r = item % (nrb * chunk);
  const int cb = min_int(chunk, nbh - c * chunk);   // pairs in this chunk
  const int l = r / cb, bh = c * chunk + r % cb;
  rb = reverse ? nrb - 1 - l : l;
  hh = bh % h;
  b = bh / h;
}

__device__ __forceinline__ uint16_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}
__device__ __forceinline__ float bf16_val(uint16_t u) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
}
// 2^x by the SFU (ex2.approx.ftz: 2 ulp; the softmax's p is rounded to
// bf16 before p v, and its sum is an fp32 sum of such terms).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// wgmma's accumulator layout (m64nN, fp32): register i of a thread holds
// row 16 w + g + 8 ((i >> 1) & 1) of the warpgroup's 64 (w the warp, g =
// lane / 4) and column acc_col(i, t) (t = lane % 4).
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}
// Register A of a k16 step (64 x 16) from columns 16 kk .. 16 kk + 15 of
// an accumulator of the same rows, rounded to bf16: the two layouts agree.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[N],
                                         int kk) {
  a[0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}
// Accumulator x (m64nN; this thread's rows are row and row + 8 of the
// tile) times mul_lo / mul_hi by row, rounded to bf16, into a swizzled
// tile of R rows in the tile layout: the swizzle keeps a warp's 8 rows on
// distinct banks.
template <int R, int N>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&x)[N], float mul_lo,
                                          float mul_hi, int row, int t) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int r = row + ((i & 2) ? 8 : 0);
    const int col = acc_col(i, t), cc = col & 63;
    const float mul = (i & 2) ? mul_hi : mul_lo;
    *reinterpret_cast<uint32_t*>(tile + (col >> 6) * R * 128 + r * 128 +
                                 (((cc >> 3) ^ (r & 7)) << 4) +
                                 (cc & 7) * 2) =
        pack_bf16(x[i] * mul, x[i + 1] * mul);
  }
}
// The warp's share of releasing a ring stage.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Rotate unit u of row r (at sequence position pos) of a swizzled
// head-dim-128 tile of R rows in place, with its angles c[8], s[8]:
// 16-byte unit u of row r sits at unit u ^ (r & 7) of the row, so the
// pair (j, j + 64) is the same unit of chunks 0 and 1.
template <int R>
__device__ __forceinline__ void rope_unit(unsigned char* tile, int r, int u,
                                          const float4 (&c)[2],
                                          const float4 (&s)[2]) {
  unsigned char* row = tile + r * 128 + ((u ^ (r & 7)) << 4);
  uint4* p1 = reinterpret_cast<uint4*>(row);
  uint4* p2 = reinterpret_cast<uint4*>(row + R * 128);
  const uint4 v1 = *p1, v2 = *p2;
  const uint16_t* x1 = reinterpret_cast<const uint16_t*>(&v1);
  const uint16_t* x2 = reinterpret_cast<const uint16_t*>(&v2);
  const float* cf = reinterpret_cast<const float*>(c);
  const float* sf = reinterpret_cast<const float*>(s);
  uint4 w1, w2;
  uint16_t* y1 = reinterpret_cast<uint16_t*>(&w1);
  uint16_t* y2 = reinterpret_cast<uint16_t*>(&w2);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a = bf16_val(x1[k]), b = bf16_val(x2[k]);
    y1[k] = bf16_bits(rope1(a, b, cf[k], -sf[k]));
    y2[k] = bf16_bits(rope1(b, a, cf[k], sf[k]));
  }
  *p1 = w1;
  *p2 = w2;
}

// Rotate the rows of such a tile, row r at sequence position pos0 + r
// (rows at or past S are left alone), thread ``tid`` of ``nthreads``
// taking U units at a time with their angle loads in flight together.
template <int R, int U>
__device__ __forceinline__ void rope_tile(unsigned char* tile, int pos0,
                                          int S, const float* cos_h,
                                          const float* sin_h, int tid,
                                          int nthreads) {
  const int n = min_int(R, S - pos0) * 8;     // units of the rows before S
  for (int e = tid; e < n; e += U * nthreads) {
    float4 c[U][2], s[U][2];
#pragma unroll
    for (int w = 0; w < U; ++w) {
      const int ew = min_int(e + w * nthreads, n - 1);
      const size_t o = (size_t)(pos0 + (ew >> 3)) * 64 + (ew & 7) * 8;
      const float4* c4 = reinterpret_cast<const float4*>(cos_h + o);
      const float4* s4 = reinterpret_cast<const float4*>(sin_h + o);
      c[w][0] = c4[0];
      c[w][1] = c4[1];
      s[w][0] = s4[0];
      s[w][1] = s4[1];
    }
#pragma unroll
    for (int w = 0; w < U; ++w) {
      const int ew = e + w * nthreads;
      if (ew < n) rope_unit<R>(tile, ew >> 3, ew & 7, c[w], s[w]);
    }
  }
}

// A map over one operand's (d, S, h, B) with its row, head and batch
// strides (elements), boxes of 64 values x 64 rows. Encoding one costs
// microseconds on the host, a visible share of a short kernel's launch,
// so the last 64 are kept, direct-mapped on their arguments, in a cache
// of each host thread's own (callers through ctypes run without the
// interpreter's lock, so two threads may launch at once).
inline bool head_map(CUtensorMap* map, const void* ptr, int d, int S, int h,
                     int B, long long row, long long head, long long batch) {
  struct Entry {
    const void* ptr;
    long long key[7];
    CUtensorMap map;
  };
  static thread_local Entry cache[64] = {};
  const long long key[7] = {d, S, h, B, row, head, batch};
  uint64_t hsh = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (long long k : key) hsh = hsh * 1000003u ^ (uint64_t)k;
  Entry& e = cache[(hsh ^ (hsh >> 29)) & 63];
  bool same = e.ptr == ptr;
  for (int i = 0; i < 7 && same; ++i) same = e.key[i] == key[i];
  if (!same) {
    const uint64_t dims[4] = {(uint64_t)d, (uint64_t)S, (uint64_t)h,
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)row * 2, (uint64_t)head * 2,
                                 (uint64_t)batch * 2};
    const uint32_t box[4] = {64, kBoxRows, 1, 1};
    if (!make_map(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 4, dims,
                  strides, box)) {
      e.ptr = nullptr;
      return false;
    }
    e.ptr = ptr;
    for (int i = 0; i < 7; ++i) e.key[i] = key[i];
  }
  *map = e.map;
  return true;
}

// The forward, persistent: each block takes work items of the order of
// block_place (L2 chunks, heaviest first within a chunk), its first
// blockIdx.x and then the next unclaimed one from a counter (dynamic
// scheduling: a block that drew light items takes more), an item being
// the 128 query rows of one row block of one (batch, head). Rows q0 +
// 64 wg .. are consumer warpgroup wg's; key tiles 0 .. n_tiles - 1 (the
// causal bound: tile rb of row block rb, the last one masked); online
// softmax in the log2 domain (p = 2^((s - m) scale log2 e) by one fma and
// ex2.approx a score, m the running max of the raw s), p rounded to bf16
// for p v, l summed over the fp32 p; lse = m scale + log l. Within a warpgroup
// tile j's q k^T and tile j - 1's p v are issued before tile j's softmax,
// which then runs on the ALUs while the tensor cores work
// (FlashAttention-3's overlap inside a warpgroup). The producer's TMA
// thread claims the items and runs ahead across them: q is double
// buffered, so the next item's q and first tiles load while this one
// runs; k and v have rings of their own (FwdWg). o / l goes to shared
// memory (the last tile's k buffer, kept until both warpgroups' last
// q k^T is done) in the tile layout and out by TMA stores, which clip
// rows past S. With RoPE the producer warpgroup's other three warps
// rotate q (and, with RK, every k tile) after its load and mark it ready.
// ``sched`` is {claim counter, blocks done}, both 0 at launch; the last
// block to finish sets them back to 0. Launches that may overlap must not
// share it (flash_attention.py's sched_scratch: one a stream, one of its own
// for each launch a CUDA graph captures).
template <int D, bool RQ, bool RK>
__global__ void __launch_bounds__(kWgThreads, 1)
fwd_wg_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap omap, const FwdArgs a,
              int B, int chunk, int* sched) {
  static_assert(D == 64 || D == 128, "head dim");
  static_assert(!(RQ || RK) || D == 128, "RoPE in the tile: head dim 128");
  using Plan = FwdWg<D>;
  constexpr int NC = D / 64, SK = Plan::kStages, SV = Plan::kVStages;
  constexpr int kQChunk = kWgRows * 128, kKChunk = kFwdKeys * 128;
  constexpr int NK = kFwdKeys / 16;          // k16 steps of p v
  constexpr int kKRing = 2 * Plan::kQ;       // the rings' offsets
  constexpr int kVRing = kKRing + SK * Plan::kTile;
  // with RoPE the rotating warps need registers (three units' angles in
  // flight): 72 / 216, else 24 / 240
  constexpr int kProd = (RQ || RK) ? 72 : kRegsProducer;
  constexpr int kCons = (RQ || RK) ? 216 : kRegsConsumer;
  static_assert(128 * kProd + 256 * kCons <= kWgThreads * kRegsAtEntry,
                "setmaxnreg over the block's pool");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + kVRing +
                                                 SV * Plan::kTile);
  uint64_t* q_ready = q_full + 2;       // rotated (RQ)
  uint64_t* q_empty = q_full + 4;       // the item's last q k^T is done
  uint64_t* k_full = q_full + 6;
  uint64_t* k_ready = k_full + SK;      // rotated (RK)
  uint64_t* k_empty = k_ready + SK;
  uint64_t* v_full = k_empty + SK;
  uint64_t* v_empty = v_full + SV;
  int* slot = reinterpret_cast<int*>(v_empty + SV);   // item of q buffer
  const int S = a.S, causal = a.causal, tid = threadIdx.x;
  const int nrb = (S + kWgRows - 1) / kWgRows;
  const int n_items = nrb * a.h * B;
  if (tid == 0) {
    for (int q = 0; q < 2; ++q) {
      mbar_init(&q_full[q], 1);
      mbar_init(&q_ready[q], 1);
      mbar_init(&q_empty[q], 8);        // the consumers' eight warps
    }
    for (int s = 0; s < SK; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_ready[s], 1);
      mbar_init(&k_empty[s], 8);
    }
    for (int s = 0; s < SV; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // an item's row block, (batch, head) and key tiles
  auto item_of = [&](int item, int& rb, int& hh, int& b) {
    block_place(item, nrb, a.h, n_items / nrb, chunk, causal != 0, rb, hh,
                b);
    return causal ? rb + 1 : (S + kFwdKeys - 1) / kFwdKeys;
  };

  if (tid >= 256) {                     // producer warpgroup
    setmaxnreg_dec<kProd>();
    int rb, hh, b, jg = 0;
    if (tid == 256) {                   // the TMA thread
      for (int it = 0;; ++it) {
        const int qb = it & 1;
        mbar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);
        const int item = it == 0 ? blockIdx.x
                                 : gridDim.x + atomicAdd(&sched[0], 1);
        slot[qb] = item;
        if (item >= n_items) {          // no more: tell the others
          mbar_arrive(&q_full[qb]);
          break;
        }
        const int n_tiles = item_of(item, rb, hh, b);
        const uint32_t qdst = base + qb * Plan::kQ;
        mbar_expect_tx(&q_full[qb], Plan::kQ);
        for (int c = 0; c < NC; ++c)
          for (int r = 0; r < kWgRows; r += kBoxRows)
            tma_load_4d(qdst + c * kQChunk + r * 128, &qmap, c * 64,
                        rb * kWgRows + r, hh, b, &q_full[qb]);
        for (int j = 0; j < n_tiles; ++j, ++jg) {
          const int ks = jg % SK, vs = jg % SV;
          mbar_wait(&k_empty[ks], ((jg / SK) & 1) ^ 1);
          const uint32_t kt = base + kKRing + ks * Plan::kTile;
          mbar_expect_tx(&k_full[ks], Plan::kTile);
          for (int c = 0; c < NC; ++c)
            for (int r = 0; r < kFwdKeys; r += kBoxRows)
              tma_load_4d(kt + c * kKChunk + r * 128, &kmap, c * 64,
                          j * kFwdKeys + r, hh, b, &k_full[ks]);
          mbar_wait(&v_empty[vs], ((jg / SV) & 1) ^ 1);
          const uint32_t vt = base + kVRing + vs * Plan::kTile;
          mbar_expect_tx(&v_full[vs], Plan::kTile);
          for (int c = 0; c < NC; ++c)
            for (int r = 0; r < kFwdKeys; r += kBoxRows)
              tma_load_4d(vt + c * kKChunk + r * 128, &vmap, c * 64,
                          j * kFwdKeys + r, hh, b, &v_full[vs]);
        }
      }
      // every block has claimed its last item before it counts itself
      // done, so the last one may reset the counters for the next launch
      if (atomicAdd(&sched[1], 1) == (int)gridDim.x - 1) {
        atomicExch(&sched[0], 0);
        atomicExch(&sched[1], 0);
      }
    } else if ((RQ || RK) && tid >= 288) {   // the rotating warps
      const int rt = tid - 288;
      for (int it = 0;; ++it) {
        const int qb = it & 1;
        mbar_wait(&q_full[qb], (it >> 1) & 1);
        const int item = slot[qb];
        if (item >= n_items) {
          if (RQ && rt == 0) mbar_arrive(&q_ready[qb]);
          break;
        }
        const int n_tiles = item_of(item, rb, hh, b);
        if (RQ) {
          rope_tile<kWgRows, 3>(sm + qb * Plan::kQ, rb * kWgRows, S,
                                a.cos_h, a.sin_h, rt, 96);
          fence_proxy_async();
          named_barrier(1, 96);
          if (rt == 0) mbar_arrive(&q_ready[qb]);
        }
        for (int j = 0; j < n_tiles; ++j, ++jg) {
          if (!RK) continue;
          const int ks = jg % SK;
          mbar_wait(&k_full[ks], (jg / SK) & 1);
          rope_tile<kFwdKeys, 3>(sm + kKRing + ks * Plan::kTile,
                                 j * kFwdKeys, S, a.cos_h, a.sin_h, rt, 96);
          fence_proxy_async();
          named_barrier(1, 96);
          if (rt == 0) mbar_arrive(&k_ready[ks]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kCons>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t = lane & 3;
  const float scale_log2 = a.scale * kLog2e;
  uint64_t* q_wait = RQ ? q_ready : q_full;
  uint64_t* k_wait = RK ? k_ready : k_full;
  int jg = 0;                            // ring position, as the producer's
  for (int it = 0;; ++it) {
    const int qb = it & 1;
    mbar_wait(&q_wait[qb], (it >> 1) & 1);
    const int item = slot[qb];
    if (item >= n_items) break;
    int rb, hh, b;
    const int n_tiles = item_of(item, rb, hh, b);
    const int q0 = rb * kWgRows;
    const int r_lo = q0 + 64 * wg + 16 * warp + (lane >> 2);
    const int r_hi = r_lo + 8;
    const uint32_t q_s = base + qb * Plan::kQ + wg * 64 * 128;   // own rows
    float o[D / 2], sc[kFwdKeys / 2];
    uint32_t pa[NK][4];                  // the last tile's p, register A
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
    float a_lo = 0.f, a_hi = 0.f;       // the running sums' rescale
    // s of tile j: q k^T from shared memory (issued, not waited for)
    auto issue_s = [&](int j) {
      const int ks = (jg + j) % SK;
      const uint32_t kt = base + kKRing + ks * Plan::kTile;
      mbar_wait(&k_wait[ks], ((jg + j) / SK) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kFwdKeys>(
            sc, sw128_desc(q_s + (kk >> 2) * kQChunk + (kk & 3) * 32),
            sw128_desc(kt + (kk >> 2) * kKChunk + (kk & 3) * 32), kk > 0);
      wgmma_commit();
    };
    // o += p v of tile j, p from the registers pa
    auto issue_pv = [&](int j) {
      const int vs = (jg + j) % SV;
      const uint32_t vt = base + kVRing + vs * Plan::kTile;
      mbar_wait(&v_full[vs], ((jg + j) / SV) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)   // keys 16 kk.. of v, MN-major
        wgmma_rs<D, 1>(o, pa[kk], sw128_mn_desc(vt + kk * 2048, kKChunk));
      wgmma_commit();
    };
    // the online softmax of tile j's s (in sc): the running max (of the
    // raw s: scaling by a positive number keeps the order), p = 2^(s c -
    // m c) with c = scale log2 e (one fma and ex2 a score), the rescale
    // a_lo / a_hi and the running sums, each thread its own columns' (the
    // four threads of a row are summed at the end), and p in sc
    auto softmax = [&](int j) {
      const bool edge = j == n_tiles - 1;   // the diagonal, or keys past S
      const int k0 = j * kFwdKeys;
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        if (edge) {
          const int kpos = k0 + acc_col(i, t);
          if (kpos >= S || (causal && kpos > ((i & 2) ? r_hi : r_lo)))
            sc[i] = -INFINITY;
        }
        if (i & 2) mx_hi = fmaxf(mx_hi, sc[i]);
        else mx_lo = fmaxf(mx_lo, sc[i]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // tile 0 holds key 0 <= every row, so the running max is finite
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float ms_lo = mn_lo * scale_log2, ms_hi = mn_hi * scale_log2;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        const float p = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -ms_hi
                                                            : -ms_lo));
        sc[i] = p;
        if (i & 2) sum_hi += p;
        else sum_lo += p;
      }
      a_lo = ex2(fmaf(m_lo, scale_log2, -ms_lo));
      a_hi = ex2(fmaf(m_hi, scale_log2, -ms_hi));
      l_lo = a_lo * l_lo + sum_lo;
      l_hi = a_hi * l_hi + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
    };
    auto to_pa = [&]() {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) acc_to_a(pa[kk], sc, kk);
    };

    // tile j's s and tile j - 1's p v run on the tensor cores while tile
    // j's softmax runs: issue s_j, then p v_{j-1}; wait for s_j alone and
    // free its k (the last tile's k is kept for o); softmax_j; wait for
    // p v_{j-1}, free its v, rescale o; p_j.
    issue_s(0);
    wgmma_wait<0>();
    fence_operands(sc);
    if (n_tiles == 1) release(&q_empty[qb]);   // q may be reloaded
    else release(&k_empty[jg % SK]);
    softmax(0);
    to_pa();
    for (int j = 1; j < n_tiles; ++j) {
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();
      fence_operands(sc);
      if (j == n_tiles - 1) release(&q_empty[qb]);
      else release(&k_empty[(jg + j) % SK]);
      softmax(j);
      wgmma_wait<0>();
      fence_operands(o);
      release(&v_empty[(jg + j - 1) % SV]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a_hi : a_lo;
      to_pa();
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_operands(o);
    release(&v_empty[(jg + n_tiles - 1) % SV]);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the row sums, whole
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    // o / l, rounded, into the last tile's k buffer in the tile layout
    // once both
    // warpgroups' last q k^T has read it (q_empty's phase), then out by
    // one thread of the warpgroup; the stage is freed once it is read
    mbar_wait(&q_empty[qb], (it >> 1) & 1);
    const int sl = (jg + n_tiles - 1) % SK;
    const uint32_t stage = base + kKRing + sl * Plan::kTile;
    stage_acc<kFwdKeys>(sm + kKRing + sl * Plan::kTile, o, 1.f / l_lo,
                        1.f / l_hi, 64 * wg + 16 * warp + (lane >> 2), t);
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if ((tid & 127) == 0) {
      for (int c = 0; c < NC; ++c)
        tma_store_4d(&omap, stage + c * kKChunk + wg * 64 * 128, c * 64,
                     q0 + 64 * wg, hh, b);
      bulk_commit();
      bulk_wait_read();
    }
    named_barrier(2 + wg, 128);
    release(&k_empty[sl]);
    jg += n_tiles;
    if (t == 0 && a.lse != nullptr) {
      float* lrow = a.lse + ((size_t)b * a.h + hh) * S;
      if (r_lo < S) lrow[r_lo] = m_lo * a.scale + logf(l_lo);
      if (r_hi < S) lrow[r_hi] = m_hi * a.scale + logf(l_hi);
    }
  }
}

// ---- launchers -----------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D, bool RQ, bool RK>
cudaError_t fwd_fma(const FwdArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem = fwd_fma_smem<D>();
  cudaError_t err = set_smem(fwd_fma_kernel<T, D, RQ, RK>, smem);
  if (err != cudaSuccess) return err;
  fwd_fma_kernel<T, D, RQ, RK><<<grid, kFmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The launch of a TMA + wgmma kernel with ``smem`` bytes: the first call
// checks the entry registers (setmaxnreg's pool) and sets the shared
// memory attribute.
template <typename K>
cudaError_t wg_ready(K kernel, int smem, bool& ready) {
  if (ready) return cudaSuccess;
  cudaError_t err = check_entry_regs(kernel, kRegsAtEntry);
  if (err == cudaSuccess) err = set_smem(kernel, smem);
  ready = err == cudaSuccess;
  return err;
}

// The SMs of the current device: the persistent kernels' grid.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int D, bool RQ, bool RK>
cudaError_t fwd_wg(const FwdArgs& a, int B, int* sched, cudaStream_t st) {
  using Plan = FwdWg<D>;
  CUtensorMap qm, km, vm, om;
  if (sched == nullptr ||
      !head_map(&qm, a.q, D, a.S, a.h, B, a.row_q, a.head_q, a.batch_q) ||
      !head_map(&km, a.k, D, a.S, a.h, B, a.row_k, a.head_k, a.batch_k) ||
      !head_map(&vm, a.v, D, a.S, a.h, B, a.row_v, a.head_v, a.batch_v) ||
      !head_map(&om, a.out, D, a.S, a.h, B, a.row_o, a.head_o, a.batch_o))
    return cudaErrorNotSupported;
  static bool ready = false;
  cudaError_t err = wg_ready(fwd_wg_kernel<D, RQ, RK>, Plan::kSmem, ready);
  if (err != cudaSuccess) return err;
  const int items = (a.S + kWgRows - 1) / kWgRows * a.h * B;
  const int grid = items < sm_count() ? items : sm_count();
  fwd_wg_kernel<D, RQ, RK><<<grid, kWgThreads, Plan::kSmem, st>>>(
      qm, km, vm, om, a, B, l2_chunk(a.S, D, a.h * B), sched);
  return cudaGetLastError();
}

// One forward launch. dtype: 0 = float32, 1 = bfloat16; S % 64 == 0; d
// in {64, 128, 256} without RoPE and in {128, 256} with it. The variant is
// wg_variant's, as flash_plan_c's, and is written to *variant (1: TMA +
// wgmma, 0: FMA): bf16 at d 64 and 128 takes the persistent TMA + wgmma
// kernel (one block an SM, at most one a work item; ``sched`` two ints, 0
// before the launch, which the kernel leaves 0), the rest the FMA kernel
// (a B x h x S/64 grid). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a geometry the kernels do not take,
// cudaErrorNotSupported when no tensor map could be made or no sched).
template <bool RQ, bool RK>
int flash_fwd_launch(const FwdArgs& a, int B, int d, int dtype, int* sched,
                     cudaStream_t st, int* variant) {
  if (a.S % kRows || a.S <= 0 || variant == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.S / kRows, a.h, B);
  constexpr bool kRope = RQ || RK;
  if (wg_variant(d, dtype)) {
    *variant = 1;
    if (d == 128) return (int)fwd_wg<128, RQ, RK>(a, B, sched, st);
    if constexpr (!kRope) return (int)fwd_wg<64, RQ, RK>(a, B, sched, st);
    return (int)cudaErrorInvalidValue;     // RoPE in the tile: d 128
  }
  *variant = 0;
  if (dtype == 1 && d == 256)
    return (int)fwd_fma<__nv_bfloat16, 256, RQ, RK>(a, grid, st);
  if (dtype == 0) {
    if constexpr (!kRope) {
      if (d == 64) return (int)fwd_fma<float, 64, RQ, RK>(a, grid, st);
    }
    if (d == 128) return (int)fwd_fma<float, 128, RQ, RK>(a, grid, st);
    if (d == 256) return (int)fwd_fma<float, 256, RQ, RK>(a, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
