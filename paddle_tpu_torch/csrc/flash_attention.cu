// Causal flash attention for Hopper (sm_90a): the forward (K1), the merged
// backward (K2), the split backward (K3) and the head-major forward and
// split backward (K17).
//
// Replaces the Pallas TPU kernels
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_kernel_native
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_bwd_fused_kernel_native
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_bwd_dq_kernel_native
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_bwd_dkv_kernel_native
//   paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_kernel,
//     _flash_bwd_dq_kernel, _flash_bwd_dkv_kernel (head-major, K17)
// The forward (flash_fwd.cuh) has two entries: flash_fwd on the fused qkv
// projection [B, S, 3*h*d] (q, k and v at lane offsets 0, H and 2H, H = h*d,
// head j at j*d, read in place; the entry flash_attention_qkv_raw), and
// flash_fwd_sep on separate q, k, v [B, S, h, d] (flash_attention_raw in
// the native layout, as LLaMA calls it). The merged backward flash_bwd is
// on the fused qkv: dqkv [B, S, 3H] written at the same lane offsets (no
// concatenate). The split backward is two entries, flash_bwd_dq and
// flash_bwd_dkv, that take q, k, v and dq, dk, dv as base pointers with one
// row stride for the inputs and one for the outputs: 3H on the fused qkv
// (dq, dk, dv written into one dqkv at lane offsets 0, H, 2H) and H on
// separate [B, S, h, d] tensors. All compute, from the saved lse,
// p = exp(s * scale - lse) masked to 0, dp = do v^T, ds = p (dp - delta)
// cast to the input dtype, dq = ds k * scale, dk = ds^T q * scale,
// dv = cast(p)^T do. delta = rowsum(do * o) is computed by the caller in
// fp32.
//
// K17 is the head-major layout the TPU reaches under
// FLAGS_flash_attention_native_layout=0 or where its lane fusion fails (d 64
// with an odd head count): q, k, v, do, o, dq, dk and dv [B, h, S, d]. The
// TPU runs other kernel bodies there (head blocks of a [b, h, s, d] grid);
// here the layout is only strides (row d, head S*d), so flash_fwd_hm,
// flash_bwd_hm_dq and flash_bwd_hm_dkv run K1's and K3's bodies and give
// their bits on the same values.
//
// Design. The TPU grid walks q blocks in order with the hp-heads lane
// fusion and an 8-row lse packing, both artefacts of its (8, 128) tiling.
// Here one thread block owns one (batch, head, 64-row block) (the forward:
// flash_fwd.cuh). One kernel body serves both backwards, its PART template
// argument choosing the loops it runs: the dq loop over key tiles 0..i for
// the block's 64 query rows, the dk/dv loop over query tiles i..S/64 for
// its 64 keys, or (K2) the first and then the second in one block. The two
// loops are complementary under causality, so a K2 block does S/64 + 1
// tiles; a K3 dq block does i + 1 and a dk/dv block S/64 - i. Each output
// element is summed by one thread in a fixed order: no atomics,
// bitwise-reproducible gradients, and K3 gives K2's bits, since the loops
// are the same code with the same tiles. bf16 with head dim 64 or 128 runs
// every product on the tensor cores (mma.sync m16n8k16, fp32 accumulators,
// 4 warps of 16 rows); fp32, and bf16 at head dim 256, run CUDA-core
// kernels with fp32 FMAs and the same cast points.
//
// Bound on the H100. At the GPT-3 350M shape (B 16, S 1024, h 16, d 64)
// the forward moves ~134 MB and does ~34 GFLOP causal: byte-bound at
// ~0.04 ms, operation-bound close behind; the backward does ~86 GFLOP. At
// GPT-3 1.3B's long context (B 1, S 8192, h 16, d 128) the split backward
// does ~960 GFLOP over ~234 MB: operation-bound at ~0.97 ms. Here key
// (query) tiles stream through a 2-stage cp.async ring and the products
// are mma.sync fed by ldmatrix, with 64-row blocks of 4 warps; wgmma on
// 128-row tiles fed by TMA, as FlashAttention-3 does, and a better balance
// of K3's dq blocks across the causal triangle are the later work that
// closes the gap to those bounds.

#include "flash_fwd.cuh"

namespace {

// Backward operands of one launch. q, k, v (strides *_in), dout (strides
// *_do) and dq, dk, dv (strides *_out) each hold h heads of d values per
// sequence row, placed by their row, head and batch strides (flash_fwd.cuh:
// fused qkv, separate [B, S, h, d], or head-major [B, h, S, d]).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B, h, S] fp32
  const float* delta;   // [B, h, S] fp32
  void* dq;
  void* dk;
  void* dv;
  long long row_in, head_in, batch_in;
  long long row_do, head_do, batch_do;
  long long row_out, head_out, batch_out;
  int S, h, causal;
  float scale;
};

// The loops a backward block runs: both (K2), dq only or dk/dv only (K3).
enum { kBoth = 0, kDq = 1, kDkv = 2 };

template <typename T, int D, int PART>
__global__ void __launch_bounds__(kFmaThreads)
bwd_fma_kernel(const BwdArgs a) {
  constexpr int P = D + 1;
  constexpr int kAcc = kRows * D / kFmaThreads;
  extern __shared__ float smem[];
  float* a1 = smem;                     // [kRows][P]: q, then k (own)
  float* a2 = a1 + kRows * P;           // [kRows][P]: do, then v (own)
  float* t1 = a2 + kRows * P;           // [kFmaTile][P]: k, then q tile
  float* t2 = t1 + kFmaTile * P;        // [kFmaTile][P]: v, then do tile
  float* ps = t2 + kFmaTile * P;        // [kRows][kFmaTile] cast p^T
  float* ds = ps + kRows * kFmaTile;    // [kRows][kFmaTile] cast ds
  float* lse_s = ds + kRows * kFmaTile; // [kRows]
  float* dlt_s = lse_s + kRows;         // [kRows]

  const int i0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, h = a.h, causal = a.causal;
  const float scale = a.scale;
  const size_t ri = a.row_in, ro = a.row_out, rd = a.row_do;
  const size_t in0 = b * a.batch_in + hh * a.head_in;
  const size_t out0 = b * a.batch_out + hh * a.head_out;
  const T* qb = static_cast<const T*>(a.q) + in0;
  const T* kb = static_cast<const T*>(a.k) + in0;
  const T* vb = static_cast<const T*>(a.v) + in0;
  const T* dob = static_cast<const T*>(a.dout) + b * a.batch_do +
                 hh * a.head_do;
  const float* lse_b = a.lse + ((size_t)b * h + hh) * S;
  const float* dlt_b = a.delta + ((size_t)b * h + hh) * S;
  const int tid = threadIdx.x;
  float acc[kAcc], acc2[kAcc];

  if (PART != kDkv) {
    // ---- dq for query rows i0.. over key tiles ----
    T* dqb = static_cast<T*>(a.dq) + out0;
    stage_rows<T, D, P>(a1, qb, ri, i0, kRows, tid, kFmaThreads);
    stage_rows<T, D, P>(a2, dob, rd, i0, kRows, tid, kFmaThreads);
    for (int r = tid; r < kRows; r += kFmaThreads) {
      lse_s[r] = lse_b[i0 + r];
      dlt_s[r] = dlt_b[i0 + r];
    }
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
    __syncthreads();
    const int n_k = causal ? (i0 + kRows) / kFmaTile : S / kFmaTile;
    for (int kt = 0; kt < n_k; ++kt) {
      const int k0 = kt * kFmaTile;
      stage_rows<T, D, P>(t1, kb, ri, k0, kFmaTile, tid, kFmaThreads);
      stage_rows<T, D, P>(t2, vb, ri, k0, kFmaTile, tid, kFmaThreads);
      __syncthreads();
      for (int e = tid; e < kRows * kFmaTile; e += kFmaThreads) {
        const int r = e / kFmaTile, c = e % kFmaTile;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) {
          s = fmaf(a1[r * P + dd], t1[c * P + dd], s);
          dp = fmaf(a2[r * P + dd], t2[c * P + dd], dp);
        }
        float p = expf(s * scale - lse_s[r]);
        if (causal && k0 + c > i0 + r) p = 0.f;
        ds[e] = round_to<T>(p * (dp - dlt_s[r]));
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        const int e = tid + k * kFmaThreads;
        const int r = e / D, dd = e % D;
        float acc_k = acc[k];
#pragma unroll 8
        for (int c = 0; c < kFmaTile; ++c)
          acc_k = fmaf(ds[r * kFmaTile + c], t1[c * P + dd], acc_k);
        acc[k] = acc_k;
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int e = tid + k * kFmaThreads;
      const int r = e / D, dd = e % D;
      dqb[(size_t)(i0 + r) * ro + dd] = from_f<T>(acc[k] * scale);
    }
  }
  if (PART == kBoth) __syncthreads();

  if (PART != kDq) {
    // ---- dk, dv for keys i0.. over query tiles ----
    T* dkb = static_cast<T*>(a.dk) + out0;
    T* dvb = static_cast<T*>(a.dv) + out0;
    stage_rows<T, D, P>(a1, kb, ri, i0, kRows, tid, kFmaThreads);
    stage_rows<T, D, P>(a2, vb, ri, i0, kRows, tid, kFmaThreads);
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = acc2[k] = 0.f;
    __syncthreads();
    for (int qt = causal ? i0 / kFmaTile : 0; qt < S / kFmaTile; ++qt) {
      const int q0 = qt * kFmaTile;
      stage_rows<T, D, P>(t1, qb, ri, q0, kFmaTile, tid, kFmaThreads);
      stage_rows<T, D, P>(t2, dob, rd, q0, kFmaTile, tid, kFmaThreads);
      for (int c = tid; c < kFmaTile; c += kFmaThreads) {
        lse_s[c] = lse_b[q0 + c];
        dlt_s[c] = dlt_b[q0 + c];
      }
      __syncthreads();
      for (int e = tid; e < kRows * kFmaTile; e += kFmaThreads) {
        const int r = e / kFmaTile, c = e % kFmaTile;   // key r, query c
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) {
          s = fmaf(a1[r * P + dd], t1[c * P + dd], s);
          dp = fmaf(a2[r * P + dd], t2[c * P + dd], dp);
        }
        float p = expf(s * scale - lse_s[c]);
        if (causal && q0 + c < i0 + r) p = 0.f;
        ps[e] = round_to<T>(p);
        ds[e] = round_to<T>(p * (dp - dlt_s[c]));
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        const int e = tid + k * kFmaThreads;
        const int r = e / D, dd = e % D;
        float acc_k = acc[k], a2v = acc2[k];
#pragma unroll 8
        for (int c = 0; c < kFmaTile; ++c) {
          acc_k = fmaf(ds[r * kFmaTile + c], t1[c * P + dd], acc_k);
          a2v = fmaf(ps[r * kFmaTile + c], t2[c * P + dd], a2v);
        }
        acc[k] = acc_k;
        acc2[k] = a2v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int e = tid + k * kFmaThreads;
      const int r = e / D, dd = e % D;
      dkb[(size_t)(i0 + r) * ro + dd] = from_f<T>(acc[k] * scale);
      dvb[(size_t)(i0 + r) * ro + dd] = from_f<T>(acc2[k]);
    }
  }
}

template <int D>
constexpr size_t bwd_fma_smem() {
  return sizeof(float) * ((2 * kRows + 2 * kFmaTile) * (D + 1) +
                          2 * kRows * kFmaTile + 2 * kRows);
}

template <int D> struct BwdTile { static constexpr int KT = 64; };
template <> struct BwdTile<128> { static constexpr int KT = 32; };

template <int D>
constexpr size_t bwd_tc_smem() {
  return sizeof(uint16_t) * (2 * kRows + 4 * BwdTile<D>::KT) * (D + 8) +
         sizeof(float) * 4 * BwdTile<D>::KT;
}

template <int D, int PART>
__global__ void __launch_bounds__(kTcThreads)
bwd_tc_kernel(const BwdArgs a) {
  constexpr int KT = BwdTile<D>::KT, NB = KT / 8, ND = D / 8, P = D + 8;
  constexpr int kStage = 2 * KT * P;   // one (t1, t2) pair of the ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* a1 = reinterpret_cast<uint16_t*>(smem_raw);  // q, then k (own)
  uint16_t* a2 = a1 + kRows * P;                          // do, then v (own)
  uint16_t* ring = a2 + kRows * P;     // 2 x (k, v), then 2 x (q, do) tiles
  float* stats = reinterpret_cast<float*>(ring + 2 * kStage);  // 2 x (lse,
                                                                // delta)[KT]

  const int i0 = blockIdx.x * kRows, hh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, h = a.h, causal = a.causal;
  const float scale = a.scale;
  const size_t ri = a.row_in, ro = a.row_out, rd = a.row_do;
  const size_t in0 = b * a.batch_in + hh * a.head_in;
  const size_t out0 = b * a.batch_out + hh * a.head_out;
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) + in0;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + in0;
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + in0;
  const uint16_t* dob = static_cast<const uint16_t*>(a.dout) +
                        b * a.batch_do + hh * a.head_do;
  const float* lse_b = a.lse + ((size_t)b * h + hh) * S;
  const float* dlt_b = a.delta + ((size_t)b * h + hh) * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const int r_lo = i0 + wr + g, r_hi = r_lo + 8;
  float acc[ND][4];

  if (PART != kDkv) {
    // ---- dq for query rows r_lo / r_hi over key tiles ----
    uint16_t* dqb = static_cast<uint16_t*>(a.dq) + out0;
    const int n_k = causal ? (i0 + kRows) / KT : S / KT;
    stage_tc<D, P>(a1, qb, ri, i0, kRows, tid);
    stage_tc<D, P>(a2, dob, rd, i0, kRows, tid);
    stage_tc<D, P>(ring, kb, ri, 0, KT, tid);
    stage_tc<D, P>(ring + KT * P, vb, ri, 0, KT, tid);
    cp_commit();
    const float lse_lo = lse_b[r_lo], lse_hi = lse_b[r_hi];
    const float dl_lo = dlt_b[r_lo], dl_hi = dlt_b[r_hi];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nd][r] = 0.f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int k0 = kt * KT;
      cp_wait_all();
      __syncthreads();
      if (kt + 1 < n_k) {
        uint16_t* nxt = ring + ((kt + 1) % 2) * kStage;
        stage_tc<D, P>(nxt, kb, ri, k0 + KT, KT, tid);
        stage_tc<D, P>(nxt + KT * P, vb, ri, k0 + KT, KT, tid);
        cp_commit();
      }
      const uint16_t* t1 = ring + (kt % 2) * kStage;
      const uint16_t* t2 = t1 + KT * P;
      float sc[NB][4], dp[NB][4];
      dot_rows<D, P, NB>(sc, a1, wr, t1, lane);
      dot_rows<D, P, NB>(dp, a2, wr, t2, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool lo = r < 2;
          const int kpos = k0 + nb * 8 + t * 2 + (r & 1);
          float p = expf(sc[nb][r] * scale - (lo ? lse_lo : lse_hi));
          if (causal && kpos > (lo ? r_lo : r_hi)) p = 0.f;
          sc[nb][r] = p * (dp[nb][r] - (lo ? dl_lo : dl_hi));  // ds
        }
      acc_pv<D, P, NB>(acc, sc, t1, lane);                       // ds . k
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = nd * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r_lo * ro + d) =
          pack2(bf16_bits(acc[nd][0] * scale), bf16_bits(acc[nd][1] * scale));
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r_hi * ro + d) =
          pack2(bf16_bits(acc[nd][2] * scale), bf16_bits(acc[nd][3] * scale));
    }
  }
  if (PART == kBoth) __syncthreads();

  if (PART != kDq) {
    // ---- dk, dv for keys r_lo / r_hi over query tiles ----
    uint16_t* dkb = static_cast<uint16_t*>(a.dk) + out0;
    uint16_t* dvb = static_cast<uint16_t*>(a.dv) + out0;
    const int q_first = causal ? i0 / KT : 0;
    auto stage_q = [&](int buf, int q0) {
      uint16_t* dst = ring + buf * kStage;
      stage_tc<D, P>(dst, qb, ri, q0, KT, tid);
      stage_tc<D, P>(dst + KT * P, dob, rd, q0, KT, tid);
      float* st = stats + buf * 2 * KT;
      for (int c = tid; c < KT / 4; c += kTcThreads) {
        cp_async16(st + c * 4, lse_b + q0 + c * 4);
        cp_async16(st + KT + c * 4, dlt_b + q0 + c * 4);
      }
    };
    stage_tc<D, P>(a1, kb, ri, i0, kRows, tid);
    stage_tc<D, P>(a2, vb, ri, i0, kRows, tid);
    stage_q(0, q_first * KT);
    cp_commit();
    float acc2[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nd][r] = acc2[nd][r] = 0.f;
    for (int qt = q_first; qt < S / KT; ++qt) {
      const int q0 = qt * KT, buf = (qt - q_first) % 2;
      cp_wait_all();
      __syncthreads();
      if (qt + 1 < S / KT) {
        stage_q(1 - buf, q0 + KT);
        cp_commit();
      }
      const uint16_t* t1 = ring + buf * kStage;
      const uint16_t* t2 = t1 + KT * P;
      const float* lse_t = stats + buf * 2 * KT;
      const float* dlt_t = lse_t + KT;
      float sc[NB][4], dp[NB][4];
      dot_rows<D, P, NB>(sc, a1, wr, t1, lane);    // k . q^T
      dot_rows<D, P, NB>(dp, a2, wr, t2, lane);    // v . do^T
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qc = nb * 8 + t * 2 + (r & 1);
          float p = expf(sc[nb][r] * scale - lse_t[qc]);
          if (causal && q0 + qc < (r < 2 ? r_lo : r_hi)) p = 0.f;
          sc[nb][r] = p;
          dp[nb][r] = p * (dp[nb][r] - dlt_t[qc]);   // ds^T
        }
      acc_pv<D, P, NB>(acc2, sc, t2, lane);          // p^T . do
      acc_pv<D, P, NB>(acc, dp, t1, lane);           // ds^T . q
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = nd * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(dkb + (size_t)r_lo * ro + d) =
          pack2(bf16_bits(acc[nd][0] * scale), bf16_bits(acc[nd][1] * scale));
      *reinterpret_cast<uint32_t*>(dkb + (size_t)r_hi * ro + d) =
          pack2(bf16_bits(acc[nd][2] * scale), bf16_bits(acc[nd][3] * scale));
      *reinterpret_cast<uint32_t*>(dvb + (size_t)r_lo * ro + d) =
          pack2(bf16_bits(acc2[nd][0]), bf16_bits(acc2[nd][1]));
      *reinterpret_cast<uint32_t*>(dvb + (size_t)r_hi * ro + d) =
          pack2(bf16_bits(acc2[nd][2]), bf16_bits(acc2[nd][3]));
    }
  }
}

template <typename T, int D, int PART>
cudaError_t bwd_fma(const BwdArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem = bwd_fma_smem<D>();
  cudaError_t err = set_smem(bwd_fma_kernel<T, D, PART>, smem);
  if (err != cudaSuccess) return err;
  bwd_fma_kernel<T, D, PART><<<grid, kFmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D, int PART>
cudaError_t bwd_tc(const BwdArgs& a, dim3 grid, cudaStream_t st) {
  const size_t smem = bwd_tc_smem<D>();
  cudaError_t err = set_smem(bwd_tc_kernel<D, PART>, smem);
  if (err != cudaSuccess) return err;
  bwd_tc_kernel<D, PART><<<grid, kTcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// One backward launch over a B x h x S/64 grid (see flash_bwd for the
// geometry it takes).
template <int PART>
int bwd_launch(const BwdArgs& a, int B, int d, int dtype, cudaStream_t st) {
  if (a.S % kRows || a.S <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.S / kRows, a.h, B);
  if (dtype == 1) {
    if (d == 64) return (int)bwd_tc<64, PART>(a, grid, st);
    if (d == 128) return (int)bwd_tc<128, PART>(a, grid, st);
    if (d == 256) return (int)bwd_fma<__nv_bfloat16, 256, PART>(a, grid, st);
  } else if (dtype == 0) {
    if (d == 64) return (int)bwd_fma<float, 64, PART>(a, grid, st);
    if (d == 128) return (int)bwd_fma<float, 128, PART>(a, grid, st);
    if (d == 256) return (int)bwd_fma<float, 256, PART>(a, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace {

// Native-layout backward operands: q, k, v with row stride row_in and dq,
// dk, dv with row stride row_out (heads at lane j*d, batches of S rows);
// dout [B, S, h, d].
BwdArgs native_bwd(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, long long row_in,
                   long long row_out, int S, int h, int d, int causal,
                   float scale) {
  const long long H = (long long)h * d;
  return BwdArgs{q, k, v, dout, lse, delta, dq, dk, dv,
                 row_in, d, row_in * S, H, d, H * S,
                 row_out, d, row_out * S, S, h, causal, scale};
}

// Head-major backward operands (K17): q, k, v, dout, dq, dk, dv all
// [B, h, S, d].
BwdArgs head_major_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, void* dk, void* dv, int S, int h, int d,
                       int causal, float scale) {
  const long long hs = (long long)S * d, bs = hs * h;
  return BwdArgs{q, k, v, dout, lse, delta, dq, dk, dv,
                 d, hs, bs, d, hs, bs, d, hs, bs, S, h, causal, scale};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; S % 64 == 0, d in {64, 128, 256}.
// Return cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// geometry the kernels do not take).
extern "C" int flash_fwd(const void* qkv, void* out, float* lse, int B, int S,
                         int h, int d, int causal, float scale, int dtype,
                         void* stream) {
  const long long H = (long long)h * d, es = dtype == 1 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  FwdArgs a{base, base + H * es, base + 2 * H * es, 3 * H, 3 * H, 3 * H,
            d, d, d, 3 * H * S, 3 * H * S, 3 * H * S, out, H, d, H * S, lse,
            nullptr, nullptr, S, h, causal, scale};
  return flash_fwd_launch<false, false>(a, B, d, dtype,
                                        static_cast<cudaStream_t>(stream));
}

// Separate q, k, v, each [B, S, h, d] with rows of h*d; o [B, S, h, d];
// lse [B, h, S] or null.
extern "C" int flash_fwd_sep(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int S, int h,
                             int d, int causal, float scale, int dtype,
                             void* stream) {
  const long long H = (long long)h * d;
  FwdArgs a{q, k, v, H, H, H, d, d, d, H * S, H * S, H * S, out, H, d, H * S,
            lse, nullptr, nullptr, S, h, causal, scale};
  return flash_fwd_launch<false, false>(a, B, d, dtype,
                                        static_cast<cudaStream_t>(stream));
}

// K17 forward: head-major q, k, v and o, each [B, h, S, d]; lse [B, h, S]
// or null.
extern "C" int flash_fwd_hm(const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int S, int h, int d,
                            int causal, float scale, int dtype,
                            void* stream) {
  const long long hs = (long long)S * d, bs = hs * h;
  FwdArgs a{q, k, v, d, d, d, hs, hs, hs, bs, bs, bs, out, d, hs, bs, lse,
            nullptr, nullptr, S, h, causal, scale};
  return flash_fwd_launch<false, false>(a, B, d, dtype,
                                        static_cast<cudaStream_t>(stream));
}

// K2: dqkv [B, S, 3H] of the fused qkv [B, S, 3H] in one launch.
extern "C" int flash_bwd(const void* qkv, const void* dout, const float* lse,
                         const float* delta, void* dqkv, int B, int S, int h,
                         int d, int causal, float scale, int dtype,
                         void* stream) {
  const long long H = (long long)h * d, es = dtype == 1 ? 2 : 4;
  const char* in = static_cast<const char*>(qkv);
  char* out = static_cast<char*>(dqkv);
  const BwdArgs a = native_bwd(in, in + H * es, in + 2 * H * es, dout, lse,
                               delta, out, out + H * es, out + 2 * H * es,
                               3 * H, 3 * H, S, h, d, causal, scale);
  return bwd_launch<kBoth>(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}

// K3, dq: q, k, v with row stride row_in, dq with row stride row_out.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int row_in,
                            int row_out, int B, int S, int h, int d,
                            int causal, float scale, int dtype,
                            void* stream) {
  const BwdArgs a = native_bwd(q, k, v, dout, lse, delta, dq, nullptr,
                               nullptr, row_in, row_out, S, h, d, causal,
                               scale);
  return bwd_launch<kDq>(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}

// K3, dk and dv: q, k, v with row stride row_in, dk and dv with row stride
// row_out.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             int row_in, int row_out, int B, int S, int h,
                             int d, int causal, float scale, int dtype,
                             void* stream) {
  const BwdArgs a = native_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv,
                               row_in, row_out, S, h, d, causal, scale);
  return bwd_launch<kDkv>(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}

// K17, dq: head-major q, k, v, dout and dq, each [B, h, S, d].
extern "C" int flash_bwd_hm_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int S,
                               int h, int d, int causal, float scale,
                               int dtype, void* stream) {
  const BwdArgs a = head_major_bwd(q, k, v, dout, lse, delta, dq, nullptr,
                                   nullptr, S, h, d, causal, scale);
  return bwd_launch<kDq>(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}

// K17, dk and dv: head-major operands, each [B, h, S, d].
extern "C" int flash_bwd_hm_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv,
                                int B, int S, int h, int d, int causal,
                                float scale, int dtype, void* stream) {
  const BwdArgs a = head_major_bwd(q, k, v, dout, lse, delta, nullptr, dk,
                                   dv, S, h, d, causal, scale);
  return bwd_launch<kDkv>(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}
