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
// dv = cast(p)^T do, with delta = rowsum(do * o) in fp32 given by the
// caller (the reference's XLA reduction,
// paddle_tpu/ops/pallas/flash_attention.py:794).
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
// Here one kernel body serves both backwards, its PART template argument
// choosing the loops it runs: the dq loop over key tiles for the block's
// query rows, the dk/dv loop over query tiles for its keys, or (K2) the
// first and then the second in one block. The two loops are
// complementary under causality, so a K2 block's work is the same for
// every row block; K3's dq blocks grow with the row block (launched
// heaviest first) and its dk/dv blocks shrink (launched from the first).
// Each output element is summed by one thread in a fixed order: no
// atomics, bitwise-reproducible gradients, and K3 gives K2's bits, since
// the loops are the same code with the same tiles. bf16 with head dim 64
// or 128 runs the TMA + wgmma body (bwd_wg_kernel: blocks of 128 rows, two
// consumer warpgroups of 64 and a producer warpgroup keeping a ring of
// 64-row tiles in flight; flash_fwd.cuh describes the tile layout); fp32,
// and bf16 at head dim 256, run CUDA-core kernels with fp32 FMAs and the
// same cast points.
//
// Bound on the H100. At the GPT-3 350M shape (B 16, S 1024, h 16, d 64)
// the forward moves ~134 MB and does ~34 GFLOP causal: byte-bound at
// ~0.04 ms, operation-bound close behind; the backward does ~86 GFLOP. At
// GPT-3 1.3B's long context (B 1, S 8192, h 16, d 128) the split backward
// does ~960 GFLOP over ~234 MB (7 products of 2 d flop a causal pair:
// the dq loop's s, dp and dq, the dk/dv loop's s^T, dp^T, dv and dk):
// operation-bound at ~0.97 ms. So the design is the tensor cores' rate:
// wgmma on 128-row blocks, operands brought by TMA while the last tile's
// products run, the two consumer warpgroups taking turns to issue their
// products (one's element-wise work runs while the other's products do),
// and in the dq loop the next tile's products issued before the last
// one's dq product is waited for (FlashAttention-3's shape, without its
// atomic dq, which would give up determinism).

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

// The backward's shared memory: the block's own 128-row tiles (q and do
// for the dq loop, k and v for the dk/dv loop), stages of 64-row (k, v)
// or (q, do) tiles, and each stage's lse and delta (the dk/dv loop's
// query tile).
template <int D, int PART> struct BwdWg {
  static constexpr int kOwnTile = tile_bytes(kWgRows, D);
  static constexpr int kOwn =
      kOwnTile * ((PART != kDkv ? 2 : 0) + (PART != kDq ? 2 : 0));
  static constexpr int kTile = tile_bytes(kBwdTile, D);
  static constexpr int kStats = 2 * kBwdTile * 4;
  static constexpr int kStage = 2 * kTile + kStats;
  static constexpr int kStages = min_int(
      kMaxStages, (kSmemMax - kSmemFixed - kOwn) / kStage);
  static constexpr int kSmem = kSmemFixed + kOwn + kStages * kStage;
};

// The dq loop (PART != kDkv): the block's 128 query rows (64 a consumer
// warpgroup) over 64-key tiles up to the causal bound. Per tile s = q k^T
// and dp = do v^T (shared operands), p = 2^(s scale log2 e - lse log2 e)
// masked to 0, ds = p (dp - delta) rounded to bf16 into register A, and
// dq += ds k with k MN-major; the next tile's s and dp are issued before
// this product is waited for. The dk/dv loop (PART != kDq): the block's
// 128 keys over 64-query tiles from the diagonal, with the keys as the
// products' rows, so p^T and ds^T land in register A's layout: s^T = k
// q^T, dp^T = v do^T, dv += cast(p^T) do, dk += ds^T q (q, do MN-major).
// Tiles wholly masked for a warpgroup are only released, and a
// warpgroup whose rows lie past S (S % 128 == 64) computes nothing;
// gradients go out by TMA stores, which clip rows past S. Each output
// element is one thread's accumulator, summed in tile order: no atomics,
// and the dq of K2 (kBoth) and K3 (kDq) is the same code on the same
// tiles.
template <int D, int PART>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_wg_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap,
              const __grid_constant__ CUtensorMap dqmap,
              const __grid_constant__ CUtensorMap dkmap,
              const __grid_constant__ CUtensorMap dvmap, const BwdArgs a,
              int chunk) {
  static_assert(D == 64 || D == 128, "head dim");
  using Plan = BwdWg<D, PART>;
  constexpr int NC = D / 64, ST = Plan::kStages;
  constexpr int kOwnChunk = kWgRows * 128, kTileChunk = kBwdTile * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t qo = base, doo = base + Plan::kOwnTile;   // dq loop
  const uint32_t ko = base + (PART == kBoth ? 2 * Plan::kOwnTile : 0);
  const uint32_t vo = ko + Plan::kOwnTile;                 // dk/dv loop
  const uint32_t ring = base + Plan::kOwn;
  float* stats = reinterpret_cast<float*>(sm + Plan::kOwn +
                                          ST * 2 * Plan::kTile);
  uint64_t* own_dq = reinterpret_cast<uint64_t*>(sm + Plan::kOwn +
                                                 ST * Plan::kStage);
  uint64_t* own_dkv = own_dq + 1;
  uint64_t* full = own_dq + 2;
  uint64_t* empty = full + ST;
  const int S = a.S, causal = a.causal, tid = threadIdx.x;
  const int nrb = (S + kWgRows - 1) / kWgRows;
  int rb, hh, b;
  block_place(blockIdx.x, nrb, a.h, gridDim.x / nrb, chunk,
              causal && PART == kDq, rb, hh, b);
  const int i0 = rb * kWgRows;
  const int n_k = (causal ? min_int(i0 + kWgRows, S) : S) / kBwdTile;
  const int q_first = causal ? i0 / kBwdTile : 0;
  const int n_q = S / kBwdTile - q_first;
  const float* lse_b = a.lse + ((size_t)b * a.h + hh) * S;
  const float* dlt_b = a.delta + ((size_t)b * a.h + hh) * S;
  if (tid == 0) {
    mbar_init(own_dq, 1);
    mbar_init(own_dkv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // the consumers' eight warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {                     // producer warpgroup
    setmaxnreg_dec<kRegsProducer>();
    if (tid == 256) {
      auto own = [&](uint32_t dst, const CUtensorMap* map, uint64_t* bar) {
        for (int c = 0; c < NC; ++c)
          for (int r = 0; r < kWgRows; r += kBoxRows)
            tma_load_4d(dst + c * kOwnChunk + r * 128, map, c * 64, i0 + r,
                        hh, b, bar);
      };
      auto tile = [&](uint32_t dst, const CUtensorMap* map, int r0,
                      uint64_t* bar) {
        for (int c = 0; c < NC; ++c)
          tma_load_4d(dst + c * kTileChunk, map, c * 64, r0, hh, b, bar);
      };
      if (PART != kDkv) {
        mbar_expect_tx(own_dq, 2 * Plan::kOwnTile);
        own(qo, &qmap, own_dq);
        own(doo, &domap, own_dq);
      }
      if (PART != kDq) {
        mbar_expect_tx(own_dkv, 2 * Plan::kOwnTile);
        own(ko, &kmap, own_dkv);
        own(vo, &vmap, own_dkv);
      }
      int i = 0;
      if (PART != kDkv)
        for (int kt = 0; kt < n_k; ++kt, ++i) {
          const int s = i % ST;
          mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
          const uint32_t dst = ring + s * 2 * Plan::kTile;
          mbar_expect_tx(&full[s], 2 * Plan::kTile);
          tile(dst, &kmap, kt * kBwdTile, &full[s]);
          tile(dst + Plan::kTile, &vmap, kt * kBwdTile, &full[s]);
        }
      if (PART != kDq)
        for (int qt = 0; qt < n_q; ++qt, ++i) {
          const int s = i % ST, q0 = (q_first + qt) * kBwdTile;
          mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
          const uint32_t dst = ring + s * 2 * Plan::kTile;
          const uint32_t st = smem_u32(stats + s * 2 * kBwdTile);
          mbar_expect_tx(&full[s], 2 * Plan::kTile + Plan::kStats);
          tile(dst, &qmap, q0, &full[s]);
          tile(dst + Plan::kTile, &domap, q0, &full[s]);
          bulk_load(st, lse_b + q0, kBwdTile * 4, &full[s]);
          bulk_load(st + kBwdTile * 4, dlt_b + q0, kBwdTile * 4, &full[s]);
        }
    }
    return;
  }
  setmaxnreg_inc<kRegsConsumer>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t = lane & 3;
  const int row0 = i0 + 64 * wg;        // the warpgroup's first query / key
  const int r_lo = row0 + 16 * warp + (lane >> 2), r_hi = r_lo + 8;
  const bool idle = row0 >= S;          // past S: nothing to compute
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  const int wrow = 64 * wg + 16 * warp + (lane >> 2);   // row in the tile
  // the warpgroup's 64 rows of an own tile (gradients staged in it once
  // its loop is done: only this warpgroup's products read them) out by
  // one thread's TMA stores, which clip rows past S
  auto store_rows = [&](uint32_t tile, const CUtensorMap* map) {
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if ((tid & 127) == 0) {
      for (int c = 0; c < NC; ++c)
        tma_store_4d(map, tile + c * kOwnChunk + wg * 64 * 128, c * 64,
                     row0, hh, b);
      bulk_commit();
      bulk_wait_read();
    }
  };
  // The two warpgroups take turns issuing their products (named barriers
  // 4 and 5, warpgroup 0 first): while one does its element-wise work
  // the other's products run. Both pass the same number of turns, two a
  // tile (a skipped tile too); the last one is not handed on.
  int turns = 2 * ((PART != kDkv ? n_k : 0) + (PART != kDq ? n_q : 0));
  auto my_turn = [&]() { named_barrier(4 + wg, 256); };
  auto your_turn = [&]() {
    if (--turns > 0 || wg == 0) named_arrive(5 - wg, 256);
  };
  auto skip_turns = [&]() {
    my_turn();
    your_turn();
    my_turn();
    your_turn();
  };
  if (wg == 1) named_arrive(4, 256);
  int i = 0;                            // ring position, as the producer's

  if (PART != kDkv) {
    // ---- dq for query rows r_lo / r_hi over key tiles ----
    const float lse_lo = r_lo < S ? lse_b[r_lo] * kLog2e : 0.f;
    const float lse_hi = r_hi < S ? lse_b[r_hi] * kLog2e : 0.f;
    const float dl_lo = r_lo < S ? dlt_b[r_lo] : 0.f;
    const float dl_hi = r_hi < S ? dlt_b[r_hi] : 0.f;
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    // the key tiles this warpgroup computes: all up to its last row, the
    // rest (wholly above its rows) only released
    const int n_run = idle ? 0 : causal ? min_int(n_k, row0 / kBwdTile + 1)
                                        : n_k;
    mbar_wait(own_dq, 0);
    const uint32_t qa = qo + wg * 64 * 128, da = doo + wg * 64 * 128;
    int kt = 0;
    for (; kt < n_run; ++kt, ++i) {
      const int s = i % ST, k0 = kt * kBwdTile;
      const uint32_t kt_s = ring + s * 2 * Plan::kTile;
      const uint32_t vt_s = kt_s + Plan::kTile;
      mbar_wait(&full[s], (i / ST) & 1);
      float sc[kBwdTile / 2], dp[kBwdTile / 2];
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBwdTile>(
            sc, sw128_desc(qa + (kk >> 2) * kOwnChunk + (kk & 3) * 32),
            sw128_desc(kt_s + (kk >> 2) * kTileChunk + (kk & 3) * 32),
            kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBwdTile>(
            dp, sw128_desc(da + (kk >> 2) * kOwnChunk + (kk & 3) * 32),
            sw128_desc(vt_s + (kk >> 2) * kTileChunk + (kk & 3) * 32),
            kk > 0);
      wgmma_commit();
      your_turn();
      wgmma_wait<1>();                  // the last tile's dq product
      fence_operands(acc);
      if (kt > 0) release(&empty[(i - 1) % ST]);
      wgmma_wait<0>();
      fence_operands(sc);
      fence_operands(dp);
      const bool edge = causal && k0 + 63 > row0;
#pragma unroll
      for (int e = 0; e < kBwdTile / 2; ++e) {
        const bool hi = e & 2;
        float p = ex2(fmaf(sc[e], scale_log2, -(hi ? lse_hi : lse_lo)));
        if (edge && k0 + acc_col(e, t) > (hi ? r_hi : r_lo)) p = 0.f;
        sc[e] = __fmul_rn(p, __fsub_rn(dp[e], hi ? dl_hi : dl_lo));   // ds
      }
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(dsa[kk], sc, kk);
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)    // keys 16 kk.. of k, MN-major
        wgmma_rs<D, 1>(acc, dsa[kk], sw128_mn_desc(kt_s + kk * 2048,
                                                   kTileChunk));
      wgmma_commit();
      your_turn();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (n_run > 0) release(&empty[(i - 1) % ST]);
    for (; kt < n_k; ++kt, ++i) {
      mbar_wait(&full[i % ST], (i / ST) & 1);
      release(&empty[i % ST]);
      skip_turns();
    }
    stage_acc<kWgRows>(sm + (qo - base), acc, scale, scale, wrow, t);
    store_rows(qo, &dqmap);
  }

  if (PART != kDq) {
    // ---- dk, dv for keys r_lo / r_hi over query tiles ----
    const uint32_t ka = ko + wg * 64 * 128, va = vo + wg * 64 * 128;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
    // the query tiles wholly before this warpgroup's keys (causal) are
    // only released, and all of them past S
    const int n_skip = idle ? n_q : causal ? (row0 - i0) / kBwdTile : 0;
    mbar_wait(own_dkv, 0);
    int qt = 0;
    for (; qt < n_skip; ++qt, ++i) {
      mbar_wait(&full[i % ST], (i / ST) & 1);
      release(&empty[i % ST]);
      skip_turns();
    }
    for (; qt < n_q; ++qt, ++i) {
      const int s = i % ST, q0 = (q_first + qt) * kBwdTile;
      const uint32_t qt_s = ring + s * 2 * Plan::kTile;
      const uint32_t dt_s = qt_s + Plan::kTile;
      const float* lse_t = stats + s * 2 * kBwdTile;
      const float* dlt_t = lse_t + kBwdTile;
      mbar_wait(&full[s], (i / ST) & 1);
      float st[kBwdTile / 2], dpt[kBwdTile / 2];
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBwdTile>(
            st, sw128_desc(ka + (kk >> 2) * kOwnChunk + (kk & 3) * 32),
            sw128_desc(qt_s + (kk >> 2) * kTileChunk + (kk & 3) * 32),
            kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBwdTile>(
            dpt, sw128_desc(va + (kk >> 2) * kOwnChunk + (kk & 3) * 32),
            sw128_desc(dt_s + (kk >> 2) * kTileChunk + (kk & 3) * 32),
            kk > 0);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);
      const bool edge = causal && q0 < row0 + 63;
#pragma unroll
      for (int e = 0; e < kBwdTile / 2; ++e) {
        const int qc = acc_col(e, t);
        float p = ex2(fmaf(st[e], scale_log2, -(lse_t[qc] * kLog2e)));
        if (edge && q0 + qc < ((e & 2) ? r_hi : r_lo)) p = 0.f;
        st[e] = p;
        dpt[e] = __fmul_rn(p, __fsub_rn(dpt[e], dlt_t[qc]));         // ds^T
      }
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], st, kk);
        acc_to_a(dsa[kk], dpt, kk);
      }
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)    // queries 16 kk.. of do, MN-major
        wgmma_rs<D, 1>(dv, pa[kk], sw128_mn_desc(dt_s + kk * 2048,
                                                 kTileChunk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)    // queries 16 kk.. of q, MN-major
        wgmma_rs<D, 1>(dk, dsa[kk], sw128_mn_desc(qt_s + kk * 2048,
                                                  kTileChunk));
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_operands(dk);
      fence_operands(dv);
      release(&empty[s]);
    }
    stage_acc<kWgRows>(sm + (ko - base), dk, scale, scale, wrow, t);
    stage_acc<kWgRows>(sm + (vo - base), dv, 1.f, 1.f, wrow, t);
    store_rows(ko, &dkmap);
    store_rows(vo, &dvmap);
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
cudaError_t bwd_wg(const BwdArgs& a, int B, cudaStream_t st) {
  using Plan = BwdWg<D, PART>;
  CUtensorMap qm, km, vm, dm, g[3];
  if (!head_map(&qm, a.q, D, a.S, a.h, B, a.row_in, a.head_in, a.batch_in) ||
      !head_map(&km, a.k, D, a.S, a.h, B, a.row_in, a.head_in, a.batch_in) ||
      !head_map(&vm, a.v, D, a.S, a.h, B, a.row_in, a.head_in, a.batch_in) ||
      !head_map(&dm, a.dout, D, a.S, a.h, B, a.row_do, a.head_do,
                a.batch_do))
    return cudaErrorNotSupported;
  void* outs[3] = {a.dq, a.dk, a.dv};   // the ones this part writes
  for (int j = 0; j < 3; ++j)
    if (outs[j] == nullptr) g[j] = qm;
    else if (!head_map(&g[j], outs[j], D, a.S, a.h, B, a.row_out,
                       a.head_out, a.batch_out))
      return cudaErrorNotSupported;
  static bool ready = false;
  cudaError_t err = wg_ready(bwd_wg_kernel<D, PART>, Plan::kSmem, ready);
  if (err != cudaSuccess) return err;
  const int nrb = (a.S + kWgRows - 1) / kWgRows;
  bwd_wg_kernel<D, PART><<<nrb * a.h * B, kWgThreads, Plan::kSmem, st>>>(
      qm, km, vm, dm, g[0], g[1], g[2], a, l2_chunk(a.S, D, a.h * B));
  return cudaGetLastError();
}

// One backward launch (see flash_bwd for the geometry it takes), its
// variant chosen by wg_variant as flash_plan_c's and written to *variant
// (1: TMA + wgmma, 0: FMA): bf16 at d 64 and 128 takes the TMA + wgmma
// kernel (a 1-D grid of S/128 x h x B blocks of 128 rows; K3's dq blocks
// heaviest first when causal, its dk/dv blocks from the first, which is
// the heaviest), the rest the FMA kernel (a B x h x S/64 grid).
template <int PART>
int bwd_launch(const BwdArgs& a, int B, int d, int dtype, cudaStream_t st,
               int* variant) {
  if (a.S % kRows || a.S <= 0 || variant == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.S / kRows, a.h, B);
  if (wg_variant(d, dtype)) {
    *variant = 1;
    return (int)(d == 64 ? bwd_wg<64, PART>(a, B, st)
                         : bwd_wg<128, PART>(a, B, st));
  }
  *variant = 0;
  if (dtype == 1 && d == 256)
    return (int)bwd_fma<__nv_bfloat16, 256, PART>(a, grid, st);
  if (dtype == 0) {
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
// The forwards take ``sched``, two ints of scheduling scratch that are 0
// before the launch and left 0 by it; launches that may run at the same
// time need scratch of their own (the caller keeps one per stream). Each
// entry writes the variant it launched to *variant (1: TMA + wgmma, 0:
// FMA) and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a geometry the kernels do not take).
extern "C" int flash_fwd(const void* qkv, void* out, float* lse, int B, int S,
                         int h, int d, int causal, float scale, int dtype,
                         int* sched, void* stream, int* variant) {
  const long long H = (long long)h * d, es = dtype == 1 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  FwdArgs a{base, base + H * es, base + 2 * H * es, 3 * H, 3 * H, 3 * H,
            d, d, d, 3 * H * S, 3 * H * S, 3 * H * S, out, H, d, H * S, lse,
            nullptr, nullptr, S, h, causal, scale};
  return flash_fwd_launch<false, false>(
      a, B, d, dtype, sched, static_cast<cudaStream_t>(stream), variant);
}

// Separate q, k, v, each [B, S, h, d] with rows of h*d; o [B, S, h, d];
// lse [B, h, S] or null.
extern "C" int flash_fwd_sep(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int S, int h,
                             int d, int causal, float scale, int dtype,
                             int* sched, void* stream, int* variant) {
  const long long H = (long long)h * d;
  FwdArgs a{q, k, v, H, H, H, d, d, d, H * S, H * S, H * S, out, H, d, H * S,
            lse, nullptr, nullptr, S, h, causal, scale};
  return flash_fwd_launch<false, false>(
      a, B, d, dtype, sched, static_cast<cudaStream_t>(stream), variant);
}

// K17 forward: head-major q, k, v and o, each [B, h, S, d]; lse [B, h, S]
// or null.
extern "C" int flash_fwd_hm(const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int S, int h, int d,
                            int causal, float scale, int dtype, int* sched,
                            void* stream, int* variant) {
  const long long hs = (long long)S * d, bs = hs * h;
  FwdArgs a{q, k, v, d, d, d, hs, hs, hs, bs, bs, bs, out, d, hs, bs, lse,
            nullptr, nullptr, S, h, causal, scale};
  return flash_fwd_launch<false, false>(
      a, B, d, dtype, sched, static_cast<cudaStream_t>(stream), variant);
}

// K2: dqkv [B, S, 3H] of the fused qkv [B, S, 3H] in one launch.
extern "C" int flash_bwd(const void* qkv, const void* dout, const float* lse,
                         const float* delta, void* dqkv, int B, int S, int h,
                         int d, int causal, float scale, int dtype,
                         void* stream, int* variant) {
  const long long H = (long long)h * d, es = dtype == 1 ? 2 : 4;
  const char* in = static_cast<const char*>(qkv);
  char* out = static_cast<char*>(dqkv);
  const BwdArgs a = native_bwd(in, in + H * es, in + 2 * H * es, dout, lse,
                               delta, out, out + H * es, out + 2 * H * es,
                               3 * H, 3 * H, S, h, d, causal, scale);
  return bwd_launch<kBoth>(a, B, d, dtype, static_cast<cudaStream_t>(stream),
                           variant);
}

// K3, dq: q, k, v with row stride row_in, dq with row stride row_out.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int row_in,
                            int row_out, int B, int S, int h, int d,
                            int causal, float scale, int dtype,
                            void* stream, int* variant) {
  const BwdArgs a = native_bwd(q, k, v, dout, lse, delta, dq, nullptr,
                               nullptr, row_in, row_out, S, h, d, causal,
                               scale);
  return bwd_launch<kDq>(a, B, d, dtype, static_cast<cudaStream_t>(stream),
                         variant);
}

// K3, dk and dv: q, k, v with row stride row_in, dk and dv with row stride
// row_out.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             int row_in, int row_out, int B, int S, int h,
                             int d, int causal, float scale, int dtype,
                             void* stream, int* variant) {
  const BwdArgs a = native_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv,
                               row_in, row_out, S, h, d, causal, scale);
  return bwd_launch<kDkv>(a, B, d, dtype, static_cast<cudaStream_t>(stream),
                          variant);
}

// K17, dq: head-major q, k, v, dout and dq, each [B, h, S, d].
extern "C" int flash_bwd_hm_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int S,
                               int h, int d, int causal, float scale,
                               int dtype, void* stream, int* variant) {
  const BwdArgs a = head_major_bwd(q, k, v, dout, lse, delta, dq, nullptr,
                                   nullptr, S, h, d, causal, scale);
  return bwd_launch<kDq>(a, B, d, dtype, static_cast<cudaStream_t>(stream),
                         variant);
}

// K17, dk and dv: head-major operands, each [B, h, S, d].
extern "C" int flash_bwd_hm_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv,
                                int B, int S, int h, int d, int causal,
                                float scale, int dtype, void* stream,
                                int* variant) {
  const BwdArgs a = head_major_bwd(q, k, v, dout, lse, delta, nullptr, dk,
                                   dv, S, h, d, causal, scale);
  return bwd_launch<kDkv>(a, B, d, dtype, static_cast<cudaStream_t>(stream),
                          variant);
}

template <int PART>
void bwd_plan(int d, int& stages, int& smem) {
  stages = d == 64 ? BwdWg<64, PART>::kStages : BwdWg<128, PART>::kStages;
  smem = d == 64 ? BwdWg<64, PART>::kSmem : BwdWg<128, PART>::kSmem;
}

// The plan the launchers follow, for the Python side's flash_plan to be
// held against on the card: out = {variant (1: TMA + wgmma, 0: FMA), rows
// a block, rows a ring tile, stages (the forward: of its k ring), shared
// bytes, heaviest-first reversal of the row blocks (1) or ascending order
// (0), (batch, head) pairs an L2 chunk of the order holds (bh pairs in
// all), the forward's v ring stages (0 for the backward)}. part: 0 the
// forward, 1 + kBoth, kDq or kDkv the backward. Returns 0, or
// cudaErrorInvalidValue.
extern "C" int flash_plan_c(int S, int d, int dtype, int part, int causal,
                            int bh, int* out) {
  if (S % kRows || S <= 0 || part < 0 || part > 3 || bh < 1)
    return (int)cudaErrorInvalidValue;
  if (!wg_variant(d, dtype)) {
    const int o[8] = {0, kRows, kFmaTile, 0, 0, 0, 0, 0};
    for (int j = 0; j < 8; ++j) out[j] = o[j];
    return 0;
  }
  int stages, v_stages = 0, smem;
  if (part == 0) {
    stages = d == 64 ? FwdWg<64>::kStages : FwdWg<128>::kStages;
    v_stages = d == 64 ? FwdWg<64>::kVStages : FwdWg<128>::kVStages;
    smem = d == 64 ? FwdWg<64>::kSmem : FwdWg<128>::kSmem;
  } else {
    if (part - 1 == kBoth) bwd_plan<kBoth>(d, stages, smem);
    else if (part - 1 == kDq) bwd_plan<kDq>(d, stages, smem);
    else bwd_plan<kDkv>(d, stages, smem);
  }
  const int o[8] = {1, kWgRows, part == 0 ? kFwdKeys : kBwdTile, stages,
                    smem, causal && (part == 0 || part - 1 == kDq),
                    l2_chunk(S, d, bh), v_stages};
  for (int j = 0; j < 8; ++j) out[j] = o[j];
  return 0;
}
