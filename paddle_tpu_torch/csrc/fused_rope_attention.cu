// Flash attention forward with RoPE applied inside the tile (K11), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/fused_rope_attention.py::_rope_flash_fwd_kernel
// (launched by _rope_fwd): causal flash forward over UNROTATED q and k,
// [B, S, h, d] each (v likewise), with q rotated once per block after its
// load and, with rope_k, each key tile rotated after its load inside the
// key loop. The tables are the angles' cos and sin, [S, d/2] fp32, row =
// absolute position (0..S-1). LLaMA's
// GQA prefill runs the q-only arm on the repeated, pre-rotated k and v; an
// MHA config rotates both.
//
// The kernel body is K1's forward (flash_fwd.cuh, fwd_wg_kernel for bf16
// at head dim 128, fwd_fma_kernel otherwise, with their RoPE template
// arguments on): the rotation rounds each product and the sum on their
// own and rounds the row to the input dtype before the dot, so the tile
// equals the eager apply_rope bit for bit.
//
// Bound on the H100. At LLaMA-1B's prefill (B 16, S 512, h 16, d 128, bf16)
// q, k, v in and o out are 134 MB (0.040 ms at 3.35 TB/s) and the causal
// products 17 GFLOP (0.017 ms at 989 TFLOP/s): byte-bound. What the
// fusion saves is the rotated q (and k) round trip through device memory,
// a write and a read of [B, S, h, d] each. The tile loop is K1's (TMA
// ring, wgmma): q is rotated once in shared memory after its TMA load,
// k once per tile under rope_k (then a barrier of both warpgroups).

#include "flash_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16; S % 64 == 0, d in {128, 256}; q, k, v
// and o [B, S, h, d] with rows of h*d; cos_h / sin_h [S, d/2] fp32,
// 16-byte aligned; lse [B, h, S] or null; sched and *variant as
// flash_fwd's. Returns cudaGetLastError() after the launch.
extern "C" int rope_flash_fwd(const void* q, const void* k, const void* v,
                              const float* cos_h, const float* sin_h,
                              void* out, float* lse, int B, int S, int h,
                              int d, int causal, float scale, int rope_q,
                              int rope_k, int dtype, int* sched,
                              void* stream, int* variant) {
  const long long H = (long long)h * d;
  FwdArgs a{q, k, v, H, H, H, d, d, d, H * S, H * S, H * S, out, H, d,
            H * S, lse, cos_h, sin_h, S, h, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cos_h == nullptr || sin_h == nullptr) return (int)cudaErrorInvalidValue;
  if (rope_q && rope_k)
    return flash_fwd_launch<true, true>(a, B, d, dtype, sched, st, variant);
  if (rope_q)
    return flash_fwd_launch<true, false>(a, B, d, dtype, sched, st, variant);
  if (rope_k)
    return flash_fwd_launch<false, true>(a, B, d, dtype, sched, st, variant);
  return (int)cudaErrorInvalidValue;
}
