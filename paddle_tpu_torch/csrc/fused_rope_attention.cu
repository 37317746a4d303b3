// Flash attention forward with RoPE applied inside the tile (K11), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/fused_rope_attention.py::_rope_flash_fwd_kernel
// (launched by _rope_fwd): causal flash forward over UNROTATED q and k,
// [B, S, h, d] each (v likewise), with q rotated once per block after its
// load and, with rope_k, each key tile rotated after its load inside the
// key loop. The tables are the full-width C = [cos, cos] and
// S = [-sin, sin], [S, d] fp32, row = absolute position (0..S-1). LLaMA's
// GQA prefill runs the q-only arm on the repeated, pre-rotated k and v; an
// MHA config rotates both.
//
// The kernel body is K1's forward (flash_fwd.cuh, fwd_tc_kernel /
// fwd_fma_kernel with their RoPE template arguments on): the rotation rounds
// each product and the sum on their own and rounds the row to the input
// dtype before the dot, so the tile equals the eager apply_rope bit for bit.
//
// Bound on the H100. At LLaMA-1B's prefill (B 16, S 512, h 16, d 128, bf16)
// q, k, v in and o out are 134 MB (0.040 ms at 3.35 TB/s) and the causal
// products 17 GFLOP (0.017 ms at 989 TFLOP/s): byte-bound. What the
// fusion saves is the rotated q (and k) round trip through device memory,
// a write and a read of [B, S, h, d] each. The tile
// loop is K1's (mma.sync, 2-stage cp.async ring): its distance from the
// bound is K1's, plus one barrier per key tile for the rotation.

#include "flash_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16; S % 64 == 0, d in {128, 256}; q, k, v
// and o [B, S, h, d] with rows of h*d; cos_f / sin_f [S, d] fp32; lse
// [B, h, S] or null. Returns cudaGetLastError() after the launch.
extern "C" int rope_flash_fwd(const void* q, const void* k, const void* v,
                              const float* cos_f, const float* sin_f,
                              void* out, float* lse, int B, int S, int h,
                              int d, int causal, float scale, int rope_q,
                              int rope_k, int dtype, void* stream) {
  const long long H = (long long)h * d;
  FwdArgs a{q, k, v, H, H, H, d, d, d, H * S, H * S, H * S, out, H, d,
            H * S, lse, cos_f, sin_f, S, h, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cos_f == nullptr || sin_f == nullptr) return (int)cudaErrorInvalidValue;
  if (rope_q && rope_k) return flash_fwd_launch<true, true>(a, B, d, dtype, st);
  if (rope_q) return flash_fwd_launch<true, false>(a, B, d, dtype, st);
  if (rope_k) return flash_fwd_launch<false, true>(a, B, d, dtype, st);
  return (int)cudaErrorInvalidValue;
}
