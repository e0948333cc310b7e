// Multi-head attention on head-major [B, H, S, D] tensors of any head dim
// D (a multiple of 8, at most 128), for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_attention.py flash_attention (its
//   Pallas body _attn_kernel), the route of every head dim K1 does not take.
// Computes, per (batch, head): softmax(q' k^T) v with q' = q * scale
// rounded to q's dtype (the JAX wrapper's pre-scale), fp32 scores, fp32
// row max / sum and fp32 accumulation, the unnormalised probabilities
// rounded to the value dtype for the PV product, the denominator summing
// the fp32 probabilities (mxu_denom: attention_switches.cu). q, k, v and o
// are read
// and written through their batch, head and row strides (innermost stride
// 1): contiguous [B, H, S, D] tensors, or split-head views [B, S, H, D] ->
// [B, H, S, D] of a [B, S, H*D] projection and of the [B, S, H*D] output.
//
// Bound on this card: operations. 4*B*H*S^2*D FLOPs against 4*B*H*S*D
// bytes ([32, 16, 1370, 64]: 246 GFLOP, 0.249 ms of bf16 tensor-core time,
// against 0.107 ms of memory time); the head-dim tile pads D up to 16, 32,
// 64 or 128, and the padded columns cost products the bound does not count.
//
// Design: K1's body (attention_flash.cuh) instantiated per head-dim tile:
// 128-key tiles streamed by TMA through a shared-memory ring into wgmma
// with an online softmax, so any S is taken (the TPU kernel keeps S
// resident and hands S > 8448 to XLA); columns past D arrive zero-filled
// from the tensor maps and are never stored; q's pre-scale is applied once
// to the Q tile in shared memory, rounded to bf16.

#include "attention_flash.cuh"

// dtype: 0 = fp32, 1 = bf16. Strides are in elements, (batch, head, row)
// for each of q, k, v, o; innermost strides are 1. q_scale is the softmax
// scale already rounded to q's dtype. Returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a D the kernel does not take);
// does not synchronise.
extern "C" int vda_attention_head_major(int dtype, const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int S, int D, long long q_sb,
                                        long long q_sh, long long q_ss,
                                        long long k_sb, long long k_sh,
                                        long long k_ss, long long v_sb,
                                        long long v_sh, long long v_ss,
                                        long long o_sb, long long o_sh,
                                        long long o_ss, float q_scale,
                                        void* stream) {
  using namespace vda::flash;
  const Params p{q, k, v, o, S, D,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 q_scale, 1.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 || D > 128) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch<16>(dtype, p, B, H, st);
  if (D <= 32) return launch<32>(dtype, p, B, H, st);
  if (D <= 64) return launch<64>(dtype, p, B, H, st);
  return launch<128>(dtype, p, B, H, st);
}
