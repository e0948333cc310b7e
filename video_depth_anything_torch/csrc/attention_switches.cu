// The attention body's option instances for K1, K4 and K5, for Hopper
// (sm_90a): the JAX kernels' mxu_denom and exp2 options.
//
// Replaces: the JAX package's ops/pallas_attention.py options
//   flash_attention_packed(mxu_denom=, exp2=) (K1; body _packed_kernel
//   :76-89, :107-120), flash_attention(mxu_denom=) (K4; _attn_kernel
//   :398-413) and flash_attention_qkv_fused(mxu_denom=) (K5).
// Computes K1's and K4's functions (spatial_attention.cu,
// attention_head_major.cu) with either switch:
//   mxu_denom: the softmax denominator sums the probabilities after their
//     rounding to bf16 for PV. Both JAX settings of mxu_denom compute this
//     (the cast precedes the sum: pallas_attention.py:113 before :119, :397
//     before :413); they differ only in which unit adds. In fp32 the
//     rounding is the identity and the default kernel's function.
//   exp2 (K1): q pre-scaled in its dtype by scale * log2(e) (the caller
//     passes it rounded), the scores exponentiated in base 2.
//
// Bound on this card: K1's and K4's (operations: 4*B*H*S^2*D FLOPs). The
// denominator's product adds 8 / D of PV's tensor work (12.5 % at D = 64)
// and takes one FADD per score off the consumer warpgroups.
//
// Design: the instances attention_bf16<DT, false, DENOM_ONES> and
// <64, false, *, SCHED_STAGGER, true> of the body (attention_flash.cuh),
// in a library of their own: compiled beside the default instances, they
// changed how ptxas scheduled those (the same instructions in another
// order), and the defaults are the ones the model runs.

#include "attention_flash.cuh"

// K1 with its switches (at least one set): as vda_spatial_attention, with
// q_scale pre-scaling q in its dtype (already rounded to it; 1: none) and
// s_scale scaling the fp32 scores (exp2: log2-domain, 1). Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int vda_spatial_attention_switch(int dtype, const void* q, const void* k,
                                            const void* v, void* o, int B, int S, int H,
                                            long long q_sb, long long q_ss, long long k_sb,
                                            long long k_ss, long long v_sb, long long v_ss,
                                            float q_scale, float s_scale, int mxu_denom,
                                            int exp2, void* stream) {
  using namespace vda::flash;
  constexpr int DH = 64;
  const long long C = (long long)H * DH;
  const Params p{q, k, v, o, S, DH,
                 q_sb, DH, q_ss, k_sb, DH, k_ss,
                 v_sb, DH, v_ss, S * C, DH, C,
                 q_scale, s_scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (exp2)
    return mxu_denom ? launch<DH, false, DENOM_ONES, SCHED_STAGGER, true>(dtype, p, B, H, st)
                     : launch<DH, false, DENOM_FP32, SCHED_STAGGER, true>(dtype, p, B, H, st);
  if (mxu_denom) return launch<DH, false, DENOM_ONES>(dtype, p, B, H, st);
  return (int)cudaErrorInvalidValue;   // no switch: vda_spatial_attention
}

// K4 with mxu_denom: as vda_attention_head_major. Returns the cudaError_t
// of the launch (0 on success; cudaErrorInvalidValue for a D the kernel
// does not take); does not synchronise.
extern "C" int vda_attention_head_major_ones(int dtype, const void* q, const void* k,
                                             const void* v, void* o, int B, int H, int S, int D,
                                             long long q_sb, long long q_sh, long long q_ss,
                                             long long k_sb, long long k_sh, long long k_ss,
                                             long long v_sb, long long v_sh, long long v_ss,
                                             long long o_sb, long long o_sh, long long o_ss,
                                             float q_scale, void* stream) {
  using namespace vda::flash;
  const Params p{q, k, v, o, S, D,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 q_scale, 1.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 || D > 128) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch<16, false, DENOM_ONES>(dtype, p, B, H, st);
  if (D <= 32) return launch<32, false, DENOM_ONES>(dtype, p, B, H, st);
  if (D <= 64) return launch<64, false, DENOM_ONES>(dtype, p, B, H, st);
  return launch<128, false, DENOM_ONES>(dtype, p, B, H, st);
}
