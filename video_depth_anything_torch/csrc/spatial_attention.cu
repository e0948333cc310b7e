// Spatial multi-head attention of the DINOv2 blocks, for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_attention.py
//   flash_attention_packed (its Pallas body _packed_kernel).
// Computes, per (batch, head): softmax(q k^T * scale) v with fp32 scores,
// fp32 row max / sum and fp32 output accumulation; the unnormalised
// probabilities are rounded to the value dtype for the PV product; the
// denominator sums the fp32 probabilities. (The JAX kernel's mxu_denom and
// exp2 options run the body's other instances, attention_switches.cu.) q, k, v
// are [B, S, H*64] views read in place with their own batch and row strides
// (the fused qkv projection output [B, S, 3C] is passed as three column
// views, no copy); the output is a contiguous [B, S, H*64].
//
// Bound on this card: operations. 4*B*H*S^2*64 FLOPs against 4*B*S*C
// bytes moved (vits at B=32, S=1370: ~92 GFLOP vs ~135 MB, about 93 us of
// bf16 tensor-core time vs 40 us of memory time). At dh = 64 the B*H*S^2
// exponentials meet a similar bound on the special-function units.
//
// Design: the TPU kernel keeps all of S resident and runs a one-pass
// softmax; here K and V for one head at S = 1370 would not fit a block's
// shared memory, so the body (attention_flash.cuh, shared with K4 and K5)
// streams 128-key tiles with an online softmax. bf16: 128-query blocks,
// a TMA producer feeding a K / V ring, two consumer warpgroups on wgmma
// that take turns on the tensor cores (one's exponentials under the
// other's products); the strided column views of the fused qkv are read in
// place through the tensor maps. fp32: FMAs.

#include "attention_flash.cuh"

// dtype: 0 = fp32, 1 = bf16. Strides are in elements; the innermost
// stride of q, k and v is 1 and o is contiguous [B, S, H*64]. Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int vda_spatial_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, long long q_sb, long long q_ss,
                                     long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss,
                                     float scale, void* stream) {
  constexpr int DH = 64;
  const long long C = (long long)H * DH;
  const vda::flash::Params p{q, k, v, o, S, DH,
                             q_sb, DH, q_ss, k_sb, DH, k_ss,
                             v_sb, DH, v_ss, S * C, DH, C,
                             1.f, scale};
  return vda::flash::launch<DH>(dtype, p, B, H, static_cast<cudaStream_t>(stream));
}
