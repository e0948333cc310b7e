// Spatial multi-head attention of the DINOv2 blocks, for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_attention.py
//   flash_attention_packed (its Pallas body _packed_kernel).
// Computes, per (batch, head): softmax(q k^T * scale) v with fp32 scores,
// fp32 row max / sum and fp32 output accumulation; the unnormalised
// probabilities are rounded to the value dtype for the PV product. q, k, v
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
// shared memory, so each block owns one (64-query tile, head, batch) and
// streams 64-key tiles through shared memory with an online softmax
// (running row max m and sum l, the accumulator rescaled by
// exp(m_old - m_new)). Each of the 4 warps owns 16 query rows end to end.
//
// bf16: both products run on tensor cores as mma.sync m16n8k16 with the
// scores, the probabilities and the output accumulator in registers (the
// FlashAttention-2 layout): a score fragment is re-packed in place as the A
// operand of the PV product, so nothing but the K/V tiles goes through
// shared memory. Operands come in with ldmatrix (V transposed on the fly);
// tile pitches of 144 B keep both conflict-free. K/V tiles are double
// buffered with cp.async (zero-filled past S), so the next tile's load
// overlaps this tile's products. Row statistics live with the 4 lanes of a
// quad that share a row; the row sum is reduced across the quad once, at
// the end. Exponentials are exp2 of log2(e)-prescaled scores.
// fp32 (the --fp32 path): true fp32 FMAs (no TF32), each lane owning two
// keys of the score strip and two output dims.
// Not yet: wgmma, TMA, warp specialisation.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vda;

constexpr int DH = 64;          // head dim (all four encoders)
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int WARPS = 4;        // each warp owns BQ / WARPS = 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int RW = BQ / WARPS;  // rows per warp
constexpr int LDB = DH + 8;     // bf16 tile pitch (elements): 144 B rows
constexpr int LDF = DH + 1;     // fp32 tile pitch (fp32 path): odd, so
                                // column reads by 32 lanes hit 32 banks
constexpr int TILE = BQ * LDB;  // elements of one bf16 tile

// Q, then K and V double buffered.
constexpr size_t SMEM_BF16 = 5 * TILE * sizeof(__nv_bfloat16);
constexpr size_t SMEM_F32 = 4 * BQ * LDF * sizeof(float);

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 64) x 64 columns of a row-strided bf16 matrix into a
// [64][LDB] tile, asynchronously; rows past S are zero.
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride, int r0,
                                                int S) {
  for (int idx = threadIdx.x; idx < BQ * (DH / 8); idx += THREADS) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LDB + c, src + (long long)(ok ? r0 + r : 0) * row_stride + c, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
attention_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, int H,
               long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + TILE;       // [2][TILE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;   // [2][TILE]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * RW;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const __nv_bfloat16* kb = k + b * k_sb + h * DH;
  const __nv_bfloat16* vb = v + b * v_sb + h * DH;
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)

  load_tile_async(Qs, q + b * q_sb + h * DH, q_ss, q0, S);
  load_tile_async(Ks, kb, k_ss, 0, S);
  load_tile_async(Vs, vb, v_ss, 0, S);
  cp_async_commit();

  uint32_t qf[DH / 16][4];       // A fragments of the warp's 16 Q rows
  float acc[DH / 8][4];          // output: 8 dim blocks x (row g, g + 8)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // log2 domain
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (S + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile_async(Ks + (buf ^ 1) * TILE, kb, k_ss, (t + 1) * BK, S);
      load_tile_async(Vs + (buf ^ 1) * TILE, vb, v_ss, (t + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const __nv_bfloat16* Kt = Ks + buf * TILE;
    const __nv_bfloat16* Vt = Vs + buf * TILE;
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (r0 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
    }

    // Scores [16 rows, 64 keys] = Q K^T: 8 key blocks of 8.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < DH / 32; ++kp) {
        uint32_t kf[4];  // B fragments of 2 k-steps (K rows = keys, non-transposed)
        ldsm_x4(kf, Kt + (n * 8 + (lane & 7)) * LDB + kp * 32 + (lane >> 3) * 8);
        mma_bf16(s[n], qf[2 * kp], kf[0], kf[1]);
        mma_bf16(s[n], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }

    // Online softmax; the ragged key edge is -inf. Key t*BK < S always, so
    // the new row max is finite.
    const int k0 = t * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + n * 8 + c2 + (e & 1) < S;
        s[n][e] = ok ? s[n][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - mn);  // exp2(-inf) = 0 on the first tile
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];  // this lane's part of the row sum
      }
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // Output [16, 64] += P [16, 64 keys] V [64 keys, 64]: the score
    // fragments of key blocks 2kk and 2kk + 1 are the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t vf[4];  // B fragments of dim blocks 2np, 2np + 1 (V transposed)
        ldsm_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * LDB + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  const long long C = (long long)H * DH;
  // Every lane shuffles before any lane skips a row past S.
  const float inv[2] = {1.f / fmaxf(quad_sum(l[0]), 1e-30f),
                        1.f / fmaxf(quad_sum(l[1]), 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + ((long long)b * S + row) * C + h * DH + c2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
  }
}

// ---- fp32 ----

// Rows [r0, r0 + 64) x 64 columns of a row-strided fp32 matrix into a
// [64][LDF] tile: 16-byte loads, scalar stores into the odd pitch; rows
// past S are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int S) {
  for (int idx = threadIdx.x; idx < BQ * (DH / 4); idx += THREADS) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * row_stride + c);
    float* d = dst + r * LDF + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// One online-softmax step for the warp's 16 rows. s0/s1 hold the raw scores
// of keys k0 + lane and k0 + lane + 32; returns the probabilities in place
// and the per-row rescale factor of the running accumulator in alpha.
__device__ __forceinline__ void online_softmax(float (&s0)[RW], float (&s1)[RW],
                                               float (&m)[RW], float (&l)[RW],
                                               float (&alpha)[RW], int k0,
                                               int S, float scale) {
  const int lane = threadIdx.x & 31;
  const bool ok0 = k0 + lane < S, ok1 = k0 + lane + 32 < S;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float a = ok0 ? s0[i] * scale : -INFINITY;
    const float b = ok1 ? s1[i] * scale : -INFINITY;
    // Key k0 < S always, so the new row max is finite.
    const float mn = fmaxf(m[i], warp_max(fmaxf(a, b)));
    s0[i] = expf(a - mn);
    s1[i] = expf(b - mn);
    alpha[i] = expf(m[i] - mn);  // exp(-inf) = 0 on the first tile
    l[i] = l[i] * alpha[i] + warp_sum(s0[i] + s1[i]);
    m[i] = mn;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int H, long long q_sb, long long q_ss, long long k_sb,
              long long k_ss, long long v_sb, long long v_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LDF;
  float* Vs = Ks + BK * LDF;
  float* Ps = Vs + BK * LDF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * RW;

  load_tile(Qs, q + b * q_sb + h * DH, q_ss, q0, S);

  float m[RW], l[RW], alpha[RW], s0[RW], s1[RW], o0[RW], o1[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY; l[i] = 0.f; o0[i] = 0.f; o1[i] = 0.f;
  }

  const int ntiles = (S + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile(Ks, k + b * k_sb + h * DH, k_ss, k0, S);
    load_tile(Vs, v + b * v_sb + h * DH, v_ss, k0, S);
    __syncthreads();

    // Lane owns keys lane and lane + 32 of the tile for the warp's 16 rows.
#pragma unroll
    for (int i = 0; i < RW; ++i) { s0[i] = 0.f; s1[i] = 0.f; }
    for (int d = 0; d < DH; ++d) {
      const float ka = Ks[lane * LDF + d], kc = Ks[(lane + 32) * LDF + d];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float qv = Qs[(r0 + i) * LDF + d];
        s0[i] = fmaf(qv, ka, s0[i]);
        s1[i] = fmaf(qv, kc, s1[i]);
      }
    }
    online_softmax(s0, s1, m, l, alpha, k0, S, scale);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      Ps[(r0 + i) * LDF + lane] = s0[i];
      Ps[(r0 + i) * LDF + lane + 32] = s1[i];
      o0[i] *= alpha[i];
      o1[i] *= alpha[i];
    }
    __syncwarp();
    // Lane owns output dims lane and lane + 32.
    for (int j = 0; j < BK; ++j) {
      const float va = Vs[j * LDF + lane], vc = Vs[j * LDF + lane + 32];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float p = Ps[(r0 + i) * LDF + j];
        o0[i] = fmaf(p, va, o0[i]);
        o1[i] = fmaf(p, vc, o1[i]);
      }
    }
    __syncwarp();
  }

  const long long C = (long long)H * DH;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = r0 + i;
    if (q0 + r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + ((long long)b * S + q0 + r) * C + h * DH;
    orow[lane] = o0[i] * inv;
    orow[lane + 32] = o1[i] * inv;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Strides are in elements; the innermost
// stride of q, k and v is 1 and o is contiguous [B, S, H*64]. Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int vda_spatial_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, long long q_sb, long long q_ss,
                                     long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss,
                                     float scale, void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(attention_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    attention_bf16<<<grid, THREADS, SMEM_BF16, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        S, H, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale);
  } else if (dtype == 0) {
    err = cudaFuncSetAttribute(attention_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    attention_f32<<<grid, THREADS, SMEM_F32, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, q_sb,
        q_ss, k_sb, k_ss, v_sb, v_ss, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
