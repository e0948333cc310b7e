// The flash-attention body shared by K1 (spatial_attention.cu) and K4
// (attention_head_major.cu), templated on the head-dim tile DT (16, 32, 64
// or 128). Each .cu that includes it compiles on its own.
//
// Computes, per (batch, head): softmax(q' k^T * s_scale) v, where
// q' = q * q_scale rounded to q's dtype (q_scale = 1 leaves q as it is),
// with fp32 scores, fp32 row max / sum and fp32 output accumulation; the
// unnormalised probabilities are rounded to the value dtype for the PV
// product. q, k, v and o are read and written in place through their
// batch, head and row strides (innermost stride 1), so one body serves the
// packed [B, S, H*dh] layout (head stride dh), head-major [B, H, S, D]
// tensors and split-head views of a fused projection. A head dim D below
// the tile (D % 8 == 0) is zero-filled on load and never stored.
//
// Design: each block owns one (64-query tile, head, batch) and streams
// 64-key tiles through shared memory with an online softmax (running row
// max m and sum l, the accumulator rescaled by exp(m_old - m_new)); each of
// the 4 warps owns 16 query rows end to end.
// bf16: both products run on tensor cores as mma.sync m16n8k16 with the
// scores, the probabilities and the output accumulator in registers (the
// FlashAttention-2 layout): a score fragment is re-packed in place as the A
// operand of the PV product, so nothing but the K/V tiles goes through
// shared memory. Operands come in with ldmatrix (V transposed on the fly);
// tile pitches of DT + 8 elements keep both conflict-free. K/V tiles are
// double buffered with cp.async (zero-filled past S and past D), so the
// next tile's load overlaps this tile's products. Row statistics live with
// the 4 lanes of a quad that share a row; the row sum is reduced across the
// quad once, at the end. Exponentials are exp2 of log2(e)-prescaled scores.
// fp32: true fp32 FMAs (no TF32), each lane owning two keys of the score
// strip and DT / 32 output dims (one for DT <= 32).
#pragma once

#include <math.h>

#include "attention_common.cuh"

namespace vda {
namespace flash {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int WARPS = 4;        // each warp owns BQ / WARPS = 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int RW = BQ / WARPS;  // rows per warp
constexpr int LDP = BK + 1;     // fp32 probability strip pitch (elements)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, D;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float q_scale;  // applied to q in its own dtype (already rounded to it)
  float s_scale;  // applied to the fp32 scores
};

template <int DT>
struct Tile {
  static constexpr int LDB = DT + 8;   // bf16 tile pitch (elements)
  static constexpr int LDF = DT + 1;   // fp32 tile pitch: odd, so column
                                       // reads by 32 lanes hit 32 banks
  static constexpr int TILE = BQ * LDB;
  // Q, then K and V double buffered.
  static constexpr size_t SMEM_BF16 = 5 * TILE * sizeof(__nv_bfloat16);
  // Q, K, V and the probability strip.
  static constexpr size_t SMEM_F32 = (3 * BQ * LDF + BQ * LDP) * sizeof(float);
};

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

// Rows [r0, r0 + 64) x DT columns of a row-strided bf16 matrix into a
// [64][LDB] tile, asynchronously; rows past S and columns past D are zero.
template <int DT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride, int r0,
                                                int S, int D) {
  for (int idx = threadIdx.x; idx < BQ * (DT / 8); idx += THREADS) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    const bool ok = r0 + r < S && c < D;
    cp_async16(dst + r * Tile<DT>::LDB + c,
               ok ? src + (long long)(r0 + r) * row_stride + c : src, ok);
  }
}

template <int DT>
__global__ void __launch_bounds__(THREADS) attention_bf16(const Params p) {
  constexpr int LDB = Tile<DT>::LDB, TILE = Tile<DT>::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + TILE;       // [2][TILE]
  __nv_bfloat16* Vs = Ks + 2 * TILE;   // [2][TILE]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * RW;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int S = p.S, D = p.D;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float sl2 = p.s_scale * 1.4426950408889634f;  // s_scale * log2(e)

  load_tile_async<DT>(Qs, qb, p.q_ss, q0, S, D);
  load_tile_async<DT>(Ks, kb, p.k_ss, 0, S, D);
  load_tile_async<DT>(Vs, vb, p.v_ss, 0, S, D);
  cp_async_commit();

  uint32_t qf[DT / 16][4];       // A fragments of the warp's 16 Q rows
  float acc[DT / 8][4];          // output: DT/8 dim blocks x (row g, g + 8)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // log2 domain
#pragma unroll
  for (int n = 0; n < DT / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (S + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile_async<DT>(Ks + (buf ^ 1) * TILE, kb, p.k_ss, (t + 1) * BK, S, D);
      load_tile_async<DT>(Vs + (buf ^ 1) * TILE, vb, p.v_ss, (t + 1) * BK, S, D);
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
      for (int kk = 0; kk < DT / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (r0 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
      if (p.q_scale != 1.f) {  // q * q_scale, rounded to bf16 per element
        const __nv_bfloat162 s2 = __float2bfloat162_rn(p.q_scale);
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]);
            x = __hmul2(x, s2);
            qf[kk][i] = *reinterpret_cast<uint32_t*>(&x);
          }
      }
    }

    // Scores [16 rows, 64 keys] = Q K^T: 8 key blocks of 8.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (DT % 32 == 0) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int kp = 0; kp < DT / 32; ++kp) {
          uint32_t kf[4];  // B fragments of 2 k-steps (K rows = keys, non-transposed)
          ldsm_x4(kf, Kt + (n * 8 + (lane & 7)) * LDB + kp * 32 + (lane >> 3) * 8);
          mma_bf16(s[n], qf[2 * kp], kf[0], kf[1]);
          mma_bf16(s[n], qf[2 * kp + 1], kf[2], kf[3]);
        }
      }
    } else {  // DT == 16: one k-step; one ldmatrix.x4 serves two key blocks
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, Kt + ((n + (lane >> 4)) * 8 + (lane & 7)) * LDB + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qf[0], kf[0], kf[1]);
        mma_bf16(s[n + 1], qf[0], kf[2], kf[3]);
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
    for (int n = 0; n < DT / 8; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // Output [16, DT] += P [16, 64 keys] V [64 keys, DT]: the score
    // fragments of key blocks 2kk and 2kk + 1 are the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DT / 16; ++np) {
        uint32_t vf[4];  // B fragments of dim blocks 2np, 2np + 1 (V transposed)
        ldsm_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * LDB + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  // Every lane shuffles before any lane skips a row past S.
  const float inv[2] = {1.f / fmaxf(quad_sum(l[0]), 1e-30f),
                        1.f / fmaxf(quad_sum(l[1]), 1e-30f)};
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + c2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = ob + row * p.o_ss;
#pragma unroll
    for (int n = 0; n < DT / 8; ++n)
      if (n * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
  }
}

// ---- fp32 ----

// Rows [r0, r0 + 64) x DT columns of a row-strided fp32 matrix into a
// [64][LDF] tile, each value times mul: 16-byte loads, scalar stores into
// the odd pitch; rows past S and columns past D are zero.
template <int DT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0, int S,
                                          int D, float mul) {
  for (int idx = threadIdx.x; idx < BQ * (DT / 4); idx += THREADS) {
    const int r = idx / (DT / 4), c = (idx % (DT / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c < D)
      val = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * row_stride + c);
    float* d = dst + r * Tile<DT>::LDF + c;
    d[0] = val.x * mul; d[1] = val.y * mul; d[2] = val.z * mul; d[3] = val.w * mul;
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

template <int DT>
__global__ void __launch_bounds__(THREADS) attention_f32(const Params p) {
  constexpr int LDF = Tile<DT>::LDF;
  constexpr int ND = DT < 32 ? 1 : DT / 32;  // output dims per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LDF;
  float* Vs = Ks + BK * LDF;
  float* Ps = Vs + BK * LDF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * RW;
  const int S = p.S, D = p.D;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<DT>(Qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                q0, S, D, p.q_scale);

  float m[RW], l[RW], alpha[RW], s0[RW], s1[RW], o[ND][RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY; l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) o[j][i] = 0.f;
  }

  const int ntiles = (S + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<DT>(Ks, kb, p.k_ss, k0, S, D, 1.f);
    load_tile<DT>(Vs, vb, p.v_ss, k0, S, D, 1.f);
    __syncthreads();

    // Lane owns keys lane and lane + 32 of the tile for the warp's 16 rows.
#pragma unroll
    for (int i = 0; i < RW; ++i) { s0[i] = 0.f; s1[i] = 0.f; }
    for (int d = 0; d < DT; ++d) {
      const float ka = Ks[lane * LDF + d], kc = Ks[(lane + 32) * LDF + d];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float qv = Qs[(r0 + i) * LDF + d];
        s0[i] = fmaf(qv, ka, s0[i]);
        s1[i] = fmaf(qv, kc, s1[i]);
      }
    }
    online_softmax(s0, s1, m, l, alpha, k0, S, p.s_scale);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      Ps[(r0 + i) * LDP + lane] = s0[i];
      Ps[(r0 + i) * LDP + lane + 32] = s1[i];
#pragma unroll
      for (int j = 0; j < ND; ++j) o[j][i] *= alpha[i];
    }
    __syncwarp();
    // Lane owns output dims lane + 32 j (lanes past DT read a padded
    // column and store nothing).
    for (int kj = 0; kj < BK; ++kj) {
      float va[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) va[j] = Vs[kj * LDF + min(lane + 32 * j, DT - 1)];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float pr = Ps[(r0 + i) * LDP + kj];
#pragma unroll
        for (int j = 0; j < ND; ++j) o[j][i] = fmaf(pr, va[j], o[j][i]);
      }
    }
    __syncwarp();
  }

  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      if (lane + 32 * j < D) ob[row * p.o_ss + lane + 32 * j] = o[j][i] * inv;
  }
}

// dtype: 0 = fp32, 1 = bf16. Grid (query tiles, H, B); returns the
// cudaError_t of the launch (0 on success); does not synchronise.
template <int DT>
int launch(int dtype, const Params& p, int B, int H, cudaStream_t st) {
  const dim3 grid((p.S + BQ - 1) / BQ, H, B);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(attention_bf16<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tile<DT>::SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    attention_bf16<DT><<<grid, THREADS, Tile<DT>::SMEM_BF16, st>>>(p);
  } else if (dtype == 0) {
    err = cudaFuncSetAttribute(attention_f32<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tile<DT>::SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    attention_f32<DT><<<grid, THREADS, Tile<DT>::SMEM_F32, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace vda
