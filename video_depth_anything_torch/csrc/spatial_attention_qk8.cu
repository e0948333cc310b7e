// Spatial multi-head attention with int8 QK (the --int8 encoder), for
// Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_attention.py
//   flash_attention_packed_qk8 (its Pallas body _packed_qk8_kernel).
// Computes, per (batch, head): s = int32(q8 k8^T), exact;
//   p = exp((s - rowmax s) * sq * sk), rounded to v's dtype for the PV
//   product; o = p v / sum(p) with fp32 accumulation; keys past S masked.
// q8 and k8 are contiguous int8 [B, S, H*64] (the quant_act outputs); v is
// a [B, S, H*64] view read in place with its own batch and row strides (a
// column view of the fused qkv output); scales is fp32 [2] on the device,
// (sq, sk) with the attention scale folded into sq, read by every block (no
// host round trip). The output is a contiguous [B, S, H*64] in v's dtype.
//
// Bound on this card: operations. 2*B*H*S^2*64 int8 ops for QK at
// 1979 TOP/s plus as many bf16 FLOPs for PV at 989 TFLOP/s (67 TFLOP/s for
// fp32 v) against B*S*C*(1 + 1 + 2 * sizeof(v)) bytes (the main path's
// [22, 1814, 384]: about 0.084 ms of tensor-core time against 0.027 ms of
// memory time).
//
// Design: K1's (csrc/spatial_attention.cu). The TPU kernel keeps all of S
// resident; here each block owns one (64-query tile, head, batch) and
// streams 64-key tiles through shared memory with an online softmax, K
// (int8) and V double buffered with cp.async and zero-filled past S. Each
// of the 4 warps owns 16 query rows end to end. QK runs on the int8 tensor
// cores, mma.sync m16n8k32 s8.s8.s32, which is exact: |s| <= 64 * 127^2 <
// 2^24, so scores and row maxima convert to fp32 exactly and the running
// max is an integer held in fp32. An int8 row of one head is 64 bytes, so
// the A and B fragments load with the same ldmatrix (b16) addressing, in
// bytes, as K1's bf16 tiles; one ldmatrix.x4 brings 8 keys x 64 dims. The
// int32 accumulator has the fp32 accumulator's fragment layout, so the
// softmax and PV are K1's: bf16 v re-packs the probabilities from registers
// as the A operand of mma.sync m16n8k16 (V transposed by ldmatrix.trans);
// fp32 v (--int8 --fp32) writes the warp's probability strip to shared
// memory and runs K1's fp32 FMA product, each lane owning two output dims.
// The denominator sums the fp32 probabilities, as K1 does (the TPU kernel
// sums the bf16-rounded ones on its matrix unit).
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
constexpr int LD8 = DH + 16;    // int8 tile pitch (bytes): 80, so the 8 rows
                                // of an ldmatrix hit 8 distinct bank quads
constexpr int TILE8 = BQ * LD8; // bytes of one int8 tile
constexpr int LDB = DH + 8;     // bf16 V tile pitch (elements): 144 B rows
constexpr int LDF = DH + 4;     // fp32 V tile pitch (elements): 272 B rows
constexpr int LDP = BK + 1;     // fp32 probability strip pitch (elements)
constexpr float LOG2E = 1.4426950408889634f;

template <bool BF16> struct VType { using T = float; static constexpr int LD = LDF; };
template <> struct VType<true> { using T = __nv_bfloat16; static constexpr int LD = LDB; };

// Q, K double buffered, V double buffered, and (fp32 v) the probability strip.
template <bool BF16>
constexpr size_t smem_bytes() {
  return 3 * TILE8 + 2 * BK * VType<BF16>::LD * sizeof(typename VType<BF16>::T)
         + (BF16 ? 0 : BQ * LDP * sizeof(float));
}

// d += a[16x32, row] * b[32x8, col], int8 in, exact int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 64) x 64 columns of a row-strided matrix into a [64][LD]
// tile, 16 bytes a copy, asynchronously; rows past S are zero.
template <typename T, int LD>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long row_stride, int r0,
                                                int S) {
  constexpr int VEC = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < BK * (DH / VEC); idx += THREADS) {
    const int r = idx / (DH / VEC), c = (idx % (DH / VEC)) * VEC;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LD + c, src + (long long)(ok ? r0 + r : 0) * row_stride + c, ok);
  }
}

// The value of v[] for row i (0..15) of the warp, where the MMA layout keeps
// rows g and g + 8 in v[0] and v[1] of lane 4g.
__device__ __forceinline__ float row_value(const float (&v)[2], int i) {
  return __shfl_sync(0xffffffffu, i < 8 ? v[0] : v[1], (i & 7) * 4);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
attention_qk8(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
              const typename VType<BF16>::T* __restrict__ v,
              const float* __restrict__ scales,
              typename VType<BF16>::T* __restrict__ o, int S, int H,
              long long v_sb, long long v_ss) {
  using T = typename VType<BF16>::T;
  constexpr int LDV = VType<BF16>::LD;
  constexpr int VTILE = BK * LDV;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  int8_t* Ks = Qs + TILE8;                          // [2][TILE8]
  T* Vs = reinterpret_cast<T*>(Ks + 2 * TILE8);     // [2][VTILE]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * VTILE);  // fp32 v: [BQ][LDP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * RW;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const long long C = (long long)H * DH;
  const long long qk_off = (long long)b * S * C + h * DH;
  const int8_t* kb = k + qk_off;
  const T* vb = v + (long long)b * v_sb + h * DH;
  const float cl2 = scales[0] * scales[1] * LOG2E;  // score scale, log2 domain

  load_tile_async<int8_t, LD8>(Qs, q + qk_off, C, q0, S);
  load_tile_async<int8_t, LD8>(Ks, kb, C, 0, S);
  load_tile_async<T, LDV>(Vs, vb, v_ss, 0, S);
  cp_async_commit();

  uint32_t qf[DH / 32][4];  // A fragments of the warp's 16 Q rows, 2 k-steps
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // Output: bf16 v in the MMA layout (8 dim blocks x (row g, g + 8));
  // fp32 v as lane-owned dims lane and lane + 32 of the warp's 16 rows.
  constexpr int NACC = BF16 ? DH / 8 : 1, NROW = BF16 ? 1 : RW;
  float acc[NACC][4], o0[NROW], o1[NROW];
#pragma unroll
  for (int n = 0; n < NACC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int i = 0; i < NROW; ++i) o0[i] = o1[i] = 0.f;

  const int ntiles = (S + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile_async<int8_t, LD8>(Ks + (buf ^ 1) * TILE8, kb, C, (t + 1) * BK, S);
      load_tile_async<T, LDV>(Vs + (buf ^ 1) * VTILE, vb, v_ss, (t + 1) * BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const int8_t* Kt = Ks + buf * TILE8;
    const T* Vt = Vs + buf * VTILE;
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 32; ++kk)
        ldsm_x4(qf[kk], Qs + (r0 + (lane & 15)) * LD8 + kk * 32 + (lane >> 4) * 16);
    }

    // Scores [16 rows, 64 keys] = Q K^T in int32: 8 key blocks of 8, each
    // one ldmatrix.x4 of 8 keys x 64 bytes and two k-steps of 32.
    int si[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
      uint32_t kf[4];
      ldsm_x4(kf, Kt + (n * 8 + (lane & 7)) * LD8 + (lane >> 3) * 16);
      mma_s8(si[n], qf[0], kf[0], kf[1]);
      mma_s8(si[n], qf[1], kf[2], kf[3]);
    }

    // Online softmax on the exact integer scores; the ragged key edge is
    // -inf. Key t*BK < S always, so the new row max is finite.
    const int k0 = t * BK;
    float s[BK / 8][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + n * 8 + c2 + (e & 1) < S;
        s[n][e] = ok ? static_cast<float>(si[n][e]) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = m[i] == -INFINITY ? 0.f : exp2f((m[i] - mn) * cl2);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f((s[n][e] - m[e >> 1]) * cl2);
        l[e >> 1] += s[n][e];  // this lane's part of the row sum
      }
    }

    if constexpr (BF16) {
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
          ldsm_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * LDV + np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    } else {
      // The warp's probability strip [16, 64] to shared memory, then fp32
      // FMAs: lane owns output dims lane and lane + 32.
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ps[(r0 + g + 8 * (e >> 1)) * LDP + n * 8 + c2 + (e & 1)] = s[n][e];
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float a = row_value(alpha, i);
        o0[i] *= a;
        o1[i] *= a;
      }
      __syncwarp();
      for (int j = 0; j < BK; ++j) {
        const float va = Vt[j * LDV + lane], vc = Vt[j * LDV + lane + 32];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float p = Ps[(r0 + i) * LDP + j];
          o0[i] = fmaf(p, va, o0[i]);
          o1[i] = fmaf(p, vc, o1[i]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  // Every lane shuffles before any lane skips a row past S.
  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};
  if constexpr (BF16) {
    const float inv[2] = {1.f / fmaxf(lt[0], 1e-30f), 1.f / fmaxf(lt[1], 1e-30f)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + g + 8 * i;
      if (row >= S) continue;
      T* orow = o + ((long long)b * S + row) * C + h * DH + c2;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float inv = 1.f / fmaxf(row_value(lt, i), 1e-30f);
      const int row = q0 + r0 + i;
      if (row >= S) continue;
      T* orow = o + ((long long)b * S + row) * C + h * DH;
      orow[lane] = o0[i] * inv;
      orow[lane + 32] = o1[i] * inv;
    }
  }
}

template <bool BF16>
int launch(const void* q8, const void* k8, const void* v, const void* scales,
           void* o, int B, int S, int H, long long v_sb, long long v_ss,
           cudaStream_t st) {
  using T = typename VType<BF16>::T;
  constexpr size_t smem = smem_bytes<BF16>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_qk8<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attention_qk8<BF16><<<grid, THREADS, smem, st>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const T*>(v), static_cast<const float*>(scales),
      static_cast<T*>(o), S, H, v_sb, v_ss);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of v and o): 0 = fp32, 1 = bf16. q8, k8 contiguous int8 [B, S,
// H*64]; v strides in elements, innermost 1; scales fp32 [2] on the device;
// o contiguous [B, S, H*64]. Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int vda_spatial_attention_qk8(int dtype, const void* q8, const void* k8,
                                         const void* v, const void* scales, void* o,
                                         int B, int S, int H, long long v_sb,
                                         long long v_ss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<true>(q8, k8, v, scales, o, B, S, H, v_sb, v_ss, st);
  if (dtype == 0) return launch<false>(q8, k8, v, scales, o, B, S, H, v_sb, v_ss, st);
  return (int)cudaErrorInvalidValue;
}
