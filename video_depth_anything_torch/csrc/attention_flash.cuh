// The flash-attention body shared by K1 (spatial_attention.cu), K3
// (spatial_attention_qk8.cu, bf16 v), K4 (attention_head_major.cu), K5
// (K1's entry at scale 1) and the schedule variants T2
// (attention_variants.cu), templated on the head-dim tile DT (16, 32, 64 or
// 128), for K3 on int8 q and k (QK8), and on the options below, each of
// which defaults to the instance the model runs. Each .cu that includes it
// compiles on its own.
//
// Computes, per (batch, head): softmax(q' k^T * s_scale) v, where
// q' = q * q_scale rounded to q's dtype (q_scale = 1 leaves q as it is),
// with fp32 scores, fp32 row max / sum and fp32 output accumulation; the
// unnormalised probabilities are rounded to the value dtype for the PV
// product, and the output is normalised at the end. q, k, v and o are read
// and written in place through their batch, head and row strides (innermost
// stride 1), so one body serves the packed [B, S, H*dh] layout (head stride
// dh), head-major [B, H, S, D] tensors and split-head views of a fused
// projection. A head dim D below the tile (D % 8 == 0) is zero-filled on
// load and never stored.
//
// bf16 (attention_bf16), along FlashAttention-3's lines (Shah et al.,
// 2024): a block owns 128 query rows of one (batch, head) and runs three
// warpgroups. A producer warp issues TMA loads (4D tensor maps carrying the
// batch, head and row strides, so strided views are read in place; rows
// past S and columns past D arrive as zeros): Q once, then 128-key K and V
// tiles into a 3-stage ring (2 at DT = 128) with full / empty mbarriers.
// Two consumer warpgroups own 64 query rows each. Per key tile a consumer
// issues QK^T as wgmma (A = its Q rows, B = the K tile, both K-major from
// shared memory) together with the previous tile's PV as wgmma (A = the
// probabilities packed to bf16 in registers, B = the V tile read MN-major
// through the descriptor's transpose bit), then runs the online softmax on
// the fresh scores (exp2 of log2(e)-prescaled scores, keys past S at -inf)
// while PV runs, and rescales the accumulator once PV is done. The two
// consumers take turns on the tensor cores through named barriers
// (ping-pong), so one's exponentials run under the other's products. K4's
// q pre-scale is applied once to the Q tile in shared memory, rounded to
// bf16. Tiles use the widest swizzle their rows allow (32, 64 or 128 bytes);
// DT = 128 is two 64-column sub-tiles. Nothing in the K loop calls
// __syncthreads.
// Options of the bf16 body (K1, K4, K5 and T2 take them; K3 the defaults):
//   DENOM: DENOM_FP32 (default) sums the fp32 probabilities on the FMA
//     units (one FADD per score); DENOM_ONES sums them after their rounding
//     to bf16 for PV, which is what both settings of the JAX kernels'
//     mxu_denom compute (the TPU's ones column appended to V). Here it is a
//     second wgmma per PV k step, m64n8k16 with the same A fragment (the
//     rounded probabilities in registers) against an 8 x 16 tile of ones
//     in shared memory, written once: the denominator arrives in an fp32
//     accumulator of its own, rescaled by alpha with the output, and every
//     column of it holds the row's sum, so no lane needs a shuffle. A
//     separate product and not PV widened to N = 72: the V ring's
//     128-byte-swizzled stages would each need a ones block at the same
//     offset for the descriptor, and DT = 128's two sub-tiles a third
//     product anyway. Keys past S already carry p = 0: no mask.
//   SCHED: the order of one consumer's phases per key tile. SCHED_STAGGER
//     (default): QK(t + 1) is issued with PV(t) and softmax(t + 1) runs
//     while PV(t) is in flight (FlashAttention-3's intra-warpgroup overlap).
//     SCHED_BASE: QK(t), wait, softmax(t), PV(t), wait: no overlap inside a
//     warpgroup; each product takes its own turn of the ping-pong.
//     SCHED_KCHUNK: the key tiles in two halves, each consumer carrying
//     two online-softmax chains (one per half, own output, denominator and
//     row max) whose tiles alternate, merged at the end: a chain's rescale
//     does not wait for the other chain's PV, which runs under it. It
//     holds two 64 x DT outputs in registers (the A fragments are shared),
//     more than the launch bound leaves a thread: ptxas serialises its
//     products (C7511).
//   EXP2: the scores arrive in the log2 domain (the caller folded log2(e)
//     into q's pre-scale, as JAX's exp2 option does), so the exponent's
//     multiplier is s_scale itself (1 exactly), not s_scale * log2(e); a
//     template flag, so that the default instance keeps its instructions.
// int8 QK (QK8, K3; DT = 64): q and k are int8 rows of 64 bytes, loaded by
// TMA into 64-byte-swizzled tiles; QK runs as wgmma s8.s8 -> s32 in two
// k steps of 32 bytes, exact (|s| <= 64 * 127^2 < 2^24), and the int32
// scores turn into fp32 once their group is waited for. The score scale is
// scales[0] * scales[1], read from the device. The rest is the bf16 body's:
// the row max taken on the (integer) scores, keys past S at -inf and out
// of the row max, PV on bf16 V, the fp32 denominator.
// fp32 (attention_f32, the --fp32 correctness path): true fp32 FMAs (no
// TF32), 64-query blocks of 4 warps, each lane owning two keys of the score
// strip and DT / 32 output dims (one for DT <= 32); EXP2 takes exp2f of
// log2-domain scores. Rounding fp32 probabilities to fp32 is the identity,
// so both denominators are the one it computes.
#pragma once

#include <math.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace vda {
namespace flash {

// fp32 body: blocks of BQ queries, 4 warps of RW rows, BK-key tiles.
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
  float s_scale;  // applied to the fp32 scores; > 0
  const float* scales;  // QK8: the score scale is scales[0] * scales[1] (device)
};

template <int DT>
struct Tile {
  static constexpr int LDF = DT + 1;   // fp32 tile pitch: odd, so column
                                       // reads by 32 lanes hit 32 banks
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

// ---- bf16: wgmma, TMA, warp specialisation ----

// 2^x on the special-function unit (ex2.approx, flush to zero; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}


template <int DT, bool QK8 = false>
struct Wg {
  static constexpr int BQ = 128;                    // query rows per block
  static constexpr int BK = 128;                    // keys per tile
  static constexpr int SW = DT * 2 < 128 ? DT * 2 : 128;  // swizzle = sub-tile row bytes
  static constexpr int COLS = SW / 2;               // columns per sub-tile
  static constexpr int NSUB = DT / COLS;            // sub-tiles per tile
  // Q and K: bf16 sub-tiles as V, or (QK8) int8 rows of DT bytes, one sub-tile.
  static constexpr int QK_SW = QK8 ? DT : SW;
  static constexpr int QK_COLS = QK8 ? DT : COLS;
  static constexpr int QK_NSUB = DT / QK_COLS;
  static constexpr int STAGES = DT == 128 ? 2 : 3;  // K / V ring depth
  static constexpr int Q_BYTES = BQ * DT * (QK8 ? 1 : 2);
  static constexpr int K_BYTES = BK * DT * (QK8 ? 1 : 2);
  static constexpr int V_BYTES = BK * DT * 2;
  static constexpr int THREADS = 384;               // consumers 0, 1; producer 2
  static constexpr int BARS = 1 + 4 * STAGES;       // q, k full / empty, v full / empty
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 8 * BARS;
};

struct alignas(64) TmaParams {
  CUtensorMap q, k, v;  // dims (D, S, H, B), boxes (COLS, 128, 1, 1)
  Params p;
};

// The denominator of the bf16 body (template parameter DENOM).
constexpr int DENOM_FP32 = 0;  // the fp32 probabilities summed on the FMA units (default)
constexpr int DENOM_ONES = 1;  // the bf16-rounded ones summed on the tensor cores (JAX's)
// The order of one consumer's phases per key tile (template parameter SCHED).
constexpr int SCHED_STAGGER = 0;  // QK(t + 1) with PV(t), softmax(t + 1) under PV(t) (default)
constexpr int SCHED_BASE = 1;     // QK(t), wait, softmax(t), PV(t), wait
constexpr int SCHED_KCHUNK = 2;   // two chains over the two halves of the keys

// A compile-time chain index, so that a consumer's per-chain register
// arrays are indexed by constants only.
template <int C>
struct Chain {
  static constexpr int value = C;
};

template <int DT, bool QK8 = false, int DENOM = DENOM_FP32, int SCHED = SCHED_STAGGER,
          bool EXP2 = false>
__global__ void __launch_bounds__(384, 1) attention_bf16(const __grid_constant__ TmaParams tp) {
  using W = Wg<DT, QK8>;
  using namespace hopper;
  constexpr int SW = W::SW, COLS = W::COLS, NSUB = W::NSUB, ST = W::STAGES, BK = W::BK;
  constexpr int QSW = W::QK_SW, QCOLS = W::QK_COLS, QNSUB = W::QK_NSUB;
  constexpr bool ONES = DENOM == DENOM_ONES;
  constexpr int CH = SCHED == SCHED_KCHUNK ? 2 : 1;   // online-softmax chains per consumer
  extern __shared__ unsigned char smem_raw[];
  // Tiles 1024-aligned (the 128-byte swizzle's atom), barriers after them.
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;                              // QNSUB x [128][QSW]
  unsigned char* Ks = Qs + W::Q_BYTES;                   // ST x QNSUB x [128][QSW]
  unsigned char* Vs = Ks + ST * W::K_BYTES;              // ST x NSUB x [128][SW]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + ST * W::V_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  // ONES: an 8 x 16 bf16 tile of ones, 256 bytes past the barriers.
  unsigned char* ones = reinterpret_cast<unsigned char*>(bars) + 256;

  const Params& p = tp.p;
  const int S = p.S, D = p.D;
  const int q0 = blockIdx.x * W::BQ, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (S + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
  // The key tile of the i-th step: in order, or (kchunk) alternating
  // between the halves [0, nh) and [nh, ntiles): 0, nh, 1, nh + 1, ...
  const int nh = (ntiles + 1) / 2;
  auto tile_of = [&](int i) {
    if constexpr (SCHED == SCHED_KCHUNK) return (i & 1) ? nh + (i >> 1) : (i >> 1);
    else return i;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2);   // one arrival per consumer warpgroup
      mbar_init(&v_empty[s], 2);
    }
    mbar_init_fence();
  }
  if constexpr (ONES) {
    if (threadIdx.x < 64) reinterpret_cast<uint32_t*>(ones)[threadIdx.x] = 0x3F803F80u;
    fence_async_smem();          // read by wgmma
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, W::Q_BYTES);
#pragma unroll
      for (int j = 0; j < QNSUB; ++j)
        tma_load_4d(Qs + j * W::BQ * QSW, &tp.q, q_full, j * QCOLS, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % ST;
        const uint32_t ph = (t / ST) & 1;
        const int k0 = tile_of(t) * BK;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_expect_tx(&k_full[s], W::K_BYTES);
#pragma unroll
        for (int j = 0; j < QNSUB; ++j)
          tma_load_4d(Ks + s * W::K_BYTES + j * BK * QSW, &tp.k, &k_full[s], j * QCOLS, k0, h, b);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], W::V_BYTES);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          tma_load_4d(Vs + s * W::V_BYTES + j * BK * SW, &tp.v, &v_full[s], j * COLS, k0, h, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 64 ----
  regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // accumulator row, column pair
  const bool leader = tid == 0;                  // arrives for the warpgroup
  float sl2;                                     // the score scale * log2(e)
  if constexpr (QK8) sl2 = p.scales[0] * p.scales[1] * 1.4426950408889634f;
  else if constexpr (EXP2) sl2 = p.s_scale;      // scores already in the log2 domain
  else sl2 = p.s_scale * 1.4426950408889634f;

  mbar_wait(q_full, 0);
  if (!QK8 && p.q_scale != 1.f) {  // q * q_scale, rounded to bf16 per element, in place
    const __nv_bfloat162 s2 = __float2bfloat162_rn(p.q_scale);
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      uint4* rows = reinterpret_cast<uint4*>(Qs + j * W::BQ * SW + wg * 64 * SW);
      for (int i = tid; i < 64 * SW / 16; i += 128) {
        uint4 v = rows[i];
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
        x[0] = __hmul2(x[0], s2); x[1] = __hmul2(x[1], s2);
        x[2] = __hmul2(x[2], s2); x[3] = __hmul2(x[3], s2);
        rows[i] = v;
      }
    }
    fence_async_smem();          // the scaled tile is read by wgmma
    named_sync(3 + wg, 128);
  }

  // Descriptors: Q (A) and K (B) K-major, V (B) MN-major; k step kk of QK
  // is 32 bytes of a row (16 bf16 or 32 int8 columns), of PV 16 keys (16
  // rows of the V tile). The ones tile (B of the denominator's product) is
  // K-major, 8 rows of 32 bytes: one 32-byte-swizzle atom, every element 1.
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * QSW;
  const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
  auto qk_off = [](int kk) { return (kk * 32 / QSW) * 128 * QSW + kk * 32 % QSW; };

  float s[BK / 2];                 // scores / probabilities, 64 x 128 (16 blocks of 8 keys)
  uint32_t si[QK8 ? BK / 2 : 1];   // QK8: the int32 scores while their group runs
  uint32_t pa[BK / 16][4];         // the previous tile's probabilities, bf16 A fragments
  // Per chain: the output (64 x DT), ONES: the denominator's accumulator
  // (64 x 8, every column the row's sum), the row max and (FP32) this
  // lane's part of the row sum, both in the log2 domain.
  float o[CH][NSUB][COLS / 2];
  float dn[CH][ONES ? 4 : 1];
  float m[CH][2], l[CH][2];
  float alpha[2];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < COLS / 2; ++i) o[c][j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (ONES ? 4 : 1); ++i) dn[c][i] = 0.f;
    m[c][0] = m[c][1] = -INFINITY;
    l[c][0] = l[c][1] = 0.f;
  }
  constexpr Chain<0> C0{};
  constexpr Chain<1> C1{};

  auto issue_qk = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < DT * (QK8 ? 1 : 2) / 32; ++kk) {
      const uint64_t da = make_desc(q_addr + qk_off(kk), QSW, 8 * QSW, 8 * QSW);
      const uint64_t db = make_desc(k_addr + stage * W::K_BYTES + qk_off(kk), QSW, 8 * QSW,
                                    8 * QSW);
      if constexpr (QK8) {
        if (kk == 0) wgmma_ss_n128_s8<false>(si, da, db);
        else wgmma_ss_n128_s8<true>(si, da, db);
      } else {
        wgmma_ss_n128<0, 0>(s, da, db, kk > 0);
      }
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int stage, auto chain) {
    constexpr int c = decltype(chain)::value;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        wgmma_rs<COLS, 1>(o[c][j], pa[kk],
                          make_desc(v_addr + stage * W::V_BYTES + j * BK * SW + kk * 16 * SW,
                                    SW, 8 * SW, 8 * SW), 1);
      if constexpr (ONES) wgmma_rs<8, 0>(dn[c], pa[kk], make_desc(smem_u32(ones), 32, 256, 256), 1);
    }
    wgmma_commit();
  };
  // The QK accumulator, pinned around its asynchronous products.
  auto fence_acc = [&]() {
    if constexpr (QK8) fence_regs(si);
    else fence_regs(s);
  };
  // QK8: the waited-for int32 scores into s, exactly (|s| < 2^24).
  auto int_scores = [&]() {
    if constexpr (QK8) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = static_cast<float>(static_cast<int>(si[i]));
    }
  };
  auto fence_o_pa = [&](auto chain) {
    constexpr int c = decltype(chain)::value;
    fence_regs(o[c][0]);
    if constexpr (NSUB > 1) fence_regs(o[c][1]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    if constexpr (ONES) fence_regs(dn[c]);
  };
  // Online softmax of key tile t into chain c. Only the last tile has keys
  // past S; they are -inf. Key t*BK < S always, so the new row max is
  // finite. The row max is taken on the raw scores (s_scale > 0 commutes
  // with it) and the scale folded into the exponent: p = exp2(s * s_scale *
  // log2(e) - m) (EXP2: p = exp2(s * s_scale - m)). Leaves the
  // probabilities in s and the accumulator's rescale in alpha.
  auto softmax = [&](int t, auto chain) {
    constexpr int c = decltype(chain)::value;
    if ((t + 1) * BK > S) {
      const int k0 = t * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + c2 + (e & 1) >= S) s[4 * n + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    float neg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[c][i], quad_max(mx[i]) * sl2);
      alpha[i] = fast_exp2(m[c][i] - mn);  // exp2(-inf) = 0 on the first tile
      m[c][i] = mn;
      if constexpr (!ONES) l[c][i] *= alpha[i];
      neg[i] = -mn;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * n + e] = fast_exp2(fmaf(s[4 * n + e], sl2, neg[e >> 1]));
        if constexpr (!ONES) l[c][e >> 1] += s[4 * n + e];  // this lane's part of the row sum
      }
    }
  };
  // The probabilities of key blocks 2kk, 2kk + 1 are the A fragment of
  // PV's k step kk; rounded to bf16 here, which is what ONES sums.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  // Chain c's output (and ONES denominator) rescaled to its new row max.
  auto rescale = [&](auto chain) {
    constexpr int c = decltype(chain)::value;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < COLS / 2; ++i) o[c][j][i] *= alpha[(i >> 1) & 1];
    if constexpr (ONES) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dn[c][i] *= alpha[i >> 1];
    }
  };

  // Consumer 1 lets consumer 0 take the tensor cores first; each then
  // hands them over once its products of a tile are issued.
  if (wg == 1) named_arrive(1, 256);

  if constexpr (SCHED == SCHED_BASE) {
    // Each tile in order, a wait after each product: QK(t), softmax(t),
    // PV(t), each product on its own turn of the ping-pong.
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % ST;
      const uint32_t ph = (t / ST) & 1;
      mbar_wait(&k_full[st], ph);
      named_sync(1 + wg, 256);
      fence_acc();
      wgmma_fence();
      issue_qk(st);
      named_arrive(2 - wg, 256);     // the other's turn (its QK or PV)
      wgmma_wait<0>();
      fence_acc();
      if (leader) mbar_arrive(&k_empty[st]);
      int_scores();
      softmax(t, C0);
      rescale(C0);                   // PV of t - 1 is done
      pack_p();
      mbar_wait(&v_full[st], ph);
      named_sync(1 + wg, 256);
      fence_o_pa(C0);
      wgmma_fence();
      issue_pv(st, C0);
      if (wg == 0 || t + 1 < ntiles) named_arrive(2 - wg, 256);
      wgmma_wait<0>();
      fence_o_pa(C0);
      if (leader) mbar_arrive(&v_empty[st]);
    }
  } else {
    // Tile 0: QK alone.
    mbar_wait(&k_full[0], 0);
    named_sync(1 + wg, 256);
    fence_acc();
    wgmma_fence();
    issue_qk(0);
    if (wg == 0 || ntiles > 1) named_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_acc();
    if (leader) mbar_arrive(&k_empty[0]);
    int_scores();
    softmax(0, C0);
    pack_p();

    if constexpr (SCHED == SCHED_STAGGER) {
      // Tile t: QK of t and PV of t - 1 in flight together; t's softmax
      // runs while PV does.
      for (int t = 1; t < ntiles; ++t) {
        const int s_k = t % ST, s_v = (t - 1) % ST;
        mbar_wait(&k_full[s_k], (t / ST) & 1);
        mbar_wait(&v_full[s_v], ((t - 1) / ST) & 1);
        named_sync(1 + wg, 256);       // this consumer's turn
        fence_acc();
        fence_o_pa(C0);
        wgmma_fence();
        issue_qk(s_k);
        issue_pv(s_v, C0);
        if (wg == 0 || t + 1 < ntiles) named_arrive(2 - wg, 256);   // the other's turn
        wgmma_wait<1>();               // QK done, PV may run on
        fence_acc();
        if (leader) mbar_arrive(&k_empty[s_k]);
        int_scores();
        softmax(t, C0);
        wgmma_wait<0>();               // PV of t - 1 done: free its V stage, rescale
        fence_o_pa(C0);
        if (leader) mbar_arrive(&v_empty[s_v]);
        rescale(C0);
        pack_p();
      }

      // The last tile's PV.
      {
        const int s_v = (ntiles - 1) % ST;
        mbar_wait(&v_full[s_v], ((ntiles - 1) / ST) & 1);
        fence_o_pa(C0);
        wgmma_fence();
        issue_pv(s_v, C0);
        wgmma_wait<0>();
        fence_o_pa(C0);
      }
    } else {
      // kchunk, step i (key tile tile_of(i), chain i & 1): QK of i and PV
      // of i - 1 (the other chain) in flight together. Chain c's output
      // was last written by PV of i - 2, done, so its rescale does not
      // wait for PV of i - 1; only the A fragments, which the two chains
      // share, do.
      auto step = [&](int i, auto chain, auto other) {
        const int s_k = i % ST, s_v = (i - 1) % ST;
        mbar_wait(&k_full[s_k], (i / ST) & 1);
        mbar_wait(&v_full[s_v], ((i - 1) / ST) & 1);
        named_sync(1 + wg, 256);
        fence_acc();
        fence_o_pa(other);
        wgmma_fence();
        issue_qk(s_k);
        issue_pv(s_v, other);
        if (wg == 0 || i + 1 < ntiles) named_arrive(2 - wg, 256);
        wgmma_wait<1>();               // QK of i done, PV of i - 1 runs on
        fence_acc();
        if (leader) mbar_arrive(&k_empty[s_k]);
        int_scores();
        softmax(tile_of(i), chain);
        rescale(chain);
        wgmma_wait<0>();               // PV of i - 1 done: free its V stage and A fragments
        fence_o_pa(other);
        if (leader) mbar_arrive(&v_empty[s_v]);
        pack_p();
      };
      // Steps in pairs (chain 1, then chain 0: compile-time tags); an even
      // tile count leaves one step of chain 1 after the loop.
      int i = 1;
      for (; i + 1 < ntiles; i += 2) {
        step(i, C1, C0);
        step(i + 1, C0, C1);
      }
      auto last_pv = [&](auto chain) {
        const int s_v = (ntiles - 1) % ST;
        mbar_wait(&v_full[s_v], ((ntiles - 1) / ST) & 1);
        fence_o_pa(chain);
        wgmma_fence();
        issue_pv(s_v, chain);
        wgmma_wait<0>();
        fence_o_pa(chain);
      };
      if (i < ntiles) {            // an even tile count: the last step is chain 1's
        step(i, C1, C0);
        last_pv(C1);
      } else {
        last_pv(C0);
      }
      // Merge chain 1 into chain 0 at their common row max (chain 1 is
      // empty, m = -inf, when there is one key tile).
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mm = fmaxf(m[0][i], m[1][i]);
        const float fa = fast_exp2(m[0][i] - mm), fb = fast_exp2(m[1][i] - mm);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int n = 0; n < COLS / 8; ++n) {
            o[0][j][4 * n + 2 * i] = o[0][j][4 * n + 2 * i] * fa + o[1][j][4 * n + 2 * i] * fb;
            o[0][j][4 * n + 2 * i + 1] =
                o[0][j][4 * n + 2 * i + 1] * fa + o[1][j][4 * n + 2 * i + 1] * fb;
          }
        if constexpr (ONES) {
          dn[0][2 * i] = dn[0][2 * i] * fa + dn[1][2 * i] * fb;
          dn[0][2 * i + 1] = dn[0][2 * i + 1] * fa + dn[1][2 * i + 1] * fb;
        } else {
          l[0][i] = l[0][i] * fa + l[1][i] * fb;
        }
      }
    }
  }

  // Every lane shuffles before any lane skips a row past S.
  float inv[2];
  if constexpr (ONES) {
    inv[0] = 1.f / fmaxf(dn[0][0], 1e-30f);
    inv[1] = 1.f / fmaxf(dn[0][2], 1e-30f);
  } else {
    inv[0] = 1.f / fmaxf(quad_sum(l[0][0]), 1e-30f);
    inv[1] = 1.f / fmaxf(quad_sum(l[0][1]), 1e-30f);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + c2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wg * 64 + warp * 16 + g + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = ob + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int n = 0; n < COLS / 8; ++n)
        if (j * COLS + n * 8 < D)
          *reinterpret_cast<uint32_t*>(orow + j * COLS + n * 8) =
              pack_bf16(o[0][j][4 * n + 2 * i] * inv[i], o[0][j][4 * n + 2 * i + 1] * inv[i]);
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
template <bool EXP2>
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
    if constexpr (EXP2) {   // scores in the log2 domain
      s0[i] = exp2f(a - mn);
      s1[i] = exp2f(b - mn);
      alpha[i] = exp2f(m[i] - mn);
    } else {
      s0[i] = expf(a - mn);
      s1[i] = expf(b - mn);
      alpha[i] = expf(m[i] - mn);  // exp(-inf) = 0 on the first tile
    }
    l[i] = l[i] * alpha[i] + warp_sum(s0[i] + s1[i]);
    m[i] = mn;
  }
}

template <int DT, bool EXP2 = false>
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
    online_softmax<EXP2>(s0, s1, m, l, alpha, k0, S, p.s_scale);
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

// The bf16 body's launch: grid (query tiles, H, B). Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue if
// cuTensorMapEncodeTiled refuses a tensor map); does not synchronise.
template <int DT, bool QK8 = false, int DENOM = DENOM_FP32, int SCHED = SCHED_STAGGER,
          bool EXP2 = false>
int launch_bf16(const Params& p, int B, int H, cudaStream_t st) {
  using W = Wg<DT, QK8>;
  TmaParams tp;
  tp.p = p;
  const void* ptrs[3] = {p.q, p.k, p.v};
  const long long strides[3][3] = {{p.q_ss, p.q_sh, p.q_sb}, {p.k_ss, p.k_sh, p.k_sb},
                                   {p.v_ss, p.v_sh, p.v_sb}};
  CUtensorMap* maps[3] = {&tp.q, &tp.k, &tp.v};
  const uint64_t dims[4] = {(uint64_t)p.D, (uint64_t)p.S, (uint64_t)H, (uint64_t)B};
  const uint32_t box[4] = {(uint32_t)W::COLS, 128u, 1u, 1u};
  const uint32_t qk_box[4] = {(uint32_t)W::QK_COLS, 128u, 1u, 1u};
  for (int i = 0; i < 3; ++i) {
    const int64_t str[3] = {strides[i][0], strides[i][1], strides[i][2]};
    const bool i8 = QK8 && i < 2;   // int8 q and k: bytes as UINT8
    if (!hopper::make_map(maps[i], ptrs[i], 4, dims, str, i8 ? qk_box : box,
                          i8 ? W::QK_SW : W::SW,
                          i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          i8 ? 1 : 2))
      return (int)cudaErrorInvalidValue;
  }
  // DENOM_ONES: the ones tile 256 bytes past the barriers.
  const size_t smem = W::SMEM + (DENOM == DENOM_ONES ? 512 : 0);
  auto kernel = attention_bf16<DT, QK8, DENOM, SCHED, EXP2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + W::BQ - 1) / W::BQ, H, B);
  kernel<<<grid, W::THREADS, smem, st>>>(tp);
  return (int)cudaGetLastError();
}

// dtype: 0 = fp32, 1 = bf16 (QK8: bf16 v only; q and k int8). DENOM and
// SCHED select the bf16 body's instance (the fp32 kernel sums fp32
// probabilities, which are their own rounding, and has one order); EXP2
// takes s_scale as a log2-domain scale in both. Returns the cudaError_t of
// the launch; does not synchronise.
template <int DT, bool QK8 = false, int DENOM = DENOM_FP32, int SCHED = SCHED_STAGGER,
          bool EXP2 = false>
int launch(int dtype, const Params& p, int B, int H, cudaStream_t st) {
  if (dtype == 1) return launch_bf16<DT, QK8, DENOM, SCHED, EXP2>(p, B, H, st);
  if constexpr (!QK8) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(attention_f32<DT, EXP2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Tile<DT>::SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.S + BQ - 1) / BQ, H, B);
    attention_f32<DT, EXP2><<<grid, THREADS, Tile<DT>::SMEM_F32, st>>>(p);
    return (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace vda
