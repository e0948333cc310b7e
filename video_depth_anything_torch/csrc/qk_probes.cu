// Phase probes of the spatial attention kernel K1, for Hopper (sm_90a).
//
// Replaces: tools/bench_kernel_phases.py probes (T1; Pallas bodies
//   _qk_probe_kernel, _qk128_probe_kernel, _sm_probe_kernel,
//   _pv_probe_kernel) and tools/bench_kernel_ab.py probes (T3; bodies
//   _qk64_probe, _qk128_probe).
// Computes, per step (one grid row of the TPU tool), bf16 in, fp32
// accumulation:
//   q, k [M, 128] and [N, 128]; heads = 2 splits the 128 columns into two
//   64-deep contractions s_h = q_h k_h^T, heads = 1 is one 128-deep s.
//   FIRST128 (T1 qk64x2, qk128): o = bf16(sum_h s_h[:, :128]).
//   COLSUM   (T3 qk64, qk128):   o[:, j] = sum_h sum_t s_h[:, 128 t + j], fp32.
//   SOFTMAX  (T1 qk+sm x2):      o = bf16(sum_h bf16(exp(s_h - max s_h))[:, :128]),
//     and side[row] = sum_h sum_keys exp(s_h - max s_h) in fp32: every
//     exponential the probe computes feeds it, so none can be dropped.
//   PV (T1 pv128x2): p, p2 [M, N], v [N, 128]: o = bf16(p v + p2 v).
//
// Bound on this card, at the tool's shape (64 steps of 1408 x 1408 keys;
// PV 24 steps): the QK probes 32.5 GFLOP, 0.033 ms of bf16 tensor-core time
// against 69 MB (T3: 92 MB) of bytes, 0.021 to 0.027 ms; qk+sm adds 2.5e8
// exponentials, 0.061 ms on the special-function units (16 ex2 per SM and
// clock at 1.98 GHz); PV moves 190 MB of p and p2, 0.062 ms at 3.35 TB/s, against
// 0.025 ms of products: bytes-bound, unlike K1's PV, whose P never leaves
// registers.
//
// Design: K1's (csrc/attention_flash.cuh). Each block owns 64 query rows of
// one step; each of the 4 warps 16 rows end to end. Key tiles of 64 x 128
// stream through shared memory, double buffered with cp.async; products are
// mma.sync m16n8k16 with ldmatrix operands and the scores in registers.
// Both probe kinds issue the same 64 products per key tile and warp
// (8 key blocks x 8 k-steps); only the epilogue differs. mma_bf16 is asm
// volatile, which keeps the products in the PTX; ptxas works on the PTX and
// may still drop a product whose result nothing reads, so FIRST128 does
// not zero its score registers past key tile 1: they accumulate every
// later tile's products and are stored at the end if the caller passes a
// sink pointer (null in use). SOFTMAX keeps the running row max and sum
// (exp2 of log2(e)-scaled scores) and recomputes the scores of key tiles 0
// and 1 after the pass, against the final max (2 of the N/64 tiles extra).
// PV loads p, p2 and v tiles and runs 2 x 32 products per key tile and warp.
// Not yet: wgmma, TMA.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vda;

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int WARPS = 4;         // each warp owns 16 rows
constexpr int THREADS = WARPS * 32;
constexpr int RW = BQ / WARPS;
constexpr int W = 128;           // q / k / v / o row width
constexpr int LDW = W + 8;       // bf16 pitch of a 128-wide tile (elements)
constexpr int LDK = BK + 8;      // bf16 pitch of a 64-wide p tile
constexpr int TILE_W = BQ * LDW;
constexpr int TILE_P = BQ * LDK;
constexpr float LOG2E = 1.4426950408889634f;

enum { FIRST128 = 0, COLSUM = 1, SOFTMAX = 2 };

struct QKParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  void* o;        // [steps, M, 128]: bf16 (FIRST128, SOFTMAX) or fp32 (COLSUM)
  float* side;    // SOFTMAX: [steps, M]
  float* sink;    // FIRST128: null in use (see the note above)
  int M, N;
};

// rows x cols (cols % 8 == 0) of a bf16 matrix with row pitch ld_src into a
// tile of pitch ld_dst, asynchronously. Every probe shape is a multiple of
// 64 rows: no edge.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld_dst,
                                          const __nv_bfloat16* src, long long ld_src,
                                          int cols) {
  const int chunks = cols / 8;
  for (int idx = threadIdx.x; idx < BQ * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    cp_async16(dst + r * ld_dst + c, src + r * ld_src + c, true);
  }
}

// acc[0..7] (upper false) or acc[8..15] (upper true) += s; the register
// arrays are indexed by constants only, so they stay in registers.
__device__ __forceinline__ void add_scores(float (&acc)[W / 8][4], const float (&s)[BK / 8][4],
                                           bool upper) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (upper) acc[BK / 8 + n][e] += s[n][e];
      else acc[n][e] += s[n][e];
    }
}

template <int HEADS, int EPI>
__global__ void __launch_bounds__(THREADS) qk_probe(const QKParams p) {
  constexpr int DH = W / HEADS;   // contraction depth of one score tile
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + TILE_W;   // [2][TILE_W]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RW, g = lane >> 2, c2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * BQ, step = blockIdx.y;
  const __nv_bfloat16* kb = p.k + (long long)step * p.N * W;
  const int ntiles = p.N / BK;
  // SOFTMAX runs the pass, then key tiles 0 and 1 again.
  const int iters = EPI == SOFTMAX ? ntiles + 2 : ntiles;

  load_rows(Qs, LDW, p.q + ((long long)step * p.M + q0) * W, W, W);
  load_rows(Ks, LDW, kb, W, W);
  cp_async_commit();

  uint32_t qf[W / 16][4];
  float acc[W / 8][4];              // output columns 0..127
  float s[BK / 8][4];               // one head's scores [16 rows, 64 keys]
  float m[HEADS][2], l[HEADS][2];   // SOFTMAX: running max (log2 domain), sum
#pragma unroll
  for (int n = 0; n < W / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    m[h][0] = m[h][1] = -INFINITY;
    l[h][0] = l[h][1] = 0.f;
  }

  for (int i = 0; i < iters; ++i) {
    const int buf = i & 1;
    if (i + 1 < iters) {
      const int nt = i + 1 < ntiles ? i + 1 : i + 1 - ntiles;
      load_rows(Ks + (buf ^ 1) * TILE_W, LDW, kb + (long long)nt * BK * W, W, W);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (r0 + (lane & 15)) * LDW + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + buf * TILE_W;
    const int kt = i < ntiles ? i : i - ntiles;
    const bool recompute = i >= ntiles;

#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      if (EPI != FIRST128 || kt < 2) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int kp = 0; kp < DH / 32; ++kp) {
          uint32_t kf[4];
          ldsm_x4(kf, Kt + (n * 8 + (lane & 7)) * LDW + h * DH + kp * 32 + (lane >> 3) * 8);
          mma_bf16(s[n], qf[h * (DH / 16) + 2 * kp], kf[0], kf[1]);
          mma_bf16(s[n], qf[h * (DH / 16) + 2 * kp + 1], kf[2], kf[3]);
        }
      }
      if constexpr (EPI == FIRST128) {
        if (kt < 2) add_scores(acc, s, kt == 1);
      } else if constexpr (EPI == COLSUM) {
        add_scores(acc, s, kt & 1);
      } else {  // SOFTMAX (HEADS == 2)
        if (!recompute) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[n][e] *= LOG2E;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[h][r], quad_max(mx[r]));
            l[h][r] *= exp2f(m[h][r] - mn);   // exp2(-inf) = 0 on the first tile
            m[h][r] = mn;
          }
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) l[h][e >> 1] += exp2f(s[n][e] - m[h][e >> 1]);
        } else {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = __bfloat162float(
                  __float2bfloat16_rn(exp2f(s[n][e] * LOG2E - m[h][e >> 1])));
          add_scores(acc, s, kt == 1);
        }
      }
    }
    __syncthreads();
  }

  const long long row0 = (long long)step * p.M + q0 + r0 + g;
  if constexpr (EPI == COLSUM) {
    float* ob = static_cast<float*>(p.o);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < W / 8; ++n)
        *reinterpret_cast<float2*>(ob + (row0 + 8 * r) * W + n * 8 + c2) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  } else {
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < W / 8; ++n)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8 * r) * W + n * 8 + c2) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
  if constexpr (EPI == SOFTMAX) {
    // Every lane shuffles; one lane of each quad stores its row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[0][r]) + quad_sum(l[1][r]);
      if ((lane & 3) == 0) p.side[row0 + 8 * r] = sum;
    }
  }
  if constexpr (EPI == FIRST128) {
    if (p.sink != nullptr) {
      float x = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) x += s[n][0] + s[n][1] + s[n][2] + s[n][3];
      p.sink[(row0 - g) * 32 + lane] = x;
    }
  }
}

// o = bf16(p v + p2 v): p, p2 [M, N], v [N, 128] per step.
__global__ void __launch_bounds__(THREADS) pv_probe(const __nv_bfloat16* pp,
                                                    const __nv_bfloat16* pp2,
                                                    const __nv_bfloat16* vv,
                                                    __nv_bfloat16* o, int M, int N) {
  constexpr int STAGE = 2 * TILE_P + TILE_W;   // p, p2, v tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * RW, g = lane >> 2, c2 = (lane & 3) * 2;
  const int q0 = blockIdx.x * BQ, step = blockIdx.y;
  const __nv_bfloat16* pb[2] = {pp + ((long long)step * M + q0) * N,
                                pp2 + ((long long)step * M + q0) * N};
  const __nv_bfloat16* vb = vv + (long long)step * N * W;
  const int ntiles = N / BK;

  auto load = [&](int t, int buf) {
    __nv_bfloat16* st = base + buf * STAGE;
    load_rows(st, LDK, pb[0] + t * BK, N, BK);
    load_rows(st + TILE_P, LDK, pb[1] + t * BK, N, BK);
    load_rows(st + 2 * TILE_P, LDW, vb + (long long)t * BK * W, W, W);
    cp_async_commit();
  };
  load(0, 0);

  float acc[W / 8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* st = base + buf * STAGE;
    const __nv_bfloat16* Vt = st + 2 * TILE_P;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const __nv_bfloat16* Pt = st + which * TILE_P;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        ldsm_x4(pa, Pt + (r0 + (lane & 15)) * LDK + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < W / 16; ++np) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * LDW + np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = o + ((long long)step * M + q0 + r0 + g) * W + c2;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + 8 * r * W + n * 8) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
}

template <int HEADS, int EPI>
int launch_qk(const QKParams& p, int steps, cudaStream_t st) {
  constexpr size_t smem = 3 * TILE_W * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(qk_probe<HEADS, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  qk_probe<HEADS, EPI><<<dim3(p.M / BQ, steps), THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// probe: 0 = T1 qk64x2, 1 = T1 qk128, 2 = T1 qk+sm x2, 3 = T3 qk64 (two
// heads), 4 = T3 qk128. q [steps, M, 128], k [steps, N, 128] contiguous
// bf16; M % 64 == 0, N % 128 == 0. o [steps, M, 128]: fp32 for T3, bf16
// otherwise; side [steps, M] fp32 for probe 2 (else unused); sink null.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int vda_qk_probe(int probe, const void* q, const void* k, void* o, float* side,
                            float* sink, int steps, int M, int N, void* stream) {
  const QKParams p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                   o, side, sink, M, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case 0: return launch_qk<2, FIRST128>(p, steps, st);
    case 1: return launch_qk<1, FIRST128>(p, steps, st);
    case 2: return launch_qk<2, SOFTMAX>(p, steps, st);
    case 3: return launch_qk<2, COLSUM>(p, steps, st);
    case 4: return launch_qk<1, COLSUM>(p, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// T1 pv128x2: p, p2 [steps, M, N], v [steps, N, 128], o [steps, M, 128],
// all contiguous bf16; M % 64 == 0, N % 64 == 0.
extern "C" int vda_pv_probe(const void* p, const void* p2, const void* v, void* o, int steps,
                            int M, int N, void* stream) {
  constexpr size_t smem = 2 * (2 * TILE_P + TILE_W) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(pv_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  pv_probe<<<dim3(M / BQ, steps), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(p2),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), M, N);
  return (int)cudaGetLastError();
}
