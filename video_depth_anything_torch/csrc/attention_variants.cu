// The spatial attention function of K1 under three schedules, for Hopper
// (sm_90a): the schedule variants of the phase bench.
//
// Replaces: tools/bench_kernel_phases.py variant_attention (T2; Pallas
//   body _variant_kernel), schedules base, stagger and kchunk.
// Computes, per (batch, head) of q, k, v contiguous bf16 [B, S, H*64]:
//   q' = q * q_scale rounded to bf16 (q_scale = bf16(64^-0.5), exact);
//   s = q' k^T in fp32; m = the row max over the S valid keys;
//   p = bf16(exp(s - m)); o = (p v) / max(sum p, 1e-30), where the
//   denominator sums the bf16-rounded p (the tool's ones column) and the
//   numerator accumulates in fp32. The TPU tool pads the keys to 1408 and
//   its row max includes the padded zero scores; in fp32 the result is the
//   same.
//
// Bound on this card: operations. At [32, 1370, 1024], H = 16: 4*B*H*S^2*64
// = 246 GFLOP, 0.2487 ms at 989 TFLOP/s, against 360 MB of bytes (0.107
// ms); the B*H*S^2 = 9.6e8 exponentials take about as long again on the
// special-function units (0.230 ms at 4.18e12 per second: 16 ex2 per SM and
// clock at 1.98 GHz).
//
// Design: K1's body (csrc/attention_flash.cuh), rewritten so that the order
// of the three phases of one warp's 16 query rows is a template parameter:
// each block owns (64 query rows, head, batch), each of 4 warps 16 rows;
// 64-key K / V tiles stream through shared memory with cp.async; both
// products run on mma.sync m16n8k16 with the scores, the probabilities
// (packed to bf16 once, summed from the packed values) and the output in
// registers; online softmax in the log2 domain.
//   base:    per key tile: QK, softmax, PV (K1's order).
//   stagger: software-pipelined: the QK of tile t + 1 is issued before the
//            softmax of tile t and its PV after it, so two score tiles are
//            live and the exponentials of one tile can overlap the tensor-
//            core work of the next (FlashAttention-3's overlap on mma.sync).
//   kchunk:  the keys split in two halves; each warp carries both halves'
//            online-softmax chains interleaved (two independent chains of
//            products and exponentials) and merges (m, l, acc) at the end.
// base and stagger use a 3-deep ring of K / V tiles (tile t + 2 loads while
// t computes, so stagger finds tile t + 1 resident); kchunk a 2-deep ring of
// tile pairs (j, half + j).
// Not yet: wgmma, TMA.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vda;

constexpr int DH = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RW = BQ / WARPS;
constexpr int LDB = DH + 8;       // bf16 tile pitch (elements)
constexpr int TILE = BQ * LDB;
constexpr float LOG2E = 1.4426950408889634f;

enum { BASE = 0, STAGGER = 1, KCHUNK = 2 };

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int S, H;
  float q_scale;
};

// One warp's online-softmax state for its 16 rows (rows g and g + 8).
struct Chain {
  float acc[DH / 8][4];
  float m[2], l[2];
};

__device__ __forceinline__ void init(Chain& c) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) c.acc[n][0] = c.acc[n][1] = c.acc[n][2] = c.acc[n][3] = 0.f;
  c.m[0] = c.m[1] = -INFINITY;
  c.l[0] = c.l[1] = 0.f;
}

// Rows [r0, r0 + 64) x 64 columns of a row-strided matrix into a tile;
// rows past S are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < BQ * (DH / 8); idx += THREADS) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LDB + c, ok ? src + (long long)(r0 + r) * row_stride + c : src, ok);
  }
}

// Scores [16 rows, 64 keys] = Q K^T of one key tile.
__device__ __forceinline__ void qk(float (&s)[BK / 8][4], const uint32_t (&qf)[DH / 16][4],
                                   const __nv_bfloat16* Kt, int lane) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < DH / 32; ++kp) {
      uint32_t kf[4];
      ldsm_x4(kf, Kt + (n * 8 + (lane & 7)) * LDB + kp * 32 + (lane >> 3) * 8);
      mma_bf16(s[n], qf[2 * kp], kf[0], kf[1]);
      mma_bf16(s[n], qf[2 * kp + 1], kf[2], kf[3]);
    }
  }
}

__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Online softmax of one score tile (keys k0..k0+63; keys past S are -inf):
// the probabilities come out packed to bf16 as the A fragments of the PV
// product, and the running sum adds the packed (rounded) values.
__device__ __forceinline__ void softmax(float (&s)[BK / 8][4], uint32_t (&pa)[BK / 16][4],
                                        Chain& c, int k0, int S, int c2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = k0 + n * 8 + c2 + (e & 1) < S;
      s[n][e] = ok ? s[n][e] * LOG2E : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(c.m[i], quad_max(mx[i]));   // finite: key k0 < S
    alpha[i] = exp2f(c.m[i] - mn);
    c.m[i] = mn;
    c.l[i] *= alpha[i];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // A fragment register j of k-step kk: key block 2kk + (j >> 1), row
      // half j & 1 (rows g, g + 8).
      const int n = 2 * kk + (j >> 1), r = j & 1;
      const uint32_t u = pack_bf16(exp2f(s[n][2 * r] - c.m[r]), exp2f(s[n][2 * r + 1] - c.m[r]));
      pa[kk][j] = u;
      c.l[r] += lo_bf16(u) + hi_bf16(u);
    }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    c.acc[n][0] *= alpha[0]; c.acc[n][1] *= alpha[0];
    c.acc[n][2] *= alpha[1]; c.acc[n][3] *= alpha[1];
  }
}

// Output [16, 64] += P [16, 64 keys] V [64 keys, 64].
__device__ __forceinline__ void pv(const uint32_t (&pa)[BK / 16][4], Chain& c,
                                   const __nv_bfloat16* Vt, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * LDB + np * 16 + (lane >> 4) * 8);
      mma_bf16(c.acc[2 * np], pa[kk], vf[0], vf[1]);
      mma_bf16(c.acc[2 * np + 1], pa[kk], vf[2], vf[3]);
    }
}

template <int SCHED>
__global__ void __launch_bounds__(THREADS) attention_variant(const Params p) {
  constexpr int NT = SCHED == KCHUNK ? 2 : 1;     // key tiles per stage
  constexpr int RING = SCHED == KCHUNK ? 2 : 3;   // stages in flight
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ring = Qs + TILE;   // [RING][NT][K, V]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * RW, g = lane >> 2, c2 = (lane & 3) * 2;
  const int S = p.S;
  const long long C = (long long)p.H * DH;
  const long long off = (long long)b * S * C + (long long)h * DH;
  const __nv_bfloat16* kb = p.k + off;
  const __nv_bfloat16* vb = p.v + off;
  const int ntiles = (S + BK - 1) / BK;
  const int half = (ntiles + 1) / 2;                  // kchunk: chain B starts here
  const int nstages = SCHED == KCHUNK ? half : ntiles;

  auto kt = [&](int stage, int j) { return Ring + ((stage % RING) * NT + j) * 2 * TILE; };
  auto vt = [&](int stage, int j) { return kt(stage, j) + TILE; };
  auto load_stage = [&](int st) {   // key tiles of stage st (none past the end)
    if (st < nstages) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int t = st + j * half;
        if (t < ntiles) {
          load_tile(kt(st, j), kb, C, t * BK, S);
          load_tile(vt(st, j), vb, C, t * BK, S);
        }
      }
    }
    cp_async_commit();   // an empty group past the end keeps the counting uniform
  };

  load_tile(Qs, p.q + off, C, q0, S);
  load_stage(0);
  if (RING == 3) load_stage(1);

  uint32_t qf[DH / 16][4];
  Chain a;
  init(a);

  if constexpr (SCHED != KCHUNK) {
    float s[BK / 8][4], sn[BK / 8][4];
    uint32_t pa[BK / 16][4];
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<0>();   // tiles t and t + 1 are resident
      __syncthreads();      // ... for every warp; tile t - 1's stage is free
      load_stage(t + 2);
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          ldsm_x4(qf[kk], Qs + (r0 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
        if (p.q_scale != 1.f) {
          const __nv_bfloat162 s2 = __float2bfloat162_rn(p.q_scale);
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]);
              x = __hmul2(x, s2);
              qf[kk][i] = *reinterpret_cast<uint32_t*>(&x);
            }
        }
        if constexpr (SCHED == STAGGER) qk(s, qf, kt(0, 0), lane);
      }
      if constexpr (SCHED == BASE) {
        qk(s, qf, kt(t, 0), lane);
        softmax(s, pa, a, t * BK, S, c2);
        pv(pa, a, vt(t, 0), lane);
      } else {   // STAGGER: s holds tile t's scores on entry
        if (t + 1 < ntiles) qk(sn, qf, kt(t + 1, 0), lane);
        softmax(s, pa, a, t * BK, S, c2);
        pv(pa, a, vt(t, 0), lane);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = sn[n][e];
      }
    }
  } else {   // KCHUNK: chain a over tiles [0, half), chain bch over [half, ntiles)
    Chain bch;
    init(bch);
    float sa[BK / 8][4], sb[BK / 8][4];
    uint32_t pa[BK / 16][4], pb[BK / 16][4];
    for (int j = 0; j < half; ++j) {
      load_stage(j + 1);
      cp_async_wait<1>();
      __syncthreads();
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          ldsm_x4(qf[kk], Qs + (r0 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
        if (p.q_scale != 1.f) {
          const __nv_bfloat162 s2 = __float2bfloat162_rn(p.q_scale);
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&qf[kk][i]);
              x = __hmul2(x, s2);
              qf[kk][i] = *reinterpret_cast<uint32_t*>(&x);
            }
        }
      }
      const bool second = half + j < ntiles;
      qk(sa, qf, kt(j, 0), lane);
      if (second) qk(sb, qf, kt(j, 1), lane);
      softmax(sa, pa, a, j * BK, S, c2);
      if (second) softmax(sb, pb, bch, (half + j) * BK, S, c2);
      pv(pa, a, vt(j, 0), lane);
      if (second) pv(pb, bch, vt(j, 1), lane);
      __syncthreads();   // every warp is done with stage j before it refills
    }
    // Merge: chain b may be empty (m = -inf, l = acc = 0).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(a.m[i], bch.m[i]);
      const float fa = exp2f(a.m[i] - mn), fb = exp2f(bch.m[i] - mn);
      a.l[i] = a.l[i] * fa + bch.l[i] * fb;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        a.acc[n][2 * i] = a.acc[n][2 * i] * fa + bch.acc[n][2 * i] * fb;
        a.acc[n][2 * i + 1] = a.acc[n][2 * i + 1] * fa + bch.acc[n][2 * i + 1] * fb;
      }
    }
  }

  // Every lane shuffles before any lane skips a row past S.
  const float inv[2] = {1.f / fmaxf(quad_sum(a.l[0]), 1e-30f),
                        1.f / fmaxf(quad_sum(a.l[1]), 1e-30f)};
  __nv_bfloat16* ob = p.o + off + c2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + row * C + n * 8) =
          pack_bf16(a.acc[n][2 * i] * inv[i], a.acc[n][2 * i + 1] * inv[i]);
  }
}

template <int SCHED>
int launch(const Params& p, int B, cudaStream_t st) {
  constexpr int NT = SCHED == KCHUNK ? 2 : 1, RING = SCHED == KCHUNK ? 2 : 3;
  constexpr size_t smem = (1 + RING * NT * 2) * TILE * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attention_variant<SCHED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  attention_variant<SCHED><<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// schedule: 0 = base, 1 = stagger, 2 = kchunk. q, k, v and o contiguous bf16
// [B, S, H*64]. Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
extern "C" int vda_attention_variant(int schedule, const void* q, const void* k, const void* v,
                                     void* o, int B, int S, int H, float q_scale,
                                     void* stream) {
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H,
                 q_scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (schedule) {
    case BASE: return launch<BASE>(p, B, st);
    case STAGGER: return launch<STAGGER>(p, B, st);
    case KCHUNK: return launch<KCHUNK>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
