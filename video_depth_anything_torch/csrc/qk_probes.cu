// DCE-proof QK probes of the spatial attention kernel K1, for Hopper
// (sm_90a).
//
// Replaces: tools/bench_kernel_ab.py probes (T3; bodies _qk64_probe,
//   _qk128_probe). (T1's phase probes, once here, are phase_probes.cu.)
// Computes, per step (one grid row of the TPU tool), bf16 in, fp32
// accumulation: q, k [M, 128] and [N, 128]; heads = 2 splits the 128
// columns into two 64-deep contractions s_h = q_h k_h^T, heads = 1 is one
// 128-deep s; o[:, j] = sum_h sum_t s_h[:, 128 t + j] in fp32: every score
// column feeds the output.
//
// Bound on this card, at the tool's shape (64 steps of 1408 x 1408 keys):
// 32.5 GFLOP, 0.033 ms of bf16 tensor-core time against 92 MB of bytes,
// 0.027 ms.
//
// Design: the attention body's first design, on mma.sync. Each block owns 64 query rows of
// one step; each of the 4 warps 16 rows end to end. Key tiles of 64 x 128
// stream through shared memory, double buffered with cp.async; products are
// mma.sync m16n8k16 with ldmatrix operands and the scores in registers,
// 64 products per key tile and warp (8 key blocks x 8 k-steps); the
// column-group sums are the epilogue.
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
constexpr int TILE_W = BQ * LDW;

// side and sink are not read here: they keep the parameter offsets of the
// kernel that once also ran T1's probes, so that T3's instructions stay as
// they were until its own redesign.
struct QKParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  float* o;       // [steps, M, 128]
  float* side;
  float* sink;
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

template <int HEADS>
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

  load_rows(Qs, LDW, p.q + ((long long)step * p.M + q0) * W, W, W);
  load_rows(Ks, LDW, kb, W, W);
  cp_async_commit();

  uint32_t qf[W / 16][4];
  float acc[W / 8][4];              // output columns 0..127
  float s[BK / 8][4];               // one head's scores [16 rows, 64 keys]
#pragma unroll
  for (int n = 0; n < W / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      load_rows(Ks + (buf ^ 1) * TILE_W, LDW, kb + (long long)(i + 1) * BK * W, W, W);
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

#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
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
      add_scores(acc, s, i & 1);
    }
    __syncthreads();
  }

  const long long row0 = (long long)step * p.M + q0 + r0 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      *reinterpret_cast<float2*>(p.o + (row0 + 8 * r) * W + n * 8 + c2) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

template <int HEADS>
int launch_qk(const QKParams& p, int steps, cudaStream_t st) {
  constexpr size_t smem = 3 * TILE_W * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(qk_probe<HEADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  qk_probe<HEADS><<<dim3(p.M / BQ, steps), THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// heads: 2 = qk64 (two 64-deep heads), 1 = qk128. q [steps, M, 128], k
// [steps, N, 128] contiguous bf16; M % 64 == 0, N % 128 == 0; o [steps, M,
// 128] fp32. Returns the cudaError_t of the launch (0 on success); does
// not synchronise.
extern "C" int vda_qk_probe(int heads, const void* q, const void* k, float* o, int steps, int M,
                            int N, void* stream) {
  const QKParams p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                   o, nullptr, nullptr, M, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (heads) {
    case 2: return launch_qk<2>(p, steps, st);
    case 1: return launch_qk<1>(p, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
