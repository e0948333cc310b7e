// Phase probes of the spatial attention body, for Hopper (sm_90a): K1's
// phases alone, on the body's wgmma + TMA machinery.
//
// Replaces: tools/bench_kernel_phases.py probes (T1; Pallas bodies
//   _qk_probe_kernel, _qk128_probe_kernel, _sm_probe_kernel,
//   _pv_probe_kernel).
// Computes, per step (one grid row of the TPU tool), bf16 in, fp32
// accumulation:
//   q, k [M, 128] and [N, 128]; heads = 2 splits the 128 columns into two
//   64-deep contractions s_h = q_h k_h^T, heads = 1 is one 128-deep s.
//   FIRST128 (qk64x2, qk128): o = bf16(sum_h s_h[:, :128]).
//   SOFTMAX  (qk+sm x2):      o = bf16(sum_h bf16(exp(s_h - max s_h))[:, :128]),
//     and side[row] = sum_h sum_keys exp(s_h - max s_h) in fp32: every
//     exponential the probe computes feeds it, so none can be dropped.
//   PV (pv128x2): p, p2 [M, N], v [N, 128]: o = bf16(p v + p2 v).
//
// Bound on this card, at the tool's shape (64 steps of 1408 x 1408 keys;
// PV 24 steps): the QK probes 32.5 GFLOP, 0.033 ms of bf16 tensor-core time
// against 69 MB of bytes (0.021 ms); qk+sm adds 2.5e8 exponentials, 0.061
// ms on the special-function units (16 ex2 per SM and clock at 1.98 GHz);
// PV moves 190 MB of p and p2, 0.062 ms at 3.35 TB/s, against 0.025 ms of
// products: bytes-bound, unlike K1's PV, whose P never leaves registers.
//
// Design: the attention body's (attention_flash.cuh). A block owns 128
// query rows of one step and runs three warpgroups; a producer thread
// TMA-loads the Q rows once (two 64-column sub-tiles, 128-byte swizzle)
// and streams 128-key K tiles of width 128 through a 4-stage ring of full /
// empty mbarriers. Each consumer warpgroup owns 64 rows and issues QK as
// wgmma m64n128k16 with both operands K-major from shared memory: qk64x2
// two 64-deep chains (one accumulator each), qk128 one 128-deep chain;
// each tile's products are issued before the previous tile's are waited
// for. qk+sm issues its two heads as two commit groups and runs the
// first head's online softmax (running row max and sum, exp2 of
// log2(e)-scaled scores) while the second head's products run, then
// recomputes key tile 0 once after the pass for the output against the
// final max (1 of the N/128 tiles extra). PV streams 64-key tiles of p, p2
// (A, K-major) and v (B, MN-major through the descriptor's transpose bit)
// into a 4-stage ring and accumulates p v + p2 v in one 64 x 128 fp32
// accumulator per warpgroup. DCE guards: wgmma is asm volatile, and ptxas
// may still drop a product whose result nothing reads; so FIRST128's
// accumulators keep collecting every later key tile (scale-d = 1 past
// tile 0, whose sum is stored), and are summed into the optional sink
// pointer at the end (null in use); SOFTMAX's side sum consumes every
// exponential.

#include <math.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace vda;
using namespace vda::hopper;

constexpr int W = 128;               // q / k / v / o row width
constexpr int BQ = 128;              // query rows per block, 64 per consumer
constexpr int BK = 128;              // keys per QK tile
constexpr int SUB = 128 * 128;       // bytes of 128 rows x 64 bf16 (one 128-byte-swizzled sub-tile)
constexpr int QK_ST = 4;             // K ring depth (tiles of 2 sub-tiles)
constexpr int PV_BK = 64;            // keys per PV tile
constexpr int PV_ST = 4;             // PV ring depth
constexpr int P_BYTES = BQ * PV_BK * 2;          // one p tile, 128 rows x 64 keys
constexpr int V_SUB = PV_BK * 64 * 2;            // 64 keys x 64 columns of v
constexpr int PV_STAGE = 2 * P_BYTES + 2 * V_SUB;
constexpr int THREADS = 384;         // consumers 0, 1; producer 2
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t QK_SMEM = 1024 + 2 * SUB + QK_ST * 2 * SUB + 8 * (1 + 2 * QK_ST);
constexpr size_t PV_SMEM = 1024 + PV_ST * PV_STAGE + 8 * 2 * PV_ST;

enum { FIRST128 = 0, SOFTMAX = 1 };

struct alignas(64) QKArgs {
  CUtensorMap q, k;   // dims (128, rows, 1, steps), boxes (64, 128, 1, 1)
  void* o;            // [steps, M, 128] bf16
  float* side;        // SOFTMAX: [steps, M]
  float* sink;        // FIRST128: null in use (see the note above)
  int M, N;
};

struct alignas(64) PVArgs {
  CUtensorMap p, p2, v;   // p, p2 (N, M, 1, steps) boxes (64, 128); v (128, N, 1, steps) boxes (64, 64)
  __nv_bfloat16* o;
  int M, N;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// One head's online-softmax pass over a 64 x 128 score tile (this thread's
// rows g and g + 8): running row max m (log2 domain) and this lane's part
// of the row sum l.
__device__ __forceinline__ void softmax_pass(const float (&s)[64], float (&m)[2], float (&l)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]) * LOG2E);
    l[r] *= ex2(m[r] - mn);   // exp2(-inf) = 0 on the first tile
    m[r] = mn;
  }
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e >> 1] += ex2(fmaf(s[4 * n + e], LOG2E, -m[e >> 1]));
}

// A 64 x 128 fp32 accumulator (rows q0 + 16 warp + g, + 8) as bf16 into
// o [rows of 128]; rows at or past M are not stored.
__device__ __forceinline__ void store_rows(__nv_bfloat16* o, const float (&acc)[64], int row0,
                                           int M, int c2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= M) continue;
    __nv_bfloat16* orow = o + (long long)(row0 + 8 * r) * W + c2;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(acc[4 * n + 2 * r],
                                                             acc[4 * n + 2 * r + 1]);
  }
}

template <int HEADS, int EPI>
__global__ void __launch_bounds__(THREADS, 1) qk_probe_wg(const __grid_constant__ QKArgs a) {
  constexpr int KPH = 8 / HEADS;   // k steps of 16 per chain: 64- or 128-deep
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  unsigned char* Qs = base;                  // 2 x [128][128 B]
  unsigned char* Ks = Qs + 2 * SUB;          // QK_ST x 2 x [128][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Ks + QK_ST * 2 * SUB);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + QK_ST;

  const int q0 = blockIdx.x * BQ, step = blockIdx.y;
  const int ntiles = a.N / BK;
  const int iters = EPI == SOFTMAX ? ntiles + 1 : ntiles;   // SOFTMAX: key tile 0 again
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < QK_ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 2);   // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * SUB);
      for (int j = 0; j < 2; ++j) tma_load_4d(Qs + j * SUB, &a.q, q_full, j * 64, q0, 0, step);
      for (int i = 0; i < iters; ++i) {
        const int s = i % QK_ST;
        const int kt = i < ntiles ? i : 0;
        mbar_wait(&k_empty[s], ((i / QK_ST) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], 2 * SUB);
        for (int j = 0; j < 2; ++j)
          tma_load_4d(Ks + s * 2 * SUB + j * SUB, &a.k, &k_full[s], j * 64, kt * BK, 0, step);
      }
    }
    return;
  }

  regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool leader = tid == 0;
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + (long long)step * a.M * W;
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128, k_addr = smem_u32(Ks);
  // k step kk (16 columns, 32 bytes) of the 128: sub-tile kk / 4, 32 kk % 128 bytes in.
  auto off = [](int kk) { return (kk / 4) * SUB + (kk % 4) * 32; };
  float acc[HEADS][64];
  mbar_wait(q_full, 0);

  if constexpr (EPI == FIRST128) {
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % QK_ST;
      mbar_wait(&k_full[st], (t / QK_ST) & 1);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < HEADS; ++h)
#pragma unroll
        for (int kk = 0; kk < KPH; ++kk) {
          const int ks = h * KPH + kk;
          wgmma_ss_n128<0, 0>(acc[h], make_desc(q_addr + off(ks), 128, 1024, 1024),
                              make_desc(k_addr + st * 2 * SUB + off(ks), 128, 1024, 1024),
                              t > 0 || kk > 0);
        }
      wgmma_commit();
      if (t == 0) {
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < HEADS; ++h) fence_regs(acc[h]);
        if (leader) mbar_arrive(&k_empty[0]);
        float first[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          first[i] = acc[0][i];
#pragma unroll
          for (int h = 1; h < HEADS; ++h) first[i] += acc[h][i];
        }
        store_rows(o, first, row0, a.M, c2);
      } else {
        wgmma_wait<1>();       // tile t - 1 done, t may run on
#pragma unroll
        for (int h = 0; h < HEADS; ++h) fence_regs(acc[h]);
        if (leader && t >= 2) mbar_arrive(&k_empty[(t - 1) % QK_ST]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < HEADS; ++h) fence_regs(acc[h]);
    if (a.sink != nullptr) {
      float x = 0.f;
#pragma unroll
      for (int h = 0; h < HEADS; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) x += acc[h][i];
      a.sink[((long long)step * gridDim.x + blockIdx.x) * 256 + threadIdx.x] = x;
    }
  } else {  // SOFTMAX (HEADS == 2)
    float m[2][2], l[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h][0] = m[h][1] = -INFINITY;
      l[h][0] = l[h][1] = 0.f;
    }
    for (int i = 0; i < iters; ++i) {
      const int st = i % QK_ST;
      const bool again = i == ntiles;    // key tile 0, against the final row max
      mbar_wait(&k_full[st], (i / QK_ST) & 1);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kk = 0; kk < KPH; ++kk) {
          const int ks = h * KPH + kk;
          wgmma_ss_n128<0, 0>(acc[h], make_desc(q_addr + off(ks), 128, 1024, 1024),
                              make_desc(k_addr + st * 2 * SUB + off(ks), 128, 1024, 1024),
                              kk > 0);
        }
        wgmma_commit();
      }
      wgmma_wait<1>();         // head 0's scores; head 1's products run on
      fence_regs(acc[0]);
      if (!again) {
        softmax_pass(acc[0], m[0], l[0]);
      } else {
#pragma unroll
        for (int j = 0; j < 64; ++j)
          acc[0][j] = round_bf16(ex2(fmaf(acc[0][j], LOG2E, -m[0][(j >> 1) & 1])));
      }
      wgmma_wait<0>();
      fence_regs(acc[1]);
      if (leader) mbar_arrive(&k_empty[st]);
      if (!again) {
        softmax_pass(acc[1], m[1], l[1]);
      } else {
#pragma unroll
        for (int j = 0; j < 64; ++j)
          acc[0][j] += round_bf16(ex2(fmaf(acc[1][j], LOG2E, -m[1][(j >> 1) & 1])));
      }
    }
    store_rows(o, acc[0], row0, a.M, c2);
    // Every lane shuffles; one lane of each quad stores its row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[0][r]) + quad_sum(l[1][r]);
      if ((lane & 3) == 0 && row0 + 8 * r < a.M) a.side[(long long)step * a.M + row0 + 8 * r] = sum;
    }
  }
}

// o = bf16(p v + p2 v): p, p2 [M, N], v [N, 128] per step.
__global__ void __launch_bounds__(THREADS, 1) pv_probe_wg(const __grid_constant__ PVArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);   // PV_ST x [p | p2 | v 2 x [64][128 B]]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + PV_ST * PV_STAGE);
  uint64_t* empty = full + PV_ST;

  const int q0 = blockIdx.x * BQ, step = blockIdx.y;
  const int ntiles = a.N / PV_BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PV_ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % PV_ST;
        unsigned char* st = base + s * PV_STAGE;
        mbar_wait(&empty[s], ((t / PV_ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], PV_STAGE);
        tma_load_4d(st, &a.p, &full[s], t * PV_BK, q0, 0, step);
        tma_load_4d(st + P_BYTES, &a.p2, &full[s], t * PV_BK, q0, 0, step);
        for (int j = 0; j < 2; ++j)
          tma_load_4d(st + 2 * P_BYTES + j * V_SUB, &a.v, &full[s], j * 64, t * PV_BK, 0, step);
      }
    }
    return;
  }

  regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool leader = tid == 0;
  const uint32_t smem = smem_u32(base);
  float acc[2][32];   // output columns 64 j .. 64 j + 63
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % PV_ST;
    const uint32_t st = smem + s * PV_STAGE;
    mbar_wait(&full[s], (t / PV_ST) & 1);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PV_BK / 16; ++kk)
#pragma unroll
      for (int which = 0; which < 2; ++which)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wgmma_ss_n64<0, 1>(acc[j],
                             make_desc(st + which * P_BYTES + wg * 64 * 128 + kk * 32, 128,
                                       1024, 1024),
                             make_desc(st + 2 * P_BYTES + j * V_SUB + kk * 16 * 128, 128,
                                       1024, 1024),
                             1);
    wgmma_commit();
    wgmma_wait<1>();           // tile t - 1 done: free its stage
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (leader && t >= 1) mbar_arrive(&empty[(t - 1) % PV_ST]);
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  const int row0 = q0 + wg * 64 + warp * 16 + g;
  __nv_bfloat16* o = a.o + (long long)step * a.M * W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= a.M) continue;
    __nv_bfloat16* orow = o + (long long)(row0 + 8 * r) * W + c2;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + j * 64 + n * 8) =
            pack_bf16(acc[j][4 * n + 2 * r], acc[j][4 * n + 2 * r + 1]);
  }
}

// A bf16 [steps, rows, cols] tensor as a 4D map (cols, rows, 1, steps) with
// boxes of 64 columns x box_rows and the 128-byte swizzle.
bool map3(CUtensorMap* map, const void* ptr, int steps, int rows, int cols, int box_rows) {
  const uint64_t dims[4] = {(uint64_t)cols, (uint64_t)rows, 1u, (uint64_t)steps};
  const int64_t strides[3] = {cols, 0, (int64_t)rows * cols};
  const uint32_t box[4] = {64u, (uint32_t)box_rows, 1u, 1u};
  return make_map(map, ptr, 4, dims, strides, box, 128);
}

template <int HEADS, int EPI>
int launch_qk(QKArgs& a, int steps, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(qk_probe_wg<HEADS, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)QK_SMEM);
  if (err != cudaSuccess) return (int)err;
  qk_probe_wg<HEADS, EPI><<<dim3((a.M + BQ - 1) / BQ, steps), THREADS, QK_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// probe: 0 = qk64x2, 1 = qk128, 2 = qk+sm x2. q [steps, M, 128], k [steps,
// N, 128] contiguous bf16; M % 64 == 0, N % 128 == 0. o [steps, M, 128]
// bf16; side [steps, M] fp32 for probe 2 (else unused); sink null, or for
// probes 0 and 1 steps * ceil(M / 128) * 256 floats. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue if a
// tensor map is refused); does not synchronise.
extern "C" int vda_phase_probe(int probe, const void* q, const void* k, void* o, float* side,
                               float* sink, int steps, int M, int N, void* stream) {
  QKArgs a;
  a.o = o;
  a.side = side;
  a.sink = sink;
  a.M = M;
  a.N = N;
  if (!map3(&a.q, q, steps, M, W, BQ) || !map3(&a.k, k, steps, N, W, BK))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case 0: return launch_qk<2, FIRST128>(a, steps, st);
    case 1: return launch_qk<1, FIRST128>(a, steps, st);
    case 2: return launch_qk<2, SOFTMAX>(a, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// pv128x2: p, p2 [steps, M, N], v [steps, N, 128], o [steps, M, 128], all
// contiguous bf16; M % 64 == 0, N % 64 == 0.
extern "C" int vda_phase_pv(const void* p, const void* p2, const void* v, void* o, int steps,
                            int M, int N, void* stream) {
  PVArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.M = M;
  a.N = N;
  if (!map3(&a.p, p, steps, M, N, BQ) || !map3(&a.p2, p2, steps, M, N, BQ) ||
      !map3(&a.v, v, steps, N, W, PV_BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pv_probe_wg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PV_SMEM);
  if (err != cudaSuccess) return (int)err;
  pv_probe_wg<<<dim3((M + BQ - 1) / BQ, steps), THREADS, PV_SMEM,
                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
