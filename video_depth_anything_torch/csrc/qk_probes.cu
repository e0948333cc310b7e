// DCE-proof QK probes of the spatial attention kernel K1, for Hopper
// (sm_90a), on the attention body's wgmma + TMA machinery.
//
// Replaces: tools/bench_kernel_ab.py probes (T3; bodies _qk64_probe,
//   _qk128_probe). (T1's phase probes are phase_probes.cu.)
// Computes, per step (one grid row of the TPU tool), bf16 in, fp32
// accumulation: q, k [M, 128] and [N, 128]; heads = 2 splits the 128
// columns into two 64-deep contractions s_h = q_h k_h^T, heads = 1 is one
// 128-deep s; o[:, j] = sum_h sum_t s_h[:, 128 t + j] in fp32: every score
// column feeds the output.
//
// Bound on this card, at the tool's shape (64 steps of 1408 x 1408 keys):
// 32.5 GFLOP, 0.033 ms of bf16 tensor-core time, against 92 MB of bytes
// (q, k and the fp32 o), 0.027 ms.
//
// Design: the column-group sum is what a wgmma accumulator computes when
// it is not reset between 128-key tiles: acc_h += q_h k_{h,t}^T over every
// t leaves acc_h[:, j] = sum_t s_h[:, 128 t + j], and o = sum_h acc_h. So
// no score is ever added outside the tensor cores. A persistent grid of
// min(tiles, SMs) blocks walks the (step, 128-row block) tiles by a fixed
// stride. Each block runs three warpgroups: one producer thread TMA-loads
// each tile's Q rows (two 64-column sub-tiles, 128-byte swizzle) into one
// of two Q slots and streams 128-key K tiles of width 128 through a
// 4-stage ring of full / empty mbarriers, running on into the next tile's
// Q and K while the consumers finish and store the current one. Each
// consumer warpgroup owns 64 of a tile's rows and issues wgmma m64n128k16
// with both operands K-major from shared memory: qk64 two 64-deep chains
// of 4 k steps, one accumulator each; qk128 one 128-deep chain of 8. The
// two heads are not folded into one accumulator, so the two probes issue
// different instruction streams (the tools time their ratio). Scale-d is 0
// only on key tile 0's first k step of each chain; tile t's products are
// issued before tile t - 1's are waited for, and a K stage is freed once
// its products have retired. The epilogue sums the accumulators in fp32
// and stores rows below M (TMA zero-fills the rows past M on load). DCE
// guard: every product feeds the stored output. What is left between the
// kernel and its bound is data movement per SM: each tile pulls every K
// tile of its step into shared memory (11 at the tools' shape) and writes
// 64 KB of fp32; with the products removed, those alone take about 80 % of
// the kernel's time (PERF.md; tools/bench_variants.py qk).

#include "hopper.cuh"

namespace {

using namespace vda::hopper;

constexpr int W = 128;               // q / k / o row width
constexpr int BQ = 128;              // query rows per tile, 64 per consumer
constexpr int BK = 128;              // keys per K tile
constexpr int SUB = 128 * 128;       // bytes of 128 rows x 64 bf16 (one 128-byte-swizzled sub-tile)
constexpr int Q_ST = 2;              // Q slots: the current tile's and the next one's
constexpr int K_ST = 4;              // K ring depth (tiles of 2 sub-tiles)
constexpr int THREADS = 384;         // consumers 0, 1; producer 2
constexpr size_t SMEM = 1024 + (Q_ST + K_ST) * 2 * SUB + 8 * 2 * (Q_ST + K_ST);

struct alignas(64) QKArgs {
  CUtensorMap q, k;   // dims (128, rows, 1, steps), boxes (64, 128, 1, 1)
  float* o;           // [steps, M, 128]
  int M, N;
  int rblocks;        // 128-row blocks per step
  int tiles;          // steps * rblocks
};

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

template <int HEADS>
__global__ void __launch_bounds__(THREADS, 1) qk_probe(const __grid_constant__ QKArgs a) {
  constexpr int KPH = 8 / HEADS;   // k steps of 16 per chain: 64- or 128-deep
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_base(smem_raw);
  unsigned char* Qs = base;                  // Q_ST x 2 x [128][128 B]
  unsigned char* Ks = Qs + Q_ST * 2 * SUB;   // K_ST x 2 x [128][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Ks + K_ST * 2 * SUB);
  uint64_t* q_empty = q_full + Q_ST;
  uint64_t* k_full = q_empty + Q_ST;
  uint64_t* k_empty = k_full + K_ST;

  const int ntiles = a.N / BK;   // key tiles per step
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_ST; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 2);   // one arrival per consumer warpgroup
    }
    for (int s = 0; s < K_ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int it = 0;   // K tiles loaded by this block so far
      for (int tile = blockIdx.x, n = 0; tile < a.tiles; tile += gridDim.x, ++n) {
        const int step = tile / a.rblocks, q0 = (tile % a.rblocks) * BQ;
        const int qs = n % Q_ST;
        mbar_wait(&q_empty[qs], ((n / Q_ST) & 1) ^ 1);
        mbar_expect_tx(&q_full[qs], 2 * SUB);
        for (int j = 0; j < 2; ++j)
          tma_load_4d(Qs + (qs * 2 + j) * SUB, &a.q, &q_full[qs], j * 64, q0, 0, step);
        for (int t = 0; t < ntiles; ++t, ++it) {
          const int s = it % K_ST;
          mbar_wait(&k_empty[s], ((it / K_ST) & 1) ^ 1);
          mbar_expect_tx(&k_full[s], 2 * SUB);
          for (int j = 0; j < 2; ++j)
            tma_load_4d(Ks + (s * 2 + j) * SUB, &a.k, &k_full[s], j * 64, t * BK, 0, step);
        }
      }
    }
    return;
  }

  regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool leader = tid == 0;
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128, k_addr = smem_u32(Ks);
  // k step kk (16 columns, 32 bytes) of the 128: sub-tile kk / 4, 32 kk % 128 bytes in.
  auto off = [](int kk) { return (kk / 4) * SUB + (kk % 4) * 32; };
  float acc[HEADS][64];
  int it = 0;   // K tiles consumed by this block so far
  for (int tile = blockIdx.x, n = 0; tile < a.tiles; tile += gridDim.x, ++n) {
    const int step = tile / a.rblocks, q0 = (tile % a.rblocks) * BQ;
    const int qs = n % Q_ST;
    const uint32_t qa = q_addr + qs * 2 * SUB;
    mbar_wait(&q_full[qs], (n / Q_ST) & 1);
    for (int t = 0; t < ntiles; ++t, ++it) {
      const int st = it % K_ST;
      mbar_wait(&k_full[st], (it / K_ST) & 1);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < HEADS; ++h)
#pragma unroll
        for (int kk = 0; kk < KPH; ++kk) {
          const int ks = h * KPH + kk;
          wgmma_ss_n128<0, 0>(acc[h], make_desc(qa + off(ks), 128, 1024, 1024),
                              make_desc(k_addr + st * 2 * SUB + off(ks), 128, 1024, 1024),
                              t > 0 || kk > 0);
        }
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();       // tile t - 1 done, t may run on
#pragma unroll
        for (int h = 0; h < HEADS; ++h) fence_regs(acc[h]);
        if (leader) mbar_arrive(&k_empty[(it - 1) % K_ST]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < HEADS; ++h) fence_regs(acc[h]);
    if (leader) {
      mbar_arrive(&k_empty[(it - 1) % K_ST]);
      mbar_arrive(&q_empty[qs]);
    }
    // o = sum_h acc_h; this thread's rows row0 and row0 + 8, columns 8 n + c2, + 1.
    const int row0 = q0 + wg * 64 + warp * 16 + g;
    float* o = a.o + (long long)step * a.M * W;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r >= a.M) continue;
      float* orow = o + (long long)(row0 + 8 * r) * W + c2;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        float2 v = make_float2(acc[0][4 * nb + 2 * r], acc[0][4 * nb + 2 * r + 1]);
#pragma unroll
        for (int h = 1; h < HEADS; ++h) {
          v.x += acc[h][4 * nb + 2 * r];
          v.y += acc[h][4 * nb + 2 * r + 1];
        }
        *reinterpret_cast<float2*>(orow + nb * 8) = v;
      }
    }
  }
}

// A bf16 [steps, rows, 128] tensor as a 4D map (128, rows, 1, steps) with
// boxes of 64 columns x 128 rows and the 128-byte swizzle.
bool map3(CUtensorMap* map, const void* ptr, int steps, int rows) {
  const uint64_t dims[4] = {(uint64_t)W, (uint64_t)rows, 1u, (uint64_t)steps};
  const int64_t strides[3] = {W, 0, (int64_t)rows * W};
  const uint32_t box[4] = {64u, 128u, 1u, 1u};
  return make_map(map, ptr, 4, dims, strides, box, 128);
}

template <int HEADS>
int launch_qk(const QKArgs& a, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qk_probe<HEADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  qk_probe<HEADS><<<a.tiles < sms ? a.tiles : sms, THREADS, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// heads: 2 = qk64 (two 64-deep heads), 1 = qk128. q [steps, M, 128], k
// [steps, N, 128] contiguous bf16; M % 64 == 0, N % 128 == 0; o [steps, M,
// 128] fp32. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue if a tensor map is refused); does not synchronise.
extern "C" int vda_qk_probe(int heads, const void* q, const void* k, float* o, int steps, int M,
                            int N, void* stream) {
  QKArgs a;
  a.o = o;
  a.M = M;
  a.N = N;
  a.rblocks = (M + BQ - 1) / BQ;
  a.tiles = steps * a.rblocks;
  if (!map3(&a.q, q, steps, M) || !map3(&a.k, k, steps, N)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (heads) {
    case 2: return launch_qk<2>(a, st);
    case 1: return launch_qk<1>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
