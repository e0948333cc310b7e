// Temporal multi-head attention of the motion modules, for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_temporal_attention.py
//   temporal_flash_attention (its Pallas body _kernel), and the XLA twin
//   that the JAX model routes on the TPU, ops/attention.py
//   temporal_flat_attention.
// Computes, per pixel p and head h: softmax((q * scale) k^T) v over the
// T <= 32 frames of the window, where q, k, v, o are contiguous [P, T, C]
// and head h owns channels [h*dh, (h+1)*dh). q is pre-scaled in its own
// dtype, scores, max, sum and the PV accumulation are fp32, the
// unnormalised probabilities are rounded to the value dtype before PV, the
// denominator sums the unrounded ones and the output is normalised at the
// end — the arithmetic of the flat XLA form.
//
// Bound on this card: bytes. 4*P*T*C*itemsize bytes (q, k, v read once,
// o written once) against 4*P*H*T^2*dh FLOPs: 8 FLOPs per byte in bf16 at
// T = 32, far below the ~295 at which the tensor cores would bind. The
// P*H*T^2 exponentials take about 40 % of the byte time at dh = 8.
//
// Design, bf16: the TPU kernel flattens (frame, head) and masks cross-head
// pairs with -inf to fill a 128x128 matrix unit; that 8x detour is not
// needed here. A block of 4 warps walks tiles of (pixel, head group)
// units: a unit is one pixel's [T, G*dh] rows of q, k and v, with G the
// most heads whose three slabs fit the stage (all 8 at C = 64, 2 at
// C = 192, 1 at C = 384 and at dh = 128), and a tile is as many units as
// fit about 14 KB. Tiles are staged into shared memory with 16-byte
// cp.async copies, consecutive threads on consecutive 16 bytes of a frame
// row, and double buffered: tile j + 1 loads while tile j computes. Rows
// are padded to an odd number of 16-byte chunks, so ldmatrix reads them
// without bank conflicts. Each warp takes (unit, head) items, both
// 16-query blocks of T = 32 at once (one block each when a tile has fewer
// heads than warps): QK^T [32 x 32 frames] on mma.sync m16n8k16 bf16
// (m16n8k8 for a last 8 channels), q's pre-scale applied to the A
// fragments in bf16; frames past T at -inf; the softmax in registers
// (exp2 of log2(e)-scaled scores); PV [32 x dh] on mma.sync with the
// probabilities as bf16 A fragments and V through ldmatrix.trans, 32
// output channels at a time, K's and V's fragments shared by both blocks.
// The normalised output goes back into the Q slab's place in shared
// memory and leaves in 16-byte coalesced stores. T pads to 32 frames:
// V's rows past T are zero, so the zero probabilities of padded frames
// meet zeros. Needs dh % 8 == 0 and dh <= 512 (the wrapper pads other head
// dims with zero channels). The grid is as many blocks as the card holds
// at once (6 per SM at the main path's widths), or fewer when there are
// fewer tiles. At dh = 8 the softmax's instructions, not the loads, set
// the pace: smaller tiles on more blocks per SM overlap them best
// (tools/bench_variants.py temporal).
// fp32 (the --fp32 correctness path): one warp per (pixel, head), lane t
// owns query frame t; dh in chunks of 32 channels staged in shared memory
// with coalesced row loads, read back as broadcasts; scalar fp32 FMAs,
// none on the channels past dh.

#include <math.h>

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace vda;

// ---- bf16: tensor cores ----

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 32;            // frames per window at most (T pads to it)
constexpr int BLOCKS = 6;           // blocks per SM the registers are held to
constexpr int STAGE_MAX = 14000;    // bytes of q, k, v per tile: two tiles of
                                    // six blocks fit an SM's shared memory
constexpr int MAX_DH = 512;         // bf16 head dims taken: two tiles of one
                                    // such head fill a block's shared memory
constexpr float LOG2E = 1.4426950408889634f;

// The tiling of one launch, computed on the host.
struct Geo {
  int T, C, dh;
  int G, W, ng;         // heads per unit, its channels G * dh, units per pixel
  int pitch;            // bytes per staged frame row
  int unit_bytes, U;    // q, k and v of one unit; units per tile
  int chunks, mt;       // 16-byte chunks per row; 16-query blocks (1 or 2)
  int split;            // a warp takes one query block of a head, not both
  long long nunits, ntiles;
};

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// d += a[16x8, row] * b[8x8, col], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, __nv_bfloat162 s) {
  __nv_bfloat162 y = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&x), s);
  return *reinterpret_cast<uint32_t*>(&y);
}

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One head of one unit for MT 16-query blocks from row m0: Qb, Kb, Vb
// point at the head's first channel in frame row 0 of the staged slabs.
// The output, normalised and rounded, replaces those Q rows of this head.
// K's and V's fragments are loaded once for the MT blocks.
template <int MT>
__device__ __forceinline__ void head_attention(unsigned char* Qb, const unsigned char* Kb,
                                               const unsigned char* Vb, int m0,
                                               const Geo& g, __nv_bfloat162 qs2) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, c2 = (lane & 3) * 2;
  const int pitch = g.pitch, dh = g.dh;
  const unsigned char* qrow = Qb + (m0 + (lane & 15)) * pitch;   // this lane's ldmatrix row

  // Scores [16 queries, 32 frames] per block: 4 frame blocks of 8.
  float s[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
  int kc = 0;
  for (; kc + 16 <= dh; kc += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ldsm_x4(a[m], qrow + m * 16 * pitch + (kc + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[m][i] = mul_bf16x2(a[m][i], qs2);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {   // frame blocks 2np, 2np + 1
      uint32_t b[4];
      ldsm_x4(b, Kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * pitch
                     + (kc + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(s[m][2 * np], a[m], b[0], b[1]);
        mma_bf16(s[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
  if (kc < dh) {   // the last 8 channels of a dh that is 8 mod 16
    uint32_t a[MT][2], b[4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ldsm_x2(a[m], qrow + m * 16 * pitch + kc * 2);
      a[m][0] = mul_bf16x2(a[m][0], qs2);
      a[m][1] = mul_bf16x2(a[m][1], qs2);
    }
    ldsm_x4(b, Kb + lane * pitch + kc * 2);   // frame block j in b[j]
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_k8(s[m][j], a[m], b[j]);
  }

  // Softmax over the frames; rows g and g + 8 of each block, frames past T
  // at -inf (frame 0 is always there, so the row max is finite). The
  // probabilities of frame blocks 2kk, 2kk + 1 become the bf16 A fragment
  // of PV's k step kk.
  if (g.T < ROWS) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + c2 + (e & 1) >= g.T) s[m][j][e] = -INFINITY;
  }
  float inv[MT][2];
  uint32_t pa[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[m][j][0], s[m][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[m][j][2], s[m][j][3]));
    }
    float l[2] = {0.f, 0.f}, neg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) neg[i] = -quad_max(mx[i]) * LOG2E;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[m][j][e] = fast_exp2(fmaf(s[m][j][e], LOG2E, neg[e >> 1]));
        l[e >> 1] += s[m][j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[m][i] = __frcp_rn(fmaxf(quad_sum(l[i]), 1e-30f));
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[m][kk][0] = pack_bf16(s[m][2 * kk][0], s[m][2 * kk][1]);
      pa[m][kk][1] = pack_bf16(s[m][2 * kk][2], s[m][2 * kk][3]);
      pa[m][kk][2] = pack_bf16(s[m][2 * kk + 1][0], s[m][2 * kk + 1][1]);
      pa[m][kk][3] = pack_bf16(s[m][2 * kk + 1][2], s[m][2 * kk + 1][3]);
    }
  }
  const int ksteps = g.T > 16 ? 2 : 1;   // a k step past T holds zeros only
  __syncwarp();   // every lane's Q reads are done before the output lands there

  for (int dc = 0; dc < dh; dc += 32) {
    const int nn = min(4, (dh - dc) >> 3);   // 8-channel blocks in this pass
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (kk >= ksteps) break;
      const unsigned char* vrow = Vb + (kk * 16 + (lane & 15)) * pitch + dc * 2;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (2 * np + 1 < nn) {
          uint32_t b[4];
          ldsm_x4_trans(b, vrow + (np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][2 * np], pa[m][kk], b[0], b[1]);
            mma_bf16(acc[m][2 * np + 1], pa[m][kk], b[2], b[3]);
          }
        } else if (2 * np < nn) {
          uint32_t b[2];
          ldsm_x2_trans(b, vrow + np * 16 * 2);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(acc[m][2 * np], pa[m][kk], b[0], b[1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n >= nn) break;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(Qb + (m0 + 16 * m + gr + 8 * i) * pitch
                                       + (dc + 8 * n + c2) * 2) =
              pack_bf16(acc[m][n][2 * i] * inv[m][i], acc[m][n][2 * i + 1] * inv[m][i]);
      }
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS)
temporal_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              const __grid_constant__ Geo g, const __nv_bfloat162 qs2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int slot = ROWS * g.pitch;   // bytes of one tensor of one unit
  // Unit u of stage s at (s * U + u) * unit_bytes: its Q, K and V slots.
  auto unit = [&](int s, int u) { return smem + (s * g.U + u) * g.unit_bytes; };

  // V's rows past T stay zero in every slot (the loads never write them).
  if (g.T < ROWS) {
    const int zc = (ROWS - g.T) * g.pitch / 16;
    for (int i = threadIdx.x; i < 2 * g.U * zc; i += THREADS) {
      const int su = i / zc;
      *reinterpret_cast<uint4*>(smem + su * g.unit_bytes + 2 * slot + g.T * g.pitch
                                + (i - su * zc) * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // A unit's [T, W] rows in 16-byte chunks: this thread's first chunk
  // (t0, c0), then a step of THREADS chunks.
  const int t0 = threadIdx.x / g.chunks, c0 = threadIdx.x % g.chunks;
  const int dt = THREADS / g.chunks, dc = THREADS % g.chunks;
  // Element offset of unit n in q, k, v and o.
  auto offset = [&](long long n) {
    const long long px = n / g.ng;
    return px * g.T * g.C + (n - px * g.ng) * g.W;
  };
  auto load = [&](long long tile, int s) {
    for (int u = 0; u < g.U; ++u) {
      const long long n = tile * g.U + u;
      if (n >= g.nunits) break;
      const long long off = offset(n);
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const __nv_bfloat16* src = (x == 0 ? q : x == 1 ? k : v) + off;
        unsigned char* dst = unit(s, u) + x * slot;
        for (int t = t0, c = c0; t < g.T;) {
          cp_async16(dst + t * g.pitch + c * 16, src + (long long)t * g.C + c * 8, true);
          c += dc;
          t += dt;
          if (c >= g.chunks) { c -= g.chunks; ++t; }
        }
      }
    }
  };
  auto store = [&](long long tile, int s) {   // the output, from the Q slots
    for (int u = 0; u < g.U; ++u) {
      const long long n = tile * g.U + u;
      if (n >= g.nunits) break;
      __nv_bfloat16* dst = o + offset(n);
      const unsigned char* src = unit(s, u);
      for (int t = t0, c = c0; t < g.T;) {
        *reinterpret_cast<uint4*>(dst + (long long)t * g.C + c * 8) =
            *reinterpret_cast<const uint4*>(src + t * g.pitch + c * 16);
        c += dc;
        t += dt;
        if (c >= g.chunks) { c -= g.chunks; ++t; }
      }
    }
  };
  // Items: (unit, head), both query blocks at once, or (unit, head, query
  // block) when a tile has fewer heads than warps.
  const int per_unit = g.split ? g.G * 2 : g.G;
  auto compute = [&](long long tile, int s) {
    int u = 0, r = warp;
    while (r >= per_unit) { r -= per_unit; ++u; }
    for (; u < g.U && tile * g.U + u < g.nunits;) {
      const int hd = g.split ? r >> 1 : r;
      unsigned char* qb = unit(s, u) + hd * g.dh * 2;
      if (g.split) head_attention<1>(qb, qb + slot, qb + 2 * slot, (r & 1) * 16, g, qs2);
      else if (g.mt == 2) head_attention<2>(qb, qb + slot, qb + 2 * slot, 0, g, qs2);
      else head_attention<1>(qb, qb + slot, qb + 2 * slot, 0, g, qs2);
      r += WARPS;
      while (r >= per_unit) { r -= per_unit; ++u; }
    }
  };

  const long long step = gridDim.x;
  long long tile = blockIdx.x;
  load(tile, 0);
  cp_async_commit();
  load(tile + step, 1);
  cp_async_commit();
  for (int j = 0; tile < g.ntiles; ++j, tile += step) {
    const int s = j & 1;
    cp_async_wait<1>();      // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    compute(tile, s);
    __syncthreads();
    store(tile, s);
    __syncthreads();         // the slots are read before they refill
    load(tile + 2 * step, s);
    cp_async_commit();
  }
}

int pitch_of(int w) {   // bytes per staged row of w bf16 channels: an odd count of 16 bytes
  const int b = w * 2;
  return (b / 16) % 2 ? b : b + 16;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int P, int T, int H,
                int dh, float scale, cudaStream_t st) {
  if (dh % 8 || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  Geo g;
  g.T = T;
  g.C = H * dh;
  g.dh = dh;
  g.G = 1;
  for (int d = H; d > 1; --d)
    if (H % d == 0 && 3 * ROWS * pitch_of(d * dh) <= STAGE_MAX) { g.G = d; break; }
  g.W = g.G * dh;
  g.ng = H / g.G;
  g.pitch = pitch_of(g.W);
  g.unit_bytes = 3 * ROWS * g.pitch;
  g.nunits = (long long)P * g.ng;
  g.U = (int)std::max<long long>(1, std::min<long long>(STAGE_MAX / g.unit_bytes, g.nunits));
  g.ntiles = (g.nunits + g.U - 1) / g.U;
  g.chunks = g.W / 8;
  g.mt = T > 16 ? 2 : 1;
  g.split = g.mt == 2 && g.U * g.G < WARPS;
  const int smem = 2 * g.U * g.unit_bytes;
  cudaError_t err = cudaFuncSetAttribute(temporal_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  // Blocks resident per SM: the registers hold BLOCKS (the launch bounds);
  // the shared memory (228 KB an SM, 1 KB of it reserved per block) may hold
  // fewer, at one head of dh > 48 per unit.
  const int per_sm = std::max(1, std::min(BLOCKS, 233472 / (smem + 1024)));
  const long long grid = std::min<long long>(g.ntiles, (long long)per_sm * sms);
  temporal_bf16<<<(unsigned)grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), g,
      __float2bfloat162_rn(scale));
  return (int)cudaGetLastError();
}

// ---- fp32: FMAs ----

constexpr int TMAX = 32;             // frames per window at most
constexpr int CH = 32;               // channels per chunk
constexpr int F_WARPS = 8;           // (pixel, head) pairs per block
constexpr int F_THREADS = F_WARPS * 32;
constexpr int KP = CH;               // K/V chunk pitch: broadcast reads only
constexpr int QP = CH + 1;           // Q/O chunk pitch: per-lane rows, odd
constexpr int WARP_FLOATS = TMAX * KP + TMAX * QP;
constexpr size_t F_SMEM = (size_t)F_WARPS * WARP_FLOATS * sizeof(float);

// Chunk [TMAX][CH] of one (pixel, head) slice into shared memory: lane =
// channel, so each frame's row is one coalesced load. Zero past T / dh.
__device__ __forceinline__ void load_chunk(float* dst, int pitch, const float* src, int nt,
                                           int C, int c0, int cw, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = 0; j < TMAX; ++j)
    dst[j * pitch + lane] = j < nt && lane < cw ? src[(long long)j * C + c0 + lane] * mul : 0.f;
}

__global__ void __launch_bounds__(F_THREADS)
temporal_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int P, int nt, int H,
             int dh, float scale) {
  extern __shared__ __align__(16) float fsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * F_WARPS + warp;
  if (pair >= (long long)P * H) return;  // no block-wide sync below
  const long long p = pair / H;
  const int h = (int)(pair - p * H);
  const int C = H * dh;
  const long long base = p * nt * C + (long long)h * dh;
  float* KV = fsmem + warp * WARP_FLOATS;  // [TMAX][KP]
  float* QO = KV + TMAX * KP;              // [TMAX][QP]

  float s[TMAX];
#pragma unroll
  for (int j = 0; j < TMAX; ++j) s[j] = 0.f;

  for (int c0 = 0; c0 < dh; c0 += CH) {
    const int cw = min(CH, dh - c0);
    load_chunk(KV, KP, k + base, nt, C, c0, cw, 1.f);
    load_chunk(QO, QP, q + base, nt, C, c0, cw, scale);
    __syncwarp();
#pragma unroll
    for (int d = 0; d < CH; d += 4) {
      if (d >= cw) break;   // the chunk's channels past dh are zeros: skip them
      const float q0 = QO[lane * QP + d], q1 = QO[lane * QP + d + 1];
      const float q2 = QO[lane * QP + d + 2], q3 = QO[lane * QP + d + 3];
#pragma unroll
      for (int j = 0; j < TMAX; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(KV + j * KP + d);
        s[j] = fmaf(q0, kv.x, fmaf(q1, kv.y, fmaf(q2, kv.z, fmaf(q3, kv.w, s[j]))));
      }
    }
    __syncwarp();
  }

  // Lane-local softmax over the frames (rows past T never store).
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < TMAX; ++j)
    if (j < nt) mx = fmaxf(mx, s[j]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    s[j] = j < nt ? expf(s[j] - mx) : 0.f;
    sum += s[j];
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);

  for (int c0 = 0; c0 < dh; c0 += CH) {
    const int cw = min(CH, dh - c0);
    load_chunk(KV, KP, v + base, nt, C, c0, cw, 1.f);
    __syncwarp();
    float acc[CH];
#pragma unroll
    for (int d = 0; d < CH; ++d) acc[d] = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
#pragma unroll
      for (int d = 0; d < CH; d += 4) {
        if (d >= cw) break;
        const float4 vv = *reinterpret_cast<const float4*>(KV + j * KP + d);
        acc[d] = fmaf(s[j], vv.x, acc[d]);
        acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
      }
    }
#pragma unroll
    for (int d = 0; d < CH; ++d) QO[lane * QP + d] = acc[d] * inv;
    __syncwarp();
    // Coalesced store: lane = channel, one frame row at a time.
    for (int j = 0; j < nt; ++j)
      if (lane < cw) o[base + (long long)j * C + c0 + lane] = QO[j * QP + lane];
    __syncwarp();
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. q, k, v, o contiguous [P, T, H*dh], T <= 32,
// 16-byte aligned; bf16 needs dh % 8 == 0 and dh <= 512. scale is already
// rounded to the dtype. Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int vda_temporal_attention(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int P, int T,
                                      int H, int dh, float scale,
                                      void* stream) {
  if (T < 1 || T > TMAX || dh < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(q, k, v, o, P, T, H, dh, scale, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)P * H;
  cudaError_t err = cudaFuncSetAttribute(temporal_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  temporal_f32<<<(unsigned)((pairs + F_WARPS - 1) / F_WARPS), F_THREADS, F_SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), P, T, H, dh, scale);
  return (int)cudaGetLastError();
}
