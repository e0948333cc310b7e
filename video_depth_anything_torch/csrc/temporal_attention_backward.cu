// The gradient of the motion modules' temporal attention (K2), for Hopper
// (sm_90a).
//
// Replaces: no TPU kernel. The JAX package's K2 (ops/pallas_temporal_
//   attention.py temporal_flash_attention) has no VJP; JAX's training
//   takes XLA's fused gradient of ops/attention.py temporal_flat_attention
//   / temporal_mha. This kernel is that gradient for the port's K2
//   (csrc/temporal_attention.cu), kept in a library of its own so that the
//   forward's code stays as it is.
// Computes, per pixel p and head h, over the T <= 32 frames of the window,
// with q, k, v, do, dq, dk, dv contiguous [P, T, C] and head h owning
// channels [h*dh, (h+1)*dh):
//   qs = q * scale, rounded to q's dtype (as the forward pre-scales q);
//   S = qs k^T and P = softmax(S) in fp32, recomputed (only q, k and v are
//   saved); dP = do v^T; D = rowsum(P o dP) (= rowsum(do o o), so o is not
//   needed); dS = P o (dP - D); dv = P^T do; dk = dS^T qs; dq = dS k * scale.
//   Each (pixel, head) owns its rows of dq, dk and dv: no atomics.
//
// Bound on this card: bytes. 7*P*T*C*itemsize bytes (q, k, v, do read once,
// dq, dk, dv written once) against 10*P*H*T^2*dh FLOPs (five T x T x dh
// products): 10 FLOPs per byte in bf16 at T = 32, far below the ~295 at
// which the tensor cores would bind. So wgmma and its 64-row tiles are not
// needed: mma.sync on 16-row blocks keeps up, and the design is about
// keeping bytes in flight.
//
// Design, bf16: a block of 4 warps walks tiles of (pixel, head group)
// units, as the forward does. A unit is one pixel's [T, G*dh] rows of q, k,
// v and do, with G the most heads whose four slabs fit STAGE_MAX (all 8 at
// C = 64, where a pixel's rows of one tensor are one contiguous run; 4 at
// C = 192, 2 at C = 384 and 256, 1 at dh 128), and a tile is as many units
// as fit STAGE_MAX. Tiles are staged with 16-byte cp.async copies, consecutive
// threads on consecutive 16 bytes of a frame row, into a ring of two tiles:
// tile j + 1 loads while tile j computes and stores (one tile when two of
// one head over 440 channels at T > 16 overfill a block). The grid is as
// many blocks as the card holds at once. Rows are padded to an odd number
// of 16-byte chunks, so ldmatrix reads them without bank conflicts; T pads
// to 16 or 32 rows (MT 16-row blocks), and those rows are zeroed once:
// neither the loads nor the outputs write them, so a unit's non-finite
// values stay in its own rows. Warps take (unit, head) items from the
// staged tile, each with the per-item register algorithm: S and dP on
// mma.sync m16n8k16 (m16n8k8 for a last 8 channels) with fp32 accumulators,
// qs's scale applied to the ldmatrix fragments in bf16; frame columns
// padded to NB = ceil(T / 8) blocks of 8 (24 at T = 20, not 32: a quarter
// fewer S / dP products and exponentials; a padded column adds exact zeros,
// so the result is the same as over 2 MT blocks); the softmax, D and dS in
// registers, the statistics of all 2 MT rows of a lane reduced together so
// that their shuffles overlap. P and dS are rounded to bf16 only as mma
// operands: dS as the A fragments of dq directly, P^T and dS^T by
// movmatrix.trans of the accumulator fragments. dv, dk and dq run 32
// channels at a time with do, qs and k as B through ldmatrix.trans, land in
// the slabs whose inputs they no longer need (dv in v's, dk in do's, dq in
// q's), only in rows before T, and leave in 16-byte coalesced stores before
// the ring slot refills. vits's head dims 8 and 24 are compile-time
// constants (one output pass, no branches on the width); dh 8's registers
// leave room for 5 blocks per SM, the others' for 4. Each item keeps the
// arithmetic of a warp per (pixel, head): the same products summed in the
// same order, so dq, dk and dv are those of that simpler kernel bit for
// bit.
// fp32 (the --fp32 correctness path): K2's fp32 form, one warp per
// (pixel, head), lane t owns frame t; 32-channel chunks staged with
// coalesced row loads and read back as broadcasts; S and dP by scalar
// FMAs; P and dS go to shared memory, where lane j reads column j of each
// for its rows of dv and dk.

#include <math.h>

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace vda;

// ---- bf16: tensor cores ----

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCKS = 4;           // blocks per SM the registers are held to
constexpr int BLOCKS_DH8 = 5;       // the same at dh 8, whose items need fewer
constexpr int STAGE_MAX = 28672;    // bytes of one tile's q, k, v and do slabs
constexpr int BLOCK_SMEM = 232448;  // the most shared memory one block takes
constexpr int MAX_DH = 512;
constexpr float LOG2E = 1.4426950408889634f;

// The tiling of one launch, computed on the host.
struct Geo {
  int T, C, dh;
  int G, W, ng;          // heads per unit, its channels G * dh, units per pixel
  int rows, pitch;       // staged frame rows (T padded to 16 MT), bytes per row
  int slot, unit_bytes;  // bytes of one tensor of a unit; of its four
  int U, ring;           // units per tile; tiles staged per block (2, or 1)
  int chunks;            // 16-byte chunks per row
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

// The transpose of the 8x8 bf16 matrix whose fragment (row lane / 4,
// columns 2 (lane % 4) and + 1) the warp holds, in the same fragment form.
__device__ __forceinline__ uint32_t trans8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
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

template <int N>
__device__ __forceinline__ void scale_frag(uint32_t (&r)[N], bool on, __nv_bfloat162 qs2) {
  if (on) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = mul_bf16x2(r[i], qs2);
  }
}

// s[i-block m][frame block j < NB] += A B^T over dh channels: A's and B's
// rows are frames (A's the rows of s, B's its columns); A's fragments
// times qs2 when scale_a (qs from q's slab).
template <int MT, int NB>
__device__ __forceinline__ void rows_by_rows(float (&s)[MT][NB][4], const unsigned char* A,
                                             const unsigned char* B, int pitch, int dh,
                                             bool scale_a, __nv_bfloat162 qs2) {
  const int lane = threadIdx.x & 31;
  const unsigned char* arow = A + (lane & 15) * pitch;
  int kc = 0;
  for (; kc + 16 <= dh; kc += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ldsm_x4(a[m], arow + m * 16 * pitch + (kc + (lane >> 4) * 8) * 2);
      scale_frag(a[m], scale_a, qs2);
    }
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {   // frame blocks 2np, 2np + 1
      uint32_t b[4];
      ldsm_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * pitch
                     + (kc + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(s[m][2 * np], a[m], b[0], b[1]);
        mma_bf16(s[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
    if constexpr (NB % 2) {   // a last frame block of its own
      uint32_t b[2];
      ldsm_x2(b, B + (8 * (NB - 1) + (lane & 7)) * pitch + (kc + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_bf16(s[m][NB - 1], a[m], b[0], b[1]);
    }
  }
  if (kc < dh) {   // the last 8 channels of a dh that is 8 mod 16
    uint32_t a[MT][2], b[4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ldsm_x2(a[m], arow + m * 16 * pitch + kc * 2);
      scale_frag(a[m], scale_a, qs2);
    }
    // Frame block j in b[j]: 32 rows (MT 2) or 16.
    if constexpr (NB > 2) ldsm_x4(b, B + lane * pitch + kc * 2);
    else ldsm_x2(*reinterpret_cast<uint32_t(*)[2]>(b), B + (lane & 15) * pitch + kc * 2);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_k8(s[m][j], a[m], b[j]);
  }
}

// acc[row block][8-channel block n < nn] += a B over channels [dc, dc + 8 nn):
// a holds the A fragments [row block][k step][4]; B's rows are the k index;
// B's fragments times qs2 when scale_b.
template <int MT, int N>
__device__ __forceinline__ void rows_by_cols(float (&acc)[MT][N][4],
                                             const uint32_t (&a)[MT][MT][4],
                                             const unsigned char* B, int pitch, int dc, int nn,
                                             bool scale_b, __nv_bfloat162 qs2) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    const unsigned char* row = B + (kk * 16 + (lane & 15)) * pitch + dc * 2;
#pragma unroll
    for (int np = 0; np < (N + 1) / 2; ++np) {
      if (2 * np + 1 < nn) {
        uint32_t b[4];
        ldsm_x4_trans(b, row + (np * 16 + (lane >> 4) * 8) * 2);
        scale_frag(b, scale_b, qs2);
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          mma_bf16(acc[mb][2 * np], a[mb][kk], b[0], b[1]);
          mma_bf16(acc[mb][2 * np + 1], a[mb][kk], b[2], b[3]);
        }
      } else if (2 * np < nn) {
        uint32_t b[2];
        ldsm_x2_trans(b, row + np * 16 * 2);
        scale_frag(b, scale_b, qs2);
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) mma_bf16(acc[mb][2 * np], a[mb][kk], b[0], b[1]);
      }
    }
  }
}

// acc * mul, rounded to bf16, into a slab's channels [dc, dc + 8 nn) of
// its first T rows. Rows past T keep the zeros they were given, whatever
// this item computed there: later units of the ring slot sum over them.
// Only the last row block holds rows past T (T > 16 when MT = 2).
template <int MT, int N>
__device__ __forceinline__ void put(unsigned char* S, const float (&acc)[MT][N][4], int pitch,
                                    int T, int dc, int nn, float mul) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (n >= nn) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * mb + gr + 8 * i;
        if (mb + 1 < MT || row < T)
          *reinterpret_cast<uint32_t*>(S + row * pitch + (dc + 8 * n + c2) * 2) =
              pack_bf16(acc[mb][n][2 * i] * mul, acc[mb][n][2 * i + 1] * mul);
      }
    }
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&acc)[MT][N][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
}

// quad_max / quad_sum of N values at once: their shuffles in flight together.
template <int N>
__device__ __forceinline__ void quad_max_n(float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int o = 1; o <= 2; o *= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = __shfl_xor_sync(0xffffffffu, x[i], o);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = fmaxf(x[i], y[i]);
  }
}

template <int N>
__device__ __forceinline__ void quad_sum_n(float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int o = 1; o <= 2; o *= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = __shfl_xor_sync(0xffffffffu, x[i], o);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] += y[i];
  }
}

// One (unit, head) item of a staged tile: Q, K, V and O point at the
// head's first channel in frame row 0 of the unit's q, k, v and do slabs.
// dv, dk and dq replace v, do and q there. NN = dh / 8 for dh 8 and 24 (a
// single output pass, its width known to the compiler), else 0.
template <int MT, int NB, int NN>
__device__ __forceinline__ void item_bf16(unsigned char* Q, unsigned char* K, unsigned char* V,
                                          unsigned char* O, const Geo& g, __nv_bfloat162 qs2,
                                          float sc) {
  const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2;
  const int dh = NN ? 8 * NN : g.dh;

  // 1. S = qs k^T and dP = do v^T over the head's channels.
  float s[MT][NB][4], dp[MT][NB][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][j][e] = dp[m][j][e] = 0.f;
  rows_by_rows<MT, NB>(s, Q, K, g.pitch, dh, true, qs2);
  rows_by_rows<MT, NB>(dp, O, V, g.pitch, dh, false, qs2);

  // 2. P = softmax(S) over the frames, all 2 MT rows of the lane at once
  // (rows gr and gr + 8 of each block; frames past T at -inf, frame 0
  // always there); D = rowsum(P o dP); dS = P o (dP - D). P stays in s,
  // dS goes to dp. Only the last frame block holds frames past T when
  // the columns are fitted to T.
  if (g.T < 8 * NB) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = NB - 1; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + c2 + (e & 1) >= g.T) s[m][j][e] = -INFINITY;
  }
  float mx[2 * MT], l[2 * MT], d[2 * MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    mx[2 * m] = mx[2 * m + 1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mx[2 * m] = fmaxf(mx[2 * m], fmaxf(s[m][j][0], s[m][j][1]));
      mx[2 * m + 1] = fmaxf(mx[2 * m + 1], fmaxf(s[m][j][2], s[m][j][3]));
    }
  }
  quad_max_n(mx);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float neg[2] = {-mx[2 * m] * LOG2E, -mx[2 * m + 1] * LOG2E};
    l[2 * m] = l[2 * m + 1] = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[m][j][e] = fast_exp2(fmaf(s[m][j][e], LOG2E, neg[e >> 1]));
        l[2 * m + (e >> 1)] += s[m][j][e];
      }
  }
  quad_sum_n(l);
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) l[i] = __frcp_rn(fmaxf(l[i], 1e-30f));
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    d[2 * m] = d[2 * m + 1] = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[m][j][e] *= l[2 * m + (e >> 1)];
        d[2 * m + (e >> 1)] = fmaf(s[m][j][e], dp[m][j][e], d[2 * m + (e >> 1)]);
      }
  }
  quad_sum_n(d);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[m][j][e] = s[m][j][e] * (dp[m][j][e] - d[2 * m + (e >> 1)]);

  // 3. The bf16 A fragments [row block][k step]: dS for dq (rows i, k over
  // frames j); P^T for dv and dS^T for dk (rows j, k over queries i), each
  // 8x8 block of the accumulators transposed in registers. A frame block
  // past NB holds zeros (as P and dS do there).
  uint32_t pt[MT][MT][4], dst[MT][MT][4], dsa[MT][MT][4];
  if constexpr (NB < 2 * MT) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < MT; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[m][kk][e] = dst[m][kk][e] = dsa[m][kk][e] = 0u;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint32_t ptop = pack_bf16(s[m][j][0], s[m][j][1]);
      const uint32_t pbot = pack_bf16(s[m][j][2], s[m][j][3]);
      const uint32_t dtop = pack_bf16(dp[m][j][0], dp[m][j][1]);
      const uint32_t dbot = pack_bf16(dp[m][j][2], dp[m][j][3]);
      const int hi = j & 1;
      dsa[m][j >> 1][2 * hi] = dtop;
      dsa[m][j >> 1][2 * hi + 1] = dbot;
      pt[j >> 1][m][hi] = trans8x8(ptop);
      pt[j >> 1][m][2 + hi] = trans8x8(pbot);
      dst[j >> 1][m][hi] = trans8x8(dtop);
      dst[j >> 1][m][2 + hi] = trans8x8(dbot);
    }

  // 4. dv = P^T do, dk = dS^T qs, dq = dS k * scale, 32 channels at a time;
  // each lands in a slab whose input is read.
  __syncwarp();   // every lane's S / dP reads are done
  for (int dc = 0; dc < dh; dc += 32) {
    const int nn = NN ? NN : min(4, (dh - dc) >> 3);
    float acc[MT][4][4];
    zero(acc);
    rows_by_cols(acc, pt, O, g.pitch, dc, nn, false, qs2);
    put(V, acc, g.pitch, g.T, dc, nn, 1.f);           // v is not read here
    zero(acc);
    rows_by_cols(acc, dst, Q, g.pitch, dc, nn, true, qs2);
    __syncwarp();                                     // do's channels are read
    put(O, acc, g.pitch, g.T, dc, nn, 1.f);
    zero(acc);
    rows_by_cols(acc, dsa, K, g.pitch, dc, nn, false, qs2);
    __syncwarp();                                     // qs's channels are read
    put(Q, acc, g.pitch, g.T, dc, nn, sc);
  }
}

template <int MT, int NB, int NN>
__global__ void __launch_bounds__(THREADS, NN == 1 ? BLOCKS_DH8 : BLOCKS)
temporal_bwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, const __grid_constant__ Geo g,
                  const __nv_bfloat162 qs2, const float sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  // Unit u of ring slot s at (s * U + u) * unit_bytes: its q, k, v and do
  // slabs, one slot apart.
  auto unit = [&](int s, int u) { return smem + (s * g.U + u) * g.unit_bytes; };

  // Rows past T are zero in every slab, and stay so: neither the loads
  // nor put write them.
  if (g.T < g.rows) {
    const int zc = (g.rows - g.T) * g.pitch / 16;
    for (int i = threadIdx.x; i < 4 * g.ring * g.U * zc; i += THREADS) {
      const int sl = i / zc;
      *reinterpret_cast<uint4*>(smem + sl * g.slot + g.T * g.pitch + (i - sl * zc) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // A unit's [T, W] rows in 16-byte chunks: this thread's first chunk
  // (t0, c0), then a step of THREADS chunks.
  const int t0 = threadIdx.x / g.chunks, c0 = threadIdx.x % g.chunks;
  const int dt = THREADS / g.chunks, dc = THREADS % g.chunks;
  // Element offset of unit n in every tensor.
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
      for (int x = 0; x < 4; ++x) {
        const __nv_bfloat16* src = (x == 0 ? q : x == 1 ? k : x == 2 ? v : dout) + off;
        unsigned char* dst = unit(s, u) + x * g.slot;
        for (int t = t0, c = c0; t < g.T;) {
          cp_async16(dst + t * g.pitch + c * 16, src + (long long)t * g.C + c * 8, true);
          c += dc;
          t += dt;
          if (c >= g.chunks) { c -= g.chunks; ++t; }
        }
      }
    }
  };
  auto store = [&](long long tile, int s) {   // dq, dk, dv from q's, do's and v's slabs
    for (int u = 0; u < g.U; ++u) {
      const long long n = tile * g.U + u;
      if (n >= g.nunits) break;
      const long long off = offset(n);
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        __nv_bfloat16* dst = (x == 0 ? dq : x == 1 ? dk : dv) + off;
        const unsigned char* src = unit(s, u) + (x == 0 ? 0 : x == 1 ? 3 : 2) * g.slot;
        for (int t = t0, c = c0; t < g.T;) {
          *reinterpret_cast<uint4*>(dst + (long long)t * g.C + c * 8) =
              *reinterpret_cast<const uint4*>(src + t * g.pitch + c * 16);
          c += dc;
          t += dt;
          if (c >= g.chunks) { c -= g.chunks; ++t; }
        }
      }
    }
  };
  // Items (unit, head) of the tile, taken by the warps in turn.
  auto compute = [&](long long tile, int s) {
    for (int r = warp; r < g.U * g.G; r += WARPS) {
      const int u = r / g.G;
      if (tile * g.U + u >= g.nunits) break;
      unsigned char* b = unit(s, u) + (r - u * g.G) * g.dh * 2;
      item_bf16<MT, NB, NN>(b, b + g.slot, b + 2 * g.slot, b + 3 * g.slot, g, qs2, sc);
    }
  };

  const long long step = gridDim.x;
  long long tile = blockIdx.x;
  for (int s = 0; s < g.ring; ++s) {
    load(tile + s * step, s);
    cp_async_commit();
  }
  for (int j = 0; tile < g.ntiles; ++j, tile += step) {
    const int s = j % g.ring;
    // Tile j has landed; tile j + 1 may be in flight.
    if (g.ring == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    compute(tile, s);
    __syncthreads();
    store(tile, s);
    __syncthreads();         // the slabs are read before they refill
    load(tile + g.ring * step, s);
    cp_async_commit();
  }
}

int pitch_of(int w) {   // bytes per staged row of w bf16 channels: an odd count of 16 bytes
  const int b = w * 2;
  return (b / 16) % 2 ? b : b + 16;
}

template <int MT, int NB, int NN>
int launch_bf16_tiles(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      void* dk, void* dv, const Geo& g, float scale, cudaStream_t st) {
  const int smem = g.ring * g.U * g.unit_bytes;
  cudaError_t err = cudaFuncSetAttribute(temporal_bwd_bf16<MT, NB, NN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, temporal_bwd_bf16<MT, NB, NN>,
                                                           THREADS, smem)) != cudaSuccess)
    return (int)err;
  const long long grid = std::min<long long>(g.ntiles, (long long)std::max(1, per_sm) * sms);
  temporal_bwd_bf16<MT, NB, NN><<<(unsigned)grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g, __float2bfloat162_rn(scale), scale);
  return (int)cudaGetLastError();
}

// The instance for NB frame-column blocks (MT = 1 up to 2 blocks, else 2).
template <int NN>
int launch_nb(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dv, const Geo& g, int nb, float scale, cudaStream_t st) {
  switch (nb) {
    case 1: return launch_bf16_tiles<1, 1, NN>(q, k, v, dout, dq, dk, dv, g, scale, st);
    case 2: return launch_bf16_tiles<1, 2, NN>(q, k, v, dout, dq, dk, dv, g, scale, st);
    case 3: return launch_bf16_tiles<2, 3, NN>(q, k, v, dout, dq, dk, dv, g, scale, st);
    default: return launch_bf16_tiles<2, 4, NN>(q, k, v, dout, dq, dk, dv, g, scale, st);
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, int P, int T, int H, int dh, float scale, cudaStream_t st) {
  if (dh % 8 || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  Geo g;
  g.T = T;
  g.C = H * dh;
  g.dh = dh;
  const int mt = T > 16 ? 2 : 1;
  g.rows = 16 * mt;
  g.G = 1;
  for (int d = H; d > 1; --d)
    if (H % d == 0 && 4 * g.rows * pitch_of(d * dh) <= STAGE_MAX) { g.G = d; break; }
  g.W = g.G * dh;
  g.ng = H / g.G;
  g.pitch = pitch_of(g.W);
  g.slot = g.rows * g.pitch;
  g.unit_bytes = 4 * g.slot;
  g.nunits = (long long)P * g.ng;
  g.U = (int)std::max<long long>(1, std::min<long long>(STAGE_MAX / g.unit_bytes, g.nunits));
  g.ntiles = (g.nunits + g.U - 1) / g.U;
  g.chunks = g.W / 8;
  // Two tiles, or one where two of one wide head's overfill a block
  // (dh > 440 at T > 16).
  g.ring = 2 * g.U * g.unit_bytes <= BLOCK_SMEM ? 2 : 1;
  const int nb = (T + 7) / 8;
  switch (dh) {   // vits's dh 8 and 24 at a width known to the compiler
    case 8: return launch_nb<1>(q, k, v, dout, dq, dk, dv, g, nb, scale, st);
    case 24: return launch_nb<3>(q, k, v, dout, dq, dk, dv, g, nb, scale, st);
    default: return launch_nb<0>(q, k, v, dout, dq, dk, dv, g, nb, scale, st);
  }
}

// ---- fp32: FMAs ----

constexpr int TMAX = 32;             // frames per window at most
constexpr int CH = 32;               // channels per chunk
constexpr int F_WARPS = 4;           // (pixel, head) pairs per block
constexpr int F_THREADS = F_WARPS * 32;
constexpr int KP = CH;               // broadcast chunk pitch
constexpr int QP = CH + 1;           // per-lane row chunk pitch, odd
constexpr int SP = TMAX + 1;         // P / dS pitch: lane j reads column j
constexpr int WARP_FLOATS = TMAX * KP + TMAX * QP + 2 * TMAX * SP;
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

// s[j] += X[lane] . Y[j] over the chunk's cw channels.
__device__ __forceinline__ void dot_rows(float (&s)[TMAX], const float* X, const float* Y,
                                         int cw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 0; d < CH; d += 4) {
    if (d >= cw) break;   // the chunk's channels past dh are zeros: skip them
    const float x0 = X[lane * QP + d], x1 = X[lane * QP + d + 1];
    const float x2 = X[lane * QP + d + 2], x3 = X[lane * QP + d + 3];
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(Y + j * KP + d);
      s[j] = fmaf(x0, y.x, fmaf(x1, y.y, fmaf(x2, y.z, fmaf(x3, y.w, s[j]))));
    }
  }
}

// X[lane] = mul * sum_j w(j) Y[j] over the chunk, then X's rows out to dst.
template <typename W>
__device__ __forceinline__ void weighted_rows(float* dst, float* X, const float* Y, int nt, int C,
                                              int c0, int cw, float mul, W w) {
  const int lane = threadIdx.x & 31;
  float acc[CH];
#pragma unroll
  for (int d = 0; d < CH; ++d) acc[d] = 0.f;
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    const float wj = w(j);
#pragma unroll
    for (int d = 0; d < CH; d += 4) {
      if (d >= cw) break;
      const float4 y = *reinterpret_cast<const float4*>(Y + j * KP + d);
      acc[d] = fmaf(wj, y.x, acc[d]);
      acc[d + 1] = fmaf(wj, y.y, acc[d + 1]);
      acc[d + 2] = fmaf(wj, y.z, acc[d + 2]);
      acc[d + 3] = fmaf(wj, y.w, acc[d + 3]);
    }
  }
#pragma unroll
  for (int d = 0; d < CH; ++d) X[lane * QP + d] = acc[d] * mul;
  __syncwarp();
  // Coalesced store: lane = channel, one frame row at a time.
  for (int j = 0; j < nt; ++j)
    if (lane < cw) dst[(long long)j * C + c0 + lane] = X[j * QP + lane];
  __syncwarp();
}

__global__ void __launch_bounds__(F_THREADS)
temporal_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int P,
                 int nt, int H, int dh, float scale) {
  extern __shared__ __align__(16) float fsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * F_WARPS + warp;
  if (pair >= (long long)P * H) return;  // no block-wide sync below
  const long long p = pair / H;
  const int h = (int)(pair - p * H);
  const int C = H * dh;
  const long long base = p * nt * C + (long long)h * dh;
  float* Y = fsmem + warp * WARP_FLOATS;   // [TMAX][KP], read as broadcasts
  float* X = Y + TMAX * KP;                // [TMAX][QP], lane t's row t
  float* Pm = X + TMAX * QP;               // [TMAX][SP]: P, row = query
  float* Dm = Pm + TMAX * SP;              // [TMAX][SP]: dS

  float s[TMAX], dp[TMAX];
#pragma unroll
  for (int j = 0; j < TMAX; ++j) s[j] = dp[j] = 0.f;
  for (int c0 = 0; c0 < dh; c0 += CH) {
    const int cw = min(CH, dh - c0);
    load_chunk(Y, KP, k + base, nt, C, c0, cw, 1.f);
    load_chunk(X, QP, q + base, nt, C, c0, cw, scale);
    __syncwarp();
    dot_rows(s, X, Y, cw);
    __syncwarp();
    load_chunk(Y, KP, v + base, nt, C, c0, cw, 1.f);
    load_chunk(X, QP, dout + base, nt, C, c0, cw, 1.f);
    __syncwarp();
    dot_rows(dp, X, Y, cw);
    __syncwarp();
  }

  // Lane-local softmax over the frames; a lane past T keeps P = 0.
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
  const float inv = lane < nt ? 1.f / fmaxf(sum, 1e-30f) : 0.f;
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    s[j] *= inv;
    d = fmaf(s[j], dp[j], d);
  }
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    dp[j] = s[j] * (dp[j] - d);   // dS
    Pm[lane * SP + j] = s[j];
    Dm[lane * SP + j] = dp[j];
  }
  __syncwarp();

  for (int c0 = 0; c0 < dh; c0 += CH) {
    const int cw = min(CH, dh - c0);
    load_chunk(Y, KP, k + base, nt, C, c0, cw, 1.f);
    __syncwarp();
    weighted_rows(dq + base, X, Y, nt, C, c0, cw, scale, [&](int j) { return dp[j]; });
    load_chunk(Y, KP, dout + base, nt, C, c0, cw, 1.f);
    __syncwarp();
    weighted_rows(dv + base, X, Y, nt, C, c0, cw, 1.f, [&](int i) { return Pm[i * SP + lane]; });
    load_chunk(Y, KP, q + base, nt, C, c0, cw, scale);
    __syncwarp();
    weighted_rows(dk + base, X, Y, nt, C, c0, cw, 1.f, [&](int i) { return Dm[i * SP + lane]; });
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. q, k, v, do (dout), dq, dk, dv contiguous
// [P, T, H*dh], T <= 32, 16-byte aligned; bf16 needs dh % 8 == 0 and
// dh <= 512. scale is already rounded to the dtype. Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int vda_temporal_attention_backward(int dtype, const void* q, const void* k,
                                               const void* v, const void* dout, void* dq,
                                               void* dk, void* dv, int P, int T, int H, int dh,
                                               float scale, void* stream) {
  if (T < 1 || T > TMAX || dh < 1 || H < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(q, k, v, dout, dq, dk, dv, P, T, H, dh, scale, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)P * H;
  cudaError_t err = cudaFuncSetAttribute(temporal_bwd_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  temporal_bwd_f32<<<(unsigned)((pairs + F_WARPS - 1) / F_WARPS), F_THREADS, F_SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), P, T, H, dh, scale);
  return (int)cudaGetLastError();
}
