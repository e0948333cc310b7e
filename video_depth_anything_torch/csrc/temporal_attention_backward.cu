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
// which the tensor cores would bind.
//
// Design, bf16: one warp per (pixel, head) item, items pixel-major so that
// a block's warps read neighbouring heads of one pixel's rows. A warp
// stages its item's q, k, v and do into four slabs of shared memory, 64
// channels at a time, with 16-byte cp.async copies (rows past T
// zero-filled; rows padded to an odd number of 16-byte chunks, so ldmatrix
// reads them without bank conflicts), and pre-scales q there in bf16. T
// pads to 16 or 32 rows (MT 16-row blocks). S and dP accumulate over the
// chunks on mma.sync m16n8k16 (m16n8k8 for a last 8 channels) with fp32
// accumulators; the softmax, D and dS stay in registers. P and dS are
// rounded to bf16 only as mma operands: dS as the A fragments of dq
// directly, P^T and dS^T by movmatrix.trans of the accumulator fragments
// (no shared memory round trip). dv, dk and dq run 32 channels at a time
// with qs, k and do as B through ldmatrix.trans, land in the slabs whose
// inputs they no longer need (dv in v's, dk in do's, dq in q's) and leave
// in 16-byte coalesced stores. Over 64 channels (dh 128 at vitl, up to
// 512) the second pass stages q, k and do again, one chunk at a time. A
// simple kernel: no double buffering across items, no wgmma or TMA.
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
constexpr int CW = 64;              // channels per staged chunk
constexpr int MAX_DH = 512;
constexpr float LOG2E = 1.4426950408889634f;

// The geometry of one launch, computed on the host.
struct Geo {
  int T, C, H, dh;
  int rows;         // frames staged: T padded to 16 MT
  int pitch;        // bytes per staged row: the widest chunk, odd count of 16 bytes
  int slab;         // bytes of one tensor's staged chunk: rows * pitch
  long long items;  // P * H
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

// The staged rows of w channels from src (an item's first row at its
// chunk's first channel) into a slab; rows past T are zero-filled.
__device__ __forceinline__ void stage(unsigned char* dst, const __nv_bfloat16* src,
                                      const Geo& g, int w) {
  const int lane = threadIdx.x & 31, nc = w >> 3;
  for (int i = lane; i < g.rows * nc; i += 32) {
    const int r = i / nc, c = i - r * nc;
    const bool ok = r < g.T;
    cp_async16(dst + r * g.pitch + c * 16, src + (long long)(ok ? r : 0) * g.C + c * 8, ok);
  }
}

// The slab's rows [0, T) of w channels out to dst, 16 bytes per lane and copy.
__device__ __forceinline__ void unstage(__nv_bfloat16* dst, const unsigned char* src,
                                        const Geo& g, int w) {
  const int lane = threadIdx.x & 31, nc = w >> 3;
  for (int i = lane; i < g.T * nc; i += 32) {
    const int r = i / nc, c = i - r * nc;
    *reinterpret_cast<uint4*>(dst + (long long)r * g.C + c * 8) =
        *reinterpret_cast<const uint4*>(src + r * g.pitch + c * 16);
  }
}

// q's slab times the scale, rounded to bf16 (the forward's pre-scale).
__device__ __forceinline__ void scale_slab(unsigned char* s, const Geo& g, int w,
                                           __nv_bfloat162 qs2) {
  const int lane = threadIdx.x & 31, nc = w >> 3;
  for (int i = lane; i < g.rows * nc; i += 32) {
    const int r = i / nc, c = i - r * nc;
    uint4* p = reinterpret_cast<uint4*>(s + r * g.pitch + c * 16);
    uint4 x = *p;
    x.x = mul_bf16x2(x.x, qs2);
    x.y = mul_bf16x2(x.y, qs2);
    x.z = mul_bf16x2(x.z, qs2);
    x.w = mul_bf16x2(x.w, qs2);
    *p = x;
  }
}

// s[i-block m][frame block j] += A B^T over w channels: A's and B's rows are
// frames (A's the rows of s, B's its columns).
template <int MT>
__device__ __forceinline__ void rows_by_rows(float (&s)[MT][2 * MT][4], const unsigned char* A,
                                             const unsigned char* B, int pitch, int w) {
  const int lane = threadIdx.x & 31;
  const unsigned char* arow = A + (lane & 15) * pitch;
  int kc = 0;
  for (; kc + 16 <= w; kc += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a[m], arow + m * 16 * pitch + (kc + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int np = 0; np < MT; ++np) {   // frame blocks 2np, 2np + 1
      uint32_t b[4];
      ldsm_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * pitch
                     + (kc + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(s[m][2 * np], a[m], b[0], b[1]);
        mma_bf16(s[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
  if (kc < w) {   // the last 8 channels of a width that is 8 mod 16
    uint32_t a[MT][2], b[2 * MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x2(a[m], arow + m * 16 * pitch + kc * 2);
    if constexpr (MT == 2) ldsm_x4(b, B + lane * pitch + kc * 2);   // frame block j in b[j]
    else ldsm_x2(b, B + (lane & 15) * pitch + kc * 2);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j) mma_k8(s[m][j], a[m], b[j]);
  }
}

// acc[row block][8-channel block n < nn] += a B over channels [dc, dc + 8 nn):
// a holds the A fragments [row block][k step][4]; B's rows are the k index.
template <int MT>
__device__ __forceinline__ void rows_by_cols(float (&acc)[MT][4][4],
                                             const uint32_t (&a)[MT][MT][4],
                                             const unsigned char* B, int pitch, int dc, int nn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    const unsigned char* row = B + (kk * 16 + (lane & 15)) * pitch + dc * 2;
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (2 * np + 1 < nn) {
        uint32_t b[4];
        ldsm_x4_trans(b, row + (np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          mma_bf16(acc[mb][2 * np], a[mb][kk], b[0], b[1]);
          mma_bf16(acc[mb][2 * np + 1], a[mb][kk], b[2], b[3]);
        }
      } else if (2 * np < nn) {
        uint32_t b[2];
        ldsm_x2_trans(b, row + np * 16 * 2);
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) mma_bf16(acc[mb][2 * np], a[mb][kk], b[0], b[1]);
      }
    }
  }
}

// acc * mul, rounded to bf16, into a slab's channels [dc, dc + 8 nn).
template <int MT>
__device__ __forceinline__ void put(unsigned char* S, const float (&acc)[MT][4][4], int pitch,
                                    int dc, int nn, float mul) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mb = 0; mb < MT; ++mb)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n >= nn) break;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(S + (16 * mb + gr + 8 * i) * pitch + (dc + 8 * n + c2) * 2) =
            pack_bf16(acc[mb][n][2 * i] * mul, acc[mb][n][2 * i + 1] * mul);
    }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
}

// One (pixel, head) item: base is the element offset of its first row and
// channel in every tensor. sm holds the warp's four slabs.
template <int MT>
__device__ __forceinline__ void item_bf16(
    unsigned char* sm, const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, long long base, const Geo& g, __nv_bfloat162 qs2,
    float sc) {
  unsigned char *Q = sm, *K = sm + g.slab, *V = sm + 2 * g.slab, *O = sm + 3 * g.slab;
  const int lane = threadIdx.x & 31, c2 = (lane & 3) * 2;
  const int nch = (g.dh + CW - 1) / CW;

  // 1. S = qs k^T and dP = do v^T, over the chunks.
  float s[MT][2 * MT][4], dp[MT][2 * MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][j][e] = dp[m][j][e] = 0.f;
  for (int ci = 0; ci < nch; ++ci) {
    const int c0 = ci * CW, w = min(CW, g.dh - c0);
    if (ci) __syncwarp();   // the last chunk's reads are done before the slabs refill
    stage(Q, q + base + c0, g, w);
    stage(K, k + base + c0, g, w);
    stage(V, v + base + c0, g, w);
    stage(O, dout + base + c0, g, w);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    scale_slab(Q, g, w, qs2);
    __syncwarp();
    rows_by_rows<MT>(s, Q, K, g.pitch, w);
    rows_by_rows<MT>(dp, O, V, g.pitch, w);
  }

  // 2. P = softmax(S) over the frames (rows gr and gr + 8 of each block;
  // frames past T at -inf, frame 0 always there); D = rowsum(P o dP);
  // dS = P o (dP - D). P stays in s, dS goes to dp.
  if (g.T < 16 * MT) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + c2 + (e & 1) >= g.T) s[m][j][e] = -INFINITY;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[m][j][0], s[m][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[m][j][2], s[m][j][3]));
    }
    float l[2] = {0.f, 0.f}, neg[2], d[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) neg[i] = -quad_max(mx[i]) * LOG2E;
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[m][j][e] = fast_exp2(fmaf(s[m][j][e], LOG2E, neg[e >> 1]));
        l[e >> 1] += s[m][j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = __frcp_rn(fmaxf(quad_sum(l[i]), 1e-30f));
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[m][j][e] *= l[e >> 1];
        d[e >> 1] = fmaf(s[m][j][e], dp[m][j][e], d[e >> 1]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) d[i] = quad_sum(d[i]);
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[m][j][e] = s[m][j][e] * (dp[m][j][e] - d[e >> 1]);
  }

  // 3. The bf16 A fragments [row block][k step]: dS for dq (rows i, k over
  // frames j); P^T for dv and dS^T for dk (rows j, k over queries i), each
  // 8x8 block of the accumulators transposed in registers.
  uint32_t pt[MT][MT][4], dst[MT][MT][4], dsa[MT][MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j) {
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

  // 4. dv = P^T do, dk = dS^T qs, dq = dS k * scale, chunk by chunk, 32
  // channels at a time; each lands in a slab whose input is read.
  for (int ci = 0; ci < nch; ++ci) {
    const int c0 = ci * CW, w = min(CW, g.dh - c0);
    if (nch > 1) {   // one chunk: the slabs still hold qs, k and do
      __syncwarp();
      stage(Q, q + base + c0, g, w);
      stage(K, k + base + c0, g, w);
      stage(O, dout + base + c0, g, w);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      scale_slab(Q, g, w, qs2);
      __syncwarp();
    }
    for (int dc = 0; dc < w; dc += 32) {
      const int nn = min(4, (w - dc) >> 3);
      float acc[MT][4][4];
      zero<MT>(acc);
      rows_by_cols<MT>(acc, pt, O, g.pitch, dc, nn);
      put<MT>(V, acc, g.pitch, dc, nn, 1.f);          // v is not read here
      zero<MT>(acc);
      rows_by_cols<MT>(acc, dst, Q, g.pitch, dc, nn);
      __syncwarp();                                    // do's channels are read
      put<MT>(O, acc, g.pitch, dc, nn, 1.f);
      zero<MT>(acc);
      rows_by_cols<MT>(acc, dsa, K, g.pitch, dc, nn);
      __syncwarp();                                    // qs's channels are read
      put<MT>(Q, acc, g.pitch, dc, nn, sc);
    }
    __syncwarp();
    unstage(dv + base + c0, V, g, w);
    unstage(dk + base + c0, O, g, w);
    unstage(dq + base + c0, Q, g, w);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, BLOCKS)
temporal_bwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, const __grid_constant__ Geo g,
                  const __nv_bfloat162 qs2, const float sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  unsigned char* sm = smem + warp * 4 * g.slab;
  // Warps walk the items on their own: no block-wide barrier.
  for (long long n = (long long)blockIdx.x * WARPS + warp; n < g.items;
       n += (long long)gridDim.x * WARPS) {
    const long long px = n / g.H;
    const long long base = px * g.T * g.C + (n - px * g.H) * g.dh;
    item_bf16<MT>(sm, q, k, v, dout, dq, dk, dv, base, g, qs2, sc);
    __syncwarp();   // the stores read the slabs before the next item refills them
  }
}

int pitch_of(int w) {   // bytes per staged row of w bf16 channels: an odd count of 16 bytes
  const int b = w * 2;
  return (b / 16) % 2 ? b : b + 16;
}

template <int MT>
int launch_bf16_mt(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, Geo g, float scale, cudaStream_t st) {
  g.rows = 16 * MT;
  g.slab = g.rows * g.pitch;
  const int smem = WARPS * 4 * g.slab;
  cudaError_t err = cudaFuncSetAttribute(temporal_bwd_bf16<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, temporal_bwd_bf16<MT>,
                                                           THREADS, smem)) != cudaSuccess)
    return (int)err;
  const long long grid = std::min<long long>((g.items + WARPS - 1) / WARPS,
                                             (long long)std::max(1, per_sm) * sms);
  temporal_bwd_bf16<MT><<<(unsigned)grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), g, __float2bfloat162_rn(scale), scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, int P, int T, int H, int dh, float scale, cudaStream_t st) {
  if (dh % 8 || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  Geo g;
  g.T = T;
  g.C = H * dh;
  g.H = H;
  g.dh = dh;
  g.pitch = pitch_of(std::min(dh, CW));
  g.items = (long long)P * H;
  return T > 16 ? launch_bf16_mt<2>(q, k, v, dout, dq, dk, dv, g, scale, st)
                : launch_bf16_mt<1>(q, k, v, dout, dq, dk, dv, g, scale, st);
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
