// Fused ResidualConvUnit of the DPT RefineNet blocks, for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_conv.py fused_rcu (its Pallas
//   body _rcu_kernel).
// Computes, on NHWC x [N, H, W, C] with weights [3, 3, C_out, C_in] (tap,
//   out, in; already in x's dtype) and fp32 biases:
//     a = relu(conv3x3(relu(x)) + b1), zero outside the image, rounded to
//         x's dtype;
//     y = conv3x3(a) + b2 + x, accumulated and added in fp32, rounded once.
//   Both convolutions are stride 1 with zero padding 1; conv2 sees the
//   intermediate zero-padded, not conv1 evaluated on the padding.
//
// Bound on this card: operations. 4*N*H*W*9*C^2 FLOPs against 2*N*H*W*C
// elements moved ((32, 148, 148, 256) bf16: 1.654 TFLOP, 1.672 ms of bf16
// tensor-core time, against 0.214 ms of memory time).
//
// Design: one launch per RCU, the intermediate kept on chip as the TPU
// kernel keeps it in VMEM. Each block (8 warps) owns one (frame, 8 x 16
// output tile) and runs two implicit GEMMs, M = pixels, N = C_out, K =
// 9 * C_in, on mma.sync m16n8k16 bf16 -> fp32 (K1's instruction):
//   conv1 over the 10 x 18 halo region of the tile (180 pixels, padded to
//   192 rows), reading the 12 x 20 x region in 64-channel chunks; its
//   epilogue adds b1, applies relu and the image mask and stores the
//   intermediate in shared memory in bf16 ([180][C + 8]: 95 KB at C = 256);
//   conv2 over the 128 output pixels reading the intermediate, whose
//   epilogue adds b2 and the residual x from device memory.
// Output channels go in passes of 64; the K loop runs over (64-channel
// chunk, tap) stages, each stage's [64 out][64 in] weight tile and each
// chunk's x region arriving by double-buffered cp.async (zero-filled
// outside the image) while the previous stage computes. A fragments are
// ldmatrix rows at each pixel's shifted address (relu(x) applied to the
// fragments); B fragments are the weight tile's rows, [out][in] being the
// "col" operand as it lies. Costs the bound does not count: conv1's halo
// recompute (192 / 128 = 1.5x conv1's products at 8 x 16, 1.25x of the
// whole), and every block re-reading both weight tensors from L2 (2.4 MB
// per block at C = 256). 182 KB of shared memory: one block per SM.
// fp32 (the --fp32 path, correctness only): the same fusion on FMAs with
// no TF32, 4 x 8 output tiles, the whole intermediate in shared memory.
// Not yet: wgmma, TMA, warp specialisation, larger tiles.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace vda;
using bf16 = __nv_bfloat16;

constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90

// ---- bf16: tensor cores ----

constexpr int TH = 8, TW = 16;                      // output tile
constexpr int IH = TH + 2, IW = TW + 2, M1 = IH * IW;  // intermediate: 180 px,
                                                    // 12 m16 tiles (192 rows)
constexpr int XH = TH + 4, XW = TW + 4, XP = XH * XW;  // x region: 240 px
constexpr int NB = 64;                              // output channels per pass
constexpr int KC = 64;                              // input channels per chunk
constexpr int THREADS = 256;                        // 8 warps: 4 (M) x 2 (N)
constexpr int LDX = KC + 8, LDW = KC + 8;           // 144-byte rows
constexpr int XTILE = XP * LDX, WTILE = NB * LDW;

size_t smem_bf16(int C) {
  return ((size_t)M1 * (C + 8) + 2 * XTILE + 2 * WTILE) * sizeof(bf16);
}

struct Args {
  const void* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  void* out;
  int H, W, C;
};

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  x = __hmax2(x, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&x);
}

// Stage s of a conv's K loop: weight tile (tap, output pass, input chunk)
// = w[tap][nb*64 .. +64][kc*64 .. +64] into a [64][LDW] tile.
__device__ __forceinline__ void load_w(bf16* dst, const bf16* w, int s, int C) {
  const int kcn = C / KC;
  const int nb = s / (kcn * 9), kc = (s / 9) % kcn, tap = s % 9;
  const bf16* src = w + ((long long)tap * C + nb * NB) * C + kc * KC;
  for (int idx = threadIdx.x; idx < NB * (KC / 8); idx += THREADS) {
    const int r = idx / (KC / 8), c = (idx % (KC / 8)) * 8;
    cp_async16(dst + r * LDW + c, src + (long long)r * C + c, true);
  }
}

// Channels [kc*64, +64) of the tile's 12 x 20 x region into a [240][LDX]
// tile; pixels outside the image are zero.
__device__ __forceinline__ void load_x(bf16* dst, const bf16* xn, int kc, int oy0,
                                       int ox0, int H, int W, int C) {
  for (int idx = threadIdx.x; idx < XP * (KC / 8); idx += THREADS) {
    const int p = idx / (KC / 8), c = (idx % (KC / 8)) * 8;
    const int gy = oy0 - 2 + p / XW, gx = ox0 - 2 + p % XW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(dst + p * LDX + c,
               ok ? xn + ((long long)gy * W + gx) * C + kc * KC + c : xn, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1) rcu_bf16(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C, LDI = C + 8;
  bf16* Is = reinterpret_cast<bf16*>(smem);   // [M1][LDI] intermediate
  bf16* Xs = Is + M1 * LDI;                    // [2][XTILE] x chunks
  bf16* Ws = Xs + 2 * XTILE;                   // [2][WTILE] weight tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int wm = warp & 3, wn = warp >> 2;       // warp's M group, N half
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const long long plane = (long long)H * W * C;
  const bf16* xn = static_cast<const bf16*>(a.x) + blockIdx.z * plane;
  bf16* on = static_cast<bf16*>(a.out) + blockIdx.z * plane;
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const int kcn = C / KC, stages = (C / NB) * kcn * 9;

  // ---- conv1 over the halo region: warp rows wm*48 .. +48 (3 m-tiles),
  // columns wn*32 .. +32 of the pass (4 n-tiles).
  int xb[3];  // x-region pixel of this lane's A row at tap (0, 0)
#pragma unroll
  for (int mt = 0; mt < 3; ++mt) {
    const int p = min(wm * 48 + mt * 16 + (lane & 15), M1 - 1);  // pad rows: any pixel
    xb[mt] = (p / IW) * XW + p % IW;
  }
  float acc[3][4][4];
#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  load_w(Ws, w1, 0, C);
  load_x(Xs, xn, 0, oy0, ox0, H, W, C);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      load_w(Ws + ((s + 1) & 1) * WTILE, w1, s + 1, C);
      if ((s + 1) % 9 == 0)  // a new (pass, chunk): its x region
        load_x(Xs + (((s + 1) / 9) & 1) * XTILE, xn, ((s + 1) / 9) % kcn, oy0, ox0, H, W, C);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = s % 9, chunk = s / 9;
    const bf16* Xt = Xs + (chunk & 1) * XTILE;
    const bf16* Wt = Ws + (s & 1) * WTILE;
    const int toff = (tap / 3) * XW + tap % 3;
#pragma unroll
    for (int kp = 0; kp < KC / 32; ++kp) {
      uint32_t bf[4][4];  // per n-tile: B fragments of k-steps 2kp, 2kp + 1
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        ldsm_x4(bf[nt], Wt + (wn * 32 + nt * 8 + (lane & 7)) * LDW + kp * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          uint32_t af[4];
          ldsm_x4(af, Xt + (xb[mt] + toff) * LDX + (2 * kp + ks) * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = relu_bf16x2(af[i]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bf[nt][2 * ks], bf[nt][2 * ks + 1]);
        }
      }
    }
    if (tap == 8 && chunk % kcn == kcn - 1) {
      // The pass is complete: b1, relu, zero outside the image, bf16.
      const int co0 = (chunk / kcn) * NB + wn * 32 + c2;
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = wm * 48 + mt * 16 + g + 8 * i;
          if (row >= M1) continue;
          const int gy = oy0 - 1 + row / IW, gx = ox0 - 1 + row % IW;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int co = co0 + nt * 8;
            const float v0 = in ? fmaxf(acc[mt][nt][2 * i] + a.b1[co], 0.f) : 0.f;
            const float v1 = in ? fmaxf(acc[mt][nt][2 * i + 1] + a.b1[co + 1], 0.f) : 0.f;
            *reinterpret_cast<uint32_t*>(Is + row * LDI + co) = pack_bf16(v0, v1);
          }
        }
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
    __syncthreads();  // every warp is done with these buffers before they refill
  }

  // ---- conv2 over the 128 output pixels: warp rows wm*32 .. +32 (2
  // m-tiles), columns wn*32 .. +32 of the pass. The loop's last barrier
  // made the whole intermediate visible.
  int ib[2];  // intermediate pixel of this lane's A row at tap (0, 0)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = wm * 32 + mt * 16 + (lane & 15);
    ib[mt] = (p / TW) * IW + p % TW;
  }
  float acc2[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc2[mt][nt][0] = acc2[mt][nt][1] = acc2[mt][nt][2] = acc2[mt][nt][3] = 0.f;

  load_w(Ws, w2, 0, C);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      load_w(Ws + ((s + 1) & 1) * WTILE, w2, s + 1, C);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = s % 9, chunk = s / 9, kc = chunk % kcn;
    const bf16* Wt = Ws + (s & 1) * WTILE;
    const int toff = (tap / 3) * IW + tap % 3;
#pragma unroll
    for (int kp = 0; kp < KC / 32; ++kp) {
      uint32_t bf[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        ldsm_x4(bf[nt], Wt + (wn * 32 + nt * 8 + (lane & 7)) * LDW + kp * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t af[4];
          ldsm_x4(af, Is + (ib[mt] + toff) * LDI + kc * KC + (2 * kp + ks) * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc2[mt][nt], af, bf[nt][2 * ks], bf[nt][2 * ks + 1]);
        }
      }
    }
    if (tap == 8 && kc == kcn - 1) {
      // The pass is complete: b2 and the residual in fp32, one rounding.
      const int co0 = (chunk / kcn) * NB + wn * 32 + c2;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = wm * 32 + mt * 16 + g + 8 * i;
          const int gy = oy0 + p / TW, gx = ox0 + p % TW;
          if (gy >= H || gx >= W) continue;
          const long long pix = ((long long)gy * W + gx) * C;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int co = co0 + nt * 8;
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xn + pix + co));
            *reinterpret_cast<uint32_t*>(on + pix + co) =
                pack_bf16(acc2[mt][nt][2 * i] + a.b2[co] + r.x,
                          acc2[mt][nt][2 * i + 1] + a.b2[co + 1] + r.y);
          }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc2[mt][nt][0] = acc2[mt][nt][1] = acc2[mt][nt][2] = acc2[mt][nt][3] = 0.f;
    }
    __syncthreads();
  }
}

// ---- fp32: FMAs ----

constexpr int FTH = 4, FTW = 8, FM2 = FTH * FTW;         // output tile: 32 px
constexpr int FIW = FTW + 2, FM1 = (FTH + 2) * FIW;      // intermediate: 60 px
constexpr int FXW = FTW + 4, FXP = (FTH + 4) * FXW;      // x region: 96 px
constexpr int FNB = 64, FKC = 32;                        // pass width, chunk depth
constexpr int LDXF = FKC + 1, LDWF = FNB + 1;            // odd pitches

size_t smem_f32(int C) {
  return ((size_t)FM1 * (C + 1) + FXP * LDXF + FKC * LDWF) * sizeof(float);
}

// w[tap][nb*64 + co][kc*32 + ci] -> Ws[ci][co] (coalesced along ci).
__device__ __forceinline__ void load_w_f32(float* Ws, const float* w, int tap, int nb,
                                           int kc, int C) {
  for (int idx = threadIdx.x; idx < FKC * FNB; idx += THREADS) {
    const int ci = idx % FKC, co = idx / FKC;
    Ws[ci * LDWF + co] = w[((long long)tap * C + nb * FNB + co) * C + kc * FKC + ci];
  }
}

__global__ void __launch_bounds__(THREADS) rcu_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C, LDI = C + 1;
  float* Is = reinterpret_cast<float*>(smem);  // [FM1][LDI] intermediate
  float* Xs = Is + FM1 * LDI;                   // [FXP][LDXF] relu(x) chunk
  float* Ws = Xs + FXP * LDXF;                  // [FKC][LDWF] weight tile

  const int col = threadIdx.x & 63, pg = threadIdx.x >> 6;  // channel, pixel group
  const int oy0 = blockIdx.y * FTH, ox0 = blockIdx.x * FTW;
  const long long plane = (long long)H * W * C;
  const float* xn = static_cast<const float*>(a.x) + blockIdx.z * plane;
  float* on = static_cast<float*>(a.out) + blockIdx.z * plane;
  const float* w1 = static_cast<const float*>(a.w1);
  const float* w2 = static_cast<const float*>(a.w2);

  // conv1: thread owns channel col of the pass at pixels pg + 4 j.
  for (int nb = 0; nb < C / FNB; ++nb) {
    float acc[FM1 / 4];
#pragma unroll
    for (int j = 0; j < FM1 / 4; ++j) acc[j] = 0.f;
    for (int kc = 0; kc < C / FKC; ++kc) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < FXP * FKC; idx += THREADS) {
        const int p = idx / FKC, c = idx % FKC;
        const int gy = oy0 - 2 + p / FXW, gx = ox0 - 2 + p % FXW;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
        Xs[p * LDXF + c] = ok ? fmaxf(xn[((long long)gy * W + gx) * C + kc * FKC + c], 0.f) : 0.f;
      }
      for (int tap = 0; tap < 9; ++tap) {
        __syncthreads();
        load_w_f32(Ws, w1, tap, nb, kc, C);
        __syncthreads();
        const int toff = (tap / 3) * FXW + tap % 3;
        for (int ci = 0; ci < FKC; ++ci) {
          const float wv = Ws[ci * LDWF + col];
#pragma unroll
          for (int j = 0; j < FM1 / 4; ++j) {
            const int p = pg + 4 * j;
            acc[j] = fmaf(Xs[((p / FIW) * FXW + p % FIW + toff) * LDXF + ci], wv, acc[j]);
          }
        }
      }
    }
    const int co = nb * FNB + col;
#pragma unroll
    for (int j = 0; j < FM1 / 4; ++j) {
      const int p = pg + 4 * j;
      const int gy = oy0 - 1 + p / FIW, gx = ox0 - 1 + p % FIW;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      Is[p * LDI + co] = in ? fmaxf(acc[j] + a.b1[co], 0.f) : 0.f;
    }
  }

  // conv2: thread owns channel col of the pass at output pixels pg + 4 j.
  for (int nb = 0; nb < C / FNB; ++nb) {
    float acc[FM2 / 4];
#pragma unroll
    for (int j = 0; j < FM2 / 4; ++j) acc[j] = 0.f;
    for (int kc = 0; kc < C / FKC; ++kc) {
      for (int tap = 0; tap < 9; ++tap) {
        __syncthreads();  // (the first also publishes the intermediate)
        load_w_f32(Ws, w2, tap, nb, kc, C);
        __syncthreads();
        const int toff = (tap / 3) * FIW + tap % 3;
        for (int ci = 0; ci < FKC; ++ci) {
          const float wv = Ws[ci * LDWF + col];
#pragma unroll
          for (int j = 0; j < FM2 / 4; ++j) {
            const int p = pg + 4 * j;
            acc[j] = fmaf(Is[((p / FTW) * FIW + p % FTW + toff) * LDI + kc * FKC + ci], wv, acc[j]);
          }
        }
      }
    }
    const int co = nb * FNB + col;
#pragma unroll
    for (int j = 0; j < FM2 / 4; ++j) {
      const int p = pg + 4 * j;
      const int gy = oy0 + p / FTW, gx = ox0 + p % FTW;
      if (gy >= H || gx >= W) continue;
      const long long i = ((long long)gy * W + gx) * C + co;
      on[i] = acc[j] + a.b2[co] + xn[i];
    }
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. x and out are contiguous NHWC [N, H, W, C],
// w1 and w2 contiguous [3, 3, C, C] (tap, out, in) in x's dtype, b1 and b2
// fp32 [C]. C must be a multiple of 64 whose shared memory fits a block
// (C <= 384 in bf16). Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a C or dtype the kernel does not take); does
// not synchronise.
extern "C" int vda_fused_rcu(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int N, int H,
                             int W, int C, void* stream) {
  if (C <= 0 || C % 64 || N <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
               out, H, W, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = smem_bf16(C);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(rcu_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rcu_bf16<<<dim3((W + TW - 1) / TW, (H + TH - 1) / TH, N), THREADS, smem, st>>>(a);
  } else if (dtype == 0) {
    const size_t smem = smem_f32(C);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(rcu_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rcu_f32<<<dim3((W + FTW - 1) / FTW, (H + FTH - 1) / FTH, N), THREADS, smem, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
