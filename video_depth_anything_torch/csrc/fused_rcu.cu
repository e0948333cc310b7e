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
// tensor-core time, against 0.214 ms of memory time). Costs the bound does
// not count: conv1's halo recompute (192 / 128 rows = 1.5x conv1's
// products at the 8 x 16 tile, 1.25x of the whole), and the weights, which
// every block streams from L2: 2 x 9 x C^2 x 2 B = 2.36 MB per block at
// C = 256, 6080 blocks at 148^2, 14.3 GB per call if each block read its
// own; a cluster of CS = 2 blocks shares each weight tile by one TMA
// multicast, so 7.2 GB.
//
// Design: one launch per RCU, the intermediate kept on chip as the TPU
// kernel keeps it in VMEM. Each block owns one (frame, 8 x 16 output tile)
// and runs two implicit GEMMs, M = pixels, N = C_out, K = 9 * C_in, on
// wgmma bf16 -> fp32 with 3 warpgroups:
//   - a producer thread issues every TMA load: the 12 x 20 x region of a
//     32-channel chunk (a 4D box; pixels outside the image arrive as zeros)
//     into a 2-deep ring, and each (tap, 32-channel) weight tile [NP out]
//     [32 in], 64-byte swizzled as wgmma's B operand wants it, into a ring
//     of up to 16 stages (12 at C = 256) with full / empty mbarriers. The
//     stages are narrow so that the ring is deep: the weight loads' latency
//     from L2, not the products, bounded a 4-deep ring of 64-channel
//     stages (measured, see PERF.md).
//     The two blocks of a cluster (neighbouring frames, same tile) each
//     load half of every weight tile and multicast it to both, so a stage
//     is free only when both blocks' consumers have released it.
//   - two consumer warpgroups. conv1 covers the 10 x 18 halo (180 pixels,
//     three 64-row blocks): warpgroup w takes block w at the full pass
//     width NP and half the columns of block 2. conv2 covers the 128
//     output pixels, one 64-row block each. A (pixels x input channels)
//     is loaded from registers with ldmatrix at each tap's shifted pixel
//     (relu(x) applied in registers for conv1), two stages ahead into a
//     third register buffer while the stage before runs; B comes from the
//     ring by descriptor. conv1's epilogue adds b1, applies relu and the
//     image mask and stores the intermediate in bf16 in shared memory
//     ([180][C + 8]: 95 KB at C = 256); conv2's adds b2 and the residual x
//     from device memory. Nothing in the K loop calls __syncthreads.
// Output channels go in passes of NP = 128 (64 where C % 128 != 0): conv1
// then holds 96 accumulator registers and two A buffers within the 232
// registers a consumer thread gets, and a weight stage is 8 KB.
// fp32 (the --fp32 path, correctness only): the same fusion on FMAs with
// no TF32, 4 x 8 output tiles, the whole intermediate in shared memory.

#include <math.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace vda;
using bf16 = __nv_bfloat16;

constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90

struct Args {
  const void* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  void* out;
  int H, W, C;
};

// ---- bf16: wgmma, TMA, clusters ----

constexpr int TH = 8, TW = 16;                         // output tile: 128 px
constexpr int IH = TH + 2, IW = TW + 2, M1 = IH * IW;  // intermediate: 180 px
constexpr int XH = TH + 4, XW = TW + 4, XP = XH * XW;  // x region: 240 px
constexpr int KC = 32;                                 // input channels per stage
constexpr int SWB = KC * 2;                            // stage rows: 64 B, 64-byte swizzle
constexpr int X_BYTES = XP * SWB;                      // one x chunk: 15 KB
constexpr int CS = 2;                                  // cluster: frames n, n + 1
constexpr int WG_THREADS = 384;                        // consumers 0, 1; producer 2
constexpr int MAX_STAGES = 16;
constexpr int BARS = 4 + 2 * MAX_STAGES;               // x full / empty, w full / empty

size_t smem_wg(int C, int np, int stages) {
  return 1024 + 2 * (size_t)X_BYTES + (size_t)stages * np * SWB +
         (size_t)M1 * (C + 8) * 2 + 8 * BARS;
}

struct alignas(64) RcuParams {
  CUtensorMap x;       // dims (C, W, H, N), box (32, 20, 12, 1)
  CUtensorMap w1, w2;  // dims (C_in, 9 * C_out), box (32, NP / CS)
  Args a;
  int N;               // frames (the grid's z is rounded up to the cluster)
  int stages;          // weight ring depth
};

// A stage's place in a conv's K loop and in the weight ring, advanced one
// stage at a time (no division in the loop).
struct Stage {
  int slot;        // ring slot
  uint32_t phase;  // the slot's fill parity
  int tap, kc;     // tap 0..8, input chunk of KC channels
  int xi;          // x chunks begun (conv1: the x ring's position)
  int pass, step;  // output pass, stage within it
  __device__ __forceinline__ void next(int ws, int kcn, int pass_stages) {
    if (++slot == ws) { slot = 0; phase ^= 1; }
    if (++tap == 9) { tap = 0; ++xi; if (++kc == kcn) kc = 0; }
    if (++step == pass_stages) { step = 0; ++pass; }
  }
};

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  x = __hmax2(x, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int NP>
__global__ void __cluster_dims__(1, 1, CS) __launch_bounds__(WG_THREADS, 1)
    rcu_bf16(const __grid_constant__ RcuParams rp) {
  using namespace hopper;
  constexpr int W_BYTES = NP * SWB;     // one weight stage
  const Args& a = rp.a;
  const int H = a.H, W = a.W, C = a.C, LDI = C + 8, WS = rp.stages;
  const int KCN = C / KC, PASS_STAGES = KCN * 9, NS = (C / NP) * PASS_STAGES;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Xs = base;                          // 2 x [240 px][64 B], swizzled
  unsigned char* Ws = Xs + 2 * X_BYTES;              // WS x [NP][64 B], swizzled
  bf16* Is = reinterpret_cast<bf16*>(Ws + WS * W_BYTES);  // [180][C + 8]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Is + M1 * LDI);
  uint64_t* x_full = bars;
  uint64_t* x_empty = bars + 2;
  uint64_t* w_full = bars + 4;
  uint64_t* w_empty = w_full + MAX_STAGES;

  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW, n = blockIdx.z;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], 2);          // the two consumer warpgroups
    }
    for (int i = 0; i < WS; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], 2 * CS);     // both consumers of every block
    }
    mbar_init_fence();
  }
  cluster_sync();  // peers' barriers exist before any multicast or remote arrive

  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      const uint32_t rank = cluster_rank();
      const uint16_t mask = (1u << CS) - 1;
      int slot = 0, xi = 0;
      uint32_t phase = 0;
      for (int conv = 0; conv < 2; ++conv) {
        const CUtensorMap* wmap = conv ? &rp.w2 : &rp.w1;
        for (int pass = 0; pass < C / NP; ++pass) {
          for (int kc = 0; kc < KCN; ++kc) {
            if (conv == 0) {
              const int xs = xi & 1;
              mbar_wait(&x_empty[xs], ((xi >> 1) & 1) ^ 1);
              mbar_expect_tx(&x_full[xs], X_BYTES);
              tma_load_4d(Xs + xs * X_BYTES, &rp.x, &x_full[xs], kc * KC, ox0 - 2, oy0 - 2, n);
              ++xi;
            }
            for (int tap = 0; tap < 9; ++tap) {
              mbar_wait(&w_empty[slot], phase ^ 1);
              mbar_expect_tx(&w_full[slot], W_BYTES);
              tma_load_2d_multicast(Ws + slot * W_BYTES + rank * (NP / CS) * SWB, wmap,
                                    &w_full[slot], kc * KC,
                                    tap * C + pass * NP + rank * (NP / CS), mask);
              if (++slot == WS) { slot = 0; phase ^= 1; }
            }
          }
        }
      }
      // Every stage has been released by every consumer of the cluster:
      // nothing remote touches this block after this.
      for (int i = 0; i < WS; ++i) {
        mbar_wait(&w_empty[slot], phase ^ 1);
        if (++slot == WS) { slot = 0; phase ^= 1; }
      }
    }
    return;
  }

  // ---- consumers ----
  regs_alloc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, c2 = (lane & 3) * 2;   // accumulator row, column pair
  const int hi = lane >> 4;                         // ldmatrix: second 8 columns
  const bool leader = tid == 0;
  const uint32_t x_addr = smem_u32(Xs), w_addr = smem_u32(Ws), i_addr = smem_u32(Is);

  auto w_desc = [&](const Stage& st, int row0, int ks) {   // B: rows row0.., k step ks
    return make_desc(w_addr + st.slot * W_BYTES + row0 * SWB + ks * 32, SWB, 16, 8 * SWB);
  };
  // The stage's weight slot is free in every block of the cluster; after
  // the last tap of a conv1 chunk, so is the chunk's x slot.
  auto release = [&](const Stage& st, bool conv1) {
    if (!leader) return;
#pragma unroll
    for (int r = 0; r < CS; ++r) mbar_arrive_cluster(&w_empty[st.slot], r);
    if (conv1 && st.tap == 8) mbar_arrive(&x_empty[st.xi & 1]);
  };
  auto fence_frags = [&](uint32_t (&r4)[2][4]) {   // one stage's two k steps
    fence_regs(r4[0]);
    fence_regs(r4[1]);
  };

  // ---- conv1 over the halo: block wg at width NP, half of block 2 ----
  Stage cur{0, 0, 0, 0, 0, 0, 0};
  {
    const int ra = wg * 64 + warp * 16 + (lane & 15);
    const int rb = min(128 + warp * 16 + (lane & 15), M1 - 1);   // pad rows: any pixel
    const int xa = (ra / IW) * XW + ra % IW, xb = (rb / IW) * XW + rb % IW;
    float acc_a[NP / 2], acc_b[NP / 4];
    uint32_t fa[3][2][4], fb[3][2][4];   // A fragments (2 k steps), three stage buffers

    // x rows are 64 B with the 64-byte swizzle: 16-byte chunk c of pixel p
    // sits at chunk c ^ ((p >> 1) & 3).
    auto load_a = [&](uint32_t (&ra4)[2][4], uint32_t (&rb4)[2][4], const Stage& st) {
      const int xs = st.xi & 1;
      if (st.tap == 0) mbar_wait(&x_full[xs], (st.xi >> 1) & 1);
      const uint32_t xbase = x_addr + xs * X_BYTES;
      const int toff = (st.tap / 3) * XW + st.tap % 3;
      const int pa = xa + toff, pb = xb + toff;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        ldsm_x4(ra4[ks], xbase + pa * SWB + (((2 * ks + hi) ^ ((pa >> 1) & 3)) << 4));
        ldsm_x4(rb4[ks], xbase + pb * SWB + (((2 * ks + hi) ^ ((pb >> 1) & 3)) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ra4[ks][i] = relu_bf16x2(ra4[ks][i]);
          rb4[ks][i] = relu_bf16x2(rb4[ks][i]);
        }
      }
    };
    // The pass is complete: b1, relu, zero outside the image, bf16.
    auto epilogue = [&](int pass) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wg * 64 + warp * 16 + g8 + 8 * i;
        const int gy = oy0 - 1 + row / IW, gx = ox0 - 1 + row % IW;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int co = pass * NP + j * 8 + c2;
          const float2 bb = *reinterpret_cast<const float2*>(a.b1 + co);
          const float v0 = in ? fmaxf(acc_a[4 * j + 2 * i] + bb.x, 0.f) : 0.f;
          const float v1 = in ? fmaxf(acc_a[4 * j + 2 * i + 1] + bb.y, 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(Is + row * LDI + co) = pack_bf16(v0, v1);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 128 + warp * 16 + g8 + 8 * i;
        if (row >= M1) continue;
        const int gy = oy0 - 1 + row / IW, gx = ox0 - 1 + row % IW;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NP / 16; ++j) {
          const int co = pass * NP + wg * (NP / 2) + j * 8 + c2;
          const float2 bb = *reinterpret_cast<const float2*>(a.b1 + co);
          const float v0 = in ? fmaxf(acc_b[4 * j + 2 * i] + bb.x, 0.f) : 0.f;
          const float v1 = in ? fmaxf(acc_b[4 * j + 2 * i + 1] + bb.y, 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(Is + row * LDI + co) = pack_bf16(v0, v1);
        }
      }
    };
    Stage prev = cur, nx1 = cur;
    nx1.next(WS, KCN, PASS_STAGES);
    bool pending = false;   // prev is done but not yet released
    // Stage s runs from buffer s % 3 while the fragments of stage s + 2 are
    // loaded into the buffer stage s - 1 has just freed.
    auto step = [&](auto buf, int s) {
      constexpr int B = decltype(buf)::value, F = (B + 2) % 3;
      mbar_wait(&w_full[cur.slot], cur.phase);
      const int first = cur.step == 0;
      // The accumulators are not fenced here: the previous stage's products
      // into them may still run (wgmma orders a chain on one accumulator).
      fence_frags(fa[B]);
      fence_frags(fb[B]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int acc = !(first && ks == 0);
        wgmma_rs<NP, 0>(acc_a, fa[B][ks], w_desc(cur, 0, ks), acc);
        wgmma_rs<NP / 2, 0>(acc_b, fb[B][ks], w_desc(cur, wg * (NP / 2), ks), acc);
      }
      wgmma_commit();
      // The accumulators are read only on the path that waited for all.
      if (cur.step == PASS_STAGES - 1) {
        wgmma_wait<0>();
        fence_regs(acc_a);
        fence_regs(acc_b);
        fence_frags(fa[B]);
        fence_frags(fb[B]);
        fence_frags(fa[F]);
        fence_frags(fb[F]);
        if (pending) release(prev, true);
        release(cur, true);
        pending = false;
        epilogue(cur.pass);
      } else {
        wgmma_wait<1>();
        fence_frags(fa[F]);      // the previous stage's fragments are free from here
        fence_frags(fb[F]);
        if (pending) release(prev, true);
        pending = true;
      }
      Stage nx2 = nx1;
      nx2.next(WS, KCN, PASS_STAGES);
      if (s + 2 < NS) load_a(fa[F], fb[F], nx2);
      prev = cur;
      cur = nx1;
      nx1 = nx2;
    };

    load_a(fa[0], fb[0], cur);
    load_a(fa[1], fb[1], nx1);   // a conv has 9 or more stages
#pragma unroll 1
    for (int s = 0; s < NS; s += 3) {   // NS is a multiple of 9
      step(std::integral_constant<int, 0>(), s);
      step(std::integral_constant<int, 1>(), s + 1);
      step(std::integral_constant<int, 2>(), s + 2);
    }
  }
  named_sync(1, 256);   // the whole intermediate is in shared memory

  // ---- conv2 over the 128 output pixels: block wg at width NP ----
  {
    cur.tap = cur.kc = cur.xi = cur.pass = cur.step = 0;   // the ring runs on
    const int ro = wg * 64 + warp * 16 + (lane & 15);
    const int io = (ro / TW) * IW + ro % TW;   // intermediate pixel at tap (0, 0)
    float acc[NP / 2];
    uint32_t fa[3][2][4];
    const bf16* xn = static_cast<const bf16*>(a.x) + (long long)n * H * W * C;
    bf16* on = static_cast<bf16*>(a.out) + (long long)n * H * W * C;

    auto load_a = [&](uint32_t (&r4)[2][4], const Stage& st) {
      const int pix = io + (st.tap / 3) * IW + st.tap % 3;
      const uint32_t row = i_addr + (pix * LDI + st.kc * KC + hi * 8) * 2;
      ldsm_x4(r4[0], row);
      ldsm_x4(r4[1], row + 32);
    };
    // The pass is complete: b2 and the residual in fp32, one rounding.
    auto epilogue = [&](int pass) {
      if (n >= rp.N) return;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = wg * 64 + warp * 16 + g8 + 8 * i;
        const int gy = oy0 + p / TW, gx = ox0 + p % TW;
        if (gy >= H || gx >= W) continue;
        const long long pix = ((long long)gy * W + gx) * C;
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int co = pass * NP + j * 8 + c2;
          const float2 bb = *reinterpret_cast<const float2*>(a.b2 + co);
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xn + pix + co));
          *reinterpret_cast<uint32_t*>(on + pix + co) =
              pack_bf16(acc[4 * j + 2 * i] + bb.x + r.x, acc[4 * j + 2 * i + 1] + bb.y + r.y);
        }
      }
    };
    Stage prev = cur, nx1 = cur;
    nx1.next(WS, KCN, PASS_STAGES);
    bool pending = false;
    auto step = [&](auto buf, int s) {
      constexpr int B = decltype(buf)::value, F = (B + 2) % 3;
      mbar_wait(&w_full[cur.slot], cur.phase);
      const int first = cur.step == 0;
      fence_frags(fa[B]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_rs<NP, 0>(acc, fa[B][ks], w_desc(cur, 0, ks), !(first && ks == 0));
      wgmma_commit();
      if (cur.step == PASS_STAGES - 1) {
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(fa[B]);
        fence_frags(fa[F]);
        if (pending) release(prev, false);
        release(cur, false);
        pending = false;
        epilogue(cur.pass);
      } else {
        wgmma_wait<1>();
        fence_frags(fa[F]);
        if (pending) release(prev, false);
        pending = true;
      }
      Stage nx2 = nx1;
      nx2.next(WS, KCN, PASS_STAGES);
      if (s + 2 < NS) load_a(fa[F], nx2);
      prev = cur;
      cur = nx1;
      nx1 = nx2;
    };

    load_a(fa[0], cur);
    load_a(fa[1], nx1);
#pragma unroll 1
    for (int s = 0; s < NS; s += 3) {
      step(std::integral_constant<int, 0>(), s);
      step(std::integral_constant<int, 1>(), s + 1);
      step(std::integral_constant<int, 2>(), s + 2);
    }
  }
}

// ---- fp32: FMAs ----

constexpr int THREADS = 256;

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

// The weight ring's depth for the bf16 kernel at C and pass width np (0 if
// no ring of two stages fits beside the intermediate).
static int rcu_stages(int C, int np) {
  const long room = SMEM_MAX - (long)smem_wg(C, np, 0);
  const long st = room / (np * SWB);
  return st < 2 ? 0 : (st > MAX_STAGES ? MAX_STAGES : (int)st);
}

template <int NP>
static int launch_bf16(const Args& a, int N, cudaStream_t st) {
  const int C = a.C, stages = rcu_stages(C, NP);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  RcuParams rp;
  rp.a = a;
  rp.N = N;
  rp.stages = stages;
  const uint64_t xdims[4] = {(uint64_t)C, (uint64_t)a.W, (uint64_t)a.H, (uint64_t)N};
  const int64_t xstr[3] = {C, (int64_t)a.W * C, (int64_t)a.H * a.W * C};
  const uint32_t xbox[4] = {KC, XW, XH, 1};
  const uint64_t wdims[2] = {(uint64_t)C, (uint64_t)9 * C};
  const int64_t wstr[1] = {C};
  const uint32_t wbox[2] = {KC, NP / CS};
  if (!hopper::make_map(&rp.x, a.x, 4, xdims, xstr, xbox, SWB) ||
      !hopper::make_map(&rp.w1, a.w1, 2, wdims, wstr, wbox, SWB) ||
      !hopper::make_map(&rp.w2, a.w2, 2, wdims, wstr, wbox, SWB))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_wg(C, NP, stages);
  cudaError_t err = cudaFuncSetAttribute(rcu_bf16<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, (N + CS - 1) / CS * CS);
  rcu_bf16<NP><<<grid, WG_THREADS, smem, st>>>(rp);
  return (int)cudaGetLastError();
}

// dtype: 0 = fp32, 1 = bf16. x and out are contiguous NHWC [N, H, W, C],
// w1 and w2 contiguous [3, 3, C, C] (tap, out, in) in x's dtype, b1 and b2
// fp32 [C]. C must be a multiple of 64 whose shared memory fits a block
// (C <= 384 in bf16). Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a C or dtype the kernel does not take, or a
// tensor map cuTensorMapEncodeTiled refuses); does not synchronise.
extern "C" int vda_fused_rcu(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int N, int H,
                             int W, int C, void* stream) {
  if (C <= 0 || C % 64 || N <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
               out, H, W, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return C % 128 == 0 ? launch_bf16<128>(a, N, st) : launch_bf16<64>(a, N, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_f32(C);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rcu_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  rcu_f32<<<dim3((W + FTW - 1) / FTW, (H + FTH - 1) / FTH, N), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
