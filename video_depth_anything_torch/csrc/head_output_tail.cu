// The head's output tail for Hopper (sm_90a): kernel K7.
//
// Replaces: no TPU kernel. The JAX package leaves this stage to XLA, which
//   fuses its mixed island (models/dpt.py::output_head); the port ran it as
//   two einsums, a cuDNN conv and PyTorch's elementwise kernels, through
//   full-resolution maps in device memory.
// Computes, from output_conv1's NHWC map x [N, h, w, C] bf16, the depth
//   out [N, H, W] fp32:
//     u = the bilinear align-corners upsample of x to H x W: rows first,
//         then columns, each output row or column the two taps (lo, lo + 1)
//         of the interpolation matrix with its bf16 weights, the two
//         products summed in fp32 and rounded to bf16 (ops/resize.py's two
//         einsums);
//     a = bf16(relu(conv3x3(u, w1) + b1)): C -> 32, fp32 accumulation, zero
//         padding, the bias added to the fp32 accumulator;
//     out = relu(sum_k a_k * w2_k + b2) in fp32.
//
// Bound on this card: operations. 2 * 9 * C * 32 FLOPs per output pixel
//   (a vitl window, 32 x 518 x 924 px at C 128: 1.13 TFLOP, 1.14 ms of bf16
//   tensor-core time) against one read of x and one write of out (1.28 GB
//   and 61 MB: 0.40 ms). Costs the bound does not count: the upsample (the
//   column pass on the tensor cores, +21 % products; the row pass on the
//   CUDA cores), the conv's halo (10 rows of 64 columns for 8 x 62 output
//   pixels) and shared-memory bandwidth: N = 32 gives a wgmma little work
//   for the operands it reads, so shared memory, which both sides use, is
//   the resource to spare.
//
// Design: persistent blocks, one per SM, each walking output tiles of
//   TW x TH = 62 x 8 pixels (tiles in order x, y, frame; block b takes
//   tiles b, b + grid, ...), so the weights are loaded once per block. No
//   full-resolution map leaves the SM. Per tile, input channels go in
//   chunks of KC (32, or 16 where C % 32 != 0) through two A buffers, each
//   the tile's halo (TH + 2 rows x 64 columns, zero outside the image) in
//   [KC / 8][row][HP pixels][8 channels]. Warpgroups are specialised:
//   - warpgroups 2 and 3 (256 threads) fill the A buffers. One thread
//     loads a chunk's source patch (the rows and columns of x the halo
//     interpolates from, box SBH x SBW x KC, zero outside x) by TMA two
//     chunks ahead into a ring of two slots, KC*2-byte swizzled. The row
//     pass (CUDA cores) interpolates the patch's columns at the halo's rows
//     into R, each thread walking a source column down the rows with its
//     two taps in registers. The column pass runs on the tensor cores: per
//     halo row, U (64 columns x KC) = the tile's interpolation weights
//     (64 x 48: two nonzeros a row, from registers) x R's row (48 x KC,
//     channels contiguous: an MN-major B), fp32 sums rounded to bf16;
//   - warpgroups 0 and 1 own RPW = TH / 2 output rows of 64 pixels each
//     (M = 64, N = 32, K = 9 * KC per chunk). A fragment of 64 halo
//     pixels x 16 channels, loaded once by ldmatrix, is the A operand (from
//     registers) of the up to 3 taps (dy, dx) that read it, one wgmma per
//     output row; B, the tap's weights, comes from shared memory by
//     descriptor. The A buffer is free once its last fragment is loaded
//     (full / empty mbarriers); after a tile's last chunk the warpgroup
//     adds b1, applies relu, rounds to bf16, takes the fp32 dot with w2
//     over a quad's 32 columns (shuffles), adds b2, applies relu and stores
//     fp32 for the first 62 of its 64 pixels.
//   Alternatives measured on an H100 (a vitl window): every warpgroup
//   doing both jobs, 6.2 ms (issuing 72 small wgmmas kept a warpgroup as
//   long as they ran); specialised, 5.2; A from shared memory per tap (3 KB
//   a wgmma), 4.9; fragments reused over dy, 3.7; this design, 3.1-3.3.
// TH = 8 (RPW 4) where it fits in shared memory beside the weights, else
// TH = 4 (RPW 2: vitg's C 192). Needs an upsample of at least 1.5x (the
// model's is 1.75x), so a tile's source patch is at most 48 columns wide
// and its taps rise by at most one a row or column.

#include <math.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace vda;

constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90
constexpr int HWD = 64;           // halo width: one wgmma M block of the column pass
constexpr int TW = HWD - 2;       // output tile width (the conv's M block of 64, 62 kept)
constexpr int HP = HWD + 3;       // a halo row's pixels in an A buffer (the conv reads 66)
constexpr int RW = 48;            // R's row: the source box's columns, K of the column pass
constexpr int NOUT = 32;          // output_conv2's 3x3 width
constexpr int THREADS = 512;      // warpgroups 0, 1: products; 2, 3: TMA, upsample
constexpr int UP = 256;           // upsample threads
constexpr int MMA_REGS = 152, UP_REGS = 104;   // registers a thread: 256 x (152 + 104) = 64 K

struct alignas(64) TailParams {
  CUtensorMap x;        // dims (C, w, h, N), box (KC, SBW, SBH, 1)
  const void* w1;       // [9][C / 8][32][8] bf16: tap, channel group, out, channel
  const float* b1;      // [32]
  const float* w2;      // [32]
  const float* b2;      // [1]
  const float4* rows;   // [H]: lo (int32 bits), weight of lo, weight of lo + 1, 0
  const float4* cols;   // [W]
  float* out;           // [N, H, W]
  int H, W, C;
  int sbh, sbw;         // the source box
  int tiles_y, tiles_x, tiles;
  uint32_t sbw_magic;   // i / sbw == (i * sbw_magic) >> 20 for every index used
};

template <int KC, int RPW>
struct Cfg {
  static constexpr int TH = 2 * RPW;           // output rows of a tile
  static constexpr int HH = TH + 2;            // halo rows
  static constexpr int P = HH * HP;            // an A buffer's pixels (halo rows of HP)
  static constexpr int G8 = KC / 8;            // 16-byte channel groups of a chunk
  static constexpr int SWB = 2 * KC;           // a source pixel's bytes = its swizzle
  static constexpr int A_BYTES = G8 * P * 16;
};

__host__ __device__ constexpr size_t align1k(size_t b) { return (b + 1023) & ~size_t(1023); }

// The shared-memory layout: two source slots (1024-byte aligned for their
// swizzle), the weights, two A buffers, R, six barriers.
template <int KC, int RPW>
struct Layout {
  size_t s, w, a, r;
  __host__ __device__ Layout(int C, int sbh, int sbw)
      : s(align1k((size_t)sbh * sbw * Cfg<KC, RPW>::SWB)),
        w((size_t)576 * C),
        a((size_t)Cfg<KC, RPW>::A_BYTES),
        r((size_t)Cfg<KC, RPW>::G8 * Cfg<KC, RPW>::HH * RW * 16) {}
  __host__ __device__ size_t bytes() const { return 1024 + 2 * s + w + 2 * a + r + 48; }
};

// Byte offset of 16-byte channel group g of pixel p in a source slot that
// TMA wrote with a (2 * KC)-byte swizzle (the slot is 1024-byte aligned).
template <int SWB>
__device__ __forceinline__ int swz(int p, int g) {
  return p * SWB + ((g ^ ((p * SWB >> 7) & (SWB / 16 - 1))) << 4);
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Two bf16 pairs interpolated: bf16(w0 * a + w1 * b), the products exact
// in fp32, one fp32 rounding of their sum.
__device__ __forceinline__ uint32_t lerp2(uint32_t a, uint32_t b, float w0, float w1) {
  return pack_bf16(fmaf(w1, bf_lo(b), w0 * bf_lo(a)), fmaf(w1, bf_hi(b), w0 * bf_hi(a)));
}

__device__ __forceinline__ uint4 lerp8(uint4 a, uint4 b, float w0, float w1) {
  return make_uint4(lerp2(a.x, b.x, w0, w1), lerp2(a.y, b.y, w0, w1),
                    lerp2(a.z, b.z, w0, w1), lerp2(a.w, b.w, w0, w1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A descriptor of a K-major bf16 tile with no swizzle: 8 x 16-byte core
// matrices, lbo between the two along K, sbo between those along M (N).
__device__ __forceinline__ uint64_t desc_plain(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

struct Tile {
  int n, y0, x0;
};

template <int KC, int RPW>
__global__ void __launch_bounds__(THREADS, 1) tail_bf16(const __grid_constant__ TailParams p) {
  using namespace hopper;
  using K = Cfg<KC, RPW>;
  constexpr int TH = K::TH, HH = K::HH, P = K::P, G8 = K::G8, SWB = K::SWB;
  const int C = p.C, KCN = C / KC, sbw = p.sbw;
  const Layout<KC, RPW> L(C, p.sbh, sbw);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g8 = lane >> 2, c2 = (lane & 3) * 2;   // a wgmma fragment's row, column pair

  extern __shared__ unsigned char smem_raw[];
  // Offsets from smem_raw itself, so every access below stays a shared one.
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* Ss = smem_raw + (((raw + 1023) & ~1023u) - raw);   // 2 x [SBH][SBW][KC], swizzled
  unsigned char* Ws = Ss + 2 * L.s;            // [9][C / 8][32][8] bf16
  unsigned char* As = Ws + L.w;                // 2 x [G8][HH][HP][8] bf16
  unsigned char* Rs = As + 2 * L.a;            // [G8][HH][RW][8] bf16
  uint64_t* bars = reinterpret_cast<uint64_t*>(Rs + L.r);
  uint64_t* s_full = bars;        // a source slot has landed (TMA)
  uint64_t* a_full = bars + 2;    // an A buffer is written (every upsample thread)
  uint64_t* a_empty = bars + 4;   // an A buffer is read (every product thread)

  const int ntiles = p.tiles > (int)blockIdx.x ? (p.tiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int G = ntiles * KCN;   // this block's chunks

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s_full[i], 1);
      mbar_init(&a_full[i], UP);
      mbar_init(&a_empty[i], THREADS - UP);
    }
    mbar_init_fence();
  }
  {
    const int4* src = static_cast<const int4*>(p.w1);
    int4* dst = reinterpret_cast<int4*>(Ws);
    for (int i = tid; i < 36 * C; i += THREADS) dst[i] = src[i];   // 576 C bytes
    // A's pixels past the column pass's 64 and R's columns past the box
    // are read (times zero, or for outputs not kept) and never written.
    int4* zero = reinterpret_cast<int4*>(As);
    for (int i = tid; i < (int)((2 * L.a + L.r) / 16); i += THREADS) zero[i] = make_int4(0, 0, 0, 0);
  }
  fence_async_smem();
  __syncthreads();
  if (G == 0) return;

  auto tile_of = [&](int j) {   // the tile of chunk j
    const int t = blockIdx.x + (j / KCN) * gridDim.x;
    const int tx = t % p.tiles_x, r = t / p.tiles_x;
    return Tile{r / p.tiles_y, (r % p.tiles_y) * TH, tx * TW};
  };

  if (wg >= 2) {
    // ---- TMA and upsample: warpgroups 2 and 3 ----
    regs_dealloc<UP_REGS>();
    const int ut = tid - (THREADS - UP), uwg = wg - 2;
    auto origin = [&](const Tile& t) {   // the source patch's first column, row
      return make_int2(__float_as_int(p.cols[max(t.x0 - 1, 0)].x),
                       __float_as_int(p.rows[max(t.y0 - 1, 0)].x));
    };
    auto load_source = [&](int j) {   // one thread
      const Tile t = tile_of(j);
      const int2 o = origin(t);
      mbar_expect_tx(&s_full[j & 1], p.sbh * sbw * SWB);
      tma_load_4d(Ss + (j & 1) * L.s, &p.x, &s_full[j & 1], (j % KCN) * KC, o.x, o.y, t.n);
    };
    // The column pass's A operand, this warp's 16 halo columns x RW source
    // columns: the interpolation weights (w0 at lo - o.x, w1 at lo + 1 - o.x,
    // zero elsewhere and outside the image), in wgmma's fragment layout.
    uint32_t mc[RW / 16][4];
    auto weights = [&](const Tile& t, int ox) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = t.x0 - 1 + warp * 16 + g8 + 8 * i;
        const float4 tb = __ldg(&p.cols[min(max(x, 0), p.W - 1)]);
        const int c = __float_as_int(tb.x) - ox;
        const bool in = x >= 0 && x < p.W;
#pragma unroll
        for (int kk = 0; kk < RW / 16; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 16 * kk + 8 * h + c2;
            const float v0 = !in ? 0.f : k == c ? tb.y : k == c + 1 ? tb.z : 0.f;
            const float v1 = !in ? 0.f : k + 1 == c ? tb.y : k + 1 == c + 1 ? tb.z : 0.f;
            mc[kk][i + 2 * h] = pack_bf16(v0, v1);   // exact: the weights are bf16
          }
        }
      }
    };
    if (ut == 0) {
      load_source(0);
      if (G > 1) load_source(1);
    }
    const uint32_t r_addr = smem_u32(Rs), a_addr = smem_u32(As);
#pragma unroll 1
    for (int j = 0; j < G; ++j) {
      const Tile t = tile_of(j);
      const int2 o = origin(t);
      const unsigned char* S = Ss + (j & 1) * L.s;
      if (j % KCN == 0) weights(t, o.x);
      mbar_wait(&s_full[j & 1], (j >> 1) & 1);
      named_sync(1, UP);   // R is free: chunk j - 1's column pass has read it
      // Row pass: the patch's columns at the halo's rows; items (g, sc), each
      // walking the HH rows, whose first tap rises by 0 or 1 a row (an
      // upsample), so each source row is read once. Rows outside the image
      // take the nearest one's taps; the column pass stores zeros there.
      for (int i = ut; i < G8 * sbw; i += UP) {
        const int g = (int)(((uint32_t)i * p.sbw_magic) >> 20), sc = i - g * sbw;
        uint4* R = reinterpret_cast<uint4*>(Rs) + g * HH * RW + sc;
        uint4 lo, hi;
        int prev = 0;
#pragma unroll
        for (int yy = 0; yy < HH; ++yy) {
          const float4 tb = __ldg(&p.rows[min(max(t.y0 - 1 + yy, 0), p.H - 1)]);
          const int ry = __float_as_int(tb.x) - o.y;
          if (yy == 0) lo = *reinterpret_cast<const uint4*>(S + swz<SWB>(ry * sbw + sc, g));
          else if (ry != prev) lo = hi;
          hi = *reinterpret_cast<const uint4*>(S + swz<SWB>((ry + 1) * sbw + sc, g));
          prev = ry;
          R[yy * RW] = lerp8(lo, hi, tb.y, tb.z);
        }
      }
      fence_async_smem();
      named_sync(1, UP);   // R is complete, the source slot read
      if (ut == 0 && j + 2 < G) load_source(j + 2);
      if (j >= 2) mbar_wait(&a_empty[j & 1], ((j >> 1) - 1) & 1);
      // Column pass on the tensor cores: per halo row yy, U (64 halo columns
      // x KC) = the weights (64 x RW) x R's row (RW x KC, channels
      // contiguous: B is MN-major), fp32 sums of the two nonzero products,
      // rounded to bf16 into the A buffer; zero on rows outside the image.
      // Warpgroup uwg takes rows uwg, uwg + 2, ... (HH is even), two in flight.
      const uint32_t abuf = a_addr + (j & 1) * (uint32_t)L.a;
      float acc[2][KC / 2];
      auto rows_issue = [&](float (&d)[KC / 2], int yy) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RW / 16; ++kk)
          wgmma_rs<KC, 1>(d, mc[kk], desc_plain(r_addr + (uint32_t)((yy * RW + 16 * kk) * 16),
                                                128, HH * RW * 16), kk > 0);
        wgmma_commit();
      };
      auto rows_store = [&](float (&d)[KC / 2], int yy) {
        const int y = t.y0 - 1 + yy;
        const bool in = y >= 0 && y < p.H;
#pragma unroll
        for (int jj = 0; jj < G8; ++jj) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = warp * 16 + g8 + 8 * i;
            const uint32_t v = in ? pack_bf16(d[4 * jj + 2 * i], d[4 * jj + 2 * i + 1]) : 0u;
            asm volatile("st.shared.b32 [%0], %1;\n"
                         :: "r"(abuf + (uint32_t)(((jj * HH + yy) * HP + x) * 16 + c2 * 2)),
                            "r"(v) : "memory");
          }
        }
      };
      rows_issue(acc[0], uwg);
#pragma unroll
      for (int k = 0; k < HH / 2; ++k) {
        if (k + 1 < HH / 2) {
          rows_issue(acc[(k + 1) & 1], uwg + 2 * (k + 1));
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(acc[k & 1]);
        rows_store(acc[k & 1], uwg + 2 * k);
      }
      fence_async_smem();
      mbar_arrive(&a_full[j & 1]);
    }
    return;
  }

  // ---- products and epilogue: warpgroups 0 and 1, RPW output rows each ----
  regs_alloc<MMA_REGS>();
  float b1r[8], w2r[8];   // this thread's 8 columns of b1 and w2
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b1r[2 * j] = p.b1[8 * j + c2];
    b1r[2 * j + 1] = p.b1[8 * j + c2 + 1];
    w2r[2 * j] = p.w2[8 * j + c2];
    w2r[2 * j + 1] = p.w2[8 * j + c2 + 1];
  }
  const float b2 = p.b2[0];
  float acc[RPW][16] = {};
  // Chunk j's products, in steps (halo row hr, dx, k step ks): one A fragment
  // (64 pixels x 16 channels, ldmatrix from the A buffer) serves the taps
  // (dy, dx) of the up to 3 output rows hr - dy, so each halo row is read
  // from shared memory once per dx, not once per tap; B (the tap's weights)
  // by descriptor. A ring of NB fragments, NB - 2 steps' products in flight.
  constexpr int KS = KC / 16, STEPS = (RPW + 2) * 3 * KS, NB = 4;
  uint32_t fa[NB][4];
  const uint32_t w_addr = smem_u32(Ws);
  const uint32_t a_lane = smem_u32(As) + (uint32_t)(((lane >> 4) * P + RPW * wg * HP +
                                                     warp * 16 + (lane & 15)) * 16);
  auto load_frag = [&](uint32_t (&f)[4], uint32_t buf, int s) {
    const int hr = s / (3 * KS), dx = (s / KS) % 3, ks = s % KS;
    ldsm_x4(f, buf + (uint32_t)((2 * ks * P + hr * HP + dx) * 16));
  };
  auto issue = [&](int j) {
    const int kc = j % KCN;
    const uint32_t buf = a_lane + (j & 1) * (uint32_t)L.a;
    const uint32_t wb = w_addr + (uint32_t)(kc * G8 * NOUT * 16);
    if constexpr (STEPS % NB != 0) wgmma_wait<0>();   // the ring restarts at buffer 0
    load_frag(fa[0], buf, 0);
    load_frag(fa[1], buf, 1);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int hr = s / (3 * KS), dx = (s / KS) % 3, ks = s % KS;
      fence_regs(fa[s % NB]);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        if (hr - dy < 0 || hr - dy >= RPW) continue;
        const uint32_t woff = ((dy * 3 + dx) * (C / 8) + 2 * ks) * NOUT * 16;
        wgmma_rs<NOUT, 0>(acc[hr - dy], fa[s % NB], desc_plain(wb + woff, NOUT * 16, 128),
                          (kc == 0 && dy == 0 && dx == 0 && ks == 0) ? 0 : 1);
      }
      wgmma_commit();
      wgmma_wait<NB - 2>();   // step s - 2's products are done: its fragment is free
      fence_regs(fa[(s + 2) % NB]);
      if (s + 2 < STEPS) load_frag(fa[(s + 2) % NB], buf, s + 2);
    }
  };
  // The tile of chunk j is complete: b1, relu, bf16, the dot with w2, b2,
  // relu; lanes 4i and 4i + 1 store the quad's two pixels (of the 64, the
  // first TW).
  auto epilogue = [&](int j) {
    const Tile t = tile_of(j);
    const int m = warp * 16 + g8 + 8 * (lane & 1), x = t.x0 + m;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = 4 * (k >> 1) + (k & 1);
        s0 = fmaf(round_bf16(fmaxf(acc[r][e] + b1r[k], 0.f)), w2r[k], s0);
        s1 = fmaf(round_bf16(fmaxf(acc[r][e + 2] + b1r[k], 0.f)), w2r[k], s1);
      }
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      const int y = t.y0 + RPW * wg + r;
      if ((lane & 3) < 2 && m < TW && y < p.H && x < p.W)
        p.out[((size_t)t.n * p.H + y) * p.W + x] = fmaxf(((lane & 1) ? s1 : s0) + b2, 0.f);
    }
  };

#pragma unroll 1
  for (int j = 0; j < G; ++j) {
    mbar_wait(&a_full[j & 1], (j >> 1) & 1);
    issue(j);
    mbar_arrive(&a_empty[j & 1]);   // every fragment of chunk j is in registers
    if (j % KCN == KCN - 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_regs(acc[r]);
      epilogue(j);
    }
  }
}

// The source box of a tile of `tile` output rows (columns): the most
// source rows any tile's halo interpolates from.
int box_extent(const int* lo, int out, int tile) {
  int best = 0;
  for (int t0 = 0; t0 < out; t0 += tile) {
    const int first = lo[t0 > 0 ? t0 - 1 : 0], last = lo[t0 + tile < out ? t0 + tile : out - 1];
    best = last + 2 - first > best ? last + 2 - first : best;
  }
  return best;
}

template <int KC, int RPW>
int launch(TailParams& tp, const void* x, int N, int h, int w, const int* row_lo,
           const int* col_lo, int sms, cudaStream_t st) {
  using K = Cfg<KC, RPW>;
  tp.sbh = box_extent(row_lo, tp.H, K::TH);
  tp.sbw = box_extent(col_lo, tp.W, TW);
  if (tp.sbw > RW) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<KC, RPW>(tp.C, tp.sbh, tp.sbw).bytes();
  if (smem > SMEM_MAX || tp.sbh > 256) return -1;   // try a smaller tile
  tp.sbw_magic = (1u << 20) / tp.sbw + 1;
  for (uint32_t i = 0; i < (uint32_t)(K::G8 * tp.sbw); ++i)
    if ((i * tp.sbw_magic) >> 20 != i / tp.sbw) return (int)cudaErrorInvalidValue;
  tp.tiles_y = (tp.H + K::TH - 1) / K::TH;
  tp.tiles_x = (tp.W + TW - 1) / TW;
  const long long tiles = (long long)N * tp.tiles_y * tp.tiles_x;
  if (tiles > (1ll << 30)) return (int)cudaErrorInvalidValue;
  tp.tiles = (int)tiles;
  const uint64_t dims[4] = {(uint64_t)tp.C, (uint64_t)w, (uint64_t)h, (uint64_t)N};
  const int64_t strides[3] = {tp.C, (int64_t)w * tp.C, (int64_t)h * w * tp.C};
  const uint32_t box[4] = {KC, (uint32_t)tp.sbw, (uint32_t)tp.sbh, 1};
  if (!hopper::make_map(&tp.x, x, 4, dims, strides, box, K::SWB))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tail_bf16<KC, RPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = tp.tiles < sms ? tp.tiles : sms;
  tail_bf16<KC, RPW><<<grid, THREADS, smem, st>>>(tp);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_fitted(TailParams& tp, const void* x, int N, int h, int w, const int* row_lo,
                  const int* col_lo, int sms, cudaStream_t st) {
  const int err = launch<KC, 4>(tp, x, N, h, w, row_lo, col_lo, sms, st);
  if (err != -1) return err;
  const int err2 = launch<KC, 2>(tp, x, N, h, w, row_lo, col_lo, sms, st);
  return err2 == -1 ? (int)cudaErrorInvalidValue : err2;
}

}  // namespace

// x: contiguous NHWC [N, h, w, C] bf16 (16-byte aligned); w1: contiguous
// [9][C / 8][32][8] bf16; b1, w2: fp32 [32]; b2: fp32 [1]; rows, cols:
// fp32 [H][4], [W][4] device tables (lo's int32 bits, weight of lo, weight
// of lo + 1, 0) with lo + 1 < h (w); row_lo, col_lo: the tables' lo on the host;
// out: contiguous fp32 [N, H, W]; sms: the grid's most blocks. C must be a
// multiple of 16 whose weights and tiles fit a block's shared memory (up
// to 192 at the model's 1.75x), H >= h >= 2, W >= w >= 2. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// shape the kernel does not take or a tensor map cuTensorMapEncodeTiled
// refuses); does not synchronise.
extern "C" int vda_head_output_tail(const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* rows,
                                    const void* cols, void* out, const int* row_lo,
                                    const int* col_lo, int N, int h, int w, int C, int H,
                                    int W, int sms, void* stream) {
  if (C <= 0 || C % 16 || N <= 0 || h < 2 || w < 2 || H < h || W < w || sms <= 0)
    return (int)cudaErrorInvalidValue;
  // The passes walk taps that rise by 0 or 1 an output row (column).
  for (int i = 1; i < H; ++i)
    if (row_lo[i] - row_lo[i - 1] < 0 || row_lo[i] - row_lo[i - 1] > 1)
      return (int)cudaErrorInvalidValue;
  for (int i = 1; i < W; ++i)
    if (col_lo[i] - col_lo[i - 1] < 0 || col_lo[i] - col_lo[i - 1] > 1)
      return (int)cudaErrorInvalidValue;
  TailParams tp;
  tp.w1 = w1;
  tp.b1 = static_cast<const float*>(b1);
  tp.w2 = static_cast<const float*>(w2);
  tp.b2 = static_cast<const float*>(b2);
  tp.rows = static_cast<const float4*>(rows);
  tp.cols = static_cast<const float4*>(cols);
  tp.out = static_cast<float*>(out);
  tp.H = H;
  tp.W = W;
  tp.C = C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return C % 32 == 0 ? launch_fitted<32>(tp, x, N, h, w, row_lo, col_lo, sms, st)
                     : launch_fitted<16>(tp, x, N, h, w, row_lo, col_lo, sms, st);
}
