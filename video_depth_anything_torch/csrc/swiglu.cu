// SwiGLU's gate for Hopper (sm_90a): kernel K8.
//
// Replaces: no TPU kernel. The JAX package leaves vitg's fused SwiGLU FFN
//   (models/dinov2.py::_ffn) to XLA, which fuses the split, silu and the
//   product into one pass; the port ran them as two PyTorch kernels on the
//   strided halves of w12's output (silu reads x1 and writes s, the product
//   reads s and x2 and writes h: 40 bytes a hidden pair). Upstream, DINOv2's
//   SwiGLUFFNFused calls xFormers' fused op on a card.
// Computes, from w12's output y [M, 2H] bf16 (row-major, contiguous), the
//   w3 input h [M, H] bf16:
//     s = bf16(x1 / (1 + expf(-x1)))      x1 = y[:, :H], in fp32
//     h = bf16(float(s) * float(x2))      x2 = y[:, H:]
//   which is the rounding of F.silu(x1) * x2 on the card, where silu
//   computes in fp32 and rounds to bf16 and the product does the same. The
//   build keeps IEEE division and the accurate expf (no fast math), so the
//   output is PyTorch's bit for bit.
//
// Bound on this card: bytes. y read once and h written once, 3H x 2 bytes
//   a row (vitg, a window of 32 frames at 518x924: 78,176 rows at H 4096,
//   1.92 GB, 0.573 ms at 3.35 TB/s). The arithmetic, about 20 instructions
//   an element (the division and expf most of it), stays under the
//   instruction rate the bytes leave.
//
// Design: every thread takes UNROLL 16-byte vectors of h (8 hidden
//   columns each), THREADS apart so that a warp's loads and stores are
//   contiguous; it starts all their loads (x1's and x2's, 16 bytes each,
//   through the read-only path) before any arithmetic, so a warp keeps
//   UNROLL x 1 KB in flight. A block covers THREADS x UNROLL vectors of the
//   flattened [M, H / 8] grid; the last block masks the ragged end, so any
//   row count works. Indices are 32-bit where 2 M H / 8 fits, else 64-bit.
//   Needs H % 8 == 0 and 16-byte aligned y and h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int TILE = THREADS * UNROLL;   // vectors of h a block covers

__device__ __forceinline__ __nv_bfloat16 gate(__nv_bfloat16 a, __nv_bfloat16 b) {
  const float x = __bfloat162float(a);
  const __nv_bfloat16 s = __float2bfloat16(x / (1.0f + expf(-x)));
  return __float2bfloat16(__bfloat162float(s) * __bfloat162float(b));
}

__device__ __forceinline__ uint4 gate8(const uint4& a, const uint4& b) {
  const __nv_bfloat16* pa = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* pb = reinterpret_cast<const __nv_bfloat16*>(&b);
  uint4 r;
  __nv_bfloat16* pr = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) pr[i] = gate(pa[i], pb[i]);
  return r;
}

template <typename Index>
__global__ void __launch_bounds__(THREADS)
swiglu_bf16(const uint4* __restrict__ y, uint4* __restrict__ h, Index total, Index hv) {
  const Index base = static_cast<Index>(blockIdx.x) * TILE + threadIdx.x;
  uint4 a[UNROLL], b[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const Index i = base + static_cast<Index>(u) * THREADS;
    if (i < total) {
      const Index row = i / hv;
      const uint4* src = y + (i + row * hv);   // row * 2hv + (i - row * hv)
      a[u] = __ldg(src);
      b[u] = __ldg(src + hv);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const Index i = base + static_cast<Index>(u) * THREADS;
    if (i < total) h[i] = gate8(a[u], b[u]);
  }
}

}  // namespace

// y [rows, 2 * hidden] bf16 -> h [rows, hidden] bf16 on ``stream``; returns
// the launch's cudaError (cudaErrorInvalidValue for what the kernel does not
// take: hidden not a multiple of 8, a pointer not 16-byte aligned).
extern "C" int vda_swiglu(const void* y, void* h, long long rows, int hidden, void* stream) {
  if (rows < 0 || hidden <= 0 || hidden % 8 || reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(h) % 16)
    return (int)cudaErrorInvalidValue;
  const unsigned long long hv = hidden / 8;
  const unsigned long long total = static_cast<unsigned long long>(rows) * hv;
  if (total == 0) return (int)cudaSuccess;
  const unsigned long long blocks = (total + TILE - 1) / TILE;
  if (blocks > 0x7fffffffULL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 32-bit indices while every input vector's index (up to 2 total) fits.
  if (2 * total + 2 * TILE < (1ULL << 32))
    swiglu_bf16<uint32_t><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const uint4*>(y), static_cast<uint4*>(h), (uint32_t)total, (uint32_t)hv);
  else
    swiglu_bf16<unsigned long long><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const uint4*>(y), static_cast<uint4*>(h), total, hv);
  return (int)cudaGetLastError();
}
