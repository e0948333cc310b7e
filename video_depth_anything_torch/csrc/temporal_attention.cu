// Temporal multi-head attention of the motion modules, for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_temporal_attention.py
//   temporal_flash_attention (its Pallas body _kernel), and the XLA twin
//   that the JAX model routes on the TPU, ops/attention.py
//   temporal_flat_attention.
// Computes, per pixel p and head h: softmax((q * scale) k^T) v over the
// T <= 32 frames of the window, where q, k, v, o are contiguous [P, T, C]
// and head h owns channels [h*dh, (h+1)*dh). q is pre-scaled in its own
// dtype, scores, max, sum and the PV accumulation are fp32, and the
// unnormalised probabilities are rounded to the value dtype before PV —
// the arithmetic of the flat XLA form.
//
// Bound on this card: bytes. 4*P*T*C*itemsize bytes (q, k, v read once,
// o written once) against 4*P*H*T^2*dh FLOPs: 8 FLOPs per byte in bf16 at
// T = 32, far below the ~295 at which the tensor cores would bind.
//
// Design: the TPU kernel flattens (frame, head) and masks cross-head pairs
// with -inf to fill a 128x128 matrix unit; that 8x detour is not needed
// here. One warp owns one (pixel, head) pair and lane t owns query frame t.
// dh is walked in chunks of 32 channels: the warp stages the chunk of K
// (then V) for all frames in shared memory with coalesced row loads, every
// lane reads it back as broadcasts (16-byte vectors), and the lane's 32
// scores / 32 output channels stay in registers. The output chunk goes
// back through shared memory so the global stores are coalesced too.
// Frames past T and channels past dh load as zeros; scores of frames past T
// are masked to -inf. All arithmetic is scalar fp32 FMA: a first, simple
// kernel (the T x T x dh products are too small for an MMA tile at T = 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TMAX = 32;             // frames per window at most
constexpr int CH = 32;               // channels per chunk
constexpr int WARPS = 8;             // (pixel, head) pairs per block
constexpr int THREADS = WARPS * 32;
constexpr int KP = CH;               // K/V chunk pitch: broadcast reads only
constexpr int QP = CH + 1;           // Q/O chunk pitch: per-lane rows, odd
constexpr int WARP_FLOATS = TMAX * KP + TMAX * QP;
constexpr size_t SMEM = (size_t)WARPS * WARP_FLOATS * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// Round to T's precision and back (identity for fp32).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Chunk [TMAX][CH] of one (pixel, head) slice into shared memory: lane =
// channel, so each frame's row is one coalesced load. Zero past T / dh.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, int pitch, const T* src,
                                           int nt, int C, int c0, int cw,
                                           float mul, bool round_mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = 0; j < TMAX; ++j) {
    float x = 0.f;
    if (j < nt && lane < cw) {
      x = to_f(src[(long long)j * C + c0 + lane]);
      if (round_mul) x = round_to<T>(x * mul);
    }
    dst[j * pitch + lane] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
temporal_attention(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int P, int nt,
                   int H, int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * WARPS + warp;
  if (pair >= (long long)P * H) return;  // no block-wide sync below
  const long long p = pair / H;
  const int h = (int)(pair - p * H);
  const int C = H * dh;
  const long long base = p * nt * C + (long long)h * dh;
  float* KV = smem + warp * WARP_FLOATS;  // [TMAX][KP]
  float* QO = KV + TMAX * KP;             // [TMAX][QP]

  float s[TMAX];
#pragma unroll
  for (int j = 0; j < TMAX; ++j) s[j] = 0.f;

  for (int c0 = 0; c0 < dh; c0 += CH) {
    const int cw = min(CH, dh - c0);
    load_chunk<T>(KV, KP, k + base, nt, C, c0, cw, 1.f, false);
    load_chunk<T>(QO, QP, q + base, nt, C, c0, cw, scale, true);
    __syncwarp();
#pragma unroll
    for (int d = 0; d < CH; d += 4) {
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
    const float e = j < nt ? expf(s[j] - mx) : 0.f;
    sum += e;
    s[j] = round_to<T>(e);
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);

  for (int c0 = 0; c0 < dh; c0 += CH) {
    const int cw = min(CH, dh - c0);
    load_chunk<T>(KV, KP, v + base, nt, C, c0, cw, 1.f, false);
    __syncwarp();
    float acc[CH];
#pragma unroll
    for (int d = 0; d < CH; ++d) acc[d] = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
#pragma unroll
      for (int d = 0; d < CH; d += 4) {
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
      if (lane < cw) o[base + (long long)j * C + c0 + lane] = from_f<T>(QO[j * QP + lane]);
    __syncwarp();
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. q, k, v, o contiguous [P, T, H*dh], T <= 32.
// Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int vda_temporal_attention(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int P, int T,
                                      int H, int dh, float scale,
                                      void* stream) {
  if (T < 1 || T > TMAX || dh < 1) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)P * H;
  const dim3 grid((unsigned)((pairs + WARPS - 1) / WARPS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(temporal_attention<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    temporal_attention<__nv_bfloat16><<<grid, THREADS, SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), P, T, H,
        dh, scale);
  } else if (dtype == 0) {
    err = cudaFuncSetAttribute(temporal_attention<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    temporal_attention<float><<<grid, THREADS, SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), P, T, H, dh, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
