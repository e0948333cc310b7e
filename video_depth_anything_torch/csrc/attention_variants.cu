// The spatial attention function of K1 under three schedules, for Hopper
// (sm_90a): the schedule variants of the phase bench.
//
// Replaces: tools/bench_kernel_phases.py variant_attention (T2; Pallas
//   body _variant_kernel), schedules base, stagger and kchunk.
// Computes, per (batch, head) of q, k, v contiguous bf16 [B, S, H*64]:
//   q' = q * q_scale rounded to bf16 (q_scale = bf16(64^-0.5), exact);
//   s = q' k^T in fp32; p = bf16(exp(s - m)) against the running row max
//   m over the S valid keys; o = (p v) / max(sum p, 1e-30), where the
//   denominator sums the bf16-rounded p (the tool's ones column) and the
//   numerator accumulates in fp32. The TPU tool pads the keys to 1408 and
//   its row max includes the padded zero scores; the softmax is the same.
//
// Bound on this card: operations. At [32, 1370, 1024], H = 16: 4*B*H*S^2*64
// = 246 GFLOP, 0.2487 ms at 989 TFLOP/s, against 360 MB of bytes (0.107
// ms); the B*H*S^2 = 9.6e8 exponentials take about as long again on the
// special-function units (0.230 ms at 4.18e12 per second: 16 ex2 per SM and
// clock at 1.98 GHz).
//
// Design: the instances attention_bf16<64, false, DENOM_ONES, SCHED> of the
// attention body (attention_flash.cuh): TMA-fed K / V ring, two consumer
// warpgroups on wgmma in ping-pong, the denominator as a second wgmma
// against a tile of ones. The schedules are the body's:
//   stagger: QK(t + 1) issued with PV(t), softmax(t + 1) under PV(t): the
//            instance K1 runs with mxu_denom (the same products; q' = q / 8
//            and the scale on the scores differ by a power of two only).
//   base:    QK(t), wait, softmax(t), PV(t), wait: no overlap inside a
//            warpgroup (the TPU's phase-grouped order, not pipelined).
//   kchunk:  the keys in two halves, two online-softmax chains per
//            consumer with alternating tiles, merged at the end (the TPU's
//            two key chunks).

#include "attention_flash.cuh"

// schedule: 0 = base, 1 = stagger, 2 = kchunk. q, k, v, o contiguous bf16
// [B, S, H*64]; q_scale is q's pre-scale, already rounded to bf16. Returns
// the cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int vda_attention_variant(int schedule, const void* q, const void* k, const void* v,
                                     void* o, int B, int S, int H, float q_scale,
                                     void* stream) {
  using namespace vda::flash;
  constexpr int DH = 64;
  const long long C = (long long)H * DH;
  const Params p{q, k, v, o, S, DH,
                 S * C, DH, C, S * C, DH, C,
                 S * C, DH, C, S * C, DH, C,
                 q_scale, 1.f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (schedule) {
    case 0: return launch_bf16<DH, false, DENOM_ONES, SCHED_BASE>(p, B, H, st);
    case 1: return launch_bf16<DH, false, DENOM_ONES, SCHED_STAGGER>(p, B, H, st);
    case 2: return launch_bf16<DH, false, DENOM_ONES, SCHED_KCHUNK>(p, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
