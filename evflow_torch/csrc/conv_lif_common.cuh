// The function of a fused conv3x3 (+ recurrent conv3x3) + folded BatchNorm +
// LIF step, and the pieces every kernel of it shares, for Hopper. A unit
// computes, for every pixel and output channel c,
//   ff = sum_k bf16(in[k]) bf16(W[k, c]) (f32 sums) + bias[c], in = the 3x3
//   neighbourhood of [x | prev_spk] (zero outside the image),
// then lif_update's snn.Leaky step of (ff, mem): BatchNorm folded into W and
// bias: an implicit GEMM on mma.sync m16n8k16 bf16 -> f32, shared rows padded
// by PAD bf16 (bank spread). Kernels: conv_lif_layer.cuh (K1, K2), K3-K7, probes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace evflow {

constexpr int PAD = 8;  // bf16 padding per shared-memory row (bank spread)

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The LIF update (evflow_torch.ops.lif), roundings explicit (no FMA) as the plain
// version's: reset = mem > theta, base = beta mem + ff, u = base - reset (base
// | theta), spk = u > theta, mem' = u - (spk - reset) (u | theta) (hard | subtract).
__device__ __forceinline__ void lif_update(float ff, float mem, float beta, float theta,
                                           bool hard, float& spk, float& mem2) {
  const float reset = mem > theta ? 1.f : 0.f;
  const float base = __fadd_rn(__fmul_rn(beta, mem), ff);
  const float u = hard ? __fsub_rn(base, __fmul_rn(reset, base))
                       : __fsub_rn(base, __fmul_rn(reset, theta));
  spk = u > theta ? 1.f : 0.f;
  const float d = __fsub_rn(spk, reset);
  mem2 = hard ? __fsub_rn(u, __fmul_rn(d, u)) : __fsub_rn(u, __fmul_rn(d, theta));
}

}  // namespace evflow
