// The pieces of a 3x3 conv over pixel-major bf16 tiles in shared memory that
// the probes of chained conv layers share (probe_unit_loop.cu,
// probe_wholenet_bisect.cu), for sm_90a:
//   * to_pixel_major: a channel-major box, as a TMA tensor copy lands it (or
//     in padded planes, as cp.async copies land it), into a pixel-major
//     buffer (a pixel's 32 channels contiguous, pitch SPITCH), by
//     ldmatrix.trans and stmatrix in 8 x 8 pieces;
//   * layer_mma: one warp's m16 fragments of a conv, mma.sync m16n8k16 bf16
//     -> f32 with the 32 output channels on N, A and B fragments by
//     ldmatrix (any pixel a lane), the k16 steps folded at compile time
//     into straight-line code, the next step's fragments loaded before
//     this step's mma;
//   * tensor_store_4d, and the host's encoder of 4-D tensor maps.
#pragma once

#include <utility>

#include "fused_net_common.cuh"
#include "tma.cuh"

namespace evflow {
namespace pixconv {

using wholenet::C;       // 32 channels
using wholenet::NF;      // n8 fragments of the output channels
using wholenet::SPITCH;  // bf16 per pixel of a pixel-major buffer

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The box [c0 innermost .. c3] of a 4-D tensor map from 128-byte aligned
// shared memory, in the current bulk async-group; clipped to the tensor.
__device__ __forceinline__ void tensor_store_4d(const CUtensorMap* map, int c0, int c1, int c2,
                                                int c3, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(src))
      : "memory");
}

// A channel-major box [C][rows][bx] -> the pixel-major buffer
// [rows][hc][SPITCH], box column j landing on buffer column j - sh: per
// 8 x 8 piece (8 channels by 8 columns of a row) one ldmatrix.trans and one
// stmatrix, four pieces (the channel groups) a warp instruction; a column
// outside the buffer goes to the dummy row. PLANE: bf16 from one channel's
// plane to the next, where the planes are padded (0: rows bx, a dense box);
// NW: the warps that share the work, the first ones (0: every warp).
template <int PLANE = 0, int NW = 0>
__device__ __forceinline__ void to_pixel_major(const __nv_bfloat16* box, __nv_bfloat16* buf,
                                               uint32_t dummy, int rows, int bx, int hc, int sh) {
  const int lane = threadIdx.x & 31, nw = NW ? NW : blockDim.x >> 5;
  const int cg = lane >> 3, i = lane & 7, per_row = bx / 8;
  for (int task = threadIdx.x >> 5; task < rows * per_row; task += nw) {
    const int r = task / per_row, col = (task - r * per_row) * 8;
    uint32_t v[4];
    ldsm_x4_t(v, smem_u32(PLANE == 0 ? box + ((cg * 8 + i) * rows + r) * bx + col
                                     : box + (cg * 8 + i) * PLANE + r * bx + col));
    const int bc = col + i - sh;
    stsm_x4(bc >= 0 && bc < hc ? smem_u32(buf + (r * hc + bc) * SPITCH + cg * 8) : dummy, v);
  }
}

// One k16 step of one m16 fragment against the 32 output channels' B
// fragments `b` (two ldmatrix.x4: channels 0-15, 16-31).
__device__ __forceinline__ void mma_n32(float (&acc)[NF][4], const uint32_t (&av)[4],
                                        const uint32_t (&b)[2][4]) {
  mma_bf16_16816(acc[0], av, b[0][0], b[0][1]);
  mma_bf16_16816(acc[1], av, b[0][2], b[0][3]);
  mma_bf16_16816(acc[2], av, b[1][0], b[1][1]);
  mma_bf16_16816(acc[3], av, b[1][2], b[1][3]);
}

// One layer's k16 steps for NFRAG of a warp's fragments (acc[f], abase[f]),
// straight-line (a fold over the step index, so that every register buffer
// is indexed at compile time), against weight rows of WP bf16 (K index
// half 9C + tap C + channel): a step is (tap, 16 channels) of h, then (AUX)
// of aux, B fragments from the weights, A from h (SEPARATE: aux from its own
// buffer, else h's A again). The next step's fragments are loaded before
// this step's mma (two register buffers). SPLIT (one fragment): the steps
// go to two accumulator sets in turn, summed by the caller, so that no mma
// waits on the one before it.
template <int NFRAG, bool SPLIT, bool AUX, bool SEPARATE, int WP>
struct LayerMma {
  static constexpr int NK = AUX ? 36 : 18;
  float (*acc)[NF][4];
  const uint32_t* abase;
  uint32_t hsm, asm_, wbase;
  int hc;
  uint32_t b[2][2][4], av[2][NFRAG][4], aa[2][NFRAG][4];  // two steps' fragments

  template <int KS>
  __device__ __forceinline__ void load() {
    constexpr int j = AUX ? KS >> 1 : KS, half = AUX ? KS & 1 : 0;
    constexpr int tap = j >> 1, c16 = j & 1, dy = tap / 3;
    constexpr uint32_t k0 = (half * 9 * C + tap * C + c16 * 16) * 2;
    ldsm_x4(b[KS & 1][0], wbase + k0);
    ldsm_x4(b[KS & 1][1], wbase + 16 * WP * 2 + k0);
    const uint32_t off = ((dy * hc + tap - 3 * dy) * SPITCH + c16 * 16) * 2;
#pragma unroll
    for (int f = 0; f < NFRAG; ++f) {
      if (half == 0) ldsm_x4(av[j & 1][f], hsm + abase[f] + off);
      if (half == 1 && SEPARATE) ldsm_x4(aa[j & 1][f], asm_ + abase[f] + off);
    }
  }

  template <int KS>
  __device__ __forceinline__ void step() {
    if constexpr (KS + 1 < NK) load<KS + 1>();
    constexpr int j = AUX ? KS >> 1 : KS, half = AUX ? KS & 1 : 0;
#pragma unroll
    for (int f = 0; f < NFRAG; ++f) {
      mma_n32(acc[SPLIT ? (KS & 1) : f],
              half == 1 && SEPARATE ? aa[j & 1][f] : av[j & 1][f], b[KS & 1]);
    }
  }

  template <int... KS>
  __device__ __forceinline__ void run(std::integer_sequence<int, KS...>) {
    load<0>();
    (step<KS>(), ...);
  }
};

template <int NFRAG, bool SPLIT, bool AUX, bool SEPARATE, int WP>
__device__ __forceinline__ void layer_mma(float (*acc)[NF][4], const uint32_t* abase, uint32_t hsm,
                                          uint32_t asm_, uint32_t wbase, int hc) {
  using M = LayerMma<NFRAG, SPLIT, AUX, SEPARATE, WP>;
  M m;
  m.acc = acc;
  m.abase = abase;
  m.hsm = hsm;
  m.asm_ = asm_;
  m.wbase = wbase;
  m.hc = hc;
  m.run(std::make_integer_sequence<int, M::NK>{});
}

// A map over a dense 4-D tensor (dims innermost first) with the box `box`,
// zero-filled outside the tensor on loads and clipped to it on stores;
// `swizzle` the box's layout in shared memory.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
                   const int (&dims)[4], const int (&box)[4],
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[4], strides[3];
  cuuint32_t boxdim[4];
  cuuint64_t stride = esize;
  for (int i = 0; i < 4; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    boxdim[i] = static_cast<cuuint32_t>(box[i]);
    stride *= gdim[i];
    if (i < 3) strides[i] = stride;
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), gdim, strides, boxdim, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pixconv
}  // namespace evflow
