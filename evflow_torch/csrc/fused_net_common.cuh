// The whole LIFFireNet inference step in one launch: shared pieces of the
// five schedules (fused_net.cu, fused_net_loop.cu, fused_net_loop2.cu,
// fused_net_lgrid.cu, fused_net_batch.cu).
//
// What one launch computes, for a window x [B,H,W,Cin] (f32, NHWC) and L
// units (C = 32 channels each, state [B,C,H,W] in f32 or bf16):
//   h_0 = x
//   for each unit l:
//     ff    = conv3x3_SAME(bf16 [h_l | prev_spk_l]) . W_l  (f32 sums) + bias_l
//     spk, mem' = snn.Leaky update of (ff, mem_l)        (conv_lif_common.cuh)
//     h_{l+1} = spk
//   flow = tanh(h_L . pred_w + pred_b)                     [B,H,W,2] f32
// where prev_spk_l is the unit's spikes of the previous window (recurrent
// units only) and every unit's input is ZERO outside the image, as in
// FireNet's SAME padding. (The TPU kernels these replace recompute halo rows
// but never zero the rows outside the image, so their border rows drift from
// FireNet's function; see ROADMAP.md section 3.)
//
// Every schedule stages its inputs as bf16 pixel-major tiles in shared
// memory ([pixel][channel], rows padded by 8 bf16 so fragment loads are free
// of bank conflicts) and runs the conv as an implicit GEMM with mma.sync
// m16n8k16 bf16 -> f32, in the k order of pack_weights (tap-major, then
// [h | prev] channels), the same order as conv_lif_common.cuh. Membranes
// are read and written straight from the accumulator fragments. All five
// run the pieces of fused_net_item.cuh: a pixel-a-lane staging, one weight
// buffer refilled by TMA bulk copies, m16 fragments loaded by ldmatrix and
// an epilogue that issues a fragment's state loads together. K3, K4, K5 and
// K7 keep each unit's spikes on chip for the next (an item of every unit);
// K6 runs a unit over the whole image and sends its spikes through device
// memory.
#pragma once

#include "conv_lif_common.cuh"

namespace evflow {
namespace wholenet {

constexpr int MAX_UNITS = 7;
constexpr int C = 32;                   // channels of every unit
constexpr int NF = C / 8;               // n8 fragments of the output channels
constexpr int SPITCH = C + PAD;         // bf16 per pixel of a staged spike tile

// Operands of one launch, filled by evflow_torch/ops/fused_net.py (ctypes
// mirror WholeNetArgs there). Per-unit pointers make the schedules
// independent of how the caller stacks its states.
struct WholeNetArgs {
  const float* x;                       // [B, H, W, Cin] f32
  const void* mem_in[MAX_UNITS];        // [B, C, H, W] state dtype
  void* mem_out[MAX_UNITS];             // [B, C, H, W] state dtype
  const void* spk_in[MAX_UNITS];        // previous spikes of a recurrent unit, else null
  void* spk_out[MAX_UNITS];             // this window's spikes if kept, else null
  const __nv_bfloat16* wk[MAX_UNITS];   // packed [C, 9 * ck[l]] (pack_weights)
  const float* params;                  // [L, 3, C]: bias, beta, theta
  const float* pred_w;                  // [C, 2]
  const float* pred_b;                  // [2]
  float* flow;                          // [B, H, W, 2]
  int ck[MAX_UNITS];                    // packed input channels: head 16 or 32, 32, 64 (rec)
  int B, H, W, Cin, L, hard_reset, state_bf16;
  int grid;  // set by the launch: the CTAs it started
};

__host__ __device__ inline bool recurrent(const WholeNetArgs& a, int l) {
  return a.spk_in[l] != nullptr;
}

// The head's packed input channels (pack_weights): Cin rounded up to 16.
__host__ __device__ inline int head_channels(int cin) { return cin <= 16 ? 16 : 32; }

// What the kernels take; anything else is refused before launch.
inline bool args_valid(const WholeNetArgs& a) {
  if (a.L < 1 || a.L > MAX_UNITS || a.Cin < 1 || a.Cin > 32 || a.B < 1 || a.H < 1 ||
      a.W < 1 || a.x == nullptr || a.flow == nullptr || a.params == nullptr ||
      a.pred_w == nullptr || a.pred_b == nullptr || recurrent(a, 0)) {
    return false;
  }
  for (int l = 0; l < a.L; ++l) {
    const int expect = l == 0 ? head_channels(a.Cin) : (recurrent(a, l) ? 2 * C : C);
    if (a.ck[l] != expect || a.wk[l] == nullptr || a.mem_in[l] == nullptr ||
        a.mem_out[l] == nullptr) {
      return false;
    }
  }
  return true;
}

__device__ __forceinline__ bool inside(const WholeNetArgs& a, int h, int w) {
  return h >= 0 && h < a.H && w >= 0 && w < a.W;
}

// One k16 step of two m16 fragments x NF n8 fragments, by 32-bit loads (the
// probes' mainloop; the kernels load fragments by ldmatrix, fused_net_item.cuh).
__device__ __forceinline__ void mma_k16(const __nv_bfloat16* buf, int pitch,
                                        const int (&pix)[2][2], int toff, int c0,
                                        const __nv_bfloat16* wsm, int wpitch, int k0, int g,
                                        int q, float (&acc)[2][NF][4]) {
  uint32_t af[2][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const __nv_bfloat16* p0 = buf + (pix[mf][0] + toff) * pitch + c0 + 2 * q;
    const __nv_bfloat16* p1 = buf + (pix[mf][1] + toff) * pitch + c0 + 2 * q;
    af[mf][0] = lds32(p0);      // pixel g,   k 2q..2q+1
    af[mf][1] = lds32(p1);      // pixel g+8, k 2q..2q+1
    af[mf][2] = lds32(p0 + 8);  // pixel g,   k 2q+8..2q+9
    af[mf][3] = lds32(p1 + 8);  // pixel g+8, k 2q+8..2q+9
  }
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    const __nv_bfloat16* pb = wsm + (nf * 8 + g) * wpitch + k0 + 2 * q;
    const uint32_t b0 = lds32(pb), b1 = lds32(pb + 8);
    mma_bf16_16816(acc[0][nf], af[0], b0, b1);
    mma_bf16_16816(acc[1][nf], af[1], b0, b1);
  }
}

// Kernel arguments -> shared memory, so that per-unit pointers indexed by a
// runtime unit number need no local-memory copy of the struct.
__device__ __forceinline__ void copy_args(const WholeNetArgs& src, WholeNetArgs& dst) {
  if (threadIdx.x == 0) dst = src;
  __syncthreads();
}

}  // namespace wholenet
}  // namespace evflow
