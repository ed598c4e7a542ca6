// The whole FireNet step in one launch, units unrolled at compile time over
// a uniform extent, recurrent units' spikes only (K4), for sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_loop.py::fused_firenet_step_loop
// (Pallas, body `_make_kernel`): one grid step per (b, row tile) runs every
// unit over the same extent, its unit loop unrolled in Python so that every
// weight, state and spike-slot index is a constant, and writes the
// membranes and only the R recurrent units' spikes. Function and shared
// pieces: fused_net_common.cuh.
//
// Schedule. K5's tile (uniform_tile in fused_net_common.cuh): one CTA of 16
// warps per (b, 8x16 output tile), every unit over the same
// (8 + 2(L-1)) x (16 + 2(L-1)) extent, three 22x30-pixel tiles and one
// unit's weights in 191 KB of shared memory, one CTA per SM. The TPU's tile
// (16 rows x the whole width, a 32-row extent) would need ~512 KB and has
// no counterpart here. What K4 adds to K5 is the unroll: the kernel is a
// template on the unit count and on which units are recurrent (LIFFireNet,
// LIFFireNet_short and their feedforward variants), which uniform_tile takes
// as its NL and REC: every unit's input channels, weight pitch, extent and k
// loop are compile-time constants and each unit's conv compiles into its own
// straight-line code, where K5 runs one body with runtime trip counts
// (`#pragma unroll 1`). The same k order and LIF epilogue as
// K1/K3/K5/K6/K7: with f32 state the five whole-network kernels are
// bit-equal.
//
// Bound on an H100 SXM (B=2, 256x256): input, membranes in and out, the
// recurrent units' spikes in and out and the flow, once each: ~153 MB with
// bf16 state -> 0.0457 ms at 3.35 TB/s (0.091 ms f32), K3's bytes; K5 also
// writes its slot 2. The uniform extent issues 4.4x the useful MACs (92.4
// GFLOP of mma per window at B=2), as K5. Single stage, as fused_net.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_loop.so fused_net_loop.cu
#include "fused_net_common.cuh"

namespace evflow {
namespace wholenet {

template <int L, unsigned REC, class S>
__global__ void __launch_bounds__(U_THREADS, 1) fused_net_loop_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  uniform_zero(smem);
  uniform_tile<S, L, REC>(a, blockIdx.z, blockIdx.y * U_TH, blockIdx.x * U_TW, smem);
}

template <int L, unsigned REC, class S>
int launch(WholeNetArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_net_loop_kernel<L, REC, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(U_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + U_TW - 1) / U_TW, (a.H + U_TH - 1) / U_TH, a.B);
  fused_net_loop_kernel<L, REC, S><<<grid, U_THREADS, U_SMEM, stream>>>(a);
  a.grid = static_cast<int>(grid.x * grid.y * grid.z);
  return static_cast<int>(cudaGetLastError());
}

// The unit layouts compiled in: (L, recurrent-unit mask) of LIFFireNet
// (G1, G2 recurrent), LIFFireNet_short, and their feedforward variants.
template <class S>
int launch_layout(WholeNetArgs& a, cudaStream_t stream) {
  unsigned rec = 0;
  for (int l = 0; l < a.L; ++l) {
    if (recurrent(a, l)) rec |= 1u << l;
  }
  if (a.L == 7 && rec == 0x12u) return launch<7, 0x12u, S>(a, stream);
  if (a.L == 5 && rec == 0x0Au) return launch<5, 0x0Au, S>(a, stream);
  if (a.L == 7 && rec == 0u) return launch<7, 0u, S>(a, stream);
  if (a.L == 5 && rec == 0u) return launch<5, 0u, S>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wholenet
}  // namespace evflow

extern "C" int fused_net_loop(evflow::wholenet::WholeNetArgs* a, void* stream) {
  using namespace evflow::wholenet;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->state_bf16 ? launch_layout<__nv_bfloat16>(*a, s) : launch_layout<float>(*a, s);
}
