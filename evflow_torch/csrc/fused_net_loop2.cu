// The whole FireNet step in one launch, a runtime loop over units with a
// uniform extent (K5), for sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_loop2.py::fused_firenet_step_loop2
// (Pallas, body `_make_kernel`): the same function as fused_net.cu over
// stacked weights, with one conv+LIF body that a runtime loop runs once per
// unit. Function and shared pieces: fused_net_common.cuh.
//
// Schedule. One CTA (16 warps) per (b, 8x16 output tile). Every unit
// computes the same (8 + 2(L-1)) x (16 + 2(L-1)) extent (20 x 28 at L = 7):
// no per-unit geometry, which is what makes the body one runtime loop. Its
// input and output tiles carry a one-pixel zero ring, so the extent's edge
// reads zeros and its error moves one pixel inward per unit, reaching the
// owned tile's edge only after L units. Three 22x30-pixel tiles (52 KB each)
// and one unit's weights (37 KB): 191 KB, one CTA per SM. The uniform extent
// costs 560 x 7 / (128 x 7) = 4.4x the useful MACs, against 1.95x for K3.
//
// Bound on an H100 SXM: as fused_net.cu (the same bytes must move). Single
// stage, as fused_net.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_loop2.so fused_net_loop2.cu
#include "fused_net_common.cuh"

namespace evflow {
namespace wholenet {

template <class S>
__global__ void __launch_bounds__(U_THREADS, 1) fused_net_loop2_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  uniform_zero(smem);
  uniform_tile<S>(a, blockIdx.z, blockIdx.y * U_TH, blockIdx.x * U_TW, smem);
}

template <class S>
int launch(WholeNetArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_net_loop2_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(U_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + U_TW - 1) / U_TW, (a.H + U_TH - 1) / U_TH, a.B);
  fused_net_loop2_kernel<S><<<grid, U_THREADS, U_SMEM, stream>>>(a);
  a.grid = static_cast<int>(grid.x * grid.y * grid.z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wholenet
}  // namespace evflow

extern "C" int fused_net_loop2(evflow::wholenet::WholeNetArgs* a, void* stream) {
  using namespace evflow::wholenet;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->state_bf16 ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s);
}
