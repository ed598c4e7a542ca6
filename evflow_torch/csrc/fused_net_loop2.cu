// The whole FireNet step in one launch, a runtime loop over units (K5), for
// sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_loop2.py::fused_firenet_step_loop2
// (Pallas, body `_make_kernel`): the same function as fused_net.cu over
// stacked weights, with one conv+LIF body that a runtime loop runs once per
// unit, one grid step per (b, tile). Function: fused_net_common.cuh.
//
// Schedule. One CTA of 16 warps per (b, 16 x 16 item), B ceil(H/16)
// ceil(W/16) CTAs (512 at B=2, 256x256; one a SM at 228,504 bytes of
// shared memory), each the item body of fused_net_item.cuh with the unit
// loop rolled (`#pragma unroll 1`): unit l over the owned tile grown by
// L-1-l pixels a side, m16 fragments over the warps, the weight buffer
// refilled by TMA bulk copies (unit 0's issued at CTA start, so they land
// during the event staging). What K7 adds to it is the persistent loop.
// Its outputs are the slots of ops/fused_net_loop2.py: every membrane, the
// recurrent units' spikes in slots 0 and 1, the last feedforward unit's in
// slot 2 (the TPU kernel's scratch slot).
//
// Bound on an H100 SXM: as fused_net.cu (the same bytes must move; slot 2
// too). 39.94 GFLOP of mma issued a window at B=2, as K7.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_loop2.so fused_net_loop2.cu
#include "fused_net_item.cuh"

namespace evflow {
namespace wholenet {

template <class S>
__global__ void __launch_bounds__(ITEM_THREADS, 1) fused_net_loop2_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const ItemSmem sm = item_start(a, smem_raw, item_layout(a));
  int u = 0;
  run_item<S>(a, sm, blockIdx.x, u, false);
}

}  // namespace wholenet
}  // namespace evflow

extern "C" int fused_net_loop2(evflow::wholenet::WholeNetArgs* a, void* stream) {
  using namespace evflow::wholenet;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->state_bf16 ? launch_items(fused_net_loop2_kernel<__nv_bfloat16>, *a, s, false)
                       : launch_items(fused_net_loop2_kernel<float>, *a, s, false);
}
