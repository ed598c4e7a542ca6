// The whole FireNet step in one launch, units unrolled at compile time,
// recurrent units' spikes only (K4), for sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_loop.py::fused_firenet_step_loop
// (Pallas, body `_make_kernel`): one grid step per (b, row tile) runs every
// unit, its unit loop unrolled in Python so that every weight, state and
// spike-slot index is a constant, and writes the membranes and only the R
// recurrent units' spikes. Function: fused_net_common.cuh.
//
// Schedule. K5's grid (fused_net_loop2.cu): one CTA of 16 warps per (b,
// 16 x 16 item), each the item body of fused_net_item.cuh. What K4 adds is
// the unroll: the kernel is a template on the unit count and on which
// units are recurrent (LIFFireNet, LIFFireNet_short and their feedforward
// variants), which run_item takes as its NL and REC: every unit's input
// channels, weight pitch, extent and work count are compile-time constants
// and each unit compiles into its own code, where K5 runs one body with
// runtime trip counts. The tap and k loops stay as K5's. The same k order
// and LIF epilogue as K1/K3/K5/K6/K7: with f32 state the five whole-network
// kernels are bit-equal.
//
// Bound on an H100 SXM (B=2, 256x256): input, membranes in and out, the
// recurrent units' spikes in and out and the flow, once each: ~153 MB with
// bf16 state -> 0.0457 ms at 3.35 TB/s (0.091 ms f32), K3's bytes. 39.94
// GFLOP of mma issued a window at B=2, as K5 and K7.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_loop.so fused_net_loop.cu
#include "fused_net_item.cuh"

namespace evflow {
namespace wholenet {

template <int L, unsigned REC, class S>
__global__ void __launch_bounds__(ITEM_THREADS, 1) fused_net_loop_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const ItemSmem sm = item_start(a, smem_raw);
  int u = 0;
  run_item<S, L, REC>(a, sm, blockIdx.x, u, false);
}

// The unit layouts compiled in: (L, recurrent-unit mask) of LIFFireNet
// (G1, G2 recurrent), LIFFireNet_short, and their feedforward variants.
template <class S>
int launch_layout(WholeNetArgs& a, cudaStream_t stream) {
  unsigned rec = 0;
  for (int l = 0; l < a.L; ++l) {
    if (recurrent(a, l)) rec |= 1u << l;
  }
  auto go = [&](auto kernel) { return launch_items(kernel, a, stream, false); };
  if (a.L == 7 && rec == 0x12u) return go(fused_net_loop_kernel<7, 0x12u, S>);
  if (a.L == 5 && rec == 0x0Au) return go(fused_net_loop_kernel<5, 0x0Au, S>);
  if (a.L == 7 && rec == 0u) return go(fused_net_loop_kernel<7, 0u, S>);
  if (a.L == 5 && rec == 0u) return go(fused_net_loop_kernel<5, 0u, S>);
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
