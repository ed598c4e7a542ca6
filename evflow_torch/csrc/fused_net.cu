// The whole FireNet step in one launch, units unrolled at compile time with
// a shrinking extent (K3), for sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net.py::fused_firenet_step (Pallas, body
// `_make_kernel`): x, per-unit membranes, recurrent units' spikes in; flow,
// membranes and recurrent spikes out, with every inter-unit activation kept
// on chip, the unit loop unrolled over the layer list it is given (any
// number of units, any of them after the head recurrent). Function:
// fused_net_common.cuh.
//
// Schedule. One CTA of 16 warps per (b, 16 x 16 item), B ceil(H/16)
// ceil(W/16) CTAs, each the item body of fused_net_item.cuh (run_item):
// unit l over the owned tile grown by L-1-l pixels a side, m16 fragments
// over the warps, ldmatrix fragments, the epilogue's state loads issued
// together, the weight buffer refilled by TMA bulk copies. What K3 keeps of
// its TPU kernel is the unroll: the kernel is a template on the unit count
// (L = 1..7), so each unit's extent and work count are constants; which
// units are recurrent and the head's width (16 packed channels for Cin <=
// 16, 32 for Cin <= 32) are read from the arguments (run_item's REC_ARGS),
// so the 7 x 2 instantiations take any layer list. K4 compiles the
// recurrent units in as well, for the layouts of the FireNet family. A
// 32-channel head's event tile (30 x 30 pixels at L = 7) outgrows spike
// tile B and runs into tile P (item_layout): every layout fits one CTA's
// shared memory, LIFFireNet's at 228,504 bytes.
//
// Bound on an H100 SXM (B=2, 256x256): input, membranes in and out, the
// recurrent units' spikes in and out and the flow, once each: ~153 MB with
// bf16 state -> 0.0457 ms at 3.35 TB/s (0.091 ms f32). 39.94 GFLOP of mma
// issued a window at B=2, as K4, K5 and K7.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net.so fused_net.cu
#include "fused_net_item.cuh"

namespace evflow {
namespace wholenet {

template <int L, class S>
__global__ void __launch_bounds__(ITEM_THREADS, 1) fused_net_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const ItemSmem sm = item_start(a, smem_raw, item_layout(a));
  int u = 0;
  run_item<S, L, REC_ARGS>(a, sm, blockIdx.x, u, false);
}

template <class S>
int launch_units(WholeNetArgs& a, cudaStream_t stream) {
  auto go = [&](auto kernel) { return launch_items(kernel, a, stream, false); };
  switch (a.L) {
    case 1: return go(fused_net_kernel<1, S>);
    case 2: return go(fused_net_kernel<2, S>);
    case 3: return go(fused_net_kernel<3, S>);
    case 4: return go(fused_net_kernel<4, S>);
    case 5: return go(fused_net_kernel<5, S>);
    case 6: return go(fused_net_kernel<6, S>);
    case 7: return go(fused_net_kernel<7, S>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wholenet
}  // namespace evflow

extern "C" int fused_net(evflow::wholenet::WholeNetArgs* a, void* stream) {
  using namespace evflow::wholenet;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->state_bf16 ? launch_units<__nv_bfloat16>(*a, s) : launch_units<float>(*a, s);
}
