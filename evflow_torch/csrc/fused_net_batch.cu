// The whole FireNet step in one launch, persistent CTAs that each pull
// (b, tile) items and loop over units inside (K7), for sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_batch.py::fused_firenet_step_batch
// (Pallas, body `_make_kernel`): the TPU version ran one grid step per batch
// element with loops over tiles and units inside. On Hopper the blocks run
// in parallel, so the counterpart is one CTA per SM (the occupancy of the
// 191 KB body) walking the B x tiles items in a stride of the grid, each
// item the runtime unit loop of fused_net_loop2.cu. The zero rings of the
// ping-pong tiles are cleared once per CTA, not per item. Function and
// shared pieces: fused_net_common.cuh.
//
// Bound on an H100 SXM: as fused_net.cu. Single stage, as fused_net.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_batch.so fused_net_batch.cu
#include "fused_net_common.cuh"

namespace evflow {
namespace wholenet {

template <class S>
__global__ void __launch_bounds__(U_THREADS, 1) fused_net_batch_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  uniform_zero(smem);
  const int ntw = (a.W + U_TW - 1) / U_TW, nth = (a.H + U_TH - 1) / U_TH;
  const int items = a.B * nth * ntw;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / (nth * ntw), t = item - b * nth * ntw;
    const int ty = t / ntw, tx = t - ty * ntw;
    uniform_tile<S>(a, b, ty * U_TH, tx * U_TW, smem);
  }
}

template <class S>
int launch(WholeNetArgs& a, cudaStream_t stream) {
  auto kernel = fused_net_batch_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(U_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, U_THREADS,
                                                           U_SMEM)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int items = a.B * ((a.H + U_TH - 1) / U_TH) * ((a.W + U_TW - 1) / U_TW);
  int grid = per_sm * sms;
  if (grid > items) grid = items;
  kernel<<<grid, U_THREADS, U_SMEM, stream>>>(a);
  a.grid = grid;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wholenet
}  // namespace evflow

extern "C" int fused_net_batch(evflow::wholenet::WholeNetArgs* a, void* stream) {
  using namespace evflow::wholenet;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->state_bf16 ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s);
}
