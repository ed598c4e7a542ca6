// The whole FireNet step in one launch, layer as the outer axis (K6), for
// sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_lgrid.py::fused_firenet_step_lgrid
// (Pallas, body `_make_kernel`), whose grid ran the layer index fastest over
// a VMEM-resident tile. On Hopper blocks run in parallel and carry nothing
// from one grid step to the next, so the counterpart is one cooperative,
// persistent launch: every CTA computes unit l over its share of the image's
// (b, 8x32) tiles, the grid waits at a grid-wide barrier, then unit l+1 runs.
// Each unit's spikes go to device memory ([L, B, C, H, W], all kept, as the
// TPU layout does) and are read back by the next unit from L2: at B=2,
// 256x256 one unit's spikes are 8 MB bf16 (16 MB f32) against a 50 MB L2.
// No halo is recomputed. The grid is sized from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor: a cooperative grid larger
// than what is resident at once would deadlock at the barrier. The last
// unit's spikes also go to a shared tile, from which the pred head writes
// the flow. Function and shared pieces: fused_net_common.cuh.
//
// Bound on an H100 SXM: fused_net.cu's bytes plus the spikes of the five
// units that K3 keeps on chip, written once (B=2, 256x256, f32 state:
// ~388 MB -> 0.116 ms at 3.35 TB/s). Per item the body is conv_lif.cu's
// single-stage tile (10x34 halo tile, 8 warps), two CTAs per SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_lgrid.so fused_net_lgrid.cu
#include <cooperative_groups.h>

#include "fused_net_common.cuh"

namespace evflow {
namespace wholenet {

constexpr int G_TH = 8, G_TW = 32;  // output tile per item
constexpr int G_THREADS = 256;
constexpr int G_HALO_PX = (G_TH + 2) * (G_TW + 2);
constexpr size_t G_SMEM =
    (2 * static_cast<size_t>(G_HALO_PX) * SPITCH + static_cast<size_t>(G_TH) * G_TW * SPITCH +
     static_cast<size_t>(C) * WPITCH_MAX) *
    sizeof(__nv_bfloat16);

template <class S>
__global__ void __launch_bounds__(G_THREADS) fused_net_lgrid_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* pbuf = hbuf + G_HALO_PX * SPITCH;
  __nv_bfloat16* obuf = pbuf + G_HALO_PX * SPITCH;
  __nv_bfloat16* wsm = obuf + G_TH * G_TW * SPITCH;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  const int ntw = (a.W + G_TW - 1) / G_TW, nth = (a.H + G_TH - 1) / G_TH;
  const int items = a.B * nth * ntw;
  for (int l = 0; l < a.L; ++l) {
    const int ck = a.ck[l];
    const bool rec = recurrent(a, l), last = l == a.L - 1;
    stage_unit_weights(a.wk[l], ck, wsm);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / (nth * ntw), t = item - b * nth * ntw;
      const int ty = t / ntw, tx = t - ty * ntw;
      const int th0 = ty * G_TH, tw0 = tx * G_TW;
      __syncthreads();  // the previous item is done with the tiles
      if (l == 0) {
        stage_x(a, b, th0 - 1, tw0 - 1, G_TH + 2, G_TW + 2, hbuf);
      } else {
        stage_spikes<S>(a, a.spk_out[l - 1], b, th0 - 1, tw0 - 1, G_TH + 2, G_TW + 2, hbuf);
      }
      if (rec) stage_spikes<S>(a, a.spk_in[l], b, th0 - 1, tw0 - 1, G_TH + 2, G_TW + 2, pbuf);
      __syncthreads();
      const UnitEpilogue<S> epi = unit_epilogue<S>(a, l, b, th0, tw0, th0, tw0, th0 + G_TH,
                                                   tw0 + G_TW, last ? obuf : nullptr, G_TW, 0);
      conv_region<G_THREADS / 32>(hbuf, l == 0 ? XPITCH : SPITCH, ck - (rec ? C : 0),
                                  rec ? pbuf : nullptr, wsm, ck, G_TW, G_TH * G_TW, epi);
      if (last) {
        __syncthreads();
        pred_tile(a, obuf, G_TW, 0, b, th0, tw0, G_TH, G_TW);
      }
    }
    if (!last) grid.sync();  // unit l's spikes are complete before unit l+1 reads them
  }
}

template <class S>
int launch(WholeNetArgs& a, cudaStream_t stream) {
  auto kernel = fused_net_lgrid_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0, coop = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G_THREADS,
                                                           G_SMEM)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1 || !coop) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // every unit's spikes are read back by the next unit
  for (int l = 0; l + 1 < a.L; ++l) {
    if (a.spk_out[l] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int items = a.B * ((a.H + G_TH - 1) / G_TH) * ((a.W + G_TW - 1) / G_TW);
  int grid = per_sm * sms;  // all resident at once: the barrier cannot deadlock
  if (grid > items) grid = items;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(G_THREADS), params, G_SMEM, stream);
  a.grid = grid;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wholenet
}  // namespace evflow

extern "C" int fused_net_lgrid(evflow::wholenet::WholeNetArgs* a, void* stream) {
  using namespace evflow::wholenet;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->state_bf16 ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s);
}
