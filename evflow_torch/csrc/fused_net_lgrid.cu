// The whole FireNet step in one launch, layer as the outer axis (K6), for
// sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_lgrid.py::fused_firenet_step_lgrid
// (Pallas, body `_make_kernel`), whose grid ran the layer index fastest over
// a VMEM-resident tile. On Hopper blocks run in parallel and carry nothing
// from one grid step to the next, so the counterpart is one cooperative,
// persistent launch: every CTA computes unit l over its share of the
// image's (b, 16 x 16) tiles, the grid waits at a grid-wide barrier, then
// unit l+1 runs. Each unit's spikes go to device memory ([L, B, C, H, W],
// all kept, as the TPU layout does) and are read back by the next unit from
// L2: at B=2, 256x256 one unit's spikes are 8 MB bf16 (16 MB f32) against a
// 50 MB L2. No halo is recomputed: 20.5 GFLOP of mma a window at B=2, half
// of what the item kernels issue. Function: fused_net_common.cuh.
//
// Schedule. A tile runs fused_net_item.cuh's pieces with the extent the
// owned tile: its input (the events, or unit l-1's spikes read by ld.global.cg,
// since other CTAs wrote them in this launch) staged over the 18 x 18 halo
// a pixel a lane, a recurrent unit's previous spikes the same way, the conv
// and LIF update in m16 fragments by ldmatrix, the state loads of a fragment
// issued together; every unit's spikes to spk_out, the last unit's also to
// a tile for the pred head (flow_tile). The weight buffer is refilled by
// TMA bulk copies: unit l+1's are issued by the warp that is the last to
// read unit l's in the CTA's last tile of the unit, before the grid
// barrier, so they land during it. A CTA is 8 warps (two fragments each a
// tile) with at most 128 registers a thread and 112,664 bytes of shared
// memory at most, so two CTAs share an SM: one stages while the other runs
// its mma. The grid is sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor:
// a cooperative grid larger than what is resident at once would deadlock at
// the barrier (264 CTAs for 512 tiles at B=2, 256x256).
//
// Bound on an H100 SXM: K3's bytes plus the spikes of the units that K3
// keeps on chip, written once (B=2, 256x256: ~195 MB with bf16 state ->
// 0.058 ms at 3.35 TB/s; 0.116 ms f32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_lgrid.so fused_net_lgrid.cu
#include <cooperative_groups.h>

#include "fused_net_item.cuh"

namespace evflow {
namespace wholenet {

constexpr int LG_WARPS = 8;
constexpr int LG_THREADS = LG_WARPS * 32;
constexpr int LG_IN = ITEM_TH + 2;  // the staged input tile's side: the owned tile and its halo

// K6's shared memory (mirrored by ops/fused_net_item.py::lgrid_smem): the
// input tile A (18 x 18 at SPITCH), the last unit's spike tile B (16 x 16),
// the previous spikes P (recurrent nets only), then as item_layout.
__host__ __device__ inline ItemLayout lgrid_layout(const WholeNetArgs& a) {
  ItemLayout s;
  s.tile = LG_IN * LG_IN * SPITCH * 2;
  s.spk = s.tile + ITEM_TH * ITEM_TW * SPITCH * 2;
  place_after_tiles(a, s.spk + (any_recurrent(a) ? s.tile : 0), s);
  return s;
}

template <class S>
__global__ void __launch_bounds__(LG_THREADS, 2) fused_net_lgrid_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const ItemSmem sm = item_start(a, smem_raw, lgrid_layout(a));
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int items = item_count(a);
  const int ntw = (a.W + ITEM_TW - 1) / ITEM_TW, nth = (a.H + ITEM_TH - 1) / ITEM_TH;
  const int lane = threadIdx.x & 31;
  for (int l = 0; l < a.L; ++l) {
    const bool rec = recurrent(a, l), last = l == a.L - 1;
    const int ck = a.ck[l];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / (nth * ntw), t = item - b * nth * ntw;
      const int th0 = (t / ntw) * ITEM_TH, tw0 = (t - (t / ntw) * ntw) * ITEM_TW;
      const bool final_item = item + static_cast<int>(gridDim.x) >= items;
      __syncthreads();  // the last tile is done with the tiles
      if (l == 0) {
        if (item_keeps(ITEM_CUT_EVENT_STAGE)) {
          stage_events<LG_WARPS, LG_IN>(a, b, th0 - 1, tw0 - 1, LG_IN, LG_IN, ck, sm.tile_a);
        }
      } else if (item_keeps(ITEM_CUT_INPUT_STAGE)) {
        stage_prev_spikes<S, LG_WARPS, true>(a, static_cast<const S*>(a.spk_out[l - 1]), b,
                                             th0 - 1, tw0 - 1, LG_IN, LG_IN, sm.tile_a);
      }
      if (rec && item_keeps(ITEM_CUT_SPIKE_STAGE)) {
        stage_prev_spikes<S, LG_WARPS>(a, static_cast<const S*>(a.spk_in[l]), b, th0 - 1,
                                       tw0 - 1, LG_IN, LG_IN, sm.tile_p);
      }
      __syncthreads();  // the input tiles are complete
      auto weights_ready = [&]() {
        if (item_keeps(ITEM_CUT_WEIGHT_STAGE)) mbar_wait(sm.wbar, l & 1);
      };
      auto weights_read = [&]() {  // counted in the CTA's last tile of the unit
        if (!final_item) return;
        unsigned done = 0;
        if (lane == 0) done = atomicAdd(sm.reads, 1u) == (l + 1) * LG_WARPS - 1;
        done = __shfl_sync(0xffffffffu, done, 0);
        if (item_keeps(ITEM_CUT_WEIGHT_STAGE) && done && !last) {
          fence_proxy_async();
          issue_unit_weights(a, l + 1, sm.wsm, sm.wbar);
        }
      };
      conv_lif_unit<S, LG_WARPS>(
          sm.tile_a, l == 0 ? ck + PAD : SPITCH, ck - (rec ? C : 0), rec ? sm.tile_p : nullptr,
          sm.wsm, ck, ITEM_TW, ITEM_TH * ITEM_TW, static_cast<const S*>(a.mem_in[l]),
          static_cast<S*>(a.mem_out[l]), static_cast<S*>(a.spk_out[l]), sm.prm + l * 3 * C, a.H,
          a.W, b, a.hard_reset != 0, th0, tw0, th0, tw0, last ? sm.tile_b : nullptr,
          weights_ready, weights_read);
      if (last) {
        __syncthreads();  // the last unit's spike tile is complete
        if (item_keeps(ITEM_CUT_FLOW)) flow_tile(a, sm.tile_b, sm.prm + a.L * 3 * C, b, th0, tw0);
      }
    }
    // unit l's spikes are complete before unit l+1 reads them
    if (!last && item_keeps(ITEM_CUT_GRID_BARRIER)) grid.sync();
  }
}

template <class S>
int launch(WholeNetArgs& a, cudaStream_t stream) {
  auto kernel = fused_net_lgrid_kernel<S>;
  const int smem = lgrid_layout(a).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {  // two CTAs an SM: the whole carveout as shared memory
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(C) * a.H * a.W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);  // an image's offsets are 32-bit
  }
  int per_sm = 0, device = 0, sms = 0, coop = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LG_THREADS, smem)) !=
          cudaSuccess ||
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
  const int items = item_count(a);
  int grid = per_sm * sms;  // all resident at once: the barrier cannot deadlock
  if (grid > items) grid = items;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(LG_THREADS), params, smem, stream);
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
