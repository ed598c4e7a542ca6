// The whole FireNet step in one launch, persistent CTAs that each pull
// (b, tile) items and loop over units inside (K7), for sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net_batch.py::fused_firenet_step_batch
// (Pallas, body `_make_kernel`): the TPU version ran one grid step per batch
// element with loops over tiles and units inside. On Hopper the blocks run
// in parallel, so the counterpart is one CTA of 16 warps per SM walking the
// (b, tile) items in a stride of the grid, each item the runtime unit loop.
// Function: fused_net_common.cuh; the mainloop's k order, the LIF update and
// the pred head are the other schedules', so the flows agree bit for bit.
// The item body (every piece below but the persistent loop) is
// fused_net_item.cuh's run_item, which K5, K4 and K3 run too, an item a CTA.
//
// What held the first version back, measured (probes/wholenet_slope.py
// --split, variant builds with one part taken out): 1.88 ms at B=2, bf16
// state, 34 us a unit and item, 78% of it the epilogue, whose state load,
// LIF update and stores ran once per output element as a chain of
// dependent round trips (its plain pointers kept each load behind the last
// store), 16% the element-wise staging of the recurrent spikes, and a
// uniform extent that ran every unit over (8 + 2(L-1)) x (16 + 2(L-1))
// pixels of an 8 x 16 tile. The design:
//
//   Extent. An item owns a 16 x 16 tile (512 items at B=2, 256x256: four
// a CTA, where 8 x 16 tiles gave eight with the same per-item costs).
// Unit l computes the tile grown by L-1-l pixels a side, exactly unit
// l+1's input extent: its output tile is the next unit's input tile, no
// zero ring, and the last unit's extent is the owned tile; 3,536 fragment-
// rounded pixels an item at L=7, 13.8 an owned pixel against 31.5 before.
//   Work. The warps take m16 fragments (16 pixels x the 32 output
// channels): accumulators and state of 16 elements a lane, so that the
// kernel keeps within 128 registers without a spill (32-pixel pairs
// spilled), and a unit's last round is at most 16 pixels long.
//   Fragments. ldmatrix.x4 for A (16 pixels x 16 k of the staged tile, one
// row address a lane) and B (16 output channels x 16 k of the weights): 3
// loads per 4 mma, against 12 32-bit loads; the rows' padding (8 bf16)
// keeps them free of bank conflicts.
//   Epilogue. After a fragment's k loop its 16 state loads (read-only,
// ld.global.nc, 32-bit offsets within an image) are issued together, then
// the LIF update runs on registers with the unit's parameters in shared
// memory, then the stores: one round trip a fragment, not one an element.
//   Weights. One buffer of the widest unit: each warp counts itself done
// with a unit's weights after its last k loop, and the warp that completes
// the count issues the next unit's 32 weight rows (the next item's first
// unit after the last) as TMA bulk copies onto the buffer's mbarrier, so
// they land during the unit's last epilogues and the next unit's staging.
//   Staging. The event input and the recurrent spikes are read a row of up
// to 32 pixels a warp, a pixel a lane, every load of a lane issued before
// its stores; a spike pixel's 32 channels go to shared memory as four
// 16-byte stores.
//   Shared memory: two spike tiles of unit 0's output extent (62,720 bytes
// at L=7; the event tile lives in the second until unit 1 writes it), one
// for the previous spikes of a recurrent unit, one weight buffer of the
// widest unit, the parameters and the pred head: 228,504 bytes at L=7 with
// a recurrent unit.
//
// Bound on an H100 SXM: as fused_net.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net_batch.so fused_net_batch.cu
#include "fused_net_item.cuh"

namespace evflow {
namespace wholenet {

template <class S>
__global__ void __launch_bounds__(ITEM_THREADS, 1) fused_net_batch_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const ItemSmem sm = item_start(a, smem_raw, item_layout(a));
  const int items = item_count(a);
  int u = 0;  // units this CTA has run
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    run_item<S>(a, sm, item, u, item + static_cast<int>(gridDim.x) < items);
  }
}

}  // namespace wholenet
}  // namespace evflow

extern "C" int fused_net_batch(evflow::wholenet::WholeNetArgs* a, void* stream) {
  using namespace evflow::wholenet;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->state_bf16 ? launch_items(fused_net_batch_kernel<__nv_bfloat16>, *a, s, true)
                       : launch_items(fused_net_batch_kernel<float>, *a, s, true);
}
