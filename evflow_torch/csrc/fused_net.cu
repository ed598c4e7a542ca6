// The whole FireNet step in one launch, units unrolled at compile time with
// a shrinking extent (K3), for sm_90a.
//
// Replaces the TPU kernel
// benchmarks/pallas_archive/fused_net.py::fused_firenet_step (Pallas, body
// `_make_kernel`): x, per-unit membranes, recurrent units' spikes in; flow,
// membranes and recurrent spikes out, with every inter-unit activation kept
// on chip. Function and shared pieces: fused_net_common.cuh.
//
// Schedule. One CTA (16 warps) per (b, 16x16 output tile). It stages the
// event input over the tile plus L pixels around it, then runs the units in
// turn: unit l computes an extent of 16 + 2(L-1-l) pixels square (the halo
// shrinks by one pixel per side per unit), reading its input tile from
// shared memory and writing its spikes, as bf16, into the other of two
// ping-pong tiles; halo pixels read their membrane but never write it. Each
// unit's weights (up to 37 KB for a recurrent unit) are streamed into shared
// memory before it runs; a recurrent unit's previous spikes are staged over
// its input extent. At L = 7: tiles of 28x28 and 26x26 pixels (63 + 54 KB),
// the event / previous-spike tile (63 KB) and the weights (37 KB): 212 KB,
// one CTA per SM. The halo recompute costs 3500 / 1792 = 1.95x the useful
// MACs at 16x16.
//
// Bound on an H100 SXM (B=2, 256x256, f32 state): ~304 MB of state, input
// and flow, once each, -> 0.091 ms at 3.35 TB/s (0.046 ms with bf16 state);
// ~19.4 GFLOP of bf16 tensor work is below that. This first version is
// single-stage: weight and tile loads are not overlapped with the mma.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_net.so fused_net.cu
#include "fused_net_common.cuh"

namespace evflow {
namespace wholenet {

constexpr int K3_TILE = 16;
constexpr int K3_THREADS = 512;

template <int L>
struct K3Geom {
  static constexpr int E0 = K3_TILE + 2 * (L - 1);  // the head's output extent
  static constexpr int A_ELEMS = E0 * E0 * SPITCH;  // even units' outputs
  static constexpr int B_ELEMS = (E0 - 2) * (E0 - 2) * SPITCH;  // odd units' outputs
  // the event tile (E0 + 2 square) or a recurrent unit's previous spikes
  // (at most E0 square: the head is never recurrent)
  static constexpr int P_ELEMS = (E0 + 2) * (E0 + 2) * XPITCH > E0 * E0 * SPITCH
                                     ? (E0 + 2) * (E0 + 2) * XPITCH
                                     : E0 * E0 * SPITCH;
  static constexpr size_t SMEM =
      (static_cast<size_t>(A_ELEMS) + B_ELEMS + P_ELEMS + C * WPITCH_MAX) *
      sizeof(__nv_bfloat16);
};

template <int L, class S>
__global__ void __launch_bounds__(K3_THREADS, 1) fused_net_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using G = K3Geom<L>;
  __nv_bfloat16* bufA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bufB = bufA + G::A_ELEMS;
  __nv_bfloat16* bufP = bufB + G::B_ELEMS;
  __nv_bfloat16* wsm = bufP + G::P_ELEMS;

  const int b = blockIdx.z, th0 = blockIdx.y * K3_TILE, tw0 = blockIdx.x * K3_TILE;
  stage_x(a, b, th0 - L, tw0 - L, G::E0 + 2, G::E0 + 2, bufP);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int halo = L - 1 - l;  // pixels of halo around the tile in unit l's output
    const int eo = K3_TILE + 2 * halo;
    const int ck = a.ck[l];
    const bool rec = recurrent(a, l);
    stage_unit_weights(a.wk[l], ck, wsm);
    if (rec) stage_spikes<S>(a, a.spk_in[l], b, th0 - halo - 1, tw0 - halo - 1, eo + 2, eo + 2, bufP);
    __syncthreads();
    const __nv_bfloat16* in = l == 0 ? bufP : ((l & 1) ? bufA : bufB);
    __nv_bfloat16* out = (l & 1) ? bufB : bufA;
    const UnitEpilogue<S> epi =
        unit_epilogue<S>(a, l, b, th0 - halo, tw0 - halo, th0, tw0, th0 + K3_TILE,
                         tw0 + K3_TILE, out, eo, 0);
    conv_region<K3_THREADS / 32>(in, l == 0 ? XPITCH : SPITCH, ck - (rec ? C : 0),
                                 rec ? bufP : nullptr, wsm, ck, eo, eo * eo, epi);
    __syncthreads();
  }
  pred_tile(a, ((L - 1) & 1) ? bufB : bufA, K3_TILE, 0, b, th0, tw0, K3_TILE, K3_TILE);
}

template <int L, class S>
int launch(WholeNetArgs& a, cudaStream_t stream) {
  const size_t smem = K3Geom<L>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(fused_net_kernel<L, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + K3_TILE - 1) / K3_TILE, (a.H + K3_TILE - 1) / K3_TILE, a.B);
  fused_net_kernel<L, S><<<grid, K3_THREADS, smem, stream>>>(a);
  a.grid = static_cast<int>(grid.x * grid.y * grid.z);
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int launch_units(WholeNetArgs& a, cudaStream_t stream) {
  switch (a.L) {  // LIFFireNet and the _short variants
    case 7: return launch<7, S>(a, stream);
    case 5: return launch<5, S>(a, stream);
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
