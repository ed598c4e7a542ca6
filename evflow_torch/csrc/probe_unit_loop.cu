// The unit-loop probes: one conv+LIF unit as the body of a runtime layer
// loop, its operands staged into shared memory with the TMA engine, for
// sm_90a.
//
// Replaces the TPU kernels of
//   benchmarks/probe_loop_dyn4.py (`make_kernel(with_lif, dyn_out)`, K8i):
//     h = x [C, E, W]; for l < L:
//       ff   = conv3(h, w[l][:, :9C]) + conv3(aux, w[l][:, 9C:]) + bias_l,  aux = h
//       u    = mem_l > theta ? 0 : beta mem_l + ff;  spk = u > theta;
//       mem2 = u > theta ? 0 : u             (with LIF; without: spk = ff,
//                                             mem2 = ff + mem_l)
//       out[l] = f32(bf16(mem2[:, 8:8+TH]))   (dyn_out; else every out[l] is
//                                             the final h[:, 8:8+TH])
//       h = bf16(spk)
//     with w [L, C, 18C], p [L, C, 3] and mem [L, C, E, W] read at the
//     runtime layer index; conv3 is a 3x3 conv, zero outside rows [0, E)
//     and columns [0, W), K index dy 3C + dx C + c, bf16 products in f32;
//   benchmarks/probe_loop_dyn5.py (`k16`, K8j): the same body (LIF,
//     dyn_out) after a DMA prologue, aux = slot s(l) (0 at l=1, 1 at l=2,
//     else 2) of the spike slots spk [3, C, E, W], slot 2 being zeros; each
//     layer's spikes (rows 8:8+TH) are stored to slot s(l) of a scratch.
//
// Design. One CTA per TW = 16 output columns keeps all E rows of the window
// (one bf16 [C, E, W] window is 393 KB, beyond a CTA's 227 KB) and a halo of
// HALO columns on each side (L rounded up to a multiple of 8), whose values
// it recomputes each layer as the TPU's K5 (fused_net_loop2.py) does:
// every layer computes the same TW + 2(L-1) columns on all E rows, and a
// layer's output is exact one column further in than its input, so after L
// layers the owned columns are exact. Rows need no halo: the window is the
// whole image in rows, and the rows -1 and E of the buffers stay zero.
//   Staging. x, each layer's membrane and (K8j) each layer's spike slot are
// one TMA tensor copy each (cp.async.bulk.tensor.4d, a tensor map over
// [slot|layer, C, E, W]) of the box [C][E][BW] at the runtime layer or slot
// index, on one mbarrier; the membrane's copy completes with that layer's
// weights (one 1-D bulk copy per weight row). The tensor map, not 1-D bulk
// copies, because a 1-D copy per (channel, row) would be C E = 768 copies
// per tensor, and the columns outside the image would have to be zeroed by
// hand; the tensor copy fills them with zeros, which is the conv's padding.
// The halo is 8 columns, not L = 4, so that the box starts on a 16-byte
// boundary: a box starting 8 bytes off (HALO 4) faulted with an illegal
// instruction on the H100, one starting on the boundary did not. The TPU
// prologue stages x, all L membranes and both slots up front; here each
// layer's slot and then its membrane and weights are staged as the layer
// starts, through one staging area (x, L membranes, 2 slots and the buffers
// would not fit in shared memory), synchronously: the copy does not overlap
// the mma.
//   Mainloop. The copies land channel-major; the conv wants pixel-major
// rows (a pixel's 32 channels contiguous, pitch 40 bf16) so that a tap's
// column shift is a row offset, so x and each staged slot are transposed
// once in shared memory; the next layer's h is written pixel-major by the
// epilogue. mma.sync m16n8k16 bf16 -> f32, pixels on M (two m16 fragments
// per 32-pixel pair), the 32 output channels on N, k over the 9 taps x 32
// channels of h and then of aux (wholenet::mma_k16, the whole-net kernels'
// fragment loads). Each warp keeps the accumulators of PPW pairs in
// registers for the whole layer, so h is updated in place after a barrier
// and needs no second buffer. K8j skips the zero slot's half (its products
// are exact zeros).
//   Epilogue. bias, beta, theta from p at the runtime layer index; the
// membrane read channel-major from the staged box; the LIF with every
// rounding explicit (no fused multiply-add); h = bf16(spk), zero outside
// columns [0, W); the owned pixels of rows 8..8+TH written to out (and, when
// `slots_out` is given, the spikes to slot s(l): a check that the
// runtime-index store happened, on a branch the timed launches skip).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), at the probes' shapes
// (L=4, C=32, E=24, W=256, TH=8), for what each function needs (the cone of
// rows that reaches the output, probes/unit_loop.py::unit_loop_bytes):
//   K8i with LIF 2.18 MB -> 0.65 us, without LIF 1.98 MB -> 0.59 us
//     (0.415 GFLOP -> 0.42 us);
//   K8j 2.57 MB -> 0.77 us (0.311 GFLOP).
// The grid is W / TW = 16 CTAs on 132 SMs with L serial layers, each a
// synchronous stage, a transposition and a mainloop: latency-bound, a few
// microseconds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_unit_loop.so probe_unit_loop.cu
#include <cstring>

#include "fused_net_common.cuh"
#include "tma.cuh"

namespace evflow {
namespace unitloop {

using wholenet::C;       // 32 channels
using wholenet::NF;      // n8 fragments of the output channels
using wholenet::SPITCH;  // bf16 per pixel of a pixel-major buffer
constexpr int K = 18 * C;          // weights per output channel: h half, aux half
constexpr int WPITCH = K + PAD;    // bf16 per staged weight row
constexpr int TW = 16;             // owned columns per CTA
constexpr int R0 = 8;              // first output row
constexpr int PPW = 2;             // 32-pixel pairs per warp
constexpr int MAX_WARPS = 16;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA

// Mirrored by ctypes in evflow_torch/probes/unit_loop.py.
struct UnitLoopArgs {
  const __nv_bfloat16* x;    // [C, E, W]
  const __nv_bfloat16* w;    // [L, C, 18C]
  const float* p;            // [L, C, 3]: bias, beta, theta
  const __nv_bfloat16* mem;  // [L, C, E, W]
  const __nv_bfloat16* spk;  // [3, C, E, W] spike slots (K8j), else null
  float* out;                // [L, C, TH, W]
  __nv_bfloat16* slots_out;  // [3, C, TH, W], or null: no slots stored
  int L, C, E, W, TH, with_lif, dyn_out;
  int grid, threads, smem;  // set by the launch
};

// What the kernel reads: tensor maps of x, mem and spk, the rest plain, and
// the byte offsets of its shared-memory regions (128-byte aligned).
struct Params {
  CUtensorMap x, mem, spk;
  const __nv_bfloat16* w;
  const float* p;
  float* out;
  __nv_bfloat16* slots_out;
  int L, E, W, TH, halo, bw, n_pairs;
  int off_h, off_aux, off_sm, off_w;
};

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Channel-major box [C][E][bw] -> rows 1..E of a pixel-major buffer [(E+2) bw][SPITCH].
__device__ __forceinline__ void to_pixel_major(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                               int E, int bw) {
  const int plane = E * bw;
  for (int e = threadIdx.x; e < C * plane; e += blockDim.x) {
    const int c = e / plane, px = e - c * plane;
    dst[(px + bw) * SPITCH + c] = src[e];
  }
}

template <bool LIF, bool DYN, bool SLOTS>
__global__ void __launch_bounds__(MAX_WARPS * 32) unit_loop_kernel(const __grid_constant__ Params a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + a.off_h);    // h, pixel-major
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(smem + a.off_aux);  // aux (K8j), else h
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem + a.off_sm);   // x, slot s(l), mem[l]
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + a.off_w);   // w[l], [C][WPITCH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int E = a.E, bw = a.bw;
  const int w0 = blockIdx.x * TW;
  const int col0 = w0 - a.halo;          // image column of buffer column 0
  const int wo = TW + 2 * (a.L - 1);     // computed columns: buffer columns cb .. cb+wo-1
  const int cb = a.halo - (a.L - 1);
  const int n_out = E * wo;
  const uint32_t box = static_cast<uint32_t>(C) * E * bw * 2;

  if (threadIdx.x == 0) mbar_init(bar);
  {  // h and aux, whose rows -1 and E stay zero (the rest is overwritten)
    uint4* z = reinterpret_cast<uint4*>(hb);
    for (int i = threadIdx.x; i < (a.off_sm - a.off_h) / 16; i += blockDim.x) {
      z[i] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  uint32_t parity = 0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, box);
    tensor_copy_4d(sm, &a.x, col0, 0, 0, 0, bar);
  }
  mbar_wait(bar, parity);
  parity ^= 1u;
  to_pixel_major(sm, hb, E, bw);
  fence_proxy_async();  // this thread's reads of sm before the copies below
  __syncthreads();

#pragma unroll 1
  for (int l = 0; l < a.L; ++l) {
    const int slot = l == 1 ? 0 : (l == 2 ? 1 : 2);
    const bool has_aux = !SLOTS || slot < 2;
    if (SLOTS && has_aux) {  // the slot first, through the staging area
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar, box);
        tensor_copy_4d(sm, &a.spk, col0, 0, 0, slot, bar);
      }
      mbar_wait(bar, parity);
      parity ^= 1u;
      to_pixel_major(sm, ab, E, bw);
      fence_proxy_async();
      __syncthreads();
    }
    if (warp == 0) {  // lane 0 arms the barrier and copies the membrane, the lanes the weight rows
      if (lane == 0) {
        mbar_expect_tx(bar, box + C * K * 2);
        tensor_copy_4d(sm, &a.mem, col0, 0, 0, l, bar);
      }
      __syncwarp();
      const __nv_bfloat16* wl = a.w + static_cast<size_t>(l) * C * K;
      for (int r = lane; r < C; r += 32) bulk_copy(wsm + r * WPITCH, wl + r * K, K * 2, bar);
    }
    mbar_wait(bar, parity);
    parity ^= 1u;

    float acc[PPW][2][NF][4];
#pragma unroll
    for (int pp = 0; pp < PPW; ++pp)
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[pp][mf][nf][i] = 0.f;

#pragma unroll
    for (int pp = 0; pp < PPW; ++pp) {
      const int pair = warp * PPW + pp;
      if (pair >= a.n_pairs) break;
      int pix[2][2];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = min(pair * 32 + mf * 16 + half * 8 + g, n_out - 1);  // ragged: a valid pixel
          const int r = px / wo;
          pix[mf][half] = r * bw + cb - 1 + (px - r * wo);  // its tap (0, 0)
        }
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * dy;
        const int toff = dy * bw + dx;
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += 16) {
          wholenet::mma_k16(hb, SPITCH, pix, toff, c0, wsm, WPITCH, tap * C + c0, g, q, acc[pp]);
          if (has_aux) {
            wholenet::mma_k16(ab, SPITCH, pix, toff, c0, wsm, WPITCH, 9 * C + tap * C + c0, g, q,
                              acc[pp]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done reading h, aux and the weights

    const float* pl = a.p + static_cast<size_t>(l) * C * 3;
    const size_t plane_out = static_cast<size_t>(C) * a.TH * a.W;
#pragma unroll
    for (int pp = 0; pp < PPW; ++pp) {
      const int pair = warp * PPW + pp;
      if (pair >= a.n_pairs) break;
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int px = pair * 32 + mf * 16 + half * 8 + g;
          if (px >= n_out) continue;
          const int r = px / wo, bc = cb + px - r * wo;  // row, buffer column
          const int img = col0 + bc;
          const bool inside = img >= 0 && img < a.W;
          const bool own = inside && r >= R0 && r < R0 + a.TH && bc >= a.halo && bc < a.halo + TW;
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int ch = nf * 8 + 2 * q + j;
              const float ff = __fadd_rn(acc[pp][mf][nf][2 * half + j], __ldg(pl + ch * 3));
              const float m = bf2f(sm[(ch * E + r) * bw + bc]);
              float spk, mem2;
              if (LIF) {
                const float beta = __ldg(pl + ch * 3 + 1), theta = __ldg(pl + ch * 3 + 2);
                const float u = m > theta ? 0.f : __fadd_rn(__fmul_rn(beta, m), ff);
                spk = u > theta ? 1.f : 0.f;
                mem2 = u > theta ? 0.f : u;
              } else {
                spk = ff;
                mem2 = __fadd_rn(ff, m);
              }
              hb[((r + 1) * bw + bc) * SPITCH + ch] = __float2bfloat16_rn(inside ? spk : 0.f);
              if (own) {
                const size_t o = (static_cast<size_t>(ch) * a.TH + (r - R0)) * a.W + img;
                if (DYN) a.out[l * plane_out + o] = bf2f(__float2bfloat16_rn(mem2));
                if (SLOTS && a.slots_out != nullptr) {
                  a.slots_out[slot * plane_out + o] = __float2bfloat16_rn(spk);
                }
              }
            }
        }
    }
    fence_proxy_async();  // this thread's reads of sm and wsm before the next layer's copies
    __syncthreads();
  }

  if (!DYN) {  // every out[l] is the final h's output rows
    for (int i = threadIdx.x; i < C * a.TH * TW; i += blockDim.x) {
      const int ch = i / (a.TH * TW), rem = i - ch * a.TH * TW;
      const int t = rem / TW, cc = rem - t * TW;
      if (w0 + cc >= a.W) continue;
      const float v = bf2f(hb[((R0 + t + 1) * bw + a.halo + cc) * SPITCH + ch]);
      for (int l = 0; l < a.L; ++l) {
        a.out[((static_cast<size_t>(l) * C + ch) * a.TH + t) * a.W + w0 + cc] = v;
      }
    }
  }
}

// --- host side ----------------------------------------------------------------

// A map over `planes` contiguous bf16 tensors [C, E, W] whose box is
// [C][E][bw] of one plane, zero-filled outside the tensor.
bool encode(CUtensorMap* map, const void* base, int planes, int E, int W, int bw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(E),
                              static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(W) * 2,
                                 static_cast<cuuint64_t>(E) * W * 2,
                                 static_cast<cuuint64_t>(C) * E * W * 2};
  const cuuint32_t boxdim[4] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(E),
                                static_cast<cuuint32_t>(C), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            boxdim, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool LIF, bool DYN, bool SLOTS>
int launch(UnitLoopArgs& a, cudaStream_t stream) {
  Params prm;
  memset(&prm, 0, sizeof(prm));
  prm.halo = (a.L + 7) / 8 * 8;  // the box starts on a 16-byte boundary
  prm.bw = TW + 2 * prm.halo;
  prm.n_pairs = (a.E * (TW + 2 * (a.L - 1)) + 31) / 32;
  const int warps = (prm.n_pairs + PPW - 1) / PPW;
  if (warps > MAX_WARPS || prm.bw > 256) return static_cast<int>(cudaErrorInvalidValue);
  auto up = [](int v) { return (v + 127) / 128 * 128; };
  const int hbytes = up((a.E + 2) * prm.bw * SPITCH * 2), box = up(C * a.E * prm.bw * 2);
  int off = 128;  // the mbarrier
  prm.off_h = off;
  off += hbytes;
  prm.off_aux = SLOTS ? off : prm.off_h;
  off += SLOTS ? hbytes : 0;
  prm.off_sm = off;
  off += box;
  prm.off_w = off;
  off += C * WPITCH * 2;
  if (off > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (!encode(&prm.x, a.x, 1, a.E, a.W, prm.bw) || !encode(&prm.mem, a.mem, a.L, a.E, a.W, prm.bw) ||
      (SLOTS && !encode(&prm.spk, a.spk, 3, a.E, a.W, prm.bw))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.w = a.w;
  prm.p = a.p;
  prm.out = a.out;
  prm.slots_out = a.slots_out;
  prm.L = a.L;
  prm.E = a.E;
  prm.W = a.W;
  prm.TH = a.TH;
  auto kernel = unit_loop_kernel<LIF, DYN, SLOTS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, off);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.W + TW - 1) / TW;
  kernel<<<grid, warps * 32, off, stream>>>(prm);
  a.grid = grid;
  a.threads = warps * 32;
  a.smem = off;
  return static_cast<int>(cudaGetLastError());
}

bool args_valid(const UnitLoopArgs& a, bool slots) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w) |
                         reinterpret_cast<uintptr_t>(a.p) | reinterpret_cast<uintptr_t>(a.mem) |
                         reinterpret_cast<uintptr_t>(a.out) |
                         reinterpret_cast<uintptr_t>(a.spk) |
                         reinterpret_cast<uintptr_t>(a.slots_out);
  return a.x != nullptr && a.w != nullptr && a.p != nullptr && a.mem != nullptr &&
         a.out != nullptr && (!slots || a.spk != nullptr) && ptrs % 16 == 0 && a.C == C &&
         a.L >= 1 && a.TH >= 1 && a.E >= R0 + a.TH && a.E <= 256 && a.W >= 1 && a.W % 8 == 0;
}

}  // namespace unitloop
}  // namespace evflow

// The one entry point: K8j's body where `spk` is given (with LIF and
// dyn_out only), else K8i's. It returns the launch's cudaError_t (0 on
// success) and refuses what the kernel does not take: C other than 32,
// pointers not 16-byte aligned, rows of W bf16 not whole 16-byte pieces,
// output rows beyond E, a window whose pixels need more than 16 warps.
extern "C" int probe_unit_loop(evflow::unitloop::UnitLoopArgs* a, void* stream) {
  using namespace evflow::unitloop;
  const bool slots = a->spk != nullptr;
  if (!args_valid(*a, slots) || (slots && (!a->with_lif || !a->dyn_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots) return launch<true, true, true>(*a, s);
  if (a->with_lif) {
    return a->dyn_out ? launch<true, true, false>(*a, s) : launch<true, false, false>(*a, s);
  }
  return a->dyn_out ? launch<false, true, false>(*a, s) : launch<false, false, false>(*a, s);
}
