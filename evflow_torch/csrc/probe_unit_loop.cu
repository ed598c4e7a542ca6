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
// Design. The outputs depend only on a cone: layer l (d = L-1-l layers
// before the last) is needed on the output rows and columns widened by d on
// each side, clipped to the image, and reads its input one pixel further
// out (zero outside the image). One CTA owns TW = 8 columns (one 16-byte
// piece of a bf16 row) by t output rows, t chosen by the launch so that
// the grid covers the SMs once (t = 2, 32 x 4 = 128 CTAs at the probes'
// shapes; at most TMAX rows), and computes each layer on its cone only,
// recomputing the halo of its neighbours (the TPU probe computes every
// layer on all E rows of its one window).
//   Staging. x, each layer's membrane and K8j's two spike slots are TMA
// tensor copies (cp.async.bulk.tensor.4d, zero-filled outside the tensor,
// which is the conv's padding) of boxes that start on a 16-byte boundary
// (a box 8 bytes off one faulted with an illegal instruction on the H100);
// each layer's weights are 32 bulk copies of its rows, its parameters one.
// None of them depends on the loop, so they go through a ring of two
// stages (one where two do not fit), each with two mbarriers: one for what
// the mma needs (weights, slot), one for what the epilogue needs
// (parameters, membrane). The last warp issues them: layer l+2's weights,
// a row a lane, once every warp's mma of layer l is done, its parameters,
// membrane and slot once its epilogue is; they land while layer l+1 runs.
// x lands in the last stage's data area, whose own copies follow x's
// transposition; where a slot and a membrane do not both fit, the
// membrane follows the slot's transposition into the same area.
//   Mainloop. The copies land channel-major; the conv wants pixel-major rows
// (a pixel's 32 channels contiguous, pitch 40 bf16) so that a tap is a row
// offset: x and each slot are transposed in 8 x 8 pieces by ldmatrix.trans
// and stmatrix. mma.sync m16n8k16 bf16 -> f32, the pixels of the layer's
// cone flattened onto m16 fragments, the 32 output channels on N, k over
// the 9 taps x 32 channels of h and then of aux; A and B fragments by
// ldmatrix (any pixel per lane, so the cone's ragged rows cost nothing).
// The fragments are spread over the SM's four sub-partitions, two a warp
// at most, and a warp runs its 36 k16 steps straight-line, the next
// step's fragments loaded before this step's mma; a warp with one fragment
// puts alternate steps on two accumulator sets. K8i's aux half reuses h's
// A fragments; K8j skips the zero slot's half (its products are exact
// zeros). Cones of more than 16 fragments (large L) take the kernel of 4
// fragments a warp on 16 warps, whose loop over the taps is rolled. The
// transposition, the step fold and the tensor store are pixel_conv.cuh's,
// shared with probe_wholenet_bisect.cu.
//   Epilogue. After a barrier (every warp has read h), bias, beta and theta
// in registers from the staged parameters, the membrane from the staged
// box, the LIF with every rounding explicit (no fused multiply-add), the
// spikes written in place to h as bf16 pairs, the owned pixels' outputs
// (and K8j's slots, by the layer that writes each slot last) to a tile in
// shared memory that one TMA tensor store writes out (clipped to the
// tensor), two tiles in turn.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), at the probes' shapes
// (L=4, C=32, E=24, W=256, TH=8), for what each function needs
// (probes/unit_loop.py::unit_loop_bytes):
//   K8i with LIF 2.18 MB -> 0.65 us, without LIF 1.98 MB -> 0.59 us
//     (0.415 GFLOP -> 0.42 us);
//   K8j 2.57 MB -> 0.77 us (0.311 GFLOP).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: K8i 14.6-15.3 us, K8j
// 17.1 us, about 23x the bound; 6.0 us at L = 1 and 3.0 us a further
// layer. What holds it: the mma at the sub-partitions' mma.sync rate on
// the halo'd cone (28% of the time), the epilogue and its barriers, the
// first copies (x and layer 0's weights, which every CTA reads from L2 at
// once), and the launch.
//
// A variant build -DUL_CUT=UL_CUT_<part> takes one part out (keeps(part)
// is false), for the split of probes/unit_loop.py --split; -DUL_ROWS=n
// fixes the owned rows of a CTA. Such a build computes wrong results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_unit_loop.so probe_unit_loop.cu
#include <cstring>
#include <utility>

#include "fused_net_common.cuh"
#include "pixel_conv.cuh"
#include "tma.cuh"

namespace evflow {
namespace unitloop {

using wholenet::C;       // 32 channels
using wholenet::NF;      // n8 fragments of the output channels
using wholenet::SPITCH;  // bf16 per pixel of a pixel-major buffer
using pixconv::encode;
using pixconv::layer_mma;
using pixconv::mma_n32;
using pixconv::tensor_store_4d;
using pixconv::to_pixel_major;
constexpr int K = 18 * C;          // weights per output channel: h half, aux half
constexpr int WPITCH = K + PAD;    // bf16 per staged weight row
constexpr int TW = 8;              // owned columns per CTA
constexpr int TMAX = 8;            // most owned rows per CTA
constexpr int R0 = 8;              // first output row
constexpr int FPW = 4;             // most m16 fragments a warp keeps per layer (2 or 4 compiled)
constexpr int SUBPARTS = 4;        // an SM's sub-partitions, each a tensor core
constexpr int MIN_WARPS = 8;
constexpr int MAX_WARPS = 16;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int WBYTES = C * K * 2;   // one layer's weights
constexpr int PBYTES = C * 3 * 4;   // one layer's bias, beta, theta
constexpr int WREGION = (C * WPITCH * 2 + 127) / 128 * 128;
constexpr int DATA_OFF = WREGION + (PBYTES + 127) / 128 * 128;  // a stage's boxes

// The parts a variant build takes out (-DUL_CUT=UL_CUT_<part>).
enum UnitLoopCut {
  UL_CUT_NONE,
  UL_CUT_X_STAGE,     // x is neither copied nor transposed
  UL_CUT_SLOT_STAGE,  // K8j: no slot copy or transposition
  UL_CUT_RING,        // no weight, parameter or membrane copy: the ring is read as it lies
  UL_CUT_MMA,         // no fragment load and no mma
  UL_CUT_LOADS,       // the epilogue's parameters and membranes read as constants
  UL_CUT_STORES,      // no output or slot tile, no tensor store
};
#ifndef UL_CUT
#define UL_CUT UL_CUT_NONE
#endif
__host__ __device__ constexpr bool keeps(UnitLoopCut part) { return UL_CUT != part; }

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

__host__ __device__ constexpr int ceil8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ constexpr int up128(int v) { return (v + 127) / 128 * 128; }

// The launch's geometry (mirrored by probes/unit_loop.py::launch_layout):
// the owned rows t, the tiles, the ring, the buffers and boxes, and the byte
// offsets of the shared-memory regions.
struct Layout {
  int t, n_ct, n_rt, stages, alias, warps, fpw;  // fpw: the kernel's fragments a warp
  int HR, HC;      // pixel-major h (and aux) buffer: rows, columns
  int BX;          // x and slot boxes: columns (rows HR)
  int MR, BM;      // membrane box: rows, columns
  int xbytes, mbytes;  // x (slot) box, membrane box
  int slot_off, stage;  // a slot's offset in a stage's data area; bytes per stage
  int off_h, off_aux, off_ring, off_out, off_slt, tile, stile, total;
};

// The layout at `t` owned rows, `stages` ring stages and (K8j) the slot
// sharing the membrane's area (`alias`), or false where it exceeds what the
// kernel takes.
inline bool fill_layout(int L, int E, int W, int t, int stages, int alias, bool slots,
                        Layout& s) {
  s.t = t;
  s.stages = stages;
  s.alias = alias;
  s.HR = E + 2 < t + 2 * L ? E + 2 : t + 2 * L;
  s.HC = TW + 2 * L;
  s.BX = TW + 2 * ceil8(L);
  s.MR = E < t + 2 * (L - 1) ? E : t + 2 * (L - 1);
  s.BM = TW + 2 * ceil8(L - 1);
  s.xbytes = C * s.HR * s.BX * 2;
  s.mbytes = C * s.MR * s.BM * 2;
  const int area = up128(s.xbytes) > up128(s.mbytes) ? up128(s.xbytes) : up128(s.mbytes);
  s.slot_off = alias ? 0 : area;
  s.stage = DATA_OFF + area + (slots && !alias ? up128(s.xbytes) : 0);
  const int hbytes = up128(s.HR * s.HC * SPITCH * 2);
  int off = 128;  // the barriers and a dummy row
  s.off_h = off;
  off += hbytes;
  s.off_aux = slots ? off : s.off_h;
  off += slots ? hbytes : 0;
  s.off_ring = off;
  off += stages * s.stage;
  s.tile = up128(C * t * TW * 4);
  s.off_out = off;
  off += 2 * s.tile;
  s.stile = up128(C * t * TW * 2);
  s.off_slt = off;
  off += slots ? 2 * s.stile : 0;
  const int cols = W < TW + 2 * (L - 1) ? W : TW + 2 * (L - 1);
  const int frags = (s.MR * cols + 15) / 16;  // layer 0's cone, the largest
  // up to 2 fragments a warp on MIN_WARPS warps (the kernel's registers for
  // 256 threads), else FPW on MAX_WARPS
  s.fpw = frags <= 2 * MIN_WARPS ? 2 : FPW;
  s.warps = s.fpw == 2 ? MIN_WARPS : MAX_WARPS;
  s.total = off;
  return s.total <= SMEM_LIMIT && frags <= FPW * s.warps && s.HR <= 256 && s.BX <= 256 &&
         s.BM <= 256;
}

// The tiles: TW columns by t rows, t the rows that let the grid cover the
// SMs once (at most TMAX), shrunk where the layout does not fit; then two
// ring stages, else one, K8j's slot apart from the membrane, else sharing.
inline bool make_layout(int L, int E, int TH, int W, int sms, bool slots, Layout& s) {
  const int n_ct = W / TW;
  int n_rt = sms / n_ct > (TH + TMAX - 1) / TMAX ? sms / n_ct : (TH + TMAX - 1) / TMAX;
  n_rt = n_rt < TH ? n_rt : TH;
  int t0 = (TH + n_rt - 1) / n_rt;
#ifdef UL_ROWS
  t0 = UL_ROWS < TH ? UL_ROWS : TH;
#endif
  const int rings[4][2] = {{2, 0}, {2, 1}, {1, 0}, {1, 1}};
  for (int t = t0; t >= 1; --t) {
    for (const auto& r : rings) {
      if (r[1] && !slots) continue;
      if (fill_layout(L, E, W, t, r[0], r[1], slots, s)) {
        s.n_ct = n_ct;
        s.n_rt = (TH + t - 1) / t;
        return true;
      }
    }
  }
  return false;
}

// What the kernel reads: tensor maps of x, mem, spk, out and slots_out,
// the rest plain, and the layout.
struct Params {
  CUtensorMap x, mem, spk, out, slots;
  const __nv_bfloat16* w;
  const float* p;
  int L, E, W, TH, store_slots;
  Layout s;
};

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int slot_of(int l) { return l == 1 ? 0 : (l == 2 ? 1 : 2); }

// A warp's `mine` fragments of a layer. The kernel of 2 fragments a warp:
// both in one straight-line pass, or one on two accumulator sets. The
// kernel of FPW = 4 (large cones only, 512 threads and so at most 128
// registers): a rolled loop over the taps, every fragment on its own set.
template <bool AUX, bool SEPARATE, int FPW>
__device__ __forceinline__ void warp_mma(int mine, float (&acc)[FPW][NF][4],
                                         const uint32_t (&abase)[FPW], uint32_t hsm,
                                         uint32_t asm_, uint32_t wbase, int hc) {
  if constexpr (FPW == 2) {
    if (mine == 1) {
      layer_mma<1, true, AUX, SEPARATE, WPITCH>(acc, abase, hsm, asm_, wbase, hc);
    } else {
      layer_mma<2, false, AUX, SEPARATE, WPITCH>(acc, abase, hsm, asm_, wbase, hc);
    }
  } else {
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const uint32_t toff = ((dy * hc + tap - 3 * dy) * SPITCH) * 2;
#pragma unroll
      for (int c16 = 0; c16 < 2; ++c16) {
        uint32_t av[FPW][4];
#pragma unroll
        for (int half = 0; half < (AUX ? 2 : 1); ++half) {  // h's weights, then aux's
          const uint32_t k0 = (half * 9 * C + tap * C + c16 * 16) * 2;
          uint32_t b[2][4];
          ldsm_x4(b[0], wbase + k0);
          ldsm_x4(b[1], wbase + 16 * WPITCH * 2 + k0);
#pragma unroll
          for (int f = 0; f < FPW; ++f) {
            if (f < mine) {
              if (half == 0 || SEPARATE) {
                ldsm_x4(av[f], (half == 0 ? hsm : asm_) + abase[f] + toff + c16 * 32);
              }
              mma_n32(acc[f], av[f], b);
            }
          }
        }
      }
    }
  }
}

template <bool LIF, bool DYN, bool SLOTS, int FPW>
__global__ void __launch_bounds__(FPW == 2 ? MIN_WARPS * 32 : MAX_WARPS * 32, 1)
    unit_loop_kernel(const __grid_constant__ Params a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout& s = a.s;
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem);  // x
  uint64_t* bar_a = bar_x + 1;  // per stage: the weights (and the slot)
  uint64_t* bar_b = bar_x + 3;  // per stage: the parameters and the membrane
  const uint32_t dummy = smem_u32(smem + 64);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + s.off_h);    // h, pixel-major
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(smem + s.off_aux);  // aux (K8j), else h
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // the last warp issues the copies and stores (its lanes a weight row each):
  // the fragments go to the first warps, so it rarely has mma work
  const bool producer = warp == nw - 1, issuer = producer && lane == 0;
  const int L = a.L, E = a.E, W = a.W;
  const int c0 = (blockIdx.x % s.n_ct) * TW;
  const int a0 = R0 + (blockIdx.x / s.n_ct) * s.t;  // owned rows a0 .. a1-1
  const int a1 = min(a0 + s.t, R0 + a.TH);
  const int rb = max(-1, a0 - L), cb = c0 - L;  // image row and column of buffer pixel 0
  const int xcol = c0 - ceil8(L);               // x's and the slots' box column
  const int last_slot2 = L >= 4 ? L - 1 : 0;    // the layer that writes slot 2 last

  auto stage = [&](int l) { return smem + s.off_ring + (l % s.stages) * s.stage; };
  auto has_slot = [&](int l) { return SLOTS && (l == 1 || l == 2); };
  auto mem_row = [&](int l) { return min(max(a0 - (L - 1 - l), 0), E - s.MR); };
  // the producer warp: arm layer l's weight barrier (and slot's) and copy
  // its weights, a row a lane, once every warp's mma has read the stage's
  auto arm_w = [&](int l) {
    const int k = l % s.stages;
    if (lane == 0) {
      const uint32_t slot = keeps(UL_CUT_SLOT_STAGE) && has_slot(l) ? s.xbytes : 0;
      mbar_expect_tx(&bar_a[k], (keeps(UL_CUT_RING) ? WBYTES : 0) + slot);
    }
    __syncwarp();
    if (keeps(UL_CUT_RING)) {
      bulk_copy(stage(l) + lane * WPITCH * 2, a.w + (static_cast<size_t>(l) * C + lane) * K,
                K * 2, &bar_a[k]);
    }
  };
  // the issuer: arm its parameter and membrane barrier and copy its
  // parameters, once every warp's epilogue has read the stage's
  auto arm_p = [&](int l) {
    const int k = l % s.stages;
    mbar_expect_tx(&bar_b[k], keeps(UL_CUT_RING) ? PBYTES + s.mbytes : 0);
    if (keeps(UL_CUT_RING)) bulk_copy(stage(l) + WREGION, a.p + l * C * 3, PBYTES, &bar_b[k]);
  };
  auto issue_slot = [&](int l) {
    if (keeps(UL_CUT_SLOT_STAGE) && has_slot(l)) {
      tensor_copy_4d(stage(l) + DATA_OFF + s.slot_off, &a.spk, xcol, rb, 0, slot_of(l),
                     &bar_a[l % s.stages]);
    }
  };
  auto issue_mem = [&](int l) {
    if (keeps(UL_CUT_RING)) {
      tensor_copy_4d(stage(l) + DATA_OFF, &a.mem, c0 - ceil8(L - 1 - l), mem_row(l), 0, l,
                     &bar_b[l % s.stages]);
    }
  };
  // the issuer: a stage's boxes, the membrane after the slot's transposition where they share
  auto issue_data = [&](int l) {
    issue_slot(l);
    if (!(s.alias && has_slot(l))) issue_mem(l);
  };

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar_x + i);
  }
  __syncthreads();
  if (producer) {
    if (issuer && keeps(UL_CUT_X_STAGE)) {
      mbar_expect_tx(bar_x, s.xbytes);
      tensor_copy_4d(stage(s.stages - 1) + DATA_OFF, &a.x, xcol, rb, 0, 0, bar_x);
    }
    for (int l = 0; l < s.stages && l < L; ++l) {
      arm_w(l);
      if (issuer) arm_p(l);
      if (issuer && l < s.stages - 1) issue_data(l);
    }
  }
  if (keeps(UL_CUT_X_STAGE)) {
    mbar_wait(bar_x, 0);
    to_pixel_major(reinterpret_cast<const __nv_bfloat16*>(stage(s.stages - 1) + DATA_OFF), hb,
                   dummy, s.HR, s.BX, s.HC, ceil8(L) - L);
  }
  fence_proxy_async();  // this thread's reads of x's box before the copies below
  __syncthreads();
  if (issuer && s.stages - 1 < L) issue_data(s.stages - 1);

  const uint32_t hsm = smem_u32(hb), asm_ = smem_u32(ab);
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    const int d = L - 1 - l, k = l % s.stages;
    const uint32_t parity = (l / s.stages) & 1;
    unsigned char* st = stage(l);
    mbar_wait(&bar_a[k], parity);
    if (has_slot(l)) {
      if (keeps(UL_CUT_SLOT_STAGE)) {
        to_pixel_major(reinterpret_cast<const __nv_bfloat16*>(st + DATA_OFF + s.slot_off), ab,
                       dummy, s.HR, s.BX, s.HC, ceil8(L) - L);
      }
      fence_proxy_async();
      __syncthreads();
      if (issuer && s.alias) issue_mem(l);
    }
    const bool aux = !SLOTS || has_slot(l);
    // the layer's cone: rows lr0..lr1-1, columns lc0..lc0+wl-1, its pixels
    // on nfr fragments, fpw a warp: the fewest that keep them within the
    // warps and, up to FPW, spread them over the SM's four sub-partitions
    const int lr0 = max(0, a0 - d), lr1 = min(E, a1 + d);
    const int lc0 = max(0, c0 - d), wl = min(W, c0 + TW + d) - lc0;
    const int npx = (lr1 - lr0) * wl;
    const int nfr = (npx + 15) >> 4;
    const int fpw = max((nfr + nw - 1) / nw, min(FPW, (nfr + SUBPARTS - 1) / SUBPARTS));
    const int f0 = warp * fpw, mine = min(fpw, max(0, nfr - f0));  // fragments f0 .. f0+mine-1
    const bool split = FPW == 2 && mine == 1;  // one fragment on two accumulator sets

    float acc[FPW][NF][4];
#pragma unroll
    for (int f = 0; f < FPW; ++f)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][nf][i] = 0.f;

    uint32_t abase[FPW];  // this lane's ldmatrix row: its pixel's tap (0, 0), its 8 channels
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int px = min((f0 + f) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, npx - 1);
      const int r = lr0 + px / wl, c = lc0 + px % wl;
      abase[f] = (((r - 1 - rb) * s.HC + (c - 1 - cb)) * SPITCH + (lane >> 4) * 8) * 2;
    }
    const uint32_t wbase =
        smem_u32(st) + (((lane & 7) + ((lane >> 4) << 3)) * WPITCH + ((lane >> 3) & 1) * 8) * 2;
    if (keeps(UL_CUT_MMA) && mine > 0) {
      if (!SLOTS) {
        warp_mma<true, false, FPW>(mine, acc, abase, hsm, asm_, wbase, s.HC);
      } else if (aux) {
        warp_mma<true, true, FPW>(mine, acc, abase, hsm, asm_, wbase, s.HC);
      } else {
        warp_mma<false, false, FPW>(mine, acc, abase, hsm, asm_, wbase, s.HC);
      }
    }
    if (split) {
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[0][nf][i] += acc[1][nf][i];
    }

    const bool stores = keeps(UL_CUT_STORES) && (DYN || l == L - 1);
    const bool slot_out = SLOTS && keeps(UL_CUT_STORES) && a.store_slots &&
                          (l == 1 || l == 2 || l == last_slot2);
    if (issuer) bulk_wait_read<1>();  // layer l-2's tiles are read: they may be written
    mbar_wait(&bar_b[k], parity);
    __syncthreads();  // every warp is done reading h, aux and the stage's weights
    if (producer && l + s.stages < L) arm_w(l + s.stages);

    // bias, beta, theta of the lane's channels nf*8 + 2q + j: registers in the
    // 2-fragment kernel, read where used in the other (its registers are the
    // accumulators')
    const float* pst = reinterpret_cast<const float*>(st + WREGION);
    float prm[3][NF][2];
    auto param = [&](int i, int nf, int j) {
      return keeps(UL_CUT_LOADS) ? pst[(nf * 8 + 2 * q + j) * 3 + i]
                                 : (i == 0 ? 0.f : (i == 1 ? 0.5f : 0.25f));
    };
    if (FPW == 2) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int j = 0; j < 2; ++j) prm[i][nf][j] = param(i, nf, j);
    }
    const __nv_bfloat16* mb = reinterpret_cast<const __nv_bfloat16*>(st + DATA_OFF);
    const int mr = mem_row(l), mc = c0 - ceil8(d);
    // the staged membrane; the 2-fragment kernel loads a pixel's all first
    auto mem_at = [&](int r, int c, int ch) {
      return keeps(UL_CUT_LOADS) ? bf2f(mb[(ch * s.MR + r - mr) * s.BM + c - mc]) : 0.f;
    };
    float* tile = reinterpret_cast<float*>(smem + s.off_out + (l & 1) * s.tile);
    __nv_bfloat16* stile = reinterpret_cast<__nv_bfloat16*>(smem + s.off_slt + (l & 1) * s.stile);
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      if (f >= mine) break;
      // the lane's two pixels (rows g, g+8 of the fragment)
      int r[2], c[2];
      bool valid[2];
      float m[2][NF][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = (f0 + f) * 16 + half * 8 + g;
        valid[half] = px < npx;
        const int pc = min(px, npx - 1);
        r[half] = lr0 + pc / wl;
        c[half] = lc0 + pc - (r[half] - lr0) * wl;
        if (FPW == 2) {
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              m[half][nf][j] = mem_at(r[half], c[half], nf * 8 + 2 * q + j);
            }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bool own = valid[half] && r[half] < a1 && r[half] >= a0 && c[half] >= c0 &&
                         c[half] < c0 + TW;
        const int o = (r[half] - a0) * TW + c[half] - c0;  // in the tiles, channel 0
        __nv_bfloat16* hp = hb + ((r[half] - rb) * s.HC + (c[half] - cb)) * SPITCH + 2 * q;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          float spk[2], mem2[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float bias = FPW == 2 ? prm[0][nf][j] : param(0, nf, j);
            const float beta = FPW == 2 ? prm[1][nf][j] : param(1, nf, j);
            const float theta = FPW == 2 ? prm[2][nf][j] : param(2, nf, j);
            const float ff = __fadd_rn(acc[f][nf][2 * half + j], bias);
            const float mv =
                FPW == 2 ? m[half][nf][j] : mem_at(r[half], c[half], nf * 8 + 2 * q + j);
            if (LIF) {
              const float u = mv > theta ? 0.f : __fadd_rn(__fmul_rn(beta, mv), ff);
              spk[j] = u > theta ? 1.f : 0.f;
              mem2[j] = u > theta ? 0.f : u;
            } else {
              spk[j] = ff;
              mem2[j] = __fadd_rn(ff, mv);
            }
          }
          const __nv_bfloat162 sp = __floats2bfloat162_rn(spk[0], spk[1]);
          if (valid[half]) *reinterpret_cast<__nv_bfloat162*>(hp + nf * 8) = sp;
          if (own && stores) {
            const float v0 = DYN ? bf2f(__float2bfloat16_rn(mem2[0])) : __low2float(sp);
            const float v1 = DYN ? bf2f(__float2bfloat16_rn(mem2[1])) : __high2float(sp);
            tile[(nf * 8 + 2 * q) * s.t * TW + o] = v0;
            tile[(nf * 8 + 2 * q + 1) * s.t * TW + o] = v1;
          }
          if (own && slot_out) {
            stile[(nf * 8 + 2 * q) * s.t * TW + o] = __low2bfloat16(sp);
            stile[(nf * 8 + 2 * q + 1) * s.t * TW + o] = __high2bfloat16(sp);
          }
        }
      }
    }
    fence_proxy_async();  // this thread's tile writes before the stores, stage reads before copies
    __syncthreads();
    if (producer) {
      if (issuer) {
        if (stores) {
          for (int ll = DYN ? l : 0; ll < (DYN ? l + 1 : L); ++ll) {
            tensor_store_4d(&a.out, c0, a0 - R0, 0, ll, tile);
          }
        }
        if (slot_out) tensor_store_4d(&a.slots, c0, a0 - R0, 0, slot_of(l), stile);
        bulk_commit();
      }
      if (issuer && l + s.stages < L) {
        arm_p(l + s.stages);
        issue_data(l + s.stages);
      }
    }
  }
  if (issuer) bulk_wait();
}

// --- host side ----------------------------------------------------------------

// The card's SM count, asked once a device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <bool LIF, bool DYN, bool SLOTS>
int launch(UnitLoopArgs& a, cudaStream_t stream) {
  Params prm;
  memset(&prm, 0, sizeof(prm));
  const int sms = sm_count();
  if (sms <= 0 || !make_layout(a.L, a.E, a.TH, a.W, sms, SLOTS, prm.s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout& s = prm.s;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const bool ok =
      encode(&prm.x, bf16, 2, a.x, {a.W, a.E, C, 1}, {s.BX, s.HR, C, 1}) &&
      encode(&prm.mem, bf16, 2, a.mem, {a.W, a.E, C, a.L}, {s.BM, s.MR, C, 1}) &&
      encode(&prm.out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.out, {a.W, a.TH, C, a.L},
             {TW, s.t, C, 1}) &&
      (!SLOTS || encode(&prm.spk, bf16, 2, a.spk, {a.W, a.E, C, 3}, {s.BX, s.HR, C, 1})) &&
      (a.slots_out == nullptr ||
       encode(&prm.slots, bf16, 2, a.slots_out, {a.W, a.TH, C, 3}, {TW, s.t, C, 1}));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  prm.w = a.w;
  prm.p = a.p;
  prm.L = a.L;
  prm.E = a.E;
  prm.W = a.W;
  prm.TH = a.TH;
  prm.store_slots = a.slots_out != nullptr;
  auto kernel = s.fpw == 2 ? unit_loop_kernel<LIF, DYN, SLOTS, 2>
                           : unit_loop_kernel<LIF, DYN, SLOTS, 4>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = s.n_ct * s.n_rt;
  kernel<<<grid, s.warps * 32, s.total, stream>>>(prm);
  a.grid = grid;
  a.threads = s.warps * 32;
  a.smem = s.total;
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
// output rows beyond E, a cone whose layout does not fit a CTA
// (probes/unit_loop.py::launch_layout).
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
