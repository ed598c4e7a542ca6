// The item body of K3, K4, K5 and K7, and its pieces, which K6 runs too:
// one (b, 16 x 16 tile) item of the whole FireNet step, every unit and the
// flow, in one CTA of 16 warps, for sm_90a.
//
// An item owns a 16 x 16 tile; unit l computes it grown by L-1-l pixels a
// side, so the last unit's extent is the owned tile. The design of each
// piece (the shrinking extent, m16 fragments over the warps, ldmatrix
// fragments, the epilogue's state loads issued together, the weight buffer
// refilled by TMA bulk copies, the pixel-a-lane staging, the shared-memory
// layout) and what it cost before, measured: fused_net_batch.cu. Each
// kernel keeps only what makes it the counterpart of its TPU kernel:
// fused_net_batch.cu (K7) runs items in persistent CTAs, fused_net_loop2.cu
// (K5), fused_net_loop.cu (K4) and fused_net.cu (K3) one item a CTA, K4
// and K3 with the unit loop unrolled at compile time (run_item's NL; K4
// also compiles which units are recurrent, REC). fused_net_lgrid.cu (K6)
// runs the pieces (staging, conv_lif_unit, flow_tile, the weight buffer)
// a unit at a time over 16 x 16 tiles with no halo, in CTAs of 8 warps.
#pragma once

#include "fused_net_common.cuh"
#include "tma.cuh"

namespace evflow {
namespace wholenet {

constexpr int ITEM_WARPS = 16;
constexpr int ITEM_THREADS = ITEM_WARPS * 32;
constexpr int ITEM_TH = 16, ITEM_TW = 16;  // the owned tile of an item
constexpr int ITEM_ROW = ITEM_TW + 2 * MAX_UNITS;  // the widest staged row: 30 pixels
static_assert(ITEM_ROW <= 32, "a staged row fits the lanes of a warp");

// Parts of the item body that probes/wholenet_slope.py --split takes out,
// one a variant build (-DITEM_CUT=ITEM_CUT_<part>) of a kernel's source, to
// time what each part costs; a variant computes wrong results. The default
// build takes out nothing. Each part is one item_keeps(ITEM_CUT_<part>) test
// in the code below, K6's own two in fused_net_lgrid.cu (the script refuses
// a part without one, and an unknown part fails the build).
enum ItemCut {
  ITEM_CUT_NONE,
  ITEM_CUT_STATE_LOADS,   // the epilogue's membrane loads read as zeros
  ITEM_CUT_STATE_STORES,  // no membrane or kept-spike store
  ITEM_CUT_EPILOGUE,      // no LIF update, state load or store; no spike to the next tile
  ITEM_CUT_SPIKE_STAGE,   // the recurrent units' previous spikes are not staged
  ITEM_CUT_WEIGHT_STAGE,  // no weight copy and no wait: the buffer is read as it lies
  ITEM_CUT_EVENT_STAGE,   // the event input is not staged
  ITEM_CUT_MMA,           // no fragment load and no mma: the k loop is empty
  ITEM_CUT_FLOW,          // the pred head is not run
  ITEM_CUT_SECOND_ROUND,  // at most one fragment a warp and unit
  ITEM_CUT_INPUT_STAGE,   // K6: unit l's input (unit l-1's spikes) is not staged
  ITEM_CUT_GRID_BARRIER,  // K6: no grid barrier between units
};
#ifndef ITEM_CUT
#define ITEM_CUT ITEM_CUT_NONE
#endif
__host__ __device__ constexpr bool item_keeps(ItemCut part) { return ITEM_CUT != part; }

// Output extent of unit l of L: the owned tile grown by L-1-l pixels a side.
__host__ __device__ inline int extent_h(int l, int L) { return ITEM_TH + 2 * (L - 1 - l); }
__host__ __device__ inline int extent_w(int l, int L) { return ITEM_TW + 2 * (L - 1 - l); }

// (b, tile) items of a launch: B x ceil(H/16) x ceil(W/16).
__host__ __device__ inline int item_count(const WholeNetArgs& a) {
  return a.B * ((a.H + ITEM_TH - 1) / ITEM_TH) * ((a.W + ITEM_TW - 1) / ITEM_TW);
}

// Where a CTA's shared memory lies, in bytes from the dynamic base: tiles
// A, B and P at 0, `tile` and `spk`, then the weight buffer of the widest
// unit, the units' [L, 3, C] parameters, pred_w [C, 2] and pred_b [2], the
// weights' mbarrier and the count of warps done reading them.
struct ItemLayout {
  int tile, spk, wbuf, prm, bars, total;
};

__host__ __device__ inline bool any_recurrent(const WholeNetArgs& a) {
  bool any = false;
  for (int l = 0; l < a.L; ++l) any = any || recurrent(a, l);
  return any;
}

// The layout's weight buffer, parameters and barriers after `tiles` bytes.
__host__ __device__ inline void place_after_tiles(const WholeNetArgs& a, int tiles,
                                                  ItemLayout& s) {
  int ck_max = 0;
  for (int l = 0; l < a.L; ++l) ck_max = a.ck[l] > ck_max ? a.ck[l] : ck_max;
  s.wbuf = tiles;
  s.prm = s.wbuf + C * (9 * ck_max + PAD) * 2;
  s.bars = s.prm + (a.L * 3 * C + 2 * C + 2) * 4;
  s.total = s.bars + 16;
}

// An item CTA's layout (mirrored by ops/fused_net_item.py::item_smem):
// spike tiles A and B of unit 0's output extent at SPITCH, the previous
// spikes P (recurrent nets only). B first holds the event input, unit 0's
// extent grown by a pixel a side at the head's width + PAD; a 32-channel
// head's runs past B into P, which the first recurrent unit stages only
// after unit 0 is done with it.
__host__ __device__ inline ItemLayout item_layout(const WholeNetArgs& a) {
  ItemLayout s;
  s.tile = extent_h(0, a.L) * extent_w(0, a.L) * SPITCH * 2;
  s.spk = 2 * s.tile;
  const int events = (extent_h(0, a.L) + 2) * (extent_w(0, a.L) + 2) * (a.ck[0] + PAD) * 2;
  const int tiles = s.spk + (any_recurrent(a) ? s.tile : 0);
  place_after_tiles(a, tiles > s.tile + events ? tiles : s.tile + events, s);
  return s;
}

// The pieces of an ItemLayout as pointers.
struct ItemSmem {
  __nv_bfloat16 *tile_a, *tile_b, *tile_p, *wsm;
  float* prm;       // [L, 3, C], then pred_w [C][2] and pred_b [2]
  uint64_t* wbar;   // the weight buffer's mbarrier
  unsigned* reads;  // warps done reading the weights, over the CTA's units
};

template <class S>
__device__ __forceinline__ float ld_nc(const S* p);
template <>
__device__ __forceinline__ float ld_nc<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float ld_nc<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
// Loads through L2 only (ld.global.cg): K6 reads spikes that other CTAs
// wrote earlier in the same launch, which the non-coherent path can miss.
template <class S>
__device__ __forceinline__ float ld_cg(const S* p);
template <>
__device__ __forceinline__ float ld_cg<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ float ld_cg<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void st_state(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_state(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Event input, image rows [oh, oh+eh) x cols [ow, ow+ew) (eh <= MAX_ROWS)
// -> [eh*ew][cw + PAD] bf16, cw = 16 or 32 channels, channels Cin..cw-1 and
// pixels outside the image zero: a row a warp of NWARPS, a pixel a lane,
// 16 channels at a time, every load of a lane before its stores.
template <int NWARPS = ITEM_WARPS, int MAX_ROWS = ITEM_ROW>
__device__ void stage_events(const WholeNetArgs& a, int b, int oh, int ow, int eh, int ew, int cw,
                             __nv_bfloat16* buf) {
  constexpr int ROWS = (MAX_ROWS + NWARPS - 1) / NWARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* __restrict__ x = a.x;
  for (int c0 = 0; c0 < cw; c0 += 16) {
    float v[ROWS][16];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = warp + k * NWARPS, h = oh + r, w = ow + lane;
      const bool in = r < eh && lane < ew && inside(a, h, w);
      const float* src =
          x + ((static_cast<size_t>(b) * a.H + (in ? h : 0)) * a.W + (in ? w : 0)) * a.Cin + c0;
#pragma unroll
      for (int c = 0; c < 16; ++c) v[k][c] = in && c0 + c < a.Cin ? __ldg(src + c) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = warp + k * NWARPS;
      if (r < eh && lane < ew) {
        uint4 u[2];
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(u);
#pragma unroll
        for (int c = 0; c < 8; ++c) h2[c] = __floats2bfloat162_rn(v[k][2 * c], v[k][2 * c + 1]);
        uint4* d = reinterpret_cast<uint4*>(buf + (r * ew + lane) * (cw + PAD) + c0);
        d[0] = u[0];
        d[1] = u[1];
      }
    }
  }
}

// Spikes [B,C,H,W] (state dtype: a recurrent unit's previous spikes, or
// in K6 the unit before's, COHERENT: read by ld_cg) over image rows [oh,
// oh+eh) x cols [ow, ow+ew) -> [eh*ew][SPITCH] bf16, zero outside the
// image: a row of pixels a warp of NWARPS, a pixel a lane (reads along W),
// the lane's 32 channel loads issued together, then its pixel's 64 bytes
// written as four 16-byte stores.
template <class S, int NWARPS = ITEM_WARPS, bool COHERENT = false>
__device__ void stage_prev_spikes(const WholeNetArgs& a, const S* __restrict__ src, int b,
                                  int oh, int ow, int eh, int ew, __nv_bfloat16* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HW = a.H * a.W;
  src += static_cast<size_t>(b) * C * HW;
  for (int r = warp; r < eh; r += NWARPS) {
    const int h = oh + r, w = ow + lane;
    if (lane >= ew) continue;
    const bool in = inside(a, h, w);
    const S* p = src + (in ? h * a.W + w : 0);
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = in ? (COHERENT ? ld_cg<S>(p + c * HW) : ld_nc<S>(p + c * HW)) : 0.f;
    }
    uint4 u[4];
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(u);
#pragma unroll
    for (int c = 0; c < C / 2; ++c) h2[c] = __floats2bfloat162_rn(v[2 * c], v[2 * c + 1]);
    uint4* d = reinterpret_cast<uint4*>(buf + (r * ew + lane) * SPITCH);
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = u[k];
  }
}

// Warp 0: unit l's packed weights [C, 9 ck] into `wsm` ([C][9 ck + PAD]),
// one TMA bulk copy a row (a lane), completing on `bar`.
__device__ __forceinline__ void issue_unit_weights(const WholeNetArgs& a, int l,
                                                   __nv_bfloat16* wsm, uint64_t* bar) {
  const int lane = threadIdx.x & 31, k = 9 * a.ck[l];
  if (lane == 0) mbar_expect_tx(bar, C * k * 2);
  __syncwarp();
  bulk_copy(wsm + lane * (k + PAD), a.wk[l] + lane * k, k * 2, bar);
}

// One unit over its output extent (wo pixels wide, n_out pixels in all,
// row-major, image position of pixel 0 (oh0, ow0)): the conv of the staged
// input tile `hbuf` (ck_h channels at pitch hpitch, wo + 2 wide) and, for a
// recurrent unit, of its previous spikes `pbuf`, by m16 fragments (16
// pixels x the 32 output channels) over the NWARPS warps, then the LIF
// update; mem' and the kept spikes go to device memory for the owned
// pixels [th0, th0+ITEM_TH) x [tw0, tw0+ITEM_TW), the spikes (0 outside
// the image) to `out`, the next unit's input tile (the same extent), where
// there is one.
template <class S, int NWARPS = ITEM_WARPS, class Ready, class Done>
__device__ __forceinline__ void conv_lif_unit(
    const __nv_bfloat16* hbuf, int hpitch, int ck_h, const __nv_bfloat16* pbuf,
    const __nv_bfloat16* wsm, int ck, int wo, int n_out, const S* __restrict__ mem_in,
    S* __restrict__ mem_out, S* __restrict__ spk_out, const float* prm, int H, int W, int b,
    bool hard, int oh0, int ow0, int th0, int tw0, __nv_bfloat16* out, const Ready& weights_ready,
    const Done& weights_read) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wi = wo + 2;
  const int wpitch = 9 * ck + PAD;
  const int HW = H * W;  // the launch refuses C H W >= 2^31: 32-bit offsets in an image
  const size_t base = static_cast<size_t>(b) * C * HW;
  mem_in += base;
  mem_out += base;
  if (spk_out != nullptr) spk_out += base;
  // ldmatrix lanes: B rows (output channel (lane & 7) + 8 (lane >> 4), k
  // half (lane >> 3) & 1) for n8 fragments 0, 1 (+16 channels: 2, 3); A rows
  // (pixel lane & 15 of the fragment, k half lane >> 4)
  const uint32_t b_addr =
      smem_u32(wsm + ((lane & 7) + 8 * (lane >> 4)) * wpitch + 8 * ((lane >> 3) & 1));
  const uint32_t b_step = 16 * wpitch * 2;
  const int n_work = item_keeps(ITEM_CUT_SECOND_ROUND) ? (n_out + 15) >> 4
                                                       : min((n_out + 15) >> 4, NWARPS);
  if (warp >= n_work) weights_read();  // a warp without a fragment reads no weight
  for (int frag = warp; frag < n_work; frag += NWARPS) {
    if (frag == warp) weights_ready();  // before the warp's first k loop of the unit
    const int pa = min(frag * 16 + (lane & 15), n_out - 1);  // ragged: a valid pixel
    const int pin = (pa / wo) * wi + pa % wo;
    const uint32_t a_h = smem_u32(hbuf + pin * hpitch + 8 * (lane >> 4));
    const uint32_t a_p = pbuf != nullptr ? smem_u32(pbuf + pin * SPITCH + 8 * (lane >> 4)) : 0u;
    float acc[NF][4];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nf][i] = 0.f;

    uint32_t bk = b_addr;  // k0 = 0
    for (int tap = 0; tap < (item_keeps(ITEM_CUT_MMA) ? 9 : 0); ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const int toff = dy * wi + dx;
      for (int c0 = 0; c0 < ck_h; c0 += 16, bk += 32) {
        uint32_t af[4], bf[2][4];
        ldsm_x4(af, a_h + (toff * hpitch + c0) * 2);
        ldsm_x4(bf[0], bk);
        ldsm_x4(bf[1], bk + b_step);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          mma_bf16_16816(acc[nf], af, bf[nf >> 1][2 * (nf & 1)], bf[nf >> 1][2 * (nf & 1) + 1]);
        }
      }
      if (pbuf != nullptr) {
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += 16, bk += 32) {
          uint32_t af[4], bf[2][4];
          ldsm_x4(af, a_p + (toff * SPITCH + c0) * 2);
          ldsm_x4(bf[0], bk);
          ldsm_x4(bf[1], bk + b_step);
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            mma_bf16_16816(acc[nf], af, bf[nf >> 1][2 * (nf & 1)],
                           bf[nf >> 1][2 * (nf & 1) + 1]);
          }
        }
      }
    }

    if (frag + NWARPS >= n_work) weights_read();  // the warp's last k loop of the unit

    // the state loads of this lane's 2 pixels x 8 channels, all issued
    // before the first LIF update: one round trip a fragment (issued before
    // the k loop instead, they cost registers the k loop needs, and time)
    int off[2];
    bool in[2], owned[2];
    float m[2][NF][2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = frag * 16 + half * 8 + g;
      const int r = p / wo, col = p - r * wo;
      const int h = oh0 + r, w = ow0 + col;
      in[half] = p < n_out && h >= 0 && h < H && w >= 0 && w < W;
      off[half] = in[half] ? h * W + w : 0;
      owned[half] = in[half] && h >= th0 && h < th0 + ITEM_TH && w >= tw0 && w < tw0 + ITEM_TW;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = off[half] + (nf * 8 + 2 * q + j) * HW;
          m[half][nf][j] = 0.f;
          if (item_keeps(ITEM_CUT_STATE_LOADS) && in[half]) m[half][nf][j] = ld_nc<S>(mem_in + o);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = frag * 16 + half * 8 + g;
      if (p >= n_out) continue;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        float s2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = nf * 8 + 2 * q + j;
          float s = 0.f, m2;
          if (item_keeps(ITEM_CUT_EPILOGUE) && in[half]) {
            lif_update(acc[nf][2 * half + j] + prm[c], m[half][nf][j], prm[C + c],
                       prm[2 * C + c], hard, s, m2);
            if (item_keeps(ITEM_CUT_STATE_STORES) && owned[half]) {
              const int o = off[half] + c * HW;
              st_state(mem_out + o, m2);
              if (spk_out != nullptr) st_state(spk_out + o, s);
            }
          }
          s2[j] = s;
        }
        if (out != nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(out + p * SPITCH + nf * 8 + 2 * q) =
              __floats2bfloat162_rn(s2[0], s2[1]);
        }
      }
    }
  }
}

// flow = tanh(spikes . pred_w + pred_b) over the owned tile from the last
// unit's spike tile (the owned tile, ITEM_TW wide), the channels summed in
// order (every schedule's flow is this one), with pred_w and pred_b (`pw`)
// in shared memory.
__device__ void flow_tile(const WholeNetArgs& a, const __nv_bfloat16* buf, const float* pw, int b,
                          int th0, int tw0) {
  for (int i = threadIdx.x; i < ITEM_TH * ITEM_TW * 2; i += blockDim.x) {
    const int o = i & 1, p = i >> 1;
    const int r = p / ITEM_TW, col = p - r * ITEM_TW;
    const int h = th0 + r, w = tw0 + col;
    if (h >= a.H || w >= a.W) continue;
    const __nv_bfloat16* s = buf + p * SPITCH;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) acc = __fmaf_rn(__bfloat162float(s[c]), pw[c * 2 + o], acc);
    a.flow[((static_cast<size_t>(b) * a.H + h) * a.W + w) * 2 + o] = tanhf(acc + pw[2 * C + o]);
  }
}

// A CTA's start: its shared memory laid out (`lay`), the parameters and
// pred head copied in, the weights' mbarrier set up and unit 0's weights
// issued, so that they land while the first item stages its events.
__device__ __forceinline__ ItemSmem item_start(const WholeNetArgs& a, unsigned char* smem_raw,
                                               const ItemLayout& lay) {
  ItemSmem s;
  s.tile_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  s.tile_b = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.tile);
  s.tile_p = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.spk);
  s.wsm = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.wbuf);
  s.prm = reinterpret_cast<float*>(smem_raw + lay.prm);
  s.wbar = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  s.reads = reinterpret_cast<unsigned*>(smem_raw + lay.bars + 8);
  float* pw = s.prm + a.L * 3 * C;
  for (int i = threadIdx.x; i < a.L * 3 * C; i += blockDim.x) s.prm[i] = a.params[i];
  for (int i = threadIdx.x; i < 2 * C + 2; i += blockDim.x) {
    pw[i] = i < 2 * C ? a.pred_w[i] : a.pred_b[i - 2 * C];
  }
  if (threadIdx.x == 0) {
    mbar_init(s.wbar);
    *s.reads = 0;
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  if (item_keeps(ITEM_CUT_WEIGHT_STAGE) && threadIdx.x < 32) {
    issue_unit_weights(a, 0, s.wsm, s.wbar);
  }
  return s;
}

// run_item's REC when the recurrent units and the head's width are read
// from the arguments (K3).
constexpr unsigned REC_ARGS = ~0u;

// One item (b, 16 x 16 tile) through every unit and the flow. `u` counts
// the units the CTA has run (the weights' phase is u & 1). The warp that is
// the last to finish reading a unit's weights issues the next unit's; after
// the item's last unit, unit 0's for the CTA's next item when `next_item`,
// else nothing. With NL = 0 the unit count, which units are recurrent and
// the head's width (16 or 32 channels) are read from the arguments and the
// unit loop stays rolled (K5, K7). With NL > 0 the unit count is NL: the
// loop unrolls, and each unit's extent and work count are constants; K4
// passes which units are recurrent as the bit mask REC (each unit's input
// channels and weight pitch constants too, a 16-channel head), K3 passes
// REC_ARGS and reads them, and the head's width, from the arguments.
template <class S, int NL = 0, unsigned REC = 0u>
__device__ __forceinline__ void run_item(const WholeNetArgs& a, const ItemSmem& sm, int item,
                                         int& u, bool next_item) {
  constexpr bool fixed = NL > 0 && REC != REC_ARGS;  // K4: recurrence compiled in
  const int L = NL > 0 ? NL : a.L;
  const int head = fixed ? 16 : a.ck[0];
  const int ntw = (a.W + ITEM_TW - 1) / ITEM_TW, nth = (a.H + ITEM_TH - 1) / ITEM_TH;
  const int b = item / (nth * ntw), t = item - b * nth * ntw;
  const int th0 = (t / ntw) * ITEM_TH, tw0 = (t - (t / ntw) * ntw) * ITEM_TW;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the last item's units and flow are done with the tiles
  if (item_keeps(ITEM_CUT_EVENT_STAGE)) {
    stage_events(a, b, th0 - L, tw0 - L, ITEM_TH + 2 * L, ITEM_TW + 2 * L, head, sm.tile_b);
  }
#pragma unroll (NL > 0 ? NL : 1)
  for (int l = 0; l < L; ++l, ++u) {
    const int grow = L - 1 - l;  // the output extent: the owned tile grown by `grow`
    const int eh = ITEM_TH + 2 * grow, ew = ITEM_TW + 2 * grow;
    const int oh0 = th0 - grow, ow0 = tw0 - grow;
    const bool rec = fixed ? ((REC >> l) & 1u) != 0u : recurrent(a, l);
    // with NL > 0 a constant for every unit after the head but the recurrent
    // part (args_valid holds a.ck to this)
    const int ck = NL > 0 ? (l == 0 ? head : (rec ? 2 * C : C)) : a.ck[l];
    if (rec) {
      if (l > 0 && ((fixed ? ((REC >> (l - 1)) & 1u) != 0u : recurrent(a, l - 1)) ||
                    (l == 1 && head > 16))) {
        __syncthreads();  // the unit before reads tile P (unit 0: the event tile runs into it)
      }
      if (item_keeps(ITEM_CUT_SPIKE_STAGE)) {
        stage_prev_spikes<S>(a, static_cast<const S*>(a.spk_in[l]), b, oh0 - 1, ow0 - 1, eh + 2,
                             ew + 2, sm.tile_p);
      }
    }
    __syncthreads();  // the input tiles are complete
    const int next_l = l + 1 < L ? l + 1 : (next_item ? 0 : -1);
    auto weights_read = [&]() {
      unsigned last = 0;
      if (lane == 0) last = atomicAdd(sm.reads, 1u) == (u + 1) * ITEM_WARPS - 1;
      last = __shfl_sync(0xffffffffu, last, 0);
      if (item_keeps(ITEM_CUT_WEIGHT_STAGE) && last && next_l >= 0) {
        fence_proxy_async();
        issue_unit_weights(a, next_l, sm.wsm, sm.wbar);
      }
    };
    auto weights_ready = [&]() {
      if (item_keeps(ITEM_CUT_WEIGHT_STAGE)) mbar_wait(sm.wbar, u & 1);
    };
    conv_lif_unit<S>(l == 0 ? sm.tile_b : ((l & 1) ? sm.tile_a : sm.tile_b),
                     l == 0 ? head + PAD : SPITCH, ck - (rec ? C : 0), rec ? sm.tile_p : nullptr,
                     sm.wsm, ck, ew, eh * ew, static_cast<const S*>(a.mem_in[l]),
                     static_cast<S*>(a.mem_out[l]), static_cast<S*>(a.spk_out[l]),
                     sm.prm + l * 3 * C, a.H, a.W, b, a.hard_reset != 0, oh0, ow0, th0, tw0,
                     (l & 1) ? sm.tile_b : sm.tile_a, weights_ready, weights_read);
  }
  __syncthreads();  // the last unit's spike tile is complete
  if (item_keeps(ITEM_CUT_FLOW)) {
    flow_tile(a, ((L - 1) & 1) ? sm.tile_b : sm.tile_a, sm.prm + L * 3 * C, b, th0, tw0);
  }
}

// Launches `kernel` (blocks of ITEM_THREADS, item_layout's shared memory)
// over the items of `a`: a CTA an item, or with `persistent` at most as
// many CTAs as the card holds at once, each walking items in a stride of
// the grid (K7). Sets a.grid to the CTAs launched.
template <class Kernel>
int launch_items(Kernel kernel, WholeNetArgs& a, cudaStream_t stream, bool persistent) {
  const int smem = item_layout(a).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(C) * a.H * a.W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);  // an image's offsets are 32-bit
  }
  int grid = item_count(a);
  if (persistent) {
    int per_sm = 0, device = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ITEM_THREADS,
                                                             smem)) != cudaSuccess ||
        (err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess) {
      return static_cast<int>(err);
    }
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (grid > per_sm * sms) grid = per_sm * sms;
  }
  kernel<<<grid, ITEM_THREADS, smem, stream>>>(a);
  a.grid = grid;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wholenet
}  // namespace evflow
