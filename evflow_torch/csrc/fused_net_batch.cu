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
#include "fused_net_common.cuh"
#include "tma.cuh"

namespace evflow {
namespace wholenet {

constexpr int K7_WARPS = 16;
constexpr int K7_THREADS = K7_WARPS * 32;
constexpr int K7_TH = 16, K7_TW = 16;  // the owned tile of an item
constexpr int K7_ROW = K7_TW + 2 * MAX_UNITS;  // the widest staged row: 30 pixels
static_assert(K7_ROW <= 32, "a staged row fits the lanes of a warp");

// Parts of the kernel that probes/wholenet_slope.py --split takes out, one a
// variant build (-DK7_CUT=K7_CUT_<part>), to time what each part costs; a
// variant computes wrong results. The default build takes out nothing. Each
// part is one k7_keeps(K7_CUT_<part>) test in the code below (the script
// refuses a part without one, and an unknown part fails the build).
enum K7Cut {
  K7_CUT_NONE,
  K7_CUT_STATE_LOADS,   // the epilogue's membrane loads read as zeros
  K7_CUT_STATE_STORES,  // no membrane or kept-spike store
  K7_CUT_EPILOGUE,      // no LIF update, state load or store; no spike to the next tile
  K7_CUT_SPIKE_STAGE,   // the recurrent units' previous spikes are not staged
  K7_CUT_WEIGHT_STAGE,  // no weight copy and no wait: the buffer is read as it lies
  K7_CUT_EVENT_STAGE,   // the event input is not staged
  K7_CUT_MMA,           // no fragment load and no mma: the k loop is empty
  K7_CUT_FLOW,          // the pred head is not run
  K7_CUT_SECOND_ROUND,  // at most one fragment a warp and unit
};
#ifndef K7_CUT
#define K7_CUT K7_CUT_NONE
#endif
__host__ __device__ constexpr bool k7_keeps(K7Cut part) { return K7_CUT != part; }

// Output extent of unit l of L: the owned tile grown by L-1-l pixels a side.
__host__ __device__ inline int extent_h(int l, int L) { return K7_TH + 2 * (L - 1 - l); }
__host__ __device__ inline int extent_w(int l, int L) { return K7_TW + 2 * (L - 1 - l); }

// Where K7's shared memory lies, in bytes from the dynamic base (mirrored by
// ops/fused_net_batch.py::batch_smem): spike tiles A and B (unit 0's output
// extent at SPITCH; B first holds the event input at XPITCH), the previous
// spikes P (recurrent nets only), the weight buffer of the widest unit, the
// units' [L, 3, C] parameters, pred_w [C, 2] and pred_b [2], the weights'
// mbarrier and the count of warps done reading them.
struct K7Layout {
  int tile, spk, wbuf, prm, bars, total;
};

__host__ __device__ inline K7Layout k7_layout(const WholeNetArgs& a) {
  int ck_max = 0;
  bool any_rec = false;
  for (int l = 0; l < a.L; ++l) {
    ck_max = a.ck[l] > ck_max ? a.ck[l] : ck_max;
    any_rec = any_rec || recurrent(a, l);
  }
  K7Layout s;
  s.tile = extent_h(0, a.L) * extent_w(0, a.L) * SPITCH * 2;
  s.spk = 2 * s.tile;
  s.wbuf = s.spk + (any_rec ? s.tile : 0);
  s.prm = s.wbuf + C * (9 * ck_max + PAD) * 2;
  s.bars = s.prm + (a.L * 3 * C + 2 * C + 2) * 4;
  s.total = s.bars + 16;
  return s;
}

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
__device__ __forceinline__ void st_state(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_state(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Event input, image rows [oh, oh+eh) x cols [ow, ow+ew) -> [eh*ew][XPITCH]
// bf16, channels Cin..15 and pixels outside the image zero: a row a warp,
// a pixel a lane, every load of a lane before its stores.
__device__ void stage_events(const WholeNetArgs& a, int b, int oh, int ow, int eh, int ew,
                             __nv_bfloat16* buf) {
  constexpr int ROWS = (K7_TH + 2 * MAX_UNITS + K7_WARPS - 1) / K7_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* __restrict__ x = a.x;
  float v[ROWS][16];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = warp + k * K7_WARPS, h = oh + r, w = ow + lane;
    const bool in = r < eh && lane < ew && inside(a, h, w);
    const float* src = x + ((static_cast<size_t>(b) * a.H + (in ? h : 0)) * a.W + (in ? w : 0)) *
                               a.Cin;
#pragma unroll
    for (int c = 0; c < 16; ++c) v[k][c] = in && c < a.Cin ? __ldg(src + c) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = warp + k * K7_WARPS;
    if (r < eh && lane < ew) {
      uint4 u[2];
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(u);
#pragma unroll
      for (int c = 0; c < 8; ++c) h2[c] = __floats2bfloat162_rn(v[k][2 * c], v[k][2 * c + 1]);
      uint4* d = reinterpret_cast<uint4*>(buf + (r * ew + lane) * XPITCH);
      d[0] = u[0];
      d[1] = u[1];
    }
  }
}

// A recurrent unit's previous spikes [B,C,H,W] (state dtype) over image
// rows [oh, oh+eh) x cols [ow, ow+ew) -> [eh*ew][SPITCH] bf16, zero outside
// the image: a row of pixels a warp, a pixel a lane (reads along W), the
// lane's 32 channel loads issued together, then its pixel's 64 bytes
// written as four 16-byte stores.
template <class S>
__device__ void stage_prev_spikes(const WholeNetArgs& a, const S* __restrict__ src, int b,
                                  int oh, int ow, int eh, int ew, __nv_bfloat16* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HW = a.H * a.W;
  src += static_cast<size_t>(b) * C * HW;
  for (int r = warp; r < eh; r += K7_WARPS) {
    const int h = oh + r, w = ow + lane;
    if (lane >= ew) continue;
    const bool in = inside(a, h, w);
    const S* p = src + (in ? h * a.W + w : 0);
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = in ? ld_nc<S>(p + c * HW) : 0.f;
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
// pixels x the 32 output channels) over the warps, then the LIF update;
// mem' and the kept spikes go to device memory for the owned pixels [th0,
// th0+K7_TH) x [tw0, tw0+K7_TW), the spikes (0 outside the image) to `out`,
// the next unit's input tile (the same extent).
template <class S, class Ready, class Done>
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
  const int n_work = k7_keeps(K7_CUT_SECOND_ROUND) ? (n_out + 15) >> 4
                                                   : min((n_out + 15) >> 4, K7_WARPS);
  if (warp >= n_work) weights_read();  // a warp without a fragment reads no weight
  for (int frag = warp; frag < n_work; frag += K7_WARPS) {
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
    for (int tap = 0; tap < (k7_keeps(K7_CUT_MMA) ? 9 : 0); ++tap) {
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

    if (frag + K7_WARPS >= n_work) weights_read();  // the warp's last k loop of the unit

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
      owned[half] = in[half] && h >= th0 && h < th0 + K7_TH && w >= tw0 && w < tw0 + K7_TW;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = off[half] + (nf * 8 + 2 * q + j) * HW;
          m[half][nf][j] = 0.f;
          if (k7_keeps(K7_CUT_STATE_LOADS) && in[half]) m[half][nf][j] = ld_nc<S>(mem_in + o);
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
          if (k7_keeps(K7_CUT_EPILOGUE) && in[half]) {
            lif_update(acc[nf][2 * half + j] + prm[c], m[half][nf][j], prm[C + c],
                       prm[2 * C + c], hard, s, m2);
            if (k7_keeps(K7_CUT_STATE_STORES) && owned[half]) {
              const int o = off[half] + c * HW;
              st_state(mem_out + o, m2);
              if (spk_out != nullptr) st_state(spk_out + o, s);
            }
          }
          s2[j] = s;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + p * SPITCH + nf * 8 + 2 * q) =
            __floats2bfloat162_rn(s2[0], s2[1]);
      }
    }
  }
}

// flow = tanh(spikes . pred_w + pred_b) over the owned tile from the last
// unit's spike tile (the owned tile, K7_TW wide), as pred_tile computes it
// (the same order of sums, so the flows are the other schedules'), with
// pred_w and pred_b (`pw`) in shared memory.
__device__ void flow_tile(const WholeNetArgs& a, const __nv_bfloat16* buf, const float* pw, int b,
                          int th0, int tw0) {
  for (int i = threadIdx.x; i < K7_TH * K7_TW * 2; i += blockDim.x) {
    const int o = i & 1, p = i >> 1;
    const int r = p / K7_TW, col = p - r * K7_TW;
    const int h = th0 + r, w = tw0 + col;
    if (h >= a.H || w >= a.W) continue;
    const __nv_bfloat16* s = buf + p * SPITCH;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) acc = __fmaf_rn(__bfloat162float(s[c]), pw[c * 2 + o], acc);
    a.flow[((static_cast<size_t>(b) * a.H + h) * a.W + w) * 2 + o] = tanhf(acc + pw[2 * C + o]);
  }
}

template <class S>
__global__ void __launch_bounds__(K7_THREADS, 1) fused_net_batch_kernel(WholeNetArgs args) {
  __shared__ WholeNetArgs a;
  copy_args(args, a);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const K7Layout lay = k7_layout(a);
  __nv_bfloat16* tile_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* tile_b = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.tile);
  __nv_bfloat16* tile_p = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.spk);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.wbuf);
  float* prm = reinterpret_cast<float*>(smem_raw + lay.prm);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  unsigned* reads = reinterpret_cast<unsigned*>(smem_raw + lay.bars + 8);
  const int L = a.L;
  const int ntw = (a.W + K7_TW - 1) / K7_TW, nth = (a.H + K7_TH - 1) / K7_TH;
  const int items = a.B * nth * ntw;
  const int lane = threadIdx.x & 31;
  float* pw = prm + L * 3 * C;  // pred_w [C][2], then pred_b [2]
  for (int i = threadIdx.x; i < L * 3 * C; i += blockDim.x) prm[i] = a.params[i];
  for (int i = threadIdx.x; i < 2 * C + 2; i += blockDim.x) {
    pw[i] = i < 2 * C ? a.pred_w[i] : a.pred_b[i - 2 * C];
  }
  if (threadIdx.x == 0) {
    mbar_init(wbar);
    *reads = 0;
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  if (k7_keeps(K7_CUT_WEIGHT_STAGE) && threadIdx.x < 32) issue_unit_weights(a, 0, wsm, wbar);
  int u = 0;  // units this CTA has run: the weights' phase u & 1
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / (nth * ntw), t = item - b * nth * ntw;
    const int th0 = (t / ntw) * K7_TH, tw0 = (t - (t / ntw) * ntw) * K7_TW;
    __syncthreads();  // the last item's units and flow are done with the tiles
    if (k7_keeps(K7_CUT_EVENT_STAGE)) {
      stage_events(a, b, th0 - L, tw0 - L, K7_TH + 2 * L, K7_TW + 2 * L, tile_b);
    }
    for (int l = 0; l < L; ++l, ++u) {
      const int grow = L - 1 - l;  // the output extent: the owned tile grown by `grow`
      const int eh = K7_TH + 2 * grow, ew = K7_TW + 2 * grow;
      const int oh0 = th0 - grow, ow0 = tw0 - grow;
      const bool rec = recurrent(a, l);
      if (rec) {
        if (l > 0 && recurrent(a, l - 1)) __syncthreads();  // the unit before reads tile P
        if (k7_keeps(K7_CUT_SPIKE_STAGE)) {
          stage_prev_spikes<S>(a, static_cast<const S*>(a.spk_in[l]), b, oh0 - 1, ow0 - 1,
                               eh + 2, ew + 2, tile_p);
        }
      }
      __syncthreads();  // the input tiles are complete
      // the next unit's weights (the next item's first after the last),
      // issued by the warp that is the last to finish reading this unit's
      const int next_l = l + 1 < L ? l + 1 : (item + static_cast<int>(gridDim.x) < items ? 0 : -1);
      auto weights_read = [&]() {
        unsigned last = 0;
        if (lane == 0) last = atomicAdd(reads, 1u) == (u + 1) * K7_WARPS - 1;
        last = __shfl_sync(0xffffffffu, last, 0);
        if (k7_keeps(K7_CUT_WEIGHT_STAGE) && last && next_l >= 0) {
          fence_proxy_async();
          issue_unit_weights(a, next_l, wsm, wbar);
        }
      };
      auto weights_ready = [&]() {
        if (k7_keeps(K7_CUT_WEIGHT_STAGE)) mbar_wait(wbar, u & 1);
      };
      const int ck = a.ck[l];
      conv_lif_unit<S>(l == 0 ? tile_b : ((l & 1) ? tile_a : tile_b), l == 0 ? XPITCH : SPITCH,
                       ck - (rec ? C : 0), rec ? tile_p : nullptr, wsm, ck, ew, eh * ew,
                       static_cast<const S*>(a.mem_in[l]), static_cast<S*>(a.mem_out[l]),
                       static_cast<S*>(a.spk_out[l]), prm + l * 3 * C, a.H, a.W, b,
                       a.hard_reset != 0, oh0, ow0, th0, tw0, (l & 1) ? tile_b : tile_a,
                       weights_ready, weights_read);
    }
    __syncthreads();  // the last unit's spike tile is complete
    if (k7_keeps(K7_CUT_FLOW)) flow_tile(a, ((L - 1) & 1) ? tile_b : tile_a, pw, b, th0, tw0);
  }
}

template <class S>
int launch(WholeNetArgs& a, cudaStream_t stream) {
  auto kernel = fused_net_batch_kernel<S>;
  const int smem = k7_layout(a).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K7_THREADS,
                                                           smem)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (static_cast<long long>(C) * a.H * a.W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);  // an image's offsets are 32-bit
  }
  const int items = a.B * ((a.H + K7_TH - 1) / K7_TH) * ((a.W + K7_TW - 1) / K7_TW);
  int grid = per_sm * sms;
  if (grid > items) grid = items;
  kernel<<<grid, K7_THREADS, smem, stream>>>(a);
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
