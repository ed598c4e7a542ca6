// The whole LIFFireNet inference step in one launch: shared pieces of the
// five schedules (fused_net.cu, fused_net_loop.cu, fused_net_loop2.cu,
// fused_net_lgrid.cu, fused_net_batch.cu).
//
// What one launch computes, for a window x [B,H,W,Cin] (f32, NHWC) and L
// units (C = 32 channels each, state [B,C,H,W] in f32 or bf16):
//   h_0 = x
//   for each unit l:
//     ff    = conv3x3_SAME(bf16 [h_l | prev_spk_l]) . W_l  (f32 sums) + bias_l
//     spk, mem' = snn.Leaky update of (ff, mem_l)        (conv_lif_common.cuh)
//     h_{l+1} = spk
//   flow = tanh(h_L . pred_w + pred_b)                     [B,H,W,2] f32
// where prev_spk_l is the unit's spikes of the previous window (recurrent
// units only) and every unit's input is ZERO outside the image, as in
// FireNet's SAME padding. (The TPU kernels these replace recompute halo rows
// but never zero the rows outside the image, so their border rows drift from
// FireNet's function; see ROADMAP.md section 3.)
//
// Every schedule stages its inputs as bf16 pixel-major tiles in shared
// memory ([pixel][channel], rows padded by 8 bf16 so fragment loads are free
// of bank conflicts) and runs the conv as an implicit GEMM with mma.sync
// m16n8k16 bf16 -> f32, in the k order of pack_weights (tap-major, then
// [h | prev] channels), the same order as conv_lif_common.cuh. Membranes
// are read and written straight from the accumulator fragments; spikes for
// the next unit go to shared memory (K3, K4, K5, K7) or to device memory (K6).
// K3 and K6 stage with the pieces below (stage_x, stage_spikes,
// stage_unit_weights: a thread an element) and run conv_region's 32-pixel
// pairs; K4, K5 and K7 run fused_net_item.cuh's item body, which stages a
// pixel a lane, refills one weight buffer by TMA bulk copies and takes m16
// fragments.
#pragma once

#include "conv_lif_common.cuh"

namespace evflow {
namespace wholenet {

constexpr int MAX_UNITS = 7;
constexpr int C = 32;                   // channels of every unit
constexpr int NF = C / 8;               // n8 fragments of the output channels
constexpr int XPITCH = 16 + PAD;        // bf16 per pixel of a staged event tile
constexpr int SPITCH = C + PAD;         // bf16 per pixel of a staged spike tile
constexpr int WPITCH_MAX = 9 * 2 * C + PAD;  // bf16 per row of a recurrent unit's weights

// Operands of one launch, filled by evflow_torch/ops/fused_net.py (ctypes
// mirror WholeNetArgs there). Per-unit pointers make the schedules
// independent of how the caller stacks its states.
struct WholeNetArgs {
  const float* x;                       // [B, H, W, Cin] f32
  const void* mem_in[MAX_UNITS];        // [B, C, H, W] state dtype
  void* mem_out[MAX_UNITS];             // [B, C, H, W] state dtype
  const void* spk_in[MAX_UNITS];        // previous spikes of a recurrent unit, else null
  void* spk_out[MAX_UNITS];             // this window's spikes if kept, else null
  const __nv_bfloat16* wk[MAX_UNITS];   // packed [C, 9 * ck[l]] (pack_weights)
  const float* params;                  // [L, 3, C]: bias, beta, theta
  const float* pred_w;                  // [C, 2]
  const float* pred_b;                  // [2]
  float* flow;                          // [B, H, W, 2]
  int ck[MAX_UNITS];                    // packed input channels: 16 (head), 32, 64 (recurrent)
  int B, H, W, Cin, L, hard_reset, state_bf16;
  int grid;  // set by the launch: the CTAs it started
};

__host__ __device__ inline bool recurrent(const WholeNetArgs& a, int l) {
  return a.spk_in[l] != nullptr;
}

// What the kernels take; anything else is refused before launch.
inline bool args_valid(const WholeNetArgs& a) {
  if (a.L < 1 || a.L > MAX_UNITS || a.Cin < 1 || a.Cin > 16 || a.B < 1 || a.H < 1 ||
      a.W < 1 || a.x == nullptr || a.flow == nullptr || a.params == nullptr ||
      a.pred_w == nullptr || a.pred_b == nullptr || recurrent(a, 0)) {
    return false;
  }
  for (int l = 0; l < a.L; ++l) {
    const int expect = l == 0 ? 16 : (recurrent(a, l) ? 2 * C : C);
    if (a.ck[l] != expect || a.wk[l] == nullptr || a.mem_in[l] == nullptr ||
        a.mem_out[l] == nullptr) {
      return false;
    }
  }
  return true;
}

__device__ __forceinline__ size_t cm(int b, int c, int h, int w, int H, int W) {
  return ((static_cast<size_t>(b) * C + c) * H + h) * W + w;
}

// State loads bypass L1 (ld.global.cg): K6 reads spikes that other CTAs
// wrote earlier in the same launch.
template <class S>
__device__ __forceinline__ float ld_state(const void* p, size_t i);
template <>
__device__ __forceinline__ float ld_state<float>(const void* p, size_t i) {
  return __ldcg(static_cast<const float*>(p) + i);
}
template <>
__device__ __forceinline__ float ld_state<__nv_bfloat16>(const void* p, size_t i) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(static_cast<const unsigned short*>(p) + i)));
}
__device__ __forceinline__ void st_state(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st_state(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool inside(const WholeNetArgs& a, int h, int w) {
  return h >= 0 && h < a.H && w >= 0 && w < a.W;
}

// Event input, image rows [oh, oh+eh) x cols [ow, ow+ew), -> [eh*ew][XPITCH]
// bf16, channels Cin..15 and pixels outside the image zero.
__device__ void stage_x(const WholeNetArgs& a, int b, int oh, int ow, int eh, int ew,
                        __nv_bfloat16* buf) {
  for (int p = threadIdx.x; p < eh * ew; p += blockDim.x) {
    const int r = p / ew, col = p - r * ew;
    const int h = oh + r, w = ow + col;
    const bool in = inside(a, h, w);
    const float* src = in ? a.x + ((static_cast<size_t>(b) * a.H + h) * a.W + w) * a.Cin : a.x;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      buf[p * XPITCH + c] = __float2bfloat16_rn(in && c < a.Cin ? src[c] : 0.f);
    }
  }
}

// Spikes [B,C,H,W] (state dtype) over the same kind of window ->
// [eh*ew][SPITCH] bf16, zero outside the image. Reads run along W.
template <class S>
__device__ void stage_spikes(const WholeNetArgs& a, const void* src, int b, int oh, int ow,
                             int eh, int ew, __nv_bfloat16* buf) {
  const int px = eh * ew;
  for (int e = threadIdx.x; e < C * px; e += blockDim.x) {
    const int c = e / px, p = e - c * px;
    const int r = p / ew, col = p - r * ew;
    const int h = oh + r, w = ow + col;
    const float v = inside(a, h, w) ? ld_state<S>(src, cm(b, c, h, w, a.H, a.W)) : 0.f;
    buf[p * SPITCH + c] = __float2bfloat16_rn(v);
  }
}

// Packed weights [C, 9*ck] -> shared memory [C][9*ck + PAD], 16 bytes at a time.
__device__ void stage_unit_weights(const __nv_bfloat16* wk, int ck, __nv_bfloat16* wsm) {
  const int vec_per_row = 9 * ck / 8;
  const uint4* src = reinterpret_cast<const uint4*>(wk);
  for (int i = threadIdx.x; i < C * vec_per_row; i += blockDim.x) {
    const int n = i / vec_per_row, v = i - n * vec_per_row;
    *reinterpret_cast<uint4*>(wsm + n * (9 * ck + PAD) + v * 8) = src[i];
  }
}

// One k16 step of two m16 fragments x NF n8 fragments.
__device__ __forceinline__ void mma_k16(const __nv_bfloat16* buf, int pitch,
                                        const int (&pix)[2][2], int toff, int c0,
                                        const __nv_bfloat16* wsm, int wpitch, int k0, int g,
                                        int q, float (&acc)[2][NF][4]) {
  uint32_t af[2][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const __nv_bfloat16* p0 = buf + (pix[mf][0] + toff) * pitch + c0 + 2 * q;
    const __nv_bfloat16* p1 = buf + (pix[mf][1] + toff) * pitch + c0 + 2 * q;
    af[mf][0] = lds32(p0);      // pixel g,   k 2q..2q+1
    af[mf][1] = lds32(p1);      // pixel g+8, k 2q..2q+1
    af[mf][2] = lds32(p0 + 8);  // pixel g,   k 2q+8..2q+9
    af[mf][3] = lds32(p1 + 8);  // pixel g+8, k 2q+8..2q+9
  }
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    const __nv_bfloat16* pb = wsm + (nf * 8 + g) * wpitch + k0 + 2 * q;
    const uint32_t b0 = lds32(pb), b1 = lds32(pb + 8);
    mma_bf16_16816(acc[0][nf], af[0], b0, b1);
    mma_bf16_16816(acc[1][nf], af[1], b0, b1);
  }
}

// One unit's conv over an output region wo pixels wide and n_out pixels in
// all (row-major). Output pixel (r, c) reads input pixels (r+dy, c+dx) of
// the staged tiles, which are wo + 2 pixels wide: hbuf holds the unit's
// input (ck_h channels, pitch hpitch), pbuf its previous spikes (recurrent
// units; null otherwise). Warps take 32-pixel pairs of m16 fragments in
// turn; epi(r, c, channel, acc) receives every output once.
template <int NWARPS, class Epi>
__device__ __forceinline__ void conv_region(const __nv_bfloat16* hbuf, int hpitch, int ck_h,
                                            const __nv_bfloat16* pbuf, const __nv_bfloat16* wsm,
                                            int ck, int wo, int n_out, const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wi = wo + 2;
  const int wpitch = 9 * ck + PAD;
  const int n_pairs = (n_out + 31) >> 5;
  for (int pair = warp; pair < n_pairs; pair += NWARPS) {
    int rr[2][2], cc[2][2], pix[2][2];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = pair * 32 + mf * 16 + half * 8 + g;
        const int pc = p < n_out ? p : n_out - 1;  // ragged fragment: load a valid pixel
        const int r = pc / wo, c = pc - r * wo;
        rr[mf][half] = p < n_out ? r : -1;
        cc[mf][half] = c;
        pix[mf][half] = r * wi + c;
      }
    }
    float acc[2][NF][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;

    int k0 = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const int toff = dy * wi + dx;
      for (int c0 = 0; c0 < ck_h; c0 += 16, k0 += 16) {
        mma_k16(hbuf, hpitch, pix, toff, c0, wsm, wpitch, k0, g, q, acc);
      }
      if (pbuf != nullptr) {
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += 16, k0 += 16) {
          mma_k16(pbuf, SPITCH, pix, toff, c0, wsm, wpitch, k0, g, q, acc);
        }
      }
    }

#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            if (rr[mf][half] >= 0) {
              epi(rr[mf][half], cc[mf][half], nf * 8 + 2 * q + j, acc[mf][nf][2 * half + j]);
            }
  }
}

// The LIF update of one unit's output: reads mem for every output pixel in
// the image (halo pixels too), writes mem' and the kept spikes only for the
// pixels the CTA owns, and puts the spike (0 outside the image) into the
// next unit's input tile when there is one.
template <class S>
struct UnitEpilogue {
  const void* mem_in;
  S* mem_out;
  S* spk_out;
  const float* prm;  // this unit's [3, C]
  int H, W, b, hard;
  int oh0, ow0;                // image position of output pixel (0, 0)
  int th0, tw0, th1, tw1;      // owned pixels [th0, th1) x [tw0, tw1)
  __nv_bfloat16* out;          // next unit's input tile or null
  int obw, ooff;               // its width and the offset of output (0, 0) in it

  __device__ __forceinline__ void operator()(int r, int col, int c, float acc) const {
    const int h = oh0 + r, w = ow0 + col;
    float s = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const size_t i = cm(b, c, h, w, H, W);
      float m2;
      lif_update(acc + prm[c], ld_state<S>(mem_in, i), prm[C + c], prm[2 * C + c], hard != 0,
                 s, m2);
      if (h >= th0 && h < th1 && w >= tw0 && w < tw1) {
        st_state(mem_out, i, m2);
        if (spk_out != nullptr) st_state(spk_out, i, s);
      }
    }
    if (out != nullptr) out[((r + ooff) * obw + col + ooff) * SPITCH + c] = __float2bfloat16_rn(s);
  }
};

template <class S>
__device__ __forceinline__ UnitEpilogue<S> unit_epilogue(const WholeNetArgs& a, int l, int b,
                                                         int oh0, int ow0, int th0, int tw0,
                                                         int th1, int tw1, __nv_bfloat16* out,
                                                         int obw, int ooff) {
  UnitEpilogue<S> e;
  e.mem_in = a.mem_in[l];
  e.mem_out = static_cast<S*>(a.mem_out[l]);
  e.spk_out = static_cast<S*>(a.spk_out[l]);
  e.prm = a.params + l * 3 * C;
  e.H = a.H;
  e.W = a.W;
  e.b = b;
  e.hard = a.hard_reset;
  e.oh0 = oh0;
  e.ow0 = ow0;
  e.th0 = th0;
  e.tw0 = tw0;
  e.th1 = th1;
  e.tw1 = tw1;
  e.out = out;
  e.obw = obw;
  e.ooff = ooff;
  return e;
}

// flow = tanh(spikes . pred_w + pred_b) over the owned th x tw tile, from
// the last unit's spike tile (width bw; owned pixel (0, 0) at (off, off)).
__device__ void pred_tile(const WholeNetArgs& a, const __nv_bfloat16* buf, int bw, int off,
                          int b, int th0, int tw0, int th, int tw) {
  for (int i = threadIdx.x; i < th * tw * 2; i += blockDim.x) {
    const int o = i & 1, p = i >> 1;
    const int r = p / tw, col = p - r * tw;
    const int h = th0 + r, w = tw0 + col;
    if (h >= a.H || w >= a.W) continue;
    const __nv_bfloat16* s = buf + ((r + off) * bw + col + off) * SPITCH;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc = __fmaf_rn(__bfloat162float(s[c]), a.pred_w[c * 2 + o], acc);
    a.flow[((static_cast<size_t>(b) * a.H + h) * a.W + w) * 2 + o] = tanhf(acc + a.pred_b[o]);
  }
}

// Kernel arguments -> shared memory, so that per-unit pointers indexed by a
// runtime unit number need no local-memory copy of the struct.
__device__ __forceinline__ void copy_args(const WholeNetArgs& src, WholeNetArgs& dst) {
  if (threadIdx.x == 0) dst = src;
  __syncthreads();
}

}  // namespace wholenet
}  // namespace evflow
