// One FireNet unit a launch, the kernel of conv_lif.cu (K1, NHWC) and
// conv_lif_cmajor.cu (K2): one unit of K6 (fused_net_lgrid.cu) on the item
// body's pieces. A CTA of 8 warps owns a 16 x 16 tile (8 x 16 where 16 x 16
// would leave SMs idle). Warp 0 issues the packed weights [C, 9 Ck] by TMA
// bulk copies while [x | prev_spk] stages over the halo into ONE pixel-major
// bf16 tile at the packed channel order (Ck = Cin (+ C) rounded up to 16), so
// the k loop reads the weights as packed, whatever Cin is; then layer_unit,
// conv_lif_unit's k loop and epilogue over C rounded up to 16 channels (rows
// c >= C zero). It is K1's and K2's own: conv_lif_unit templated on the width
// and layout moved K3-K7's ptxas registers (K6 126 -> 114) and ran K1 and K2
// slower. Units over a CTA's 232,448 bytes (recurrent, C > 56 at Cin = C) are
// refused before launch (ops/conv_lif.py::layer_smem).
#pragma once

#include <atomic>

#include "fused_net_item.cuh"

namespace evflow {
namespace layer {

using namespace wholenet;  // item_keeps and the ItemCut parts

constexpr int LAYER_WARPS = 8, LAYER_THREADS = LAYER_WARPS * 32;
// the tile's width (its height is 16 or 8), the channels the fragments take,
// the dynamic shared memory of a CTA on an H100
constexpr int LT = 16, MAX_CH = 64, SMEM_MAX = 232448;

struct ConvLIFArgs {
  const float* __restrict__ x;     // [B, H, W, Cin] or [B, Cin, H, W]
  const float* __restrict__ prev;  // previous spikes, like mem; null if feedforward
  const float* __restrict__ mem;   // [B, H, W, C] or [B, C, H, W]
  const __nv_bfloat16* __restrict__ wk;  // [C, 9 * Ck]
  const float *__restrict__ bias, *__restrict__ beta, *__restrict__ theta;
  float *__restrict__ spk, *__restrict__ mem_out;
  int B, H, W, Cin, C, Ck, hard_reset;
  int tile_h, vec4, pairs;  // set by the launch
};

// A CTA's shared memory, bytes from the dynamic base: the input tile
// [(th + 2) 18][ck + PAD] bf16 at 0, the weights [ch][9 ck + PAD] bf16, the
// parameters [3][ch] f32, the weights' mbarrier.
struct LayerLayout {
  int wbuf, prm, bar, total;
};
__host__ __device__ inline LayerLayout layer_layout(int ck, int ch, int th) {
  LayerLayout s;
  s.wbuf = (th + 2) * (LT + 2) * (ck + PAD) * 2;
  s.prm = s.wbuf + ch * (9 * ck + PAD) * 2;
  s.bar = s.prm + 3 * ch * 4;
  s.total = s.bar + 16;
  return s;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// [x | prev_spk] over image rows [oh, oh + rows) x cols [ow, ow + 18) ->
// [rows 18][Ck + PAD] bf16, zero past Cin + C and outside the image: a pixel a
// thread (two of them), RC channels a round, a round's loads before its stores.
template <bool PIXEL>
__device__ void stage_input(const ConvLIFArgs& a, int b, int oh, int ow, int rows,
                            __nv_bfloat16* tile) {
  constexpr int RC = PIXEL ? 16 : 32;  // NHWC's 16-byte loads need fewer registers
  const int HW = a.H * a.W, cp = a.prev != nullptr ? a.C : 0, n = rows * (LT + 2);
  const float* x = a.x + static_cast<size_t>(b) * a.Cin * HW;
  const float* prev = a.prev + static_cast<size_t>(b) * cp * HW;
  const bool keep_x = item_keeps(ITEM_CUT_EVENT_STAGE), keep_p = item_keeps(ITEM_CUT_SPIKE_STAGE);
  int pix[2];
  bool in[2];
  for (int k = 0; k < 2; ++k) {
    const int p = threadIdx.x + k * LAYER_THREADS, h = oh + p / (LT + 2), w = ow + p % (LT + 2);
    in[k] = p < n && h >= 0 && h < a.H && w >= 0 && w < a.W;
    pix[k] = in[k] ? h * a.W + w : 0;
  }
  for (int c0 = 0; c0 < a.Ck; c0 += RC) {
    if (!(keep_x && c0 < a.Cin) && !(keep_p && c0 + RC > a.Cin && c0 < a.Cin + cp)) continue;
    float4 v[2][RC / 4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < RC; i += 4) {  // with vec4, a group of 4 lies in x or in prev_spk
        float4& f = v[k][i / 4];
        f = make_float4(0.f, 0.f, 0.f, 0.f);
        auto load = [&](const float* src, int e) {
          if (PIXEL && a.vec4) {
            f = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            reinterpret_cast<float*>(&f)[e] = __ldg(src);
          }
        };
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + i + e, cc = c - a.Cin;
          if (!in[k] || (PIXEL && a.vec4 && e > 0)) continue;
          if (c < a.Cin) {
            if (keep_x) load(PIXEL ? x + pix[k] * a.Cin + c : x + c * HW + pix[k], e);
          } else if (cc < cp) {
            if (keep_p) load(PIXEL ? prev + pix[k] * a.C + cc : prev + cc * HW + pix[k], e);
          }
        }
      }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = threadIdx.x + k * LAYER_THREADS;
#pragma unroll
      for (int i = 0; i < RC / 4; i += 2) {  // 8 channels: one 16-byte store
        if (p >= n || c0 + 4 * i >= a.Ck) continue;
        const float4 lo = v[k][i], hi = v[k][i + 1];
        *reinterpret_cast<uint4*>(tile + p * (a.Ck + PAD) + c0 + 4 * i) = make_uint4(
            bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w), bf16x2(hi.x, hi.y), bf16x2(hi.z, hi.w));
      }
    }
  }
}

// The unit over the CTA's tile (tile_h x LT pixels at (th0, tw0)): FR tile rows
// a warp through one k loop (B fragments loaded once for them), their state
// loads issued together, spk and mem' stored for c < C (pixel-major: a lane's
// two channels as one 8-byte access).
template <int CH, int FR, bool PIXEL>
__device__ __forceinline__ void layer_unit(const ConvLIFArgs& a, const __nv_bfloat16* tile,
                                           const __nv_bfloat16* wsm, const float* prm, int b,
                                           int th0, int tw0) {
  constexpr int NF = CH / 8;  // n8 fragments
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int hpitch = a.Ck + PAD, wpitch = 9 * a.Ck + PAD, HW = a.H * a.W, cs = a.C;
  const int step = PIXEL ? 1 : HW;  // from a channel to the next
  const size_t base = static_cast<size_t>(b) * cs * HW;
  const float* mem_in = a.mem + base;
  float *mem_out = a.mem_out + base, *spk_out = a.spk + base;
  const bool pairs = PIXEL && a.pairs != 0, hard = a.hard_reset != 0;
  // ldmatrix lanes (conv_lif_unit's): B rows for n8 fragments 2j, 2j + 1, A rows for pixel lane & 15
  const uint32_t b_addr =
      smem_u32(wsm + ((lane & 7) + 8 * (lane >> 4)) * wpitch + 8 * ((lane >> 3) & 1));
  for (int r0 = warp; r0 < a.tile_h; r0 += LAYER_WARPS * FR) {
    uint32_t a_h[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      a_h[f] = smem_u32(tile + ((r0 + f * LAYER_WARPS) * (LT + 2) + (lane & 15)) * hpitch +
                        8 * (lane >> 4));
    }
    float acc[FR][NF][4] = {};
    uint32_t bk = b_addr;  // k0 = 0
    for (int tap = 0; tap < (item_keeps(ITEM_CUT_MMA) ? 9 : 0); ++tap) {
      const int toff = (tap / 3 * (LT + 2) + tap % 3) * hpitch;
      for (int c0 = 0; c0 < a.Ck; c0 += 16, bk += 32) {
        uint32_t af[FR][4], bf[NF / 2][4];
#pragma unroll
        for (int f = 0; f < FR; ++f) ldsm_x4(af[f], a_h[f] + (toff + c0) * 2);
#pragma unroll
        for (int j = 0; j < NF / 2; ++j) ldsm_x4(bf[j], bk + j * 32 * wpitch);
#pragma unroll
        for (int f = 0; f < FR; ++f)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            mma_bf16_16816(acc[f][nf], af[f], bf[nf >> 1][2 * (nf & 1)],
                           bf[nf >> 1][2 * (nf & 1) + 1]);
          }
      }
    }
    int off[FR][2];  // the lane's pixels g and g + 8 of each row, their state loads
    bool in[FR][2];
    float m[FR][2][NF][2];
#pragma unroll
    for (int f = 0; f < FR; ++f)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = th0 + r0 + f * LAYER_WARPS, w = tw0 + g + 8 * half;
        in[f][half] = h < a.H && w < a.W;
        off[f][half] = in[f][half] ? (PIXEL ? (h * a.W + w) * cs : h * a.W + w) : 0;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int c = nf * 8 + 2 * q;
          const float* p = mem_in + off[f][half] + c * step;
          float2 v = make_float2(0.f, 0.f);
          if (item_keeps(ITEM_CUT_STATE_LOADS) && in[f][half]) {
            if (pairs && c + 1 < cs) {
              v = __ldg(reinterpret_cast<const float2*>(p));
            } else {
              if (c < cs) v.x = __ldg(p);
              if (c + 1 < cs) v.y = __ldg(p + step);
            }
          }
          m[f][half][nf][0] = v.x;
          m[f][half][nf][1] = v.y;
        }
      }
#pragma unroll
    for (int f = 0; f < FR; ++f)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const int c = nf * 8 + 2 * q;
          float s[2], u[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            lif_update(acc[f][nf][2 * half + j] + prm[c + j], m[f][half][nf][j], prm[CH + c + j],
                       prm[2 * CH + c + j], hard, s[j], u[j]);
          }
          // (the variant without stores keeps the update: it stores where mem' is -1e30)
          if (!in[f][half] || (!item_keeps(ITEM_CUT_STATE_STORES) && u[0] != -1e30f)) continue;
          const int o = off[f][half] + c * step;
          if (pairs && c + 1 < cs) {
            *reinterpret_cast<float2*>(mem_out + o) = make_float2(u[0], u[1]);
            *reinterpret_cast<float2*>(spk_out + o) = make_float2(s[0], s[1]);
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (c + j < cs) mem_out[o + j * step] = u[j], spk_out[o + j * step] = s[j];
            }
          }
        }
  }
}

template <int CH, bool PIXEL>
__global__ void __launch_bounds__(LAYER_THREADS, 2)
    conv_lif_kernel(const __grid_constant__ ConvLIFArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const LayerLayout lay = layer_layout(a.Ck, CH, a.tile_h);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.wbuf);
  float* prm = reinterpret_cast<float*>(smem_raw + lay.prm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + lay.bar);
  const int K = 9 * a.Ck, ntw = (a.W + LT - 1) / LT, nth = (a.H + a.tile_h - 1) / a.tile_h;
  const int b = blockIdx.x / (nth * ntw), t = blockIdx.x % (nth * ntw);
  const int th0 = t / ntw * a.tile_h, tw0 = t % ntw * LT;
  if (item_keeps(ITEM_CUT_WEIGHT_STAGE) && threadIdx.x < 32) {  // warp 0: a bulk copy a row
    if (threadIdx.x == 0) {
      mbar_init(bar);
      mbar_expect_tx(bar, a.C * K * 2);
    }
    __syncwarp();
    for (int n = threadIdx.x; n < a.C; n += 32) {
      bulk_copy(wsm + n * (K + PAD), a.wk + static_cast<size_t>(n) * K, K * 2, bar);
    }
  }
  for (int i = threadIdx.x; i < (CH - a.C) * (K + PAD); i += LAYER_THREADS) {
    wsm[a.C * (K + PAD) + i] = __ushort_as_bfloat16(0);
  }
  for (int i = threadIdx.x; i < 3 * CH; i += LAYER_THREADS) {  // bias, beta, theta [3][CH]
    prm[i] = i % CH < a.C ? (i < CH ? a.bias : i < 2 * CH ? a.beta : a.theta)[i % CH] : 0.f;
  }
  stage_input<PIXEL>(a, b, th0 - 1, tw0 - 1, a.tile_h + 2, tile);
  __syncthreads();  // the input tile and the parameters are complete
  if (item_keeps(ITEM_CUT_WEIGHT_STAGE)) mbar_wait(bar, 0);
  CH <= 32 && a.tile_h == LT ? layer_unit<CH, 2, PIXEL>(a, tile, wsm, prm, b, th0, tw0)
                             : layer_unit<CH, 1, PIXEL>(a, tile, wsm, prm, b, th0, tw0);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// What a launch asks of the runtime, asked once a device (a small unit's
// launch is mostly host time): its SM count, and the shared memory that an
// instantiation may take there. 0: not asked yet.
constexpr int MAX_DEVICES = 64;
inline int sm_count(int device) {
  static std::atomic<int> sms[MAX_DEVICES];
  int n = device < MAX_DEVICES ? sms[device].load(std::memory_order_relaxed) : 0;
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess &&
      device < MAX_DEVICES) {
    sms[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <int CH, bool PIXEL>
int launch_ch(const ConvLIFArgs& a, int device, unsigned grid, int smem, cudaStream_t stream) {
  static std::atomic<int> granted[MAX_DEVICES];
  const auto kernel = conv_lif_kernel<CH, PIXEL>;
  if (device >= MAX_DEVICES || granted[device].load(std::memory_order_relaxed) < smem) {
    cudaError_t r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r == cudaSuccess) {  // two CTAs an SM: the whole carveout as shared memory
      r = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (r != cudaSuccess) return static_cast<int>(r);
    if (device < MAX_DEVICES) granted[device].store(smem, std::memory_order_relaxed);
  }
  kernel<<<grid, LAYER_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Refuses what the kernel does not take (the wrapper raises first, naming the
// reason), picks the tile height and the vector accesses, and launches.
template <bool PIXEL>
int launch(ConvLIFArgs a, cudaStream_t stream) {
  const bool rec = a.prev != nullptr;
  const int ch = (a.C + 15) / 16 * 16;
  if (a.B < 1 || a.H < 1 || a.W < 1 || a.Cin < 1 || a.C < 1 || a.C > MAX_CH ||
      a.Ck != (a.Cin + (rec ? a.C : 0) + 15) / 16 * 16 || !aligned(a.wk, 16) ||
      static_cast<long long>(a.Cin > a.C ? a.Cin : a.C) * a.H * a.W >= (1LL << 31) ||
      layer_layout(a.Ck, ch, LT).total > SMEM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sm_count(device);
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long cols = static_cast<long long>(a.B) * ((a.W + LT - 1) / LT);
  a.tile_h = cols * ((a.H + LT - 1) / LT) < sms ? LT / 2 : LT;  // 8 x 16 where SMs would idle
  const long long grid = cols * ((a.H + a.tile_h - 1) / a.tile_h);
  if (grid >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  a.vec4 = PIXEL && a.Cin % 4 == 0 && (!rec || a.C % 4 == 0) && aligned(a.x, 16) &&
           (!rec || aligned(a.prev, 16));
  a.pairs = a.C % 2 == 0 && aligned(a.mem, 8) && aligned(a.spk, 8) && aligned(a.mem_out, 8);
  const int smem = layer_layout(a.Ck, ch, a.tile_h).total;
  const unsigned g = static_cast<unsigned>(grid);
  switch (ch) {
    case 16: return launch_ch<16, PIXEL>(a, device, g, smem, stream);
    case 32: return launch_ch<32, PIXEL>(a, device, g, smem, stream);
    case 48: return launch_ch<48, PIXEL>(a, device, g, smem, stream);
    default: return launch_ch<64, PIXEL>(a, device, g, smem, stream);
  }
}

}  // namespace layer
}  // namespace evflow

// The C entry point of each layout's library: every pointer and the stream
// as void*, returns the cudaError_t of the launch (0 on success).
#define EVFLOW_CONV_LIF_ENTRY(NAME, PIXEL)                                                    \
  extern "C" int NAME(const void* x, const void* prev, const void* mem, const void* wk,       \
                      const void* bias, const void* beta, const void* theta, void* spk,         \
                      void* mem_out, int B, int H, int W, int Cin, int C, int Ck,               \
                      int hard_reset, void* stream) {                                          \
    using F = const float*;                                                                    \
    evflow::layer::ConvLIFArgs a{F(x), F(prev), F(mem), static_cast<const __nv_bfloat16*>(wk), \
        F(bias), F(beta), F(theta), static_cast<float*>(spk), static_cast<float*>(mem_out),    \
        B, H, W, Cin, C, Ck, hard_reset, 0, 0, 0};                                             \
    return evflow::layer::launch<PIXEL>(a, static_cast<cudaStream_t>(stream));                \
  }
