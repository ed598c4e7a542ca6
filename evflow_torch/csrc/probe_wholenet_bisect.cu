// The whole-net bisection probes: chained 3x3 conv layers over a row
// window, with a step, a scale or a LIF after each, for sm_90a.
//
// Replaces the TPU kernels of
//   benchmarks/probe_wholenet_bisect.py (K8k), over x [B, C, rows, W] bf16
//   and w [C, 9C] bf16, every conv a 3x3 conv whose rows are the window's
//   own (no row padding) and whose columns are zero-padded, K index
//   dy 3C + dx C + c, bf16 products summed in f32:
//     `kA` (`runA`): out[b, :, r] = conv(x)[b, :, r + TH] * p[:, 0]   (x has H + 2TH rows)
//     `kB` (`runB`): for each block i of E = TH + 16 rows of x, 7 layers
//       v = f32(conv(bf16(v)) > 0), all with w, each two rows shorter;
//       out rows i TH .. i TH + TH = the first TH of the 18 rows left;
//   probe_wholenet_bisect3.py (K8l), bisect5.py (K8m), bisect6.py (K8n):
//     two conv+LIF units over the padded arrays x, m0, m1 [B, C, H + 2TH, W]
//     (rows outside the image read as they are, not zeroed):
//       ff1 = conv(x, w0) (+ bias0), (spk1, mem1') = lif(ff1, m0)
//       ff2 = conv(bf16(spk1), w1) (+ bias1), or conv(x, w1) (K8l
//             `from_scratch`); (spk2, mem2') = lif(ff2, m1)
//       o0, o1 = bf16(spk or mem') on padded rows [TH, TH + H), zero on the
//             rows the TPU kernel leaves unwritten
//       flow = spk2 (all C channels, K8l), spk2[:2], or
//             tanh(pw . bf16(spk2) + pb) (K8m `use_pred`)
//     with the LIFs (bias, beta, theta from p, or all 0.5, or no bias and
//     beta = theta = 0.5):
//       simple   spk = ff + 0.5 mem > 0.5, mem' = ff
//       real     snn.Leaky's hard reset (lif_update)
//       one/two where  u = mem > theta ? 0 : beta mem + ff, spk = u > theta,
//                      mem' = u, or (two) u > theta ? 0 : u.
//
// Design. Two kernels, both over pixel-major bf16 tiles in shared memory
// (32 channels of a pixel contiguous, pitch 40) and the whole-net kernels'
// mma.sync m16n8k16 bf16 -> f32 implicit GEMM (wholenet::mma_k16: pixels
// on M, the 32 output channels on N, k over 9 taps x 32 channels). One TPU
// program holds a whole-width window ([32, 32, 256] bf16 is 512 KB, K8l's
// three 1.5 MB); a CTA holds 227 KB, so each CTA owns a 16 x 16 output tile
// and its column halo as well as its row halo shrinks by one pixel per
// layer, as K3 schedules it (csrc/fused_net.cu):
//   stack_kernel<NL> (kA with NL = 1, kB with NL = 7): x staged over
//     (16 + 2 NL)^2 pixels, columns outside [0, W) zero; layer l computes
//     (16 + 2(NL - l))^2 pixels into the other of two ping-pong tiles,
//     zero outside columns [0, W) (the next layer's column padding); the
//     last layer writes the owned pixels to device memory. kB at 16 x 16:
//     x 72 KB, the tiles 63 KB, w 19 KB: 154 KB, one CTA per SM; its
//     seven layers compute 3500 pixels for 256 owned.
//   chain_kernel<...> (nine variants): x staged over 20 x 20 pixels, both
//     weight matrices; unit 1 over 18 x 18 pixels reads m0 from device
//     memory in its epilogue and keeps bf16(spk1) in shared memory; unit 2
//     over the owned 16 x 16 reads spk1 (or the staged x one pixel in) and
//     m1; the pred head sums the 32 channels of the staged spk2 per pixel.
//     116 KB with the pred tile. The CTAs of the first and last row tile
//     also write the zero border rows of o0 and o1: one launch per call.
// Staging is plain 2-byte loads along W (a column halo that starts one or
// two columns off a 16-byte boundary rules out a TMA box, which faulted
// there in csrc/probe_unit_loop.cu); it is not overlapped with the mma. Every LIF
// rounding is explicit (no fused multiply-add), as in the plain version.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the files' shapes
// (C = 32, H = 64, W = 256, TH = 16; B = 1 for K8k, 2 for the chain), for
// what each function needs (probes/wholenet_bisect.py::bisect_bytes):
//   kA 3.20 MB -> 0.95 us (0.30 GFLOP); kB 4.08 MB, 1.22 us, against 2.91
//   GFLOP of its layers' cones -> 2.94 us; the chain 13.1-17.0 MB (x, m0,
//   m1 over the rows the outputs reach, o0 and o1 with their borders, the
//   flow) -> 3.9-5.1 us against 1.23 GFLOP. Grids: 64 CTAs (K8k), 128
//   (chain), on 132 SMs; each CTA's layers run in turn behind a barrier.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_wholenet_bisect.so probe_wholenet_bisect.cu
#include "fused_net_common.cuh"

namespace evflow {
namespace bisect {

using wholenet::C;       // 32 channels
using wholenet::NF;      // n8 fragments of the output channels
using wholenet::SPITCH;  // bf16 per pixel of a pixel-major tile
constexpr int WPITCH = 9 * C + PAD;  // bf16 per staged weight row
constexpr int TH = 16;               // output rows per CTA, the probes' TH
constexpr int TW = 16;               // output columns per CTA
constexpr int E = TH + 16;           // kB's block rows
constexpr int KB_LAYERS = 7;
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;

// Packed weights [C, 9*ck] -> shared memory [C][9*ck + PAD], 16 bytes at a time.
__device__ void stage_unit_weights(const __nv_bfloat16* wk, int ck, __nv_bfloat16* wsm) {
  const int vec_per_row = 9 * ck / 8;
  const uint4* src = reinterpret_cast<const uint4*>(wk);
  for (int i = threadIdx.x; i < C * vec_per_row; i += blockDim.x) {
    const int n = i / vec_per_row, v = i - n * vec_per_row;
    *reinterpret_cast<uint4*>(wsm + n * (9 * ck + PAD) + v * 8) = src[i];
  }
}

enum Body { KA = 0, KB = 1, CHAIN0 = 2, N_BODIES = 11 };  // chain variants 2..10
enum Lif { SIMPLE, REAL, ONE_WHERE, TWO_WHERE };
enum Prm { NO_PARAMS, HALF, PER_CHANNEL };  // no bias, beta = theta = 0.5 | all 0.5 | from p
enum Flow { ALL_CHANNELS, TWO_CHANNELS, PRED };

// Mirrored by ctypes in evflow_torch/probes/wholenet_bisect.py.
struct BisectArgs {
  const __nv_bfloat16* x;   // kA, chain [B, C, H + 2TH, W]; kB [B, C, (H / TH) E, W]
  const __nv_bfloat16* m0;  // chain [B, C, H + 2TH, W]
  const __nv_bfloat16* m1;
  const __nv_bfloat16* w0;  // [C, 9C] (kA, kB: w)
  const __nv_bfloat16* w1;
  const float* p0;          // [C, 3] (kA: p, beta in column 0)
  const float* p1;
  const __nv_bfloat16* pw;  // [2, C]
  const float* pb;          // [2, 1]
  __nv_bfloat16* o0;        // [B, C, H + 2TH, W]
  __nv_bfloat16* o1;
  float* out;               // kA, kB out [B, C, H, W]; chain flow [B, C | 2, H, W]
  int body, B, H, W;
  int grid, threads, smem;  // set by the launch
};

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) { return __float2bfloat16_rn(v); }

// Rows [row0, row0 + rows) and columns [col0, col0 + cols) of one image's
// channel-major planes src [C][src_rows][W] -> the pixel-major tile
// [rows * cols][SPITCH]; columns outside [0, W) are zero (the probes'
// column padding). Rows are the caller's to keep inside the planes.
__device__ void stage(const __nv_bfloat16* src, int src_rows, int W, int row0, int col0,
                      int rows, int cols, __nv_bfloat16* buf) {
  const int px = rows * cols;
  for (int e = threadIdx.x; e < C * px; e += blockDim.x) {
    const int ch = e / px, p = e - ch * px;
    const int r = p / cols, col = col0 + p - r * cols;
    buf[p * SPITCH + ch] =
        col >= 0 && col < W
            ? src[(static_cast<size_t>(ch) * src_rows + row0 + r) * W + col]
            : f2bf(0.f);
  }
}

// One 3x3 conv of a pixel-major tile: output pixel (r, c) of a region wo
// pixels wide and n_out pixels in all reads input pixels base + (r + dy)
// in_w + c + dx, against the staged weights [C][WPITCH]. Warps take
// 32-pixel pairs of m16 fragments in turn; epi(r, c, channel, sum) receives
// every output once.
template <class Epi>
__device__ __forceinline__ void conv_tile(const __nv_bfloat16* in, int in_w, int base,
                                          const __nv_bfloat16* wsm, int wo, int n_out,
                                          const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n_pairs = (n_out + 31) >> 5;
  for (int pair = warp; pair < n_pairs; pair += NWARPS) {
    int rr[2][2], cc[2][2], pix[2][2];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = pair * 32 + mf * 16 + half * 8 + g;
        const int pc = p < n_out ? p : n_out - 1;  // ragged fragment: load a valid pixel
        const int r = pc / wo, c = pc - r * wo;
        rr[mf][half] = p < n_out ? r : -1;
        cc[mf][half] = c;
        pix[mf][half] = base + r * in_w + c;
      }
    float acc[2][NF][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * in_w + tap % 3;
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += 16) {
        wholenet::mma_k16(in, SPITCH, pix, toff, c0, wsm, WPITCH, tap * C + c0, g, q, acc);
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

// kA (NL = 1): out = conv * beta. kB (NL = 7): v = conv > 0, seven layers.
template <int NL>
__global__ void __launch_bounds__(THREADS, 1) stack_kernel(const __grid_constant__ BisectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int X = TH + 2 * NL;  // staged x tile, rows and columns (TH == TW)
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf0 = wsm + C * WPITCH;     // x, then the even layers' outputs
  __nv_bfloat16* buf1 = buf0 + X * X * SPITCH;  // the odd layers' outputs
  const int b = blockIdx.z, i = blockIdx.y, c0 = blockIdx.x * TW;
  // kA: output row t is centred on x row t + TH; kB: output row j of block
  // i on block row j + 7. Tile row 0 of x is NL rows above either.
  const int src_rows = NL == 1 ? a.H + 2 * TH : (a.H / TH) * E;
  const int row0 = NL == 1 ? i * TH + TH - 1 : i * E;
  stage_unit_weights(a.w0, C, wsm);
  stage(a.x + static_cast<size_t>(b) * C * src_rows * a.W, src_rows, a.W, row0, c0 - NL, X, X,
        buf0);
  __syncthreads();
#pragma unroll
  for (int l = 1; l <= NL; ++l) {
    const int halo = NL - l, wo = TW + 2 * halo;
    const __nv_bfloat16* in = (l & 1) ? buf0 : buf1;
    if (l < NL) {
      __nv_bfloat16* nxt = (l & 1) ? buf1 : buf0;
      conv_tile(in, wo + 2, 0, wsm, wo, (TH + 2 * halo) * wo,
                [&](int r, int c, int ch, float sum) {
                  const int col = c0 - halo + c;
                  const bool inside = col >= 0 && col < a.W;
                  nxt[(r * wo + c) * SPITCH + ch] = f2bf(inside && sum > 0.f ? 1.f : 0.f);
                });
      __syncthreads();
    } else {
      conv_tile(in, wo + 2, 0, wsm, TW, TH * TW, [&](int r, int c, int ch, float sum) {
        const int col = c0 + c;
        if (col >= a.W) return;
        const float v = NL == 1 ? __fmul_rn(sum, __ldg(a.p0 + 3 * ch)) : (sum > 0.f ? 1.f : 0.f);
        a.out[((static_cast<size_t>(b) * C + ch) * a.H + i * TH + r) * a.W + col] = v;
      });
    }
  }
}

// The unit's LIF on its conv sum, every rounding explicit.
template <int LIF, int PRM>
__device__ __forceinline__ void lif(float sum, float m, const float* p, int ch, float& spk,
                                    float& mem2) {
  float bias = 0.5f, beta = 0.5f, theta = 0.5f;
  if (PRM == PER_CHANNEL) {
    bias = __ldg(p + 3 * ch);
    beta = __ldg(p + 3 * ch + 1);
    theta = __ldg(p + 3 * ch + 2);
  }
  const float ff = PRM == NO_PARAMS ? sum : __fadd_rn(sum, bias);
  if (LIF == SIMPLE) {
    spk = __fadd_rn(ff, __fmul_rn(0.5f, m)) > 0.5f ? 1.f : 0.f;
    mem2 = ff;
  } else if (LIF == REAL) {
    lif_update(ff, m, beta, theta, true, spk, mem2);
  } else {
    const float u = m > theta ? 0.f : __fadd_rn(__fmul_rn(beta, m), ff);
    spk = u > theta ? 1.f : 0.f;
    mem2 = LIF == TWO_WHERE && u > theta ? 0.f : u;
  }
}

template <int LIF, int PRM, int FLOW, bool OUT_SPK, bool SCRATCH>
__global__ void __launch_bounds__(THREADS, 1) chain_kernel(const __grid_constant__ BisectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XW = TW + 4, W1 = TW + 2;  // x tile 20 x 20, unit-1 tile 18 x 18
  __nv_bfloat16* w0s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w1s = w0s + C * WPITCH;
  __nv_bfloat16* xt = w1s + C * WPITCH;
  __nv_bfloat16* s1 = xt + (TH + 4) * XW * SPITCH;
  __nv_bfloat16* s2 = s1 + (TH + 2) * W1 * SPITCH;  // spk2 for the pred head
  const int b = blockIdx.z, i = blockIdx.y, c0 = blockIdx.x * TW;
  const int Hp = a.H + 2 * TH, W = a.W;
  const int R = TH + i * TH;  // padded row of the tile's first output row
  const size_t img = static_cast<size_t>(b) * C * Hp * W;
  stage_unit_weights(a.w0, C, w0s);
  stage_unit_weights(a.w1, C, w1s);
  stage(a.x + img, Hp, W, R - 2, c0 - 2, TH + 4, XW, xt);
  for (int edge = 0; edge < 2; ++edge) {  // the border rows: zero
    if (edge == 0 ? i != 0 : i != static_cast<int>(gridDim.y) - 1) continue;
    const int rb = edge == 0 ? 0 : a.H + TH;
    for (int e = threadIdx.x; e < 2 * C * TH * TW; e += blockDim.x) {
      const int which = e / (C * TH * TW), rem = e - which * C * TH * TW;
      const int ch = rem / (TH * TW), r = (rem / TW) % TH, col = c0 + rem % TW;
      if (col < W) {
        (which ? a.o1 : a.o0)[img + (static_cast<size_t>(ch) * Hp + rb + r) * W + col] = f2bf(0.f);
      }
    }
  }
  __syncthreads();

  // unit 1 on padded rows R-1 .. R+TH, columns c0-1 .. c0+TW
  conv_tile(xt, XW, 0, w0s, W1, (TH + 2) * W1, [&](int r, int c, int ch, float sum) {
    const int col = c0 - 1 + c;
    float s = 0.f;
    if (col >= 0 && col < W) {
      const size_t o = img + (static_cast<size_t>(ch) * Hp + R - 1 + r) * W + col;
      float mem2;
      lif<LIF, PRM>(sum, bf2f(a.m0[o]), a.p0, ch, s, mem2);
      if (r >= 1 && r <= TH && c >= 1 && c <= TW) a.o0[o] = f2bf(OUT_SPK ? s : mem2);
    }
    s1[(r * W1 + c) * SPITCH + ch] = f2bf(s);
  });
  __syncthreads();

  // unit 2 on the owned rows R .. R+TH-1, columns c0 .. c0+TW-1
  conv_tile(SCRATCH ? xt : s1, SCRATCH ? XW : W1, SCRATCH ? XW + 1 : 0, w1s, TW, TH * TW,
            [&](int r, int c, int ch, float sum) {
              const int col = c0 + c;
              if (col >= W) return;
              const size_t o = img + (static_cast<size_t>(ch) * Hp + R + r) * W + col;
              float s, mem2;
              lif<LIF, PRM>(sum, bf2f(a.m1[o]), a.p1, ch, s, mem2);
              a.o1[o] = f2bf(OUT_SPK ? s : mem2);
              const int fc = FLOW == ALL_CHANNELS ? C : 2;
              const size_t f = ((static_cast<size_t>(b) * fc + ch) * a.H + R - TH + r) * W + col;
              if (FLOW == ALL_CHANNELS || (FLOW == TWO_CHANNELS && ch < 2)) a.out[f] = s;
              if (FLOW == PRED) s2[(r * TW + c) * SPITCH + ch] = f2bf(s);
            });
  if (FLOW == PRED) {  // flow = tanh(pw . spk2 + pb) per owned pixel
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * TH * TW; e += blockDim.x) {
      const int o = e / (TH * TW), p = e - o * TH * TW;
      const int r = p / TW, col = c0 + p % TW;
      if (col >= W) continue;
      float acc = 0.f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        acc = __fmaf_rn(bf2f(s2[p * SPITCH + ch]), bf2f(a.pw[o * C + ch]), acc);
      }
      a.out[((static_cast<size_t>(b) * 2 + o) * a.H + R - TH + r) * W + col] =
          tanhf(__fadd_rn(acc, __ldg(a.pb + o)));
    }
  }
}

// --- host side ----------------------------------------------------------------

template <class Kernel>
int run(Kernel kernel, BisectArgs& a, int smem, cudaStream_t stream) {
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + TW - 1) / TW, a.H / TH, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  a.grid = static_cast<int>(grid.x * grid.y * grid.z);
  a.threads = THREADS;
  a.smem = smem;
  return static_cast<int>(cudaGetLastError());
}

constexpr int tile_bytes(int px) { return px * SPITCH * 2; }
constexpr int W_BYTES = C * WPITCH * 2;

template <int NL>
int launch_stack(BisectArgs& a, cudaStream_t s) {
  constexpr int X = TH + 2 * NL;
  const int smem = W_BYTES + tile_bytes(X * X) + (NL > 1 ? tile_bytes((X - 2) * (X - 2)) : 0);
  return run(stack_kernel<NL>, a, smem, s);
}

template <int LIF, int PRM, int FLOW, bool OUT_SPK, bool SCRATCH>
int launch_chain(BisectArgs& a, cudaStream_t s) {
  const int smem = 2 * W_BYTES + tile_bytes((TH + 4) * (TW + 4)) +
                   tile_bytes((TH + 2) * (TW + 2)) + (FLOW == PRED ? tile_bytes(TH * TW) : 0);
  return run(chain_kernel<LIF, PRM, FLOW, OUT_SPK, SCRATCH>, a, smem, s);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool args_valid(const BisectArgs& a) {
  if (a.body < 0 || a.body >= N_BODIES || a.B < 1 || a.H < TH || a.H % TH != 0 || a.W < 1 ||
      a.x == nullptr || a.w0 == nullptr || !aligned(a.w0) || a.out == nullptr) {
    return false;
  }
  if (a.body == KA) return a.p0 != nullptr;
  if (a.body == KB) return true;
  return a.m0 != nullptr && a.m1 != nullptr && a.w1 != nullptr && aligned(a.w1) &&
         a.o0 != nullptr && a.o1 != nullptr;
}

}  // namespace bisect
}  // namespace evflow

// The one entry point: body 0 is kA, 1 kB, 2..10 the chain's variants in
// the order of probes/wholenet_bisect.py::BODIES (K8l from_scratch, h_chain;
// K8m's four cases; K8n passthrough, one_where, two_where). It returns the
// launch's cudaError_t (0 on success) and refuses what the kernels do not
// take: an unknown body, H not a positive multiple of 16, weights not
// 16-byte aligned, a missing operand (p0 and p1 for K8m's parameters, pw
// and pb for its pred head are checked by the variant that reads them).
extern "C" int probe_wholenet_bisect(evflow::bisect::BisectArgs* a, void* stream) {
  using namespace evflow::bisect;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool params = a->p0 != nullptr && a->p1 != nullptr;
  const bool pred = a->pw != nullptr && a->pb != nullptr;
  switch (a->body) {
    case KA: return launch_stack<1>(*a, s);
    case KB: return launch_stack<KB_LAYERS>(*a, s);
    case CHAIN0 + 0: return launch_chain<SIMPLE, NO_PARAMS, ALL_CHANNELS, true, true>(*a, s);
    case CHAIN0 + 1: return launch_chain<SIMPLE, NO_PARAMS, ALL_CHANNELS, true, false>(*a, s);
    case CHAIN0 + 2:
      if (!params || !pred) break;
      return launch_chain<SIMPLE, PER_CHANNEL, PRED, false, false>(*a, s);
    case CHAIN0 + 3:
      if (!params) break;
      return launch_chain<REAL, PER_CHANNEL, TWO_CHANNELS, false, false>(*a, s);
    case CHAIN0 + 4:
      if (!pred) break;
      return launch_chain<REAL, HALF, PRED, false, false>(*a, s);
    case CHAIN0 + 5:
      if (!params || !pred) break;
      return launch_chain<REAL, PER_CHANNEL, PRED, false, false>(*a, s);
    case CHAIN0 + 6: return launch_chain<SIMPLE, NO_PARAMS, TWO_CHANNELS, false, false>(*a, s);
    case CHAIN0 + 7: return launch_chain<ONE_WHERE, NO_PARAMS, TWO_CHANNELS, false, false>(*a, s);
    case CHAIN0 + 8: return launch_chain<TWO_WHERE, NO_PARAMS, TWO_CHANNELS, false, false>(*a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
