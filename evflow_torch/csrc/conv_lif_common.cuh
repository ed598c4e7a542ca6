// Fused conv3x3 (+ recurrent conv3x3) + folded BatchNorm + LIF step for Hopper.
//
// Shared by conv_lif.cu (NHWC activations) and conv_lif_cmajor.cu (NCHW
// activations); the two differ only in how a (b, h, w, c) element is
// addressed in device memory, which `offset<CMAJOR>` encodes.
//
// What one launch computes, for every pixel and output channel c:
//   ff    = sum_k bf16(in[k]) * bf16(W[k, c])  (f32 accumulation)  + bias[c]
//   reset = mem > theta;  base = beta*mem + ff
//   u     = base - reset*base        (hard reset)  | base - reset*theta (subtract)
//   spk   = u > theta
//   mem'  = u - (spk - reset)*u      (hard reset)  | u - (spk - reset)*theta
// where `in` is the 3x3 neighbourhood of the channel concatenation
// [x | prev_spk] (prev_spk only for recurrent units), zero outside the
// image. That is the snn.Leaky inference update of evflow_torch.ops.lif
// with BatchNorm folded into W and bias.
//
// Design. The conv is an implicit GEMM: M = pixels, N = C output channels,
// K = 9 * Ck, with Ck the input channel count rounded up to 16. A block owns
// an 8 x 32 pixel tile. It reads the halo'd (10 x 34) input tile once from
// device memory as f32, rounds it to bf16 while writing it to shared memory
// (no bf16 copy of the input is ever written to device memory, and the image
// border is masked here, so no padded copy either), stages the packed bf16
// weights [C, K] next to it, and each of its 8 warps computes one tile row
// (two m16 fragments x C/8 n8 fragments) with mma.sync m16n8k16 bf16 -> f32.
// The LIF update runs on the accumulator registers; mem is read and spk and
// mem' written straight from the fragment layout. Shared-memory rows are
// padded by 8 bf16 so the fragment loads are free of bank conflicts.
//
// Bound on an H100 SXM: at the FireNet bench shape (B=2, 256x256, C=32,
// f32 state) a feedforward unit must move ~67 MB (x, mem in; spk, mem' out)
// and a recurrent unit ~84 MB (plus prev_spk), against 2.4 / 4.8 GFLOP of
// bf16 tensor work: memory-bound, ~20 / ~25 us at 3.35 TB/s. The design reads
// each input element once from device memory (plus the 6% halo re-read,
// mostly from L2) and writes each output once; the tensor-core work is far
// below the memory time. This first version is single-stage (no cp.async or
// TMA pipelining), so load latency is hidden only by the other resident
// blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace evflow {

constexpr int TILE_H = 8;   // output rows per block: one warp per row
constexpr int TILE_W = 32;  // output columns per block: two m16 fragments
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int THREADS = TILE_H * 32;
constexpr int PAD = 8;  // bf16 padding per shared-memory row (bank spread)

struct ConvLIFArgs {
  const float* __restrict__ x;     // [B, H, W, Cin] or [B, Cin, H, W]
  const float* __restrict__ prev;  // previous spikes, like mem; null if feedforward
  const float* __restrict__ mem;   // [B, H, W, C] or [B, C, H, W]
  const __nv_bfloat16* __restrict__ wk;  // [C, 9 * Ck], k = (dy*3 + dx)*Ck + ch
  const float* __restrict__ bias;
  const float* __restrict__ beta;
  const float* __restrict__ theta;
  float* __restrict__ spk;
  float* __restrict__ mem_out;
  int B, H, W, Cin, C, Ck, hard_reset;
};

template <bool CMAJOR>
__device__ __forceinline__ size_t offset(int b, int h, int w, int c, int H, int W,
                                         int channels) {
  return CMAJOR ? ((static_cast<size_t>(b) * channels + c) * H + h) * W + w
                : ((static_cast<size_t>(b) * H + h) * W + w) * channels + c;
}

__device__ __forceinline__ float load_input(const ConvLIFArgs& a, int b, int h, int w,
                                            int c, bool cmajor) {
  if (c < a.Cin) {
    return cmajor ? a.x[offset<true>(b, h, w, c, a.H, a.W, a.Cin)]
                  : a.x[offset<false>(b, h, w, c, a.H, a.W, a.Cin)];
  }
  c -= a.Cin;
  return cmajor ? a.prev[offset<true>(b, h, w, c, a.H, a.W, a.C)]
                : a.prev[offset<false>(b, h, w, c, a.H, a.W, a.C)];
}

// Halo'd input tile -> shared memory, [HALO_H][HALO_W][Ck + PAD] bf16.
template <bool CMAJOR>
__device__ void stage_inputs(const ConvLIFArgs& a, __nv_bfloat16* tile, int b, int h0,
                             int w0) {
  const int pitch = a.Ck + PAD;
  const int channels = a.Cin + (a.prev != nullptr ? a.C : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!CMAJOR) {
    // one halo pixel per warp, channels across lanes: coalesced NHWC reads
    for (int p = warp; p < HALO_H * HALO_W; p += TILE_H) {
      const int r = p / HALO_W, col = p - r * HALO_W;
      const int h = h0 - 1 + r, w = w0 - 1 + col;
      const bool inside = h >= 0 && h < a.H && w >= 0 && w < a.W;
      for (int c = lane; c < a.Ck; c += 32) {
        const float v = (inside && c < channels) ? load_input(a, b, h, w, c, false) : 0.f;
        tile[p * pitch + c] = __float2bfloat16_rn(v);
      }
    }
  } else {
    // one (channel, halo row) per warp, columns across lanes: coalesced NCHW reads
    for (int rc = warp; rc < HALO_H * a.Ck; rc += TILE_H) {
      const int c = rc / HALO_H, r = rc - c * HALO_H;
      const int h = h0 - 1 + r;
      for (int col = lane; col < HALO_W; col += 32) {
        const int w = w0 - 1 + col;
        const bool inside = h >= 0 && h < a.H && w >= 0 && w < a.W;
        const float v = (inside && c < channels) ? load_input(a, b, h, w, c, true) : 0.f;
        tile[(r * HALO_W + col) * pitch + c] = __float2bfloat16_rn(v);
      }
    }
  }
}

// Packed weights [C, K] -> shared memory [C][K + PAD], 16 bytes at a time.
__device__ void stage_weights(const ConvLIFArgs& a, __nv_bfloat16* wsm) {
  const int K = 9 * a.Ck;
  const int vec_per_row = K / 8;  // K is a multiple of 144
  const uint4* src = reinterpret_cast<const uint4*>(a.wk);
  for (int i = threadIdx.x; i < a.C * vec_per_row; i += THREADS) {
    const int n = i / vec_per_row, v = i - n * vec_per_row;
    *reinterpret_cast<uint4*>(wsm + n * (K + PAD) + v * 8) = src[i];
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The LIF update, with every rounding explicit (no fused multiply-add), so
// it rounds exactly as the plain PyTorch version does.
__device__ __forceinline__ void lif_update(float ff, float mem, float beta, float theta,
                                           bool hard, float& spk, float& mem2) {
  const float reset = mem > theta ? 1.f : 0.f;
  const float base = __fadd_rn(__fmul_rn(beta, mem), ff);
  const float u = hard ? __fsub_rn(base, __fmul_rn(reset, base))
                       : __fsub_rn(base, __fmul_rn(reset, theta));
  spk = u > theta ? 1.f : 0.f;
  const float d = __fsub_rn(spk, reset);
  mem2 = hard ? __fsub_rn(u, __fmul_rn(d, u)) : __fsub_rn(u, __fmul_rn(d, theta));
}

template <int NF, bool CMAJOR>
__global__ void __launch_bounds__(THREADS) conv_lif_kernel(ConvLIFArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = a.Ck + PAD;
  const int K = 9 * a.Ck;
  const int wpitch = K + PAD;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wsm = tile + HALO_H * HALO_W * pitch;

  const int b = blockIdx.z, h0 = blockIdx.y * TILE_H, w0 = blockIdx.x * TILE_W;
  stage_inputs<CMAJOR>(a, tile, b, h0, w0);
  stage_weights(a, wsm);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int h = h0 + warp;
  if (h >= a.H) return;

  float acc[2][NF][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += 16) {
    const int tap = k0 / a.Ck, c0 = k0 - tap * a.Ck;
    const int dy = tap / 3, dx = tap - dy * 3;
    const __nv_bfloat16* row = tile + ((warp + dy) * HALO_W + dx) * pitch + c0 + 2 * q;
    uint32_t af[2][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
      const __nv_bfloat16* p = row + (mf * 16 + g) * pitch;
      af[mf][0] = lds32(p);                  // pixel g,   k 2q..2q+1
      af[mf][1] = lds32(p + 8 * pitch);      // pixel g+8, k 2q..2q+1
      af[mf][2] = lds32(p + 8);              // pixel g,   k 2q+8..2q+9
      af[mf][3] = lds32(p + 8 * pitch + 8);  // pixel g+8, k 2q+8..2q+9
    }
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const __nv_bfloat16* pb = wsm + (nf * 8 + g) * wpitch + k0 + 2 * q;
      const uint32_t b0 = lds32(pb), b1 = lds32(pb + 8);
      mma_bf16_16816(acc[0][nf], af[0], b0, b1);
      mma_bf16_16816(acc[1][nf], af[1], b0, b1);
    }
  }

  const bool hard = a.hard_reset != 0;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = nf * 8 + 2 * q + j;
      const float bias = a.bias[c], beta = a.beta[c], theta = a.theta[c];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int w = w0 + mf * 16 + g + 8 * half;
          if (w >= a.W) continue;
          const size_t o = offset<CMAJOR>(b, h, w, c, a.H, a.W, a.C);
          float s, m2;
          lif_update(acc[mf][nf][2 * half + j] + bias, a.mem[o], beta, theta, hard, s, m2);
          a.spk[o] = s;
          a.mem_out[o] = m2;
        }
      }
    }
  }
}

template <int NF, bool CMAJOR>
int launch_nf(const ConvLIFArgs& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(HALO_H) * HALO_W * (a.Ck + PAD) +
       static_cast<size_t>(a.C) * (9 * a.Ck + PAD)) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(conv_lif_kernel<NF, CMAJOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.W + TILE_W - 1) / TILE_W, (a.H + TILE_H - 1) / TILE_H, a.B);
  conv_lif_kernel<NF, CMAJOR><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool CMAJOR>
int launch(const ConvLIFArgs& a, cudaStream_t stream) {
  if (a.Ck % 16 != 0 || a.Ck < a.Cin + (a.prev != nullptr ? a.C : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (a.C) {
    case 8: return launch_nf<1, CMAJOR>(a, stream);
    case 16: return launch_nf<2, CMAJOR>(a, stream);
    case 32: return launch_nf<4, CMAJOR>(a, stream);
    case 64: return launch_nf<8, CMAJOR>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace evflow

// The C entry point of each layout's library: every pointer and the stream
// as void*, returns the cudaError_t of the launch (0 on success).
#define EVFLOW_CONV_LIF_ENTRY(NAME, CMAJOR)                                            \
  extern "C" int NAME(const void* x, const void* prev, const void* mem, const void* wk, \
                      const void* bias, const void* beta, const void* theta, void* spk,   \
                      void* mem_out, int B, int H, int W, int Cin, int C, int Ck,         \
                      int hard_reset, void* stream) {                                    \
    evflow::ConvLIFArgs a{static_cast<const float*>(x),                                  \
                          static_cast<const float*>(prev),                               \
                          static_cast<const float*>(mem),                                \
                          static_cast<const __nv_bfloat16*>(wk),                         \
                          static_cast<const float*>(bias),                               \
                          static_cast<const float*>(beta),                               \
                          static_cast<const float*>(theta),                              \
                          static_cast<float*>(spk),                                      \
                          static_cast<float*>(mem_out),                                  \
                          B, H, W, Cin, C, Ck, hard_reset};                              \
    return evflow::launch<CMAJOR>(a, static_cast<cudaStream_t>(stream));                 \
  }
