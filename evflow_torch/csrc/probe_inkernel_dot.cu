// In-kernel dot probes: the whole-network kernels' mma.sync mainloop on
// operands resident in shared memory, for sm_90a.
//
// Replaces the TPU kernels of benchmarks/probe_inkernel_dot.py (pallas_calls
// A pixel-major, B channel-major, Bi channel-major int8, C K-split) and
// benchmarks/probe_inkernel_dot2.py (`make`): each computes
//   out = sum over S steps of ( sum_{i<L} W_i . X )
// with X [K, Np] (or [Np, K]) and W_i [M, K] (or [K, M]) resident in fast
// memory, the TPU's sequential grid of S steps accumulating into the output
// block. They measured how fast in-kernel dots run at the conv's shapes.
//
// On Hopper. One CTA of 16 warps owns TP = 64 pixels and MT (32, or 16 where
// L weight slices of 32 rows do not fit) output channels. It stages its X
// tile and its rows of all L weight matrices into shared memory once, as
// [row][k] with rows padded by 16 bytes (the fragment loads are free of bank
// conflicts), then loops over the S steps: the TPU's sequential grid becomes
// a loop inside the CTA, the steps split over 8 groups of 2 warps, each warp
// keeping its sum in registers; the 8 partial sums are added in shared
// memory at the end and written once. A warp's tile is 32 pixels x 32
// channels (2 m16 x 4 n8 fragments), the tile of conv_region in
// fused_net_common.cuh, with the same 32-bit fragment loads (no ldmatrix)
// and mma.sync m16n8k16 bf16 -> f32 (m16n8k32 s8 -> s32 for the int8
// probe). So the rate reached here is the ceiling of the whole-network
// kernels' mainloop with staging, halo and LIF taken away.
//
// Orientation: pixel-major (A) puts pixels on the mma's M side and channels
// on N, as conv_region does; channel-major (B, Bi, C, dot2) puts the weight
// rows on M and pixels on N. C's three K=96 dots per weight run as one
// K=288 stream into the same accumulators. acc=bf16 (dot2) accumulates each
// dot in f32, rounds it to bf16, and rounds the running sum to bf16 after
// each dot, as `acc += dot(..., preferred_element_type=bf16)` does.
//
// Bound on an H100 SXM: the operations, 2 M K Np L S (87.0 GFLOP at the
// probes' shapes: 0.088 ms at 989 TFLOP/s bf16, 0.044 ms at 1979 TOP/s
// int8); the operand bytes are read once and are far below that.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_inkernel_dot.so probe_inkernel_dot.cu
#include <type_traits>

#include "conv_lif_common.cuh"

namespace evflow {
namespace probe {

constexpr int TP = 64;                 // pixels per CTA
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int NPG = TP / 32;           // pixel groups of 32
constexpr int NSG = NWARPS / NPG;      // step groups
constexpr int ROW_PAD = 16;            // bytes per shared-memory row
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory of one CTA

enum Mode { F32_ACC = 0, BF16_ACC = 1, S8 = 2 };

// Mirrored by ctypes in evflow_torch/probes/inkernel_dot.py.
struct ProbeArgs {
  const void* x;
  const void* w;
  void* out;
  long long x_sp, x_sk;              // X element (pixel, k)
  long long w_si, w_sm, w_sj, w_sk;  // W element (i, m, k): k = j * kseg + kk
  long long o_sp, o_sm;              // out element (pixel, m)
  int Np, K, M, L, S, kseg;
  int pixel_major;                   // pixels on the mma's M side
  int mode;
  int tile_m;                        // MT: 32 or 16
  int grid, smem;                    // set by the launch
};

inline int row_bytes(const ProbeArgs& a) { return a.K * (a.mode == S8 ? 1 : 2) + ROW_PAD; }

inline int smem_bytes(const ProbeArgs& a) {
  const int operands = (TP + a.L * a.tile_m) * row_bytes(a);
  const int partials = NSG * TP * a.tile_m * 4;
  return operands > partials ? operands : partials;
}

// X's TP-pixel tile -> [TP][kpb bytes]; pixels past Np are zero. Reads run
// along whichever of pixel and k is contiguous in device memory.
template <class T>
__device__ void stage_x(const ProbeArgs& a, int p0, unsigned char* xs, int kpb) {
  const T* x = static_cast<const T*>(a.x);
  const bool k_fast = a.x_sk == 1;
  for (int e = threadIdx.x; e < TP * a.K; e += blockDim.x) {
    int p, k;
    if (k_fast) {
      p = e / a.K;
      k = e - p * a.K;
    } else {
      k = e / TP;
      p = e - k * TP;
    }
    const int gp = p0 + p;
    reinterpret_cast<T*>(xs + p * kpb)[k] = gp < a.Np ? x[gp * a.x_sp + k * a.x_sk] : T(0);
  }
}

// Rows [m0, m0 + MT) of every W_i -> [L][MT][kpb bytes].
template <class T>
__device__ void stage_w(const ProbeArgs& a, int m0, unsigned char* ws, int kpb) {
  const T* w = static_cast<const T*>(a.w);
  const int mt = a.tile_m;
  const int per_i = mt * a.K;
  const bool k_fast = a.w_sk == 1;
  for (int e = threadIdx.x; e < a.L * per_i; e += blockDim.x) {
    const int i = e / per_i, r = e - i * per_i;
    int m, k;
    if (k_fast) {
      m = r / a.K;
      k = r - m * a.K;
    } else {
      k = r / mt;
      m = r - k * mt;
    }
    const int j = k / a.kseg, kk = k - j * a.kseg;
    reinterpret_cast<T*>(ws + (i * mt + m) * kpb)[k] =
        w[i * a.w_si + (m0 + m) * a.w_sm + j * a.w_sj + kk * a.w_sk];
  }
}

__device__ __forceinline__ uint32_t lds(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  mma_bf16_16816(d, a, b0, b1);
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MT, int MODE, bool PIXM>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(ProbeArgs a) {
  using T = typename std::conditional<MODE == S8, int8_t, uint16_t>::type;
  using Acc = typename std::conditional<MODE == S8, int, float>::type;
  constexpr int MFA = PIXM ? 2 : MT / 16;  // m16 fragments of a warp's tile
  constexpr int NFB = PIXM ? MT / 8 : 4;   // n8 fragments
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpb = a.K * static_cast<int>(sizeof(T)) + ROW_PAD;
  unsigned char* xs = smem;
  unsigned char* ws = smem + TP * kpb;
  const int p0 = blockIdx.x * TP, m0 = blockIdx.y * MT;
  stage_x<T>(a, p0, xs, kpb);
  stage_w<T>(a, m0, ws, kpb);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int pg = warp % NPG, sg = warp / NPG;
  const unsigned char* xrow = xs + pg * 32 * kpb;  // the warp's 32 pixels
  const int kbytes = a.K * static_cast<int>(sizeof(T));

  Acc out[MFA][NFB][4];
#pragma unroll
  for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[mf][nf][e] = 0;

  for (int s = sg; s < a.S; s += NSG) {
    float step[MFA][NFB][4];  // acc=bf16: this step's running bf16 sum
#pragma unroll
    for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
      for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) step[mf][nf][e] = 0.f;
    for (int i = 0; i < a.L; ++i) {
      const unsigned char* wi = ws + i * MT * kpb;
      const unsigned char* abase = PIXM ? xrow : wi;
      const unsigned char* bbase = PIXM ? wi : xrow;
      Acc dot[MFA][NFB][4];  // W_i . X
#pragma unroll
      for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
        for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[mf][nf][e] = 0;
      for (int kb = 0; kb < kbytes; kb += 32) {  // one k16 (bf16) or k32 (s8) step
        uint32_t af[MFA][4], b0[NFB], b1[NFB];
#pragma unroll
        for (int mf = 0; mf < MFA; ++mf) {
          const unsigned char* p = abase + (mf * 16 + g) * kpb + kb + 4 * q;
          af[mf][0] = lds(p);                 // row g,   k bytes 4q..4q+3
          af[mf][1] = lds(p + 8 * kpb);       // row g+8
          af[mf][2] = lds(p + 16);            // row g,   k bytes 16+4q..
          af[mf][3] = lds(p + 8 * kpb + 16);  // row g+8
        }
#pragma unroll
        for (int nf = 0; nf < NFB; ++nf) {
          const unsigned char* p = bbase + (nf * 8 + g) * kpb + kb + 4 * q;
          b0[nf] = lds(p);
          b1[nf] = lds(p + 16);
        }
#pragma unroll
        for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
          for (int mf = 0; mf < MFA; ++mf) mma(dot[mf][nf], af[mf], b0[nf], b1[nf]);
      }
#pragma unroll
      for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
        for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (MODE == BF16_ACC) {
              step[mf][nf][e] = bf16r(step[mf][nf][e] + bf16r(dot[mf][nf][e]));
            } else {
              out[mf][nf][e] += dot[mf][nf][e];
            }
          }
    }
    if (MODE == BF16_ACC) {
#pragma unroll
      for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
        for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) out[mf][nf][e] += step[mf][nf][e];
    }
  }

  // the step groups' partial sums -> shared memory [NSG][TP][MT], added in
  // group order and written once
  __syncthreads();  // every warp is done with the operands
  Acc* part = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mf * 16 + g + 8 * (e >> 1), col = nf * 8 + 2 * q + (e & 1);
        const int p = pg * 32 + (PIXM ? row : col), m = PIXM ? col : row;
        part[(sg * TP + p) * MT + m] = out[mf][nf][e];
      }
  __syncthreads();
  Acc* dst = static_cast<Acc*>(a.out);
  const bool m_fast = a.o_sm == 1;
  for (int e = threadIdx.x; e < TP * MT; e += THREADS) {
    int p, m;
    if (m_fast) {
      p = e / MT;
      m = e - p * MT;
    } else {
      m = e / TP;
      p = e - m * TP;
    }
    if (p0 + p >= a.Np) continue;
    Acc v = 0;
    for (int k = 0; k < NSG; ++k) v += part[(k * TP + p) * MT + m];
    dst[(p0 + p) * a.o_sp + (m0 + m) * a.o_sm] = v;
  }
}

template <int MT, int MODE, bool PIXM>
int launch(ProbeArgs& a, cudaStream_t stream) {
  auto kernel = probe_kernel<MT, MODE, PIXM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Np + TP - 1) / TP, a.M / MT);
  kernel<<<grid, THREADS, a.smem, stream>>>(a);
  a.grid = static_cast<int>(grid.x * grid.y);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(ProbeArgs& a, cudaStream_t stream) {
  if (a.pixel_major) return a.tile_m == 32 ? launch<32, MODE, true>(a, stream) : -1;
  return a.tile_m == 32 ? launch<32, MODE, false>(a, stream) : launch<16, MODE, false>(a, stream);
}

}  // namespace probe
}  // namespace evflow

extern "C" int probe_inkernel_dot(evflow::probe::ProbeArgs* a, void* stream) {
  using namespace evflow::probe;
  const int kstep = a->mode == S8 ? 32 : 16;
  if (a->x == nullptr || a->w == nullptr || a->out == nullptr || a->Np < 1 || a->L < 1 ||
      a->S < 1 || a->K < kstep || a->K % kstep != 0 || a->kseg < 1 || a->K % a->kseg != 0 ||
      (a->tile_m != 32 && a->tile_m != 16) || a->M % a->tile_m != 0 ||
      (a->pixel_major && (a->tile_m != 32 || a->mode == S8)) || a->mode < F32_ACC ||
      a->mode > S8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a->smem = smem_bytes(*a);
  if (a->smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->mode) {
    case F32_ACC: return launch_mode<F32_ACC>(*a, s);
    case BF16_ACC: return launch_mode<BF16_ACC>(*a, s);
    default: return launch_mode<S8>(*a, s);
  }
}
