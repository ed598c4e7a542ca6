// Staging probes: halo'd row windows and a layer loop, staged into shared
// memory with the TMA engine's bulk copies, for sm_90a.
//
// Replaces the TPU kernels of
//   benchmarks/probe_manual_dma.py  (`run`, K8c): a manual DMA of the halo'd
//     row window x[0, :, i*TH : i*TH + E, :] into VMEM per grid step, then
//     out[0, :, tile i] = 2 * window[:, HALO : HALO + TH, :] as f32;
//   benchmarks/probe_manual_dma2.py (`make_run`, K8d): the same at HALO = 8
//     (E = 32, 8-aligned), into f32 and into bf16 scratch;
//   benchmarks/probe_layer_grid.py  (`run`, K8e): a sequential grid over L
//     layers into a persistent accumulator,
//       out = sum_{l<L} W_l [C, 9C] @ tile9(s_l),  s_l = m[l, :, 0:E-2, :]
//     for even l (a DMA that runs on even layers only), s_l = 0 for odd l,
//     with W_l read from the stacked weights at the runtime layer index.
// The TPU's `make_async_copy` + DMA semaphore becomes Hopper's bulk copy
// (cp.async.bulk global -> shared) completing on an mbarrier with the
// expected byte count.
//
// row_window. One CTA per (row tile i, group of `cpc` channels). One thread
// initialises the mbarrier, arms it with the group's bytes and issues one
// bulk copy per channel: a channel's window is E * W * esize contiguous bytes
// (whole rows), the halo rows included, since staging the halo'd window is
// the probe's work. Every thread waits on the barrier, then reads the TH
// interior rows from shared memory and writes 2x as f32 with 16-byte
// stores. `cpc` (probes/staging.py::channels_per_cta) keeps a CTA's windows
// within 48 KB and bundles channels only while the grid still has a CTA per
// SM, so several CTAs per SM overlap one's copy with another's stores. Given
// `halo_sum`, each CTA also adds up the 32-bit words of every staged
// channel's 2 * HALO halo rows as they lie in shared memory, into
// halo_sum[c][tile]: a check that the halo rows were staged, which the
// interior's output cannot show.
//
// layer_grid. One CTA of 4 warps per 64-pixel block of the flattened
// (E-2)*W plane; for each channel that block is one contiguous 128-byte
// segment of m[l, c]. The TPU's sequential grid over L becomes a runtime
// loop (`#pragma unroll 1`) inside each CTA, the accumulator stays in
// registers across the layers and is written once. Each layer: w_all[l] is
// staged into shared memory ([C][9C], rows padded by 8 bf16), by one bulk
// copy per row where C is a multiple of 16 (else element by element, with
// each repeat's channels padded to a multiple of 16); on even l one bulk
// copy per channel lands the block's segments ([C][64 + 8] bf16) on the
// same mbarrier (the lanes of warp 0 issue the copies), on odd l the buffer
// is zeroed; then mma.sync m16n8k16 bf16 -> f32
// runs over K = 9C, output channels on M, pixels on N, the B fragments read
// with ldmatrix.trans from the same staged channel rows for each of the 9
// repeats (the repeats are not folded and odd layers not skipped: the MACs
// are the probe's). Rows past C are zero, the tail block's pixels past the
// plane are masked on the store.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) for what each function
// needs, at the probes' shapes:
//   K8c  x [1,32,76,256] bf16, TH=16: the interior read once + the f32
//        output written = 3.15 MB -> 0.94 us (the 4 tiles' 28-row windows
//        staged with it: 3.93 MB);
//   K8d  HALO=8: f32 4.19 MB -> 1.25 us, bf16 3.15 MB -> 0.94 us (staged
//        6.29 and 4.19 MB);
//   large K8c at H=2048: 100.7 MB -> 30.0 us (staged 125.8 MB), the one
//        case where the bytes and not the launch set the time;
//   K8e  w_all [7,32,288], m [7,32,40,256]: the even layers' weights and
//        rows and the f32 output, 3.02 MB -> 0.90 us; their operations
//        with the repeats folded, 0.063 GFLOP, take 0.06 us (the kernel
//        issues 0.991 GFLOP).
// Every case but the large one is below a kernel launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_staging.so probe_staging.cu
#include "conv_lif_common.cuh"

namespace evflow {
namespace staging {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int HEADER = 16;          // the mbarrier, before the staged data
constexpr int RW_THREADS = 256;
constexpr int LG_PX = 64;                  // pixels per CTA
constexpr int LG_THREADS = 128;            // 4 warps of 16 pixels
constexpr int LG_XPITCH = LG_PX + 8;       // bf16 per staged channel row: 144 bytes
constexpr int LG_WPAD = 8;                 // bf16 padding per staged weight row

// --- mbarrier and bulk copy -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global to shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy accesses of shared memory before later
// bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- row_window (K8c, K8d) --------------------------------------------------

// Mirrored by ctypes in evflow_torch/probes/staging.py.
struct RowWindowArgs {
  const void* x;       // [1, C, H + 2 halo, W], bf16 or f32
  float* out;          // [1, C, H, W]
  uint32_t* halo_sum;  // [C, H / th], zeroed, or null: no sums
  int esize;      // 2 (bf16) or 4 (f32)
  int C, H, W, th, halo, cpc;
  int grid, smem;  // set by the launch
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);  // bf16 -> f32 is a 16-bit shift
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

template <class T>
__global__ void __launch_bounds__(RW_THREADS) row_window_kernel(RowWindowArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const T* win = reinterpret_cast<const T*>(smem + HEADER);
  const int tile = blockIdx.x, c0 = blockIdx.y * a.cpc;
  const int nc = min(a.cpc, a.C - c0);
  const int E = a.th + 2 * a.halo;
  const size_t rows_in = static_cast<size_t>(a.H) + 2 * a.halo;
  const uint32_t chan_bytes = static_cast<uint32_t>(E) * a.W * sizeof(T);

  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, nc * chan_bytes);
    const T* src = static_cast<const T*>(a.x) + (c0 * rows_in + tile * a.th) * a.W;
    for (int j = 0; j < nc; ++j) {
      bulk_copy(smem + HEADER + j * chan_bytes, src + j * rows_in * a.W, chan_bytes, bar);
    }
  }
  mbar_wait(bar, 0);

  if (a.halo_sum != nullptr) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(smem + HEADER);
    const int hw = a.halo * a.W * static_cast<int>(sizeof(T)) / 4;  // words of one halo
    const int bottom = (a.halo + a.th) * a.W * static_cast<int>(sizeof(T)) / 4;
    for (int j = 0; j < nc; ++j) {
      const uint32_t* cw = words + j * (chan_bytes / 4);
      uint32_t s = 0;
      for (int v = threadIdx.x; v < 2 * hw; v += RW_THREADS) s += cw[v < hw ? v : bottom + v - hw];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if ((threadIdx.x & 31) == 0) atomicAdd(a.halo_sum + (c0 + j) * gridDim.x + tile, s);
    }
  }

  const int vpr = a.W / 4;  // 16-byte f32 stores per row
  const int per_c = a.th * vpr;
  for (int v = threadIdx.x; v < nc * per_c; v += RW_THREADS) {
    const int j = v / per_c, rem = v - j * per_c;
    const int r = rem / vpr, q = rem - r * vpr;
    float4 f = load4(win + (static_cast<size_t>(j) * E + a.halo + r) * a.W + 4 * q);
    f.x *= 2.f;
    f.y *= 2.f;
    f.z *= 2.f;
    f.w *= 2.f;
    *reinterpret_cast<float4*>(
        a.out + ((static_cast<size_t>(c0 + j) * a.H + tile * a.th + r) * a.W + 4 * q)) = f;
  }
}

template <class T>
int launch_row_window(RowWindowArgs& a, cudaStream_t stream) {
  const int E = a.th + 2 * a.halo;
  a.smem = HEADER + a.cpc * E * a.W * static_cast<int>(sizeof(T));
  if (a.smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = row_window_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H / a.th, (a.C + a.cpc - 1) / a.cpc);
  kernel<<<grid, RW_THREADS, a.smem, stream>>>(a);
  a.grid = static_cast<int>(grid.x * grid.y);
  return static_cast<int>(cudaGetLastError());
}

// --- layer_grid (K8e) -------------------------------------------------------

// Mirrored by ctypes in evflow_torch/probes/staging.py.
struct LayerGridArgs {
  const __nv_bfloat16* w;  // [L, C, 9C]
  const __nv_bfloat16* m;  // [L, C, Em, W], Em >= E
  float* out;              // [C, (E - 2) W]
  int L, C, E, Em, W;
  int grid, smem;  // set by the launch
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

template <int MF>  // m16 fragments: output channels padded to CP = 16 MF
constexpr int lg_smem() {
  return HEADER + (MF * 16 * LG_XPITCH + MF * 16 * (9 * MF * 16 + LG_WPAD)) * 2;
}

template <int MF>
__global__ void __launch_bounds__(LG_THREADS) layer_grid_kernel(LayerGridArgs a) {
  constexpr int CP = MF * 16;
  constexpr int KP = 9 * CP;
  constexpr int WPITCH = KP + LG_WPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + HEADER);  // [CP][LG_XPITCH]
  __nv_bfloat16* ws = xs + CP * LG_XPITCH;                               // [CP][WPITCH]
  const int P = (a.E - 2) * a.W;
  const int p0 = blockIdx.x * LG_PX;
  const int np = min(LG_PX, P - p0);
  const uint32_t seg = np * 2;  // bytes of one channel's segment
  const int K = 9 * a.C;
  const size_t plane = static_cast<size_t>(a.Em) * a.W;

  if (threadIdx.x == 0) mbar_init(bar);
  uint4* xv = reinterpret_cast<uint4*>(xs);
  for (int i = threadIdx.x; i < CP * LG_XPITCH / 8; i += LG_THREADS) xv[i] = make_uint4(0, 0, 0, 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = warp * 16;  // the warp's pixels: two n8 fragments
  // ldmatrix.x4.trans: matrices (channels c0..c0+7 | c0+8..c0+15) x (pixels
  // n0..n0+7 | n0+8..n0+15) give b0, b1 of the first n8 fragment, then of the second
  const __nv_bfloat16* brow =
      xs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LG_XPITCH + n0 + (lane >> 4) * 8;

  float acc[MF][2][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;

  // C a multiple of 16: a weight row is staged as it lies in device memory,
  // by one bulk copy; otherwise element by element into the padded layout
  const bool bulk_w = a.C == CP;
  uint32_t parity = 0;
#pragma unroll 1
  for (int l = 0; l < a.L; ++l) {
    fence_proxy_async();  // this thread's reads and zeroing of xs, ws before the copies below
    __syncthreads();      // every warp is done with the previous layer's operands
    const bool even = (l & 1) == 0;
    const __nv_bfloat16* wl = a.w + static_cast<size_t>(l) * a.C * K;
    if (warp == 0 && (even || bulk_w)) {  // the lanes of warp 0 issue the copies
      if (lane == 0) mbar_expect_tx(bar, (bulk_w ? a.C * K * 2 : 0) + (even ? a.C * seg : 0));
      __syncwarp();
      if (bulk_w) {
        for (int r = lane; r < a.C; r += 32) bulk_copy(ws + r * WPITCH, wl + r * K, K * 2, bar);
      }
      if (even) {
        const __nv_bfloat16* src = a.m + static_cast<size_t>(l) * a.C * plane + p0;
        for (int c = lane; c < a.C; c += 32) {
          bulk_copy(xs + c * LG_XPITCH, src + c * plane, seg, bar);
        }
      }
    }
    if (!even) {
      for (int i = threadIdx.x; i < CP * LG_XPITCH / 8; i += LG_THREADS) {
        xv[i] = make_uint4(0, 0, 0, 0);
      }
    }
    if (!bulk_w) {  // [CP][WPITCH], column rep * CP + c holding W[l, row, rep * C + c]
      for (int e = threadIdx.x; e < CP * KP; e += LG_THREADS) {
        const int r = e / KP, k = e - r * KP;
        const int rep = k / CP, c = k - rep * CP;
        ws[r * WPITCH + k] = (r < a.C && c < a.C) ? wl[r * K + rep * a.C + c]
                                                   : __ushort_as_bfloat16(0);
      }
    }
    __syncthreads();
    if (even || bulk_w) {
      mbar_wait(bar, parity);
      parity ^= 1u;
    }
#pragma unroll 1
    for (int rep = 0; rep < 9; ++rep) {
#pragma unroll
      for (int c0 = 0; c0 < CP; c0 += 16) {
        const int k0 = rep * CP + c0;
        uint32_t b[4];
        ldsm_x4_trans(b, brow + c0 * LG_XPITCH);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          const __nv_bfloat16* pa = ws + (mf * 16 + g) * WPITCH + k0 + 2 * q;
          uint32_t af[4];
          af[0] = lds32(pa);                   // row g,   k 2q..2q+1
          af[1] = lds32(pa + 8 * WPITCH);      // row g+8
          af[2] = lds32(pa + 8);               // row g,   k 2q+8..2q+9
          af[3] = lds32(pa + 8 * WPITCH + 8);  // row g+8
          mma_bf16_16816(acc[mf][0], af, b[0], b[1]);
          mma_bf16_16816(acc[mf][1], af, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mf * 16 + g + 8 * (e >> 1), n = n0 + nf * 8 + 2 * q + (e & 1);
        if (row < a.C && n < np) a.out[static_cast<size_t>(row) * P + p0 + n] = acc[mf][nf][e];
      }
}

template <int MF>
int launch_layer_grid(LayerGridArgs& a, cudaStream_t stream) {
  a.smem = lg_smem<MF>();
  auto kernel = layer_grid_kernel<MF>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = ((a.E - 2) * a.W + LG_PX - 1) / LG_PX;
  kernel<<<grid, LG_THREADS, a.smem, stream>>>(a);
  a.grid = grid;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace staging
}  // namespace evflow

// Each entry point returns the launch's cudaError_t (0 on success) and
// refuses what the kernel does not take: pointers not 16-byte aligned, rows
// of W elements not a whole number of 16-byte pieces, H not a multiple of th.
extern "C" int probe_row_window(evflow::staging::RowWindowArgs* a, void* stream) {
  using namespace evflow::staging;
  const int esize = a->esize;
  const bool aligned = (reinterpret_cast<uintptr_t>(a->x) | reinterpret_cast<uintptr_t>(a->out)) %
                       16 == 0;
  if (a->x == nullptr || a->out == nullptr || !aligned || (esize != 2 && esize != 4) ||
      a->C < 1 || a->th < 1 || a->halo < 0 || a->H < a->th || a->H % a->th != 0 || a->W < 1 ||
      (a->W * esize) % 16 != 0 || a->cpc < 1 || a->cpc > a->C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return esize == 2 ? launch_row_window<__nv_bfloat16>(*a, s) : launch_row_window<float>(*a, s);
}

extern "C" int probe_layer_grid(evflow::staging::LayerGridArgs* a, void* stream) {
  using namespace evflow::staging;
  const bool aligned = (reinterpret_cast<uintptr_t>(a->w) | reinterpret_cast<uintptr_t>(a->m) |
                        reinterpret_cast<uintptr_t>(a->out)) % 16 == 0;
  if (a->w == nullptr || a->m == nullptr || a->out == nullptr || !aligned || a->L < 1 ||
      a->C < 1 || a->C > 64 || a->E < 3 || a->Em < a->E || a->W < 1 || a->W % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((a->C + 15) / 16) {
    case 1: return launch_layer_grid<1>(*a, s);
    case 2: return launch_layer_grid<2>(*a, s);
    case 3: return launch_layer_grid<3>(*a, s);
    default: return launch_layer_grid<4>(*a, s);
  }
}
