// Staging probes: halo'd row windows and a layer loop, staged into shared
// memory with the TMA engine's bulk and tensor copies, for sm_90a.
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
// (cp.async.bulk global -> shared; a tensor copy for the layer grid)
// completing on an mbarrier with the expected byte count.
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
// layer_grid. One CTA per 64-pixel block of the flattened (E-2)*W plane
// (120 CTAs at the probe's 7680 pixels). The TPU's sequential grid over L
// becomes a runtime loop (`#pragma unroll 1`) inside each CTA, the
// accumulators stay in registers across the layers and are written once.
// The layers are staged through a ring of `depth` stages in shared memory
// (every layer's where they fit, up to 8: all 7 at C=32; 2 at C=64, where
// w[l] alone is 74 KB), each stage with a full and an empty mbarrier. A
// producer warp issues the copies of layer l into stage l % depth as soon
// as the consumer warps have read that stage's last layer, so the copies of
// every later layer in the ring are in flight while layer l's mma runs, and
// each layer waits on its own barrier alone, with no CTA barrier in the
// loop. The copies are TMA tensor copies with a 128-byte swizzle: w[l] in
// boxes of [C][64] columns (5 at C=32, where C is a multiple of 16; else
// the producer's lanes stage it element by element into the same layout,
// each repeat's channels padded to a multiple of 16) and, on even l, the
// block's 64 pixels of every channel of m[l] in one box, pixels past the
// plane zero-filled: 6 copies on an even layer, where one bulk copy per
// weight row and per channel (64) cost the TMA engine ~2 us a layer.
// Eight consumer warps (4 pixel quarters x 2 K groups, each group taking
// alternate k16 steps, fully unrolled) run mma.sync m16n8k16 bf16 -> f32
// over K = 9C, output channels on M, pixels on N: A fragments by
// ldmatrix.x4 from the weight boxes, B by ldmatrix.x4.trans from the same
// staged channel rows for each of the 9 repeats, or zeros on odd layers
// (the repeats are not folded and odd layers not skipped: the MACs, and the
// NaN of a non-finite weight times the zero block, are the probe's); the
// swizzle keeps both free of bank conflicts. The two K groups' sums meet
// once in shared memory. Rows past C are zero, the tail block's pixels
// past the plane are masked on the store. Each CTA reads every layer's
// weights from L2 (120 x 129 KB at the probe's shapes); staging only layer
// 0's weights did not move the time per layer, so the mma and not that
// traffic sets it (PERF.md).
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
#include <algorithm>
#include <cstring>

#include "conv_lif_common.cuh"
#include "tma.cuh"

namespace evflow {
namespace staging {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int HEADER = 16;          // the mbarrier, before the staged data
constexpr int RW_THREADS = 256;
constexpr int LG_PX = 64;                  // pixels per CTA
constexpr int LG_CONSUMERS = 8;            // 4 pixel quarters of 16 x 2 K groups
constexpr int LG_THREADS = (LG_CONSUMERS + 1) * 32;  // and one producer warp
constexpr int LG_BOX = 64;                 // bf16 columns of a staged box: 128-byte rows
constexpr int LG_MAX_DEPTH = 8;            // stages of the layer ring
constexpr int LG_HEADER = 128 + 1024;      // the full and empty barriers, and the ring's alignment

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
  int grid, depth, smem;  // set by the launch
};

// A ring stage at MF m16 fragments (CP = 16 MF channels): w[l] as NB boxes
// [CP][64] bf16 (128-byte rows, 9 CP columns rounded up to whole boxes),
// then the block's channel rows [CP][64]; each box 128-byte swizzled, its
// 16-byte chunk j of row r at chunk j ^ (r & 7).
__host__ __device__ constexpr int lg_boxes(int mf) { return (9 * 16 * mf + LG_BOX - 1) / LG_BOX; }
__host__ __device__ constexpr int lg_stage_bytes(int mf) {
  return (lg_boxes(mf) + 1) * 16 * mf * LG_BOX * 2;
}

// Stages of the ring (mirrored by staging.layer_grid_plan): every layer's
// where they fit, at most LG_MAX_DEPTH, at least one.
inline int lg_depth(int mf, int L) {
  const int fit = (SMEM_LIMIT - LG_HEADER) / lg_stage_bytes(mf);
  return std::max(1, std::min(std::min(L, LG_MAX_DEPTH), fit));
}

// What the layer-grid kernel reads: tensor maps of w_all (where C is a
// multiple of 16) and m, w_all itself for the element-wise staging, the
// output and the launch's sizes.
struct LgParams {
  CUtensorMap wmap;  // w_all as [L][C][9C], box [C][64]
  CUtensorMap xmap;  // m as [L][C][P]: each channel's first P = (E-2) W pixels, box [C][64]
  const __nv_bfloat16* w;
  float* out;
  int L, C, P, depth;
};

// One warp's share of a layer's k16 steps, ks = start, start + 2, ... <
// 9 MF: step ks is repeat ks / MF, channel block ks % MF, K columns k0 =
// 16 ks. The A fragments (w[l], output channels on M) come by ldmatrix.x4
// from the stage's weight boxes; B (the warp's 16 pixels, two n8 fragments)
// by ldmatrix.x4.trans from the staged channel rows, the same rows for each
// of the 9 repeats, or zeros on an odd layer (X false): its products with
// the zero block are kept. `a_lane` and `b_lane` hold the lane's row in the
// stage, `a_chunk` its k half and `sw` its rows' swizzle (row & 7).
template <int MF, bool X, int START>
__device__ __forceinline__ void lg_steps(float (&acc)[MF][2][4], uint32_t a_lane, int a_chunk,
                                         uint32_t b_lane, int sw) {
  constexpr int CP = MF * 16;
#pragma unroll
  for (int ks = START; ks < 9 * MF; ks += 2) {
    const int cb = ks % MF, k0 = 16 * ks;
    uint32_t b[4] = {0u, 0u, 0u, 0u};
    if (X) ldsm_x4_t(b, b_lane + cb * 16 * LG_BOX * 2);
    const uint32_t a_at =
        a_lane + (k0 / LG_BOX) * CP * LG_BOX * 2 + ((((k0 % LG_BOX) / 8 + a_chunk) ^ sw) << 4);
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      uint32_t a[4];
      ldsm_x4(a, a_at + mf * 16 * LG_BOX * 2);
      mma_bf16_16816(acc[mf][0], a, b[0], b[1]);
      mma_bf16_16816(acc[mf][1], a, b[2], b[3]);
    }
  }
}

template <int MF>
__global__ void __launch_bounds__(LG_THREADS, 1)
    layer_grid_kernel(const __grid_constant__ LgParams a) {
  constexpr int CP = MF * 16;
  constexpr int KP = 9 * CP;
  constexpr int ROW = LG_BOX * 2;             // bytes of a staged row
  constexpr int WBYTES = lg_boxes(MF) * CP * ROW;
  constexpr int STAGE = lg_stage_bytes(MF);
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [LG_MAX_DEPTH]: a stage has landed
  uint64_t* empty = full + LG_MAX_DEPTH;               // [LG_MAX_DEPTH]: a stage is read
  const uint32_t base = smem_u32(smem);
  unsigned char* ring = smem + (((base + 128 + 1023) & ~1023u) - base);  // 1024-byte aligned
  const int depth = a.depth;
  const int p0 = blockIdx.x * LG_PX;
  const int np = min(LG_PX, a.P - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The tensor copies zero-fill the pixels past P. Rows C .. CP - 1 of the
  // channel block, which no copy writes, are made zeros once: a padded
  // weight's zero times stale shared memory could be NaN.
  if (a.C < CP) {
    for (int s = 0; s < depth; ++s) {
      uint4* xv = reinterpret_cast<uint4*>(ring + s * STAGE + WBYTES + a.C * ROW);
      for (int i = threadIdx.x; i < (CP - a.C) * ROW / 16; i += LG_THREADS) {
        xv[i] = make_uint4(0, 0, 0, 0);
      }
    }
    fence_proxy_async();  // before the tensor copies into the same stages
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(&full[s], 32);             // the producer's lanes
      mbar_init(&empty[s], LG_CONSUMERS);  // one arrival per consumer warp
    }
  }
  __syncthreads();

  if (warp == LG_CONSUMERS) {
    // The producer: layer l into stage l % depth once every consumer warp
    // has read the layer before it there. Where C is a multiple of 16, lane
    // 0 copies w[l] by one tensor copy per 64-column box; else the lanes
    // stage it element by element into the same swizzled boxes, each
    // repeat's channels padded to CP. On even l lane 0 copies the block's
    // 64 pixels of every channel of m[l] by one tensor copy. Lane 0 sets
    // the bytes to expect before its copies; each lane arrives once its
    // copies are issued or its stores made (the arrival releases the
    // stores to the consumers).
    const bool bulk_w = a.C == CP;
    const int K = 9 * a.C;
#pragma unroll 1
    for (int l = 0; l < a.L; ++l) {
      const int s = l % depth;
      if (l >= depth) mbar_wait(&empty[s], ((l / depth) - 1) & 1);
      const bool even = (l & 1) == 0;
      unsigned char* ws = ring + s * STAGE;
      if (lane == 0) {
        mbar_expect_tx_only(&full[s], (bulk_w ? WBYTES : 0) + (even ? a.C * ROW : 0));
        if (bulk_w) {
          for (int j = 0; j < lg_boxes(MF); ++j) {
            tensor_copy_3d(ws + j * CP * ROW, &a.wmap, j * LG_BOX, 0, l, &full[s]);
          }
        }
        if (even) tensor_copy_3d(ws + WBYTES, &a.xmap, p0, 0, l, &full[s]);
      }
      if (!bulk_w) {
        const __nv_bfloat16* wl = a.w + static_cast<size_t>(l) * a.C * K;
        for (int e = lane; e < CP * KP; e += 32) {
          const int r = e / KP, k = e - r * KP;
          const int rep = k / CP, c = k - rep * CP;
          const int at = (k / LG_BOX) * CP * ROW + r * ROW +
                         ((((k % LG_BOX) / 8) ^ (r & 7)) << 4) + (k % 8) * 2;
          *reinterpret_cast<__nv_bfloat16*>(ws + at) =
              (r < a.C && c < a.C) ? wl[r * K + rep * a.C + c] : __ushort_as_bfloat16(0);
        }
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // The consumers: warp (quarter, kg) owns the block's pixels 16 quarter ..
  // 16 quarter + 15 and, of each layer's 9 MF k16 steps, those of parity
  // (kg + l) & 1, so the two K groups share every layer's steps evenly over
  // the layers. Each waits on its layer's barrier alone.
  const int quarter = warp & 3, kg = warp >> 2;
  const int n0 = quarter * 16;
  const int g = lane >> 2, q = lane & 3;
  // ldmatrix rows: A rows (lane & 15), k half (lane >> 4); B (x4.trans)
  // channels (lane & 7) + 8 ((lane >> 3) & 1), pixels n0 + 8 (lane >> 4).
  // Every row a lane reads has (row & 7) == (lane & 7): its swizzle.
  const int sw = lane & 7;
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t a_off = (lane & 15) * ROW;
  const uint32_t b_off = WBYTES + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                         (((n0 / 8 + (lane >> 4)) ^ sw) << 4);

  float acc[MF][2][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;

#pragma unroll 1
  for (int l = 0; l < a.L; ++l) {
    const int s = l % depth;
    mbar_wait(&full[s], (l / depth) & 1);
    const uint32_t stage = ring_u32 + s * STAGE;
    const uint32_t a_at = stage + a_off, b_at = stage + b_off;
    if ((l & 1) == 0) {  // steps of parity kg: even l has x, odd l the zero block
      if (kg == 0) {
        lg_steps<MF, true, 0>(acc, a_at, lane >> 4, b_at, sw);
      } else {
        lg_steps<MF, true, 1>(acc, a_at, lane >> 4, b_at, sw);
      }
    } else if (kg == 0) {  // steps of parity 1 - kg
      lg_steps<MF, false, 1>(acc, a_at, lane >> 4, b_at, sw);
    } else {
      lg_steps<MF, false, 0>(acc, a_at, lane >> 4, b_at, sw);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // The two K groups' sums: group 1's through shared memory (stage 0, read
  // by now: every copy issued has been waited for), added to group 0's in
  // that order, each output element written once.
  bar_sync(1, LG_CONSUMERS * 32);  // the consumer warps
  float* part = reinterpret_cast<float*>(ring) + quarter * (MF * 8 * 32) + lane;
  if (kg == 1) {
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[((mf * 2 + nf) * 4 + e) * 32] = acc[mf][nf][e];
  }
  bar_sync(1, LG_CONSUMERS * 32);  // the consumer warps
  if (kg == 1) return;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
      const int n = n0 + nf * 8 + 2 * q;
      if (n >= np) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = mf * 16 + g + 8 * h;
        if (row >= a.C) continue;
        const float* pp = part + ((mf * 2 + nf) * 4 + 2 * h) * 32;
        *reinterpret_cast<float2*>(a.out + static_cast<size_t>(row) * a.P + p0 + n) =
            make_float2(acc[mf][nf][2 * h] + pp[0], acc[mf][nf][2 * h + 1] + pp[32]);
      }
    }
}

// A bf16 map over [d2][d1][d0] (row strides s1, s2 bytes) whose box is
// [rows][64], 128-byte swizzled, zero-filled outside the tensor.
bool encode_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
               uint64_t s1, uint64_t s2, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {LG_BOX, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MF>
int launch_layer_grid(LayerGridArgs& a, cudaStream_t stream) {
  LgParams prm;
  memset(&prm, 0, sizeof(prm));
  prm.w = a.w;
  prm.out = a.out;
  prm.L = a.L;
  prm.C = a.C;
  prm.P = (a.E - 2) * a.W;
  prm.depth = lg_depth(MF, a.L);
  const uint64_t K = 9 * static_cast<uint64_t>(a.C), plane = static_cast<uint64_t>(a.Em) * a.W;
  if ((a.C == MF * 16 && !encode_3d(&prm.wmap, a.w, K, a.C, a.L, K * 2, a.C * K * 2, a.C)) ||
      !encode_3d(&prm.xmap, a.m, prm.P, a.C, a.L, plane * 2, a.C * plane * 2, a.C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.depth = prm.depth;
  a.smem = LG_HEADER + a.depth * lg_stage_bytes(MF);
  auto kernel = layer_grid_kernel<MF>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (prm.P + LG_PX - 1) / LG_PX;
  kernel<<<grid, LG_THREADS, a.smem, stream>>>(prm);
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
