// The runtime-indexed loop probes: a layer loop with a runtime trip count
// that reads and writes a shared-memory scratch at the runtime layer index,
// for sm_90a. Seven kernels, some templated on the scratch type and index map.
//
// Replaces the TPU kernels of benchmarks/probe_loop_dyn.py (K8f, the
// pallas_call in `run`, :21; x [L, C, E, W] f32, w [L, C, 3C] f32, a VMEM
// scratch [L, C, E, W]), benchmarks/probe_loop_dyn2.py (K8g, :31, :60, :75,
// :91) and benchmarks/probe_loop_dyn3.py (K8h, the K8f bodies with bf16
// scratch or operands, :29, :43, :61):
//   load_sum_kernel<float, Identity>   k1  (:40): scr = x; out = sum_l scr[l]
//   load_sum_kernel<float, Slot>       k5  (:84): out = sum_l scr[s(l)],
//                                      s(l) = l==1 ? 0 : l==2 ? 1 : 2
//   load_sum_kernel<bf16, Identity>    k10 (dyn3 :22): k1 with bf16 scratch,
//                                      each element widened before the add
//   store_kernel<float>                k3  (:64): scr[l] = 2 x[l]; out = scr[0]
//   store_kernel<bf16>                 k11 (dyn3 :37): scr[l] = bf16(x[l]) * 2
//                                      in bf16; out = f32(scr[0])
//   store_bulk_kernel                  k4  (:73): out[l] = 3 x[l] through a
//                                      stage and a copy to the runtime index;
//                                      it also stands for k9
//                                      (probe_loop_dyn2.py:83, the same
//                                      function with the fixed `.at[l]`), and
//                                      with a source row window it is
//                                      k8 (dyn2 :69): out[l, 0] = 2 x[l][:,
//                                      8 : 8 + TH], out [L, 1, C, TH, W]
//   load_dot_f32_kernel                k2  (:50): out = sum_l w[l] @
//                                      concat(scr[l], scr[l], scr[l]), f32
//   load_dot_bf16_kernel               k12 (dyn3 :51): k2 on bf16 x and w,
//                                      f32 accumulation
//   narrow_sum_kernel                  k6  (dyn2 :24): out[c, :, :] = sum_l
//                                      p[l][c][1], p [L, C, 3] f32
//   conv_sum_kernel                    k7  (dyn2 :39): out = sum_l of the 3x3
//                                      SAME conv of x[l] (zero rows and
//                                      columns outside the image) with w[l]
//                                      [C, 9C], w[l][co, (dy 3 + dx) C + ci]
// with the pixels p = (e, w) of a layer flattened: x [L, C, P], P = E W.
//
// Design. The TPU keeps the whole [L, C, E, W] scratch (3.1 MB in f32) in
// VMEM under grid=(1,); a CTA has 227 KB. So each CTA owns TP = 64 pixels
// of every channel and keeps its own [L, C, TP] slab of the scratch in
// shared memory (32 KB in f32 at L=4; 96 CTAs at E W = 6144). The layer
// count L is a kernel argument and every layer loop carries `#pragma unroll
// 1`, so the scratch index l (or s(l)) stays a runtime offset into shared
// memory, as fori_loop's is into VMEM. Each thread owns 8 consecutive
// pixels of one channel (256 threads = 32 channels x 8 groups); its
// running sums are 8 registers with compile-time indices, never an array
// indexed by l.
//   Load-sum: the slab is filled from x with 16-byte loads (the `scr[:] =
// x[:]` copy, every layer), then after a barrier each layer's row is read
// at the runtime index and added in f32.
//   Store: each layer's 2 x[l] is rounded to the scratch type (bf16: round
// first, then x2 in bf16, as k11 does; the doubling is exact) and written
// at the runtime index; after a barrier scr[0] is read back by other threads
// (channels across lanes) and written out widened to f32. Only scr[0] shows
// in the output, so where `scratch` is given the whole slab is written out
// as well, on a branch that the timed launches skip.
//   Bulk store: a CTA owns one contiguous, 16-byte aligned run of TILE
// elements of the flattened output layer [C, rows W]. For each l its
// threads write scale x[l] (from each channel's rows row0 .. row0 + rows)
// into a shared stage, fence the writes to the async proxy and meet at a
// barrier; one thread then issues one TMA bulk store of the run to out + l
// C rows W + offset (cp.async.bulk.global.shared::cta), commits it and
// waits until the stage has been read before the next layer overwrites it:
// the TPU's start()/wait() per layer. At k8's TH W = TILE each run is one
// channel's window: one bulk store per (l, c). The output [L, 1, C, TH, W]
// of k8 is a view of [L, C, TH, W].
//   Dot: the concat is not built, K index k reads channel k mod C of the
// slab. f32 products must stay exact (TF32 would round the operands), so k2
// runs on the CUDA cores. A k2 CTA owns DOT_TP = 32 pixels (192 CTAs at E W
// = 6144, at least one on every SM; 64 pixels gave 96 and left 36 SMs
// idle). Before its layer loop it issues 16-byte cp.async copies of every
// layer's slab rows and w[l] rows ([C, 3C] as they lie, padded to 3C + 4
// words), in layer order, each layer's copies arriving on that layer's
// mbarrier: layer l waits on its barrier alone (one wait a layer, no CTA
// barrier) while the later layers' copies are still in flight. Each thread
// holds a 4 x 4 register tile, output channels g + 8j (j < 4) by 4
// consecutive pixels, over a quarter of the input channels (the 8 warps are
// 4 channel quarters x 2 pixel halves): per 4 input channels one 16-byte
// load of w[co][4 k] for each of its 4 channels (8 rows 100 words apart: 8
// bank quads) and one of x[c][4 pixels] for each of the 4 channels
// (broadcast across the channel lanes) feed 64 FFMA, against 8 before. The
// four quarters' partial sums are added in shared memory in a fixed order
// and each output element is written once, 16 bytes a thread along pixels.
// Every output keeps all L 3C products: pre-summing the three weight
// blocks would round the weights before the product and would no longer do
// the work of the stacked-matmul yardstick. k12 runs mma.sync m16n8k16
// bf16 -> f32 (conv_lif_common.cuh's mma_bf16_16816): output channels on
// M (two m16 fragments, A = w[l] from shared memory, rows padded by 8), the
// warp's 8 pixels on N, 3C / 16 = 6 k16 steps, B packed from the slab's
// channel rows (channel block 16 ks mod C).
//   Narrow sum: p [L, C, 3] has a 12-byte row, so no tensor map (global
// strides are multiples of 16 bytes) and no vector load of a row can take
// it. Each CTA stages the whole block (12 L C bytes, a multiple of 16) with
// one bulk copy on an mbarrier, then each thread adds column 1 of its
// channel's row at the runtime l and writes the sum over its 8 pixels.
//   Conv: a CTA owns one image row e and TW = 64 columns of all 32 output
// channels (96 CTAs at E=24, W=256). Per layer, at the runtime l, it stages
// w[l] transposed to [9C][C] (lanes on output channels, 16-byte loads along
// K, so the stores hit 32 banks) and x[l]'s rows e-1..e+1 and columns
// w0-1..w0+TW, zeros outside the image (scalar loads: the halo starts one
// column off any 16-byte boundary). The loads of layer l + 1 are issued
// into registers before layer l's dots, so they wait in flight and not in
// line (each thread's offsets, the same in every layer, are computed once).
// Warp j owns output channels 4j..4j+3,
// lane i columns i and i+32: per K index one broadcast 16-byte load of the
// four weights, two conflict-free loads of x and 8 FFMA into registers
// that carry the sum over layers. Exact f32, as in k2.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32, 989 bf16) at the
// probes' shapes (L=4, C=32, E=24, W=256, TH=8), for what each function
// needs (probes/loop_dyn.py::loop_dyn_bytes): every body but k7 is bound by
// bytes.
//   k1 3.93 MB -> 1.17 us, k5 3.15 MB (x[3] is never read) -> 0.94 us,
//   k10 2.36 MB -> 0.70 us, k3 and k11 1.57 MB (x[0] and out) -> 0.47 us,
//   k4 6.29 MB -> 1.88 us, k2 3.98 MB -> 1.19 us (50.3 MFLOP f32, the three
//   weight blocks folded: 0.75 us), k12 2.38 MB -> 0.71 us, k6 0.79 MB ->
//   0.24 us, k8 2.10 MB (the windows and out) -> 0.63 us, k7 453.0 MFLOP
//   f32 -> 6.76 us (4.08 MB: 1.22 us).
// The design reads each input byte once and writes each output byte once
// (k3 and k11 also read x[1..L-1], k5 also x[3], as the TPU bodies do; k7
// reads its halo rows again from L2), on 96 CTAs (k8 on 32, k2 on 192), one
// pass and no pipelining but k2's: at a few MB per launch the time is set by
// the launch and the latency of one synchronous pass, not the bytes; k7's
// and k2's time by their FFMA and shared-memory load issue (k2 issues the
// 151 MFLOP of its three weight blocks, 2.25 us at 67 TFLOP/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_loop_dyn.so probe_loop_dyn.cu
#include "conv_lif_common.cuh"
#include "tma.cuh"

namespace evflow {
namespace loopdyn {

constexpr int C = 32;          // channels: the probes' C, the only width the kernels take
constexpr int TP = 64;         // pixels of every channel per CTA
constexpr int PPT = 8;         // consecutive pixels per thread
constexpr int GROUPS = TP / PPT;
constexpr int THREADS = C * GROUPS;  // 256
constexpr int TILE = C * TP;   // elements of the flattened layer per bulk-store CTA
constexpr int K = 3 * C;       // the dot's depth: concat(h, h, h)
constexpr int WPITCH_BF16 = K + 8;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int CONV_TW = 64;    // output columns of one row per conv CTA
constexpr int CONV_XP = CONV_TW + 2;  // staged columns: the tile and its halo
constexpr int CONV_SMEM = (9 * C * C + C * 3 * CONV_XP) * 4;
constexpr int DOT_TP = 32;     // pixels of every channel per k2 CTA
constexpr int DOT_WP = K + 4;  // k2's weight row: 100 words, 8 rows on 8 bank quads
constexpr int DOT_PP = DOT_TP + 4;  // k2's partial-sum row
constexpr int DOT_SPLIT = 4;   // k2's input-channel quarters
constexpr int DOT_BARS = 128;  // bytes for k2's layer barriers (L <= 16)

// k2's dynamic shared memory (mirrored by loop_dyn.load_dot_smem): the
// layer barriers, then every layer's slab and weight rows, or the four
// quarters' partial sums where larger.
inline int dot_f32_smem(int L) {
  const int layers = L * C * (DOT_TP + DOT_WP) * 4;
  const int partials = DOT_SPLIT * C * DOT_PP * 4;
  return DOT_BARS + (layers > partials ? layers : partials);
}

enum Op { LOAD_SUM = 0, STORE = 1, STORE_BULK = 2, LOAD_DOT = 3, NARROW_SUM = 4, CONV = 5 };

// Mirrored by ctypes in evflow_torch/probes/loop_dyn.py.
struct LoopDynArgs {
  const void* x;  // [L, C, P]: f32; bf16 where `bf16` is set (load-sum, dot);
                  // p [L, C, 3] f32 (narrow sum)
  const void* w;  // [L, C, 3C] of x's type (dot), [L, C, 9C] f32 (conv), else null
  void* out;      // [C, P] f32, or [L, C, rows W] f32 (bulk store)
  void* scratch;  // [L, C, P] of the scratch type (store), or null
  int op;         // Op
  int bf16;       // load-sum, dot: x (and w) bf16; store: bf16 scratch
  int slot;       // load-sum: read slot s(l), not l
  int L, C, P;
  int W;          // the row width, P = E W
  int row0, rows; // bulk store: the source rows row0 .. row0 + rows of each channel
  float scale;    // bulk store: the factor
  int grid, threads, smem;  // set by the launch
};

struct Identity {
  __device__ __forceinline__ static int at(int l) { return l; }
};
struct Slot {
  __device__ __forceinline__ static int at(int l) { return l == 1 ? 0 : (l == 2 ? 1 : 2); }
};

__device__ __forceinline__ void load8(const float* p, float (&v)[PPT]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[PPT]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < PPT; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[PPT]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// 2 v rounded to the scratch type: f32 directly; bf16 rounded first, then
// doubled in bf16.
__device__ __forceinline__ void store_doubled(float* p, const float (&v)[PPT]) {
  float d[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) d[i] = __fmul_rn(v[i], 2.f);
  store8(p, d);
}

__device__ __forceinline__ void store_doubled(__nv_bfloat16* p, const float (&v)[PPT]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
  const __nv_bfloat16 two = __float2bfloat16_rn(2.f);
#pragma unroll
  for (int i = 0; i < PPT; ++i) h[i] = __hmul(__float2bfloat16_rn(v[i]), two);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void copy8(float* dst, const float* src) {
  float v[PPT];
  load8(src, v);
  store8(dst, v);
}

__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// x[l, c, p0 : p0 + n] of every layer and channel into scr[l][c][0 : n], 16
// bytes at a time, zeros past n (n and p0 are multiples of 8).
template <typename T>
__device__ void fill_slab(const T* __restrict__ x, T* scr, int L, int P, int p0, int n) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = TP / V;  // 16-byte pieces per slab row
  for (int i = threadIdx.x; i < L * C * VPR; i += THREADS) {
    const int row = i / VPR, v = i - row * VPR;  // row = l C + c
    uint4 val = make_uint4(0, 0, 0, 0);
    if (v * V < n) val = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * P + p0 + v * V);
    *reinterpret_cast<uint4*>(scr + row * TP + v * V) = val;
  }
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(THREADS) load_sum_kernel(const T* __restrict__ x,
                                                           float* __restrict__ out, int L,
                                                           int P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* scr = reinterpret_cast<T*>(smem_raw);  // [L][C][TP]
  const int p0 = blockIdx.x * TP, n = min(TP, P - p0);
  fill_slab(x, scr, L, P, p0, n);
  __syncthreads();
  const int c = threadIdx.x / GROUPS, px = (threadIdx.x % GROUPS) * PPT;
  float acc[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    float v[PPT];
    load8(scr + (Idx::at(l) * C + c) * TP + px, v);  // the runtime layer (or slot) index
#pragma unroll
    for (int i = 0; i < PPT; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
  }
  if (px < n) store8(out + static_cast<size_t>(c) * P + p0 + px, acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) store_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out,
                                                        T* __restrict__ scratch, int L, int P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* scr = reinterpret_cast<T*>(smem_raw);  // [L][C][TP]
  const int p0 = blockIdx.x * TP, n = min(TP, P - p0);
  const int c = threadIdx.x / GROUPS, px = (threadIdx.x % GROUPS) * PPT;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    float v[PPT];
    if (px < n) {
      load8(x + (static_cast<size_t>(l) * C + c) * P + p0 + px, v);
    } else {
#pragma unroll
      for (int i = 0; i < PPT; ++i) v[i] = 0.f;
    }
    store_doubled(scr + (l * C + c) * TP + px, v);  // the runtime layer index
  }
  __syncthreads();
  // read back by other threads: channels across lanes
  const int rc = threadIdx.x % C, rpx = (threadIdx.x / C) * PPT;
  if (rpx >= n) return;
  float v[PPT];
  load8(scr + rc * TP + rpx, v);
  store8(out + static_cast<size_t>(rc) * P + p0 + rpx, v);
  if (scratch != nullptr) {
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      copy8(scratch + (static_cast<size_t>(l) * C + rc) * P + p0 + rpx, scr + (l * C + rc) * TP + rpx);
    }
  }
}

// out[l][c][j] = scale x[l][c][off + j] for j < run, through the stage:
// in_chan and run are a channel's elements in x and in out, off the window's
// first element (k4: in_chan = run = P, off = 0).
__global__ void __launch_bounds__(THREADS) store_bulk_kernel(const float* __restrict__ x,
                                                             float* __restrict__ out, int L,
                                                             int in_chan, int run, int off,
                                                             float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);  // [TILE]
  constexpr int PIECES = TILE / (THREADS * 4);  // 16-byte pieces of the run a thread
  const int layer = C * run;
  const int t0 = blockIdx.x * TILE, n = min(TILE, layer - t0);  // n a multiple of 4
  // each piece's source within x[l], the same in every layer (run a
  // multiple of 4: no piece spans two channels)
  int from[PIECES];
#pragma unroll
  for (int j = 0; j < PIECES; ++j) {
    const int o = t0 + (threadIdx.x + j * THREADS) * 4, c = o / run;
    from[j] = c * in_chan + off + (o - c * run);
  }
  // x[l] and out[l] by pointer steps: a 64-bit l * layer product here
  // cost a 4-byte spill
  const float* src = x;
  float* dst = out + t0;
#pragma unroll 1
  for (int l = 0; l < L; ++l, src += C * in_chan, dst += layer) {
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      const int i = (threadIdx.x + j * THREADS) * 4;
      if (i >= n) break;
      float4 v = *reinterpret_cast<const float4*>(src + from[j]);
      v.x = __fmul_rn(v.x, scale);
      v.y = __fmul_rn(v.y, scale);
      v.z = __fmul_rn(v.z, scale);
      v.w = __fmul_rn(v.w, scale);
      *reinterpret_cast<float4*>(stage + i) = v;
    }
    fence_proxy_async();  // this thread's stage writes, before the bulk store reads them
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(dst, stage, n * 4);  // out[l]: the runtime layer index
      bulk_commit();
      bulk_wait_read();  // the stage may be written again
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) bulk_wait();
}

__global__ void __launch_bounds__(THREADS) narrow_sum_kernel(const float* __restrict__ p,
                                                             float* __restrict__ out, int L,
                                                             int P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* psm = reinterpret_cast<float*>(smem_raw + 16);  // [L][C][3]
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_expect_tx(bar, L * C * 3 * 4);
    bulk_copy(psm, p, L * C * 3 * 4, bar);  // the whole narrow block, 12-byte rows
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  mbar_wait(bar, 0);
  const int c = threadIdx.x / GROUPS, px = (threadIdx.x % GROUPS) * PPT;
  float s = 0.f;
#pragma unroll 1
  for (int l = 0; l < L; ++l) s = __fadd_rn(s, psm[(l * C + c) * 3 + 1]);  // p[l][c][1], runtime l
  const int p0 = blockIdx.x * TP, n = min(TP, P - p0);
  if (px >= n) return;
  float v[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) v[i] = s;
  store8(out + static_cast<size_t>(c) * P + p0 + px, v);
}

__global__ void __launch_bounds__(THREADS) conv_sum_kernel(const float* __restrict__ x,
                                                           const float* __restrict__ w,
                                                           float* __restrict__ out, int L, int E,
                                                           int W) {
  constexpr int WQ = 9 * C * C / 4 / THREADS;                     // 16-byte weight loads a thread
  constexpr int XN = (C * 3 * CONV_XP + THREADS - 1) / THREADS;  // x loads a thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [9C][C]: w[l] with K major
  float* xs = ws + 9 * C * C;                      // [C][3][CONV_XP]: rows e-1..e+1
  const int tiles = (W + CONV_TW - 1) / CONV_TW;
  const int e = blockIdx.x / tiles, w0 = (blockIdx.x - e * tiles) * CONV_TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = E * W;
  // the tile's elements this thread stages, the same in every layer: their
  // offsets in x[l], -1 outside the image (a zero)
  int xoff[XN];
#pragma unroll
  for (int j = 0; j < XN; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CONV_XP, col = i - r * CONV_XP;  // r = ci 3 + dy
    const int ci = r / 3, row = e - 1 + (r - ci * 3), wc = w0 - 1 + col;
    xoff[j] = (i < C * 3 * CONV_XP && row >= 0 && row < E && wc >= 0 && wc < W)
                  ? ci * P + row * W + wc
                  : -1;
  }
  // w[l] and x[l] in registers: a layer's loads fly during the last one's
  // dots. Weights with lanes on output channels, 16-byte loads along K.
  float4 wv[WQ];
  float xv[XN];
  auto load = [&](const float* xl, const float4* wl) {
#pragma unroll
    for (int j = 0; j < WQ; ++j) wv[j] = wl[lane * (9 * C / 4) + warp + j * (THREADS / 32)];
#pragma unroll
    for (int j = 0; j < XN; ++j) xv[j] = xoff[j] >= 0 ? xl[xoff[j]] : 0.f;
  };
  float acc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0.f;
  const float* xl = x;
  const float4* wl = reinterpret_cast<const float4*>(w);
  load(xl, wl);
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    __syncthreads();  // the last layer's tiles are read
#pragma unroll
    for (int j = 0; j < WQ; ++j) {
      float* d = ws + 4 * (warp + j * (THREADS / 32)) * C + lane;  // K index 4 kq, channel lane
      d[0] = wv[j].x;
      d[C] = wv[j].y;
      d[2 * C] = wv[j].z;
      d[3 * C] = wv[j].w;
    }
#pragma unroll
    for (int j = 0; j < XN; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < C * 3 * CONV_XP) xs[i] = xv[j];
    }
    __syncthreads();
    if (l + 1 < L) {  // x[l + 1], w[l + 1]: the runtime layer index
      xl += C * P;
      wl += 9 * C * C / 4;
      load(xl, wl);
    }
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* xr = xs + (ci * 3 + dy) * CONV_XP + lane;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wk =
              reinterpret_cast<const float4*>(ws + ((dy * 3 + dx) * C + ci) * C)[warp];
          const float a = xr[dx], b = xr[dx + 32];
          acc[0][0] = fmaf(wk.x, a, acc[0][0]);
          acc[0][1] = fmaf(wk.x, b, acc[0][1]);
          acc[1][0] = fmaf(wk.y, a, acc[1][0]);
          acc[1][1] = fmaf(wk.y, b, acc[1][1]);
          acc[2][0] = fmaf(wk.z, a, acc[2][0]);
          acc[2][1] = fmaf(wk.z, b, acc[2][1]);
          acc[3][0] = fmaf(wk.w, a, acc[3][0]);
          acc[3][1] = fmaf(wk.w, b, acc[3][1]);
        }
      }
    }
  }
  float* o = out + static_cast<size_t>(warp * 4) * P + e * W + w0 + lane;
#pragma unroll
  for (int j = 0; j < 4; ++j, o += P) {
    if (w0 + lane < W) o[0] = acc[j][0];
    if (w0 + lane + 32 < W) o[32] = acc[j][1];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The barrier's arrival once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__global__ void __launch_bounds__(THREADS) load_dot_f32_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ w,
                                                               float* __restrict__ out, int L,
                                                               int P) {
  constexpr int XV = DOT_TP / 4, WV = K / 4;  // 16-byte pieces of a slab row, a weight row
  constexpr int CQ = C / DOT_SPLIT;           // input channels of a quarter
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);          // [L]
  float* scr = reinterpret_cast<float*>(smem_raw + DOT_BARS);      // [L][C][DOT_TP]
  float* wsm = scr + L * C * DOT_TP;                               // [L][C][DOT_WP]
  const int p0 = blockIdx.x * DOT_TP, n = min(DOT_TP, P - p0);
  if (threadIdx.x == 0) {
    for (int l = 0; l < L; ++l) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&bars[l])),
                   "r"(THREADS)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised before anyone arrives
  // every layer's copies, in layer order: x[l]'s slab rows (zeros past n)
  // and w[l]'s rows, then this thread's arrival on layer l's barrier
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    for (int i = threadIdx.x; i < C * XV; i += THREADS) {
      const int c = i / XV, v = i - c * XV;
      const bool in = v * 4 < n;
      cp_async16(scr + (l * C + c) * DOT_TP + v * 4,
                 x + (static_cast<size_t>(l) * C + c) * P + p0 + (in ? v * 4 : 0), in ? 16 : 0);
    }
    for (int i = threadIdx.x; i < C * WV; i += THREADS) {
      const int co = i / WV, v = i - co * WV;
      cp_async16(wsm + (l * C + co) * DOT_WP + v * 4,
                 w + (static_cast<size_t>(l) * C + co) * K + v * 4, 16);
    }
    cp_async_arrive(&bars[l]);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quarter = warp >> 1, g = lane & 7;
  const int px = (warp & 1) * (DOT_TP / 2) + (lane >> 3) * 4;  // the thread's 4 pixels
  float acc[4][4];  // [channel g + 8 j][pixel px + i]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    mbar_wait(&bars[l], 0);  // x[l] and w[l] have landed
    const float* h = scr + (l * C + quarter * CQ) * DOT_TP + px;  // scr[l]: the runtime index
    const float* wl = wsm + (l * C + g) * DOT_WP + quarter * CQ;   // w[l]: the runtime index
#pragma unroll
    for (int b = 0; b < 3; ++b) {  // the three concatenated copies of scr[l]
#pragma unroll
      for (int c4 = 0; c4 < CQ; c4 += 4) {
        float4 wk[4], xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wk[j] = *reinterpret_cast<const float4*>(wl + 8 * j * DOT_WP + b * C + c4);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          xv[t] = *reinterpret_cast<const float4*>(h + (c4 + t) * DOT_TP);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float wt = t == 0 ? wk[j].x : t == 1 ? wk[j].y : t == 2 ? wk[j].z : wk[j].w;
            acc[j][0] = fmaf(wt, xv[t].x, acc[j][0]);
            acc[j][1] = fmaf(wt, xv[t].y, acc[j][1]);
            acc[j][2] = fmaf(wt, xv[t].z, acc[j][2]);
            acc[j][3] = fmaf(wt, xv[t].w, acc[j][3]);
          }
        }
      }
    }
  }
  // the quarters' partial sums -> shared memory [quarter][C][DOT_PP], then
  // each output element once: ((q0 + q1) + q2) + q3
  __syncthreads();  // every layer is read (every copy landed before its barrier)
  float* part = reinterpret_cast<float*>(smem_raw + DOT_BARS);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(part + (quarter * C + g + 8 * j) * DOT_PP + px) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const int co = threadIdx.x / (DOT_TP / 4), p4 = (threadIdx.x % (DOT_TP / 4)) * 4;
  if (p4 >= n) return;
  float4 v = *reinterpret_cast<const float4*>(part + co * DOT_PP + p4);
#pragma unroll
  for (int qi = 1; qi < DOT_SPLIT; ++qi) {
    const float4 u = *reinterpret_cast<const float4*>(part + (qi * C + co) * DOT_PP + p4);
    v.x = __fadd_rn(v.x, u.x);
    v.y = __fadd_rn(v.y, u.y);
    v.z = __fadd_rn(v.z, u.z);
    v.w = __fadd_rn(v.w, u.w);
  }
  *reinterpret_cast<float4*>(out + static_cast<size_t>(co) * P + p0 + p4) = v;
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__global__ void __launch_bounds__(THREADS) load_dot_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    float* __restrict__ out, int L, int P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* scr = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [L][C][TP]
  __nv_bfloat16* wsm = scr + L * C * TP;                             // [C][WPITCH_BF16]
  const int p0 = blockIdx.x * TP, n = min(TP, P - p0);
  fill_slab(x, scr, L, P, p0, n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = warp * 8;  // the warp's 8 pixels: N of one n8 fragment
  float d[2][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[mf][i] = 0.f;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    __syncthreads();  // the slab is filled; the last layer's weights are read
    const uint4* wl = reinterpret_cast<const uint4*>(w + static_cast<size_t>(l) * C * K);
    for (int i = threadIdx.x; i < C * K / 8; i += THREADS) {  // w[l]: the runtime layer index
      const int r = i / (K / 8), v = i - r * (K / 8);
      *reinterpret_cast<uint4*>(wsm + r * WPITCH_BF16 + v * 8) = wl[i];
    }
    __syncthreads();
    const __nv_bfloat16* h = scr + l * C * TP;  // scr[l]: the runtime layer index
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      const int k0 = ks * 16, c0 = k0 % C;  // concat: K index k is channel k mod C
      const __nv_bfloat16* pb = h + (c0 + 2 * q) * TP + n0 + g;
      const uint32_t b0 = pack2(pb[0], pb[TP]), b1 = pack2(pb[8 * TP], pb[9 * TP]);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const __nv_bfloat16* pa = wsm + (mf * 16 + g) * WPITCH_BF16 + k0 + 2 * q;
        const uint32_t a[4] = {lds32(pa), lds32(pa + 8 * WPITCH_BF16), lds32(pa + 8),
                               lds32(pa + 8 * WPITCH_BF16 + 8)};
        mma_bf16_16816(d[mf], a, b0, b1);
      }
    }
  }
  if (n0 >= n) return;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    float* o = out + static_cast<size_t>(mf * 16 + g) * P + p0 + n0 + 2 * q;
    *reinterpret_cast<float2*>(o) = make_float2(d[mf][0], d[mf][1]);
    *reinterpret_cast<float2*>(o + 8 * static_cast<size_t>(P)) = make_float2(d[mf][2], d[mf][3]);
  }
}

template <typename Kernel, typename... Args>
int run(LoopDynArgs& a, Kernel kernel, int grid, int smem, cudaStream_t stream, Args... args) {
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  a.grid = grid;
  a.threads = THREADS;
  a.smem = smem;
  return static_cast<int>(cudaGetLastError());
}

int launch(LoopDynArgs& a, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const int tiles = (a.P + TP - 1) / TP;
  const int slab = a.L * C * TP * (a.bf16 ? 2 : 4);
  float* out = static_cast<float*>(a.out);
  switch (a.op) {
    case LOAD_SUM:
      if (a.bf16) {
        auto k = a.slot ? load_sum_kernel<bf, Slot> : load_sum_kernel<bf, Identity>;
        return run(a, k, tiles, slab, s, static_cast<const bf*>(a.x), out, a.L, a.P);
      } else {
        auto k = a.slot ? load_sum_kernel<float, Slot> : load_sum_kernel<float, Identity>;
        return run(a, k, tiles, slab, s, static_cast<const float*>(a.x), out, a.L, a.P);
      }
    case STORE:
      if (a.bf16) {
        return run(a, store_kernel<bf>, tiles, slab, s, static_cast<const float*>(a.x), out,
                   static_cast<bf*>(a.scratch), a.L, a.P);
      }
      return run(a, store_kernel<float>, tiles, slab, s, static_cast<const float*>(a.x), out,
                 static_cast<float*>(a.scratch), a.L, a.P);
    case STORE_BULK:
      return run(a, store_bulk_kernel, (C * a.rows * a.W + TILE - 1) / TILE, TILE * 4, s,
                 static_cast<const float*>(a.x), out, a.L, a.P, a.rows * a.W, a.row0 * a.W,
                 a.scale);
    case NARROW_SUM:
      return run(a, narrow_sum_kernel, tiles, 16 + a.L * C * 3 * 4, s,
                 static_cast<const float*>(a.x), out, a.L, a.P);
    case CONV:
      return run(a, conv_sum_kernel, (a.P / a.W) * ((a.W + CONV_TW - 1) / CONV_TW), CONV_SMEM, s,
                 static_cast<const float*>(a.x), static_cast<const float*>(a.w), out, a.L,
                 a.P / a.W, a.W);
    default:  // LOAD_DOT
      if (a.bf16) {
        return run(a, load_dot_bf16_kernel, tiles, slab + C * WPITCH_BF16 * 2, s,
                   static_cast<const bf*>(a.x), static_cast<const bf*>(a.w), out, a.L, a.P);
      }
      return run(a, load_dot_f32_kernel, (a.P + DOT_TP - 1) / DOT_TP, dot_f32_smem(a.L), s,
                 static_cast<const float*>(a.x), static_cast<const float*>(a.w), out, a.L, a.P);
  }
}

bool args_valid(const LoopDynArgs& a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w) |
                         reinterpret_cast<uintptr_t>(a.out) |
                         reinterpret_cast<uintptr_t>(a.scratch);
  const bool dot = a.op == LOAD_DOT || a.op == CONV;
  const bool window = a.W >= 1 && a.P % a.W == 0 && a.row0 >= 0 && a.rows >= 1 &&
                      a.row0 + a.rows <= a.P / a.W && (a.rows * a.W) % 4 == 0 &&
                      (a.row0 * a.W) % 4 == 0;
  return a.x != nullptr && a.out != nullptr && ptrs % 16 == 0 && a.op >= LOAD_SUM &&
         a.op <= CONV && a.C == C && a.L >= 1 && a.P >= 8 && (a.op == CONV || a.P % 8 == 0) &&
         (!a.slot || (a.op == LOAD_SUM && a.L >= 3)) && dot == (a.w != nullptr) &&
         (a.op == STORE || a.scratch == nullptr) &&
         (a.op == LOAD_SUM || a.op == STORE || a.op == LOAD_DOT || !a.bf16) &&
         (a.op != STORE_BULK || window) && (a.op != CONV || (a.W >= 1 && a.P % a.W == 0)) &&
         (a.op != LOAD_DOT || a.bf16 || a.L * 8 <= DOT_BARS);
}

}  // namespace loopdyn
}  // namespace evflow

// The one entry point: the kernel `op` names. It returns the launch's
// cudaError_t (0 on success) and refuses what the kernels do not take: C
// other than 32, pointers not 16-byte aligned, E W not a multiple of 8 (but
// for the conv), the slot map with fewer than 3 layers, a bulk store's row
// window outside the image or off a 16-byte boundary, a slab beyond a CTA's
// shared memory.
extern "C" int probe_loop_dyn(evflow::loopdyn::LoopDynArgs* a, void* stream) {
  using namespace evflow::loopdyn;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(*a, static_cast<cudaStream_t>(stream));
}
