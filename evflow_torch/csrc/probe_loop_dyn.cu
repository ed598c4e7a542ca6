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
// of every channel (32 for k2, k3, k11 and k12) and keeps its own [L, C,
// TP] slab of the scratch in shared memory (32 KB in f32 at L=4; 96 CTAs
// at E W = 6144). The layer
// count L is a kernel argument and every layer loop carries `#pragma unroll
// 1`, so the scratch index l (or s(l)) stays a runtime offset into shared
// memory, as fori_loop's is into VMEM. Each thread owns 8 consecutive
// pixels of one channel (256 threads = 32 channels x 8 groups); its
// running sums are 8 registers with compile-time indices, never an array
// indexed by l.
//   Load-sum: the slab is filled from x with 16-byte loads (the `scr[:] =
// x[:]` copy, every layer), then after a barrier each layer's row is read
// at the runtime index and added in f32.
//   Store: a store CTA owns ST_TP = 32 pixels of every channel (192 CTAs
// at E W = 6144, at least one on every SM) and its [L, C, 32] slab; each
// thread 4 pixels of one channel (a warp 4 channel rows, 128 bytes each).
// The loads of up to 8 layers are issued together, one 16-byte load per
// layer, before the first store (a loop that loads and stores one layer at
// a time sends its L DRAM round trips out in series); then each layer's 2 x[l],
// rounded to the scratch type (bf16: round first, then x2 in bf16, as k11
// does; the doubling is exact), is stored at the runtime index. As soon as
// scr[0] is final (after the first batch and a barrier) it is read back by
// another warp (channel c + 4) and written out widened to f32, 128 bytes per
// 8 lanes. Only scr[0] shows in the output, so where `scratch` is given the
// whole slab is written out as well, on a branch that the timed launches
// skip.
//   Bulk store: a CTA of 128 threads owns one contiguous, 16-byte aligned
// tile of the flattened output layer [C, rows W], the same in every layer,
// one 16-byte piece a thread. The launch cuts the layer for at least 132
// CTAs, an H100 SXM's SMs: tile = the layer / 132 in whole pieces, 256 to
// 512 elements (132 CTAs of 500 at k8's 65,536; 384 of 512 at k4's
// 196,608, where tiles of 1492 or 1024 elements, two pieces a thread,
// measured slower; a fixed 2048 gave 96 and 32 CTAs). Each thread issues
// the loads of its piece of up to 8 layers (each channel's rows row0 ..
// row0 + rows) before any store; each layer's scale x[l] then goes into
// its own stage of a ring of up to 8, the writes are fenced to the async
// proxy and the CTA meets once; one thread issues one TMA bulk store a
// layer to out + l C rows W + t0 (cp.async.bulk.global.shared::cta, one
// bulk group each), at the runtime l: the TPU's start() per layer. A stage
// is waited for (until its store has read it, bulk_wait_read) only when the
// ring comes round to it again, 8 layers on; the stores are waited for once,
// at exit. The output [L, 1, C, TH, W] of k8 is a view of [L, C, TH, W].
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
// bf16 -> f32 (conv_lif_common.cuh's mma_bf16_16816) on CTAs of DB_TP = 32
// pixels (192 at E W = 6144; 64 pixels gave 96). A producer lane sets up
// the barriers and issues, for every layer before the CTA first meets,
// four TMA tensor copies onto that layer's stage and mbarrier: w[l]'s three
// [C][C] blocks and x[l]'s [C][32] slab, each a 2 KB box of 64-byte rows
// with the 64-byte swizzle (pixels past E W zero-filled), a ring of up to 8
// stages with full and empty barriers beyond 8 layers. Tensor copies, not
// one cp.async per 16 bytes (the producer warp's lanes issuing them
// measured slower) or one bulk copy per row: four copies a layer keep the
// TMA engine's cost per copy small, and the swizzle keeps every ldmatrix
// free of bank conflicts. Eight mma warps: 2 m16 fragments of output channels x 4 K
// groups (channel block cb of the slab, layers of one parity), each over
// all 32 pixels (four n8 fragments), so each weight element is read from
// shared memory by one warp a layer instead of four: per own layer two
// ldmatrix.x4.trans of the block's B fragments, then per weight block one
// ldmatrix.x4 of A and four mma (K index 32 b + c reads channel c: the
// concat is not built). Each warp waits on its layers' barriers alone, no
// CTA barrier in the loop. The four groups' sums meet once in shared memory
// in a fixed order and each output element is written once, 16 bytes a
// thread along pixels. What sets k12's time beyond its launch is the weight
// copies: every CTA reads all of w (24 KB at L=4) from L2, all of them the
// same lines at the same moment. Without them (a timing-only variant) it
// ran markedly faster, yet copying w[0] alone was no faster than all of w:
// the contention for those lines costs, not their bytes. Sharing the copies
// within a cluster (TMA multicast) needs a cluster barrier before the first
// copy, which measured slower than the copies it saves; 132 CTAs of up to
// 64 pixels measured no faster.
//   Narrow sum: p [L, C, 3] has a 12-byte row, so no tensor map (global
// strides are multiples of 16 bytes) and no vector load of a row can take
// it. Each CTA stages the whole block (12 L C bytes, a multiple of 16) with
// one bulk copy on an mbarrier, then each thread adds column 1 of its
// channel's row at the runtime l and writes the sum over its 8 pixels.
//   Conv: exact f32 (FFMA on the CUDA cores, as k2). A CTA owns one image
// row e, CONV_TW = 32 columns and one half of the output channels (384 CTAs
// at E=24, W=256, three resident on each SM: 2.9 a SM, where 96 CTAs of 64
// columns and all channels left 36 SMs idle). Its 128 threads are 8 K
// groups of 4 input channels; each thread holds a 4 x 8 register tile,
// output channels j + 4 i of the half by 8 consecutive pixels, so per
// (input channel, dy) the 10 x values it loads once (four 16-byte loads)
// serve all three dx taps, and per (dy, dx) four 16-byte weight loads (4
// channels x 4 input channels) feed 128 FFMA: 28 shared loads per 384
// FFMA, against 3 per 8 before. Weight rows are padded to
// 296 words, so the 8 rows a warp reads at once lie on 8 bank quads, and a
// K group's x rows start 4 words after the last group's, so the two groups
// of a warp read 8 quads too. Each layer is one cp.async group into a ring
// of two stages: w[l]'s 16 rows of the half as they lie and x[l]'s rows
// e-1..e+1, columns w0-4..w0+35, 16-byte copies with zeros outside the
// image (where W is not a multiple of 4 the rows start off 16-byte
// boundaries: the columns w0-1..w0+32 in 4-byte copies); layers 0 and 1
// are issued before the first dot, layer l + 2 as soon as layer l's stage
// is read, so a layer's copies fly during the last one's dots and no
// register holds them. The eight K
// groups' sums meet once in shared memory, added in a fixed order, and
// each output element is written once, 16 bytes a thread where the row
// allows. What bounds it: its FFMA issue (1.18 M a CTA at L=4) and the
// weight reads, every CTA all of its half from L2 (147 KB a pair of CTAs).
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
// The design reads each input byte once from device memory and writes each
// output byte once (k3 and k11 also read x[1..L-1], k5 also x[3], as the
// TPU bodies do: what k3 and k11 read and write, every layer of x and out,
// is 3.93 MB -> 1.17 us; k7 reads its halo rows again from L2 and every
// CTA its half of w, every k12 CTA w from L2: 4.7 MB), on 96 CTAs (k2, k3,
// k11 and k12 on 192, k4 and k7 on 384, k8 on 132), one pass with every
// layer's loads or copies in flight in k2, k3, k11, k12 and the bulk store
// (k7: two layers): at a few MB per launch the time is set
// by the launch and the latency of one pass, not the bytes; k7's and k2's
// time by their FFMA and shared-memory load issue (k2 issues the 151 MFLOP
// of its three weight blocks, 2.25 us at 67 TFLOP/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_loop_dyn.so probe_loop_dyn.cu
#include <cstring>

#include "conv_lif_common.cuh"
#include "tma.cuh"

namespace evflow {
namespace loopdyn {

constexpr int C = 32;          // channels: the probes' C, the only width the kernels take
constexpr int TP = 64;         // pixels of every channel per CTA
constexpr int PPT = 8;         // consecutive pixels per thread
constexpr int GROUPS = TP / PPT;
constexpr int THREADS = C * GROUPS;  // 256
constexpr int K = 3 * C;       // the dot's depth: concat(h, h, h)
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one CTA
constexpr int CONV_TW = 32;    // output columns of one row per conv CTA
constexpr int CONV_CO = C / 2;  // output channels per conv CTA: one half of C
constexpr int CONV_KG = 8;     // the conv's K groups: 4 input channels each
constexpr int CONV_THREADS = CONV_KG * 16;  // 16 threads a K group: 4 x 8 outputs each
constexpr int CONV_WP = 9 * C + 8;  // a staged weight row: 296 words, rows 8 banks apart
constexpr int CONV_XW = 40;    // a staged x row: columns w0-4 .. w0+35, ten 16-byte chunks
// x rows of a stage: [C][3][CONV_XW], K group kg's 12 rows 4 words on (bank stagger)
constexpr int CONV_XWORDS = C * 3 * CONV_XW + CONV_KG * 4;
constexpr int CONV_PP = CONV_TW + 4;  // a partial-sum row of the conv
constexpr int CONV_STAGE = (CONV_CO * CONV_WP + CONV_XWORDS) * 4;  // 34,432 bytes
constexpr int CONV_SMEM = 2 * CONV_STAGE;  // a ring of two layer stages
static_assert(CONV_KG * CONV_CO * CONV_PP * 4 <= CONV_SMEM, "the partial sums fit the ring");
constexpr int DOT_TP = 32;     // pixels of every channel per k2 CTA
constexpr int DOT_WP = K + 4;  // k2's weight row: 100 words, 8 rows on 8 bank quads
constexpr int DOT_PP = DOT_TP + 4;  // k2's partial-sum row
constexpr int DOT_SPLIT = 4;   // k2's input-channel quarters
constexpr int DOT_BARS = 128;  // bytes for k2's layer barriers (L <= 16)
constexpr int ST_TP = 32;      // pixels of every channel per store CTA (k3, k11)
constexpr int ST_PPT = 4;      // consecutive pixels per store thread: one 16-byte load a layer
constexpr int ST_GROUPS = ST_TP / ST_PPT;
constexpr int ST_BATCH = 8;    // layers whose loads a store thread has in flight together
static_assert(C * ST_GROUPS == THREADS, "a store thread per 4 pixels of a channel");
constexpr int BULK_CTAS = 132;  // CTAs a bulk-store layer is cut for at least: an H100 SXM's SMs
constexpr int BULK_THREADS = 128;  // a bulk-store CTA: one 16-byte piece of its tile a thread
constexpr int BULK_MIN = 256;   // elements of a bulk-store tile at least (1 KB a store)
constexpr int BULK_MAX = BULK_THREADS * 4;  // and at most (2 KB)
constexpr int BULK_RING = 8;    // stages: one a layer, the loads of as many in flight
constexpr int DB_TP = 32;       // pixels of every channel per k12 CTA
constexpr int DB_CONSUMERS = 8;  // k12's mma warps: 2 m16 fragments x 4 K groups
constexpr int DB_THREADS = (DB_CONSUMERS + 1) * 32;  // and one producer warp
constexpr int DB_RING = 8;      // k12's layer stages at most
constexpr int DB_BOX = C * DB_TP * 2;  // bytes of a [32][32] bf16 box: 64-byte rows
constexpr int DB_STAGE = 4 * DB_BOX;   // w[l]'s three [C][C] blocks and x[l]'s slab
constexpr int DB_HEADER = 128 + 1024;  // the full and empty barriers, the ring's alignment
constexpr int DB_PP = DB_TP + 8;       // a partial-sum row: 40 words, rows 8 banks apart
constexpr int DB_PARTS = 4 * C * DB_PP * 4;  // the four K groups' partial sums

// The bulk store's tile over a flattened output layer of `layer` elements
// (mirrored by loop_dyn.store_bulk_tile): the layer cut for BULK_CTAS CTAs,
// in whole 16-byte pieces, within [BULK_MIN, BULK_MAX].
inline int bulk_tile(int layer) {
  const int t = ((layer + BULK_CTAS - 1) / BULK_CTAS + 3) / 4 * 4;
  return t < BULK_MIN ? BULK_MIN : (t > BULK_MAX ? BULK_MAX : t);
}

inline int ring_depth(int L, int ring) { return L < ring ? L : ring; }

// k12's dynamic shared memory (mirrored by loop_dyn.load_dot_smem): the
// barriers and the slack that aligns the ring to 1024 bytes, up to 8 layer
// stages, the K groups' partial sums.
inline int dot_bf16_smem(int L) { return DB_HEADER + ring_depth(L, DB_RING) * DB_STAGE + DB_PARTS; }

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

// 2 v rounded to the scratch type, 4 pixels: f32 directly (16 bytes); bf16
// rounded first, then doubled in bf16 (8 bytes).
__device__ __forceinline__ void store_doubled4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = make_float4(__fmul_rn(v.x, 2.f), __fmul_rn(v.y, 2.f),
                                              __fmul_rn(v.z, 2.f), __fmul_rn(v.w, 2.f));
}

__device__ __forceinline__ void store_doubled4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat16 two = __float2bfloat16_rn(2.f);
  uint2 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
  h[0] = __hmul(__float2bfloat16_rn(v.x), two);
  h[1] = __hmul(__float2bfloat16_rn(v.y), two);
  h[2] = __hmul(__float2bfloat16_rn(v.z), two);
  h[3] = __hmul(__float2bfloat16_rn(v.w), two);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) store_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out,
                                                        T* __restrict__ scratch, int L, int P) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* scr = reinterpret_cast<T*>(smem_raw);  // [L][C][ST_TP]
  const int p0 = blockIdx.x * ST_TP, n = min(ST_TP, P - p0);
  // the thread's 4 pixels of one channel: a warp covers 4 channel rows
  const int c = threadIdx.x / ST_GROUPS, px = (threadIdx.x % ST_GROUPS) * ST_PPT;
  const bool in = px < n;
  const float* src = x + static_cast<size_t>(c) * P + p0 + px;
  const size_t layer = static_cast<size_t>(C) * P;
  // read back by another warp: channel rc = c + 4, written by the next warp
  const int rc = (c + 4) % C;
#pragma unroll 1
  for (int l0 = 0; l0 < L; l0 += ST_BATCH) {
    // the loads of up to ST_BATCH layers in flight together, then their stores
    float4 v[ST_BATCH];
#pragma unroll
    for (int j = 0; j < ST_BATCH; ++j) {
      v[j] = in && l0 + j < L ? *reinterpret_cast<const float4*>(src + (l0 + j) * layer)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < ST_BATCH; ++j) {  // scr[l0 + j]: the runtime layer index
      if (l0 + j < L) store_doubled4(scr + ((l0 + j) * C + c) * ST_TP + px, v[j]);
    }
    if (l0 == 0) {  // scr[0] is final: out from it now
      __syncthreads();
      if (in) {
        const float4 r = load4(scr + rc * ST_TP + px);
        *reinterpret_cast<float4*>(out + static_cast<size_t>(rc) * P + p0 + px) = r;
      }
    }
  }
  if (scratch == nullptr) return;
  __syncthreads();  // every layer's stores, which other warps read back
  if (!in) return;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    copy4(scratch + (static_cast<size_t>(l) * C + rc) * P + p0 + px,
          scr + (l * C + rc) * ST_TP + px);
  }
}

// out[l][c][j] = scale x[l][c][off + j] for j < run, through a ring of
// stages: in_chan and run are a channel's elements in x and in out, off the
// window's first element (k4: in_chan = run = P, off = 0); the CTA owns
// elements t0 .. t0 + tile of each flattened output layer [C, run], one
// 16-byte piece a thread.
__global__ void __launch_bounds__(BULK_THREADS) store_bulk_kernel(const float* __restrict__ x,
                                                                  float* __restrict__ out, int L,
                                                                  int in_chan, int run, int off,
                                                                  int tile, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [min(L, BULK_RING)][tile]
  const int layer = C * run;
  const int t0 = blockIdx.x * tile, n = min(tile, layer - t0);  // n a multiple of 4
  const int i = threadIdx.x * 4;  // the thread's piece of the tile
  const bool in = i < n;
  // its source within x[l], the same in every layer (run a multiple of 4: no
  // piece spans two channels)
  const int c = (t0 + i) / run;
  const float* src = x + c * in_chan + off + (t0 + i - c * run);  // x[l0]
  const size_t in_layer = static_cast<size_t>(C) * in_chan;
  float* dst = out + t0;  // out[l] at thread 0's next store
#pragma unroll 1
  for (int l0 = 0; l0 < L; l0 += BULK_RING, src += BULK_RING * in_layer) {
    const int nl = min(BULK_RING, L - l0);
    // the loads of up to BULK_RING layers in flight together
    float4 v[BULK_RING];
#pragma unroll
    for (int k = 0; k < BULK_RING; ++k) {
      v[k] = in && k < nl ? *reinterpret_cast<const float4*>(src + k * in_layer)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (l0 > 0) {  // the ring comes round again: the last batch's stores have read their stages
      if (threadIdx.x == 0) bulk_wait_read<0>();
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < BULK_RING; ++k) {
      if (!in || k >= nl) continue;
      float4 u = v[k];
      u.x = __fmul_rn(u.x, scale);
      u.y = __fmul_rn(u.y, scale);
      u.z = __fmul_rn(u.z, scale);
      u.w = __fmul_rn(u.w, scale);
      *reinterpret_cast<float4*>(ring + k * tile + i) = u;
    }
    fence_proxy_async();  // this thread's stage writes, before the bulk stores read them
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < nl; ++k, dst += layer) {
        bulk_store(dst, ring + k * tile, n * 4);  // out[l0 + k]: the runtime layer index
        bulk_commit();
      }
    }
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

// 4 bytes from global to shared memory, zeros where src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's latest cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(CONV_THREADS, 3) conv_sum_kernel(const float* __restrict__ x,
                                                                   const float* __restrict__ w,
                                                                   float* __restrict__ out, int L,
                                                                   int E, int W) {
  constexpr int STAGE = CONV_STAGE / 4;  // words of a ring stage
  constexpr int XV = CONV_XW / 4;        // 16-byte chunks of a staged x row
  constexpr int XC = CONV_TW + 2;        // the columns a row needs: the tile and its halo
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);  // [2] stages: w rows [CONV_CO][CONV_WP],
                                                   // then x rows (CONV_XWORDS)
  const int tiles = (W + CONV_TW - 1) / CONV_TW;
  const int half = blockIdx.x & 1, t = blockIdx.x >> 1;  // output channels 16 half .. + 15
  const int e = t / tiles, w0 = (t - e * tiles) * CONV_TW;
  const int P = E * W;
  // Layer l into stage s, one cp.async group: the CTA's 16 rows of w[l] as
  // they lie (16 bytes a copy), and x[l]'s rows e-1..e+1, columns
  // w0-4..w0+35 at window index 0..39, zeros outside the image: 16 bytes a
  // copy where W is a multiple of 4 (the chunks start on 16-byte
  // boundaries), else the columns w0-1..w0+32 the tile needs, 4 bytes a copy.
  auto issue = [&](int l, int s) {
    float* ws = sm + s * STAGE;
    float* xs = ws + CONV_CO * CONV_WP;
    const float* wl = w + (static_cast<size_t>(l) * C + half * CONV_CO) * (9 * C);
    for (int i = threadIdx.x; i < CONV_CO * (9 * C / 4); i += CONV_THREADS) {
      const int r = i / (9 * C / 4), v = i - r * (9 * C / 4);
      cp_async16(ws + r * CONV_WP + v * 4, wl + r * (9 * C) + v * 4, 16);
    }
    const float* xl = x + static_cast<size_t>(l) * C * P;
    if ((W & 3) == 0) {
      for (int i = threadIdx.x; i < C * 3 * XV; i += CONV_THREADS) {
        const int r = i / XV, v = i - r * XV;  // r = ci 3 + dy
        const int ci = r / 3, row = e - 1 + (r - ci * 3), wc = w0 - 4 + 4 * v;
        const bool in = row >= 0 && row < E && wc >= 0 && wc < W;
        cp_async16(xs + r * CONV_XW + (r / 12) * 4 + 4 * v, in ? xl + ci * P + row * W + wc : xl,
                   in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < C * 3 * XC; i += CONV_THREADS) {
        const int r = i / XC, col = i - r * XC;
        const int ci = r / 3, row = e - 1 + (r - ci * 3), wc = w0 - 1 + col;
        const bool in = row >= 0 && row < E && wc >= 0 && wc < W;
        cp_async4(xs + r * CONV_XW + (r / 12) * 4 + 3 + col, in ? xl + ci * P + row * W + wc : xl,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  issue(0, 0);
  if (L > 1) {
    issue(1, 1);
  } else {
    cp_async_commit();  // an empty group: every layer waits for all but the newest
  }
  // thread: K group kg (input channels 4 kg .. 4 kg + 3), output channels
  // j + 4 i (i < 4) of the half, pixels 8 pg .. 8 pg + 7
  const int kg = threadIdx.x >> 4, j = threadIdx.x & 3, pg = (threadIdx.x >> 2) & 3;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[i][p] = 0.f;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    cp_async_wait<1>();  // this thread's copies of layer l have landed
    __syncthreads();     // and every thread's
    const float* ws = sm + (l & 1) * STAGE + j * CONV_WP + kg * 4;  // stage of l: runtime index
    const float* xs =
        sm + (l & 1) * STAGE + CONV_CO * CONV_WP + kg * (12 * CONV_XW + 4) + 8 * pg;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float v[4][10];  // x[4 kg + c][e + dy - 1][w0 + 8 pg - 1 ..  + 8]: window 8 pg + 3 ..
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* xr = xs + (c * 3 + dy) * CONV_XW;
        const float4 a = *reinterpret_cast<const float4*>(xr);
        const float4 b = *reinterpret_cast<const float4*>(xr + 4);
        const float4 d = *reinterpret_cast<const float4*>(xr + 8);
        const float4 f = *reinterpret_cast<const float4*>(xr + 12);
        v[c][0] = a.w;
        v[c][1] = b.x, v[c][2] = b.y, v[c][3] = b.z, v[c][4] = b.w;
        v[c][5] = d.x, v[c][6] = d.y, v[c][7] = d.z, v[c][8] = d.w;
        v[c][9] = f.x;
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float4 wv[4];  // w[l][16 half + j + 4 i][(3 dy + dx) C + 4 kg .. + 3]
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = *reinterpret_cast<const float4*>(ws + 4 * i * CONV_WP + (dy * 3 + dx) * C);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wt = c == 0 ? wv[i].x : c == 1 ? wv[i].y : c == 2 ? wv[i].z : wv[i].w;
#pragma unroll
            for (int p = 0; p < 8; ++p) acc[i][p] = fmaf(wt, v[c][p + dx], acc[i][p]);
          }
        }
      }
    }
    __syncthreads();  // layer l's stage is read
    if (l + 2 < L) {
      issue(l + 2, l & 1);
    } else {
      cp_async_commit();
    }
  }
  // The eight K groups' sums -> part[kg][16 output channels][CONV_PP], then
  // each output element once, kg 0 + 1 + ... + 7 in order.
  float* part = sm;  // every copy has landed and every stage is read
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* pr = part + (kg * CONV_CO + j + 4 * i) * CONV_PP + 8 * pg;
    *reinterpret_cast<float4*>(pr) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(pr + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  const int co = threadIdx.x >> 3, px = (threadIdx.x & 7) * 4;
  float4 s = *reinterpret_cast<const float4*>(part + co * CONV_PP + px);
#pragma unroll
  for (int k = 1; k < CONV_KG; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(part + (k * CONV_CO + co) * CONV_PP + px);
    s.x = __fadd_rn(s.x, u.x);
    s.y = __fadd_rn(s.y, u.y);
    s.z = __fadd_rn(s.z, u.z);
    s.w = __fadd_rn(s.w, u.w);
  }
  float* o = out + static_cast<size_t>(half * CONV_CO + co) * P + e * W + w0 + px;
  if ((W & 3) == 0 && w0 + px + 4 <= W) {
    *reinterpret_cast<float4*>(o) = s;
  } else {
    const float vals[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (w0 + px + p < W) o[p] = vals[p];
  }
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

// What k12 reads: tensor maps of x and w, each with [32][32] boxes
// (64-byte rows, 64-byte swizzle), and the output and sizes.
struct DotParams {
  CUtensorMap xmap;  // x as [L][C][P], box [C][32 pixels]
  CUtensorMap wmap;  // w as [L][C][3C], box [C][32 columns]: one of the three blocks
  float* out;
  int L, P, depth;
};

// The byte offset of 16-byte chunk `chunk` of row `row` in a [32][32] bf16
// box that a tensor copy wrote with the 64-byte swizzle: chunk ^ ((row >> 1)
// & 3), so the 8 rows an ldmatrix phase reads lie on 8 bank quads.
__device__ __forceinline__ uint32_t box_at(int row, int chunk) {
  return row * (DB_TP * 2) + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__global__ void __launch_bounds__(DB_THREADS) load_dot_bf16_kernel(
    const __grid_constant__ DotParams a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [DB_RING]: a stage has landed
  uint64_t* empty = full + DB_RING;                    // [DB_RING]: a stage is read
  const uint32_t base = smem_u32(smem);
  unsigned char* ring = smem + (((base + 128 + 1023) & ~1023u) - base);  // 1024-byte aligned
  float* part = reinterpret_cast<float*>(ring + a.depth * DB_STAGE);     // [4][C][DB_PP]
  const int depth = a.depth;
  const int p0 = blockIdx.x * DB_TP, n = min(DB_TP, a.P - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The producer (lane 0 of the last warp): layer l into stage l % depth,
  // w[l]'s three blocks and x[l]'s slab (pixels past P zero-filled), four
  // tensor copies on the stage's barrier. It sets up the barriers and
  // issues the first `depth` layers before the CTA first meets, the rest
  // once the warps that read the stage's last layer are done.
  const bool producer = warp == DB_CONSUMERS && lane == 0;
  auto issue = [&](int l, int s) {
    unsigned char* st = ring + s * DB_STAGE;
    mbar_expect_tx(&full[s], DB_STAGE);
    for (int b = 0; b < 3; ++b) tensor_copy_3d(st + b * DB_BOX, &a.wmap, b * C, 0, l, &full[s]);
    tensor_copy_3d(st + 3 * DB_BOX, &a.xmap, p0, 0, l, &full[s]);
  };
  if (producer) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, and the stage's bytes
      mbar_init(&empty[s], 4);  // the four warps that read a layer
    }
    for (int l = 0; l < depth; ++l) issue(l, l);
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  if (warp == DB_CONSUMERS) {
    if (producer) {
#pragma unroll 1
      for (int l = depth; l < a.L; ++l) {
        const int s = l % depth;
        mbar_wait(&empty[s], ((l / depth) - 1) & 1);
        issue(l, s);
      }
    }
    return;
  }

  // The consumers: warp (mf, kg) owns output channels 16 mf .. 16 mf + 15 of
  // all 32 pixels (four n8 fragments) and, of every layer of parity kg >> 1,
  // the K columns of channel block cb = kg & 1 in each of the three weight
  // blocks: K index 32 b + c reads channel c (the concat is not built), so
  // the block's B fragments, loaded once, serve all three.
  const int mf = warp & 1, kg = warp >> 1, cb = kg & 1;
  const int g = lane >> 2, q = lane & 3;
  // ldmatrix rows: A (x4) weight row 16 mf + (lane & 15), k half lane >> 4
  // of the block's 16 columns; B (x4.trans) channel 16 cb + (lane & 7) + 8
  // ((lane >> 3) & 1), pixel chunk lane >> 4 (+ 2 for pixels 16 .. 31)
  const uint32_t a_off = box_at(16 * mf + (lane & 15), 2 * cb + (lane >> 4));
  const int brow = 16 * cb + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t b_off0 = 3 * DB_BOX + box_at(brow, lane >> 4);
  const uint32_t b_off1 = 3 * DB_BOX + box_at(brow, 2 + (lane >> 4));
  const uint32_t ring_u32 = smem_u32(ring);
  float acc[4][4];  // [n8 fragment][mma accumulator]
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nf][e] = 0.f;
#pragma unroll 1
  for (int l = kg >> 1; l < a.L; l += 2) {
    const int s = l % depth;
    mbar_wait(&full[s], (l / depth) & 1);  // x[l] and w[l] have landed
    const uint32_t st = ring_u32 + s * DB_STAGE;  // stage of l: the runtime layer index
    uint32_t b[2][4];
    ldsm_x4_t(b[0], st + b_off0);  // pixels 0 .. 15: n8 fragments 0 and 1
    ldsm_x4_t(b[1], st + b_off1);  // pixels 16 .. 31: fragments 2 and 3
#pragma unroll
    for (int wb = 0; wb < 3; ++wb) {  // the three weight blocks, each against the same slab
      uint32_t af[4];
      ldsm_x4(af, st + wb * DB_BOX + a_off);
      mma_bf16_16816(acc[0], af, b[0][0], b[0][1]);
      mma_bf16_16816(acc[1], af, b[0][2], b[0][3]);
      mma_bf16_16816(acc[2], af, b[1][0], b[1][1]);
      mma_bf16_16816(acc[3], af, b[1][2], b[1][3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // The four K groups' sums -> part[kg], then each output element once,
  // ((kg 0 + kg 1) + kg 2) + kg 3, 16 bytes a thread along the pixels.
  float* pk = part + (kg * C + 16 * mf + g) * DB_PP + 2 * q;
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) {
    *reinterpret_cast<float2*>(pk + nf * 8) = make_float2(acc[nf][0], acc[nf][1]);
    *reinterpret_cast<float2*>(pk + 8 * DB_PP + nf * 8) = make_float2(acc[nf][2], acc[nf][3]);
  }
  bar_sync(1, DB_CONSUMERS * 32);  // the consumer warps
  const int co = threadIdx.x >> 3, p4 = (threadIdx.x & 7) * 4;
  if (p4 >= n) return;
  float4 v = *reinterpret_cast<const float4*>(part + co * DB_PP + p4);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(part + (k * C + co) * DB_PP + p4);
    v.x = __fadd_rn(v.x, u.x);
    v.y = __fadd_rn(v.y, u.y);
    v.z = __fadd_rn(v.z, u.z);
    v.w = __fadd_rn(v.w, u.w);
  }
  *reinterpret_cast<float4*>(a.out + static_cast<size_t>(co) * a.P + p0 + p4) = v;
}

template <typename Kernel, typename... Args>
int run(LoopDynArgs& a, Kernel kernel, int grid, int threads, int smem, cudaStream_t stream,
        Args... args) {
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  a.grid = grid;
  a.threads = threads;
  a.smem = smem;
  return static_cast<int>(cudaGetLastError());
}

// A bf16 map over [d2][d1][d0] (packed rows of d0 elements) whose box is
// [C][32], 64-byte swizzled, zero-filled outside the tensor.
bool encode_box32(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d1 * d0 * 2};
  const cuuint32_t box[3] = {DB_TP, C, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_dot_bf16(LoopDynArgs& a, cudaStream_t s) {
  DotParams prm;
  memset(&prm, 0, sizeof(prm));
  if (!encode_box32(&prm.xmap, a.x, a.P, C, a.L) || !encode_box32(&prm.wmap, a.w, K, C, a.L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.out = static_cast<float*>(a.out);
  prm.L = a.L;
  prm.P = a.P;
  prm.depth = ring_depth(a.L, DB_RING);
  return run(a, load_dot_bf16_kernel, (a.P + DB_TP - 1) / DB_TP, DB_THREADS, dot_bf16_smem(a.L),
             s, prm);
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
        return run(a, k, tiles, THREADS, slab, s, static_cast<const bf*>(a.x), out, a.L, a.P);
      } else {
        auto k = a.slot ? load_sum_kernel<float, Slot> : load_sum_kernel<float, Identity>;
        return run(a, k, tiles, THREADS, slab, s, static_cast<const float*>(a.x), out, a.L, a.P);
      }
    case STORE: {
      const int grid = (a.P + ST_TP - 1) / ST_TP, smem = a.L * C * ST_TP * (a.bf16 ? 2 : 4);
      if (a.bf16) {
        return run(a, store_kernel<bf>, grid, THREADS, smem, s, static_cast<const float*>(a.x),
                   out, static_cast<bf*>(a.scratch), a.L, a.P);
      }
      return run(a, store_kernel<float>, grid, THREADS, smem, s, static_cast<const float*>(a.x),
                 out, static_cast<float*>(a.scratch), a.L, a.P);
    }
    case STORE_BULK: {
      const int layer = C * a.rows * a.W, tile = bulk_tile(layer);
      return run(a, store_bulk_kernel, (layer + tile - 1) / tile, BULK_THREADS,
                 ring_depth(a.L, BULK_RING) * tile * 4, s, static_cast<const float*>(a.x), out,
                 a.L, a.P, a.rows * a.W, a.row0 * a.W, tile, a.scale);
    }
    case NARROW_SUM:
      return run(a, narrow_sum_kernel, tiles, THREADS, 16 + a.L * C * 3 * 4, s,
                 static_cast<const float*>(a.x), out, a.L, a.P);
    case CONV:
      return run(a, conv_sum_kernel, (a.P / a.W) * ((a.W + CONV_TW - 1) / CONV_TW) * 2,
                 CONV_THREADS, CONV_SMEM, s, static_cast<const float*>(a.x),
                 static_cast<const float*>(a.w), out, a.L, a.P / a.W, a.W);
    default:  // LOAD_DOT
      if (a.bf16) return launch_dot_bf16(a, s);
      return run(a, load_dot_f32_kernel, (a.P + DOT_TP - 1) / DOT_TP, THREADS, dot_f32_smem(a.L),
                 s, static_cast<const float*>(a.x), static_cast<const float*>(a.w), out, a.L, a.P);
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
