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
// Design. One TPU program holds a whole-width window; a CTA holds 227 KB,
// so each CTA owns a tile of TH = 16 output rows and computes each layer on
// the cone its outputs need, the halo shrinking by one pixel a layer, its
// neighbours' halo recomputed (the TPU probe computes every layer on all of
// its window's rows).
//   stack_kernel<NL> (kA: NL = 1, kB: NL = 7): 8 owned columns, so that the
//     grid covers the SMs (W/8 x H/16 x B: 128 CTAs at the probes' shapes;
//     kB's seven cones hold 2268 pixels for 128 owned, 1.84x the cone of the
//     function's own pixels). The conv is wgmma m64n32k16: a layer's cone in
//     quads of 64 pixels, quad u on warpgroup u mod the warpgroups, A (a
//     warp's 16 pixels) from registers by ldmatrix, B (the weights, landed
//     by 5 TMA tensor copies as 128-byte swizzled blocks of 64 K values)
//     from shared memory; a layer's 18 k16 steps straight-line, in a few
//     rounds that each load their steps' A fragments, then issue their
//     wgmmas back to back. (On mma.sync
//     every warp loaded every weight fragment a layer: the split put kB's
//     mma at 63% of its time, held by the shared memory's loads.)
//   chain_kernel<...> (nine variants): 16 x 16 owned pixels (W/16 x H/16 x
//     B: 128 CTAs). Unit 1 runs on 18 x 18 pixels and keeps bf16(spk1) in
//     shared memory (zero outside columns [0, W), unit 2's padding), unit 2
//     on the owned 16 x 16; the conv is mma.sync m16n8k16, the cone's pixels
//     flattened onto m16 fragments, fragment f on warp f mod 16 (a quarter
//     on each of the SM's sub-partitions), A and B fragments by ldmatrix, a
//     warp's 18 k16 steps straight-line (pixel_conv.cuh's fold). The pred
//     head sums a pixel's 32 channels in registers and over the quad's
//     lanes. The CTAs of the first and last row tile write the zero border
//     rows of o0 and o1; one launch a call.
// Staging. x's box (rows of 16-byte pieces from a piece's worth left of
// the tile) is copied by the compute threads' cp.async (a TMA tensor copy
// of such a narrow box took 6 cycles a row, 3.4-6 us a CTA), zero-filled
// outside columns [0, W) (the padding), into channel planes 16 bytes past
// a multiple of 128 apart, so that its transposition to pixel-major
// (ldmatrix.trans, stmatrix) meets no bank conflict; it completes on an
// mbarrier that counts every copying thread's cp.async arrival. The
// weights land by bulk copies of their rows (kB's as 5 TMA tensor copies of
// 128-byte swizzled blocks, for wgmma). The chain has a 17th warp that
// issues its copies: w0 (and p0) at the start beside x, then, once x has
// landed (x has the memory to itself), m0's and m1's boxes by TMA tensor
// copies, w1 (p1, pw) by bulk copies, all landing during unit 1; it also
// writes the zero border rows.
// Outputs. kA's and kB's out, o1 and the flow go to a tile in shared
// memory, planes padded alike, and out by 16-byte stores of every thread,
// the columns below W; the border rows are 16-byte stores of zeros. o0 is
// ready while unit 2 has yet to run, so the copy warp stores its dense tile
// by one TMA tensor store while the compute warps go on: 0.2-0.4 us
// faster a call than the compute warps' 16-byte stores in 7 of the 9
// chain cases, beyond the spread of paired runs (NVIDIA H100 80GB HBM3,
// 700 W). Every LIF rounding is explicit (no fused multiply-add), as in
// the plain version.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the files' shapes
// (C = 32, H = 64, W = 256, TH = 16; B = 1 for K8k, 2 for the chain), for
// what each function needs (probes/wholenet_bisect.py::bisect_bytes):
//   kA 3.20 MB -> 0.95 us (0.30 GFLOP); kB 4.08 MB, 1.22 us, against 2.91
//   GFLOP of its layers' cones -> 2.94 us; the chain 13.1-17.0 MB (x, m0,
//   m1 over the rows the outputs reach, o0 and o1 with their borders, the
//   flow) -> 3.9-5.1 us against 1.23 GFLOP.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (back to back): kA 6.0 us
// (was 12.0), kB 23.2 us (was 48.9), the chain 14.0-16.4 us (was
// 28.1-33.8). What holds them (probes/wholenet_bisect.py --split): kB's
// seven layers of wgmma (each about 1.2-3.5 us, a few tensor-core round
// trips on 2268 pixels' ldmatrix loads), and its x staging; the chain's x
// staging (its first 3.3 us: every CTA loads 41 KB of x and 18 KB of w0
// at once), its two convs (about 3 and 2 us), the LIF epilogues (1.1-2.3
// us each, bound by instruction issue), the stores, and the launch.
//
// A variant build -DBI_CUT=BI_CUT_<part> takes one part out (keeps(part) is
// false), for the split of probes/wholenet_bisect.py --split. Such a build
// computes wrong results.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_wholenet_bisect.so probe_wholenet_bisect.cu
#include <cstring>
#include <utility>

#include "fused_net_common.cuh"
#include "pixel_conv.cuh"
#include "tma.cuh"

namespace evflow {
namespace bisect {

using wholenet::C;       // 32 channels
using wholenet::NF;      // n8 fragments of the output channels
using wholenet::SPITCH;  // bf16 per pixel of a pixel-major tile
using pixconv::encode;
using pixconv::layer_mma;
using pixconv::tensor_store_4d;
using pixconv::to_pixel_major;
constexpr int WPITCH = 9 * C + PAD;  // bf16 per staged weight row
constexpr int TH = 16;               // output rows per CTA, the probes' TH
constexpr int E = TH + 16;           // kB's block rows
constexpr int KB_LAYERS = 7;
constexpr int STACK_TW = 8;          // owned columns per CTA of stack_kernel
constexpr int CHAIN_TW = 16;         // owned columns per CTA of chain_kernel
constexpr int CHAIN_WARPS = 16;
constexpr int KB_WARPS = 16;
constexpr int SMEM_LIMIT = 232448;
constexpr int W_BYTES = C * 9 * C * 2;  // a weight matrix in device memory
constexpr int PBYTES = C * 3 * 4;       // a unit's bias, beta, theta
constexpr int PWBYTES = 2 * C * 2;      // the pred head's weights
constexpr int W_BLOCK = C * 128;        // stack_kernel's weights: 64 K values of 32 rows
constexpr int W_BLOCKS = (9 * C + 63) / 64;

// The parts a variant build takes out (-DBI_CUT=BI_CUT_<part>).
enum BisectCut {
  BI_CUT_NONE,
  BI_CUT_X_STAGE,  // x is neither copied nor transposed
  BI_CUT_W_STAGE,  // no weight or parameter copy: they are read as they lie
  BI_CUT_MMA,      // no fragment load and no mma
  BI_CUT_M_LOADS,  // the chain's membranes neither copied nor read (zeros)
  BI_CUT_HANDOFF,  // the spikes a layer hands the next (kB's tiles, spk1) not written
  BI_CUT_STORES,   // no output tile written or stored, no border rows
};
#ifndef BI_CUT
#define BI_CUT BI_CUT_NONE
#endif
__host__ __device__ constexpr bool keeps(BisectCut part) { return BI_CUT != part; }

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

__host__ __device__ constexpr int up128(int v) { return (v + 127) / 128 * 128; }
__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
// Bytes from one channel's plane of a staged box or an output tile to the
// next: 16 past a multiple of 128, so that the 8 channels an ldmatrix or a
// warp's stores touch fall in different banks.
__host__ __device__ constexpr int plane(int bytes) { return up128(bytes) + 16; }

// stack_kernel<NL>'s geometry (mirrored by probes/wholenet_bisect.py::
// launch_layout): x's box and every layer's buffer in one frame, buffer
// pixel (0, 0) the image pixel NL rows above and NL columns left of the
// tile's first output pixel; layer l's cone starts at buffer pixel (l, l).
// The weights sit first (wgmma reads them 1024-byte aligned), as 5 blocks
// of 64 K values, 32 rows of 128 bytes each.
template <int NL>
struct Stack {
  static constexpr int TW = STACK_TW;
  static constexpr int HALO = (NL + 7) / 8 * 8;  // box columns left of the tile: 16-byte pieces
  static constexpr int HR = TH + 2 * NL;         // x's rows, every buffer's
  static constexpr int HC = TW + 2 * NL;         // every buffer's columns
  static constexpr int BX = TW + 2 * HALO;       // x's box columns
  static constexpr int WARPS = NL == 1 ? 8 : KB_WARPS;
  static constexpr int QUADS = ((HR - 2) * (HC - 2) + 63) / 64;  // layer 1's, the largest
  static constexpr int MAXQ = (QUADS + WARPS / 4 - 1) / (WARPS / 4);  // most a warpgroup takes
  static constexpr int BUF = HR * HC * SPITCH * 2;
  static constexpr int XPL = plane(HR * BX * 2);  // x's box planes
  static constexpr int OPL = plane(TH * TW * 4);  // the out tile's planes
  static constexpr int OFF_BAR = W_BLOCKS * W_BLOCK;
  static constexpr int OFF_B0 = OFF_BAR + 128;          // x, the even layers' spikes
  static constexpr int OFF_B1 = OFF_B0 + up128(BUF);    // x's box, the odd layers', the out tile
  static constexpr int SMEM = OFF_B1 + up128(max3(NL > 1 ? BUF : 0, C * XPL, C * OPL));
  static_assert(NL % 2 == 1, "the last layer reads buffer 0, so the out tile may take buffer 1");
};

// chain_kernel's geometry (mirrored by launch_layout): x's box from 8
// columns left of the tile (a 16-byte piece) and 2 rows above, transposed
// to xt (20 x 20 pixels from 2 left, 2 above); m0's box from 8 columns left
// and 1 row above; m1's from the tile's first pixel; spk1 18 x 18 pixels
// from 1 left, 1 above. o0's and o1's tiles take x's box once it is
// transposed, the flow tile m0's box once unit 1 has read it.
struct Chain {
  static constexpr int TW = CHAIN_TW;
  static constexpr int XR = TH + 4, XC = TW + 4, XB = TW + 16;  // xt rows, columns; box columns
  static constexpr int U1 = TH + 2;                             // unit 1's rows, columns
  // m0's and m1's boxes, dense as the TMA engine lands them, a row and
  // some columns wider than the unit reads, so that a channel plane is 16
  // or 48 bytes past a multiple of 128 and the four channel pairs a warp's
  // epilogue reads at once fall in different banks
  static constexpr int M0B = TW + 24, M0R = U1 + 1;  // m0: 40 columns from 8 left, 19 rows
  static constexpr int M1B = TW + 8, M1R = TH + 1;   // m1: 24 columns, 17 rows
  static constexpr int WARPS = CHAIN_WARPS;
  static constexpr int MAXF = ((U1 * U1 + 15) / 16 + WARPS - 1) / WARPS;
  static constexpr int XPL = plane(XR * XB * 2);
  static constexpr int M0PL = M0R * M0B * 2;
  static constexpr int M1PL = M1R * M1B * 2;
  static constexpr int O0PL = TH * TW * 2;        // o0's tile: dense, for a TMA tensor store
  static constexpr int OPL = plane(TH * TW * 2);  // o1's tile
  static constexpr int FPL = plane(TH * TW * 4);  // the flow tile
  static constexpr int XT = XR * XC * SPITCH * 2;
  static constexpr int S1 = U1 * U1 * SPITCH * 2;
  static constexpr int OFF_W0 = 128;  // after the barriers and a dummy row
  static constexpr int OFF_W1 = OFF_W0 + up128(C * WPITCH * 2);
  static constexpr int OFF_P = OFF_W1 + up128(C * WPITCH * 2);  // p0, p1, pw
  static constexpr int OFF_X = OFF_P + up128(2 * PBYTES + PWBYTES);
  static constexpr int OFF_XT = OFF_X + up128(max3(C * XPL, C * O0PL + C * OPL, 0));
  static constexpr int OFF_M0 = OFF_XT + up128(XT);
  static constexpr int OFF_M1 = OFF_M0 + up128(max3(C * M0PL, C * FPL, 0));
  static constexpr int OFF_S1 = OFF_M1 + up128(C * M1PL);
  static constexpr int SMEM = OFF_S1 + up128(S1);
};

// What the kernels read: stack_kernel its weights by a tensor map (128-byte
// swizzled blocks for wgmma), the rest plain.
struct StackParams {
  CUtensorMap w;
  const __nv_bfloat16* x;
  const float* p;  // kA's beta in column 0
  float* out;
  int H, W;
};

struct ChainParams {
  CUtensorMap m0, m1, o0_tile;  // the membranes' boxes and o0's tile, dense, by TMA
  const __nv_bfloat16 *x, *w0, *w1, *pw;
  const float *p0, *p1, *pb;
  __nv_bfloat16 *o0, *o1;
  float* flow;
  int H, W;
};

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) { return __float2bfloat16_rn(v); }

// An arrival at named barrier `id` (of `count` threads) that does not wait:
// this thread's shared-memory writes before it are seen by the waiters.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One 16-byte cp.async, zero-filled (the source not read) where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies have landed
// (the barrier counts every copying thread).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + 8 PIECES) of the C
// channel-major planes src [C][src_rows][W] -> planes of PL bytes in shared
// memory, rows of PIECES 16-byte pieces, columns outside [0, W) zero: one
// cp.async a piece by thread t of nt, then its arrival on `bar`.
template <int ROWS, int PIECES, int PL>
__device__ __forceinline__ void stage_planes(unsigned char* dst, const __nv_bfloat16* src,
                                             int src_rows, int W, int row0, int col0,
                                             uint64_t* bar, int t, int nt) {
  for (int e = t; e < C * ROWS * PIECES; e += nt) {
    const int p = e % PIECES, r = (e / PIECES) % ROWS, ch = e / (PIECES * ROWS);
    const int col = col0 + 8 * p;
    const bool in = col >= 0 && col < W;
    cp_async16(dst + ch * PL + (r * PIECES + p) * 16,
               src + (static_cast<size_t>(ch) * src_rows + row0 + r) * W + (in ? col : 0), in);
  }
  cp_async_arrive(bar);
}

// NCH planes of PL bytes in shared memory, each ROWS rows of COLS elements
// T, -> dst[ch * plane_stride + r * W + col0 + c], the columns below W: one
// 16-byte store a piece by thread t of nt.
template <class T, int NCH, int ROWS, int COLS, int PL>
__device__ __forceinline__ void store_planes(const unsigned char* tile, T* dst,
                                             size_t plane_stride, int W, int col0, int t, int nt) {
  constexpr int PER = 16 / sizeof(T), PIECES = COLS / PER;
  for (int e = t; e < NCH * ROWS * PIECES; e += nt) {
    const int p = e % PIECES, r = (e / PIECES) % ROWS, ch = e / (PIECES * ROWS);
    const int col = col0 + p * PER;
    if (col >= W) continue;
    *reinterpret_cast<uint4*>(dst + ch * plane_stride + static_cast<size_t>(r) * W + col) =
        *reinterpret_cast<const uint4*>(tile + ch * PL + (r * PIECES + p) * 16);
  }
}

// --- wgmma (stack_kernel) ------------------------------------------------------

// The shared-memory descriptor of a K-major B operand in 128-byte swizzled
// rows (8-row groups 1024 bytes apart) starting at `addr`.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until every committed wgmma group has completed.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += a b: a warpgroup's 64 pixels (a warp's 16, A from registers as an
// mma.sync m16k16 fragment) x the 32 output channels (B from shared
// memory), k16; d in mma.sync's accumulator layout, n8 block nf in d[nf].
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[NF][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// A warpgroup's NQ quads (64 pixels each, a warp's 16 in acc[k], its
// ldmatrix row abase[k]) of a layer: 18 k16 steps (tap, 16 channels),
// straight-line, in rounds of BATCH steps: a round loads its steps' A
// fragments by ldmatrix (at most 48 registers), then issues their wgmmas
// back to back and waits for them, so that a layer costs a few round trips
// to the tensor cores, not one a step.
template <int NQ>
struct QuadConv {
  static constexpr int BATCH = NQ >= 12 ? 1 : 12 / NQ;
  float (*acc)[NF][4];
  const uint32_t* abase;
  uint32_t in, wsm;
  int hc;
  uint32_t a[BATCH][NQ][4];

  template <int S>
  __device__ __forceinline__ void load() {
    constexpr int tap = S >> 1, c16 = S & 1, dy = tap / 3;
    const uint32_t off = ((dy * hc + tap - 3 * dy) * SPITCH + c16 * 16) * 2;
#pragma unroll
    for (int k = 0; k < NQ; ++k) ldsm_x4(a[S % BATCH][k], in + abase[k] + off);
  }

  template <int S>
  __device__ __forceinline__ void mma() {
    constexpr uint32_t kb = (S * 16) / 64 * W_BLOCK + (S * 16) % 64 * 2;  // B's k16 slice
#pragma unroll
    for (int k = 0; k < NQ; ++k) wgmma_m64n32k16(acc[k], a[S % BATCH][k], wgmma_desc(wsm + kb));
  }

  template <int S0, int... I>
  __device__ __forceinline__ void round_of(std::integer_sequence<int, I...>) {
    (load<S0 + I>(), ...);
    wgmma_fence();
    (mma<S0 + I>(), ...);
    wgmma_commit();
    wgmma_wait();
  }

  template <int... R>
  __device__ __forceinline__ void run(std::integer_sequence<int, R...>) {
    (round_of<R * BATCH>(
         std::make_integer_sequence<int, (18 - R * BATCH < BATCH ? 18 - R * BATCH : BATCH)>{}),
     ...);
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(acc[k][nf][i])::"memory");
  }
};

template <int NQ>
__device__ __forceinline__ void quad_conv(float (*acc)[NF][4], const uint32_t* abase, uint32_t in,
                                          uint32_t wsm, int hc) {
  QuadConv<NQ> m;
  m.acc = acc;
  m.abase = abase;
  m.in = in;
  m.wsm = wsm;
  m.hc = hc;
  m.run(std::make_integer_sequence<int, (18 + QuadConv<NQ>::BATCH - 1) / QuadConv<NQ>::BATCH>{});
}

// The warpgroup's `mine` quads (at most MAXQ), by a straight-line fold of
// each count.
template <int MAXQ>
__device__ __forceinline__ void warpgroup_conv(int mine, float (*acc)[NF][4],
                                               const uint32_t* abase, uint32_t in, uint32_t wsm,
                                               int hc) {
  static_assert(MAXQ <= 5, "at most five quads a warpgroup are compiled");
  if (!keeps(BI_CUT_MMA)) return;
  if (mine == 1) quad_conv<1>(acc, abase, in, wsm, hc);
  if constexpr (MAXQ >= 2) if (mine == 2) quad_conv<2>(acc, abase, in, wsm, hc);
  if constexpr (MAXQ >= 3) if (mine == 3) quad_conv<3>(acc, abase, in, wsm, hc);
  if constexpr (MAXQ >= 4) if (mine == 4) quad_conv<4>(acc, abase, in, wsm, hc);
  if constexpr (MAXQ >= 5) if (mine == 5) quad_conv<5>(acc, abase, in, wsm, hc);
}

// kA (NL = 1): out = conv * beta. kB (NL = 7): v = conv > 0, seven layers.
// A layer's cone is cut into quads of 64 pixels, quad u on warpgroup u mod
// the warpgroups (a quarter of them each), warp j of it taking pixels
// 16 (4u + j) .. + 15.
template <int NL>
__global__ void __launch_bounds__(Stack<NL>::WARPS * 32, 1)
    stack_kernel(const __grid_constant__ StackParams a) {
  using G = Stack<NL>;
  constexpr int MAXQ = G::MAXQ, NWG = G::WARPS / 4;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);  // x: every thread's copies
  uint64_t* bar_w = bar_x + 1;                                        // the weights
  const uint32_t dummy = smem_u32(smem + G::OFF_BAR + 64);
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem + G::OFF_B0);
  __nv_bfloat16* buf1 = reinterpret_cast<__nv_bfloat16*>(smem + G::OFF_B1);
  unsigned char* tile = smem + G::OFF_B1;  // the out tile [C][TH][TW] f32, planes OPL apart
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wg = warp >> 2, wj = warp & 3;
  const int c0 = blockIdx.x * G::TW, i = blockIdx.y, b = blockIdx.z;
  // kA: output row t is centred on x row t + TH; kB: output row j of block
  // i on block row j + 7. Buffer row 0 is NL rows above either.
  const int rows = NL == 1 ? a.H + 2 * TH : (a.H / TH) * E;
  const int row0 = NL == 1 ? i * TH + TH - 1 : i * E;
  if (tid == 0) {
    mbar_init(bar_x, blockDim.x);
    mbar_init(bar_w, 1);
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_w, keeps(BI_CUT_W_STAGE) ? W_BLOCKS * W_BLOCK : 0);
    if (keeps(BI_CUT_W_STAGE)) {
      for (int kb = 0; kb < W_BLOCKS; ++kb) {
        tensor_copy_4d(smem + kb * W_BLOCK, &a.w, kb * 64, 0, 0, 0, bar_w);
      }
    }
  }
  if (keeps(BI_CUT_X_STAGE)) {
    stage_planes<G::HR, G::BX / 8, G::XPL>(smem + G::OFF_B1,
                                           a.x + static_cast<size_t>(b) * C * rows * a.W, rows,
                                           a.W, row0, c0 - G::HALO, bar_x, tid, blockDim.x);
  } else {
    mbar_arrive(bar_x);
  }
  float beta[NF][2];  // kA: the lane's channels' beta
  if (NL == 1) {
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int j = 0; j < 2; ++j) beta[nf][j] = __ldg(a.p + 3 * (nf * 8 + 2 * q + j));
  }
  mbar_wait(bar_x, 0);
  if (keeps(BI_CUT_X_STAGE)) {
    to_pixel_major<G::XPL / 2>(buf1, buf0, dummy, G::HR, G::BX, G::HC, G::HALO - NL);
  }
  mbar_wait(bar_w, 0);
  __syncthreads();

#pragma unroll 1
  for (int l = 1; l <= NL; ++l) {
    const int lw = G::TW + 2 * (NL - l), npx = (TH + 2 * (NL - l)) * lw;
    const float rlw = 1.f / lw;  // px / lw = int((px + 0.5) / lw) for px < 2^12
    const int nq = (npx + 63) >> 6;
    const int mine = wg < nq ? min(MAXQ, (nq - wg + NWG - 1) / NWG) : 0;
    __nv_bfloat16* in = (l & 1) ? buf0 : buf1;
    __nv_bfloat16* nxt = (l & 1) ? buf1 : buf0;
    uint32_t abase[MAXQ];
    float acc[MAXQ][NF][4];
#pragma unroll
    for (int k = 0; k < MAXQ; ++k) {
      const int px = min(((wg + NWG * k) * 4 + wj) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                         npx - 1);
      const int r = l + px / lw, c = l + px % lw;
      abase[k] = (((r - 1) * G::HC + c - 1) * SPITCH + (lane >> 4) * 8) * 2;
    }
#pragma unroll
    for (int k = 0; k < MAXQ; ++k)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][nf][e] = 0.f;
    warpgroup_conv<MAXQ>(mine, acc, abase, smem_u32(in), smem_u32(smem), G::HC);
#pragma unroll
    for (int k = 0; k < MAXQ; ++k) {
      if (k >= mine) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = ((wg + NWG * k) * 4 + wj) * 16 + half * 8 + g;
        if (px >= npx) continue;
        const int r = __float2int_rz((px + 0.5f) * rlw), c = px - r * lw;  // in the cone
        if (l < NL) {  // the next layer's input: zero outside columns [0, W)
          const int col = c0 - NL + l + c;
          const uint32_t inside = col >= 0 && col < a.W ? 0xFFFFFFFFu : 0u;
          __nv_bfloat16* o = nxt + ((l + r) * G::HC + l + c) * SPITCH + 2 * q;
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {  // a pair of bf16 spikes: 1.0 is 0x3F80
            const uint32_t v = (acc[k][nf][2 * half] > 0.f ? 0x3F80u : 0u) |
                               (acc[k][nf][2 * half + 1] > 0.f ? 0x3F800000u : 0u);
            if (keeps(BI_CUT_HANDOFF)) *reinterpret_cast<uint32_t*>(o + nf * 8) = v & inside;
          }
        } else if (keeps(BI_CUT_STORES)) {  // the out tile
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float s = acc[k][nf][2 * half + j];
              reinterpret_cast<float*>(tile + (nf * 8 + 2 * q + j) * G::OPL)[r * G::TW + c] =
                  NL == 1 ? __fmul_rn(s, beta[nf][j]) : (s > 0.f ? 1.f : 0.f);
            }
        }
      }
    }
    __syncthreads();
  }
  if (keeps(BI_CUT_STORES)) {
    store_planes<float, C, TH, G::TW, G::OPL>(
        tile, a.out + (static_cast<size_t>(b) * C * a.H + i * TH) * a.W,
        static_cast<size_t>(a.H) * a.W, a.W, c0, tid, blockDim.x);
  }
}

// A unit's bias, beta and theta of the lane's channels nf 8 + 2q + j: from
// the staged parameters p [C][3], or all 0.5.
template <int PRM>
struct LifParams {
  float v[3][NF][2];
  __device__ __forceinline__ LifParams(const float* p, int q) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[i][nf][j] = PRM == PER_CHANNEL ? p[3 * (nf * 8 + 2 * q + j) + i] : 0.5f;
        }
  }
};

// The unit's LIF on its conv sum, every rounding explicit.
template <int LIF, int PRM>
__device__ __forceinline__ void lif(float sum, float m, const LifParams<PRM>& p, int nf, int j,
                                    float& spk, float& mem2) {
  const float bias = p.v[0][nf][j], beta = p.v[1][nf][j], theta = p.v[2][nf][j];
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

// A weight matrix [C, 9C] -> shared rows of WPITCH bf16: the warp's lane n
// copies row n, on `bar`.
__device__ __forceinline__ void copy_weights(unsigned char* wsm, const __nv_bfloat16* w, int lane,
                                             uint64_t* bar) {
  bulk_copy(wsm + lane * WPITCH * 2, w + lane * 9 * C, 9 * C * 2, bar);
}

// A warp's `mine` fragments (at most MAXF) of a unit, against rows of
// WPITCH bf16: one fragment on two accumulator sets, else each on its own.
template <int MAXF>
__device__ __forceinline__ void warp_conv(int mine, float (*acc)[NF][4], const uint32_t* abase,
                                          uint32_t in, uint32_t wbase, int hc) {
  static_assert(MAXF <= 2, "at most two fragments a warp are compiled");
  if (!keeps(BI_CUT_MMA)) return;
  if (mine == 1) layer_mma<1, true, false, false, WPITCH>(acc, abase, in, in, wbase, hc);
  if constexpr (MAXF >= 2) {
    if (mine == 2) layer_mma<2, false, false, false, WPITCH>(acc, abase, in, in, wbase, hc);
  }
}

// A unit's fragments on a warp: f = warp + warps k for k < mine; the lane's
// ldmatrix row of fragment k (its pixel's tap (0, 0), its 8 channels) in a
// buffer `hc` pixels wide, the cone `lw` pixels wide and `npx` pixels in all
// starting at buffer pixel (r0, c0); zeroed accumulators.
template <int MAXF, int WARPS>
__device__ __forceinline__ int cone_fragments(int npx, int lw, int r0, int c0, int hc,
                                              uint32_t (&abase)[MAXF],
                                              float (&acc)[MAXF > 1 ? MAXF : 2][NF][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nfr = (npx + 15) >> 4;
  const int mine = warp < nfr ? min(MAXF, (nfr - warp + WARPS - 1) / WARPS) : 0;
#pragma unroll
  for (int k = 0; k < MAXF; ++k) {
    const int px = min((warp + WARPS * k) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, npx - 1);
    const int r = r0 + px / lw, c = c0 + px % lw;
    abase[k] = (((r - 1) * hc + c - 1) * SPITCH + (lane >> 4) * 8) * 2;
  }
#pragma unroll
  for (int k = 0; k < (MAXF > 1 ? MAXF : 2); ++k)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][nf][e] = 0.f;
  return mine;
}

template <int LIF, int PRM, int FLOW, bool OUT_SPK, bool SCRATCH>
__global__ void __launch_bounds__((Chain::WARPS + 1) * 32, 1)
    chain_kernel(const __grid_constant__ ChainParams a) {
  using G = Chain;
  constexpr int MAXF = G::MAXF, NACC = MAXF > 1 ? MAXF : 2, TW = G::TW;
  constexpr int FC = FLOW == ALL_CHANNELS ? C : 2;  // the flow's channels
  constexpr bool PARAMS = PRM == PER_CHANNEL;
  constexpr int NT = G::WARPS * 32;  // the compute threads; one warp more issues the copies
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar_w0 = reinterpret_cast<uint64_t*>(smem);  // w0, p0: unit 1's mma
  uint64_t* bar_w1 = bar_w0 + 1;                         // w1, p1, pw: unit 2's
  uint64_t* bar_x = bar_w0 + 2;  // x: the compute threads' copies
  uint64_t* bar_m0 = bar_w0 + 3;  // m0, m1: the producer warp's
  uint64_t* bar_m1 = bar_w0 + 4;
  const uint32_t dummy = smem_u32(smem + 64);
  const float* prm = reinterpret_cast<const float*>(smem + G::OFF_P);  // p0 [C][3], p1 [C][3]
  const __nv_bfloat16* pws = reinterpret_cast<const __nv_bfloat16*>(prm + 6 * C);  // [2][C]
  unsigned char* o0t = smem + G::OFF_X;  // once x is transposed: o0's tile, then o1's
  unsigned char* o1t = o0t + C * G::O0PL;
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(smem + G::OFF_XT);
  const unsigned char* m0b = smem + G::OFF_M0;
  unsigned char* ft = smem + G::OFF_M0;  // the flow tile, once unit 1 has read m0
  const unsigned char* m1b = smem + G::OFF_M1;
  __nv_bfloat16* s1 = reinterpret_cast<__nv_bfloat16*>(smem + G::OFF_S1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * TW, i = blockIdx.y, b = blockIdx.z;
  const int W = a.W, hp = a.H + 2 * TH, R = TH + i * TH;  // padded row of the first output row
  const size_t img = static_cast<size_t>(b) * C * hp * W;

  if (tid == 0) {
    mbar_init(bar_w0, 1);
    mbar_init(bar_w1, 1);
    mbar_init(bar_x, NT);
    mbar_init(bar_m0, 1);
    mbar_init(bar_m1, 1);
  }
  __syncthreads();
  if (warp == G::WARPS) {  // the producer warp
    constexpr bool WS = keeps(BI_CUT_W_STAGE);
    if (lane == 0) {
      mbar_expect_tx(bar_w0, WS ? W_BYTES + (PARAMS ? PBYTES : 0) : 0);
      mbar_expect_tx(bar_w1,
                     WS ? W_BYTES + (PARAMS ? PBYTES : 0) + (FLOW == PRED ? PWBYTES : 0) : 0);
    }
    __syncwarp();
    if (WS) {  // w0 (and p0) by the TMA engine, with x
      copy_weights(smem + G::OFF_W0, a.w0, lane, bar_w0);
      if (lane == 0 && PARAMS) bulk_copy(smem + G::OFF_P, a.p0, PBYTES, bar_w0);
    }
    // the rest by the TMA engine once x has landed, so that x's copies have
    // the memory to themselves: m0, then w1 (p1, pw), then m1, while unit 1
    // runs
    mbar_wait(bar_x, 0);
    if (lane == 0) {
      constexpr bool M = keeps(BI_CUT_M_LOADS);
      mbar_expect_tx(bar_m0, M ? C * G::M0PL : 0);
      if (M) tensor_copy_4d(smem + G::OFF_M0, &a.m0, c0 - 8, R - 1, 0, b, bar_m0);
      mbar_expect_tx(bar_m1, M ? C * G::M1PL : 0);
    }
    __syncwarp();
    if (WS) {
      copy_weights(smem + G::OFF_W1, a.w1, lane, bar_w1);
      if (lane == 0 && PARAMS) bulk_copy(smem + G::OFF_P + PBYTES, a.p1, PBYTES, bar_w1);
      if (lane == 0 && FLOW == PRED) bulk_copy(smem + G::OFF_P + 2 * PBYTES, a.pw, PWBYTES, bar_w1);
    }
    if (lane == 0 && keeps(BI_CUT_M_LOADS)) {
      tensor_copy_4d(smem + G::OFF_M1, &a.m1, c0, R, 0, b, bar_m1);
    }
    // the zero border rows [0, TH) and [TH + H, Hp) of o0 and o1 over the
    // tile's columns: 16-byte stores
    const int last = static_cast<int>(gridDim.y) - 1;
    for (int edge = 0; edge < 2 && keeps(BI_CUT_STORES); ++edge) {
      if (edge == 0 ? i != 0 : i != last) continue;
      for (int e = lane; e < 2 * C * TH * (TW / 8); e += 32) {
        const int piece = e % (TW / 8), row = (e / (TW / 8)) % TH;
        const int ch = (e / (TW / 8 * TH)) % C, which = e / (TW / 8 * TH * C);
        const int col = c0 + piece * 8;
        if (col >= W) continue;
        __nv_bfloat16* o = which ? a.o1 : a.o0;
        *reinterpret_cast<uint4*>(o + img + (static_cast<size_t>(ch) * hp + row +
                                             (edge ? TH + a.H : 0)) * W + col) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // o0's tile by one TMA tensor store (clipped to the tensor), once the
    // compute warps have written it, while unit 2 runs
    bar_sync(2, NT + 32);
    if (lane == 0 && keeps(BI_CUT_STORES)) {
      tensor_store_4d(&a.o0_tile, c0, R, 0, b, o0t);
      bulk_commit();
      bulk_wait_read<0>();  // the tile is read: the warp may leave
    }
    return;
  }
  // x by the compute warps' cp.async
  if (keeps(BI_CUT_X_STAGE)) {
    stage_planes<G::XR, G::XB / 8, G::XPL>(smem + G::OFF_X, a.x + img, hp, W, R - 2, c0 - 8,
                                           bar_x, tid, NT);
  } else {
    mbar_arrive(bar_x);
  }
  const uint32_t wlane = (((lane & 7) + ((lane >> 4) << 3)) * WPITCH + ((lane >> 3) & 1) * 8) * 2;
  mbar_wait(bar_x, 0);
  if (keeps(BI_CUT_X_STAGE)) {
    to_pixel_major<G::XPL / 2, G::WARPS>(reinterpret_cast<const __nv_bfloat16*>(smem + G::OFF_X),
                                         xt, dummy, G::XR, G::XB, G::XC, 6);
  }
  mbar_wait(bar_w0, 0);
  bar_sync(1, NT);

  // unit 1 on padded rows R-1 .. R+TH, columns c0-1 .. c0+TW: pixel (r, c)
  // reads xt from (r, c) (its tap (0, 0))
  {
    uint32_t abase[MAXF];
    float acc[NACC][NF][4];
    const int npx = G::U1 * G::U1;
    const int mine = cone_fragments<MAXF, G::WARPS>(npx, G::U1, 1, 1, G::XC, abase, acc);
    warp_conv<MAXF>(mine, acc, abase, smem_u32(xt), smem_u32(smem + G::OFF_W0) + wlane, G::XC);
    if (mine == 1) {
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nf][e] += acc[1][nf][e];
    }
    const LifParams<PRM> p0(prm, q);
    mbar_wait(bar_m0, 0);
#pragma unroll
    for (int k = 0; k < MAXF; ++k) {
      if (k >= mine) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = (warp + G::WARPS * k) * 16 + half * 8 + g;
        if (px >= npx) continue;
        const int r = px / G::U1, c = px - r * G::U1;
        const int col = c0 - 1 + c;
        const bool inside = col >= 0 && col < W;
        const bool own = r >= 1 && r <= TH && c >= 1 && c <= TW;
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          float s[2], mem2[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ch = nf * 8 + 2 * q + j;
            const float m =
                keeps(BI_CUT_M_LOADS)
                    ? bf2f(reinterpret_cast<const __nv_bfloat16*>(m0b + ch * G::M0PL)
                               [r * G::M0B + c + 7])
                    : 0.f;
            lif<LIF, PRM>(acc[k][nf][2 * half + j], m, p0, nf, j, s[j], mem2[j]);
            s[j] = inside ? s[j] : 0.f;
            if (own && keeps(BI_CUT_STORES)) {
              reinterpret_cast<__nv_bfloat16*>(o0t + ch * G::O0PL)[(r - 1) * TW + c - 1] =
                  f2bf(OUT_SPK ? s[j] : mem2[j]);
            }
          }
          if (keeps(BI_CUT_HANDOFF)) {
            *reinterpret_cast<__nv_bfloat162*>(s1 + (r * G::U1 + c) * SPITCH + nf * 8 + 2 * q) =
                __floats2bfloat162_rn(s[0], s[1]);
          }
        }
      }
    }
  }
  fence_proxy_async();     // o0's tile writes before the producer's tensor store
  bar_arrive(2, NT + 32);  // o0's tile is written
  bar_sync(1, NT);         // spk1 is written: unit 2 may read it

  // unit 2 on the owned rows R .. R+TH-1, columns c0 .. c0+TW-1: pixel
  // (r, c) reads spk1 from (r, c), or (from_scratch) xt from (r + 1, c + 1)
  {
    uint32_t abase[MAXF];
    float acc[NACC][NF][4];
    const int npx = TH * TW, hc = SCRATCH ? G::XC : G::U1;
    const int mine = cone_fragments<MAXF, G::WARPS>(npx, TW, SCRATCH ? 2 : 1, SCRATCH ? 2 : 1, hc,
                                                    abase, acc);
    mbar_wait(bar_w1, 0);
    warp_conv<MAXF>(mine, acc, abase, smem_u32(SCRATCH ? xt : s1),
                    smem_u32(smem + G::OFF_W1) + wlane, hc);
    if (mine == 1) {
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nf][e] += acc[1][nf][e];
    }
    mbar_wait(bar_m1, 0);
    const LifParams<PRM> p1(prm + 3 * C, q);
    float pwr[2][NF][2];  // the pred head's weights of the lane's channels
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          pwr[o][nf][j] = FLOW == PRED ? bf2f(pws[o * C + nf * 8 + 2 * q + j]) : 0.f;
        }
#pragma unroll
    for (int k = 0; k < MAXF; ++k) {
      if (k >= mine) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = (warp + G::WARPS * k) * 16 + half * 8 + g;  // < TH TW: whole fragments
        const int r = px / TW, c = px - r * TW;
        float dot[2] = {0.f, 0.f};  // the pred head's partial sums over the lane's channels
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ch = nf * 8 + 2 * q + j;
            const float m =
                keeps(BI_CUT_M_LOADS)
                    ? bf2f(reinterpret_cast<const __nv_bfloat16*>(m1b + ch * G::M1PL)
                               [r * G::M1B + c])
                    : 0.f;
            float s, mem2;
            lif<LIF, PRM>(acc[k][nf][2 * half + j], m, p1, nf, j, s, mem2);
            if (keeps(BI_CUT_STORES)) {
              reinterpret_cast<__nv_bfloat16*>(o1t + ch * G::OPL)[r * TW + c] =
                  f2bf(OUT_SPK ? s : mem2);
              if (FLOW == ALL_CHANNELS || (FLOW == TWO_CHANNELS && ch < 2)) {
                reinterpret_cast<float*>(ft + ch * G::FPL)[r * TW + c] = s;
              }
            }
            if (FLOW == PRED) {  // s is 0 or 1: bf16(s) is s
              dot[0] = __fmaf_rn(s, pwr[0][nf][j], dot[0]);
              dot[1] = __fmaf_rn(s, pwr[1][nf][j], dot[1]);
            }
          }
        if (FLOW == PRED) {  // the quad's four lanes hold a pixel's 32 channels
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            dot[o] = __fadd_rn(dot[o], __shfl_xor_sync(0xffffffffu, dot[o], 1));
            dot[o] = __fadd_rn(dot[o], __shfl_xor_sync(0xffffffffu, dot[o], 2));
          }
          if (q == 0 && keeps(BI_CUT_STORES)) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              reinterpret_cast<float*>(ft + o * G::FPL)[r * TW + c] =
                  tanhf(__fadd_rn(dot[o], __ldg(a.pb + o)));
            }
          }
        }
      }
    }
  }
  bar_sync(1, NT);
  if (keeps(BI_CUT_STORES)) {
    store_planes<__nv_bfloat16, C, TH, TW, G::OPL>(o1t, a.o1 + img + static_cast<size_t>(R) * W,
                                                   static_cast<size_t>(hp) * W, W, c0, tid,
                                                   NT);
    store_planes<float, FC, TH, TW, G::FPL>(
        ft, a.flow + (static_cast<size_t>(b) * FC * a.H + R - TH) * W,
        static_cast<size_t>(a.H) * W, W, c0, tid, NT);
  }
}

// --- host side ----------------------------------------------------------------

template <class Kernel, class Params>
int run(Kernel kernel, const Params& prm, BisectArgs& a, dim3 grid, int threads, int smem,
        cudaStream_t stream) {
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(prm);
  a.grid = static_cast<int>(grid.x * grid.y * grid.z);
  a.threads = threads;
  a.smem = smem;
  return static_cast<int>(cudaGetLastError());
}

template <int NL>
int launch_stack(BisectArgs& a, cudaStream_t s) {
  using G = Stack<NL>;
  StackParams prm;
  memset(&prm, 0, sizeof(prm));
  // w [C, 9C] as blocks of 64 K values by 32 rows, 128-byte swizzled (the
  // last block's K values past 9C zero)
  if (!encode(&prm.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.w0, {9 * C, C, 1, 1}, {64, C, 1, 1},
              CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.x = a.x;
  prm.p = a.p0;
  prm.out = a.out;
  prm.H = a.H;
  prm.W = a.W;
  return run(stack_kernel<NL>, prm, a, dim3(a.W / G::TW, a.H / TH, a.B), G::WARPS * 32, G::SMEM,
             s);
}

template <int LIF, int PRM, int FLOW, bool OUT_SPK, bool SCRATCH>
int launch_chain(BisectArgs& a, cudaStream_t s) {
  using G = Chain;
  ChainParams prm;
  memset(&prm, 0, sizeof(prm));
  const int hp = a.H + 2 * TH;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(&prm.m0, bf16, 2, a.m0, {a.W, hp, C, a.B}, {G::M0B, G::M0R, C, 1}) ||
      !encode(&prm.m1, bf16, 2, a.m1, {a.W, hp, C, a.B}, {G::M1B, G::M1R, C, 1}) ||
      !encode(&prm.o0_tile, bf16, 2, a.o0, {a.W, hp, C, a.B}, {G::TW, TH, C, 1})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.x = a.x;
  prm.w0 = a.w0;
  prm.w1 = a.w1;
  prm.pw = a.pw;
  prm.p0 = a.p0;
  prm.p1 = a.p1;
  prm.pb = a.pb;
  prm.o0 = a.o0;
  prm.o1 = a.o1;
  prm.flow = a.out;
  prm.H = a.H;
  prm.W = a.W;
  return run(chain_kernel<LIF, PRM, FLOW, OUT_SPK, SCRATCH>, prm, a,
             dim3((a.W + G::TW - 1) / G::TW, a.H / TH, a.B), (G::WARPS + 1) * 32, G::SMEM, s);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool args_valid(const BisectArgs& a) {
  if (a.body < 0 || a.body >= N_BODIES || a.B < 1 || a.H < TH || a.H % TH != 0 || a.W < 8 ||
      a.W % 8 != 0 || a.x == nullptr || !aligned(a.x) || a.w0 == nullptr || !aligned(a.w0) ||
      a.out == nullptr || !aligned(a.out)) {
    return false;
  }
  if (a.body == KA) return a.p0 != nullptr;
  if (a.body == KB) return true;
  return a.m0 != nullptr && a.m1 != nullptr && a.w1 != nullptr && a.o0 != nullptr &&
         a.o1 != nullptr && aligned(a.m0) && aligned(a.m1) && aligned(a.w1) && aligned(a.o0) &&
         aligned(a.o1) && (a.p0 == nullptr || aligned(a.p0)) &&
         (a.p1 == nullptr || aligned(a.p1)) && (a.pw == nullptr || aligned(a.pw));
}

}  // namespace bisect
}  // namespace evflow

// The one entry point: body 0 is kA, 1 kB, 2..10 the chain's variants in
// the order of probes/wholenet_bisect.py::BODIES (K8l from_scratch, h_chain;
// K8m's four cases; K8n passthrough, one_where, two_where). It returns the
// launch's cudaError_t (0 on success) and refuses what the kernels do not
// take: an unknown body, H not a positive multiple of 16, W not a positive
// multiple of 8 (a row of bf16 a whole number of 16-byte pieces, as a
// tensor copy needs), operands not 16-byte aligned, a missing operand (p0
// and p1 for K8m's parameters, pw and pb for its pred head are checked by
// the variant that reads them).
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
