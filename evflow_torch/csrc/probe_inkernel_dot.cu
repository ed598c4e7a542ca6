// In-kernel dot probes: the whole-network kernels' mma.sync mainloop on
// operands resident in shared memory, for sm_90a.
//
// Replaces the TPU kernels of benchmarks/probe_inkernel_dot.py (pallas_calls
// A pixel-major, B channel-major, Bi channel-major int8, C K-split) and
// benchmarks/probe_inkernel_dot2.py (`make`), and runs K8o's k_dot3
// (benchmarks/probe_mosaic_ops.py:24) at one step: each computes
//   out = sum over S steps of ( sum_{i<L} W_i . X )
// with X [K, Np] (or [Np, K]) and W_i [M, K] (or [K, M]) resident in fast
// memory, the TPU's sequential grid of S steps accumulating into the output
// block. They measured how fast in-kernel dots run at the conv's shapes.
//
// On Hopper. One CTA of 16 warps owns TP = 64 pixels and MT (32, or 16 where
// L weight slices of 32 rows do not fit) output channels. A warp's tile is
// 32 pixels x 32 channels (2 m16 x 4 n8 fragments), the tile of conv_region
// in fused_net_common.cuh, run with mma.sync m16n8k16 bf16 -> f32 (m16n8k32
// s8 -> s32 for the int8 probe), so the rate reached at S = 64 is the
// ceiling of the whole-network kernels' mainloop with staging, halo and LIF
// taken away.
//
// Staging. Each operand is copied as it lies in device memory with 16-byte
// cp.async copies, all of them issued before the first wait, in chunks of
// KC = 32 k values; every index of a copy is split by compile-time
// constants. The mma's A operand (the weight rows
// channel-major, the pixel rows pixel-major) lands as [row][k] rows padded
// by 16 bytes; its B operand (X channel-major, W pixel-major) lands as
// [k][n] rows of 128 or 64 bytes, unpadded, their 16-byte chunks
// XOR-swizzled by row, and ldmatrix.x4.trans builds the B fragments from
// them; ldmatrix.x4 builds the A fragments. Both are free of bank
// conflicts. int8 has no transposing ldmatrix: its X lands as [k][p] and
// one pass transposes it in shared memory (4 x 4 byte blocks, byte
// permutes) to [p][k], read with ldmatrix. Pixels past Np are zero-filled
// by the copies (source size 0). An operand whose rows are not 16-byte
// aligned (Np not a multiple of 8 channel-major) takes a scalar copy with
// the same layout; the launch chooses (`vec`).
//
// Work split, two compile-time paths:
//  * resident (S >= 8 step groups, and every bf16-accumulation launch): all
//    512 threads copy every chunk and wait for all of them at one CTA
//    barrier; the 16 warps are then 2 pixel groups x 8 step groups, each
//    warp keeping its sum in registers over its steps s = sg, sg + 8, ...
//    The operands are resident before the step loop, so the staging is paid
//    once and the loop measures the mainloop ceiling. bf16 accumulation
//    rounds each whole dot, so it cannot split K: at S < 8 only S step
//    groups compute.
//  * split K (S below 8, f32 and int8 accumulation): a CTA of 8 warps, 2
//    pixel groups x 4 K groups, group sg taking chunks c = sg, sg + 4, ...
//    of K and running all S steps over them, so every warp computes at
//    S = 1 (k_dot3: 2 of 16 warps did before). At few steps the time is
//    one CTA's latency, not the grid's bandwidth, so in bf16 a group's two
//    warps copy their own chunks, commit one group per chunk, and wait for
//    chunk j (cp.async.wait_group, then a named barrier of the pair) while
//    chunk j + 4 is in flight: no CTA-wide barrier before the epilogue.
//    int8, which transposes X whole first, copies everything first, as the
//    resident path does.
//    K is split across warps rather than the CTA shrunk: the grid stays one
//    wave of 128 CTAs at Np = 8192, W is staged once per 64 pixels (a
//    32-pixel CTA would read it from L2 twice as often), and the 32 x 32
//    warp tile keeps the fragment loads at 2 KB per k16 step (a 16 x 16 tile
//    would need 4 KB for the same mma). Four groups, not eight: the
//    epilogue's partial tiles pass through shared memory at 128 bytes a
//    cycle (8 groups write and read 64 KB, more time than the mma of a
//    chunk), and 4 were faster than 2 or 8 on one H100.
// The groups' partial sums go to shared memory as [group][m-row][n-col]
// rows padded by 8 words, and every output element is written once, the sum
// of the partials that exist (min(S, 8), or min(chunks, 4) split), by
// threads running along the output's contiguous axis: coalesced f32 stores.
//
// Orientation: pixel-major (A) puts pixels on the mma's M side and channels
// on N, as conv_region does; channel-major (B, Bi, C, dot2, k_dot3) puts
// the weight rows on M and pixels on N. C's three K=96 dots per weight run
// as one K=288 stream into the same accumulators. acc=bf16 (dot2)
// accumulates each dot in f32, rounds it to bf16, and rounds the running
// sum to bf16 after each dot, as `acc += dot(..., preferred_element_type=
// bf16)` does.
//
// Bound on an H100 SXM: at S = 64 the operations, 2 M K Np L S (87.0 GFLOP
// at the probes' shapes: 0.088 ms at 989 TFLOP/s bf16, 0.044 ms at 1979
// TOP/s int8); at S = 1 (k_dot3, [32,288] @ [288,8192]) the bytes, 5.79 MB
// of X, W and the f32 output: 1.73 us at 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_inkernel_dot.so probe_inkernel_dot.cu
#include <type_traits>

#include "conv_lif_common.cuh"
#include "tma.cuh"  // smem_u32

namespace evflow {
namespace probe {

constexpr int TP = 64;                 // pixels per CTA
constexpr int NPG = TP / 32;           // pixel groups of 32
constexpr int NSG = 8;                 // step groups of the resident path
constexpr int NKG = 4;                 // K groups of the split-K path
constexpr int THREADS = NPG * NSG * 32;     // 512
constexpr int THREADS_SPLIT = NPG * NKG * 32;  // 256
constexpr int ROW_PAD = 16;            // bytes per padded shared-memory row
constexpr int KC = 32;                 // k values per staged chunk
constexpr int PART_PAD = 8;            // words per partial-sum row
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
  // set by the launch: MT (32, or 16 where 32 rows do not fit), the
  // split-K path (S below NSG), CTAs, shared bytes, 16-byte copies
  int tile_m, split_k, grid, smem, vec;
};

// Byte offsets of the shared-memory regions: the A rows, the B rows, int8's
// [k][p] landing rows, and the partial sums over them all.
struct Layout {
  int es, nch, apitch, brow, spitch;
  int a_off, b_off, s_off, part_off, bytes;
};

__host__ __device__ inline Layout layout(int K, int L, int mt, bool pixm, bool s8,
                                         bool split) {
  Layout o;
  o.es = s8 ? 1 : 2;
  o.nch = (K + KC - 1) / KC;
  o.apitch = K * o.es + ROW_PAD;
  const int arows = pixm ? TP : L * mt;
  o.brow = s8 ? K + ROW_PAD : (pixm ? mt : TP) * 2;
  const int brows = s8 ? TP : (pixm ? L * K : K);
  o.spitch = s8 ? TP + ROW_PAD : 0;
  o.a_off = 0;
  o.b_off = o.a_off + arows * o.apitch;
  o.s_off = o.b_off + brows * o.brow;
  const int operands = o.s_off + K * o.spitch;
  o.part_off = o.a_off;
  const int rows = pixm ? TP : mt, cols = pixm ? mt : TP;
  const int partials = o.part_off + (split ? NKG : NSG) * rows * (cols + PART_PAD) * 4;
  o.bytes = operands > partials ? operands : partials;
  return o;
}

// Byte offset of (row, col_bytes) in B rows of RB bytes (128, 64 or 32):
// the 16-byte chunk index XOR-ed with the row's place among the 8 rows that
// share a 128-byte bank window, so the 8 rows an ldmatrix phase reads fall
// on 8 different bank quads.
template <int RB>
__device__ __forceinline__ int swz(int row, int col_bytes) {
  constexpr int CPR = RB / 16;
  const int sw = (row / (8 / CPR)) & (CPR - 1);
  return row * RB + (((col_bytes >> 4) ^ sw) << 4) + (col_bytes & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits until at most `n` of this thread's committed copy groups are
// pending (at most 3: a larger `n` waits for more than it must; 4 K groups
// leave at most 3 chunks pending for K <= 512).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// A barrier of the `count` threads that use named barrier `id` (1..15).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// Chunk c (k values k0 .. k1) of both operands, 16 bytes a copy, by the
// TEAM threads whose index in the team is `tid`; the copies to pixels past
// Np are zero-filled. A thread's copies of one weight slice (or of X) have a
// compile-time count, unrolled, so their address arithmetic overlaps (one
// copy's arithmetic repeated in a loop is a serial chain, on the critical
// path of a few-step launch).
template <int MT, int MODE, bool PIXM, int TEAM>
__device__ __forceinline__ void stage_chunk(const ProbeArgs& a, const Layout& o,
                                            unsigned char* smem, int c, int p0, int m0,
                                            int tid) {
  using T = typename std::conditional<MODE == S8, int8_t, uint16_t>::type;
  constexpr int V = 16 / sizeof(T);    // elements a copy
  constexpr int KP = KC / V;           // copies along a row's chunk
  constexpr int AR = PIXM ? TP : MT;   // A rows of one weight slice (or of X)
  constexpr int AN = AR * KP, BP = (PIXM ? MT : TP) / V, BN = KC * BP;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int k0 = c * KC, k1 = min(a.K, k0 + KC);
  unsigned char* as = smem + o.a_off;
  unsigned char* bs = smem + o.b_off;
  for (int i = 0; i < (PIXM ? 1 : a.L); ++i) {  // A: [row][k] rows
#pragma unroll
    for (int j = 0; j < (AN + TEAM - 1) / TEAM; ++j) {
      const int t = tid + j * TEAM;
      const int r = t / KP, k = k0 + (t % KP) * V;
      if ((AN % TEAM != 0 && t >= AN) || k >= k1) continue;
      const T* src;
      int bytes = 16;
      if (!PIXM) {
        src = w + i * a.w_si + (m0 + r) * a.w_sm;
        if (a.kseg == a.K) {
          src += k;
        } else {
          const int js = k / a.kseg;
          src += js * a.w_sj + (k - js * a.kseg);
        }
      } else {
        const bool in = p0 + r < a.Np;
        src = x + (in ? p0 + r : 0) * a.x_sp + k;
        bytes = in ? 16 : 0;
      }
      cp_async16(as + (i * AR + r) * o.apitch + k * sizeof(T), src, bytes);
    }
  }
  for (int i = 0; i < (PIXM ? a.L : 1); ++i) {  // B: [k][n] rows
#pragma unroll
    for (int j = 0; j < (BN + TEAM - 1) / TEAM; ++j) {
      const int t = tid + j * TEAM;
      const int k = k0 + t / BP, v = t % BP;
      if ((BN % TEAM != 0 && t >= BN) || k >= k1) continue;
      if (!PIXM) {  // X rows k, pixels along the row
        const int gp = p0 + v * V;
        const bool in = gp < a.Np;
        void* dst = MODE == S8 ? smem + o.s_off + k * o.spitch + v * V
                               : bs + swz<TP * 2>(k, v * 16);
        cp_async16(dst, x + k * a.x_sk + (in ? gp : 0), in ? 16 : 0);
      } else {  // the weight rows (i, k), channels along the row
        cp_async16(bs + swz<MT * 2>(i * a.K + k, v * 16), w + i * a.w_si + k * a.w_sk + m0 + v * V,
                   16);
      }
    }
  }
}

// Both operands whole, an element at a time, in the layout of stage_chunk:
// for operands whose rows are not 16-byte aligned.
template <int MT, int MODE, bool PIXM, int NT>
__device__ void stage_scalar(const ProbeArgs& a, const Layout& o, unsigned char* smem, int p0,
                             int m0) {
  using T = typename std::conditional<MODE == S8, int8_t, uint16_t>::type;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  auto wv = [&](int i, int m, int k) {
    const int j = k / a.kseg;
    return w[i * a.w_si + (m0 + m) * a.w_sm + j * a.w_sj + (k - j * a.kseg) * a.w_sk];
  };
  auto xv = [&](int p, int k) {
    return p0 + p < a.Np ? x[(p0 + p) * a.x_sp + k * a.x_sk] : T(0);
  };
  if (!PIXM) {
    for (int e = threadIdx.x; e < a.L * MT * a.K; e += NT) {
      const int r = e / a.K, k = e - r * a.K, i = r / MT;
      reinterpret_cast<T*>(smem + o.a_off + r * o.apitch)[k] = wv(i, r - i * MT, k);
    }
    for (int e = threadIdx.x; e < a.K * TP; e += NT) {
      const int k = e / TP, p = e - k * TP;
      unsigned char* dst = MODE == S8 ? smem + o.s_off + k * o.spitch + p
                                      : smem + o.b_off + swz<TP * 2>(k, p * 2);
      *reinterpret_cast<T*>(dst) = xv(p, k);
    }
  } else {
    for (int e = threadIdx.x; e < TP * a.K; e += NT) {
      const int p = e / a.K, k = e - p * a.K;
      reinterpret_cast<T*>(smem + o.a_off + p * o.apitch)[k] = xv(p, k);
    }
    for (int e = threadIdx.x; e < a.L * a.K * MT; e += NT) {
      const int r = e / MT, m = e - r * MT, i = r / a.K;
      *reinterpret_cast<T*>(smem + o.b_off + swz<MT * 2>(r, m * 2)) = wv(i, m, r - i * a.K);
    }
  }
}

// int8 X from its [k][p] landing rows to [p][k] rows, 4 x 4 bytes a thread.
template <int NT>
__device__ void transpose_s8(const Layout& o, unsigned char* smem, int K) {
  constexpr int PB = TP / 4;
  for (int t = threadIdx.x; t < (K / 4) * PB; t += NT) {
    const int kb = t / PB, pb = t - kb * PB;
    const unsigned char* s = smem + o.s_off + 4 * kb * o.spitch + 4 * pb;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(s);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(s + o.spitch);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(s + 2 * o.spitch);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(s + 3 * o.spitch);
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
    unsigned char* d = smem + o.b_off + 4 * pb * o.brow + 4 * kb;
    *reinterpret_cast<uint32_t*>(d) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + o.brow) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(d + 2 * o.brow) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(d + 3 * o.brow) = __byte_perm(hi01, hi23, 0x7632);
  }
}

template <int MT, int MODE, bool PIXM, bool SPLITK>
__global__ void __launch_bounds__(SPLITK ? THREADS_SPLIT : THREADS, 1) probe_kernel(ProbeArgs a) {
  constexpr int NT = SPLITK ? THREADS_SPLIT : THREADS;  // threads
  constexpr int NG = SPLITK ? NKG : NSG;                // step or K groups
  using Acc = typename std::conditional<MODE == S8, int, float>::type;
  constexpr int MFA = PIXM ? 2 : MT / 16;  // m16 fragments of a warp's tile
  constexpr int NFB = PIXM ? MT / 8 : 4;   // n8 fragments
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout o = layout(a.K, a.L, MT, PIXM, MODE == S8, SPLITK);
  const int p0 = blockIdx.x * TP, m0 = blockIdx.y * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pg = warp % NPG, sg = warp / NPG;
  // split K on 16-byte copies, bf16 (int8 turns X whole first): the group's
  // two warps copy their own chunks, a commit group each; every other
  // launch copies everything before any mma
  const bool own = SPLITK && MODE != S8 && a.vec;
  if (own) {
    for (int c = sg; c < o.nch; c += NKG) {
      stage_chunk<MT, MODE, PIXM, NPG * 32>(a, o, smem, c, p0, m0, pg * 32 + lane);
      cp_async_commit();
    }
  } else {
    if (a.vec) {
      for (int c = 0; c < o.nch; ++c)
        stage_chunk<MT, MODE, PIXM, NT>(a, o, smem, c, p0, m0, threadIdx.x);
      cp_async_wait_all();
    } else {
      stage_scalar<MT, MODE, PIXM, NT>(a, o, smem, p0, m0);
    }
    __syncthreads();
    if (MODE == S8) {
      transpose_s8<NT>(o, smem, a.K);
      __syncthreads();
    }
  }

  const int g = lane >> 2, q = lane & 3;
  const int es = o.es;
  // each lane's ldmatrix row addresses: A rows (lane & 15), k half (lane >> 4);
  // B: bf16 k rows (lane & 7) + 8 ((lane >> 3) & 1) of n block (lane >> 4),
  // int8 p rows (lane & 7) of n block (lane >> 4), k half ((lane >> 3) & 1)
  const uint32_t a_lane = smem_u32(smem + o.a_off) +
                          ((PIXM ? pg * 32 : 0) + (lane & 15)) * o.apitch + (lane >> 4) * 16;
  uint32_t b_lane[NFB / 2];
  if (MODE == S8) {
#pragma unroll
    for (int np = 0; np < NFB / 2; ++np)
      b_lane[np] = smem_u32(smem + o.b_off) +
                   (pg * 32 + (2 * np + (lane >> 4)) * 8 + (lane & 7)) * o.brow +
                   ((lane >> 3) & 1) * 16;
  } else {
    const int krow = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int np = 0; np < NFB / 2; ++np)
      b_lane[np] = smem_u32(smem + o.b_off) +
                   swz<(PIXM ? MT : TP) * 2>(krow,
                                             ((PIXM ? 0 : pg * 4) + 2 * np + (lane >> 4)) * 16);
  }

  // one k16 (bf16) or k32 (int8) step of W_i . X at byte offset kb along
  // k: its fragments, then its mma
  struct Frags {
    uint32_t a[MFA][4], b[NFB / 2][4];
  };
  auto load = [&](int i, int kb, Frags& f) {
    const uint32_t ai = a_lane + (PIXM ? 0 : i * MT * o.apitch) + kb;
#pragma unroll
    for (int mf = 0; mf < MFA; ++mf) ldsm_x4(f.a[mf], ai + mf * 16 * o.apitch);
#pragma unroll
    for (int np = 0; np < NFB / 2; ++np) {
      if (MODE == S8) {
        ldsm_x4(f.b[np], b_lane[np] + kb);
      } else {  // k rows kb / 2 on: the swizzle repeats every 8 rows
        ldsm_x4_t(f.b[np], b_lane[np] + ((PIXM ? i * a.K : 0) + kb / 2) * o.brow);
      }
    }
  };
  auto mmas = [&](const Frags& f, Acc (&d)[MFA][NFB][4]) {
#pragma unroll
    for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
      for (int mf = 0; mf < MFA; ++mf)
        mma(d[mf][nf], f.a[mf], f.b[nf / 2][(nf & 1) * 2], f.b[nf / 2][(nf & 1) * 2 + 1]);
  };
  auto kstep = [&](int i, int kb, Acc (&d)[MFA][NFB][4]) {
    Frags f;
    load(i, kb, f);
    mmas(f, d);
  };

  Acc out[MFA][NFB][4];
#pragma unroll
  for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
    for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[mf][nf][e] = 0;

  const int kbytes = a.K * es;
  if (SPLITK) {
    for (int c = sg; c < o.nch; c += NG) {
      if (own) {  // this chunk, while the group's later chunks are in flight
        cp_async_wait_pending((o.nch - 1 - c) / NG);
        bar_sync(1 + sg, NPG * 32);
      }
      constexpr int STEPS = KC * (MODE == S8 ? 1 : 2) / 32;  // k steps of a chunk
      const int kb0 = c * KC * es, kb1 = min(kbytes, kb0 + KC * es);
      for (int s = 0; s < a.S; ++s)
        for (int i = 0; i < a.L; ++i) {
          Frags f[STEPS];  // both steps' fragments before their mma
#pragma unroll
          for (int st = 0; st < STEPS; ++st)
            if (kb0 + 32 * st < kb1) load(i, kb0 + 32 * st, f[st]);
#pragma unroll
          for (int st = 0; st < STEPS; ++st)
            if (kb0 + 32 * st < kb1) mmas(f[st], out);
        }
    }
  } else {
    for (int s = sg; s < a.S; s += NG) {
      if (MODE == BF16_ACC) {
        float step[MFA][NFB][4];  // this step's running bf16 sum
#pragma unroll
        for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
          for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) step[mf][nf][e] = 0.f;
        for (int i = 0; i < a.L; ++i) {
          Acc dot[MFA][NFB][4];  // W_i . X
#pragma unroll
          for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
            for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
              for (int e = 0; e < 4; ++e) dot[mf][nf][e] = 0;
#pragma unroll 2
          for (int kb = 0; kb < kbytes; kb += 32) kstep(i, kb, dot);
#pragma unroll
          for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
            for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                step[mf][nf][e] = bf16r(step[mf][nf][e] + bf16r(dot[mf][nf][e]));
        }
#pragma unroll
        for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
          for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
            for (int e = 0; e < 4; ++e) out[mf][nf][e] += step[mf][nf][e];
      } else {
        for (int i = 0; i < a.L; ++i)
#pragma unroll 2
          for (int kb = 0; kb < kbytes; kb += 32) kstep(i, kb, out);
      }
    }
  }

  // the groups' partial sums -> shared memory [group][row][col] (rows on
  // the mma's M side), added in group order and written once
  __syncthreads();  // every warp is done with the operands (every copy has landed)
  constexpr int ROWS = PIXM ? TP : MT, COLS = PIXM ? MT : TP, CP = COLS + PART_PAD;
  const int groups = SPLITK ? min(NG, o.nch) : min(NG, a.S);
  Acc* part = reinterpret_cast<Acc*>(smem + o.part_off);
  if (sg < groups) {
#pragma unroll
    for (int mf = 0; mf < MFA; ++mf)
#pragma unroll
      for (int nf = 0; nf < NFB; ++nf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mf * 16 + g + 8 * h, col = nf * 8 + 2 * q;
          const int r = PIXM ? pg * 32 + row : row, cc = PIXM ? col : pg * 32 + col;
          using Acc2 = typename std::conditional<MODE == S8, int2, float2>::type;
          *reinterpret_cast<Acc2*>(part + (sg * ROWS + r) * CP + cc) =
              Acc2{out[mf][nf][2 * h], out[mf][nf][2 * h + 1]};
        }
  }
  __syncthreads();
  // four consecutive outputs a thread along the output's contiguous axis
  // (16-byte loads of the partials, one 16-byte store), every partial loaded
  // before the first add (a loop of dependent load-add pairs, an element at
  // a time, serialises the tail of a few-step launch)
  using Acc4 = typename std::conditional<MODE == S8, int4, float4>::type;
  constexpr int N4 = ROWS * COLS / 4, PER = (N4 + NT - 1) / NT;
  Acc* dst = static_cast<Acc*>(a.out);
  const bool vec_out = PIXM || a.Np % 4 == 0;  // no 4 outputs straddle Np
  Acc4 pv[PER][NG];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = 4 * (threadIdx.x + j * NT), r = e / COLS, cc = e % COLS;
    if (N4 % NT != 0 && e >= 4 * N4) break;
#pragma unroll
    for (int k = 0; k < NG; ++k)
      if (k < groups) pv[j][k] = *reinterpret_cast<const Acc4*>(part + (k * ROWS + r) * CP + cc);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = 4 * (threadIdx.x + j * NT), r = e / COLS, cc = e % COLS;
    if (N4 % NT != 0 && e >= 4 * N4) break;
    const int p = PIXM ? r : cc, m = PIXM ? cc : r;
    Acc4 v = pv[j][0];
#pragma unroll
    for (int k = 1; k < NG; ++k)
      if (k < groups) v.x += pv[j][k].x, v.y += pv[j][k].y, v.z += pv[j][k].z, v.w += pv[j][k].w;
    Acc* o4 = dst + (p0 + p) * a.o_sp + (m0 + m) * a.o_sm;  // element (p, m)
    if (vec_out) {
      if (p0 + p < a.Np) *reinterpret_cast<Acc4*>(o4) = v;
    } else {  // channel-major, Np not a multiple of 4: element by element
      const Acc vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (p0 + p + t < a.Np) o4[t * a.o_sp] = vs[t];
    }
  }
}

template <int MT, int MODE, bool PIXM, bool SPLITK>
int launch(ProbeArgs& a, cudaStream_t stream) {
  auto kernel = probe_kernel<MT, MODE, PIXM, SPLITK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Np + TP - 1) / TP, a.M / MT);
  kernel<<<grid, SPLITK ? THREADS_SPLIT : THREADS, a.smem, stream>>>(a);
  a.grid = static_cast<int>(grid.x * grid.y);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, int MODE, bool PIXM>
int launch_split(ProbeArgs& a, cudaStream_t stream) {
  if constexpr (MODE == BF16_ACC) {
    return launch<MT, MODE, PIXM, false>(a, stream);
  } else {
    return a.split_k ? launch<MT, MODE, PIXM, true>(a, stream)
                     : launch<MT, MODE, PIXM, false>(a, stream);
  }
}

template <int MODE>
int launch_mode(ProbeArgs& a, cudaStream_t stream) {
  if constexpr (MODE == F32_ACC) {
    if (a.pixel_major) return launch_split<32, MODE, true>(a, stream);
  }
  return a.tile_m == 32 ? launch_split<32, MODE, false>(a, stream)
                        : launch_split<16, MODE, false>(a, stream);
}

inline bool aligned16(long long v) { return v % 16 == 0; }

// Whether every 16-byte copy of stage_chunk reads a 16-byte aligned run
// that lies wholly inside or wholly past the operand.
bool vector_copies(const ProbeArgs& a) {
  const int es = a.mode == S8 ? 1 : 2, v = 16 / es;
  const bool ptrs = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  if (a.pixel_major) {
    return ptrs && a.x_sk == 1 && aligned16(a.x_sp * es) && a.w_sm == 1 &&
           aligned16(a.w_si * es) && aligned16(a.w_sk * es);
  }
  return ptrs && a.x_sp == 1 && aligned16(a.x_sk * es) && a.Np % v == 0 && a.w_sk == 1 &&
         a.kseg % v == 0 && aligned16(a.w_si * es) && aligned16(a.w_sm * es) &&
         aligned16(a.w_sj * es);
}

}  // namespace probe
}  // namespace evflow

extern "C" int probe_inkernel_dot(evflow::probe::ProbeArgs* a, void* stream) {
  using namespace evflow::probe;
  const int kstep = a->mode == S8 ? 32 : 16;
  if (a->x == nullptr || a->w == nullptr || a->out == nullptr || a->Np < 1 || a->L < 1 ||
      a->S < 1 || a->K < kstep || a->K % kstep != 0 || a->kseg < 1 || a->K % a->kseg != 0 ||
      (a->pixel_major && a->mode != F32_ACC) || a->mode < F32_ACC || a->mode > S8 ||
      (a->pixel_major ? a->o_sm != 1 : a->o_sp != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // bf16 accumulation rounds each whole dot: it never splits K
  a->split_k = a->S < NSG && a->mode != BF16_ACC ? 1 : 0;
  a->tile_m = 0;
  // 32 rows where they fit, else 16 (pixel-major: 32 only)
  for (int mt = 32; mt >= (a->pixel_major ? 32 : 16); mt /= 2) {
    const int bytes = layout(a->K, a->L, mt, a->pixel_major != 0, a->mode == S8,
                             a->split_k != 0).bytes;
    if (a->M % mt == 0 && bytes <= SMEM_LIMIT) {
      a->tile_m = mt;
      a->smem = bytes;
      break;
    }
  }
  if (a->tile_m == 0) return static_cast<int>(cudaErrorInvalidValue);
  a->vec = vector_copies(*a) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->mode) {
    case F32_ACC: return launch_mode<F32_ACC>(*a, s);
    case BF16_ACC: return launch_mode<BF16_ACC>(*a, s);
    default: return launch_mode<S8>(*a, s);
  }
}
