// The Mosaic-ops probes' elementwise bodies for sm_90a: two shifted copies
// of a bf16 block added with wrap-around, and a block added to its masked
// self, each sum rounded to bf16 and widened to f32.
//
// Replaces the TPU kernels of benchmarks/probe_mosaic_ops.py (K8o; v [C, E,
// W] bf16 in VMEM, out [C, E, W] f32):
//   elementwise_kernel<ROLL>  k_roll (:13, call :33): out[c, e, w] =
//                             f32(bf16(v[c, e, (w - 1) mod W] + v[c, (e - 1)
//                             mod E, w])), pltpu.roll by 1 along lanes and
//                             along sublanes
//   elementwise_kernel<MISC>  k_misc (:42, call :50): out = f32(bf16(concat(v,
//                             v, v)[:C] + where(w > 0, v, 0))), that is 2 v
//                             where w > 0 and v at w = 0
// The third body of the file, k_dot3 (:8), is the x1 case of
// probe_inkernel_dot2.py and runs on probe_inkernel_dot.cu
// (probes/mosaic_ops.py::dot3).
//
// The bf16 sum rounds: both operands are bf16, their sum is taken in f32
// (exact for all but far-apart exponents, as torch and a bf16 vector unit
// take it) and rounded to nearest even, then widened. Pallas's interpret
// mode skips that rounding for k_roll (its output is the f32 sum), eager
// jnp and torch do not; the port computes what the source's types say.
//
// Design. One thread owns 8 consecutive elements of one row (c, e): one
// 16-byte load of its own row and, for k_roll, one 16-byte load of the row
// above ((e - 1) mod E, the sublane roll) and one 2-byte load of the
// element left of its first ((w0 - 1) mod W, the lane roll; the other seven
// come from its own registers). The neighbour row and element are read
// again by other threads, from L1 or L2: the device memory sees each input
// byte once. Two 16-byte stores of f32. 256 threads a CTA, 128 CTAs at C=32,
// E=32, W=256.
//
// Bound on an H100 SXM (3.35 TB/s): 524,288 bytes read and 1,048,576
// written at the probe's shape, 0.47 us, for either body; the adds count no
// flops (probes/mosaic_ops.py::mosaic_bytes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprobe_mosaic_ops.so probe_mosaic_ops.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace evflow {
namespace mosaic {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // consecutive elements per thread: one 16-byte load

enum Op { MISC = 0, ROLL = 1 };

// Mirrored by ctypes in evflow_torch/probes/mosaic_ops.py.
struct MosaicArgs {
  const void* v;  // [C, E, W] bf16
  void* out;      // [C, E, W] f32
  int op;         // Op
  int C, E, W;
  int grid, threads, smem;  // set by the launch
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(h[i]);
}

// The bf16 sum a + b of two bf16 values, widened: rounded once to bf16.
__device__ __forceinline__ float bf16_add(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
}

template <int OP>
__global__ void __launch_bounds__(THREADS) elementwise_kernel(const __nv_bfloat16* __restrict__ v,
                                                              float* __restrict__ out, int E,
                                                              int W, int n) {
  const int o = (blockIdx.x * THREADS + threadIdx.x) * VEC;  // flat index (c E + e) W + w0
  if (o >= n) return;
  const int row = o / W, w0 = o - row * W;
  float a[VEC], r[VEC];
  load8(v + o, a);
  if (OP == ROLL) {
    const int e = row % E;
    float up[VEC];
    load8(v + (e == 0 ? o + (E - 1) * W : o - W), up);  // v[c, (e - 1) mod E, w0 ..]
    float left = __bfloat162float(v[w0 == 0 ? o + W - 1 : o - 1]);  // v[c, e, (w0 - 1) mod W]
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      r[i] = bf16_add(left, up[i]);
      left = a[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = bf16_add(a[i], w0 + i > 0 ? a[i] : 0.f);
  }
  float4* dst = reinterpret_cast<float4*>(out + o);
  dst[0] = make_float4(r[0], r[1], r[2], r[3]);
  dst[1] = make_float4(r[4], r[5], r[6], r[7]);
}

bool args_valid(const MosaicArgs& a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out);
  return a.v != nullptr && a.out != nullptr && ptrs % 16 == 0 && (a.op == MISC || a.op == ROLL) &&
         a.C >= 1 && a.E >= 1 && a.W >= VEC && a.W % VEC == 0 &&
         static_cast<long long>(a.C) * a.E * a.W < (1LL << 31);
}

}  // namespace mosaic
}  // namespace evflow

// The one entry point: the body `op` names over v. It returns the launch's
// cudaError_t (0 on success) and refuses what the kernel does not take:
// pointers not 16-byte aligned, W not a multiple of 8, 2^31 elements or
// more.
extern "C" int probe_mosaic_ops(evflow::mosaic::MosaicArgs* a, void* stream) {
  using namespace evflow::mosaic;
  if (!args_valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  const int n = a->C * a->E * a->W;
  const int grid = (n / VEC + THREADS - 1) / THREADS;
  auto kernel = a->op == ROLL ? elementwise_kernel<ROLL> : elementwise_kernel<MISC>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a->v), static_cast<float*>(a->out), a->E, a->W, n);
  a->grid = grid;
  a->threads = THREADS;
  a->smem = 0;
  return static_cast<int>(cudaGetLastError());
}
