// Fused conv3x3 + folded-BN + LIF step, NHWC activations, for sm_90a.
//
// Replaces the TPU kernel evflow/ops/pallas/conv_lif.py::fused_conv_lif
// (Pallas, body `_kernel`): x [B,H,W,Cin], mem/spk/mem' [B,H,W,C] f32,
// recurrent units add conv3x3(prev_spk [B,H,W,C]) into the same sum.
//
// Bound on an H100 SXM at the bench shape (B=2, 256x256, C=32): ~67 MB of
// f32 traffic for a feedforward unit and ~84 MB for a recurrent one, against
// 2.4 / 4.8 GFLOP of bf16 tensor work, so memory-bound at ~20 / ~25 us
// (3.35 TB/s). The kernel reads every input element once (f32, rounded to
// bf16 on its way into shared memory), keeps the implicit-GEMM operands in
// shared memory and the LIF update in registers, and writes each output
// once. The TPU version's workarounds are gone: no materialised halo tiles,
// no zero-padding of a 2-channel input up to C in device memory, and any H
// and W. Kernel body and design notes: conv_lif_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libconv_lif.so conv_lif.cu
#include "conv_lif_common.cuh"

EVFLOW_CONV_LIF_ENTRY(conv_lif, false)
