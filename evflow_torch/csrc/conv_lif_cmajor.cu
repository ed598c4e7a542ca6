// Fused conv3x3 + folded-BN + LIF step, channel-major (NCHW) activations,
// for sm_90a.
//
// Replaces the TPU kernel
// evflow/ops/pallas/conv_lif_cmajor.py::fused_conv_lif_cmajor (Pallas, body
// `_kernel`): x [B,Cin,H,W], mem/spk/mem' [B,C,H,W] f32, recurrent units add
// conv3x3(prev_spk [B,C,H,W]) into the same sum. Same math as conv_lif.cu.
//
// Bound on an H100 SXM at the bench shape (B=2, 256x256, C=32): ~67 MB of
// f32 traffic for a feedforward unit and ~84 MB for a recurrent one, against
// 2.4 / 4.8 GFLOP of bf16 tensor work, so memory-bound at ~20 / ~25 us
// (3.35 TB/s). Input rows are read along W (coalesced in this layout),
// rounded to bf16 and transposed into the same pixel-major shared-memory
// tile the NHWC kernel uses; the epilogue reads mem and writes spk/mem'
// along W. The TPU version's materialised overlapping row windows and the
// H % tile_rows restriction are gone. Kernel body: conv_lif_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libconv_lif_cmajor.so conv_lif_cmajor.cu
#include "conv_lif_common.cuh"

EVFLOW_CONV_LIF_ENTRY(conv_lif_cmajor, true)
