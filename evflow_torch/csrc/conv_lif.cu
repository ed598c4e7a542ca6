// Fused conv3x3 + folded-BN + LIF step, NHWC (K1), for sm_90a. Replaces the
// TPU kernel evflow/ops/pallas/conv_lif.py::fused_conv_lif (Pallas, `_kernel`):
// x [B,H,W,Cin], mem/spk/mem' [B,H,W,C] f32, prev_spk [B,H,W,C] for a recurrent
// unit. Bound on an H100 SXM (B=2, 256x256, C=32): ~67 / ~84 MB of f32 traffic
// (feedforward / recurrent) against 2.4 / 4.8 GFLOP of bf16 tensor work, so
// memory-bound at ~20 / ~25 us (3.35 TB/s). The design (conv_lif_layer.cuh)
// reads each input once (a pixel's channels by 16-byte loads, rounded to bf16
// into shared memory; the 16x16 tiles' halo mostly from L2), lands the weights
// by TMA meanwhile, and writes each output once. Unlike the TPU kernel: no
// materialised halo or zero-padded input in device memory, any H, W and C <= 64.
#include "conv_lif_layer.cuh"

EVFLOW_CONV_LIF_ENTRY(conv_lif, true)
