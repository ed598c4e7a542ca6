// Fused conv3x3 + folded-BN + LIF step, channel-major (K2), for sm_90a.
// Replaces the TPU kernel evflow/ops/pallas/conv_lif_cmajor.py::
// fused_conv_lif_cmajor (Pallas, `_kernel`): x [B,Cin,H,W], mem/spk/mem' and
// prev_spk [B,C,H,W] f32; conv_lif.cu's function and bound (~20 / ~25 us at
// B=2, 256x256, C=32 on an H100 SXM: memory-bound). The design
// (conv_lif_layer.cuh) is one unit of K6 (fused_net_lgrid.cu): each channel
// plane of the tile's halo read along W into the pixel-major bf16 tile,
// weights by TMA, spk and mem' stored along W from the fragments. Unlike the
// TPU kernel: no materialised row windows, any H (no H % tile_rows), C <= 64.
#include "conv_lif_layer.cuh"

EVFLOW_CONV_LIF_ENTRY(conv_lif_cmajor, false)
