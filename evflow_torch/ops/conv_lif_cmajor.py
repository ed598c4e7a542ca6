"""Fused conv3x3 + folded BatchNorm + LIF step, channel-major (port of
``evflow/ops/pallas/conv_lif_cmajor.py``).

Same math as ``evflow_torch.ops.conv_lif`` in NCHW: x ``[B, Cin, H, W]``,
mem and outputs ``[B, C, H, W]``, the same packed weights
(``conv_lif.pack_weights``). ``fused_conv_lif_cmajor`` launches
``evflow_torch/csrc/conv_lif_cmajor.cu`` for CUDA tensors and runs
``conv_lif_cmajor_plain`` for CPU tensors. The TPU wrapper's ``tile_rows``
and never-read ``unroll`` arguments have no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from evflow_torch.ops.conv_lif import check_and_launch, conv_packed
from evflow_torch.ops.lif import leaky_step

__all__ = ["fused_conv_lif_cmajor", "conv_lif_cmajor_plain"]


def conv_lif_cmajor_plain(x, mem, wk, bias, beta, theta, prev_spk=None,
                          hard_reset: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the channel-major kernel."""
    xin = x if prev_spk is None else torch.cat([x, prev_spk], dim=1)
    ff = conv_packed(xin, wk) + bias[:, None, None]
    return leaky_step(ff, mem, beta[:, None, None], theta[:, None, None],
                      reset="zero" if hard_reset else "subtract")


def fused_conv_lif_cmajor(x, mem, wk, bias, beta, theta, prev_spk=None,
                          hard_reset: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-major fused step: x ``[B, Cin, H, W]``, mem/prev_spk and the
    returned ``(spk, mem_out)`` ``[B, C, H, W]`` f32; other arguments as in
    ``fused_conv_lif``.

    CPU tensors run ``conv_lif_cmajor_plain``; CUDA tensors launch the
    kernel (counted in ``fused_conv_lif_cmajor.launches``) or raise.
    """
    if x.device.type == "cpu":
        return conv_lif_cmajor_plain(x, mem, wk, bias, beta, theta, prev_spk,
                                     hard_reset)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_lif_cmajor runs on cpu or cuda, got {x.device}")
    out = check_and_launch("conv_lif_cmajor", True, x, mem, wk, bias, beta, theta,
                           prev_spk, hard_reset)
    fused_conv_lif_cmajor.launches += 1
    return out


fused_conv_lif_cmajor.launches = 0
