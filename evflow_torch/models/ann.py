"""The flow-prediction head (``ConvLayer`` of ``evflow/models/ann.py`` as
FireNet uses it: a 1x1 conv with bias, then tanh)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from evflow_torch.models.cells import conv_nhwc

__all__ = ["ConvLayer"]


class ConvLayer(nn.Module):
    """Conv (with bias) + tanh on NHWC input. ``w_scale`` draws the weights
    from U(-w_scale, w_scale) with zero bias (FireNet's pred head uses
    0.01). With ``compute_dtype`` the conv's operands are rounded to it; the
    output is f32. ``conv_fake_quant(x, tag)``, if set, quantises the
    conv's input ("input") and its output before the tanh ("output"). A
    bf16 input (bf16 state) is widened to f32 first, as flax promotes it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 w_scale: Optional[float] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 conv_fake_quant: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None):
        super().__init__()
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                padding=kernel_size // 2, bias=True)
        if w_scale is not None:
            nn.init.uniform_(self.conv2d.weight, -w_scale, w_scale)
            nn.init.zeros_(self.conv2d.bias)
        self.compute_dtype = compute_dtype
        self.conv_fake_quant = conv_fake_quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            x = x.float()
        q = self.conv_fake_quant
        if q is not None:
            x = q(x, "input")
        out = conv_nhwc(x, self.conv2d, self.compute_dtype)
        if q is not None:
            out = q(out, "output")
        return torch.tanh(out)
