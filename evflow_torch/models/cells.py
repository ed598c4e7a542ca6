"""Convolutional spiking LIF cells (port of the ``SNNConvLIF`` family of
``evflow/models/cells.py``).

conv3x3 (SAME, no bias) -> BatchNorm/TEBN -> ``leaky_step``, per-channel
leak ``beta`` and threshold (clamped to >= ``THRESH_MIN`` in the forward),
hard or subtract reset, membrane detached after every step, optional MPBN
on the membrane. Activations and states are channels-last ``[B, H, W, C]``
at the interface, as in the reference package; the convolutions run on
``permute``d NCHW views. ``compute_dtype=torch.bfloat16`` rounds the convs'
operands to bf16 and accumulates in f32, as the fused kernels and tensor
cores do (flax's ``dtype=bf16`` also rounds the conv output to bf16; the
port does not); the LIF state stays f32. Module names match the reference's
state dict: ``ff``, ``rec``, ``bn``, ``lif.beta``, ``lif.threshold``
(``[C, 1, 1]``), ``mpbn.bn``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evflow_torch.models.norm import MPBN, TEBN, BatchNorm
from evflow_torch.ops.lif import THRESH_MIN, LIFState, leaky_step

__all__ = ["SNNConvLIF", "SNNConvLIFRecurrent", "conv_nhwc"]


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stride-1 SAME conv of NHWC ``x`` in f32; with ``compute_dtype`` the
    operands are rounded to it first (exact products, f32 sums)."""
    w, b = conv.weight, conv.bias
    if compute_dtype is not None:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
        b = b.to(compute_dtype).float() if b is not None else None
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=conv.kernel_size[0] // 2)
    return y.permute(0, 2, 3, 1)


class _LIFParams(nn.Module):
    """Holds the learnable leak and threshold, ``[C, 1, 1]`` like snn.Leaky."""

    def __init__(self, features: int, leak, thresh):
        super().__init__()
        self.beta = nn.Parameter(torch.empty(features, 1, 1).uniform_(*leak))
        self.threshold = nn.Parameter(torch.empty(features, 1, 1).uniform_(*thresh))


class SNNConvLIF(nn.Module):
    """Feedforward conv + BN + snn.Leaky cell."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3,
                 leak: Tuple[float, float] = (0.0, 1.0),
                 thresh: Tuple[float, float] = (0.0, 0.8), hard_reset: bool = True,
                 tebn: bool = False, num_timesteps: int = 4, mpbn: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ff = nn.Conv2d(input_size, hidden_size, kernel_size,
                            padding=kernel_size // 2, bias=False)
        w = math.sqrt(1.0 / input_size)
        nn.init.uniform_(self.ff.weight, -w, w)
        self.bn = TEBN(hidden_size, num_timesteps) if tebn else BatchNorm(hidden_size)
        self.lif = _LIFParams(hidden_size, leak, thresh)
        self.mpbn = MPBN(hidden_size) if mpbn else None
        self.hard_reset = hard_reset
        self.compute_dtype = compute_dtype

    def _fire(self, current: torch.Tensor, mem: torch.Tensor):
        theta = self.lif.threshold.clamp_min(THRESH_MIN).reshape(-1)
        spk, mem_out = leaky_step(
            current, mem, self.lif.beta.reshape(-1), theta,
            reset="zero" if self.hard_reset else "subtract",
        )
        mem_out = mem_out.detach()
        if self.mpbn is not None:
            mem_out = self.mpbn(mem_out)
        return spk, LIFState(mem_out, spk)

    def forward(self, x: torch.Tensor, state: Optional[LIFState] = None):
        """``x [B, H, W, Cin]`` -> ``(spk [B, H, W, C], LIFState)``."""
        ff = self.bn(conv_nhwc(x, self.ff, self.compute_dtype))
        mem = torch.zeros_like(ff) if state is None else state.mem
        return self._fire(ff, mem)


class SNNConvLIFRecurrent(SNNConvLIF):
    """Recurrent cell: a conv over the previous spikes is added to the
    input current before the norm."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3, **kw):
        super().__init__(input_size, hidden_size, kernel_size, **kw)
        self.rec = nn.Conv2d(hidden_size, hidden_size, kernel_size,
                             padding=kernel_size // 2, bias=False)
        w = math.sqrt(1.0 / hidden_size)
        nn.init.uniform_(self.rec.weight, -w, w)

    def forward(self, x: torch.Tensor, state: Optional[LIFState] = None):
        ff = conv_nhwc(x, self.ff, self.compute_dtype)
        if state is None:
            mem = prev_spk = torch.zeros_like(ff)
        else:
            mem, prev_spk = state
        total = ff + conv_nhwc(prev_spk, self.rec, self.compute_dtype)
        return self._fire(self.bn(total), mem)
