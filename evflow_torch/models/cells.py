"""Convolutional spiking LIF cells (port of the ``SNNConvLIF`` family of
``evflow/models/cells.py``).

conv3x3 (SAME, no bias) -> BatchNorm/TEBN (at the pass's ``timestep``) ->
``leaky_step``, per-channel leak ``beta`` and threshold (clamped to >=
``THRESH_MIN`` in the forward), hard or subtract reset, the membrane
detached after every step unless ``detach=False``, optional MPBN on the
membrane. ``learn_leak=False`` / ``learn_thresh=False`` detach the leak /
threshold, so they get no gradient. The clamps split the gradient at a tie
as ``jnp.maximum``/``jnp.clip`` do (half to each side): ``torch.maximum``,
not ``clamp_min``, whose gradient passes whole. Activations and states are
channels-last ``[B, H, W, C]`` at the interface, as in the reference
package; the convolutions run on ``permute``d NCHW views.
``compute_dtype=torch.bfloat16`` rounds the convs' operands to bf16 and
accumulates in f32, as the fused kernels and tensor cores do (flax's
``dtype=bf16`` also rounds the conv output to bf16; the port does not); the
LIF state stays f32. Module names match the reference's state dict: ``ff``,
``rec``, ``bn``, ``lif.beta``, ``lif.threshold`` (``[C, 1, 1]``),
``mpbn.bn``.

f32 convs on the card run in full f32 (``full_f32_convs``) whatever the
process's TF32 flags: PyTorch lets cuDNN run f32 convs in TF32 by default,
whose 10 mantissa bits move membranes by ~1e-3 and flip spikes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evflow_torch.models.norm import MPBN, TEBN, BatchNorm
from evflow_torch.ops.lif import THRESH_MIN, LIFState, leaky_step

__all__ = ["SNNConvLIF", "SNNConvLIFRecurrent", "conv_nhwc", "full_f32_convs"]


@contextlib.contextmanager
def full_f32_convs():
    """A context in which cuDNN computes f32 convolutions in f32, not TF32:
    ``torch.backends.cudnn.conv.fp32_precision`` set to "ieee" and put
    back after (reading the legacy ``allow_tf32`` flag instead would raise
    once the two disagree). The trainer runs the whole step in it: the
    autograd engine runs the convs' gradients outside ``conv_nhwc``."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    if prev == "ieee":
        yield
        return
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stride-1 SAME conv of NHWC ``x`` in f32 (on the card in full f32,
    not TF32); with ``compute_dtype`` the operands are rounded to it first
    (exact products, f32 sums) and cuDNN's flags apply as they are."""
    w, b = conv.weight, conv.bias
    f32 = (full_f32_convs() if x.is_cuda and compute_dtype is None
           else contextlib.nullcontext())
    if compute_dtype is not None:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
        b = b.to(compute_dtype).float() if b is not None else None
    with f32:
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
                 compute_dtype: Optional[torch.dtype] = None, learn_leak: bool = True,
                 learn_thresh: bool = True, detach: bool = True):
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
        self.learn_leak = learn_leak
        self.learn_thresh = learn_thresh
        self.detach = detach

    def _norm(self, x: torch.Tensor, timestep: Optional[int]) -> torch.Tensor:
        return self.bn(x, timestep) if isinstance(self.bn, TEBN) else self.bn(x)

    def _fire(self, current: torch.Tensor, mem: torch.Tensor):
        beta, theta = self.lif.beta.reshape(-1), self.lif.threshold.reshape(-1)
        if not self.learn_leak:
            beta = beta.detach()
        if not self.learn_thresh:
            theta = theta.detach()
        # new_full fills on the device: new_tensor would copy from the host
        theta = torch.maximum(theta, theta.new_full((), THRESH_MIN))
        spk, mem_out = leaky_step(
            current, mem, beta, theta,
            reset="zero" if self.hard_reset else "subtract",
        )
        if self.detach:
            mem_out = mem_out.detach()
        if self.mpbn is not None:
            mem_out = self.mpbn(mem_out)
        return spk, LIFState(mem_out, spk)

    def forward(self, x: torch.Tensor, state: Optional[LIFState] = None,
                timestep: Optional[int] = None):
        """``x [B, H, W, Cin]`` -> ``(spk [B, H, W, C], LIFState)``;
        ``timestep`` selects TEBN's scale."""
        ff = self._norm(conv_nhwc(x, self.ff, self.compute_dtype), timestep)
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

    def forward(self, x: torch.Tensor, state: Optional[LIFState] = None,
                timestep: Optional[int] = None):
        ff = conv_nhwc(x, self.ff, self.compute_dtype)
        if state is None:
            mem = prev_spk = torch.zeros_like(ff)
        else:
            mem, prev_spk = state
        total = ff + conv_nhwc(prev_spk, self.rec, self.compute_dtype)
        return self._fire(self._norm(total, timestep), mem)
