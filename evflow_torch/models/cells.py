"""Convolutional spiking LIF cells (port of ``evflow/models/cells.py``).

The snn.Leaky cells (``SNNConvLIF``, ``SNNConvLIFRecurrent``): conv3x3
(SAME, no bias) -> BatchNorm/TEBN (at the pass's ``timestep``) ->
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

The sigmoid-family cells (``ConvLIF``, ``ConvLIFRecurrent``): conv3x3 (no
bias; the feedforward cell's at ``stride``, padded k//2 on every side as
torch pads, where flax's "SAME" would shift the taps at stride 2) ->
``sigmoid_lif_step`` with a learnable per-channel
``leak`` (through a sigmoid) and ``thresh``, drawn from normal
distributions ``(mean, std)`` (the same ``leak: [0.0, 1.0]`` config key is
a uniform range in the snn family), a selectable surrogate
(``activation``, ``act_width``), the previous spikes detached in the reset
unless ``detach=False``; the membrane is not detached. ``residual`` is added
to the feedforward cell's output spikes. ``norm="group"`` normalises the
input (and, in the recurrent cell, the previous spikes its recurrent conv
reads) with flax's one-group GroupNorm (``models.norm.GroupNorm``). Their
state-dict names are the reference's: ``ff``, ``rec``, ``leak``,
``thresh`` (``[C, 1, 1]``), ``norm`` / ``norm_ff``, ``norm_rec``.

Quantization hooks, set as attributes (``FireNet.set_quant`` installs
them): ``conv_fake_quant(x, tag)`` on the conv input (tag "input") and on
each conv output before the norm (tag "output"); the recurrent conv's
spike input is not quantised. ``state_quant(u)`` on the membrane before
firing, in the snn family only.

f32 convs on the card run in full f32 (``full_f32_convs``) whatever the
process's TF32 flags: PyTorch lets cuDNN run f32 convs in TF32 by default,
whose 10 mantissa bits move membranes by ~1e-3 and flip spikes.

``conv_impl="dypack_int8"`` runs every 3x3 conv as the int8 dy-packed GEMM
of ``ops/dypack.py`` (per-tensor int8 weights, the input rounded to int8,
a bf16 output); the recurrent snn cell then sums ff and rec in one dual
GEMM, unless a conv quant hook is set. The other values (``auto``,
``im2col``, ``dypack``, ``lax``) compute the same f32 conv.
``state_dtype=torch.bfloat16`` (snn cells) casts the post-norm current,
``beta``, ``theta`` and the membrane to bf16 before ``leaky_step``, so the
spikes and membranes are bf16; a conv of a bf16 input (the next unit's)
then rounds its operands and its output to bf16, as flax's im2col conv in
the input's dtype does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evflow_torch.models.norm import MPBN, TEBN, BatchNorm, GroupNorm
from evflow_torch.ops.dypack import conv3x3_dypack, conv3x3_dypack_dual
from evflow_torch.ops.lif import THRESH_MIN, LIFState, leaky_step, sigmoid_lif_step

__all__ = ["SNNConvLIF", "SNNConvLIFRecurrent", "ConvLIF", "ConvLIFRecurrent", "conv_nhwc",
           "cell_conv", "full_f32_convs", "CONV_IMPLS"]


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
    """Conv of NHWC ``x`` at the conv's stride, padded by k//2 on every side
    (at stride 2 that is torch's ``padding=k//2``, not flax's "SAME"), in
    f32 (on the card in full f32, not TF32); with ``compute_dtype`` the
    operands are rounded to it first (exact products, f32 sums) and cuDNN's
    flags apply as they are. A bf16 ``x`` (bf16 state) computes so in bf16
    and rounds the output to bf16."""
    if x.dtype == torch.bfloat16:
        return conv_nhwc(x.float(), conv, compute_dtype or torch.bfloat16).to(torch.bfloat16)
    w, b = conv.weight, conv.bias
    f32 = (full_f32_convs() if x.is_cuda and compute_dtype is None
           else contextlib.nullcontext())
    if compute_dtype is not None:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
        b = b.to(compute_dtype).float() if b is not None else None
    with f32:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=conv.stride,
                     padding=conv.kernel_size[0] // 2)
    return y.permute(0, 2, 3, 1)


ConvQuant = Callable[[torch.Tensor, str], torch.Tensor]
StateQuant = Callable[[torch.Tensor], torch.Tensor]
CONV_IMPLS = ("auto", "im2col", "dypack", "dypack_int8", "lax")


def cell_conv(x: torch.Tensor, conv: nn.Conv2d, compute_dtype: Optional[torch.dtype],
              conv_impl: str) -> torch.Tensor:
    """The cell's conv of NHWC ``x``: the int8 dy-packed GEMM (bf16 out) for
    a stride-1 3x3 kernel under ``dypack_int8``, else ``conv_nhwc``."""
    if conv_impl == "dypack_int8" and conv.kernel_size[0] == 3 and conv.stride[0] == 1:
        return conv3x3_dypack(x, conv.weight)
    return conv_nhwc(x, conv, compute_dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """A conv without bias, padded by k//2, its weights from
    ``U(-sqrt(1/cin), +)``."""
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    w = math.sqrt(1.0 / cin)
    nn.init.uniform_(conv.weight, -w, w)
    return conv


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
                 learn_thresh: bool = True, detach: bool = True,
                 conv_fake_quant: Optional[ConvQuant] = None,
                 state_quant: Optional[StateQuant] = None, conv_impl: str = "auto",
                 state_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        self.ff = _conv(input_size, hidden_size, kernel_size)
        self.bn = TEBN(hidden_size, num_timesteps) if tebn else BatchNorm(hidden_size)
        self.lif = _LIFParams(hidden_size, leak, thresh)
        self.mpbn = MPBN(hidden_size) if mpbn else None
        self.hard_reset = hard_reset
        self.compute_dtype = compute_dtype
        self.learn_leak = learn_leak
        self.learn_thresh = learn_thresh
        self.detach = detach
        self.conv_fake_quant = conv_fake_quant
        self.state_quant = state_quant
        self.conv_impl = conv_impl
        self.state_dtype = state_dtype

    def _conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        return cell_conv(x, conv, self.compute_dtype, self.conv_impl)

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
        sdt = self.state_dtype
        if sdt is not None:
            current, mem = current.to(sdt), mem.to(sdt)
            beta, theta = beta.to(sdt), theta.to(sdt)
        spk, mem_out = leaky_step(
            current, mem, beta, theta,
            reset="zero" if self.hard_reset else "subtract",
            state_quant=self.state_quant,
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
        q = self.conv_fake_quant
        if q is not None:
            x = q(x, "input")
        ff = self._conv(x, self.ff)
        if q is not None:
            ff = q(ff, "output")
        ff = self._norm(ff, timestep)
        mem = torch.zeros_like(ff) if state is None else state.mem
        return self._fire(ff, mem)


class SNNConvLIFRecurrent(SNNConvLIF):
    """Recurrent cell: a conv over the previous spikes is added to the
    input current before the norm."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3, **kw):
        super().__init__(input_size, hidden_size, kernel_size, **kw)
        self.rec = _conv(hidden_size, hidden_size, kernel_size)

    def forward(self, x: torch.Tensor, state: Optional[LIFState] = None,
                timestep: Optional[int] = None):
        q = self.conv_fake_quant
        if q is not None:
            x = q(x, "input")
        if state is None:
            shape = x.shape[:-1] + (self.ff.out_channels,)
            mem = prev_spk = x.new_zeros(shape, dtype=torch.float32)
        else:
            mem, prev_spk = state
        if self.conv_impl == "dypack_int8" and self.ff.kernel_size[0] == 3 and q is None:
            # ff and rec in one int8 GEMM over one shared weight scale
            total = conv3x3_dypack_dual(x, prev_spk, self.ff.weight, self.rec.weight)
        else:
            ff, rec = self._conv(x, self.ff), self._conv(prev_spk, self.rec)
            if q is not None:
                ff, rec = q(ff, "output"), q(rec, "output")
            total = ff + rec
        return self._fire(self._norm(total, timestep), mem)


class ConvLIF(nn.Module):
    """Sigmoid-family feedforward cell: conv (at ``stride``), then
    ``sigmoid_lif_step``. ``norm="group"`` puts a one-group ``GroupNorm``
    (``norm``) on the input."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3,
                 activation: str = "arctanspike", act_width: float = 10.0,
                 leak: Tuple[float, float] = (-4.0, 0.1),
                 thresh: Tuple[float, float] = (0.8, 0.0), learn_leak: bool = True,
                 learn_thresh: bool = True, hard_reset: bool = True, detach: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 conv_fake_quant: Optional[ConvQuant] = None, conv_impl: str = "auto",
                 stride: int = 1, norm: Optional[str] = None):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        if norm not in (None, "group"):
            raise ValueError(f"norm must be None or 'group', got {norm!r}")
        self.ff = _conv(input_size, hidden_size, kernel_size, stride)
        if norm == "group":
            self._add_norms(input_size, hidden_size)
        self.leak = nn.Parameter(torch.empty(hidden_size, 1, 1).normal_(*leak))
        self.thresh = nn.Parameter(torch.empty(hidden_size, 1, 1).normal_(*thresh))
        self.activation = activation
        self.act_width = act_width
        self.learn_leak = learn_leak
        self.learn_thresh = learn_thresh
        self.hard_reset = hard_reset
        self.detach = detach
        self.compute_dtype = compute_dtype
        self.conv_fake_quant = conv_fake_quant
        self.conv_impl = conv_impl
        self.norm_type = norm

    def _add_norms(self, input_size: int, hidden_size: int):
        self.norm = GroupNorm(1, input_size)

    def _quant_conv(self, x: torch.Tensor, conv: nn.Conv2d, tag_input: bool) -> torch.Tensor:
        q = self.conv_fake_quant
        if q is not None and tag_input:
            x = q(x, "input")
        y = cell_conv(x, conv, self.compute_dtype, self.conv_impl)
        return q(y, "output") if q is not None else y

    def _fire(self, current: torch.Tensor, state: Optional[LIFState]):
        if state is None:
            v = z = torch.zeros_like(current)
        else:
            v, z = state
        leak, thresh = self.leak.reshape(-1), self.thresh.reshape(-1)
        if not self.learn_leak:
            leak = leak.detach()
        if not self.learn_thresh:
            thresh = thresh.detach()
        z_out, v_out = sigmoid_lif_step(
            current, v, z, leak, thresh, hard_reset=self.hard_reset,
            detach_reset=self.detach, activation=self.activation, act_width=self.act_width)
        return z_out, LIFState(v_out, z_out)

    def forward(self, x: torch.Tensor, state: Optional[LIFState] = None,
                timestep: Optional[int] = None, residual=0.0):
        """``x [B, H, W, Cin]`` -> ``(spikes + residual, LIFState)``;
        ``timestep`` is accepted and unused (no TEBN here)."""
        if self.norm_type == "group":
            x = self.norm(x.float())
        z_out, st = self._fire(self._quant_conv(x, self.ff, True).float(), state)
        if torch.is_tensor(residual) or residual != 0.0:
            z_out = z_out + residual
        return z_out, st


class ConvLIFRecurrent(ConvLIF):
    """Sigmoid-family recurrent cell: a conv over the previous spikes is
    added to the input current."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3, **kw):
        if kw.get("stride", 1) != 1:
            raise ValueError("the recurrent cell runs at stride 1")
        super().__init__(input_size, hidden_size, kernel_size, **kw)
        self.rec = _conv(hidden_size, hidden_size, kernel_size)

    def _add_norms(self, input_size: int, hidden_size: int):
        self.norm_ff = GroupNorm(1, input_size)
        self.norm_rec = GroupNorm(1, hidden_size)

    def forward(self, x: torch.Tensor, state: Optional[LIFState] = None,
                timestep: Optional[int] = None):
        """``norm="group"`` normalises the input (``norm_ff``) and the
        previous spikes the recurrent conv reads (``norm_rec``)."""
        if self.norm_type == "group":
            x = self.norm_ff(x.float())
        ff = self._quant_conv(x, self.ff, True)
        z = torch.zeros_like(ff) if state is None else state.spk
        if self.norm_type == "group":
            z = self.norm_rec(z.float())
        return self._fire((ff + self._quant_conv(z, self.rec, False)).float(), state)
