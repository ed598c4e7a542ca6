"""Non-spiking (ANN) layers (port of ``evflow/models/ann.py``): conv
layers, the recurrent conv blocks (ConvLSTM, ConvGRU, a conv RNN), the
upsampling decoder layers and the residual block. Channels-last ``[B, H,
W, C]`` at the interface like the reference package; the convolutions run
on ``permute``d NCHW views, in full f32 on the card (``conv_nhwc``).
Submodule names are the reference's torch names (``conv2d``,
``norm_layer``, ``transposed_conv2d``, ``Gates``, ``update_gate``,
``reset_gate``, ``out_gate``, ``ff``, ``rec``, ``out``, ``conv``,
``recurrent_block``, ``conv1``, ``bn1``, ``conv2``, ``bn2``).

Norms follow flax: ``"BN"`` is ``models.norm.BatchNorm`` (running
statistics in eval mode, flax's update in training mode; the conv then has
no bias), ``"IN"`` a ``GroupNorm`` with one channel a group and affine
parameters (eps 1e-6), which only ``ConvLayer`` applies, as in the
reference package. Every conv pads by k//2 on each side: at stride 2 that
is torch's ``padding=k//2``, not flax's "SAME".
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evflow_torch.models.cells import conv_nhwc, full_f32_convs
from evflow_torch.models.norm import BatchNorm, GroupNorm

__all__ = ["ConvLayer", "ConvLayerStateful", "TransposedConvLayer", "UpsampleConvLayer",
           "RecurrentConvLayer", "ResidualBlock", "ConvLSTM", "ConvGRU", "ConvRecurrent",
           "get_activation", "upsample2x_bilinear"]

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}


def get_activation(name: Optional[str]) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The activation of ``name`` (relu, tanh, sigmoid), None for None or
    "none"; an unknown name raises ``KeyError``."""
    if name is None or name == "none":
        return None
    try:
        return ACTIVATIONS[name]
    except KeyError as e:
        raise KeyError(f"Unknown activation {name!r}") from e


def _norm(norm: Optional[str], features: int, allow_in: bool = False) -> Optional[nn.Module]:
    if norm == "BN":
        return BatchNorm(features)
    if norm == "IN" and allow_in:
        return GroupNorm(features, features)
    return None


def _conv2d(cin: int, cout: int, k: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of NHWC ``x``: half-pixel centres, edges clamped (torch
    ``align_corners=False``, which is ``jax.image.resize``'s "bilinear")."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class ConvLayer(nn.Module):
    """Conv (bias unless ``norm="BN"``) + optional norm + activation, f32
    out. ``w_scale`` draws the weights from U(-w_scale, w_scale) with zero
    bias (the flow heads use 0.01). With ``compute_dtype`` the conv's
    operands are rounded to it. ``conv_fake_quant(x, tag)``, if set,
    quantises the conv's input ("input") and its output before the norm
    ("output"). A bf16 input (bf16 state) is widened to f32 first, as flax
    promotes it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, activation: Optional[str] = "relu",
                 norm: Optional[str] = None, w_scale: Optional[float] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 conv_fake_quant: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None):
        super().__init__()
        self.conv2d = _conv2d(in_channels, out_channels, kernel_size, stride, bias=norm != "BN")
        if w_scale is not None:
            nn.init.uniform_(self.conv2d.weight, -w_scale, w_scale)
            nn.init.zeros_(self.conv2d.bias)
        self.norm_layer = _norm(norm, out_channels, allow_in=True)
        self.act = get_activation(activation)
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
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        return out if self.act is None else self.act(out)


class ConvLayerStateful(nn.Module):
    """``ConvLayer`` with the cells' call: ``(x, prev_state, residual)`` ->
    ``(act(conv(x) [+ BN] + residual), prev_state or a 0-d zero)``, so it
    can stand in for a spiking cell."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv2d = _conv2d(in_channels, out_channels, kernel_size, stride, bias=norm != "BN")
        self.norm_layer = _norm(norm, out_channels)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, prev_state=None, residual=0.0):
        out = conv_nhwc(x, self.conv2d)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        out = out + residual
        if self.act is not None:
            out = self.act(out)
        return out, (prev_state if prev_state is not None else out.new_zeros(()))


class TransposedConvLayer(nn.Module):
    """Transposed conv x2 (``ConvTranspose2d(stride=2, padding=k//2,
    output_padding=1)``: the output is exactly twice the input) + optional
    BN + activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 activation: Optional[str] = "relu", norm: Optional[str] = None):
        super().__init__()
        self.transposed_conv2d = nn.ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride=2, padding=kernel_size // 2,
            output_padding=1, bias=norm != "BN")
        self.norm_layer = _norm(norm, out_channels)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.transposed_conv2d
        with full_f32_convs() if x.is_cuda else contextlib.nullcontext():
            out = F.conv_transpose2d(x.permute(0, 3, 1, 2), t.weight, t.bias, stride=2,
                                     padding=t.padding, output_padding=1)
        out = out.permute(0, 2, 3, 1)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        return out if self.act is None else self.act(out)


class UpsampleConvLayer(nn.Module):
    """Bilinear x2, then conv (stride 1) + optional BN + activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 activation: Optional[str] = "relu", norm: Optional[str] = None):
        super().__init__()
        self.conv2d = _conv2d(in_channels, out_channels, kernel_size, bias=norm != "BN")
        self.norm_layer = _norm(norm, out_channels)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_nhwc(upsample2x_bilinear(x), self.conv2d)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        return out if self.act is None else self.act(out)


class ConvLSTM(nn.Module):
    """Convolutional LSTM cell; state ``(hidden, cell)``, zeros when None.
    One conv (``Gates``) over ``[x | hidden]`` gives the input, remember,
    output and cell gates, in that order."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.Gates = _conv2d(input_size + hidden_size, 4 * hidden_size, kernel_size)

    def forward(self, x: torch.Tensor, state: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        if state is None:
            shape = x.shape[:-1] + (self.hidden_size,)
            prev_hidden = prev_cell = x.new_zeros(shape)
        else:
            prev_hidden, prev_cell = state
        gates = conv_nhwc(torch.cat([x, prev_hidden], dim=-1), self.Gates)
        in_g, rem_g, out_g, cell_g = gates.chunk(4, dim=-1)
        cell = torch.sigmoid(rem_g) * prev_cell + torch.sigmoid(in_g) * torch.tanh(cell_g)
        hidden = torch.sigmoid(out_g) * torch.tanh(cell)
        return hidden, (hidden, cell)


class ConvGRU(nn.Module):
    """Convolutional GRU cell (orthogonal init, zero bias); state zeros when
    None."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        for name in ("reset_gate", "update_gate", "out_gate"):
            conv = _conv2d(input_size + hidden_size, hidden_size, kernel_size)
            nn.init.orthogonal_(conv.weight)
            nn.init.zeros_(conv.bias)
            self.add_module(name, conv)

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor]):
        if state is None:
            state = x.new_zeros(x.shape[:-1] + (self.hidden_size,))
        stacked = torch.cat([x, state], dim=-1)
        update = torch.sigmoid(conv_nhwc(stacked, self.update_gate))
        reset = torch.sigmoid(conv_nhwc(stacked, self.reset_gate))
        out = torch.tanh(conv_nhwc(torch.cat([x, state * reset], dim=-1), self.out_gate))
        new_state = state * (1.0 - update) + out * update
        return new_state, new_state


class ConvRecurrent(nn.Module):
    """Conv RNN cell: ``s' = tanh(ff(x) + rec(s))``, out ``relu(out(s'))``."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        self.hidden_size = hidden_size
        self.ff = _conv2d(input_size, hidden_size, kernel_size)
        self.rec = _conv2d(hidden_size, hidden_size, kernel_size)
        self.out = _conv2d(hidden_size, hidden_size, kernel_size)

    def forward(self, x: torch.Tensor, state: Optional[torch.Tensor]):
        if state is None:
            state = x.new_zeros(x.shape[:-1] + (self.hidden_size,))
        new_state = torch.tanh(conv_nhwc(x, self.ff) + conv_nhwc(state, self.rec))
        return torch.relu(conv_nhwc(new_state, self.out)), new_state


_RECURRENT = {"convlstm": ConvLSTM, "convgru": ConvGRU, "convrnn": ConvRecurrent}


class RecurrentConvLayer(nn.Module):
    """``ConvLayer`` (``conv``, at ``stride``) + a 3x3 recurrent block
    (``recurrent_block``: ``convlstm``, ``convgru`` or ``convrnn``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, recurrent_block_type: str = "convlstm",
                 activation_ff: Optional[str] = "relu", norm: Optional[str] = None):
        super().__init__()
        if recurrent_block_type not in _RECURRENT:
            raise ValueError(f"Unknown recurrent_block_type {recurrent_block_type!r}")
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride,
                              activation=activation_ff, norm=norm)
        self.recurrent_block = _RECURRENT[recurrent_block_type](out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor, state):
        return self.recurrent_block(self.conv(x), state)


class ResidualBlock(nn.Module):
    """Two 3x3 convs (the first at ``stride``), optional BN after each, the
    input added before the second activation; returns ``(out, out1)``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 activation: Optional[str] = "relu", norm: Optional[str] = None):
        super().__init__()
        bias = norm != "BN"
        self.conv1 = _conv2d(in_channels, out_channels, 3, stride, bias=bias)
        self.bn1 = _norm(norm, out_channels)
        self.conv2 = _conv2d(out_channels, out_channels, 3, bias=bias)
        self.bn2 = _norm(norm, out_channels)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor):
        out1 = conv_nhwc(x, self.conv1)
        if self.bn1 is not None:
            out1 = self.bn1(out1)
        if self.act is not None:
            out1 = self.act(out1)
        out2 = conv_nhwc(out1, self.conv2)
        if self.bn2 is not None:
            out2 = self.bn2(out2)
        out2 = out2 + x
        if self.act is not None:
            out2 = self.act(out2)
        return out2, out1

