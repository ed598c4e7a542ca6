"""The UNet family (port of ``evflow/models/unet.py``): the spiking
recurrent multires UNet behind ``SpikingRecEVFlowNet``, and the ANN
UNets (``UNetRecurrent``, ``MultiResUNet``, ``MultiResUNetRecurrent``).

Encoder channel plan (base C, multiplier m, E encoders): inputs ``[C, mC,
..]``, outputs ``[mC, m^2 C, ..]``; the first encoder reads ``num_bins``
channels (the ANN ``UNetRecurrent`` reads its head's C). Decoders mirror
the encoders with skip-concat (2x channels) plus the previous multires
prediction (+2 channels after the first decoder), in the order ``[pred |
x | skip]``.

The spiking UNet's state is a flat tuple of ``LIFState`` (2 a recurrent
encoder, 2 a residual block, 1 a decoder: 16 slots at the default 4
encoders and 2 residual blocks), channels-last ``[B, H, W, C]`` at each
slot's resolution; ``SpikingRecEVFlowNet`` pads its input to a multiple
of ``2^E`` (``CropParameters``) and crops the flows back. Module names are
the reference's torch names (``multires_unetrec.encoders.{i}.conv`` and
``.recurrent_block``, ``resblocks.{i}.conv1``/``conv2``,
``decoders.{i}.conv2d``, ``preds.{i}.conv2d``), so a reference ``.pth``
loads as it is (its cells' ``act_width`` buffers are checked against the
model's and dropped) and ``evflow.utils.checkpoint.import_torch_checkpoint``
takes the port's state dict into flax.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evflow_torch.models.ann import (ConvLayer, RecurrentConvLayer, ResidualBlock,
                                     UpsampleConvLayer, upsample2x_bilinear)
from evflow_torch.models.cells import ConvLIF, ConvLIFRecurrent
from evflow_torch.models.firenet import activity_fractions, nonzero_normalize
from evflow_torch.ops.lif import LIFState

__all__ = ["optimal_crop_size", "CropParameters", "skip_concat", "skip_sum",
           "SpikingRecurrentConvLayer", "SpikingResidualBlock", "SpikingTransposedConvLayer",
           "SpikingUpsampleConvLayer", "SpikingMultiResUNetRecurrent", "SpikingRecEVFlowNet",
           "UNetRecurrent", "MultiResUNet", "MultiResUNetRecurrent", "upsample_nearest"]


def optimal_crop_size(max_size: int, max_subsample_factor: int, safety_margin: int = 0) -> int:
    """The least multiple of ``2^max_subsample_factor`` >= ``max_size``,
    plus ``safety_margin`` such steps."""
    crop = int(2 ** max_subsample_factor * math.ceil(max_size / 2 ** max_subsample_factor))
    return crop + safety_margin * 2 ** max_subsample_factor


class CropParameters:
    """Zero-pad an NHWC input to a ``2^E``-divisible size, and crop outputs
    back to the input's (the padded map's centre)."""

    def __init__(self, width: int, height: int, num_encoders: int, safety_margin: int = 0):
        self.height, self.width = height, width
        self.height_crop = optimal_crop_size(height, num_encoders, safety_margin)
        self.width_crop = optimal_crop_size(width, num_encoders, safety_margin)
        self.pad_top = math.ceil(0.5 * (self.height_crop - height))
        self.pad_bottom = math.floor(0.5 * (self.height_crop - height))
        self.pad_left = math.ceil(0.5 * (self.width_crop - width))
        self.pad_right = math.floor(0.5 * (self.width_crop - width))
        cx, cy = self.width_crop // 2, self.height_crop // 2
        self.ix0 = cx - math.floor(width / 2)
        self.ix1 = cx + math.ceil(width / 2)
        self.iy0 = cy - math.floor(height / 2)
        self.iy1 = cy + math.ceil(height / 2)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.pad_top or self.pad_bottom or self.pad_left or self.pad_right):
            return x
        return F.pad(x, (0, 0, self.pad_left, self.pad_right, self.pad_top, self.pad_bottom))

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.iy0:self.iy1, self.ix0:self.ix1, :]


def _pad_to(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    dy, dx = x2.shape[1] - x1.shape[1], x2.shape[2] - x1.shape[2]
    if not (dy or dx):
        return x1
    return F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def skip_concat(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``[x1 | x2]`` on the channels, ``x1`` zero-padded to ``x2``'s size."""
    return torch.cat([_pad_to(x1, x2), x2], dim=-1)


def skip_sum(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``x1 + x2``, ``x1`` zero-padded to ``x2``'s size."""
    return _pad_to(x1, x2) + x2


def upsample_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC ``x`` repeated to ``[B, height, width, C]`` (integer factors:
    ``jax.image.resize``'s "nearest", torch's ``nearest-exact``)."""
    fh, fw = height // x.shape[1], width // x.shape[2]
    if fh == fw == 1:
        return x
    return x.repeat_interleave(fh, dim=1).repeat_interleave(fw, dim=2)


class SpikingRecurrentConvLayer(nn.Module):
    """A strided ``ConvLIF`` (``conv``), then a ``ConvLIFRecurrent``
    (``recurrent_block``); two state slots."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3,
                 stride: int = 1, activation_ff: str = "arctanspike",
                 activation_rec: str = "arctanspike", cell_kwargs: Optional[dict] = None):
        super().__init__()
        kw = dict(cell_kwargs or {})
        self.conv = ConvLIF(input_size, hidden_size, kernel_size, stride=stride,
                            activation=activation_ff, **kw)
        self.recurrent_block = ConvLIFRecurrent(hidden_size, hidden_size, kernel_size,
                                                activation=activation_rec, **kw)

    def forward(self, x, states: Sequence[Optional[LIFState]]):
        x1, s_ff = self.conv(x, states[0])
        x2, s_rec = self.recurrent_block(x1, states[1])
        return x2, (s_ff, s_rec)


class SpikingResidualBlock(nn.Module):
    """Two ``ConvLIF`` (``conv1``, ``conv2``), the block's input spikes added
    to the second's output spikes; two state slots."""

    def __init__(self, input_size: int, hidden_size: int, stride: int = 1,
                 activation: str = "arctanspike", cell_kwargs: Optional[dict] = None):
        super().__init__()
        kw = dict(cell_kwargs or {})
        self.conv1 = ConvLIF(input_size, hidden_size, 3, stride=stride, activation=activation,
                             **kw)
        self.conv2 = ConvLIF(hidden_size, hidden_size, 3, activation=activation, **kw)

    def forward(self, x, states: Sequence[Optional[LIFState]]):
        x1, s1 = self.conv1(x, states[0])
        x2, s2 = self.conv2(x1, states[1], residual=x)
        return x2, (s1, s2)


class SpikingTransposedConvLayer(nn.Module):
    """The transposed spiking decoder layer: not implemented, as in the
    reference."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "SpikingTransposedConvLayer is not implemented (matches reference)")


class SpikingUpsampleConvLayer(nn.Module):
    """Bilinear x2, then a ``ConvLIF`` (``conv2d``); one state slot."""

    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3,
                 activation: str = "arctanspike", cell_kwargs: Optional[dict] = None):
        super().__init__()
        self.conv2d = ConvLIF(input_size, hidden_size, kernel_size, activation=activation,
                              **dict(cell_kwargs or {}))

    def forward(self, x, state: Optional[LIFState]):
        return self.conv2d(upsample2x_bilinear(x), state)


def _channel_plan(C: int, m: int, E: int) -> Tuple[List[int], List[int]]:
    return [int(C * m ** i) for i in range(E)], [int(C * m ** (i + 1)) for i in range(E)]


class SpikingMultiResUNetRecurrent(nn.Module):
    """The spiking recurrent UNet with multires predictions: E strided
    recurrent encoders, R residual blocks, E upsampling decoders, each
    followed by a 1x1 tanh flow head (``w_scale_pred``).
    ``forward(x, states)`` -> ``(predictions coarse to fine, new states)``."""

    def __init__(self, num_bins: int, base_num_channels: int = 32, num_encoders: int = 4,
                 num_residual_blocks: int = 2, num_output_channels: int = 2,
                 channel_multiplier: int = 2, kernel_size: int = 3, skip_type: str = "concat",
                 activations: Tuple[str, str] = ("arctanspike", "arctanspike"),
                 final_activation: Optional[str] = "tanh", w_scale_pred: Optional[float] = 0.01,
                 cell_kwargs: Optional[dict] = None):
        super().__init__()
        self.num_bins = num_bins
        self.base_num_channels = base_num_channels
        self.num_encoders = num_encoders
        self.num_residual_blocks = num_residual_blocks
        self.num_output_channels = num_output_channels
        self.skip_type = skip_type
        ins, outs = _channel_plan(base_num_channels, channel_multiplier, num_encoders)
        self.encoder_input_sizes, self.encoder_output_sizes = ins, outs
        act_ff, act_rec = activations
        kw = dict(cell_kwargs or {})
        self.encoders = nn.ModuleList(
            SpikingRecurrentConvLayer(num_bins if i == 0 else ins[i], outs[i], kernel_size,
                                      stride=2, activation_ff=act_ff, activation_rec=act_rec,
                                      cell_kwargs=kw)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(
            SpikingResidualBlock(outs[-1], outs[-1], activation=act_ff, cell_kwargs=kw)
            for _ in range(num_residual_blocks))
        dec_in, dec_out = list(reversed(outs)), list(reversed(ins))
        self.decoders = nn.ModuleList(
            SpikingUpsampleConvLayer(
                (cin if skip_type == "sum" else 2 * cin) + (0 if i == 0 else num_output_channels),
                cout, kernel_size, activation=act_ff, cell_kwargs=kw)
            for i, (cin, cout) in enumerate(zip(dec_in, dec_out)))
        self.preds = nn.ModuleList(
            ConvLayer(cout, num_output_channels, 1, activation=final_activation,
                      w_scale=w_scale_pred) for cout in dec_out)

    @property
    def num_states(self) -> int:
        return 3 * self.num_encoders + 2 * self.num_residual_blocks

    def forward(self, x: torch.Tensor, states: Optional[Sequence[Optional[LIFState]]] = None):
        if states is None:
            states = (None,) * self.num_states
        new_states = list(states)
        skip = skip_concat if self.skip_type == "concat" else skip_sum
        blocks = []
        si = 0
        for enc in self.encoders:
            x, (new_states[si], new_states[si + 1]) = enc(x, states[si:si + 2])
            si += 2
            blocks.append(x)
        for res in self.resblocks:
            x, (new_states[si], new_states[si + 1]) = res(x, states[si:si + 2])
            si += 2
        predictions = []
        E = self.num_encoders
        for i, (dec, pred) in enumerate(zip(self.decoders, self.preds)):
            x = skip(x, blocks[E - i - 1])
            if i > 0:
                x = skip(predictions[-1], x)
            x, new_states[si] = dec(x, states[si])
            si += 1
            predictions.append(pred(x))
        return predictions, tuple(new_states)


class SpikingRecEVFlowNet(nn.Module):
    """Spiking recurrent EV-FlowNet: input encoding selection, optional
    nonzero normalisation, pad to a ``2^E``-divisible size, the spiking
    multires UNet (sigmoid-family cells: ``leak``/``thresh`` normal inits,
    ``norm="group"`` puts GroupNorms on the cells' inputs), every multires
    flow nearest-upsampled to the finest scale and cropped back.

    ``forward(event_voxel, event_cnt, states, log=False, timestep=None)``
    -> ``({"flow": [4 flows [B, H, W, 2]], "activity": ...}, new_states)``;
    with ``log`` the activity is the padded input's fraction of nonzero
    elements (``{"0:input": ...}``), as in the reference package."""

    def __init__(self, num_bins: int = 2, base_num_channels: int = 32, kernel_size: int = 3,
                 encoding: str = "cnt", norm_input: bool = False, mask_output: bool = True,
                 norm: Optional[str] = None, use_upsample_conv: bool = True,
                 num_encoders: int = 4, num_residual_blocks: int = 2,
                 leak: Tuple[float, float] = (-4.0, 0.1), thresh: Tuple[float, float] = (0.8, 0.0),
                 learn_leak: bool = True, learn_thresh: bool = True, hard_reset: bool = True,
                 detach: bool = True):
        super().__init__()
        if encoding not in ("cnt", "voxel"):
            raise ValueError(f"Incorrect input encoding {encoding!r}")
        if encoding == "cnt" and num_bins != 2:
            raise ValueError(f"Incorrect input encoding {encoding!r} with num_bins={num_bins}")
        self.num_bins = num_bins
        self.base_num_channels = base_num_channels
        self.kernel_size = kernel_size
        self.encoding = encoding
        self.norm_input = norm_input
        self.mask_output = mask_output
        self.norm = norm
        self.use_upsample_conv = use_upsample_conv
        self.num_encoders = num_encoders
        self.num_residual_blocks = num_residual_blocks
        self.hard_reset = hard_reset
        self.act_width = 10.0
        self.multires_unetrec = SpikingMultiResUNetRecurrent(
            num_bins, base_num_channels, num_encoders, num_residual_blocks,
            kernel_size=kernel_size,
            cell_kwargs=dict(leak=leak, thresh=thresh, learn_leak=learn_leak,
                             learn_thresh=learn_thresh, hard_reset=hard_reset, detach=detach,
                             norm=norm))

    @property
    def num_states(self) -> int:
        return 3 * self.num_encoders + 2 * self.num_residual_blocks

    @property
    def unit_names(self) -> Tuple[str, ...]:
        """Each state slot's cell, in the flat state order."""
        names = []
        for i in range(self.num_encoders):
            names += [f"enc{i}.conv", f"enc{i}.rec"]
        for i in range(self.num_residual_blocks):
            names += [f"res{i}.c1", f"res{i}.c2"]
        return tuple(names + [f"dec{i}" for i in range(self.num_encoders)])

    @property
    def device(self) -> torch.device:
        return self.multires_unetrec.preds[0].conv2d.weight.device

    def state_shapes(self, batch: int, height: int, width: int) -> List[Tuple[int, ...]]:
        """Each slot's ``[B, h, w, C]`` at the padded resolution."""
        crop = CropParameters(width, height, self.num_encoders)
        h, w = crop.height_crop, crop.width_crop
        ins, outs = _channel_plan(self.base_num_channels, 2, self.num_encoders)
        shapes = []
        for c in outs:
            h, w = h // 2, w // 2
            shapes += [(batch, h, w, c)] * 2
        shapes += [(batch, h, w, outs[-1])] * (2 * self.num_residual_blocks)
        for c in reversed(ins):
            h, w = h * 2, w * 2
            shapes.append((batch, h, w, c))
        return shapes

    def init_states(self, batch: int, height: int, width: int) -> Tuple[LIFState, ...]:
        """Zero f32 states, one ``LIFState`` a slot (see ``state_shapes``)."""
        kw = dict(device=self.device, dtype=torch.float32)
        return tuple(LIFState(torch.zeros(s, **kw), torch.zeros(s, **kw))
                     for s in self.state_shapes(batch, height, width))

    def forward(self, event_voxel: Optional[torch.Tensor], event_cnt: Optional[torch.Tensor],
                states: Optional[Sequence[Optional[LIFState]]] = None, log: bool = False,
                timestep: Optional[int] = None):
        x = event_voxel if self.encoding == "voxel" else event_cnt
        if x is None:
            raise ValueError(f"the {self.encoding} input is None")
        x = x.float()
        if self.norm_input:
            x = nonzero_normalize(x)
        B, H, W, _ = x.shape
        crop = CropParameters(W, H, self.num_encoders)
        x = crop.pad(x)
        predictions, new_states = self.multires_unetrec(x, states)
        fh, fw = predictions[-1].shape[1:3]
        flows = [crop.crop(upsample_nearest(p, fh, fw)) for p in predictions]
        activity = activity_fractions({"0:input": x}) if log else None
        return {"flow": flows, "activity": activity}, new_states

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor], strict: bool = True,
                        assign: bool = False):
        """Load a port or reference state dict: the reference cells'
        ``act_width`` buffers must equal the model's surrogate width and are
        dropped; ``[C]`` leak/threshold vectors take the model's ``[C, 1, 1]``."""
        from evflow_torch.weights import to_port_layout

        sd = dict(state_dict)
        for key in [k for k in sd if k.endswith(".act_width")]:
            width = float(torch.as_tensor(sd.pop(key)))
            if width != self.act_width:
                raise ValueError(f"{key} = {width}: the model's surrogate width is "
                                 f"{self.act_width}")
        return super().load_state_dict(to_port_layout(sd, self), strict=strict, assign=assign)


class UNetRecurrent(nn.Module):
    """ANN recurrent UNet: a head conv, E strided recurrent encoders
    (``convlstm``/``convgru``/``convrnn``), R residual blocks, E upsampling
    decoders, one full-resolution prediction over ``[x | head]``.
    ``forward(x, states)`` -> ``(prediction, new states)``."""

    def __init__(self, num_bins: int, base_num_channels: int = 32, num_encoders: int = 4,
                 num_residual_blocks: int = 2, num_output_channels: int = 1,
                 channel_multiplier: int = 2, kernel_size: int = 5, skip_type: str = "concat",
                 recurrent_block_type: str = "convlstm", norm: Optional[str] = None,
                 final_activation: Optional[str] = None):
        super().__init__()
        self.num_encoders = num_encoders
        self.skip_type = skip_type
        C, k = base_num_channels, kernel_size
        ins, outs = _channel_plan(C, channel_multiplier, num_encoders)
        cat = 1 if skip_type == "sum" else 2
        self.head = ConvLayer(num_bins, C, k, 1)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(ins[i], outs[i], k, stride=2,
                               recurrent_block_type=recurrent_block_type, norm=norm)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(ResidualBlock(outs[-1], outs[-1], norm=norm)
                                       for _ in range(num_residual_blocks))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(cat * cin, cout, k, norm=norm)
            for cin, cout in zip(reversed(outs), reversed(ins)))
        self.pred = ConvLayer(cat * C, num_output_channels, 1, activation=final_activation)

    def forward(self, x: torch.Tensor, states=None):
        E = self.num_encoders
        if states is None:
            states = (None,) * E
        new_states = list(states)
        skip = skip_concat if self.skip_type == "concat" else skip_sum
        x = self.head(x.float())
        head = x
        blocks = []
        for i, enc in enumerate(self.encoders):
            x, new_states[i] = enc(x, states[i])
            blocks.append(x)
        for res in self.resblocks:
            x, _ = res(x)
        for i, dec in enumerate(self.decoders):
            x = dec(skip(x, blocks[E - i - 1]))
        return self.pred(skip(x, head)), tuple(new_states)


class _MultiResDecoders(nn.Module):
    """The multires decoder stack shared by the two ANN multires UNets."""

    def _build_decoders(self, ins, outs, kernel_size, norm, num_output_channels,
                        final_activation):
        cat = 1 if self.skip_type == "sum" else 2
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(cat * cin + (0 if i == 0 else num_output_channels), cout,
                              kernel_size, norm=norm)
            for i, (cin, cout) in enumerate(zip(reversed(outs), reversed(ins))))
        self.preds = nn.ModuleList(
            ConvLayer(cout, num_output_channels, 1, activation=final_activation)
            for cout in reversed(ins))

    def _decode(self, x, blocks):
        skip = skip_concat if self.skip_type == "concat" else skip_sum
        E = self.num_encoders
        predictions = []
        for i, (dec, pred) in enumerate(zip(self.decoders, self.preds)):
            x = skip(x, blocks[E - i - 1])
            if i > 0:
                x = skip(predictions[-1], x)
            x = dec(x)
            predictions.append(pred(x))
        return predictions


class MultiResUNet(_MultiResDecoders):
    """ANN (non-recurrent) UNet with multires predictions: E strided
    ``ConvLayer`` encoders, R residual blocks, E upsampling decoders each
    with its flow head. ``forward(x)`` -> predictions, coarse to fine."""

    def __init__(self, num_bins: int, base_num_channels: int = 32, num_encoders: int = 4,
                 num_residual_blocks: int = 2, num_output_channels: int = 2,
                 channel_multiplier: int = 2, kernel_size: int = 3, skip_type: str = "concat",
                 norm: Optional[str] = None, final_activation: Optional[str] = None):
        super().__init__()
        self.num_encoders = num_encoders
        self.skip_type = skip_type
        ins, outs = _channel_plan(base_num_channels, channel_multiplier, num_encoders)
        self.encoders = nn.ModuleList(
            ConvLayer(num_bins if i == 0 else ins[i], outs[i], kernel_size, 2, norm=norm)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(ResidualBlock(outs[-1], outs[-1], norm=norm)
                                       for _ in range(num_residual_blocks))
        self._build_decoders(ins, outs, kernel_size, norm, num_output_channels,
                             final_activation)

    def forward(self, x: torch.Tensor):
        x = x.float()
        blocks = []
        for enc in self.encoders:
            x = enc(x)
            blocks.append(x)
        for res in self.resblocks:
            x, _ = res(x)
        return self._decode(x, blocks)


class MultiResUNetRecurrent(_MultiResDecoders):
    """ANN recurrent UNet with multires predictions: E strided recurrent
    encoders, R residual blocks, E upsampling decoders with tanh flow heads.
    ``forward(x, states)`` -> ``(predictions, new states)``."""

    def __init__(self, num_bins: int, base_num_channels: int = 32, num_encoders: int = 4,
                 num_residual_blocks: int = 2, num_output_channels: int = 2,
                 channel_multiplier: int = 2, kernel_size: int = 3, skip_type: str = "concat",
                 recurrent_block_type: str = "convlstm", norm: Optional[str] = None,
                 final_activation: Optional[str] = "tanh"):
        super().__init__()
        self.num_encoders = num_encoders
        self.skip_type = skip_type
        ins, outs = _channel_plan(base_num_channels, channel_multiplier, num_encoders)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(num_bins if i == 0 else ins[i], outs[i], kernel_size, stride=2,
                               recurrent_block_type=recurrent_block_type, norm=norm)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(ResidualBlock(outs[-1], outs[-1], norm=norm)
                                       for _ in range(num_residual_blocks))
        self._build_decoders(ins, outs, kernel_size, norm, num_output_channels,
                             final_activation)

    def forward(self, x: torch.Tensor, states=None):
        if states is None:
            states = (None,) * self.num_encoders
        new_states = list(states)
        x = x.float()
        blocks = []
        for i, enc in enumerate(self.encoders):
            x, new_states[i] = enc(x, states[i])
            blocks.append(x)
        for res in self.resblocks:
            x, _ = res(x)
        return self._decode(x, blocks), tuple(new_states)
