"""FireNet model family: LIFFireNet / LIFFireFlowNet (+ ``_short``) (port of
``evflow/models/firenet.py``).

head -> G1(rec) -> R1a -> R1b -> G2(rec) -> R2a -> R2b -> pred (1x1 conv,
tanh, w_scale 0.01). ``short`` drops R1b/R2b (5 stateful units);
``recurrent=False`` (the FlowNet variants) makes G1/G2 feedforward. The
model is a step function over an explicit state tuple, one ``LIFState`` per
unit, channels-last ``[B, H, W, C]`` like the reference package so the two
compare like with like. Module names follow the reference's torch state
dict, so reference ``.pth`` files load as they are (``load_state_dict``
also accepts the PTQ layout, see ``evflow_torch.weights``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from evflow_torch.models.ann import ConvLayer
from evflow_torch.models.cells import (ConvLIF, ConvLIFRecurrent, SNNConvLIF,
                                       SNNConvLIFRecurrent)
from evflow_torch.ops.lif import LIFState

__all__ = ["FireNet", "nonzero_normalize", "activity_fractions", "QUANT_HOOKS"]

QUANT_HOOKS = ("state_quant", "state_quant_per_layer", "conv_fake_quant",
               "conv_fake_quant_per_layer")


def nonzero_normalize(x: torch.Tensor) -> torch.Tensor:
    """Normalise the nonzero elements to zero mean / unit std over the whole
    tensor (torch ``.std()`` is unbiased)."""
    mask = (x != 0).to(x.dtype)
    n = mask.sum()
    mean = (x * mask).sum() / torch.clamp(n, min=1.0)
    var = (mask * (x - mean) ** 2).sum() / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(var)
    return torch.where(mask > 0, (x - mean) / torch.clamp(std, min=1e-12), x)


def activity_fractions(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each tensor's fraction of nonzero elements (a 0-d f32 tensor)."""
    return {k: (v != 0).float().mean() for k, v in tensors.items()}


class FireNet(nn.Module):
    """FireNet family: snn.Leaky cells (``cell_family="snn"``) or the
    sigmoid-family cells (``"sigmoid"``, with the surrogate ``activation``
    and its ``act_width``).

    ``forward(event_voxel, event_cnt, states, log=False, timestep=None)``
    runs one event window and returns ``({"flow": [flow [B, H, W, 2]],
    "activity": ...}, new_states)``; ``timestep`` is the pass's index into
    TEBN's per-timestep scales (the trainer's ``p % T``), and in
    ``.train()`` mode the norms use batch statistics and update their
    running ones. With ``log`` the activity is each layer's fraction of
    nonzero activations (``activity_fractions`` of the input, every unit's
    spikes and the flow, keyed ``"<i>:<name>"``), else None. ``compute_dtype``
    (e.g. ``torch.bfloat16``) runs the convolutions in that type while the
    LIF state stays f32. ``conv_impl="dypack_int8"`` runs the units' 3x3
    convs as int8 dy-packed GEMMs; ``state_dtype=torch.bfloat16`` carries
    bf16 membranes and spikes in the snn family (see ``models.cells``). The
    sigmoid family keeps f32 state: the reference's starts from bf16 zeros
    and computes the same f32 values from its first step on.

    Quantization hooks (``evflow_torch.quant.fake_quant``): ``state_quant``
    on every snn unit's membrane, or ``state_quant_per_layer`` (one per
    unit, None for none); ``conv_fake_quant`` on every conv's input and
    outputs, or ``conv_fake_quant_per_layer`` (one per unit, then one for
    the pred head, index ``num_units``). The per-layer forms win. The
    sigmoid family takes no state quant. ``set_quant`` changes them on a
    built model.
    """

    def __init__(self, num_bins: int = 2, base_num_channels: int = 32,
                 kernel_size: int = 3, encoding: str = "cnt",
                 norm_input: bool = False, mask_output: bool = True,
                 recurrent: bool = True, short: bool = False,
                 cell_family: str = "snn",
                 leak: Tuple[float, float] = (0.0, 1.0),
                 thresh: Tuple[float, float] = (0.0, 0.8),
                 hard_reset: bool = True, tebn: bool = False,
                 num_timesteps: int = 4, mpbn: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 w_scale_pred: float = 0.01, learn_leak: bool = True,
                 learn_thresh: bool = True, detach: bool = True,
                 activation: str = "arctanspike", act_width: float = 10.0,
                 state_quant: Optional[Callable] = None,
                 state_quant_per_layer: Optional[Sequence[Optional[Callable]]] = None,
                 conv_fake_quant: Optional[Callable] = None,
                 conv_fake_quant_per_layer: Optional[Sequence[Optional[Callable]]] = None,
                 conv_impl: str = "auto", state_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cell_family not in ("snn", "sigmoid"):
            raise ValueError(f"Unknown cell_family {cell_family!r}")
        if encoding == "cnt" and num_bins != 2:
            raise ValueError(f"cnt encoding needs num_bins=2, got {num_bins}")
        if encoding not in ("cnt", "voxel"):
            raise ValueError(f"unknown encoding {encoding!r}")
        self.num_bins = num_bins
        self.base_num_channels = base_num_channels
        self.encoding = encoding
        self.norm_input = norm_input
        self.mask_output = mask_output
        self.recurrent = recurrent
        self.short = short
        self.cell_family = cell_family
        self.hard_reset = hard_reset
        self.tebn = tebn
        self.mpbn = mpbn
        self.compute_dtype = compute_dtype
        self.num_timesteps = num_timesteps
        self.conv_impl = conv_impl
        self.state_dtype = state_dtype if cell_family == "snn" else None

        C = base_num_channels
        common = dict(kernel_size=kernel_size, leak=leak, thresh=thresh,
                      hard_reset=hard_reset, compute_dtype=compute_dtype,
                      learn_leak=learn_leak, learn_thresh=learn_thresh, detach=detach,
                      conv_impl=conv_impl)
        if cell_family == "snn":
            common.update(tebn=tebn, num_timesteps=num_timesteps, mpbn=mpbn,
                          state_dtype=state_dtype)
            ff_cell, rec_cell = SNNConvLIF, SNNConvLIFRecurrent
        else:
            common.update(activation=activation, act_width=act_width)
            ff_cell, rec_cell = ConvLIF, ConvLIFRecurrent
        mid = rec_cell if recurrent else ff_cell
        for name in self.unit_names:
            cls = mid if name in ("G1", "G2") else ff_cell
            cin = num_bins if name == "head" else C
            self.add_module(name, cls(cin, C, **common))
        self.pred = ConvLayer(C, 2, kernel_size=1, activation="tanh", w_scale=w_scale_pred,
                              compute_dtype=compute_dtype)
        self.set_quant(state_quant=state_quant, state_quant_per_layer=state_quant_per_layer,
                       conv_fake_quant=conv_fake_quant,
                       conv_fake_quant_per_layer=conv_fake_quant_per_layer)

    def set_quant(self, **hooks) -> "FireNet":
        """Set any of the four quantization hooks (keywords as in the
        constructor; the others keep theirs) and install each unit's and
        the pred head's; returns the model."""
        for key, hook in hooks.items():
            if key not in QUANT_HOOKS:
                raise TypeError(f"unknown quantization hook {key!r}")
            per_layer = key.endswith("_per_layer") and hook is not None
            setattr(self, key, tuple(hook) if per_layer else hook)
        for i, name in enumerate(self.unit_names):
            cell = getattr(self, name)
            cell.conv_fake_quant = self._layer_conv_quant(i)
            if self.cell_family == "snn":
                cell.state_quant = self._layer_quant(i)
        self.pred.conv_fake_quant = self._layer_conv_quant(self.num_units)
        return self

    @property
    def quant_hooks(self) -> Tuple[str, ...]:
        """The names of the quantization hooks that are set."""
        return tuple(k for k in QUANT_HOOKS if getattr(self, k) is not None
                     and (not k.endswith("_per_layer") or any(getattr(self, k))))

    def _layer_quant(self, idx: int):
        if self.state_quant_per_layer is not None:
            return self.state_quant_per_layer[idx]
        return self.state_quant

    def _layer_conv_quant(self, idx: int):
        """Conv quant hook of unit ``idx`` (``idx == num_units``: pred)."""
        if self.conv_fake_quant_per_layer is not None:
            return self.conv_fake_quant_per_layer[idx]
        return self.conv_fake_quant

    @property
    def num_units(self) -> int:
        return 5 if self.short else 7

    @property
    def unit_names(self) -> Tuple[str, ...]:
        if self.short:
            return ("head", "G1", "R1a", "G2", "R2a")
        return ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b")

    @property
    def device(self) -> torch.device:
        return self.pred.conv2d.weight.device

    def init_states(self, batch: int, height: int, width: int) -> Tuple[LIFState, ...]:
        """Zero state (f32, or ``state_dtype``), one ``LIFState`` per unit,
        ``[B, H, W, C]``."""
        shape = (batch, height, width, self.base_num_channels)
        kw = dict(device=self.device, dtype=self.state_dtype or torch.float32)
        return tuple(LIFState(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                     for _ in range(self.num_units))

    def forward(self, event_voxel: Optional[torch.Tensor],
                event_cnt: Optional[torch.Tensor],
                states: Optional[Sequence[Optional[LIFState]]] = None, log: bool = False,
                timestep: Optional[int] = None):
        x = event_voxel if self.encoding == "voxel" else event_cnt
        if x is None:
            raise ValueError(f"the {self.encoding} input is None")
        x = x.float()
        if self.norm_input:
            x = nonzero_normalize(x)
        if states is None:
            states = (None,) * self.num_units
        new_states = []
        taps = {"0:input": x}
        h = x
        for i, (name, st) in enumerate(zip(self.unit_names, states)):
            h, s = getattr(self, name)(h, st, timestep=timestep)
            new_states.append(s)
            taps[f"{i + 1}:{name}"] = h
        flow = self.pred(h)
        taps[f"{self.num_units + 1}:pred"] = flow
        activity = activity_fractions(taps) if log else None
        return {"flow": [flow], "activity": activity}, tuple(new_states)

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor],
                        strict: bool = True, assign: bool = False):
        """Load a port or reference state dict; the reference's PTQ layout
        (``head.beta`` for ``head.lif.beta``) is accepted as well."""
        from evflow_torch.weights import to_port_layout

        return super().load_state_dict(to_port_layout(state_dict, self),
                                       strict=strict, assign=assign)
