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

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from evflow_torch.models.ann import ConvLayer
from evflow_torch.models.cells import SNNConvLIF, SNNConvLIFRecurrent
from evflow_torch.ops.lif import LIFState

__all__ = ["FireNet", "nonzero_normalize", "activity_fractions"]


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
    """FireNet family with snn.Leaky cells (``cell_family="snn"``).

    ``forward(event_voxel, event_cnt, states, log=False)`` runs one event
    window and returns ``({"flow": [flow [B, H, W, 2]], "activity": ...},
    new_states)``; with ``log`` the activity is each layer's fraction of
    nonzero activations (``activity_fractions`` of the input, every unit's
    spikes and the flow, keyed ``"<i>:<name>"``), else None. ``compute_dtype``
    (e.g. ``torch.bfloat16``) runs the convolutions in that type while the
    LIF state stays f32.
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
                 w_scale_pred: float = 0.01):
        super().__init__()
        if cell_family != "snn":
            raise NotImplementedError(
                f"cell_family {cell_family!r}: only the snn.Leaky cells are ported")
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

        C = base_num_channels
        common = dict(kernel_size=kernel_size, leak=leak, thresh=thresh,
                      hard_reset=hard_reset, tebn=tebn, num_timesteps=num_timesteps,
                      mpbn=mpbn, compute_dtype=compute_dtype)
        mid = SNNConvLIFRecurrent if recurrent else SNNConvLIF
        for name in self.unit_names:
            cls = mid if name in ("G1", "G2") else SNNConvLIF
            cin = num_bins if name == "head" else C
            self.add_module(name, cls(cin, C, **common))
        self.pred = ConvLayer(C, 2, kernel_size=1, w_scale=w_scale_pred,
                              compute_dtype=compute_dtype)

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
        """Zero f32 state, one ``LIFState`` per unit, ``[B, H, W, C]``."""
        shape = (batch, height, width, self.base_num_channels)
        return tuple(
            LIFState(torch.zeros(shape, device=self.device),
                     torch.zeros(shape, device=self.device))
            for _ in range(self.num_units))

    def forward(self, event_voxel: Optional[torch.Tensor],
                event_cnt: Optional[torch.Tensor],
                states: Optional[Sequence[Optional[LIFState]]] = None, log: bool = False):
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
            h, s = getattr(self, name)(h, st)
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
