"""FusedFireNet: the inference FireNet on the fused conv+LIF kernels (port of
``evflow/models/fused.py``).

``from_firenet`` folds a port ``FireNet`` (BN running statistics, TEBN's
mean over p) into per-unit kernel operands; ``step`` then runs one fused
kernel per unit (``fused_conv_lif`` for ``layout="nhwc"``,
``fused_conv_lif_cmajor`` for ``layout="cmajor"``, whose states are
``[B, C, H, W]``) and the 1x1 pred conv + tanh as a plain matmul.

``from_firenet`` refuses the settings under which the fused step would
compute another function than ``FireNet``: input normalisation
(``norm_input``), membrane BN (``mpbn``), cells other than snn.Leaky,
quantization hooks (``FireNet.quant_hooks``: the fused kernels run f32
convs and membranes, so a quantised model runs unfused), bf16 state
(``state_dtype``) and int8 convs (``conv_impl="dypack_int8"``). The
reference's ``FusedFireNet`` ignores the last two and computes another
function (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from evflow_torch.ops.conv_lif import fold_bn, fused_conv_lif, pack_weights
from evflow_torch.ops.conv_lif_cmajor import fused_conv_lif_cmajor
from evflow_torch.ops.lif import THRESH_MIN, LIFState

__all__ = ["FusedFireNet"]

_BN_EPS = 1e-5


class _Unit(NamedTuple):
    name: str
    recurrent: bool


class FusedFireNet:
    """Inference FireNet over folded, packed parameter tensors.

    Build with ``FusedFireNet.from_firenet(model, layout=...)``; run with
    ``step(x, states)`` or ``scan_windows(windows, states)``. Input and
    flow are NHWC whatever the layout.
    """

    def __init__(self, units: Sequence[_Unit], params: Dict[str, Dict[str, torch.Tensor]],
                 base_num_channels: int, num_bins: int, encoding: str,
                 hard_reset: bool = True, layout: str = "nhwc"):
        if layout not in ("nhwc", "cmajor"):
            raise ValueError(f"layout must be 'nhwc' or 'cmajor', got {layout!r}")
        self.units = tuple(units)
        self.params = params
        self.base_num_channels = base_num_channels
        self.num_bins = num_bins
        self.encoding = encoding
        self.hard_reset = hard_reset
        self.layout = layout

    @classmethod
    @torch.no_grad()
    def from_firenet(cls, model, layout: str = "nhwc") -> "FusedFireNet":
        """Fold a port ``FireNet`` (eval statistics) into fused form."""
        from evflow_torch.models.firenet import FireNet

        if not isinstance(model, FireNet):
            raise ValueError(f"FusedFireNet folds a FireNet, got {type(model).__name__}")
        if model.cell_family != "snn":
            raise ValueError("FusedFireNet runs snn.Leaky cells only, got "
                             f"cell_family={model.cell_family!r}")
        hooks = getattr(model, "quant_hooks", ())
        if hooks:
            raise ValueError(f"FusedFireNet runs no fake quantization; a FireNet with "
                             f"{', '.join(hooks)} set computes another function")
        if model.norm_input:
            raise ValueError("FusedFireNet does not normalise its input; a "
                             "norm_input=True FireNet computes another function")
        if model.mpbn:
            raise ValueError("FusedFireNet has no membrane BN; an mpbn=True "
                             "FireNet computes another function")
        if model.state_dtype is not None:
            raise ValueError(f"FusedFireNet carries f32 membranes; a FireNet with "
                             f"state_dtype={model.state_dtype} computes another function")
        if model.conv_impl == "dypack_int8":
            raise ValueError("FusedFireNet runs f32 convs; a conv_impl='dypack_int8' FireNet "
                             "computes another function")
        units, params = [], {}
        for name in model.unit_names:
            cell = getattr(model, name)
            bn = cell.bn
            if hasattr(bn, "p"):  # TEBN: mean over the per-timestep scales
                pm = bn.p.mean(dim=0).reshape(-1)
                bn = bn.bn
                scale, bias = bn.weight * pm, bn.bias * pm
            else:
                scale, bias = bn.weight, bn.bias
            mean, var = bn.running_mean, bn.running_var
            w, b = fold_bn(cell.ff.weight.permute(2, 3, 1, 0), scale, bias, mean, var,
                           _BN_EPS)
            recurrent = hasattr(cell, "rec")
            w_rec = None
            if recurrent:  # the rec conv is scaled by g only: its bias is in b
                g = scale / torch.sqrt(var + _BN_EPS)
                w_rec = cell.rec.weight.permute(2, 3, 1, 0) * g
            params[name] = {
                "wk": pack_weights(w.float(), None if w_rec is None else w_rec.float()),
                "bias": b.float().contiguous(),
                "beta": cell.lif.beta.reshape(-1).clamp(0.0, 1.0).float().contiguous(),
                "theta": cell.lif.threshold.reshape(-1).clamp_min(THRESH_MIN)
                .float().contiguous(),
            }
            units.append(_Unit(name, recurrent))
        pred = model.pred.conv2d
        params["pred"] = {"w": pred.weight.reshape(2, -1).t().float().contiguous(),
                          "b": pred.bias.float().clone()}
        return cls(units, params, model.base_num_channels, model.num_bins,
                   model.encoding, hard_reset=model.hard_reset, layout=layout)

    @property
    def device(self) -> torch.device:
        return self.params["pred"]["w"].device

    def init_states(self, batch: int, height: int, width: int) -> Tuple[LIFState, ...]:
        """Zero f32 state per unit: ``[B, H, W, C]`` (nhwc) or ``[B, C, H, W]``."""
        C = self.base_num_channels
        shape = (batch, C, height, width) if self.layout == "cmajor" else (batch, height, width, C)
        return tuple(
            LIFState(torch.zeros(shape, device=self.device),
                     torch.zeros(shape, device=self.device))
            for _ in self.units)

    @torch.no_grad()
    def step(self, x: torch.Tensor, states: Sequence[LIFState]):
        """One event window: x ``[B, H, W, num_bins or 2]`` -> (flow
        ``[B, H, W, 2]``, new states in this net's layout)."""
        x = x.float()
        if self.layout == "cmajor":
            h = x.permute(0, 3, 1, 2).contiguous()
            kernel = fused_conv_lif_cmajor
        else:
            h = x.contiguous()
            kernel = fused_conv_lif
        new_states = []
        for unit, st in zip(self.units, states):
            e = self.params[unit.name]
            spk, mem = kernel(h, st.mem, e["wk"], e["bias"], e["beta"], e["theta"],
                              prev_spk=st.spk if unit.recurrent else None,
                              hard_reset=self.hard_reset)
            new_states.append(LIFState(mem, spk))
            h = spk
        pred = self.params["pred"]
        if self.layout == "cmajor":  # the spikes as a transposed [B, HW, C] view: no copy
            B, C, H, W = h.shape
            ff = torch.bmm(h.reshape(B, C, H * W).transpose(1, 2), pred["w"].expand(B, C, 2))
            ff = ff.reshape(B, H, W, 2)
        else:
            ff = torch.matmul(h, pred["w"])
        flow = torch.tanh(ff + pred["b"])
        return flow, tuple(new_states)

    def scan_windows(self, windows: torch.Tensor, states: Sequence[LIFState]):
        """Run ``step`` over ``[T, B, H, W, C_in]`` windows; returns
        ``(final states, flows [T, B, H, W, 2])``."""
        flows = []
        for x in windows:
            flow, states = self.step(x, states)
            flows.append(flow)
        return states, torch.stack(flows)
