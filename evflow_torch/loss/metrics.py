"""Validation metrics AEE, AAE and AE_ofMeans (port of the corresponding
parts of ``evflow/loss/metrics.py``).

Each metric converts the predicted flow to GT units (``flow *
flow_scaling * dt_gt / dt_input``), masks pixels without events or without
valid GT, and reduces per batch slot. ``AAE`` keeps the reference's
inverted ratio ``(|f||g|) / (dot + 0.01)`` unless ``strict=True``. Tensors
are NHWC ``[B, H, W, ...]``; the metric classes mirror the reference's
``event_flow_association`` / ``__call__`` / ``reset`` API and accumulate
error heatmaps on the tensors' device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["aee", "aae", "ae_of_means", "AEE", "AAE", "AEofMeans"]


def _convert_flow(flow, flow_scaling, dt_gt, dt_input):
    """Network output -> GT displacement units."""
    scale = flow_scaling * dt_gt / torch.clamp(dt_input, min=1e-9)
    return flow * scale.reshape((-1,) + (1,) * (flow.ndim - 1))


def _masks(gtflow, event_mask):
    """Event presence and valid (nonzero) GT."""
    gt_zero = (gtflow[..., 0] == 0.0) & (gtflow[..., 1] == 0.0)
    return (event_mask > 0) & ~gt_zero


def _reduce(error, mask):
    B = error.shape[0]
    m = mask.reshape(B, -1).to(error.dtype)
    e = error.reshape(B, -1) * m
    n = m.sum(dim=1)
    return e, n, e.sum(dim=1) / (n + 1e-9)


def aee(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float):
    """Average endpoint error and the 3 px / 5 % outlier rate per slot.
    Returns ``(AEE [B], percent [B], error map [B, H, W], mask [B, H, W])``."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    error = torch.sqrt(((f - gtflow) ** 2).sum(-1))
    flow_mag = torch.sqrt((f ** 2).sum(-1))
    mask = _masks(gtflow, event_mask)
    e, n, val = _reduce(error, mask)
    mag = flow_mag.reshape(flow.shape[0], -1) * mask.reshape(flow.shape[0], -1).to(f.dtype)
    outliers = (e > 3.0) & (e > 0.05 * mag)
    percent = outliers.sum(dim=1) / (n + 1e-9)
    return val, percent, error, mask.to(f.dtype)


def aae(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float,
        strict: bool = False):
    """Average angular error (radians) and the >30 degree outlier rate."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    f_norm = torch.linalg.norm(f, dim=-1)
    g_norm = torch.linalg.norm(gtflow, dim=-1)
    dot = (f * gtflow).sum(-1)
    if strict:
        cos = dot / (f_norm * g_norm + 1e-9)
    else:
        cos = (f_norm * g_norm) / (dot + 0.01)
    error = torch.arccos(torch.clamp(cos, -1 + 1e-5, 1 - 1e-5))
    mask = _masks(gtflow, event_mask)
    e, n, val = _reduce(error, mask)
    percent = (e > (math.pi / 6)).sum(dim=1) / (n + 1e-9)
    return val, percent, error, mask.to(f.dtype)


def ae_of_means(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float):
    """Angle between the masked mean flow vectors, per slot."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    mask = _masks(gtflow, event_mask).to(f.dtype)[..., None]
    n = mask.sum(dim=(1, 2))
    mean_f = (f * mask).sum(dim=(1, 2)) / (n + 1e-9)
    mean_g = (gtflow * mask).sum(dim=(1, 2)) / (n + 1e-9)
    dot = (mean_f * mean_g).sum(-1)
    cos = dot / (torch.linalg.norm(mean_f, dim=-1) * torch.linalg.norm(mean_g, dim=-1) + 1e-9)
    return torch.arccos(torch.clamp(cos, -1 + 1e-5, 1 - 1e-5))


class _BaseMetric:
    """Holds the latest association window and an aggregated error heatmap
    at the full (std) resolution."""

    has_percent = False

    def __init__(self, config, flow_scaling: float = 128):
        loader = config["loader"]
        self.res = tuple(loader["resolution"])
        self.std_res = tuple(loader.get("std_resolution", loader["resolution"]))
        self.flow_scaling = float(flow_scaling)
        self._reset_window()
        self._agg_error: Optional[torch.Tensor] = None
        self._agg_count: Optional[torch.Tensor] = None
        self._last_error_map: Optional[torch.Tensor] = None

    def _reset_window(self):
        self._flow = self._gtflow = self._event_mask = None
        self._dt_input = self._dt_gt = None

    def event_flow_association(self, flow_list, inputs):
        """``flow_list``: list of ``[B, H, W, 2]``; ``inputs``: tensors
        ``gtflow [B, H, W, 2]``, ``event_mask [B, H, W, 1]``, ``dt_gt``,
        ``dt_input``."""
        self._flow = flow_list[-1]
        self._gtflow = inputs.get("gtflow")
        self._event_mask = inputs["event_mask"][..., 0]
        self._dt_input = inputs["dt_input"].float().reshape(-1)
        self._dt_gt = inputs["dt_gt"].float().reshape(-1)

    def reset(self, slots=None):
        """Full reset, or (given a boolean ``[B]`` array) remove only the
        rolled-over slots from the current association."""
        if slots is None:
            self._reset_window()
            return
        if self._event_mask is None:
            return
        keep = torch.as_tensor(~np.asarray(slots, bool), dtype=self._event_mask.dtype,
                               device=self._event_mask.device)
        self._event_mask = self._event_mask * keep.reshape(
            (-1,) + (1,) * (self._event_mask.ndim - 1))

    def get_error_map(self, consume: bool = True):
        """Error map of the latest evaluation (cleared on read)."""
        if self._last_error_map is None:
            return None
        out = self._last_error_map.cpu().numpy()
        if consume:
            self._last_error_map = None
        return out

    def accumulate_error_heatmap(self, error_map, mask_map):
        e = (error_map * mask_map).sum(dim=0)
        c = mask_map.sum(dim=0)
        sh, sw = self.std_res
        if e.shape != (sh, sw) and sh % e.shape[0] == 0 and sw % e.shape[1] == 0:
            fy, fx = sh // e.shape[0], sw // e.shape[1]
            e = e.repeat_interleave(fy, 0).repeat_interleave(fx, 1)
            c = c.repeat_interleave(fy, 0).repeat_interleave(fx, 1)
        if self._agg_error is None:
            self._agg_error, self._agg_count = e, c
        else:
            self._agg_error = self._agg_error + e
            self._agg_count = self._agg_count + c

    def get_final_error_heatmap(self):
        if self._agg_error is None:
            return None, None
        return ((self._agg_error / (self._agg_count + 1e-9)).cpu().numpy(),
                self._agg_count.cpu().numpy())

    def reset_error_heatmap(self):
        self._agg_error = self._agg_count = None


class AEE(_BaseMetric):
    has_percent = True

    def __call__(self):
        val, pct, err, mask = aee(self._flow, self._gtflow, self._event_mask,
                                  self._dt_gt, self._dt_input, self.flow_scaling)
        self._last_error_map = err
        self.accumulate_error_heatmap(err, mask)
        return val, pct


class AAE(_BaseMetric):
    has_percent = True

    def __init__(self, config, flow_scaling: float = 128, strict: bool = False):
        super().__init__(config, flow_scaling)
        self.strict = strict

    def __call__(self):
        val, pct, err, mask = aae(self._flow, self._gtflow, self._event_mask,
                                  self._dt_gt, self._dt_input, self.flow_scaling,
                                  self.strict)
        self._last_error_map = err
        self.accumulate_error_heatmap(err, mask)
        return val, pct


class AEofMeans(_BaseMetric):
    def __call__(self):
        return ae_of_means(self._flow, self._gtflow, self._event_mask,
                           self._dt_gt, self._dt_input, self.flow_scaling)
