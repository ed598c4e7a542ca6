"""Validation metrics AEE, NEE, AAE, NAAE, AE_ofMeans, AAE_Weighted and
AAE_Filtered (port of ``evflow/loss/metrics.py``).

Each metric converts the predicted flow to GT units (``flow *
flow_scaling * dt_gt / dt_input``), masks pixels without events or without
valid GT, and reduces per batch slot. Two quirks of the reference are kept:
``AAE`` uses the inverted ratio ``(|f||g|) / (dot + 0.01)`` unless
``strict=True``, and ``AAE_Weighted`` weights the *unmasked* error sum by
the masked magnitude sum. Tensors are NHWC ``[B, H, W, ...]``; the metric
classes mirror the reference's ``event_flow_association`` / ``__call__`` /
``reset`` API and accumulate error heatmaps in f32 numpy on the host, at
the std resolution (``merge_aggregated`` folds in sums accumulated on the
device by ``evaluate(device_metrics=True)``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["aee", "nee", "aae", "naae", "ae_of_means", "aae_weighted", "aae_filtered",
           "AEE", "NEE", "AAE", "NAAE", "AEofMeans", "AAEWeighted", "AAEFiltered"]


def _convert_flow(flow, flow_scaling, dt_gt, dt_input):
    """Network output -> GT displacement units."""
    scale = flow_scaling * dt_gt / torch.clamp(dt_input, min=1e-9)
    return flow * scale.reshape((-1,) + (1,) * (flow.ndim - 1))


def _dot(a, b):
    """The dot product over the last axis of 2 (x, y): the two products'
    sum, as a reduction over that axis computes it, without its cost on the
    CPU. (Norms stay ``torch.linalg.norm``, which rounds as the reference's
    ``jnp.linalg.norm`` does.)"""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _norm(v):
    return torch.linalg.norm(v, dim=-1)


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
    d = f - gtflow
    error = torch.sqrt(_dot(d, d))
    flow_mag = torch.sqrt(_dot(f, f))
    mask = _masks(gtflow, event_mask)
    e, n, val = _reduce(error, mask)
    mag = flow_mag.reshape(flow.shape[0], -1) * mask.reshape(flow.shape[0], -1).to(f.dtype)
    outliers = (e > 3.0) & (e > 0.05 * mag)
    percent = outliers.sum(dim=1) / (n + 1e-9)
    return val, percent, error, mask.to(f.dtype)


def nee(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float):
    """Endpoint error normalised by the smaller magnitude, and the > 0.5
    outlier rate. Returns ``(NEE [B], percent [B], error map, mask)``."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    f_norm, g_norm = _norm(f), _norm(gtflow)
    error = _norm(f - gtflow) / (torch.minimum(f_norm, g_norm) + 0.01)
    mask = _masks(gtflow, event_mask)
    e, n, val = _reduce(error, mask)
    percent = (e > 0.5).sum(dim=1) / (n + 1e-9)
    return val, percent, error, mask.to(f.dtype)


def aae(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float,
        strict: bool = False):
    """Average angular error (radians) and the >30 degree outlier rate."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    f_norm, g_norm = _norm(f), _norm(gtflow)
    dot = _dot(f, gtflow)
    if strict:
        cos = dot / (f_norm * g_norm + 1e-9)
    else:
        cos = (f_norm * g_norm) / (dot + 0.01)
    error = torch.arccos(torch.clamp(cos, -1 + 1e-5, 1 - 1e-5))
    mask = _masks(gtflow, event_mask)
    e, n, val = _reduce(error, mask)
    percent = (e > (math.pi / 6)).sum(dim=1) / (n + 1e-9)
    return val, percent, error, mask.to(f.dtype)


def _angle(f, gtflow):
    """Per-pixel angle between f and the GT (the strict cosine), and |f|."""
    f_norm = _norm(f)
    cos = torch.clamp(_dot(f, gtflow) / (f_norm * _norm(gtflow) + 1e-9), -1 + 1e-5, 1 - 1e-5)
    return torch.arccos(cos), f_norm


def naae(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float):
    """Angular error over the flow magnitude. Returns ``(NAAE [B], error
    map, mask)``."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    angle, f_norm = _angle(f, gtflow)
    error = angle / (f_norm + 1e-9)
    mask = _masks(gtflow, event_mask)
    _, _, val = _reduce(error, mask)
    return val, error, mask.to(f.dtype)


def aae_weighted(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float):
    """Magnitude-weighted angular error: the reference weights the
    *unmasked* error sum by the masked magnitude sum, and so does this."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    angle, f_norm = _angle(f, gtflow)
    mask = _masks(gtflow, event_mask).to(f.dtype)
    B = flow.shape[0]
    wsum = (f_norm * mask).reshape(B, -1).sum(dim=1)
    return (angle * f_norm).reshape(B, -1).sum(dim=1) / (wsum + 1e-9)


def aae_filtered(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float,
                 mag_threshold: float = 0.5):
    """Angular error over the masked pixels with ``|flow| >= mag_threshold``."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    angle, f_norm = _angle(f, gtflow)
    _, _, val = _reduce(angle, _masks(gtflow, event_mask) & (f_norm >= mag_threshold))
    return val


def ae_of_means(flow, gtflow, event_mask, dt_gt, dt_input, flow_scaling: float):
    """Angle between the masked mean flow vectors, per slot."""
    f = _convert_flow(flow, flow_scaling, dt_gt, dt_input)
    mask = _masks(gtflow, event_mask).to(f.dtype)[..., None]
    n = mask.sum(dim=(1, 2))
    mean_f = (f * mask).sum(dim=(1, 2)) / (n + 1e-9)
    mean_g = (gtflow * mask).sum(dim=(1, 2)) / (n + 1e-9)
    cos = _dot(mean_f, mean_g) / (_norm(mean_f) * _norm(mean_g) + 1e-9)
    return torch.arccos(torch.clamp(cos, -1 + 1e-5, 1 - 1e-5))


class _BaseMetric:
    """Holds the latest association window and an aggregated error heatmap
    at the full (std) resolution (f32 numpy)."""

    has_percent = False

    def __init__(self, config, flow_scaling: float = 128):
        loader = config["loader"]
        self.res = tuple(loader["resolution"])
        self.std_res = tuple(loader.get("std_resolution", loader["resolution"]))
        self.flow_scaling = float(flow_scaling)
        self._reset_window()
        self._agg_error: Optional[np.ndarray] = None
        self._agg_count: Optional[np.ndarray] = None
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
        self._merge_std(e.cpu().numpy().astype(np.float32),
                        mask_map.sum(dim=0).cpu().numpy().astype(np.float32))

    def merge_aggregated(self, err_sum, count_sum):
        """Fold sums accumulated elsewhere (masked error, mask) into the
        aggregate: the heat maps that ``evaluate(device_metrics=True)``
        accumulates on the device over whole chunks, merged once."""
        self._merge_std(np.asarray(err_sum, np.float32), np.asarray(count_sum, np.float32))

    def _merge_std(self, e, c):
        # aggregate at the std resolution: nearest-upsample maps of a pooled
        # resolution
        sh, sw = self.std_res
        if e.shape != (sh, sw) and sh % e.shape[0] == 0 and sw % e.shape[1] == 0:
            fy, fx = sh // e.shape[0], sw // e.shape[1]
            e = np.repeat(np.repeat(e, fy, axis=0), fx, axis=1)
            c = np.repeat(np.repeat(c, fy, axis=0), fx, axis=1)
        if self._agg_error is None:
            self._agg_error, self._agg_count = e.copy(), c.copy()
        else:
            self._agg_error += e
            self._agg_count += c

    def aggregated_sums(self):
        """The heat map's sums ``(masked error, mask)`` at the std
        resolution, or None before any was accumulated."""
        return None if self._agg_error is None else (self._agg_error, self._agg_count)

    def get_final_error_heatmap(self):
        if self._agg_error is None:
            return None, None
        return self._agg_error / (self._agg_count + 1e-9), self._agg_count

    def save_error_heatmap(self, save_path, title="Error Heatmap", cmap="jet", **_):
        """Write the aggregate (clipped to its 95th percentile, pixels
        never scored blank) as an image; False when nothing was scored."""
        avg, count = self.get_final_error_heatmap()
        if avg is None:
            return False
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        vis = avg.copy()
        vis[count == 0] = np.nan
        valid = vis[count > 0]
        if valid.size:
            vis = np.clip(vis, None, np.quantile(valid, 0.95))
        fig, ax = plt.subplots(figsize=(12, 10))
        im = ax.imshow(vis, cmap=cmap, aspect="auto")
        ax.set_title(title)
        plt.colorbar(im, ax=ax, label="Average Error (clipped to P95)")
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return True

    def reset_error_heatmap(self):
        self._agg_error = self._agg_count = None

    def _args(self):
        return (self._flow, self._gtflow, self._event_mask, self._dt_gt, self._dt_input,
                self.flow_scaling)


class AEE(_BaseMetric):
    has_percent = True

    def __call__(self):
        val, pct, err, mask = aee(*self._args())
        self._last_error_map = err
        self.accumulate_error_heatmap(err, mask)
        return val, pct


class NEE(_BaseMetric):
    has_percent = True

    def __call__(self):
        val, pct, err, _ = nee(*self._args())
        self._last_error_map = err
        return val, pct


class AAE(_BaseMetric):
    has_percent = True

    def __init__(self, config, flow_scaling: float = 128, strict: bool = False):
        super().__init__(config, flow_scaling)
        self.strict = strict

    def __call__(self):
        val, pct, err, mask = aae(*self._args(), self.strict)
        self._last_error_map = err
        self.accumulate_error_heatmap(err, mask)
        return val, pct


class NAAE(_BaseMetric):
    def __call__(self):
        val, err, mask = naae(*self._args())
        self._last_error_map = err
        self.accumulate_error_heatmap(err, mask)
        return val


class AEofMeans(_BaseMetric):
    def __call__(self):
        return ae_of_means(*self._args())


class AAEWeighted(_BaseMetric):
    def __call__(self):
        return aae_weighted(*self._args())


class AAEFiltered(_BaseMetric):
    def __init__(self, config, flow_scaling: float = 128, mag_threshold: float = 0.5):
        super().__init__(config, flow_scaling)
        self.mag_threshold = mag_threshold

    def __call__(self):
        return aae_filtered(*self._args(), self.mag_threshold)
