"""Visualisation (port of ``evflow/utils/viz.py``): the flow colour wheel,
event images, error maps, arrow fields, per-sequence image or video storage
and activity plots.

Everything renders to uint8 RGB numpy arrays on the host. cv2 stays
optional, as in the reference: without it the arrow fields draw nothing
over their background, and ``Visualization`` renders its panels but writes
none, saying so once on stderr. The colour wheel converts HSV with its own
copy of matplotlib's formula, so that the panels render on a host without
matplotlib; the activity plot's file needs matplotlib.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - hosts without OpenCV
    cv2 = None

__all__ = ["flow_to_image", "events_to_image", "error_to_image", "flow_to_vector",
           "Visualization", "vis_activity", "hsv_to_rgb"]


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``[..., 3]`` HSV in [0, 1] to RGB in [0, 1], element for element
    ``matplotlib.colors.hsv_to_rgb``."""
    hsv = np.asarray(hsv)
    hsv = hsv.astype(np.promote_types(hsv.dtype, np.float32), copy=False)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = [i % 6 == 0] + [i == k for k in range(1, 6)]
    rgb = [np.select(sector, choices) for choices in
           ((v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))]
    grey = s == 0
    return np.stack([np.where(grey, v, c) for c in rgb], axis=-1)


def flow_to_image(flow: np.ndarray, uniform_v: Optional[float] = None) -> np.ndarray:
    """HSV colour-wheel rendering of ``[H, W, 2]`` (x, y) flow as uint8 RGB:
    hue ``atan2(fy, fx)`` wrapped to [0, 1]; value the P5-P95-normalised
    magnitude with a square-root boost, times 1.3 with a floor of 0.15;
    zero flow black; a uniform nonzero field takes the ``uniform_v`` scale."""
    fx = np.asarray(flow[..., 0], dtype=float)
    fy = np.asarray(flow[..., 1], dtype=float)
    mag = np.sqrt(fx * fx + fy * fy)
    max_mag = float(np.max(mag))
    mag_range = max_mag - float(np.min(mag))
    hsv = np.zeros((*fx.shape, 3), dtype=float)
    hsv[..., 0] = (np.arctan2(fy, fx) + np.pi) / (2.0 * np.pi)
    hsv[..., 1] = 1.0
    if mag_range > 0.0:
        p5, p95 = float(np.percentile(mag, 5)), float(np.percentile(mag, 95))
        norm = np.clip((mag - p5) / (p95 - p5 + 1e-8), 0.0, 1.0) ** 0.5
        hsv[..., 2] = np.where(mag > 0, np.clip(norm * 1.3 + 0.15, 0.15, 1.0), 0.0)
    elif max_mag > 0.0:
        v = mag / max_mag
        if uniform_v is not None:
            v = v * float(uniform_v)
        v = v ** 0.5 * 1.3 + 0.15
        hsv[..., 2] = np.where(mag > 0, np.clip(v, 0.15, 1.0), 0.0)
    return (255 * hsv_to_rgb(hsv)).astype(np.uint8)


def events_to_image(event_cnt: np.ndarray) -> np.ndarray:
    """Green (+) / red (-) rendering of ``[H, W, 2]`` per-polarity counts as
    uint8 RGB, each polarity P1-P99 normalised against the shared max."""
    pos = np.asarray(event_cnt[..., 0], dtype=float)
    neg = np.asarray(event_cnt[..., 1], dtype=float)
    pos_max, pos_min = np.percentile(pos, 99), np.percentile(pos, 1)
    neg_max, neg_min = np.percentile(neg, 99), np.percentile(neg, 1)
    mx = pos_max if pos_max > neg_max else neg_max
    if pos_min != mx:
        pos = (pos - pos_min) / (mx - pos_min)
    if neg_min != mx:
        neg = (neg - neg_min) / (mx - neg_min)
    pos = np.clip(pos, 0, 1)
    neg = np.clip(neg, 0, 1)
    img = np.zeros((*pos.shape, 3), dtype=float)
    img[..., 1][pos > 0] = pos[pos > 0]
    img[..., 0][neg > 0] = neg[neg > 0]
    return (255 * img).astype(np.uint8)


def error_to_image(error: np.ndarray, mask: Optional[np.ndarray] = None,
                   rad_to_deg: bool = False) -> np.ndarray:
    """Red error map as uint8 RGB: angles in radians on a fixed [0, 180]
    degree scale (``rad_to_deg``), else normalised by the 95th percentile."""
    e = error.astype(np.float32).copy()
    if rad_to_deg:
        e = np.degrees(e) / 180.0
    else:
        e = e / (np.percentile(e, 95) + 1e-9)
    e = np.clip(e, 0, 1)
    if mask is not None:
        e = e * mask
    img = np.zeros((*e.shape, 3), np.uint8)
    img[..., 0] = (e * 255).astype(np.uint8)
    return img


def flow_to_vector(flow: np.ndarray, step: int = 8, scale: float = 1.0,
                   gtflow: Optional[np.ndarray] = None, mode: str = "grid",
                   mask: Optional[np.ndarray] = None,
                   background: Optional[np.ndarray] = None) -> np.ndarray:
    """Arrow field over ``background`` (uint8 RGB, else black): predicted
    arrows green, GT blue; ``mode`` ``grid`` (every ``step`` pixels),
    ``sparse`` (only where ``mask``) or ``center`` (one mean arrow). Without
    cv2 it returns the background."""
    H, W = flow.shape[:2]
    img = background.copy() if background is not None else np.zeros((H, W, 3), np.uint8)
    if cv2 is None:
        return img

    def draw(f, color):
        if mode == "center":
            m = mask.astype(bool) if mask is not None and mask.sum() > 0 else None
            mean = (f[m] if m is not None else f).reshape(-1, 2).mean(axis=0)
            y, x = H // 2, W // 2
            cv2.arrowedLine(img, (x, y), (int(x + mean[0] * scale * 10),
                                          int(y + mean[1] * scale * 10)),
                            color, 1, tipLength=0.3)
            return
        for y in range(step // 2, H, step):
            for x in range(step // 2, W, step):
                if mode == "sparse" and (mask is None or not mask[y, x]):
                    continue
                v = f[y, x]
                cv2.arrowedLine(img, (x, y), (int(x + v[0] * scale), int(y + v[1] * scale)),
                                color, 1, tipLength=0.3)

    draw(flow, (0, 255, 0))
    if gtflow is not None:
        draw(gtflow, (255, 128, 0))
    return img


def _first(x) -> np.ndarray:
    x = np.asarray(x)
    return x[0] if x.ndim == 4 else x


class Visualization:
    """Store (and, with ``vis.enabled`` and a display, show) each window's
    panels: per-sequence folders ``events/ flow/ gtflow/ masked_flow_grad/
    masked_flow_vec/ iwe/ error/ stitched/`` of numbered PNGs, or one mp4 a
    panel with ``vis.store_type: video``; ``vis.store_interval`` throttles by
    the events' time."""

    KINDS = ("events", "flow", "gtflow", "masked_flow_grad", "masked_flow_vec",
             "iwe", "error", "stitched")

    def __init__(self, config: Dict, eval_id: int = -1, path_results: Optional[str] = None,
                 vis_type: str = "gradients"):
        vis = config.get("vis", {})
        self.px = int(vis.get("px", 400))
        self.store_type = vis.get("store_type", "image")
        self.store_interval = float(vis.get("store_interval", 0.0))
        self.enabled_live = bool(vis.get("enabled", False))
        self.vis_type = vis_type
        self.vec_mode = vis.get("vec_mode", "grid")  # sparse | grid | center
        self.vec_step = int(vis.get("vec_step", 8))
        self.vec_scale = float(vis.get("vec_scale", 1.0))
        self.path = os.path.join(path_results, f"eval_{eval_id}") if path_results else None
        self.frame_idx: Dict[str, int] = {}
        self.writers: Dict[str, object] = {}
        self.last_store_ts: Dict[str, float] = {}
        self.unwritten = 0  # panels rendered but not written (no cv2)

    def _dir(self, sequence: str, kind: str) -> str:
        d = os.path.join(self.path, sequence, kind)
        os.makedirs(d, exist_ok=True)
        return d

    def _write(self, sequence: str, kind: str, img: np.ndarray):
        if self.path is None:
            return
        if cv2 is None:
            if not self.unwritten:
                print(f"evflow_torch.utils.viz: no cv2 on this host; vis.store renders "
                      f"the panels but writes nothing under {self.path}", file=sys.stderr)
            self.unwritten += 1
            return
        key = f"{sequence}/{kind}"
        idx = self.frame_idx.get(key, 0)
        bgr = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        if self.store_type == "video":
            if key not in self.writers:
                path = os.path.join(self._dir(sequence, kind), f"{kind}.mp4")
                self.writers[key] = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                                    (img.shape[1], img.shape[0]))
            self.writers[key].write(bgr)
        else:
            cv2.imwrite(os.path.join(self._dir(sequence, kind), f"{idx:06d}.png"), bgr)
        self.frame_idx[key] = idx + 1

    def _panels(self, inputs: Dict[str, np.ndarray], flow: np.ndarray,
               iwe: Optional[np.ndarray], masked_flow=None,
               error_map: Optional[np.ndarray] = None,
               error_is_angle: bool = False) -> Dict[str, np.ndarray]:
        """One window's panels (batch slot 0), by kind."""
        gt = _first(inputs["gtflow"]) if inputs.get("gtflow") is not None else None
        out = {"events": events_to_image(_first(inputs["event_cnt"])),
               "flow": flow_to_image(_first(flow))}
        if gt is not None:
            out["gtflow"] = flow_to_image(gt)
        if masked_flow is not None:
            mf = _first(masked_flow)
            em = np.asarray(inputs.get("event_mask"))
            em2 = (em[0] if em.ndim == 4 else em)[..., 0] > 0 if em is not None and em.size \
                else None
            out["masked_flow_grad"] = flow_to_image(mf)
            out["masked_flow_vec"] = flow_to_vector(
                mf, step=self.vec_step, scale=self.vec_scale, gtflow=gt, mode=self.vec_mode,
                mask=em2, background=out["events"] // 2)
        if iwe is not None:
            out["iwe"] = events_to_image(_first(iwe))
        if error_map is not None:
            e = np.asarray(error_map)
            out["error"] = error_to_image(e[0] if e.ndim == 3 else e, rad_to_deg=error_is_angle)
        return out

    def store(self, inputs: Dict[str, np.ndarray], flow: np.ndarray, iwe: Optional[np.ndarray],
              sequence: str, events_window=None, masked_flow=None, iwe_window=None,
              ts: float = 0.0, error_map: Optional[np.ndarray] = None,
              error_is_angle: bool = False):
        """Store one window's panels (arrays NHWC batch-first or ``[H, W,
        C]``) and their labelled 2x2 stitch."""
        if self.path is None:
            return
        if self.store_interval > 0.0:
            if ts - self.last_store_ts.get(sequence, -1e18) < self.store_interval:
                return
            self.last_store_ts[sequence] = ts
        panels = self._panels(inputs, flow, iwe, masked_flow, error_map, error_is_angle)
        for kind, img in panels.items():
            self._write(sequence, kind, img)
        keys = [k for k in ("events", "flow", "gtflow", "iwe") if k in panels]
        if len(keys) >= 2 and cv2 is not None:
            h = max(panels[k].shape[0] for k in keys)
            w = max(panels[k].shape[1] for k in keys)
            cells = []
            for k in keys[:4]:
                img = cv2.resize(panels[k], (w, h))
                cv2.putText(img, k, (4, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
                cells.append(img)
            while len(cells) < 4:
                cells.append(np.zeros((h, w, 3), np.uint8))
            self._write(sequence, "stitched",
                        np.vstack([np.hstack(cells[:2]), np.hstack(cells[2:])]))

    def update(self, inputs, flow, iwe=None, masked_flow=None, *args, **kwargs):
        """Show the panels in cv2 windows; nothing without cv2, a display
        or ``vis.enabled``."""
        if not self.enabled_live or cv2 is None or not os.environ.get("DISPLAY"):
            return
        gt = None
        if isinstance(inputs, dict) and inputs.get("gtflow") is not None:
            gt = _first(inputs["gtflow"])
        windows = {"flow": flow_to_image(_first(flow))}
        if isinstance(inputs, dict) and "event_cnt" in inputs:
            windows["events"] = events_to_image(_first(inputs["event_cnt"]))
        if gt is not None:
            windows["gtflow"] = flow_to_image(gt)
        if iwe is not None:
            windows["iwe"] = events_to_image(_first(iwe))
        if masked_flow is not None:
            windows["masked_flow_vec"] = flow_to_vector(
                _first(masked_flow), step=self.vec_step, scale=self.vec_scale, gtflow=gt,
                mode=self.vec_mode)
        for name, img in windows.items():
            h, w = img.shape[:2]
            img = cv2.resize(img, (int(w * self.px / max(h, 1)), self.px),
                             interpolation=cv2.INTER_NEAREST)
            cv2.imshow(name, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.waitKey(1)

    def close_videos(self):
        for w in self.writers.values():
            try:
                w.release()
            except Exception:
                pass
        self.writers = {}


def _draw_activity_live(activity_log: Dict[str, list]):
    """Redraw the one interactive activity figure in place."""
    import matplotlib.pyplot as plt

    fig = getattr(_draw_activity_live, "_fig", None)
    if fig is None or not plt.fignum_exists(fig.number):
        plt.ion()
        fig, ax = plt.subplots(figsize=(10, 5))
        _draw_activity_live._fig, _draw_activity_live._ax = fig, ax
    ax = _draw_activity_live._ax
    ax.clear()
    for k, vals in activity_log.items():
        ax.plot(vals, label=k)
    ax.set_xlabel("window")
    ax.set_ylabel("fraction nonzero")
    ax.legend(fontsize=7, loc="upper right")
    fig.canvas.draw_idle()
    plt.pause(0.001)


def vis_activity(activity: Optional[Dict[str, float]], activity_log: Optional[Dict[str, list]],
                 save_path: Optional[str] = None, live: bool = False):
    """Append each layer's fraction of nonzero activations to its trace;
    ``live`` redraws an interactive window (with a display), ``save_path``
    plots the traces there (both need matplotlib). Returns the log."""
    if activity is None:
        return activity_log
    if activity_log is None:
        activity_log = {k: [] for k in activity}
    for k, v in activity.items():
        activity_log.setdefault(k, []).append(float(v))
    if live and os.environ.get("DISPLAY"):
        _draw_activity_live(activity_log)
    if save_path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 5))
        for k, vals in activity_log.items():
            ax.plot(vals, label=k)
        ax.set_xlabel("window")
        ax.set_ylabel("fraction nonzero")
        ax.legend(fontsize=7)
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return activity_log
