"""Synthetic event sequences in the reference HDF5 schema (a copy of
``evflow/data/synthetic.py``, so that the port writes its own datasets).

Translating random-dot scenes with exactly known optical flow, written like
the reference's MVSEC-style ``.h5``: ``events/{xs,ys,ts,ps}``, attrs
``t0``/``duration``, ``flow_dt1``/``flow_dt4`` GT groups whose datasets carry
a ``timestamp`` attr, and an optional ``images`` group. The same seed gives
the same ``.h5`` files as the reference package's generator. ``fmt="npz"``
writes the same schema as a numpy archive (see
``evflow_torch.data.h5_stream``), for hosts without ``h5py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["generate_sequence", "write_sequence", "make_dataset"]


def generate_sequence(rng: np.random.Generator, duration: float = 1.0,
                      resolution: Tuple[int, int] = (64, 64),
                      events_per_sec: int = 50_000,
                      flow_px_per_sec: Tuple[float, float] = (12.0, -8.0),
                      rate_mode: str = "fixed", rate_ref: float = 16.0):
    """Events from a translating random-dot texture: ``(xs, ys, ts, ps[0/1],
    (vx, vy))`` sorted by time; dots wrap around the sensor.

    ``rate_mode="fixed"`` emits ``events_per_sec`` whatever the motion;
    ``"motion"`` scales the rate by ``|flow| / rate_ref``, as a real event
    camera's rate follows the scene's speed.
    """
    H, W = resolution
    vx, vy = flow_px_per_sec
    if rate_mode == "motion":
        speed = float(np.hypot(vx, vy))
        n = int(duration * events_per_sec * max(speed, 1e-3) / rate_ref)
    elif rate_mode == "fixed":
        n = int(duration * events_per_sec)
    else:
        raise ValueError(f"rate_mode must be 'fixed' or 'motion', got {rate_mode!r}")
    ts = np.sort(rng.uniform(0.0, duration, n))
    n_dots = max(16, (H * W) // 64)
    dot_x = rng.uniform(0, W, n_dots)
    dot_y = rng.uniform(0, H, n_dots)
    dot_p = rng.integers(0, 2, n_dots)
    which = rng.integers(0, n_dots, n)
    xs = (dot_x[which] + vx * ts) % W
    ys = (dot_y[which] + vy * ts) % H
    # small sensor jitter
    xs = np.clip(xs + rng.normal(0, 0.2, n), 0, W - 1)
    ys = np.clip(ys + rng.normal(0, 0.2, n), 0, H - 1)
    ps = dot_p[which].astype(np.float32)
    return xs.astype(np.float32), ys.astype(np.float32), ts.astype(np.float64), ps, (vx, vy)


def write_sequence(path: str, rng: np.random.Generator, duration: float = 1.0,
                   resolution: Tuple[int, int] = (64, 64),
                   events_per_sec: int = 50_000,
                   flow_px_per_sec: Tuple[float, float] = (12.0, -8.0),
                   gt_hz: float = 10.0, t0: float = 100.0,
                   with_frames: bool = False, rate_mode: str = "fixed",
                   rate_ref: float = 16.0):
    """Write one reference-schema sequence file, HDF5 or (for a ``.npz``
    path) a numpy archive; returns the GT flow (vx, vy)."""
    H, W = resolution
    xs, ys, ts, ps, (vx, vy) = generate_sequence(
        rng, duration, resolution, events_per_sec, flow_px_per_sec,
        rate_mode=rate_mode, rate_ref=rate_ref)
    # dataset path -> (array, timestamp attr or None), in the h5 schema
    data = {"events/xs": (xs, None), "events/ys": (ys, None),
            "events/ts": (ts + t0, None), "events/ps": (ps, None)}
    n_gt = int(duration * gt_hz) + 1
    gt_ts = np.linspace(0.0, duration, n_gt)
    dt = 1.0 / gt_hz
    for name, scale in (("flow_dt1", dt), ("flow_dt4", 4 * dt)):
        for i, t in enumerate(gt_ts):
            # GT displacement over the GT frame interval, [2, H, W] (x, y)
            fm = np.zeros((2, H, W), np.float32)
            fm[0] = vx * scale
            fm[1] = vy * scale
            data[f"{name}/frame_{i:06d}"] = (fm, t + t0)
    if with_frames:
        for i, t in enumerate(gt_ts):
            img = (rng.uniform(0, 255, (H, W))).astype(np.uint8)
            data[f"images/image_{i:06d}"] = (img, t + t0)
    attrs = {"t0": t0, "duration": duration}

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npz"):
        members = {f"attrs/{k}": np.asarray(v) for k, v in attrs.items()}
        for key, (a, ts_attr) in data.items():
            members[key] = a
            if ts_attr is not None:
                members[f"{key}@timestamp"] = np.asarray(ts_attr)
        np.savez(path, **members)
        return vx, vy
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs.update(attrs)
        for key, (a, ts_attr) in data.items():
            d = f.create_dataset(key, data=a)
            if ts_attr is not None:
                d.attrs["timestamp"] = ts_attr
    return vx, vy


def make_dataset(root: str, num_sequences: int = 2, seed: int = 0,
                 duration: float = 1.0, resolution: Tuple[int, int] = (64, 64),
                 events_per_sec: int = 50_000,
                 flows: Optional[Sequence[Tuple[float, float]]] = None,
                 gt_hz: float = 10.0, with_frames: bool = False,
                 rate_mode: str = "fixed", rate_ref: float = 16.0, fmt: str = "h5"):
    """Write a directory of synthetic sequences (``fmt`` "h5" or "npz");
    returns the list of GT flows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_sequences):
        flow = (flows[i] if flows is not None
                else (float(rng.uniform(-16, 16)), float(rng.uniform(-16, 16))))
        out.append(write_sequence(
            os.path.join(root, f"seq_{i:03d}.{fmt}"), rng, duration=duration,
            resolution=resolution, events_per_sec=events_per_sec,
            flow_px_per_sec=flow, gt_hz=gt_hz, with_frames=with_frames,
            rate_mode=rate_mode, rate_ref=rate_ref))
    return out
