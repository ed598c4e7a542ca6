"""Host (numpy) event encodings: count images, voxel grids, masks and the
hot-pixel filter (the ``np_*`` functions of ``evflow/data/encodings.py``).

All image-like outputs are channels-last ``[H, W, C]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "np_events_to_image",
    "np_events_to_voxel",
    "np_events_to_channels",
    "np_events_to_mask",
    "np_polarity_mask",
    "np_hot_event_mask",
]


def np_events_to_image(xs: np.ndarray, ys: np.ndarray, ps: np.ndarray,
                       sensor_size: Sequence[int], accumulate: bool = True) -> np.ndarray:
    """Scatter events into an ``[H, W]`` image. ``accumulate=False`` keeps
    the value written last (torch ``index_put_(accumulate=False)``)."""
    img = np.zeros(tuple(sensor_size), dtype=np.float32)
    xi = xs.astype(np.int64)
    yi = ys.astype(np.int64)
    if accumulate:
        np.add.at(img, (yi, xi), ps.astype(np.float32))
    else:
        img[yi, xi] = ps.astype(np.float32)
    return img


def np_events_to_voxel(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                       num_bins: int, sensor_size: Sequence[int],
                       round_ts: bool = False) -> np.ndarray:
    """Temporal-bilinear voxel grid ``[H, W, num_bins]``: ts scaled by
    ``num_bins - 1``, per-bin weight ``max(0, 1 - |ts - b|)``."""
    tb = ts.astype(np.float32) * (num_bins - 1)
    if round_ts:
        tb = np.round(tb)
    bins = []
    for b in range(num_bins):
        weights = np.maximum(0.0, 1.0 - np.abs(tb - b))
        bins.append(np_events_to_image(xs, ys, ps * weights, sensor_size))
    return np.stack(bins, axis=-1)


def np_events_to_channels(xs: np.ndarray, ys: np.ndarray, ps: np.ndarray,
                          sensor_size: Sequence[int]) -> np.ndarray:
    """Per-polarity count image ``[H, W, 2]`` (``ps * ps`` weighted, so
    plain counts for ``ps`` in {-1, +1})."""
    pos = np_events_to_image(xs, ys, ps * np.where(ps > 0, ps, 0.0), sensor_size)
    neg = np_events_to_image(xs, ys, ps * np.where(ps < 0, ps, 0.0), sensor_size)
    return np.stack([pos, neg], axis=-1)


def np_events_to_mask(xs: np.ndarray, ys: np.ndarray, ps: np.ndarray,
                      sensor_size: Sequence[int]) -> np.ndarray:
    """Binary event-presence mask ``[H, W, 1]``."""
    mask = np_events_to_image(xs, ys, np.abs(ps), sensor_size, accumulate=False)
    return mask[..., None]


def np_polarity_mask(ps: np.ndarray) -> np.ndarray:
    """``[N, 2]`` (pos, neg) polarity indicator."""
    pos = np.where(ps > 0, ps, 0.0)
    neg = -np.where(ps < 0, ps, 0.0)
    return np.stack([pos, neg], axis=-1).astype(np.float32)


def np_hot_event_mask(event_rate: np.ndarray, idx: int, max_px: int = 100,
                      min_obvs: int = 5, max_rate: float = 0.8) -> np.ndarray:
    """Mask zeroing up to ``max_px`` hottest pixels above ``max_rate`` once
    more than ``min_obvs`` windows were seen. Mutates ``event_rate``."""
    mask = np.ones_like(event_rate, dtype=np.float32)
    if idx > min_obvs:
        for _ in range(max_px):
            flat = int(np.argmax(event_rate))
            yx = np.unravel_index(flat, event_rate.shape)
            if event_rate[yx] > max_rate:
                event_rate[yx] = 0.0
                mask[yx] = 0.0
            else:
                break
    return mask
