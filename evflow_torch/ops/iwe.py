"""Images of warped events (IWE) and flow upsampling (port of
``evflow/ops/iwe.py``).

Conventions, as in the reference package:

* event lists are ``[B, N, 4]`` rows ``(ts, y, x, p)``, ``ts`` normalised to
  [0, 1] inside a window;
* flow maps are ``[B, H, W, 2]``, channels ``(x, y)``;
* per-event flow vectors are ``[B, N, 2]`` in ``(y, x)`` order.

Everything runs on the tensors' device. Event lists have a padded length
``N``; padded events come in through ``valid`` and get weight 0, as do
corners outside the image, which land at pixel 0. The splats are one
``index_add_`` over the flattened ``[B * H * W]`` image (several images
sharing one index set in one call), which on the card adds in atomic order:
its sums differ from the CPU's by f32 rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["lookup_event_flow", "get_interpolation", "interpolate", "interpolate_multi",
           "deblur_events", "compute_pol_iwe", "upsample_flow"]

Tref = Union[torch.Tensor, float]


def _event_linear_idx(events: torch.Tensor, res: Sequence[int]) -> torch.Tensor:
    """Row-major pixel index of each event, ``floor(y) * W + floor(x)``,
    clamped into the image."""
    ys = torch.floor(events[..., 1]).to(torch.int64)
    xs = torch.floor(events[..., 2]).to(torch.int64)
    return torch.clamp(ys * int(res[1]) + xs, 0, int(res[0]) * int(res[1]) - 1)


def lookup_event_flow(flow_map: torch.Tensor, events: torch.Tensor,
                      res: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The flow under each event: ``flow_map [B, H, W, 2]`` (x, y) and
    ``events [B, N, 4]`` -> ``[B, N, 2]`` in (y, x) order."""
    B, H, W, _ = flow_map.shape
    if res is None:
        res = (H, W)
    elif tuple(res) != (H, W):
        raise ValueError(f"event resolution {tuple(res)} != flow map resolution {(H, W)}")
    lin = _event_linear_idx(events, res)
    gathered = torch.gather(flow_map.reshape(B, H * W, 2), 1,
                            lin[..., None].expand(*lin.shape, 2))
    return gathered.flip(-1)


def get_interpolation(events: torch.Tensor, flow: torch.Tensor, tref: Tref,
                      res: Sequence[int], flow_scaling: float, round_idx: bool = False,
                      valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp events to ``tref``: ``(y, x) + (tref - ts) flow flow_scaling``;
    returns ``(lin_idx [B, M] int64, weights [B, M])``, M = N with
    ``round_idx`` (the nearest pixel, ties to even, weight 1) else 4N (the
    bilinear corners: top-left, top-right, bottom-left, bottom-right, each a
    block of N). Corners outside the image, and padded events (``valid`` 0),
    weigh 0."""
    H, W = int(res[0]), int(res[1])
    ts = events[..., 0:1]
    warped = events[..., 1:3] + (tref - ts) * flow * flow_scaling  # [B, N, 2]
    if round_idx:
        idx = torch.round(warped)
        weights = torch.ones(idx.shape[:2], dtype=warped.dtype, device=warped.device)
    else:
        top, left = torch.floor(warped[..., 0:1]), torch.floor(warped[..., 1:2])
        bot, right = torch.floor(warped[..., 0:1] + 1.0), torch.floor(warped[..., 1:2] + 1.0)
        idx = torch.cat([torch.cat(c, dim=-1) for c in
                         ((top, left), (top, right), (bot, left), (bot, right))], dim=1)
        # the two factors multiplied, not torch.prod: its backward syncs the
        # host (a check for zeros) and runs a scan. A warp onto a pixel (as
        # a zero flow gives) puts its corners at the kinks; there the
        # gradients are jnp.abs's (+1 at 0, torch's abs: 0) and jnp.maximum's
        # (half to each side at a tie, clamp: all of it). Without a gradient
        # (the evaluation), abs and clamp: the same values in fewer launches
        d = warped.repeat(1, 4, 1) - idx
        if warped.requires_grad:
            hat = 1.0 - torch.where(d >= 0, d, -d)
            hat = torch.maximum(hat, hat.new_zeros(()))
        else:
            hat = torch.clamp(1.0 - d.abs(), min=0.0)
        weights = hat[..., 0] * hat[..., 1]
    in_bounds = (idx[..., 0] >= 0) & (idx[..., 0] < H) & (idx[..., 1] >= 0) & (idx[..., 1] < W)
    weights = weights * in_bounds.to(weights.dtype)
    if valid is not None:
        weights = weights * valid.to(weights.dtype).repeat(1, idx.shape[1] // valid.shape[1])
    idx = torch.where(in_bounds[..., None], idx, torch.zeros_like(idx)).to(torch.int64)
    return idx[..., 0] * W + idx[..., 1], weights


def _splat(lin_idx: torch.Tensor, weights: torch.Tensor, res: Sequence[int]) -> torch.Tensor:
    """``weights [B, M, C]`` added at ``lin_idx [B, M]`` into ``[B, H*W, C]``
    in one ``index_add_``."""
    H, W = int(res[0]), int(res[1])
    B, M, C = weights.shape
    offset = torch.arange(B, device=lin_idx.device).reshape(B, 1) * (H * W)
    img = torch.zeros(B * H * W, C, dtype=weights.dtype, device=weights.device)
    img.index_add_(0, (lin_idx + offset).reshape(-1), weights.reshape(B * M, C))
    return img.reshape(B, H * W, C)


def interpolate(lin_idx: torch.Tensor, weights: torch.Tensor, res: Sequence[int],
                polarity_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-add weighted events into ``[B, H, W]``; ``polarity_mask
    [B, M]`` multiplies the weights."""
    if polarity_mask is not None:
        weights = weights * polarity_mask
    H, W = int(res[0]), int(res[1])
    return _splat(lin_idx, weights[..., None], res).reshape(-1, H, W)


def interpolate_multi(lin_idx: torch.Tensor, weights: torch.Tensor,
                      res: Sequence[int]) -> torch.Tensor:
    """C images sharing one index set in one scatter: ``weights [B, M, C]``
    -> ``[B, H, W, C]``."""
    H, W = int(res[0]), int(res[1])
    return _splat(lin_idx, weights, res).reshape(-1, H, W, weights.shape[-1])


def deblur_events(flow_map: torch.Tensor, events: torch.Tensor, res: Sequence[int],
                  flow_scaling: float = 128, round_idx: bool = True,
                  polarity_mask: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None, tref: Tref = 1.0) -> torch.Tensor:
    """Events warped by the flow under them to ``tref`` and splatted:
    ``[B, H, W]``."""
    event_flow = lookup_event_flow(flow_map, events, res)
    idx, weights = get_interpolation(events, event_flow, tref, res, flow_scaling,
                                     round_idx=round_idx, valid=valid)
    if not round_idx and polarity_mask is not None:
        polarity_mask = polarity_mask.repeat(1, 4)
    return interpolate(idx, weights, res, polarity_mask=polarity_mask)


def compute_pol_iwe(flow_map: torch.Tensor, events: torch.Tensor, res: Sequence[int],
                    pos_mask: torch.Tensor, neg_mask: torch.Tensor, flow_scaling: float = 128,
                    round_idx: bool = True, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-polarity IWE pair, ``[B, H, W, 2]`` (pos, neg): one warp,
    both splats in one two-channel scatter."""
    event_flow = lookup_event_flow(flow_map, events, res)
    idx, weights = get_interpolation(events, event_flow, 1.0, res, flow_scaling,
                                     round_idx=round_idx, valid=valid)
    if not round_idx:
        pos_mask, neg_mask = pos_mask.repeat(1, 4), neg_mask.repeat(1, 4)
    return interpolate_multi(idx, torch.stack([weights * pos_mask, weights * neg_mask], -1), res)


def upsample_flow(flow: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of ``[B, H, W, C]`` flow.

    ``jax.image.resize(method="nearest")`` samples source index
    ``floor((i + 0.5) * in / out)``, which is torch's ``"nearest-exact"``;
    plain ``"nearest"`` (``floor(i * in / out)``) agrees only for integer
    ratios.
    """
    out = F.interpolate(flow.permute(0, 3, 1, 2), size=(target_h, target_w),
                        mode="nearest-exact")
    return out.permute(0, 2, 3, 1)
