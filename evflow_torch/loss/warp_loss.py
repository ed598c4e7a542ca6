"""Self-supervised contrast-maximisation loss, EventWarping (port of
``evflow/loss/warp_loss.py``).

Every event of a TBPTT window is warped forward (``tref = P``) and
backward (``tref = 0``) by the flow predicted at the pass it arrived in;
per-polarity images of the warped events' averaged timestamps are
penalised by their squared magnitude (over the number of active pixels
with ``loss_scaling``), plus a Charbonnier smoothness term over spatial
and temporal flow differences.

Conventions, as in the reference package: events ``[P, B, N, 4]`` rows
``(ts, y, x, p)`` with ``ts`` in [0, 1] per window (the pass offset ``+p``
is added here), padded events marked by ``valid [P, B, N]``; flow maps
``[P, B, H, W, 2]``, channels (x, y). Each direction's four images (pos,
neg, pos ts, neg ts) share the warp's index set and are one 4-channel
``index_add_`` (``ops.iwe.interpolate_multi``). Gradients reach the flow
maps through the bilinear weights; the corner indices carry none.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch

from evflow_torch.ops.iwe import get_interpolation, interpolate_multi, lookup_event_flow

__all__ = ["event_warping_loss", "EventWarpingConfig"]


def _charbonnier(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x * x + 1e-6)


def _timestamp_loss_one_direction(events: torch.Tensor, event_flow: torch.Tensor,
                                  pol_mask: torch.Tensor, valid: torch.Tensor, tref: float,
                                  ts_img_weights: torch.Tensor, max_ts: float,
                                  res: Sequence[int], flow_scaling: float,
                                  loss_scaling: bool) -> torch.Tensor:
    """One direction's timestamp-image loss: events ``[B, M, 4]`` (pass
    offsets added), their flow ``[B, M, 2]`` (y, x), ``pol_mask [B, M, 2]``,
    ``valid [B, M]``, the timestamps weighting the ts images ``[B, M]``."""
    idx, weights = get_interpolation(events, event_flow, tref, res, flow_scaling,
                                     round_idx=False, valid=valid)
    pol4 = pol_mask.repeat(1, 4, 1)
    ts4 = ts_img_weights.repeat(1, 4)
    imgs = interpolate_multi(idx, torch.stack([
        weights * pol4[..., 0],
        weights * pol4[..., 1],
        weights * ts4 * pol4[..., 0],
        weights * ts4 * pol4[..., 1],
    ], dim=-1), res)
    iwe_pos, iwe_neg = imgs[..., 0], imgs[..., 1]
    iwe_pos_ts = imgs[..., 2] / (iwe_pos + 1e-9) / max_ts
    iwe_neg_ts = imgs[..., 3] / (iwe_neg + 1e-9) / max_ts

    B = events.shape[0]
    loss = (iwe_pos_ts ** 2).reshape(B, -1).sum(dim=1) + (iwe_neg_ts ** 2).reshape(B, -1).sum(dim=1)
    if loss_scaling:
        nonzero_px = ((iwe_pos + iwe_neg) > 0).to(loss.dtype).reshape(B, -1)
        loss = loss / torch.clamp(nonzero_px.sum(dim=1), min=1.0)
    return loss.sum()


def _smoothness(flow_x: torch.Tensor, flow_y: torch.Tensor,
                event_mask: Optional[torch.Tensor], include_dt: bool) -> torch.Tensor:
    """Charbonnier smoothness of ``[B, P, H, W]`` flow over dx, dy and the
    two diagonals (and dt across passes); the x and y differences are
    summed before squaring, as in the reference. The dt component counts
    in the divisor whenever ``include_dt``, even for one pass."""
    pairs = [
        ((slice(None), slice(None, -1)), (slice(None), slice(1, None))),  # dx (along W)
        ((slice(None, -1), slice(None)), (slice(1, None), slice(None))),  # dy (along H)
        ((slice(None, -1), slice(None, -1)), (slice(1, None), slice(1, None))),  # down-right
        ((slice(1, None), slice(None, -1)), (slice(None, -1), slice(1, None))),  # up-right
    ]
    total = flow_x.new_zeros(())
    components = 4
    for s1, s2 in pairs:
        diff = _charbonnier((flow_x[..., s1[0], s1[1]] - flow_x[..., s2[0], s2[1]])
                            + (flow_y[..., s1[0], s1[1]] - flow_y[..., s2[0], s2[1]]))
        if event_mask is not None:
            diff = diff * (event_mask[..., s1[0], s1[1]] * event_mask[..., s2[0], s2[1]])
        total = total + diff.sum()
    if include_dt:
        components += 1
        if flow_x.shape[1] > 1:
            diff = _charbonnier((flow_x[:, :-1] - flow_x[:, 1:]) + (flow_y[:, :-1] - flow_y[:, 1:]))
            if event_mask is not None:
                diff = diff * (event_mask[:, :-1] * event_mask[:, 1:])
            total = total + diff.sum()
    return total / components / flow_x.shape[1]


def event_warping_loss(flow_maps: Sequence[torch.Tensor], events: torch.Tensor,
                       pol_mask: torch.Tensor, event_mask: torch.Tensor, valid: torch.Tensor,
                       *, flow_scaling: float, smoothness_weight: float,
                       res: Optional[Sequence[int]] = None, smoothing_mask: bool = False,
                       overwrite_intermediate: bool = False,
                       loss_scaling: bool = True) -> torch.Tensor:
    """The contrast-maximisation loss of a TBPTT window, averaged over the
    flow scales: ``flow_maps`` a list (one per scale) of ``[P, B, H, W,
    2]``, ``events [P, B, N, 4]``, ``pol_mask [P, B, N, 2]``, ``event_mask
    [P, B, H, W, 1]``, ``valid [P, B, N]``. Each event's flow is its own
    pass's map, or with ``overwrite_intermediate`` the last pass's."""
    P, B, N, _ = events.shape
    if res is None:
        res = tuple(flow_maps[0].shape[2:4])
    max_ts = float(P)

    offsets = torch.arange(P, dtype=events.dtype, device=events.device)[:, None, None]
    events_off = torch.cat([(events[..., 0] + offsets)[..., None], events[..., 1:]], dim=-1)

    def flat(x):  # [P, B, N, ...] -> [B, P*N, ...]
        return x.movedim(0, 1).reshape((B, P * N) + tuple(x.shape[3:]))

    events_all = flat(events_off)
    pol_all = flat(pol_mask)
    valid_all = flat(valid)

    total = events.new_zeros(())
    for flow_seq in flow_maps:
        if overwrite_intermediate:
            event_flow = lookup_event_flow(flow_seq[-1], events_all, res)
            flow_x = flow_seq[-1:, ..., 0].movedim(0, 1)
            flow_y = flow_seq[-1:, ..., 1].movedim(0, 1)
            mask_seq = event_mask[..., 0].amax(dim=0, keepdim=True).movedim(0, 1)
            include_dt = False
        else:
            H, W = flow_seq.shape[2:4]
            per_pass = lookup_event_flow(flow_seq.reshape(P * B, H, W, 2),
                                         events_off.reshape(P * B, N, 4), res)
            event_flow = flat(per_pass.reshape(P, B, N, 2))
            flow_x = flow_seq[..., 0].movedim(0, 1)  # [B, P, H, W]
            flow_y = flow_seq[..., 1].movedim(0, 1)
            mask_seq = event_mask[..., 0].movedim(0, 1)
            include_dt = True

        fw = _timestamp_loss_one_direction(
            events_all, event_flow, pol_all, valid_all, tref=max_ts,
            ts_img_weights=events_all[..., 0], max_ts=max_ts, res=res,
            flow_scaling=flow_scaling, loss_scaling=loss_scaling)
        bw = _timestamp_loss_one_direction(
            events_all, event_flow, pol_all, valid_all, tref=0.0,
            ts_img_weights=max_ts - events_all[..., 0], max_ts=max_ts, res=res,
            flow_scaling=flow_scaling, loss_scaling=loss_scaling)
        smooth = _smoothness(flow_x, flow_y, mask_seq if smoothing_mask else None, include_dt)
        total = total + fw + bw + smoothness_weight * smooth
    return total / len(flow_maps)


class EventWarpingConfig:
    """The loss with its settings from a config: ``loader.resolution``,
    ``loss.flow_regul_weight``, ``model.mask_output`` (the smoothing mask)
    and ``loss.overwrite_intermediate``; ``flow_scaling`` defaults to the
    larger side of the resolution."""

    def __init__(self, config: Mapping[str, Any], flow_scaling: Optional[float] = None,
                 loss_scaling: bool = True):
        self.res = tuple(config["loader"]["resolution"])
        self.flow_scaling = flow_scaling if flow_scaling is not None else max(self.res)
        self.weight = config["loss"]["flow_regul_weight"]
        self.smoothing_mask = bool(config.get("model", {}).get("mask_output", False))
        self.overwrite_intermediate = bool(
            config.get("loss", {}).get("overwrite_intermediate", False))
        self.loss_scaling = loss_scaling

    def __call__(self, flow_maps, events, pol_mask, event_mask, valid) -> torch.Tensor:
        return event_warping_loss(
            flow_maps, events, pol_mask, event_mask, valid, flow_scaling=self.flow_scaling,
            smoothness_weight=self.weight, res=self.res, smoothing_mask=self.smoothing_mask,
            overwrite_intermediate=self.overwrite_intermediate, loss_scaling=self.loss_scaling)
