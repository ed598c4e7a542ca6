"""Ground-truth evaluation loop (port of the per-window host-metric path of
``evflow/eval.py::evaluate``).

Protocol, as in the reference package:

* AEE needs a GT-flow mode and a window <= 1 whose inverse is an integer;
* model state resets per batch slot at sequence rollovers, in the state
  layout of the net that runs (``FireNet`` NHWC, or ``FusedFireNet``'s);
* ``keep_gt_full_res``: predictions are nearest-upsampled to the GT
  resolution and scaled by the spatial factor, and the metrics' flow
  scaling becomes ``base * (model_res / 128) / 2``;
* the AEE cadence: a slot advances its counter only on windows with
  ``dt_gt > 0`` and is scored every ``round(1 / window)`` such windows;
* results accumulate per HDF5 file (value and outlier percent).

Counts cross to the device as uint8 (uint16 past 255) when they are exact
integers (no downsampling), and become f32 there. The chunked dispatch,
on-device metrics, visualisation, activity logs and results files of the
reference loop come with later slices.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from evflow_torch import registry
from evflow_torch.data.h5_stream import H5EventStream, Prefetcher
from evflow_torch.device import resolve_device
from evflow_torch.ops.iwe import upsample_flow

__all__ = ["evaluate", "reset_slot_states"]


def reset_slot_states(states, state_model, flags, batch: int, height: int, width: int):
    """Zero the carries of the slots flagged in ``flags [B]``; ``state_model``
    gives the fresh states in its own layout (batch first in every layout)."""
    flags = np.asarray(flags, bool)
    if not flags.any():
        return states
    fresh = state_model.init_states(batch, height, width)
    sel = torch.as_tensor(flags, device=fresh[0].mem.device).reshape(batch, 1, 1, 1)
    return tuple(type(old)(*(torch.where(sel, n, o) for o, n in zip(old, new)))
                 for old, new in zip(states, fresh))


@torch.no_grad()
def evaluate(
    config: Dict[str, Any],
    variables: Optional[Dict[str, Any]] = None,
    model=None,
    fused: bool = False,
    layout: str = "nhwc",
    device: Optional[Union[str, torch.device]] = None,
    max_windows: Optional[int] = None,
    stats: Optional[Dict[str, Any]] = None,
):
    """Run the evaluation protocol; returns the per-file results dict
    ``{metric: {file: str(value)}, metric + "_percent": {...}}``.

    Weights: ``model`` (a port ``FireNet``, e.g. loaded from a reference
    ``.pth`` with ``weights.load_checkpoint``), else ``variables`` (flax
    ``params``/``batch_stats`` as arrays, see ``weights.from_jax_variables``),
    else the model's own init.
    ``fused`` runs ``FusedFireNet`` in ``layout`` on the fused kernels.
    ``device`` defaults to the GPU. ``stats``, if given, receives the
    number of windows run and the wall seconds of the loop.
    """
    metrics_cfg = config.get("metrics", {})
    names = metrics_cfg.get("name", [])
    mode = config["data"]["mode"]
    window = config["data"]["window"]
    if names and mode not in ("gtflow_dt1", "gtflow_dt4"):
        raise ValueError(f"metrics {names} need ground-truth flow — set data.mode "
                         f"to gtflow_dt1/gtflow_dt4 (got {mode!r})")
    if "AEE" in names:
        if window > 1:
            raise ValueError("AEE computation not compatible with window > 1")
        if not np.isclose((1.0 / window) % 1.0, 0.0):
            raise ValueError("AEE needs a window whose inverse is an integer")

    device = resolve_device(device)
    model_cfg = config["model"]
    if model is None:
        model = registry.build_model(model_cfg, device=device)
        if variables is not None:
            from evflow_torch.weights import from_jax_variables

            model.load_state_dict(from_jax_variables(variables))
    model = model.to(device).eval()

    loader = config["loader"]
    H, W = loader["resolution"]
    B = int(loader.get("batch_size", 1))
    flow_scaling = float(metrics_cfg.get("flow_scaling", 128))
    criteria = registry.build_metrics(config, flow_scaling)
    keep_gt_full_res = bool(loader.get("keep_gt_full_res", False))
    if keep_gt_full_res and criteria:
        adjusted = flow_scaling * (loader["resolution"][0] / 128) / 2
        for c in criteria:
            c.flow_scaling = adjusted

    encoding = model_cfg.get("encoding", "cnt")
    if fused:
        from evflow_torch.models.fused import FusedFireNet

        net = FusedFireNet.from_firenet(model, layout=layout)

        def step(voxel, cnt, st):
            return net.step(voxel if encoding == "voxel" else cnt, st)
    else:
        net = model

        def step(voxel, cnt, st):
            out, st2 = model(voxel, cnt, st)
            return out["flow"][-1], st2
    states = net.init_states(B, H, W)

    cadence = int(np.round(1.0 / window)) if window else 1
    idx_aee = np.zeros(B, np.int64)
    std_res = tuple(loader.get("std_resolution", loader["resolution"]))
    compact_wire = tuple(loader["resolution"]) == std_res  # counts not pooled
    wire = {"dtype": np.uint8}
    val_results: Dict[str, Dict[str, Dict[str, float]]] = {}

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

    def encode_wire(batch):
        """Host arrays for one window: the encoding the model reads, counts
        as uint8/uint16 when exact (sticky once widened)."""
        if encoding == "voxel":
            return upload(batch["event_voxel"]), None
        cnt = batch["event_cnt"]
        if compact_wire:
            if wire["dtype"] is np.uint8 and cnt.max() > 255:
                wire["dtype"] = np.uint16
            if wire["dtype"] is np.uint16:
                # torch has no uint16 arithmetic: ship the bits as int16 and
                # widen on the device
                bits = upload(cnt.astype(np.uint16).view(np.int16))
                return None, (bits.to(torch.int32) & 0xFFFF).float()
            return None, upload(cnt.astype(np.uint8)).float()
        return None, upload(cnt).float()

    def metric_values(i):
        v = criteria[i]()
        if isinstance(v, tuple):
            return tuple(t.cpu().numpy() for t in v)
        return v.cpu().numpy()

    def accumulate(batch):
        dt_gt = np.asarray(batch["dt_gt"], np.float64).reshape(-1)
        for i, mname in enumerate(names):
            if mname == "AEE":
                idx_aee[dt_gt > 0.0] += 1
                due = (idx_aee >= cadence) & (dt_gt > 0.0)
                if not due.any():
                    continue
            else:
                due = np.ones(B, np.bool_)
            val = metric_values(i)
            if mname == "AEE":
                idx_aee[due] = 0
            for b in np.flatnonzero(due):
                entry = val_results.setdefault(batch["file_names"][b], {}).setdefault(
                    mname, {"metric": 0.0, "it": 0, "percent": 0.0})
                entry["it"] += 1
                if criteria[i].has_percent:
                    entry["metric"] += float(val[0][b])
                    entry["percent"] += float(val[1][b])
                else:
                    entry["metric"] += float(val[b])
            criteria[i].reset()

    windows_done = 0
    t0 = time.perf_counter()
    data = H5EventStream(config, model_cfg.get("num_bins", 2),
                         model_cfg.get("round_encoding", False))
    fetch = Prefetcher(data, depth=2)
    try:
        while True:
            batch = next(fetch)
            if batch["epoch_done"]:
                break
            if batch["new_seq"].any():
                states = reset_slot_states(states, net, batch["new_seq"], B, H, W)
                for c in criteria:
                    c.reset(slots=batch["new_seq"])
                idx_aee[np.asarray(batch["new_seq"])] = 0

            voxel, cnt = encode_wire(batch)
            flow, states = step(voxel, cnt, states)
            if keep_gt_full_res and "gtflow" in batch:
                gh, gw = batch["gtflow"].shape[1:3]
                ph, pw = flow.shape[1:3]
                if gh > ph or gw > pw:
                    scale = torch.tensor([gw / pw, gh / ph], device=device)
                    flow = upsample_flow(flow, gh, gw) * scale
            if names:
                inputs = {k: upload(batch[k]) for k in ("gtflow", "event_mask",
                                                        "dt_gt", "dt_input")}
                for c in criteria:
                    c.event_flow_association([flow], inputs)
                accumulate(batch)

            windows_done += B
            if max_windows is not None and windows_done >= max_windows:
                break
    finally:
        fetch.close()
        data.close()
    if stats is not None:
        stats.update(windows=windows_done, seconds=time.perf_counter() - t0)

    results: Dict[str, Dict[str, str]] = {}
    for i, mname in enumerate(names):
        results[mname] = {}
        has_pct = criteria[i].has_percent and any(
            mname in v and v[mname]["it"] for v in val_results.values())
        if has_pct:
            results[mname + "_percent"] = {}
        for fname, v in val_results.items():
            if mname not in v or v[mname]["it"] == 0:
                continue
            results[mname][fname] = str(v[mname]["metric"] / v[mname]["it"])
            if has_pct:
                results[mname + "_percent"][fname] = str(v[mname]["percent"] / v[mname]["it"])
    return results
