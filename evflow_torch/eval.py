"""Ground-truth evaluation loop (port of ``evflow/eval.py::evaluate``).

Protocol, as in the reference package:

* AEE needs a GT-flow mode and a window <= 1 whose inverse is an integer;
* model state resets per batch slot at sequence rollovers, in the state
  layout of the net that runs (``FireNet`` NHWC, or ``FusedFireNet``'s);
* ``keep_gt_full_res``: predictions are nearest-upsampled to the GT
  resolution and scaled by the spatial factor, and the metrics' flow
  scaling becomes ``base * (model_res / 128) / 2``;
* the AEE cadence: a slot advances its counter only on windows with
  ``dt_gt > 0`` and is scored every ``round(1 / window)`` such windows;
* results accumulate per sequence file (value and outlier percent) and,
  unless ``debug``, go to ``<path_results>/<runid>/metrics_N.yml`` beside
  the config as ``eval_N.yml`` (and the heat maps, with
  ``metrics.heat_map``).

Dispatch. Counts cross to the device as uint8 (uint16 past 255, sticky)
when they are exact integers (no downsampling), and become f32 there.
``chunk=1`` runs one step a window and fetches its flow; the host metric
protocol runs on the CPU over the fetched flows. ``chunk=K`` runs K
windows as one dispatch (``evflow_torch.chunk.ChunkProgram``: one CUDA
graph replay on the card) and fetches the K flows in one copy.
``device_metrics`` also computes every metric's ``[K, B]`` values and the
heat-map sums inside that dispatch, and fetches only the values, one chunk
behind (depth-1 pipelining). Chunks flush at sequence rollovers, at the end
of the data and at ``max_windows``; a partial chunk runs the per-window
program, and ``max_windows`` may be overshot by up to ``chunk - 1``
windows.

Visualisation (``vis.store``, ``vis.enabled``, ``collect_vis``) needs each
window's flow on the host and the image of its warped events (IWE, from
the window's event list): in the per-window program the IWE runs on the
window's device beside the step and is fetched with the flow; in a chunk it
runs on the CPU over the fetched flows. ``vis.activity`` logs each layer's
fraction of nonzero activations through the unfused step (the fused one
refuses it), fetched with the flows or with the device metrics' values.
With ``model.temporal_cnt`` the counts cross as f32: their channel 0 is
signed.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from evflow_torch import registry
from evflow_torch.chunk import ChunkProgram
from evflow_torch.data.h5_stream import H5EventStream, Prefetcher
from evflow_torch.device import resolve_device
from evflow_torch.loss import metrics as M
from evflow_torch.ops.iwe import compute_pol_iwe, upsample_flow

__all__ = ["evaluate", "reset_slot_states", "SPLIT_PARTS"]

# the parts of a window's time that ``stats={"split": True}`` measures:
# "capture" is the host time of the dispatches that run a chunk program's
# first chunk eagerly and capture it (their device time is not counted)
SPLIT_PARTS = ("prefetch", "encode_upload", "enqueue", "device", "metrics", "capture")
_HEATMAP_METRICS = ("AEE", "AAE", "NAAE")
# the card sleeps this many cycles before a timed dispatch, so that the
# events time its work back to back (~10 ms at the H100's 1.98 GHz)
_SLEEP_CYCLES = 20_000_000


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


def _window_metric_values(criteria, names, flow, gtflow, event_mask, dt_gt, dt_input,
                         want_heatmaps: bool):
    """Every metric of one window on the tensors' device, with no sync:
    the value rows (``[B]`` each: a metric's value, then its percent where
    it has one) and, for AEE, AAE and NAAE with ``want_heatmaps``, the
    batch-summed ``(error * mask, mask)`` maps, gated as the host protocol
    gates its criterion calls (AEE only on a window where a slot has
    ``dt_gt > 0``: exact at cadence 1)."""
    rows, hmaps = [], []
    for name, crit in zip(names, criteria):
        args = (flow, gtflow, event_mask, dt_gt, dt_input, crit.flow_scaling)
        hm = None
        if name == "AEE":
            v, p, err, mask = M.aee(*args)
            rows += [v, p]
            hm = (err, mask, (dt_gt > 0.0).any())
        elif name == "NEE":
            rows += list(M.nee(*args)[:2])
        elif name == "AAE":
            v, p, err, mask = M.aae(*args, crit.strict)
            rows += [v, p]
            hm = (err, mask, None)
        elif name == "NAAE":
            v, err, mask = M.naae(*args)
            rows.append(v)
            hm = (err, mask, None)
        elif name == "AE_ofMeans":
            rows.append(M.ae_of_means(*args))
        elif name == "AAE_Weighted":
            rows.append(M.aae_weighted(*args))
        elif name == "AAE_Filtered":
            rows.append(M.aae_filtered(*args, crit.mag_threshold))
        else:  # the registry holds the set above; fail loudly if it grows
            raise NotImplementedError(f"device metric {name!r}")
        if want_heatmaps and hm is not None:
            err, mask, gate = hm
            e, c = (err * mask).sum(dim=0), mask.sum(dim=0)
            if gate is not None:
                g = gate.to(e.dtype)
                e, c = e * g, c * g
            hmaps += [e, c]
    return rows, hmaps


class _Split:
    """Per-part host time of the loop (``SPLIT_PARTS``), each part between
    two syncs of the device, and the device time of each dispatch by CUDA
    events with the card asleep while the host enqueues. Off, every part is
    a no-op."""

    def __init__(self, device: torch.device, on: bool):
        self.on = on
        self.cuda = device.type == "cuda"
        self.ms = {p: 0.0 for p in SPLIT_PARTS}
        self.slow = 0  # dispatches whose enqueue took over 5 ms

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def part(self, name: str):
        if not self.on:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.ms[name] += 1e3 * (time.perf_counter() - t0)

    @contextlib.contextmanager
    def dispatch(self, program: Optional[ChunkProgram] = None):
        if not self.on:
            yield
            return
        self._sync()
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SLEEP_CYCLES)
            start.record()
        t0 = time.perf_counter()
        yield
        host = 1e3 * (time.perf_counter() - t0)
        if self.cuda:
            end.record()
            self._sync()
        if program is not None and program.captured:
            self.ms["capture"] += host
            return
        self.ms["enqueue"] += host
        if self.cuda:
            self.ms["device"] += start.elapsed_time(end)
            self.slow += host > 5.0


def _widen(x: torch.Tensor) -> torch.Tensor:
    """The wire's counts as f32: uint16 counts cross as int16 bits (torch
    has no uint16 arithmetic)."""
    if x.dtype == torch.int16:
        return (x.to(torch.int32) & 0xFFFF).float()
    return x.float()


@torch.no_grad()
def evaluate(
    config: Dict[str, Any],
    checkpoint: Optional[str] = None,
    variables: Optional[Dict[str, Any]] = None,
    model=None,
    fused: bool = False,
    layout: str = "nhwc",
    device: Optional[Union[str, torch.device]] = None,
    path_results: str = "results_inference",
    runid: str = "eval",
    debug: bool = False,
    max_windows: Optional[int] = None,
    chunk: int = 1,
    device_metrics: bool = False,
    stats: Optional[Dict[str, Any]] = None,
    collect_vis: bool = False,
):
    """Run the evaluation protocol; returns the per-file results dict
    ``{metric: {file: str(value)}, metric + "_percent": {...}}``, and with
    ``collect_vis`` also a list of each window's ``{"flow", "iwe",
    "event_cnt", "gtflow"}`` host arrays.

    Weights: ``model`` (a port ``FireNet``), else the config's model; then
    ``variables`` (flax ``params``/``batch_stats`` as arrays, see
    ``weights.from_jax_variables``), else ``checkpoint`` (a reference
    ``.pth``/``.pt``, see ``weights.load_checkpoint``), else the model's own
    weights. ``fused`` runs ``FusedFireNet`` in ``layout`` on the fused
    kernels. ``device`` defaults to the GPU. ``chunk`` and
    ``device_metrics`` as in the module's docstring. ``stats``, if given,
    receives the windows run and the wall seconds of the loop; with
    ``stats["split"]`` true the loop syncs between the parts of
    ``SPLIT_PARTS`` and ``stats["split_ms"]`` receives each part's ms a
    window of the run (``"device"`` None off the card) and
    ``stats["slow_enqueues"]`` the dispatches, captures aside, whose
    enqueue took over 5 ms: their device time may hold the card's wait for
    the host. ``stats["encoder"]`` names the stream's encoder
    (``H5EventStream.encoder``) and, with ``vis.activity``,
    ``stats["activity"]`` holds the activity log (a list a layer, reset at
    each rollover).
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
    vis_cfg = config.get("vis") or {}
    log_activity = bool(vis_cfg.get("activity", False))
    store_vis = bool(vis_cfg.get("store", False)) and not debug
    live_vis = bool(vis_cfg.get("enabled", False))
    if fused and log_activity:
        raise ValueError("fused backend does not support activity logging")
    chunk = max(int(chunk), 1)
    want_heatmaps = bool(metrics_cfg.get("heat_map", False))
    cadence = int(np.round(1.0 / window)) if window else 1
    if device_metrics:
        if chunk <= 1:
            raise ValueError("device_metrics needs chunk > 1 (per-window "
                             "dispatch is host-driven)")
        if not names:
            raise ValueError("device_metrics without metrics does nothing — "
                             "drop the flag or configure metrics.name")
        if collect_vis or store_vis or live_vis:
            raise ValueError("device_metrics never fetches flow maps; "
                             "vis/collect_vis need them — disable one")
        if want_heatmaps and cadence != 1:
            raise ValueError("device_metrics with metrics.heat_map needs "
                             "window == 1 (the AEE criterion-call gate is "
                             "evaluated in-graph)")
    if checkpoint and variables is None and not checkpoint.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"checkpoint {checkpoint!r}: only reference .pth/.pt files are read; evflow "
            "msgpack checkpoints come with ROADMAP.md queue 1 item 6")

    device = resolve_device(device)
    model_cfg = config["model"]
    if model is None:
        model = registry.build_model(model_cfg, device=device)
    if variables is not None:
        from evflow_torch.weights import from_jax_variables

        model.load_state_dict(from_jax_variables(variables))
    elif checkpoint:
        from evflow_torch.weights import load_checkpoint

        model.load_state_dict(load_checkpoint(checkpoint))
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

    eval_id = -1
    if not debug:
        from evflow_torch.utils.tracker import create_model_dir, log_config

        path_results = create_model_dir(path_results, runid)
        eval_id = log_config(path_results, runid, config)
    vis = None
    if store_vis or live_vis:
        from evflow_torch.utils.viz import Visualization

        vis = Visualization(config, eval_id=eval_id,
                            path_results=path_results if store_vis else None)
    want_iwe = collect_vis or vis is not None
    activity_log: Optional[Dict[str, list]] = None
    act_keys: List[str] = []

    encoding = model_cfg.get("encoding", "cnt")
    counted = ()
    if fused:
        from evflow_torch.models.fused import FusedFireNet
        from evflow_torch.ops.conv_lif import fused_conv_lif
        from evflow_torch.ops.conv_lif_cmajor import fused_conv_lif_cmajor

        net = FusedFireNet.from_firenet(model, layout=layout)
        counted = (fused_conv_lif, fused_conv_lif_cmajor)

        def step(x, st):
            flow, st2 = net.step(_widen(x), st)
            return flow, st2, None
    else:
        net = model

        def step(x, st):
            """(flow, states, activity: the layers' nonzero fractions
            ``[T]`` in ``act_keys`` order, or None)."""
            x = _widen(x)
            args = (x, None) if encoding == "voxel" else (None, x)
            out, st2 = model(*args, st, log=log_activity)
            act = None
            if log_activity:
                if not act_keys:
                    act_keys.extend(out["activity"])
                act = torch.stack([out["activity"][k] for k in act_keys])
            return out["flow"][-1], st2, act
    states = net.init_states(B, H, W)
    n_states = len(states)

    def flat(st):
        return [t for s in st for t in s]

    def unflat(ts):
        return tuple(type(s)(*ts[2 * i:2 * i + 2]) for i, s in enumerate(states))

    idx_aee = np.zeros(B, np.int64)
    std_res = tuple(loader.get("std_resolution", loader["resolution"]))
    # counts not pooled, and unsigned (temporal_cnt's channel 0 is signed)
    compact_wire = (tuple(loader["resolution"]) == std_res
                    and not bool(model_cfg.get("temporal_cnt", False)))
    derive_mask = encoding == "cnt" and compact_wire
    wire = {"dtype": np.uint8}
    val_results: Dict[str, Dict[str, Dict[str, float]]] = {}
    vis_frames: List[Dict[str, Any]] = []
    split = _Split(device, bool(stats and stats.get("split")))
    windows_done = 0

    def encode_wire(batch) -> np.ndarray:
        """The host array the model reads: voxels, or counts as uint8 /
        uint16 (as int16 bits) when exact, sticky once widened."""
        if encoding == "voxel":
            return np.asarray(batch["event_voxel"], np.float32)
        cnt = batch["event_cnt"]
        if not compact_wire:
            return np.asarray(cnt, np.float32)
        if wire["dtype"] is np.uint8 and cnt.max() > 255:
            wire["dtype"] = np.uint16
        if wire["dtype"] is np.uint16:
            return cnt.astype(np.uint16).view(np.int16)
        return cnt.astype(np.uint8)

    scales: Dict[tuple, torch.Tensor] = {}

    def full_res(flow, gh, gw):
        """The flow nearest-upsampled to the GT's resolution and scaled by
        the factor (x, y); the factor's tensor is made once a device, as a
        graph capture cannot copy it up."""
        ph, pw = flow.shape[1:3]
        if gh <= ph and gw <= pw:
            return flow
        key = (flow.device, gh, gw, ph, pw)
        if key not in scales:
            scales[key] = torch.tensor([gw / pw, gh / ph], device=flow.device)
        return upsample_flow(flow, gh, gw) * scales[key]

    def accumulate_metrics(batch, value_of, post=None):
        """The cadence and per-file bookkeeping, shared by the host and the
        device metric paths."""
        dt_gt = np.asarray(batch["dt_gt"], np.float64).reshape(-1)
        for i, mname in enumerate(names):
            if mname == "AEE":
                idx_aee[dt_gt > 0.0] += 1
                due = (idx_aee >= cadence) & (dt_gt > 0.0)
                if not due.any():
                    continue
            else:
                due = np.ones(B, np.bool_)
            val = value_of(i)
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
            if post is not None:
                post(i)

    def host_value(i):
        v = criteria[i]()
        return tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy()

    def window_iwe(flow: torch.Tensor, batch) -> torch.Tensor:
        """The window's per-polarity IWE ``[B, H, W, 2]`` on the flow's
        device, at the model's resolution, before any upsampling."""
        ev, pm, va = (torch.from_numpy(batch[k]).to(flow.device, non_blocking=True)
                      for k in ("event_list", "event_list_pol_mask", "event_valid"))
        return compute_pol_iwe(flow, ev, (H, W), pm[..., 0], pm[..., 1],
                               flow_scaling=flow_scaling, round_idx=True, valid=va)

    def handle_activity(act):
        nonlocal activity_log
        if act is not None:
            from evflow_torch.utils.viz import vis_activity

            activity_log = vis_activity({k: float(v) for k, v in zip(act_keys, act)},
                                        activity_log, live=live_vis)

    def process_window(batch, flow: torch.Tensor, act=None, iwe=None):
        """The host protocol of one window over its fetched flow (a CPU
        tensor): activity, the IWE (on the CPU unless given), upsampling,
        association, cadence, accumulation and the visualisation."""
        nonlocal windows_done
        handle_activity(act)
        if want_iwe and iwe is None:
            iwe = window_iwe(flow, batch)
        if keep_gt_full_res and "gtflow" in batch:
            flow = full_res(flow, *batch["gtflow"].shape[1:3])
        if collect_vis:
            vis_frames.append({"flow": flow.numpy(), "iwe": iwe.numpy(),
                               "event_cnt": batch["event_cnt"], "gtflow": batch.get("gtflow")})
        if names:
            # contiguous: the GT arrives channel-planar, and strided
            # elementwise math costs the CPU several times more
            inputs = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                      for k in ("gtflow", "event_mask", "dt_gt", "dt_input")}
            for c in criteria:
                c.event_flow_association([flow], inputs)
            accumulate_metrics(batch, host_value, post=lambda i: criteria[i].reset())
        if vis is not None:
            store_window(batch, flow.numpy(), iwe.numpy())
        windows_done += B

    def store_window(batch, fl: np.ndarray, iwe: np.ndarray):
        """Show and store the window's panels: batch slot 0, its flow masked
        by the events where the resolutions agree, and the first metric's
        error map of this window, if one was scored."""
        em = np.asarray(batch["event_mask"])
        masked = fl * (em > 0) if em.shape[1:3] == fl.shape[1:3] else None
        err_map, err_is_angle = None, False
        for i, mname in enumerate(names):
            em_i = criteria[i].get_error_map()
            if em_i is not None:
                err_map, err_is_angle = em_i, mname in ("AAE", "NAAE")
                break
        vis.update(batch, fl, iwe=iwe, masked_flow=masked)
        vis.store(batch, fl, iwe, os.path.splitext(batch["file_names"][0])[0],
                  masked_flow=masked, ts=float(np.asarray(batch["ts"]).reshape(-1)[0]),
                  error_map=err_map, error_is_angle=err_is_angle)

    # each metric's first row in the device path's [R, K, B] values
    first_row = np.cumsum([0] + [1 + c.has_percent for c in criteria])

    def chunk_body(x, carry):
        st = unflat(carry[:2 * n_states])
        flows, acts = [], []
        for k in range(x["w"].shape[0]):
            flow, st, act = step(x["w"][k], st)
            flows.append(flow)
            acts.append(act)
        out = {"flow": torch.stack(flows)}
        if log_activity:
            out["act"] = torch.stack(acts)
        return out, flat(st)

    def metrics_body(x, carry):
        st = unflat(carry[:2 * n_states])
        hm = list(carry[2 * n_states:])
        vals = []
        for k in range(x["w"].shape[0]):
            wk = x["w"][k]
            flow, st, act = step(wk, st)
            gt = x["gt"][k]
            mask = (_widen(wk).sum(-1) > 0).to(torch.uint8) if derive_mask else x["m"][k]
            if keep_gt_full_res:
                flow = full_res(flow, *gt.shape[1:3])
            rows, hmaps = _window_metric_values(criteria, names, flow, gt, mask, x["dtg"][k],
                                               x["dti"][k], want_heatmaps)
            if act is not None:  # the window's activity rides as rows of its own
                rows += list(act[:, None].expand(act.shape[0], B))
            vals.append(torch.stack(rows))
            hm = [a + b for a, b in zip(hm, hmaps)]
        return {"vals": torch.stack(vals, dim=1)}, flat(st) + hm

    program = None
    if chunk > 1:
        program = ChunkProgram(metrics_body if device_metrics else chunk_body, device, counted)
    hm_dev: Optional[List[torch.Tensor]] = None
    pending: list = []
    inflight: list = []  # (batches, values on their way to the host, event)
    fetch_bufs: List[torch.Tensor] = []

    def drain_inflight(keep=0):
        """Accumulate dispatched device-metric chunks in stream order,
        leaving at most ``keep`` in flight: with ``keep=1`` the newest
        chunk computes while the host stages the next."""
        nonlocal windows_done
        while len(inflight) > keep:
            batches, vals, done = inflight.pop(0)
            with split.part("metrics"):
                if done is not None:
                    done.synchronize()
                v = vals.numpy()
                for k, b in enumerate(batches):
                    if log_activity:
                        handle_activity(v[first_row[-1]:, k, 0])

                    def value_of(i, _k=k):
                        r0 = first_row[i]
                        return tuple(v[r0:r0 + 2, _k]) if criteria[i].has_percent else v[r0, _k]

                    accumulate_metrics(b, value_of)
            windows_done += B * len(batches)

    def fetch_async(vals: torch.Tensor):
        """Start the values' copy to the host; returns (host tensor, event)."""
        if device.type != "cuda":
            return vals, None
        # two buffers in turns: a chunk's values are read one chunk on
        if len(fetch_bufs) < 2:
            buf = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        else:
            buf = fetch_bufs.pop(0)
        fetch_bufs.append(buf)
        buf.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    def run_pending():
        """Dispatch the buffered windows: one chunk dispatch when there are
        ``chunk`` of them, the per-window program otherwise."""
        nonlocal states, hm_dev
        if not pending:
            return
        full = program is not None and len(pending) == chunk
        if full and device_metrics:
            with split.part("encode_upload"):
                inputs = {"w": [encode_wire(p) for p in pending],
                          "gt": [np.asarray(p["gtflow"], np.float32) for p in pending],
                          "dtg": [np.asarray(p["dt_gt"], np.float32).reshape(-1)
                                  for p in pending],
                          "dti": [np.asarray(p["dt_input"], np.float32).reshape(-1)
                                  for p in pending]}
                if not derive_mask:
                    inputs["m"] = [(np.asarray(p["event_mask"])[..., 0] > 0).astype(np.uint8)
                                   for p in pending]
                if hm_dev is None:
                    # at the metrics' resolution: the GT's (std when
                    # keep_gt_full_res upsamples, else the model's)
                    res = inputs["gt"][0].shape[1:3]
                    n_hm = sum(2 for n in names if n in _HEATMAP_METRICS) if want_heatmaps else 0
                    hm_dev = [torch.zeros(res, device=device) for _ in range(n_hm)]
                program.stage(inputs, flat(states) + hm_dev)
            with split.dispatch(program):
                out, carry = program.run()
                vals, done = fetch_async(out["vals"])
            states, hm_dev = unflat(carry[:2 * n_states]), carry[2 * n_states:]
            inflight.append((list(pending), vals, done))
            pending.clear()
            drain_inflight(keep=1)
            return
        # windows processed now must follow the chunks still in flight
        drain_inflight()
        if full:
            with split.part("encode_upload"):
                program.stage({"w": [encode_wire(p) for p in pending]}, flat(states))
            with split.dispatch(program):
                out, carry = program.run()
            states = unflat(carry)
            with split.part("metrics"):
                flows = out["flow"].cpu()  # the chunk's one fetch
                acts = out["act"].cpu() if log_activity else None
                for k, b in enumerate(pending):
                    process_window(b, flows[k], acts[k] if log_activity else None)
        else:
            for b in pending:
                with split.part("encode_upload"):
                    x = torch.from_numpy(encode_wire(b)).to(device, non_blocking=True)
                with split.dispatch():
                    flow, states, act = step(x, states)
                    iwe = window_iwe(flow, b) if want_iwe else None
                with split.part("metrics"):
                    process_window(b, flow.cpu(), None if act is None else act.cpu(),
                                   None if iwe is None else iwe.cpu())
        pending.clear()

    t0 = time.perf_counter()
    data = H5EventStream(config, model_cfg.get("num_bins", 2),
                         model_cfg.get("round_encoding", False))
    fetch = Prefetcher(data, depth=2)
    try:
        while True:
            with split.part("prefetch"):
                batch = next(fetch)
            if batch["epoch_done"]:
                run_pending()
                drain_inflight()
                break
            if batch["new_seq"].any():
                # flush, so that the carries reset before this window runs
                # and in-flight chunks accumulate before the cadence resets
                run_pending()
                drain_inflight()
                activity_log = None
                states = reset_slot_states(states, net, batch["new_seq"], B, H, W)
                for c in criteria:
                    c.reset(slots=batch["new_seq"])
                idx_aee[np.asarray(batch["new_seq"])] = 0
            pending.append(batch)
            if len(pending) >= chunk:
                run_pending()
            if max_windows is not None:
                # windows_done lags by the chunk in flight
                if windows_done + B * sum(len(b) for b, _, _ in inflight) >= max_windows:
                    drain_inflight()
                if windows_done >= max_windows:
                    run_pending()
                    drain_inflight()
                    break
    finally:
        fetch.close()  # join the prefetch thread before closing its files
        data.close()
        if vis is not None:
            vis.close_videos()
    if log_activity and activity_log and not debug:
        from evflow_torch.utils.viz import vis_activity

        vis_activity({}, activity_log, save_path=os.path.join(path_results, "activity.png"))
    if stats is not None:
        stats.update(windows=windows_done, seconds=time.perf_counter() - t0,
                     encoder=data.encoder)
        if log_activity:
            stats["activity"] = activity_log
        if split.on:
            n = max(windows_done, 1)
            stats["split_ms"] = {p: (None if p == "device" and not split.cuda else v / n)
                                 for p, v in split.ms.items()}
            stats["slow_enqueues"] = split.slow

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

    if hm_dev:
        # fold the device's heat-map sums into the aggregates (partial
        # chunks accumulated on the host into the same aggregates)
        it = iter(hm_dev)
        for i, mname in enumerate(names):
            if mname in _HEATMAP_METRICS:
                e, c = next(it), next(it)
                criteria[i].merge_aggregated(e.cpu().numpy(), c.cpu().numpy())

    if not debug and names:
        from evflow_torch.utils.tracker import log_results

        log_results(runid, results, path_results, eval_id)
        if want_heatmaps:
            heat_dir = os.path.join(path_results, "heatmaps")
            os.makedirs(heat_dir, exist_ok=True)
            for i, mname in enumerate(names):
                if mname in _HEATMAP_METRICS:
                    criteria[i].save_error_heatmap(
                        os.path.join(heat_dir, f"{mname}_heatmap.png"),
                        title=f"Aggregated {mname} Error Distribution")
    if collect_vis:
        return results, vis_frames
    return results
