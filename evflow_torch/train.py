"""Self-supervised training: the TBPTT step and the trainer loop (port of
``evflow/train.py``).

Loop semantics, as in the reference package:

* a loss window is P = round(window_loss / window) passes of the model,
  the TEBN timestep of pass p being ``p % T``; the event-warping loss runs
  over the P stacked flows, then one backward, optax's global-norm clip
  (``loss.clip_grad``), one optimizer step (``registry.build_optimizer``)
  and ``clamp_thresholds``;
* the membrane and spike carries persist across loss windows as values:
  the step detaches them at its end (the truncation of the TBPTT);
* train-mode norms update their running statistics once a pass, in pass
  order; ``loss.remat`` ``full`` recomputes each pass in the backward
  (``torch.utils.checkpoint``), ``dots`` saves only the conv outputs and
  recomputes the rest, ``none`` saves everything: the three give the same
  gradients, and a recompute leaves the running statistics alone;
* on a sequence rollover the partial loss window is dropped and the
  carries reset; an epoch ends when the stream reports ``epoch_done``, with
  the loss averaged over the epoch's steps, its variance over the last 50,
  three-policy checkpoints (``utils.checkpoint``), early stop after 50
  epochs without improvement, and ``loader.n_epochs``;
* each step's loss is fetched one step behind, so the host's loading and
  upload overlap the card's step.

The wire. A window crosses to the device narrow (``compact_window``):
counts as uint8 (int16 once a window overflows, sticky), (y, x) as uint16
while integral (f32 from the first fractional window on, sticky), polarity
as one bit an event while one-hot (the full mask after, sticky), the valid
mask as per-(pass, slot) lengths; with the plain cnt encoding (no pooling,
no ``temporal_cnt``) the count and mask grids stay home and
``restore_window`` rebuilds them on the device from the event list, one
multi-channel ``index_add_``: integer sums, so equal to the loader's bit
for bit (the voxel encoding's splat likewise, equal up to f32 summation
order). Every f32 conv, forward and backward, runs in full f32 on the card
(``models.cells.full_f32_convs``). No hand-written kernel runs here: the
reference's train step reaches no Pallas kernel either.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from evflow_torch import registry
from evflow_torch.data.h5_stream import Prefetcher
from evflow_torch.data.mp_loader import build_stream, check_workers
from evflow_torch.loss.warp_loss import EventWarpingConfig
from evflow_torch.models.cells import full_f32_convs
from evflow_torch.models.norm import frozen_running_stats, global_batch_stats
from evflow_torch.ops.lif import LIFState
from evflow_torch.parallel.mesh import rank_config, rank_device
from evflow_torch.utils.checkpoint import CheckpointPolicy, load_training_checkpoint
from evflow_torch.utils.tracker import Run, grad_stats, save_csv

__all__ = ["train", "TrainStep", "stack_window", "compact_window", "upload_window",
           "restore_window", "clamp_thresholds", "clip_by_global_norm", "pass_count",
           "STEP_PARTS"]

# the parts of a step that ``TrainStep.marker`` and ``train(stats={"split": True})``
# time: the host's batches, stacking and upload, the P forward passes, the
# loss, the backward, and clip + optimizer step + threshold clamp
STEP_PARTS = ("host", "forward", "loss", "backward", "update")
_REMATS = ("none", "full", "dots")


def pass_count(config: Dict[str, Any]) -> int:
    """P, the passes of a loss window: ``round(window_loss / window)`` (a
    float floor-division would give 4 for 0.5 // 0.1)."""
    data = config["data"]
    return max(1, int(round(data.get("window_loss", data["window"]) / data["window"])))


@torch.no_grad()
def clamp_thresholds(model: torch.nn.Module):
    """Project every threshold parameter to >= 0.01, in place."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("threshold", "thresh"):
            p.clamp_(min=0.01)


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` unless the global norm is below ``max_norm``
    (``clip_grad_norm_`` divides by ``norm + 1e-6`` instead). Returns the
    norm, on the device, without a sync."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def stack_window(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack P host batches into ``[P, ...]`` arrays, the event lists padded
    to one length."""
    n_max = max(b["event_list"].shape[1] for b in batches)
    P = len(batches)
    B = batches[0]["event_list"].shape[0]
    el = np.zeros((P, B, n_max, 4), np.float32)
    pm = np.zeros((P, B, n_max, 2), np.float32)
    va = np.zeros((P, B, n_max), np.float32)
    for p, b in enumerate(batches):
        n = b["event_list"].shape[1]
        el[p, :, :n] = b["event_list"]
        pm[p, :, :n] = b["event_list_pol_mask"]
        va[p, :, :n] = b["event_valid"]
    out = {"event_list": el, "event_list_pol_mask": pm, "event_valid": va}
    for key in ("event_cnt", "event_voxel", "event_mask"):
        out[key] = np.stack([b[key] for b in batches])
    if "hot_mask" in batches[0]:
        out["hot_mask"] = np.stack([b["hot_mask"] for b in batches])
    return out


def compact_window(window: Dict[str, np.ndarray], encoding: str, exact_ints: bool = True,
                   derive_mask: bool = False, cnt_dtype: Optional[type] = None,
                   derive_cnt: bool = False, derive_voxel: bool = False,
                   coords_dtype: Optional[type] = None,
                   pol_bits: bool = False) -> Dict[str, Optional[np.ndarray]]:
    """Shrink the host-to-device wire of one TBPTT window (numpy in, numpy
    or None out; ``restore_window`` inverts it on the device).

    The model reads one encoding, so the other is dropped; the polarity
    column is dropped (the polarity mask rebuilds it). With ``exact_ints``
    (no pooling: counts and masks are integers) masks go as uint8 and
    counts as ``cnt_dtype`` (uint8 if None and they fit, else int16).
    ``derive_mask`` drops the mask (the device takes ``cnt.sum(-1) > 0``,
    the loader's mask for plain cnt windows); ``derive_cnt`` also drops the
    counts (the event list's per-polarity histogram times the hot mask,
    whose bits ride packed), ``derive_voxel`` the voxel grid (its splat).
    ``pol_bits`` packs the one-hot polarity mask to a bit an event;
    ``coords_dtype`` (uint16 or f32) sends ts and (y, x) apart and the
    valid mask as per-(pass, slot) lengths (it is a prefix mask). The
    trainer checks each window before it asks for the narrow dtypes."""
    w: Dict[str, Any] = dict(window)
    hot = w.pop("hot_mask", None)  # host-side; rides only as packed bits
    if encoding == "voxel":
        w["event_cnt"] = None
    else:
        w["event_voxel"] = None
    w["event_list"] = np.ascontiguousarray(w["event_list"][..., :3])
    if pol_bits:
        pm, va = w["event_list_pol_mask"], w["event_valid"]
        assert ((pm == 0) | (pm == 1)).all() and (pm.sum(-1) == va).all()
        w["event_pol_bits"] = np.packbits(pm[..., 0] > 0, axis=-1)
        w["event_list_pol_mask"] = None
    if coords_dtype is not None:
        el, va = w["event_list"], w["event_valid"]
        lens = va.sum(-1).astype(np.int32)
        assert (va == (np.arange(va.shape[-1]) < lens[..., None])).all()
        w["event_ts"] = np.ascontiguousarray(el[..., 0])
        w["event_yx"] = el[..., 1:3].astype(coords_dtype)
        w["event_len"] = lens
        w["event_list"] = None
        w["event_valid"] = None
    if derive_mask:
        assert exact_ints and ((encoding == "cnt" and w["event_cnt"] is not None)
                               or derive_voxel)
        w["event_mask"] = None
    if derive_cnt:
        assert derive_mask and encoding == "cnt", "derive_cnt requires derive_mask's guarantees"
        w["event_cnt"] = None
    if derive_voxel:
        assert encoding == "voxel" and exact_ints
        w["event_voxel"] = None
    if (derive_cnt or derive_voxel) and hot is not None:
        w["hot_bits"] = np.packbits(hot, axis=-1)  # big-endian bit order
    if exact_ints:
        for k in ("event_mask", "event_list_pol_mask", "event_valid"):
            if w[k] is not None:
                w[k] = w[k].astype(np.uint8)
        cnt = w.get("event_cnt")
        if cnt is not None:
            if cnt_dtype is None:
                cnt_dtype = np.uint8 if cnt.min() >= 0 and cnt.max() <= 255 else np.int16
            w["event_cnt"] = cnt.astype(cnt_dtype)
    return w


def upload_window(window: Dict[str, Optional[np.ndarray]],
                  device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
    """The compact window's arrays as tensors on ``device`` (None stays
    None); uint16 crosses as int16 and widens to int32 there. To the card
    they go from pinned memory without a sync, so the upload queues behind
    the step in flight instead of waiting for it."""
    cuda = device.type == "cuda"
    out: Dict[str, Optional[torch.Tensor]] = {}
    for k, a in window.items():
        if a is None:
            out[k] = None
            continue
        t = torch.from_numpy(np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16 else a))
        t = t.pin_memory().to(device, non_blocking=True) if cuda else t.to(device)
        out[k] = t.to(torch.int32) & 0xFFFF if a.dtype == np.uint16 else t
    return out


def _unpack_bits(b: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``np.packbits(..., axis=-1)`` (big-endian bit order):
    uint8 ``[..., ceil(n/8)]`` -> f32 {0, 1} ``[..., n]``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=b.device)
    bits = (b[..., None] >> shifts) & 1
    return bits.reshape(*b.shape[:-1], -1)[..., :n].float()


def _splat_grid(el: torch.Tensor, contrib: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``contrib [P, B, N, C]`` added at each event's integer (y, x) of
    ``el [P, B, N, >=3]`` into ``[P, B, H, W, C]``: one ``index_add_``."""
    P, B, N, C = contrib.shape
    ys = el[..., 1].to(torch.int64)
    xs = el[..., 2].to(torch.int64)
    base = (torch.arange(P * B, dtype=torch.int64, device=el.device) * (H * W)).reshape(P, B, 1)
    grid = torch.zeros(P * B * H * W, C, dtype=torch.float32, device=el.device)
    grid.index_add_(0, (base + ys * W + xs).reshape(-1), contrib.reshape(-1, C))
    return grid.reshape(P, B, H, W, C)


def restore_window(window: Dict[str, Optional[torch.Tensor]],
                   resolution: Optional[Sequence[int]] = None, num_bins: Optional[int] = None,
                   round_ts: bool = False) -> Dict[str, Optional[torch.Tensor]]:
    """The device-side inverse of ``compact_window``: f32 from the narrow
    dtypes, the polarity column from the polarity mask, and the dropped
    grids rebuilt: ``event_cnt`` as the per-polarity histogram of the event
    list times the hot-mask bits (integer sums: equal to the loader's),
    with ``num_bins`` the voxel grid as the temporal-bilinear splat of the
    list (the host encoder's f32 weights, summed in another order), and
    ``event_mask`` as the counts' indicator."""
    window = dict(window)
    hot_bits = window.pop("hot_bits", None)
    pol_bits = window.pop("event_pol_bits", None)
    lens = window.pop("event_len", None)
    window = {k: (v.float() if v is not None else None) for k, v in window.items()}
    if window.get("event_list") is None:
        ts, yx = window.pop("event_ts"), window.pop("event_yx")
        n = ts.shape[-1]
        window["event_valid"] = (torch.arange(n, device=ts.device) < lens[..., None]).float()
        window["event_list"] = torch.cat([ts[..., None], yx], dim=-1)
    if pol_bits is not None:
        pos = _unpack_bits(pol_bits, window["event_list"].shape[-2]) * window["event_valid"]
        window["event_list_pol_mask"] = torch.stack([pos, window["event_valid"] - pos], -1)
    if window["event_list"].shape[-1] == 3:
        pm = window["event_list_pol_mask"]
        window["event_list"] = torch.cat([window["event_list"], pm[..., 0:1] - pm[..., 1:2]], -1)
    hot = None
    if hot_bits is not None:
        if resolution is None:
            raise ValueError("the hot-mask bits need a resolution")
        hot = _unpack_bits(hot_bits, int(resolution[1]))[..., None]
    if window.get("event_cnt") is None:
        if resolution is None:
            raise ValueError("derive_cnt wire needs a resolution")
        H, W = int(resolution[0]), int(resolution[1])
        el = window["event_list"]
        contrib = window["event_list_pol_mask"] * window["event_valid"][..., None]
        cnt = _splat_grid(el, contrib, H, W)
        window["event_cnt"] = cnt * hot if hot is not None else cnt
    if window.get("event_voxel") is None and num_bins is not None:
        if resolution is None:
            raise ValueError("derive_voxel wire needs a resolution")
        H, W = int(resolution[0]), int(resolution[1])
        el = window["event_list"]
        tb = el[..., 0] * np.float32(num_bins - 1)
        if round_ts:
            tb = torch.round(tb)  # half to even, like np.round
        bins = torch.arange(num_bins, dtype=torch.float32, device=el.device)
        wts = torch.clamp(1.0 - (tb[..., None] - bins).abs(), min=0.0)
        vox = _splat_grid(el, el[..., 3:4] * wts, H, W)
        window["event_voxel"] = vox * hot if hot is not None else vox
    if window.get("event_mask") is None:
        window["event_mask"] = (window["event_cnt"].sum(-1, keepdim=True) > 0).float()
    return window


def _save_convs(ctx, op, *args, **kwargs):
    """Remat "dots": conv outputs stay saved, the rest is recomputed (the
    counterpart of jax.checkpoint_policies.dots_with_no_batch_dims_saveable:
    the model's only dots are its convs)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.convolution.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _checkpoint_contexts(remat: str, model: torch.nn.Module):
    """(forward, recompute) contexts of a checkpointed pass: the recompute
    leaves the running statistics alone."""
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        fwd, rec = create_selective_checkpoint_contexts(_save_convs)
        return fwd, _both(rec, frozen_running_stats(model))
    return contextlib.nullcontext(), frozen_running_stats(model)


class TrainStep:
    """The TBPTT step of a model and its optimizer (counterpart of the
    reference's ``make_train_step``).

    ``step(states, window)`` restores the window (``restore_window``; the
    arrays already on the model's device), runs the P passes in
    ``.train()`` mode, the loss, the backward, every parameter's gradient
    (zeros where none flows, as ``jax.grad`` gives), the clip, the
    optimizer step and the threshold clamp (on the card all of it in
    ``full_f32_convs``), and returns ``(loss, new_states)``: the loss a 0-d tensor on the device
    (not fetched), the carries detached. With ``keep_grads`` the raw
    gradients (before the clip) stay in ``grads``, keyed by parameter
    name. ``marker``, if set, is called with each name of ``STEP_PARTS``
    but "host" as that part ends (the caller records CUDA events there).

    With a data-parallel ``mesh`` (``evflow_torch.parallel.mesh``) the window
    is the rank's slots: the norms take the global batch's moments
    (``global_batch_stats``), and after the backward one all-reduce sums
    the gradients and the loss over the ranks in one flat bucket (the loss
    is a sum over slots, so the global gradient is the sum; a mean would
    move the clip and Adam's epsilon), before ``keep_grads``, the clip and
    the optimizer step: every rank steps alike and the returned loss is the
    global one.
    """

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 warp_cfg: EventWarpingConfig, num_timesteps: int = 4, remat: str = "full",
                 clip_grad: Optional[float] = None, resolution: Optional[Sequence[int]] = None,
                 num_bins: Optional[int] = None, round_ts: bool = False,
                 keep_grads: bool = False, mesh=None):
        if remat not in _REMATS:
            raise ValueError(f"remat must be none/full/dots, got {remat!r}")
        self.model = model
        self.optimizer = optimizer
        self.warp_cfg = warp_cfg
        self.num_timesteps = int(num_timesteps)
        self.remat = remat
        self.clip_grad = None if clip_grad is None else float(clip_grad)
        self.resolution = resolution
        self.num_bins = num_bins
        self.round_ts = round_ts
        self.keep_grads = keep_grads
        self.grads: Dict[str, torch.Tensor] = {}
        self.marker: Optional[Callable[[str], None]] = None
        self.params = list(model.parameters())
        self.names = [n for n, _ in model.named_parameters()]
        self.group = mesh.group if mesh is not None and mesh.distributed else None
        global_batch_stats(model, self.group)

    def _pass(self, voxel, cnt, states, timestep: int):
        out, new_states = self.model(voxel, cnt, states, timestep=timestep)
        return out["flow"], new_states

    def _mark(self, name: str):
        if self.marker is not None:
            self.marker(name)

    def __call__(self, states: Sequence[LIFState], window: Dict[str, Optional[torch.Tensor]]
                 ) -> Tuple[torch.Tensor, Tuple[LIFState, ...]]:
        with full_f32_convs() if self.params[0].is_cuda else contextlib.nullcontext():
            return self._step(states, window)

    def _step(self, states, window):
        from torch.utils.checkpoint import checkpoint

        window = restore_window(window, self.resolution, num_bins=self.num_bins,
                                round_ts=self.round_ts)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        voxel, cnt = window.get("event_voxel"), window.get("event_cnt")
        per_pass = []
        for p in range(window["event_list"].shape[0]):
            args = (None if voxel is None else voxel[p], None if cnt is None else cnt[p],
                    states, p % self.num_timesteps)
            if self.remat == "none":
                flow, states = self._pass(*args)
            else:
                flow, states = checkpoint(
                    self._pass, *args, use_reentrant=False, preserve_rng_state=False,
                    context_fn=lambda: _checkpoint_contexts(self.remat, self.model))
            per_pass.append(flow)
        self._mark("forward")
        flows = [torch.stack([f[s] for f in per_pass]) for s in range(len(per_pass[0]))]
        loss = self.warp_cfg(flows, window["event_list"], window["event_list_pol_mask"],
                             window["event_mask"], window["event_valid"])
        self._mark("loss")
        loss.backward()
        self._mark("backward")
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.group is not None:
            loss = self._all_reduce(grads, loss.detach())
        if self.keep_grads:
            self.grads = {n: g.detach().clone() for n, g in zip(self.names, grads)}
        if self.clip_grad is not None:
            clip_by_global_norm(grads, self.clip_grad)
        self.optimizer.step()
        clamp_thresholds(self.model)
        self._mark("update")
        return loss.detach(), tuple(LIFState(s.mem.detach(), s.spk.detach()) for s in states)

    def _all_reduce(self, grads: List[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
        """Sum the gradients (in place) and the loss over the ranks, in one
        collective; returns the global loss."""
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, group=self.group)
        for g, part in zip(grads, flat[:-1].split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        return flat[-1]


def log_param_histograms(run, model: torch.nn.Module,
                         grads: Optional[Dict[str, torch.Tensor]], step: int):
    """Histograms of the conv weights, the LIF leaks and thresholds, each
    weight's int8 scale (max |w| / 127) and the gradients."""
    named = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
    weights = {k: v for k, v in named.items() if k.endswith("weight") and v.ndim == 4}
    lif = {k: v for k, v in named.items()
           if k.rsplit(".", 1)[-1] in ("beta", "threshold", "leak", "thresh")}
    scales = {k + "/int8_scale": np.abs(v).max() / 127.0 for k, v in weights.items()}
    run.log_histograms(weights, step, group="weights")
    run.log_histograms(lif, step, group="lif")
    run.log_histograms(scales, step, group="quant_scales")
    if grads:
        run.log_histograms({n: g.cpu().numpy() for n, g in grads.items()}, step, group="grads")


def _resume(prev_ckpt: str, model, optimizer):
    from evflow_torch.utils.msgpack import is_flax_checkpoint, read_flax_checkpoint
    from evflow_torch.weights import flax_optimizer_state, from_jax_variables

    if is_flax_checkpoint(prev_ckpt):  # a reference package's run
        ckpt = read_flax_checkpoint(prev_ckpt)
        model.load_state_dict(from_jax_variables(ckpt))
        if ckpt.get("opt_state") is not None:
            optimizer.load_state_dict(flax_optimizer_state(
                ckpt["opt_state"], ckpt.get("batch_stats", {}), model, optimizer))
        return
    ckpt = load_training_checkpoint(prev_ckpt)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        sd, opt = ckpt["model_state_dict"], ckpt.get("optimizer_state_dict")
    else:  # a reference .pth: a bare state dict or a pickled module
        sd, opt = (ckpt.state_dict() if hasattr(ckpt, "state_dict") else ckpt), None
    model.load_state_dict(sd)
    if opt is not None:
        optimizer.load_state_dict(opt)


def train(config: Dict[str, Any], path_runs: str = "runs", prev_ckpt: Optional[str] = None,
          max_steps: Optional[int] = None, verbose: bool = True,
          epoch_callback: Optional[Callable] = None,
          device: Optional[Union[str, torch.device]] = None,
          stats: Optional[Dict[str, Any]] = None, mesh=None):
    """Train a FireNet with the event-warping loss (the reference's
    ``train``); returns the tracking ``Run`` (its directory holds the
    checkpoints and metrics).

    ``device`` defaults to the GPU. ``prev_ckpt`` (a port checkpoint file
    or its directory, or a reference package's ``model.msgpack`` or its
    directory) restores the weights, the norms' running statistics and the
    optimizer state (optax's moments and count); a reference ``.pth``
    restores the weights and statistics. Bf16 state (``model.state_dtype``)
    is refused: its step is not held against the reference's (ROADMAP.md
    queue 1 item 13). ``epoch_callback(epoch, model, run,
    optimizer)`` fires at every epoch end (the validation hook). ``stats``,
    if given, receives ``steps``, ``losses`` (every fetched loss),
    ``step_end`` (the host clock after each step's enqueue), ``seconds``,
    ``params_moved`` (the largest change of a parameter) and
    ``param_digest`` (a SHA-256 of the final parameters' bytes); with
    ``stats["split"]`` true the loop syncs after every step and
    ``stats["split_ms"]`` receives each step's ms by part of ``STEP_PARTS``
    from CUDA events (on the card only). ``loader.num_workers > 1`` streams
    through worker processes (``data.mp_loader.MPEventStream``).

    ``mesh`` (an ``evflow_torch.parallel.mesh.Mesh`` of this rank, on its
    device) trains data-parallel: every rank calls ``train`` with the same
    config, streams its shard (``rank_config``: B/D slots) and runs the
    ``TrainStep`` of the mesh (global norm moments, gradients summed before
    the clip), so parameters stay equal on every rank. The ranks take their
    batches in lockstep: a gloo all-reduce a batch makes a rollover on any
    rank drop the loss window and reset the carries on all (as one stream
    over the whole batch would), and ends an epoch once every rank's shard
    has ended one (the slowest rank's); the early stop follows rank 0's
    checkpoint policy. Rank 0 alone writes the run directory, the metrics
    and the checkpoints, and calls ``epoch_callback``; every rank returns
    the ``Run`` of that directory.
    """
    if config["data"]["mode"] == "frames":
        raise ValueError("Training pipeline not compatible with frames mode")
    dp = mesh is not None and mesh.distributed
    logged = config  # the run's params and checkpoints keep the global config
    if dp:
        config = rank_config(config, mesh)
    check_workers(config)  # of this process's slots
    loader = config["loader"]
    model_cfg = config["model"]
    if registry.is_unet(model_cfg):
        raise NotImplementedError(
            "training SpikingRecEVFlowNet: the UNet's training step is not held against the "
            "reference's yet, ROADMAP.md queue 1 item 14")
    if model_cfg.get("state_dtype") == "bfloat16":
        raise NotImplementedError(
            "state_dtype bfloat16 in training: the bf16-state step is not held against the "
            "reference's yet, ROADMAP.md queue 1 item 13")
    device = rank_device(mesh, device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(loader.get("seed", 0)))
        model = registry.build_model(model_cfg, device="cpu")
    model = model.to(device)
    optimizer = registry.build_optimizer(
        config.get("optimizer", {"name": "Adam", "lr": 2e-4}), model.parameters())
    if prev_ckpt:
        _resume(prev_ckpt, model, optimizer)

    data = build_stream(config, model_cfg.get("num_bins", 2),
                        model_cfg.get("round_encoding", False))
    data.shuffle()
    lead = not dp or mesh.rank == 0  # the rank that writes
    if lead:
        run = Run(path_runs, config.get("experiment", "Default"))
        run.log_params(logged)
        run.save_diff()
    if dp:  # every rank learns rank 0's run (its directory exists by now)
        runid = mesh.gather(run.runid if lead else None)[0]
        if not lead:
            run = Run(path_runs, config.get("experiment", "Default"), runid)

    H, W = loader["resolution"]
    B = loader["batch_size"]
    encoding = model_cfg.get("encoding", "cnt")
    # pooling makes counts and masks fractional: no narrow integer wire then
    pooled = tuple(loader["resolution"]) != tuple(loader.get("std_resolution",
                                                             loader["resolution"]))
    derive_voxel = (encoding == "voxel" and not pooled
                    and bool(config["data"].get("derive_voxel", True)))
    derive_mask = derive_voxel or (encoding == "cnt" and not pooled
                                   and not bool(model_cfg.get("temporal_cnt", False)))
    derive_cnt = (not derive_voxel) and derive_mask and bool(
        config["data"].get("derive_cnt", True))
    # sticky wire dtypes: each flips once, on the first window that needs it
    cnt_dtype = np.uint8 if derive_mask else np.int16
    coords_dtype = np.uint16
    pol_bits = True
    P = pass_count(config)

    store_grads = bool(config.get("vis", {}).get("store_grads", False))
    store_hists = bool(config.get("vis", {}).get("store_hists", False))
    hist_every = int(config.get("vis", {}).get("hist_every", 50))
    step_fn = TrainStep(
        model, optimizer, EventWarpingConfig(config), int(getattr(model, "num_timesteps", 4)),
        remat=str(config.get("loss", {}).get("remat", "full")),
        clip_grad=config.get("loss", {}).get("clip_grad"), resolution=(H, W),
        num_bins=int(model_cfg.get("num_bins", 2)) if derive_voxel else None,
        round_ts=bool(model_cfg.get("round_encoding", False)),
        keep_grads=store_grads or store_hists, mesh=mesh)
    states = model.init_states(B, H, W)

    split = stats is not None and bool(stats.get("split")) and device.type == "cuda"
    marks: List[Tuple[str, Any]] = []
    if split:
        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        step_fn.marker = mark
    if stats is not None:
        stats.update(steps=0, losses=[], step_end=[])
        start = [p.detach().clone() for p in model.parameters()]
        if split:
            stats["split_ms"] = []

    ckpt_policy = CheckpointPolicy(os.path.join(run.dir, "checkpoints"))
    patience = 50
    epochs_without_improvement = 0
    train_loss = 0.0
    loss_steps = 0
    recent_losses: List[float] = []
    grads_rows: List[dict] = []
    n_epochs = int(loader.get("n_epochs", 100))
    shard_epochs = emitted_epochs = 0  # this rank's shard epochs, global epochs
    pending: List[dict] = []
    steps = 0
    inflight_loss: Optional[torch.Tensor] = None
    t_start = time.time()

    def flush_loss():
        nonlocal inflight_loss, train_loss, loss_steps
        if inflight_loss is not None:
            lv = float(inflight_loss)
            train_loss += lv
            loss_steps += 1
            recent_losses.append(lv)
            if len(recent_losses) > 50:
                recent_losses.pop(0)
            if stats is not None:
                stats["losses"].append(lv)
            inflight_loss = None

    fetch = Prefetcher(data, depth=2)
    try:
        if split:
            torch.cuda.synchronize()
            mark("start")
        while True:
            batch = next(fetch)
            new_seq, epoch_done = bool(batch["new_seq"].any()), bool(batch["epoch_done"])
            if dp:  # any rank's rollover; the slowest rank's epoch
                shard_epochs += epoch_done
                new_seq, least = mesh.host_max([new_seq, -shard_epochs])
                epoch_done = -least > emitted_epochs
                emitted_epochs = max(emitted_epochs, -least)
            if new_seq:
                pending = []  # the partial loss window is dropped, the carries reset
                states = model.init_states(B, H, W)

            if epoch_done:
                flush_loss()
                avg = train_loss / max(loss_steps, 1)
                var = float(np.var(recent_losses)) if len(recent_losses) > 1 else float("inf")
                if verbose and lead:
                    print(f"Epoch {data.epoch:04d} - loss {avg:.6f} var {var:.6f}")
                lowest = False
                if lead:
                    run.log_metric("loss", avg, step=data.epoch)
                    run.log_metric("loss_variance", var, step=data.epoch)
                    state = {"model_state_dict": model.state_dict(),
                             "optimizer_state_dict": optimizer.state_dict()}
                    lowest = ckpt_policy.update(data.epoch, avg, var, len(recent_losses), state,
                                                logged)["lowest_loss"]
                if dp:
                    lowest = bool(mesh.host_max([lowest])[0])
                epochs_without_improvement = 0 if lowest else epochs_without_improvement + 1
                train_loss, loss_steps = 0.0, 0
                data.end_epoch()
                if store_grads and grads_rows and lead:
                    save_csv(grads_rows, os.path.join(run.dir, "grads_w.csv"))
                grads_rows = []
                if epoch_callback is not None and lead:
                    epoch_callback(data.epoch - 1, model, run, optimizer)
                if data.epoch >= n_epochs or epochs_without_improvement >= patience:
                    if verbose:
                        print(f"Stopping at epoch {data.epoch}.")
                    break

            pending.append(batch)
            if len(pending) < P:
                continue

            stacked = stack_window(pending)
            if (encoding == "cnt" and not derive_cnt and cnt_dtype is np.uint8
                    and stacked["event_cnt"].max() > 255):
                cnt_dtype = np.int16
            if coords_dtype is np.uint16:
                yx = stacked["event_list"][..., 1:3]
                if not ((yx >= 0) & (yx < 65536) & (yx == np.floor(yx))).all():
                    coords_dtype = np.float32
            if pol_bits:
                pm = stacked["event_list_pol_mask"]
                if not (((pm == 0) | (pm == 1)).all()
                        and (pm.sum(-1) == stacked["event_valid"]).all()):
                    pol_bits = False
            window = upload_window(compact_window(
                stacked, encoding, exact_ints=not pooled, derive_mask=derive_mask,
                cnt_dtype=cnt_dtype, derive_cnt=derive_cnt, derive_voxel=derive_voxel,
                coords_dtype=coords_dtype, pol_bits=pol_bits), device)
            pending = []
            if split:
                mark("host")
            flush_loss()  # the previous step has finished by now
            loss, states = step_fn(states, window)
            inflight_loss = loss
            data.samples += P * B
            if store_grads and lead:
                grads_rows.append(grad_stats(step_fn.grads))
            if store_hists and lead and steps % hist_every == 0:
                log_param_histograms(run, model, step_fn.grads, steps)
            steps += 1
            if stats is not None:
                stats["steps"] = steps
                stats["step_end"].append(time.perf_counter())
            if split:
                torch.cuda.synchronize()
                ms = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(marks, marks[1:])}
                stats["split_ms"].append(ms)
                marks.clear()
                mark("start")
            if verbose and lead and steps % 10 == 0:
                rate = steps * P * B * (mesh.size if dp else 1) / (time.time() - t_start)
                print(f"Epoch {data.epoch:04d} [{data.seq_num:03d}/{len(data.files):03d}] "
                      f"loss {train_loss / max(loss_steps, 1):.6f} ({rate:.1f} win/s)", end="\r")
            if max_steps is not None and steps >= max_steps:
                break
        flush_loss()
    finally:
        fetch.close()  # join the prefetch thread before closing its files
        data.close()
    if stats is not None:
        stats["seconds"] = time.time() - t_start
        stats["params_moved"] = max(float((p.detach() - p0).abs().max())
                                    for p, p0 in zip(model.parameters(), start))
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        stats["param_digest"] = digest.hexdigest()
    return run
