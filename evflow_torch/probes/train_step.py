"""The training step on the card, held and measured.

    python -m evflow_torch.probes.train_step [--steps 20] [--warm 3]

* ``compare_small``: one TBPTT step at the sizes of the port's CPU tests
  (LIFFireNet_short, 8 channels, B=2, 16x16, P=3 passes of 64 events, Adam
  with the clip active, ``remat`` full) on the card and on the CPU, the
  same seeded weights and streamed window: the loss within 1e-5 relative
  and every gradient within rtol 5e-4, atol 5e-7 (the reference package's
  cross-framework bars), provided no membrane lies within 1e-5 of its
  threshold at a spike (``spike_margins``).
* ``measure_full``: ``configs/train_SNN.yml``'s settings (LIFFireNet_short,
  8 channels, cnt, 128x128, B=8, ``window`` 1000 and ``window_loss`` 10000:
  P=10, Adam 2e-4, clip 1.0, ``remat`` full) on synthetic sequences from a
  seed, through ``train``: steps/s and windows/s over ``steps`` steps after
  ``warm``, the step's split by CUDA events with a sync after every step
  (host batches + stack + upload, the P forward passes, the loss, the
  backward, clip + optimizer + clamp), and for each ``remat``
  (``profile_step``) the step's host syncs, its peak memory and the card's
  kernel time from ``torch.profiler``, by part and by kernel, whose share
  of the timed step is the card's busy share; and the first step's loss
  against the CPU's same step.

Prints one JSON line (the CLI); ``chip_smoke.py`` phase ``train`` calls
both and checks them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from evflow_torch import registry
from evflow_torch.config import load_config
from evflow_torch.loss.warp_loss import EventWarpingConfig
from evflow_torch.ops import lif
from evflow_torch.train import (STEP_PARTS, TrainStep, pass_count, stack_window, train,
                                upload_window)

ROOT = Path(__file__).resolve().parents[2]
TRAIN_CONFIG = ROOT / "configs" / "train_SNN.yml"
SMALL = dict(B=2, H=16, W=16, C=8, P=3, window=64)
SMALL_SEED, SMALL_SKIP = 7, 0  # the seeded weights and the windows skipped
GRAD_BAR = dict(rtol=5e-4, atol=5e-7)
MARGIN = 1e-5


@contextlib.contextmanager
def spike_margins():
    """Collects min |u - theta| of every spike call of the LIF update into
    the yielded list."""
    out: List[float] = []
    real = lif.atanspike_snn

    def tracked(u, thresh=0.0, alpha=2.0):
        out.append(float((u - thresh).detach().abs().min()))
        return real(u, thresh, alpha)

    lif.atanspike_snn = tracked
    try:
        yield out
    finally:
        lif.atanspike_snn = real


def host_syncs(fn) -> int:
    """How many times ``fn()`` makes the host wait for the card (PyTorch's
    sync debug mode, warning on each)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def small_config(root: str) -> Dict[str, Any]:
    s = SMALL
    return {
        "experiment": "small",
        "data": {"path": root, "mode": "events", "window": s["window"],
                 "window_loss": s["P"] * s["window"]},
        "model": {"name": "LIFFireNet_short", "num_bins": 2, "base_num_channels": s["C"],
                  "kernel_size": 3, "encoding": "cnt", "mask_output": True,
                  "spiking_neuron": {"leak": [0.0, 1.0], "thresh": [0.0, 0.8]}},
        "loss": {"flow_regul_weight": 0.001, "clip_grad": 1.0, "remat": "full"},
        "optimizer": {"name": "Adam", "lr": 2e-4},
        "loader": {"batch_size": s["B"], "resolution": [s["H"], s["W"]], "augment": [],
                   "seed": 0},
        "hot_filter": {"enabled": False},
        "vis": {"verbose": False},
    }


def small_window(cfg: Dict[str, Any], skip: int = SMALL_SKIP) -> Dict[str, np.ndarray]:
    """A loss window of the small case from synthetic sequences (numpy
    archives: the card's host may lack h5py), after ``skip`` windows."""
    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.data.synthetic import make_dataset

    make_dataset(cfg["data"]["path"], num_sequences=2, resolution=(SMALL["H"], SMALL["W"]),
                 events_per_sec=20_000, duration=0.3, flows=[(6.0, -3.0), (-4.0, 2.0)],
                 gt_hz=10.0, fmt="npz")
    stream = H5EventStream(cfg, 2)
    batches = [stream.next_batch() for _ in range(skip + SMALL["P"])][skip:]
    stream.close()
    w = stack_window(batches)
    w.pop("hot_mask", None)
    return w


def small_step(cfg: Dict[str, Any], window, device: str, seed: int = SMALL_SEED,
               weights: Optional[Callable] = None,
               guards: Optional[Mapping[str, Tuple[Callable, float]]] = None):
    """One step of the small case on ``device`` from ``seeded_state_dict``
    weights (mapped by ``weights`` if given): (loss, raw grads on the CPU,
    {guard: least margin}) for the spike margin and each of ``guards``
    (name -> (context manager yielding a list of margins, its bar)),
    entered before the model is built."""
    from evflow_torch.weights import seeded_state_dict

    with contextlib.ExitStack() as stack:
        margins = {"spike": stack.enter_context(spike_margins()),
                   **{k: stack.enter_context(g()) for k, (g, _) in (guards or {}).items()}}
        model = registry.build_model(cfg["model"], device="cpu")
        sd = seeded_state_dict(model, seed=seed)
        model.load_state_dict(weights(sd) if weights else sd)
        model = model.to(device)
        opt = registry.build_optimizer(cfg["optimizer"], model.parameters())
        step = TrainStep(model, opt, EventWarpingConfig(cfg), 4, remat=cfg["loss"]["remat"],
                         clip_grad=cfg["loss"]["clip_grad"],
                         resolution=(SMALL["H"], SMALL["W"]), keep_grads=True)
        loss, _ = step(model.init_states(SMALL["B"], SMALL["H"], SMALL["W"]),
                       upload_window(window, torch.device(device)))
    # a guard that saw no call has nothing to hold: the largest margin
    return (float(loss), {k: g.cpu() for k, g in step.grads.items()},
            {k: min(m, default=0.5) for k, m in margins.items()})


def grad_ratio(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The largest |got - want| / (atol + rtol |want|) over every element:
    the gradients meet the bar when it is <= 1."""
    return max(float(((got[k] - w).abs() / (GRAD_BAR["atol"] + GRAD_BAR["rtol"] * w.abs())).max())
               for k, w in want.items())


def compare_small(root: str, device: str = "cuda",
                  quantization: Optional[Dict[str, Any]] = None, seed: int = SMALL_SEED,
                  weights=None, guards: Optional[Mapping[str, Tuple[Callable, float]]] = None
                  ) -> Dict[str, Any]:
    """The small case's step on ``device`` against the CPU's (with
    ``quantization`` as the model's quantization section if given;
    ``seed``, ``weights`` and ``guards`` as ``small_step``'s): every margin
    above its bar (the spike margin's ``MARGIN``)."""
    cfg = small_config(root)
    if quantization is not None:
        cfg["model"]["quantization"] = dict(quantization)
    window = small_window(cfg)
    kw = dict(seed=seed, weights=weights, guards=guards)
    loss_cpu, grads_cpu, margins_cpu = small_step(cfg, window, "cpu", **kw)
    loss_dev, grads_dev, margins_dev = small_step(cfg, window, device, **kw)
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads_cpu.values())))
    ratio = grad_ratio(grads_dev, grads_cpu)
    rel = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    margins = {k: min(m, margins_dev[k]) for k, m in margins_cpu.items()}
    bars = {"spike": MARGIN, **{k: bar for k, (_, bar) in (guards or {}).items()}}
    return {"loss_cpu": loss_cpu, "loss_card": loss_dev, "loss_rel_diff": rel,
            "grad_bar_ratio": ratio, "margins": margins, "grad_norm": gnorm,
            "ok": (all(margins[k] > b for k, b in bars.items()) and gnorm > 1.0
                   and rel <= 1e-5 and ratio <= 1.0)}


def full_config(root: str, remat: str = "full",
                quantization: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``configs/train_SNN.yml`` on the synthetic sequences under ``root``
    (with ``quantization`` as its model's quantization section, if given)."""
    cfg = load_config(str(TRAIN_CONFIG))
    cfg["data"]["path"] = root
    cfg["loss"]["remat"] = remat
    cfg["vis"]["verbose"] = False
    if quantization is not None:
        cfg["model"]["quantization"] = dict(quantization)
    return cfg


def full_data(root: str, sequences: int = 8, seconds: float = 2.5, rate: int = 100_000):
    """Sequences long enough that no slot rolls over in the timed steps
    (230 windows of 1000 events a slot)."""
    from evflow_torch.data.synthetic import make_dataset

    make_dataset(root, num_sequences=sequences, seed=0, duration=seconds,
                 resolution=(128, 128), events_per_sec=rate, fmt="npz")
    return root


def first_window(cfg: Dict[str, Any], device) -> Dict[str, Any]:
    """The first loss window of the config's stream, compacted as ``train``
    sends it (counts derived on the device) and uploaded."""
    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.train import compact_window

    stream = H5EventStream(cfg, 2)
    w = stack_window([stream.next_batch() for _ in range(pass_count(cfg))])
    stream.close()
    return upload_window(compact_window(w, "cnt", derive_mask=True, derive_cnt=True,
                                        coords_dtype=np.float32, pol_bits=True), device)


def profile_step(cfg: Dict[str, Any], n: int = 15) -> Dict[str, Any]:
    """One full-width step of the config's ``remat`` on the card: its host
    syncs (0: the step never waits for the card), the host clock of a step
    ending in a sync, the peak memory of a step, and from ``torch.profiler``
    over one more step the card's kernel time (its busy time), split by the
    part of the step whose marks bracket each kernel's start (the step is
    bound by the host, so a kernel starts soon after its launch), and the
    ``n`` kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device("cuda")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = registry.build_model(cfg["model"], device="cpu").to(dev)
    opt = registry.build_optimizer(cfg["optimizer"], model.parameters())
    loader = cfg["loader"]
    H, W = loader["resolution"]
    step = TrainStep(model, opt, EventWarpingConfig(cfg), 4, remat=cfg["loss"]["remat"],
                     clip_grad=cfg["loss"]["clip_grad"], resolution=(H, W))
    window = first_window(cfg, dev)
    states = model.init_states(loader["batch_size"], H, W)
    step(states, window)  # warm: cuDNN's plans, the allocator
    torch.cuda.synchronize()
    syncs = host_syncs(lambda: step(states, window))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step(states, window)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()

    def mark(name):
        with record_function(f"mark:{name}"):
            pass

    step.marker = mark
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mark("start")
        step(states, window)
        torch.cuda.synchronize()
    step.marker = None
    events = prof.events()
    marks = sorted((e.time_range.start, e.name[5:]) for e in events if e.name.startswith("mark:"))
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    parts = dict.fromkeys(STEP_PARTS[1:], 0.0)
    for e in kernels:
        after = [name for t, name in marks[1:] if t > e.time_range.start]
        if after:
            parts[after[0]] += e.time_range.elapsed_us() / 1e3
    rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[2])
    return {"remat": cfg["loss"]["remat"], "host_syncs": syncs, "step_ms": step_ms,
            "peak_bytes": peak, "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "kernels": len(kernels), "kernel_split_ms": parts,
            "top_kernels": [{"name": k[:120], "launches": c, "ms": ms} for k, c, ms in rows[:n]]}


def measure_full(root: str, steps: int = 20, warm: int = 3,
                 quantization: Optional[Dict[str, Any]] = None,
                 remats: Sequence[str] = ("none", "full", "dots"),
                 data: Optional[str] = None) -> Dict[str, Any]:
    """The full-width cell on the card (see the module's docstring), with
    ``quantization`` as the model's quantization section if given, each of
    ``remats`` profiled (the ``device_*`` figures are remat full's), on the
    sequences under ``data`` (``full_data``'s, else written under ``root``)."""
    data = data or full_data(root)
    cfg = full_config(data, quantization=quantization)
    runs = os.path.join(root, "runs")
    n = warm + steps
    timed: Dict[str, Any] = {}
    train(cfg, path_runs=runs, max_steps=n, verbose=False, device="cuda", stats=timed)
    torch.cuda.synchronize()
    ends = timed["step_end"]
    seconds = ends[n - 1] - ends[warm - 1]
    B, P = cfg["loader"]["batch_size"], pass_count(cfg)
    split: Dict[str, Any] = {"split": True}
    train(cfg, path_runs=runs, max_steps=warm + 5, verbose=False, device="cuda", stats=split)
    split_ms = {p: float(np.mean([s[p] for s in split["split_ms"][warm:]])) for p in STEP_PARTS}
    cards = {r: profile_step(full_config(data, r, quantization)) for r in remats}
    cpu: Dict[str, Any] = {}
    train(cfg, path_runs=runs, max_steps=1, verbose=False, device="cpu", stats=cpu)
    wall_ms = 1e3 * seconds / steps
    return {
        "steps": steps, "warm": warm, "steps_per_s": steps / seconds,
        "windows_per_s": steps * P * B / seconds, "ms_per_step": wall_ms,
        "split_ms": split_ms, "split_sum_ms": sum(split_ms.values()),
        "device_kernel_ms": cards["full"]["kernel_ms"], "kernels": cards["full"]["kernels"],
        "device_kernel_split_ms": cards["full"]["kernel_split_ms"],
        "device_idle_share": 1.0 - cards["full"]["kernel_ms"] / wall_ms,
        "by_remat": {r: {k: c[k] for k in ("kernel_ms", "kernels", "step_ms", "peak_bytes",
                                             "host_syncs")} for r, c in cards.items()},
        "top_kernels": cards["full"]["top_kernels"],
        "losses": timed["losses"], "params_moved": timed["params_moved"],
        "first_loss_card": timed["losses"][0], "first_loss_cpu": cpu["losses"][0],
        "first_loss_rel_diff": abs(timed["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)
    from evflow_torch.device import describe_card

    with tempfile.TemporaryDirectory(prefix="evflow_train_") as d:
        out = {"card": describe_card(), "small": compare_small(os.path.join(d, "small")),
               **measure_full(os.path.join(d, "full"), args.steps, args.warm)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
