"""Data parallelism and the multi-process loader, held and measured
(``chip_smoke.py`` phase ``parallel`` and the ``gpu`` cases of
``tests/test_torch_cuda.py`` run these).

* ``loader_equal``: ``MPEventStream`` at each worker count against
  in-process ``H5EventStream``s over the workers' shards
  (``mp_loader.worker_configs``), batch by batch, concatenated and re-padded
  independently of the loader's own code (``EQUAL_BATCHES`` batches):
  every array bit-equal, the file names in order; with the workers'
  process ids, the processes that hold
  a CUDA context (``nvidia-smi --query-compute-apps=pid``, on a card's
  host) and the libraries each worker has mapped: no worker may hold a
  context or map ``libcuda`` (nor, unless the caller's main module
  imports it, ``libtorch``: a spawned worker re-imports that module).
* ``loader_rates``: ``next_batch`` ms a batch and a window (batch / B) at
  each worker count, over ``RATE_BATCHES`` batches after ``RATE_WARM``
  (the workers run ahead by the loader's depth, so this is the loader's
  rate, not one batch's latency), and the ms from the stream's
  construction to its first batch (the workers' start).
* ``small_step``: one TBPTT step of the port's CPU-test sizes
  (``probes.train_step.small_config``, B=2, 16x16) on ``D`` ranks, each on
  its slots of the same window, against the single-process step on the
  same device: the global loss within 1e-5 relative, every gradient within
  rtol 5e-4, atol 5e-7, the parameters after the step bit-equal across the
  ranks, no membrane within 1e-5 of its threshold at a spike.
* ``train_rank`` / ``eval_rank``: a rank's ``train`` / ``evaluate`` under a
  mesh, returning what ``chip_smoke.py`` phase ``parallel`` compares and
  times (``launch`` runs them on every rank, ``jobs_rank`` several in one
  launch).
"""

from __future__ import annotations

import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from evflow_torch.data.h5_stream import H5EventStream
from evflow_torch.data.mp_loader import MPEventStream, build_stream, worker_configs
from evflow_torch.parallel.mesh import launch

PADDED = ("event_list", "event_list_pol_mask", "event_valid")
GLOBAL = ("epoch_done", "seq_num", "file_names")
EQUAL_BATCHES = 3  # batches loader_equal compares
RATE_WARM, RATE_BATCHES = 5, 30  # loader_rates: batches before the timed ones, timed
LIBRARIES = ("libcuda", "libtorch")  # what loader_equal looks for in a worker's maps


def expected_batch(parts: Sequence[Dict[str, Any]], mode: str) -> Dict[str, Any]:
    """The global batch of the workers' batches ``parts``: the event lists
    zero-padded to the widest (``bucket_size`` of it outside ``events``
    mode), every other array concatenated over the slots."""
    from evflow_torch.data.h5_stream import bucket_size

    n = max(p["event_list"].shape[1] for p in parts)
    n = n if mode == "events" else bucket_size(n)
    out = {}
    for k in parts[0]:
        if k in GLOBAL:
            continue
        arrs = [p[k] for p in parts]
        if k in PADDED:
            arrs = [np.pad(a, [(0, 0), (0, n - a.shape[1])] + [(0, 0)] * (a.ndim - 2))
                    for a in arrs]
        out[k] = np.concatenate(arrs, axis=0)
    out["file_names"] = [f for p in parts for f in p["file_names"]]
    return out


def cuda_pids() -> Optional[List[int]]:
    """The processes holding a CUDA context, by nvidia-smi (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [int(t) for t in out.split() if t.strip().isdigit()]


def loaded_libraries(pid: int) -> Dict[str, bool]:
    """Whether process ``pid`` has mapped each of ``LIBRARIES`` (its
    ``/proc/<pid>/maps``): a process without ``libcuda`` holds no CUDA
    context, whatever pid namespace ``nvidia-smi`` reports in."""
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    return {n: n in maps for n in LIBRARIES}


def loader_equal(cfg: Dict[str, Any], workers: int) -> Dict[str, Any]:
    """``MPEventStream`` with ``workers`` against the in-process shard
    streams (see the module's docstring)."""
    cfg = dict(cfg, loader=dict(cfg["loader"], num_workers=workers))
    mp = MPEventStream(cfg, 2)
    refs = [H5EventStream(c, 2) for c in worker_configs(cfg)]
    equal, keys = True, set()
    try:
        for _ in range(EQUAL_BATCHES):
            got = mp.next_batch()
            want = expected_batch([r.next_batch() for r in refs], cfg["data"]["mode"])
            keys |= set(want)
            equal &= set(got) - {"epoch_done", "seq_num"} == set(want) and all(
                got[k] == want[k] if k == "file_names" else np.array_equal(got[k], want[k])
                for k in want)
        pids = mp.pids
        holders = cuda_pids()
        libs = [loaded_libraries(p) for p in pids]
    finally:
        mp.close()
        for r in refs:
            r.close()
    return {"workers": workers, "batches": EQUAL_BATCHES, "equal": bool(equal),
            "keys": sorted(keys), "worker_pids": pids, "cuda_pids": holders,
            "worker_libraries": libs,
            "no_worker_holds_cuda": (holders is None or not set(pids) & set(holders))
            and not any(lib["libcuda"] for lib in libs)}


def loader_rates(cfg: Dict[str, Any], workers: Sequence[int]) -> Dict[int, Dict[str, float]]:
    """``next_batch`` ms a batch and a window at each worker count."""
    B = int(cfg["loader"]["batch_size"])
    out = {}
    for w in workers:
        t0 = time.perf_counter()
        stream = build_stream(dict(cfg, loader=dict(cfg["loader"], num_workers=w)), 2)
        try:
            stream.next_batch()
            first = 1e3 * (time.perf_counter() - t0)
            for _ in range(RATE_WARM - 1):
                stream.next_batch()
            t0 = time.perf_counter()
            for _ in range(RATE_BATCHES):
                stream.next_batch()
            ms = 1e3 * (time.perf_counter() - t0) / RATE_BATCHES
        finally:
            stream.close()
        out[w] = {"ms_per_batch": ms, "ms_per_window": ms / B, "first_batch_ms": first}
    return out


def _state_np(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def step_rank(mesh, cfg: Dict[str, Any], state: Dict[str, np.ndarray],
              window: Dict[str, Optional[np.ndarray]]) -> Dict[str, Any]:
    """This rank's ``TrainStep`` of the mesh on its slots of the global loss
    ``window`` (``[P, B, ...]`` host arrays), from the weights ``state``:
    the global loss, the summed raw gradients, the state dict after the
    step (numpy) and the least spike margin."""
    from evflow_torch import registry
    from evflow_torch.loss.warp_loss import EventWarpingConfig
    from evflow_torch.probes.train_step import spike_margins
    from evflow_torch.train import TrainStep, upload_window

    torch.set_num_threads(1)
    model = registry.build_model(cfg["model"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    model = model.to(mesh.device)
    H, W = cfg["loader"]["resolution"]
    B = window["event_list"].shape[1]
    n = B // mesh.size
    part = {k: None if v is None else v[:, mesh.rank * n:(mesh.rank + 1) * n]
            for k, v in window.items()}
    opt = registry.build_optimizer(cfg["optimizer"], model.parameters())
    step = TrainStep(model, opt, EventWarpingConfig(cfg), 4, remat=cfg["loss"]["remat"],
                     clip_grad=cfg["loss"]["clip_grad"], resolution=(H, W), keep_grads=True,
                     mesh=mesh)
    with spike_margins() as margins:
        loss, _ = step(model.init_states(n, H, W), upload_window(part, mesh.device))
    return {"loss": float(loss), "grads": {k: g.cpu().numpy() for k, g in step.grads.items()},
            "state": _state_np(model), "margin": min(margins)}


def small_step(root: str, device: str, backend: Optional[str],
               num_devices: int) -> Dict[str, Any]:
    """The small step on ``num_devices`` ranks against one process (see the
    module's docstring)."""
    from evflow_torch import registry
    from evflow_torch.probes.train_step import (GRAD_BAR, MARGIN, SMALL_SEED, small_config,
                                                small_step as single_step, small_window)
    from evflow_torch.weights import seeded_state_dict

    cfg = small_config(root)
    window = small_window(cfg)
    model = registry.build_model(cfg["model"], device="cpu")
    state = {k: v.numpy() for k, v in seeded_state_dict(model, seed=SMALL_SEED).items()}
    loss, grads, margins = single_step(cfg, window, device)
    ranks = launch(step_rank, num_devices, device, backend, args=(cfg, state, window))
    got = ranks[0]
    ratio = max(float((np.abs(got["grads"][k] - g.numpy())
                       / (GRAD_BAR["atol"] + GRAD_BAR["rtol"] * np.abs(g.numpy()))).max())
                for k, g in grads.items())
    same = all(all(np.array_equal(r["state"][k], got["state"][k]) for k in got["state"])
               and r["loss"] == got["loss"] for r in ranks[1:])
    margin = min(margins["spike"], *(r["margin"] for r in ranks))
    rel = abs(got["loss"] - loss) / abs(loss)
    return {"num_devices": num_devices, "backend": backend, "loss_single": loss,
            "loss_dp": got["loss"], "loss_rel_diff": rel, "grad_bar_ratio": ratio,
            "ranks_bit_equal": bool(same), "margin": margin,
            "ok": bool(rel <= 1e-5 and ratio <= 1.0 and same and margin > MARGIN)}


def train_rank(mesh, cfg: Dict[str, Any], runs: str, steps: int) -> Dict[str, Any]:
    """``train`` on this rank for ``steps`` steps: the losses, the host clock
    at each step's end and the digest of the final parameters."""
    from evflow_torch.train import train

    stats: Dict[str, Any] = {}
    run = train(cfg, path_runs=runs, max_steps=steps, verbose=False, stats=stats, mesh=mesh)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    return {"runid": run.runid, "losses": stats["losses"], "step_end": stats["step_end"],
            "param_digest": stats["param_digest"]}


def eval_rank(mesh, cfg: Dict[str, Any], state: Dict[str, np.ndarray],
              kw: Dict[str, Any]) -> Dict[str, Any]:
    """``evaluate`` on this rank (``debug``), the model from ``state``."""
    from evflow_torch import registry
    from evflow_torch.eval import evaluate

    model = registry.build_model(cfg["model"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    stats: Dict[str, Any] = {}
    results = evaluate(cfg, model=model.to(mesh.device), debug=True, mesh=mesh, stats=stats,
                       **kw)
    return {"results": results, "windows": stats["windows"], "seconds": stats["seconds"]}


def jobs_rank(mesh, jobs: Sequence[tuple]) -> List[Dict[str, Any]]:
    """Run ``jobs`` in order on this rank, each ``("train", cfg, runs,
    steps)`` (``train_rank``), ``("eval", cfg, state, kw)`` (``eval_rank``)
    or ``("step", cfg, state, window)`` (``step_rank``): one launch of the
    ranks for several runs."""
    table = {"train": train_rank, "eval": eval_rank, "step": step_rank}
    return [table[kind](mesh, *args) for kind, *args in jobs]
