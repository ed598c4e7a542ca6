"""Serving throughput of the int8 engine on the card (the port's counterpart
of the reference package's ``bench.py``)::

    python -m evflow_torch.bench [--batch 2] [--mem_dtype bfloat16|int8|mixed]
        [--runner int8|fused|unfused|unfused_bf16] [--steps 4096] [--repeats 5]

The workload of ``bench.py``: LIFFireNet, 32 channels, ``--batch``
sequences of 256x256, one Poisson(0.05) count window (numpy, seed 0)
reused at every step, the states carried across steps. Weights are seeded
(``weights.seeded_state_dict``: every unit fires); int8 membranes take the
reference's default range (-250, 1), as ``bench.py`` does. The steps run
as replays of one CUDA graph of ``CHUNK`` (32) steps, ``--steps`` in all,
ending in a sync; the rate is the best of ``--repeats`` timed runs by the
host clock, in windows (steps times batch) a second. ``--runner`` picks
the engine (``int8``, the default), or for comparison ``FusedFireNet.step``
(``fused``, K1), or the unfused ``FireNet`` with f32 state (``unfused``) or
bf16 state (``unfused_bf16``). Prints one JSON line with ``metric``,
``value``, ``unit`` and the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from evflow_torch.chunk import copy_carry

__all__ = ["bench", "RUNNERS"]

RUNNERS = ("int8", "fused", "unfused", "unfused_bf16")
H_BENCH = W_BENCH = 256
CHUNK = 32  # steps in the CUDA graph


def _model_cfg(state_dtype: Optional[str] = None) -> Dict[str, Any]:
    cfg = {"name": "LIFFireNet", "num_bins": 2, "base_num_channels": 32, "kernel_size": 3,
           "encoding": "cnt", "spiking_neuron": {"leak": [0.0, 1.0], "thresh": [0.0, 0.8]}}
    if state_dtype:
        cfg["state_dtype"] = state_dtype
    return cfg


def make_runner(runner: str, mem_dtype: str = "bfloat16", device: str = "cuda"):
    """``(step(x, states) -> (flow, states), init_states)`` of a runner."""
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    if runner not in RUNNERS:
        raise ValueError(f"runner must be one of {RUNNERS}, got {runner!r}")
    model = build_model(_model_cfg("bfloat16" if runner == "unfused_bf16" else None),
                        device=device)
    model.load_state_dict(seeded_state_dict(model, seed=0))
    if runner == "fused":
        from evflow_torch.models.fused import FusedFireNet

        net = FusedFireNet.from_firenet(model)
        return net.step, net.init_states
    if runner == "int8":
        from evflow_torch.deploy import Int8DeployEngine

        model = Int8DeployEngine(model, mem_dtype=mem_dtype)

    def step(x, states):
        out, new = model(None, x, states)
        return out["flow"][0], new

    return step, model.init_states


def _copy_states(dst, src):
    copy_carry([t for s in dst for t in s], [t for s in src for t in s])


@torch.no_grad()
def bench(batch: int = 2, mem_dtype: str = "bfloat16", runner: str = "int8", steps: int = 4096,
          repeats: int = 5) -> Dict[str, Any]:
    """Windows a second of ``runner`` on the workload (see the module's
    docstring), with the ms a step and each timed run's seconds."""
    if steps % CHUNK:
        raise ValueError(f"steps ({steps}) must be a multiple of {CHUNK}")
    step, init_states = make_runner(runner, mem_dtype)
    rng = np.random.default_rng(0)
    window = torch.from_numpy(
        rng.poisson(0.05, (batch, H_BENCH, W_BENCH, 2)).astype(np.float32)).cuda()
    states = init_states(batch, H_BENCH, W_BENCH)
    for _ in range(3):  # builds the kernels and warms cuBLAS before the capture
        _, new = step(window, states)
        _copy_states(states, new)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cur = states
        for _ in range(CHUNK):
            _, cur = step(window, cur)
        _copy_states(states, cur)
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps // CHUNK):
            graph.replay()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    best = min(runs)
    return {"windows_per_s": steps * batch / best, "ms_per_step": 1e3 * best / steps,
            "seconds_runs": runs, "active_px": float((window.sum(-1) > 0).float().mean())}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--mem_dtype", default="bfloat16", choices=("bfloat16", "int8", "mixed"))
    ap.add_argument("--runner", default="int8", choices=RUNNERS)
    ap.add_argument("--steps", type=int, default=4096, help="a multiple of 32")
    ap.add_argument("--repeats", type=int, default=5)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from evflow_torch.device import describe_card

    if not torch.cuda.is_available():
        raise SystemExit("evflow_torch.bench needs a CUDA card")
    r = bench(args.batch, args.mem_dtype, args.runner, args.steps, repeats=args.repeats)
    tier = f", {args.mem_dtype} membranes" if args.runner == "int8" else ""
    out = {"metric": f"LIFFireNet 256x256 serving throughput ({args.runner}{tier}, "
                     f"B={args.batch})",
           "value": r["windows_per_s"], "unit": "event-windows/s",
           "card": describe_card(), "runner": args.runner, "batch": args.batch,
           "mem_dtype": args.mem_dtype if args.runner == "int8" else None,
           "steps": args.steps, "ms_per_step": r["ms_per_step"],
           "seconds_runs": r["seconds_runs"], "active_px": r["active_px"]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
