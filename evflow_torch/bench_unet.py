"""Serving throughput of the UNet int8 engine beside the f32 model on the
card (the port's counterpart of ``benchmarks/bench_unet_deploy.py``)::

    python -m evflow_torch.bench_unet [--res 256] [--channels 32] [--batch 1]
        [--T 1024] [--iters 4] [--what engine|f32|both]
        [--compute bfloat16|int8|hybrid|hybrid8] [--phase] [--dypack_min_spatial 128]

``SpikingRecEVFlowNet`` (4 encoders, 2 residual blocks, cnt input) at
``--channels`` base channels and ``--res``x``--res``, seeded weights
(``weights.seeded_unet_state_dict``: every state slot fires), one
Poisson(0.05) count window (numpy, seed 0) reused at every step, the states
carried across steps. The steps run as replays of one CUDA graph of
``CHUNK`` (16) steps, ``--T`` in all, ending in a sync; the rate is the
best of ``--iters`` timed runs by the host clock, in windows (steps times
batch) a second. ``--what`` picks the int8 engine (``--compute``,
``--phase``: phase decoders, ``--dypack_min_spatial``: the hybrid tiers'
crossover), the f32 model, or both. Prints one JSON line with the rates,
the ms a step and the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from evflow_torch.chunk import copy_carry
from evflow_torch.deploy_unet import COMPUTE_TIERS

__all__ = ["bench", "make_runner", "CHUNK"]

CHUNK = 16  # steps in the CUDA graph


def _model_cfg(channels: int) -> Dict[str, Any]:
    return {"name": "SpikingRecEVFlowNet", "num_bins": 2, "base_num_channels": channels,
            "kernel_size": 3, "encoding": "cnt",
            "spiking_neuron": {"leak": [-4.0, 0.1], "thresh": [0.8, 0.0]}}


def make_runner(what: str, channels: int = 32, compute: str = "hybrid", phase: bool = False,
                dypack_min_spatial: int = 128, device: str = "cuda", model=None):
    """``(step(x, states) -> (flow, states), init_states)`` of the engine
    (``what="engine"``) or the f32 model (``"f32"``); ``model``, the seeded
    f32 model if given (else built here)."""
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_unet_state_dict

    if model is None:
        model = build_model(_model_cfg(channels), device=device)
        model.load_state_dict(seeded_unet_state_dict(model, seed=0))
    if what == "engine":
        from evflow_torch.deploy_unet import Int8UNetEngine

        model = Int8UNetEngine(model, compute=compute, phase_decoders=phase,
                               dypack_min_spatial=dypack_min_spatial)
    elif what != "f32":
        raise ValueError(f"what must be engine or f32, got {what!r}")

    def step(x, states):
        out, new = model(None, x, states)
        return out["flow"][-1], new

    return step, model.init_states


def window(batch: int, res: int, device: str = "cuda") -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.poisson(0.05, (batch, res, res, 2)).astype(np.float32)).to(device)


@torch.no_grad()
def bench(what: str = "engine", res: int = 256, channels: int = 32, batch: int = 1,
          T: int = 1024, iters: int = 4, compute: str = "hybrid", phase: bool = False,
          dypack_min_spatial: int = 128, runner=None) -> Dict[str, Any]:
    """Windows a second of the engine or the f32 model on the workload (see
    the module's docstring), with the ms a step and each timed run's
    seconds; ``runner``, a ``make_runner`` pair already built, stands for
    the first seven arguments but ``res``, ``batch``, ``T`` and ``iters``."""
    if T % CHUNK:
        raise ValueError(f"T ({T}) must be a multiple of {CHUNK}")
    step, init_states = runner or make_runner(what, channels, compute, phase,
                                              dypack_min_spatial)
    x = window(batch, res)
    states = init_states(batch, res, res)

    def copy_states(dst, src):
        copy_carry([t for s in dst for t in s], [t for s in src for t in s])

    for _ in range(3):  # builds cuBLAS/cuDNN plans before the capture
        _, new = step(x, states)
        copy_states(states, new)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cur = states
        for _ in range(CHUNK):
            _, cur = step(x, cur)
        copy_states(states, cur)
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(T // CHUNK):
            graph.replay()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    best = min(runs)
    return {"windows_per_s": T * batch / best, "ms_per_step": 1e3 * best / T,
            "seconds_runs": runs, "active_px": float((x.sum(-1) > 0).float().mean())}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--T", type=int, default=1024, help="steps, a multiple of 16")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--what", default="both", choices=["engine", "f32", "both"])
    ap.add_argument("--compute", default="hybrid", choices=COMPUTE_TIERS)
    ap.add_argument("--phase", action="store_true", help="phase-decomposed decoders")
    ap.add_argument("--dypack_min_spatial", type=int, default=128,
                    help="hybrid tiers: stride-1 convs at least this high ride the dy-packed "
                         "int8 GEMM")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from evflow_torch.device import describe_card

    if not torch.cuda.is_available():
        raise SystemExit("evflow_torch.bench_unet needs a CUDA card")
    out: Dict[str, Any] = {"metric": f"SpikingRecEVFlowNet {args.res}x{args.res} serving "
                                     f"throughput (B={args.batch})",
                           "unit": "event-windows/s", "card": describe_card(),
                           "res": args.res, "channels": args.channels, "batch": args.batch,
                           "T": args.T, "compute": args.compute, "phase": args.phase,
                           "dypack_min_spatial": args.dypack_min_spatial}
    for what in (("engine", "f32") if args.what == "both" else (args.what,)):
        r = bench(what, args.res, args.channels, args.batch, args.T, args.iters, args.compute,
                  args.phase, args.dypack_min_spatial)
        out[what] = r
        torch.cuda.empty_cache()
    out["value"] = out[args.what if args.what != "both" else "engine"]["windows_per_s"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
