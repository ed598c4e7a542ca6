"""The whole-network FireNet step scanned over windows on the card (the
port's counterpart of ``benchmarks/pallas_wholenet.py``, ``pallas_loop.py``,
``pallas_loop2.py``, ``pallas_lgrid.py`` and ``pallas_batch.py``).

    python -m evflow_torch.bench_wholenet [--runner fused_net|loop|loop2|lgrid|batch]
                                          [--batch 8] [--windows 32] [--seed 0]

LIFFireNet as those scripts configure it (32 channels, cnt input,
``spiking_neuron`` leak [0, 1] and thresh [0, 0.8]) with seeded weights
(``weights.seeded_state_dict``), at 256x256. One Poisson(0.05) count window
drawn with numpy from ``--seed`` is scanned ``--windows`` times, as the TPU
scripts scan theirs. Each runner (all five unless ``--runner`` names one) is
warmed up with one scan, then timed over 4 scans by the host
clock ending in a synchronize; the best gives windows/s = T * B / seconds.
States are bf16, the runners' default.
Each CUDA kernel has its own fixed tile, so there is no ``tile_rows`` knob.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from evflow_torch.device import describe_card, resolve_device
from evflow_torch.ops.fused_net import WholeNetFireNet
from evflow_torch.ops.fused_net_batch import BatchFireNet
from evflow_torch.ops.fused_net_lgrid import LayerGridFireNet
from evflow_torch.ops.fused_net_loop import UnrolledLoopFireNet
from evflow_torch.ops.fused_net_loop2 import LoopFireNet

__all__ = ["RUNNERS", "MODEL", "seeded_runner", "bench", "main"]

RUNNERS = {  # --runner: (runner, the TPU script it stands for)
    "fused_net": (WholeNetFireNet, "pallas_wholenet.py"),
    "loop": (UnrolledLoopFireNet, "pallas_loop.py"),
    "loop2": (LoopFireNet, "pallas_loop2.py"),
    "lgrid": (LayerGridFireNet, "pallas_lgrid.py"),
    "batch": (BatchFireNet, "pallas_batch.py"),
}
MODEL = {"name": "LIFFireNet", "num_bins": 2, "base_num_channels": 32, "kernel_size": 3,
         "encoding": "cnt", "spiking_neuron": {"leak": [0.0, 1.0], "thresh": [0.0, 0.8]}}
HEIGHT = WIDTH = 256
REPEATS = 4  # timed scans per runner, as the TPU scripts time theirs


def seeded_runner(name: str, device, seed: int = 0):
    """The ``name`` runner over LIFFireNet (``MODEL``) with weights from
    ``seed``, in bf16 state (the runners' default)."""
    from evflow_torch.models.fused import FusedFireNet
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    model = build_model(dict(MODEL), device=device)
    model.load_state_dict(seeded_state_dict(model, seed=seed))
    return RUNNERS[name][0](FusedFireNet.from_firenet(model, layout="cmajor"))


def bench(names: List[str], batch: int = 8, windows: int = 32, seed: int = 0,
          repeats: int = REPEATS, device: Optional[str] = None) -> List[Dict]:
    """A row per runner (bf16 state, the runners' default): best seconds of
    a ``windows``-window scan and windows/s at ``batch`` x 256 x 256."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.poisson(0.05, (batch, HEIGHT, WIDTH, 2)).astype(np.float32),
                     device=dev)
    scan = x.expand(windows, *x.shape)  # the one window, scanned as the TPU scripts do
    rows = []
    for name in names:
        runner = seeded_runner(name, dev, seed=seed)
        states = runner.init_states(batch, HEIGHT, WIDTH)
        states, _ = runner.scan_windows(scan, states)  # warm-up: builds and loads the kernel
        best = math.inf
        for _ in range(repeats):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, flows = runner.scan_windows(scan, states)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        rows.append({"runner": name, "class": type(runner).__name__,
                     "replaces": RUNNERS[name][1], "batch": batch, "windows": windows,
                     "ms": 1e3 * best, "windows_per_s": windows * batch / best,
                     "finite": bool(torch.isfinite(flows).all())})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="Whole-network FireNet scans on the card.")
    ap.add_argument("--runner", choices=sorted(RUNNERS), default=None,
                    help="one runner (default: all five)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--windows", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    names = [args.runner] if args.runner else list(RUNNERS)
    rows = bench(names, args.batch, args.windows, args.seed)
    print(describe_card(), flush=True)
    for r in rows:
        print(f"{r['runner']} ({r['class']}, as {r['replaces']}) B={r['batch']} "
              f"T={r['windows']} bf16 state: {r['ms']:.2f} ms -> "
              f"{r['windows_per_s']:.0f} win/s", flush=True)
    return rows


if __name__ == "__main__":
    main()
