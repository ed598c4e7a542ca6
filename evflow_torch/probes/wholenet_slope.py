"""K7's and K5's time against their unit count: what one more unit costs,
and what a K7 unit's time is made of.

Times the whole-net step of K7 (``ops/fused_net_batch.py``,
``csrc/fused_net_batch.cu``) and K5 (``ops/fused_net_loop2.py``,
``csrc/fused_net_loop2.cu``) on the first L = 1, 3, 5 and 7 units of the
seeded LIFFireNet (``bench_wholenet.MODEL``, weights from seed 0) at B=2
and B=8, 256x256, in bf16 and f32 state, by CUDA events (calls back to
back, on spiking states), and fits a line through the times by least
squares: its slope is what one more unit costs (a mix of feedforward and
recurrent units, as the net stacks them), its intercept what an item and
the launch cost besides. The input is one Poisson(0.05) count window drawn
with numpy from seed 0.

With ``--split`` it times K7 alone (B=2, bf16 state) in variant builds of
``csrc/fused_net_batch.cu``, each with one part of the kernel taken out
(``VARIANTS``): the state loads of the epilogue, its stores, the whole
epilogue, the recurrent spike staging, the weight staging, the event
staging, the fragment loads and mma, the flow, every round of 16-pixel
fragments after a unit's first. A part is a ``k7_keeps(K7_CUT_<part>)``
test in the source, taken out by building with ``-DK7_CUT=K7_CUT_<part>``
(``cuda_build.NVCC_FLAGS``, every variant's ``nvcc`` started at once,
into ``evflow_torch/_build/split/<variant>``) and loaded in place of the
kernel's entry point. A checkout whose source lacks a part's test is
refused, and a part the source does not declare fails the build. The
variants compute wrong results: they time, nothing more. The difference
of a variant's slope from the full kernel's is what that part costs a
unit. The full kernel is timed first and last, so drift shows.

It calls the runners alone, so it times the kernels of any checkout that
has them, for instance an earlier commit unpacked with ``git archive``:

    python -m evflow_torch.probes.wholenet_slope             # this checkout
    python evflow_torch/probes/wholenet_slope.py --tree DIR  # the package under DIR
    python -m evflow_torch.probes.wholenet_slope --split     # K7's variants

Each run prints one JSON line per point and one per fit, with the card's
name and power limit; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

LAYERS = (1, 3, 5, 7)
BATCHES = (2, 8)
STATES = ("bf16", "f32")
KERNELS = {  # name: (module under evflow_torch.ops, runner class)
    "K7": ("fused_net_batch", "BatchFireNet"),
    "K5": ("fused_net_loop2", "LoopFireNet"),
}
HEIGHT = WIDTH = 256
ITERS = 20  # calls timed back to back for one CUDA-event time
SPLIT_BATCH, SPLIT_STATE = 2, "bf16"

# K7's variants for --split: name -> the part taken out (csrc/fused_net_batch.cu,
# enum K7Cut), None for the full kernel
VARIANTS = {
    "full": None,
    "no_state_loads": "K7_CUT_STATE_LOADS",
    "no_state_stores": "K7_CUT_STATE_STORES",
    "no_epilogue": "K7_CUT_EPILOGUE",
    "no_spike_stage": "K7_CUT_SPIKE_STAGE",
    "no_weight_stage": "K7_CUT_WEIGHT_STAGE",
    "no_x_stage": "K7_CUT_EVENT_STAGE",
    "no_mma": "K7_CUT_MMA",
    "no_pred": "K7_CUT_FLOW",
    "one_round": "K7_CUT_SECOND_ROUND",
}


def fit(xs, ys):
    """(slope, intercept) of the least-squares line through the points."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return slope, my - slope * mx


def device_ms(fn, iters: int = ITERS, rounds: int = 3) -> float:
    """The best of ``rounds`` CUDA-event times of ``iters`` calls back to
    back, per call, after warm-up; the card sleeps while the host enqueues.
    Kept here, not taken from the package under test, so that every
    checkout is timed alike."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e8))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def first_units(runner, n: int):
    """``runner`` (a K5 or K7 runner) cut to the first ``n`` units of its
    net, with its stacked weights and spike slots made anew."""
    from evflow_torch.ops.fused_net import stack_weights

    w = runner.weights
    runner.weights = w._replace(recurrent=w.recurrent[:n], wk=w.wk[:n],
                                params=w.params[:n].contiguous())
    runner.w_stack = stack_weights(runner.weights)
    runner.slots = runner.slot_layout(runner.weights.recurrent)
    return runner


def unit_times(kernel: str, batch: int, state: str, layers=LAYERS):
    """K7 or K5 (``kernel``) on the card at ``batch`` x 256^2 in ``state``
    over the first L units of the seeded LIFFireNet, for each L of
    ``layers``: a row per L with its ms, and the fit ``{"slope_ms",
    "intercept_ms"}``."""
    import importlib

    import numpy as np
    import torch

    from evflow_torch.bench_wholenet import MODEL
    from evflow_torch.models.fused import FusedFireNet
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    module, cls_name = KERNELS[kernel]
    cls = getattr(importlib.import_module(f"evflow_torch.ops.{module}"), cls_name)
    model = build_model(dict(MODEL), device="cuda")
    model.load_state_dict(seeded_state_dict(model, seed=0))
    fused = FusedFireNet.from_firenet(model, layout="cmajor")
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.poisson(0.05, (batch, HEIGHT, WIDTH, 2)).astype(np.float32),
                     device="cuda")
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[state]
    rows = []
    for n in layers:
        runner = first_units(cls(fused, state_dtype=dtype), n)
        states = runner.init_states(batch, HEIGHT, WIDTH)
        _, states = runner.step(x, states)  # spiking states, not zeros
        ms = device_ms(lambda: runner.step(x, states))
        rows.append({"kernel": kernel, "batch": batch, "state": state, "L": n, "ms": ms})
    slope, intercept = fit([r["L"] for r in rows], [r["ms"] for r in rows])
    return rows, {"kernel": kernel, "batch": batch, "state": state, "slope_ms": slope,
                  "intercept_ms": intercept}


def missing_hooks(root: Path):
    """The variants whose part ``root``'s K7 source has no
    ``k7_keeps(K7_CUT_<part>)`` test for: a build with that part taken out
    would time the full kernel."""
    src = (root / "evflow_torch" / "csrc" / "fused_net_batch.cu").read_text()
    return [name for name, cut in VARIANTS.items()
            if cut is not None and f"k7_keeps({cut})" not in src]


def build_variants(root: Path):
    """``libfused_net_batch.so`` of every variant under
    ``evflow_torch/_build/split/<name>``, one ``nvcc`` each, all started
    together, with its ptxas report beside it as ``ptxas.txt``: {name:
    directory}. Raises on a source without a variant's test or a failed
    build."""
    from evflow_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    missing = missing_hooks(root)
    if missing:
        raise RuntimeError(f"csrc/fused_net_batch.cu has no k7_keeps test for {missing}")
    src = root / "evflow_torch" / "csrc" / "fused_net_batch.cu"
    nvcc = nvcc_path()
    dirs, procs = {}, {}
    for name, cut in VARIANTS.items():
        d = root / "evflow_torch" / "_build" / "split" / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        dirs[name] = d
        flags = [] if cut is None else [f"-DK7_CUT={cut}"]
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *flags, "-o", str(d / "libfused_net_batch.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (dirs[name] / "ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed[name] = log[-2000:]
    if failed:
        raise RuntimeError(f"variant builds failed: {failed}")
    return dirs


def split(root: Path):
    """K7's fit at B=2, bf16 state, in every variant build (``VARIANTS``),
    the full kernel first and last: a JSON-ready row per fit, with the
    part taken out."""
    from evflow_torch.ops import cuda_build

    dirs = build_variants(root)
    order = ["full"] + [n for n in VARIANTS if n != "full"] + ["full"]
    out = []
    for name in order:
        fn = ctypes.CDLL(str(dirs[name] / "libfused_net_batch.so")).fused_net_batch
        fn.argtypes = cuda_build.SIGNATURES["fused_net_batch"]
        fn.restype = ctypes.c_int
        cuda_build._ENTRIES["fused_net_batch"] = fn
        rows, line = unit_times("K7", SPLIT_BATCH, SPLIT_STATE)
        out.append({"variant": name, "cut": VARIANTS[name] or "K7_CUT_NONE",
                    "points_ms": [r["ms"] for r in rows], **line})
    cuda_build._ENTRIES.pop("fused_net_batch", None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="the checkout whose evflow_torch to time (default: this one)")
    ap.add_argument("--split", action="store_true",
                    help="time K7's variant builds (VARIANTS) instead, at B=2, bf16 state")
    args = ap.parse_args(argv)
    root = Path(args.tree).resolve() if args.tree else Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("wholenet_slope: CUDA is not available", file=sys.stderr)
        return 1
    import evflow_torch
    from evflow_torch.device import describe_card

    if not Path(evflow_torch.__file__).resolve().is_relative_to(root):
        print(f"wholenet_slope: evflow_torch came from {evflow_torch.__file__}, not {root}",
              file=sys.stderr)
        return 1
    card = describe_card()
    if args.split:
        for r in split(root):
            print(json.dumps({"tree": str(root), **r, "card": card}), flush=True)
        return 0
    for kernel in KERNELS:
        for batch in BATCHES:
            for state in STATES:
                rows, line = unit_times(kernel, batch, state)
                for r in rows + [line]:
                    print(json.dumps({"tree": str(root), **r, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
