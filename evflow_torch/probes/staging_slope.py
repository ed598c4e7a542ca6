"""K8e's time against its layer count: what staging one more layer costs.

Times ``probes/staging.py::layer_grid`` (K8e, ``csrc/probe_staging.cu``) at
the probe's shapes (C=32, E=32, W=256, m with E + 8 rows) at L = 1, 3, 5
and 7 layers by CUDA events (calls back to back), and fits a line through
the times by least squares: its slope is the cost of one more layer (half
of them even, with a block of m to stage, half odd), its intercept what
the launch costs besides. Inputs are drawn with numpy as the probe draws them (standard
normal, the weights times 0.05), for the largest L, and each L takes the
first L layers.

It calls ``layer_grid`` alone, so it times the kernel of any checkout that
has it, for instance an earlier commit unpacked with ``git archive``:

    python -m evflow_torch.probes.staging_slope            # this checkout
    python evflow_torch/probes/staging_slope.py --tree DIR  # the package under DIR

Each run prints one JSON line per L and one with the fit, with the card's
name and power limit; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

LAYERS = (1, 3, 5, 7)
C, E, W = 32, 32, 256


def fit(xs, ys):
    """(slope, intercept) of the least-squares line through the points."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return slope, my - slope * mx


def device_ms(fn, iters: int = 50, rounds: int = 3) -> float:
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


def layer_times(layer_grid, layers=LAYERS, seed: int = 0, iters: int = 50):
    """``layer_grid`` (a K8e wrapper) on the card at each L of ``layers``
    (``device_ms``): a row per L with its ms, and the fit ``{"slope_ms",
    "intercept_ms"}``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    top = max(layers)
    w_all = torch.tensor(rng.standard_normal((top, C, 9 * C), dtype=np.float32)
                         * np.float32(0.05), device="cuda").to(torch.bfloat16)
    m = torch.tensor(rng.standard_normal((top, C, E + 8, W), dtype=np.float32),
                     device="cuda").to(torch.bfloat16)
    rows = []
    for n in layers:
        w_n, m_n = w_all[:n].contiguous(), m[:n].contiguous()
        rows.append({"L": n, "ms": device_ms(lambda: layer_grid(w_n, m_n, E), iters)})
    slope, intercept = fit([r["L"] for r in rows], [r["ms"] for r in rows])
    return rows, {"slope_ms": slope, "intercept_ms": intercept}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="the checkout whose evflow_torch to time (default: this one)")
    args = ap.parse_args(argv)
    root = Path(args.tree).resolve() if args.tree else Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("staging_slope: CUDA is not available", file=sys.stderr)
        return 1
    from evflow_torch.device import describe_card
    from evflow_torch.probes import staging

    if not Path(staging.__file__).resolve().is_relative_to(root):
        print(f"staging_slope: evflow_torch came from {staging.__file__}, not {root}",
              file=sys.stderr)
        return 1
    rows, line = layer_times(staging.layer_grid)
    card = describe_card()
    for r in rows + [line]:
        print(json.dumps({"tree": str(root), **r, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
