"""Train a FireNet with the self-supervised event-warping loss (port of the
reference package's ``train_flow.py``)::

    python -m evflow_torch.train_flow --config configs/train_SNN.yml [--prev_runid CKPT]

Writes the run under ``<path_runs>/<experiment>/<runid>/``: ``params.yaml``,
``metrics.jsonl`` and ``checkpoints/<policy>/<epoch>/model.pth``. It runs on
the GPU unless ``--device cpu``. ``--num_devices > 1`` and ``--profile``
are not ported yet and raise.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/train_SNN.yml", help="training configuration")
    parser.add_argument("--path_runs", default="runs", help="tracking and checkpoint root")
    parser.add_argument("--prev_runid", default="",
                        help="checkpoint to resume from (a port model.pth, a reference "
                             "package's model.msgpack, or the directory of either): "
                             "weights, norm statistics and optimizer state")
    parser.add_argument("--num_devices", type=int, default=1)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--profile", metavar="DIR", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cpu for the tests)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.num_devices > 1:
        raise NotImplementedError("--num_devices > 1: data-parallel training comes with "
                                  "ROADMAP.md queue 1 item 11")
    if args.profile:
        raise NotImplementedError("--profile: the device trace comes with the tooling, "
                                  "ROADMAP.md queue 1 item 10")
    from evflow_torch.config import load_config
    from evflow_torch.train import train

    config = load_config(args.config)
    run = train(config, path_runs=args.path_runs, prev_ckpt=args.prev_runid or None,
                max_steps=args.max_steps,
                verbose=bool(config.get("vis", {}).get("verbose", True)), device=args.device)
    print(f"\nRun dir: {run.dir}")
    return run


if __name__ == "__main__":
    main()
