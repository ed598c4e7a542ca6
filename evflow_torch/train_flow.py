"""Train a FireNet with the self-supervised event-warping loss (port of the
reference package's ``train_flow.py``)::

    python -m evflow_torch.train_flow --config configs/train_SNN.yml [--prev_runid CKPT]

Writes the run under ``<path_runs>/<experiment>/<runid>/``: ``params.yaml``,
``metrics.jsonl`` and ``checkpoints/<policy>/<epoch>/model.pth``. It runs on
the GPU unless ``--device cpu``.

``--num_devices N`` trains data-parallel over N ranks
(``evflow_torch.parallel.mesh``): by default every visible card (one on
the CPU, where a world of one runs without a process group). One process a
card under NCCL, or ``--backend gloo`` (the CPU's, and on CUDA several ranks
sharing the cards there are). ``loader.batch_size`` must be a multiple of
N, else it raises (the reference trains on one device instead). Rank 0
writes the run. ``--profile`` is not ported yet and raises.
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
    parser.add_argument("--num_devices", type=int, default=None,
                        help="ranks to train over (data parallel; default: every visible card)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process group of the ranks (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--profile", metavar="DIR", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cpu for the tests)")
    return parser.parse_args(argv)


def _train_rank(mesh, config, kw):
    from evflow_torch.train import train

    return train(config, mesh=mesh, **kw).runid


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.profile:
        raise NotImplementedError("--profile: the device trace comes with the tooling, "
                                  "ROADMAP.md queue 1 item 10")
    from evflow_torch.config import load_config
    from evflow_torch.parallel.mesh import check_batch, check_mesh, launch
    from evflow_torch.train import train
    from evflow_torch.utils.tracker import Run

    config = load_config(args.config)
    kw = dict(path_runs=args.path_runs, prev_ckpt=args.prev_runid or None,
              max_steps=args.max_steps,
              verbose=bool(config.get("vis", {}).get("verbose", True)))
    n, _, backend = check_mesh(args.num_devices, args.device, args.backend)
    if n > 1:
        check_batch(config, n)
        runid = launch(_train_rank, n, args.device, backend, args=(config, kw))[0]
        run = Run(args.path_runs, config.get("experiment", "Default"), runid)
    else:
        run = train(config, device=args.device, **kw)
    print(f"\nRun dir: {run.dir}")
    return run


if __name__ == "__main__":
    main()
