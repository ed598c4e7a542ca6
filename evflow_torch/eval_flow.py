"""Evaluate a model against ground-truth optical flow (port of the reference
package's ``eval_flow.py``)::

    python -m evflow_torch.eval_flow model.pth --config configs/eval_MVSEC.yml \\
        --fused --chunk 8 --device_metrics

The checkpoint is a PyTorch ``.pth`` (the reference's, or a port
training checkpoint), a reference package's ``model.msgpack`` (or its
directory), or the id of a training run of either package under
``--path_runs``: the run's ``params.yaml`` under the config (the config
wins, the run's model survives) and its newest ``lowest_loss`` checkpoint.
Unless ``--debug``, the config and the per-file results go to
``<path_results>/<run id or name of the checkpoint file>/eval_N.yml`` and
``metrics_N.yml``. It runs on the GPU unless ``--device cpu``. The config's
model may be a FireNet or ``SpikingRecEVFlowNet`` (the UNet runs unfused:
``--fused`` refuses it).

``--num_devices N`` fans the batch slots out over N ranks
(``evflow_torch.parallel.mesh``; ``loader.batch_size`` must be a multiple
of N): one process a card under NCCL, or ``--backend gloo`` (the CPU's,
and on CUDA several ranks sharing the cards there are); each rank streams
its own sequence files, rank 0 writes the results. ``--profile`` is not
ported yet and raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Sequence, Tuple


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", help=".pth checkpoint, or a run id under --path_runs")
    parser.add_argument("--config", default="configs/eval_MVSEC.yml",
                        help="config file, overwrites training settings")
    parser.add_argument("--path_runs", default="runs")
    parser.add_argument("--path_results", default="results_inference/")
    parser.add_argument("--debug", action="store_true", help="don't save stuff")
    parser.add_argument("--max_windows", type=int, default=None)
    parser.add_argument("--fused", action="store_true",
                        help="run the fused conv+LIF kernels")
    parser.add_argument("--layout", default="nhwc", choices=("nhwc", "cmajor"),
                        help="state layout of the fused kernels")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="ranks to fan the batch slots out over (data parallel)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process group of the ranks (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("--chunk", type=int, default=1,
                        help="run K windows as one dispatch (one CUDA graph replay)")
    parser.add_argument("--device_metrics", action="store_true",
                        help="compute the metrics inside the chunk's dispatch (needs "
                             "--chunk > 1); only [K, B] values cross to the host")
    parser.add_argument("--profile", metavar="DIR", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cpu for the tests)")
    return parser.parse_args(argv)


def resolve_checkpoint(checkpoint: str, path_runs: str,
                       config: Dict[str, Any]) -> Tuple[str, str, Dict[str, Any]]:
    """``(checkpoint file, run id, config)``. An existing path is a
    checkpoint, its run id the file's name. Else a run id under
    ``path_runs/<experiment>/``: the run's params merged under ``config``
    (``config.merge_configs``) and its newest ``checkpoints/lowest_loss``
    epoch's ``model.pth`` (a port run) or ``model.msgpack`` (a reference
    package's run). Any other name raises ``FileNotFoundError``."""
    if os.path.exists(checkpoint):
        return checkpoint, os.path.basename(checkpoint.rstrip("/")) or "eval", config
    from evflow_torch.config import merge_configs
    from evflow_torch.utils.checkpoint import CKPT_NAME
    from evflow_torch.utils.msgpack import MSGPACK_NAME
    from evflow_torch.utils.tracker import Run

    for exp in sorted(os.listdir(path_runs)) if os.path.isdir(path_runs) else []:
        run_dir = os.path.join(path_runs, exp, checkpoint)
        if not os.path.isdir(run_dir):
            continue
        train_params = Run.load_params(path_runs, exp, checkpoint)
        config = merge_configs({k: str(v) for k, v in train_params.items()}, config)
        lowest = os.path.join(run_dir, "checkpoints", "lowest_loss")
        epochs = sorted(os.listdir(lowest), key=int) if os.path.isdir(lowest) else []
        files = [os.path.join(lowest, epochs[-1], name) for name in (CKPT_NAME, MSGPACK_NAME)
                 ] if epochs else []
        found = [f for f in files if os.path.isfile(f)]
        if not found:
            raise FileNotFoundError(f"run {checkpoint!r} has no lowest_loss checkpoint")
        return found[0], checkpoint, config
    raise FileNotFoundError(f"no checkpoint file or run id {checkpoint!r}")


def _evaluate_rank(mesh, config, kw):
    from evflow_torch.eval import evaluate

    return evaluate(config, mesh=mesh, **kw)


def run(config: Dict[str, Any], checkpoint: str, runid: str, path_results: str,
        debug: bool = False, max_windows: Optional[int] = None, fused: bool = False,
        layout: str = "nhwc", chunk: int = 1, device_metrics: bool = False,
        device: str = "cuda", num_devices: int = 1,
        backend: Optional[str] = None) -> Dict[str, Dict[str, str]]:
    """Evaluate ``checkpoint`` under ``config``, over ``num_devices`` ranks
    if more than one; print and return the per-file results."""
    from evflow_torch.eval import evaluate
    from evflow_torch.parallel.mesh import check_batch, check_mesh, launch

    kw = dict(checkpoint=checkpoint, path_results=path_results, runid=runid, debug=debug,
              max_windows=max_windows, fused=fused, layout=layout, chunk=chunk,
              device_metrics=device_metrics)
    n, _, backend = check_mesh(num_devices, device, backend)
    if n > 1:
        check_batch(config, n)
        if fused:
            raise ValueError("fused backend does not support mesh fan-out")
        results = launch(_evaluate_rank, n, device, backend, args=(config, kw))[0]
    else:
        results = evaluate(config, device=device, **kw)
    print()
    for metric, per_file in results.items():
        for fname, val in per_file.items():
            print(f"{metric:16s} {fname:32s} {val}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, str]]:
    args = parse_args(argv)
    if args.profile:
        raise NotImplementedError("--profile: the device trace comes with the tooling, "
                                  "ROADMAP.md queue 1 item 10")
    from evflow_torch.config import load_config

    ckpt, runid, config = resolve_checkpoint(args.checkpoint, args.path_runs,
                                             load_config(args.config))
    return run(config, ckpt, runid, args.path_results,
               debug=args.debug, max_windows=args.max_windows, fused=args.fused,
               layout=args.layout, chunk=args.chunk, device_metrics=args.device_metrics,
               device=args.device, num_devices=args.num_devices, backend=args.backend)


if __name__ == "__main__":
    main()
