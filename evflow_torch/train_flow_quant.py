"""Quantization-aware training (QAT) of a FireNet (port of the reference
package's ``train_flow_quant.py``)::

    python -m evflow_torch.train_flow_quant --config configs/train_SNN.yml \\
        --prev_runid <FP32 run id or .pth> [--conv_only] [--calibration static]

Full QAT puts int8 fake quant on every conv's input and outputs and on the
membranes inside the training graph; ``--conv_only`` (or
``model.quantization.Conv_only``) leaves the membranes in f32. The conv
scales are each tensor's own absmax (``--calibration dynamic``, the
default), or with ``--calibration static`` calibrated once on the FP32
start over ``--calibration_batches`` batches (``collect_static_scales``)
and stored in the config as ``quantization.static_scales``, so that the
training grid is the deployed PTQ grid. The run starts from
``--prev_runid``: a port run id under ``--path_runs`` (its newest
``lowest_loss`` checkpoint), a port checkpoint or a reference ``.pth``.
The weight, LIF, int8-scale and gradient histograms are stored every
``vis.hist_every`` steps. It runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/train_SNN.yml")
    parser.add_argument("--path_runs", default="runs")
    parser.add_argument("--prev_runid", default="",
                        help="the FP32 start: a run id under --path_runs, a port checkpoint "
                             "or a reference .pth (strongly recommended)")
    parser.add_argument("--conv_only", action="store_true")
    parser.add_argument("--calibration", choices=("dynamic", "static"), default="dynamic",
                        help="static: calibrate the conv scales on the FP32 start so that "
                             "the training and deployed grids agree")
    parser.add_argument("--calibration_batches", type=int, default=50)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cpu for the tests)")
    return parser.parse_args(argv)


def resolve_start(prev: str, path_runs: str) -> str:
    """A checkpoint path as it is, else the newest ``lowest_loss``
    checkpoint of the run id ``prev`` under ``path_runs``."""
    if os.path.exists(prev):
        return prev
    from evflow_torch.eval_flow import resolve_checkpoint

    return resolve_checkpoint(prev, path_runs, {})[0]


def collect_static_scales(config: Dict[str, Any], prev_ckpt: str, num_batches: int = 50,
                          device: Optional[str] = None) -> Dict[str, float]:
    """The conv activation scales of the FP32 model (the config's model
    without its quantization) with ``prev_ckpt``'s weights, over
    ``num_batches`` batches of the config's data."""
    from evflow_torch import registry
    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.quant.calibrate import collect_activation_scales
    from evflow_torch.utils.checkpoint import CKPT_NAME
    from evflow_torch.weights import load_checkpoint

    model_cfg = dict(config["model"])
    model_cfg.pop("quantization", None)  # calibrate the unquantized graph
    model = registry.build_model(model_cfg, device=device)
    path = os.path.join(prev_ckpt, CKPT_NAME) if os.path.isdir(prev_ckpt) else prev_ckpt
    model.load_state_dict(load_checkpoint(path))
    stream = H5EventStream(config, model_cfg.get("num_bins", 2))
    try:
        return collect_activation_scales(model, stream, num_batches=num_batches)
    finally:
        stream.close()


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    from evflow_torch.config import load_config
    from evflow_torch.train import train

    config = load_config(args.config)
    q = config["model"].setdefault("quantization", {})
    q["enabled"] = True
    if args.conv_only:
        q["Conv_only"] = True
    config.setdefault("vis", {})["store_hists"] = True

    prev = resolve_start(args.prev_runid, args.path_runs) if args.prev_runid else None
    if prev is None:
        print("WARNING: QAT without a pretrained FP32 start typically fails to converge.")
    if args.calibration == "static":
        if prev is None:
            raise SystemExit("--calibration static needs --prev_runid: the scales are "
                             "collected from the pretrained FP32 checkpoint")
        scales = collect_static_scales(config, prev, args.calibration_batches, args.device)
        q["static_scales"] = {k: float(v) for k, v in scales.items()}
        print(f"calibrated {len(scales)} static conv-act scales "
              f"({args.calibration_batches} batches)")

    run = train(config, path_runs=args.path_runs, prev_ckpt=prev, max_steps=args.max_steps,
                verbose=bool(config.get("vis", {}).get("verbose", True)), device=args.device)
    print(f"\nRun dir: {run.dir}")
    return run


if __name__ == "__main__":
    main()
