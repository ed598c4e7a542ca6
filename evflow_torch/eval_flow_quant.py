"""Quantized evaluation: PTQ, hybrid, mixed precision, full QAT (port of the
reference package's ``eval_flow_quant.py``)::

    python -m evflow_torch.eval_flow_quant <.pth or run id> --config configs/eval_MVSEC.yml \\
        --mode ptq [--auto_tune_lif] [--chunk 8 --device_metrics]

Modes:
  ptq      -- an FP32 checkpoint with int8 conv activations at static
              per-layer scales (calibrated over ``--calibration_batches``
              batches) and int8 membranes (``--auto_tune_lif``: per-layer
              ranges profiled over ``--profile_batches`` batches);
  hybrid   -- int8 membranes alone (for a conv-only QAT checkpoint; the
              calibration's ``states_only`` mode);
  mixed    -- dynamic int8 conv activations, the config's membranes;
  full_qat -- dynamic int8 conv activations and int8 membranes.

The checkpoint is read as by ``eval_flow``: a ``.pth`` (the reference's or
a port checkpoint) or a port run id under ``--path_runs``. The quantised
model runs unfused (the fused kernels run no fake quant); ``--chunk K``
runs K windows as one CUDA graph replay and ``--device_metrics`` computes
the metrics in it. Results go to ``<path_results>/quant_<mode>/`` unless
``--debug``. It runs on the GPU unless ``--device cpu``. ``--mode
deploy``, ``--artifact`` and the other flags of the int8 serving engines
raise: they come with ROADMAP.md queue 1 item 8.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

MODES = ("ptq", "hybrid", "mixed", "full_qat", "deploy")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help=".pth checkpoint, or a run id under --path_runs")
    parser.add_argument("--config", default="configs/eval_MVSEC.yml")
    parser.add_argument("--mode", default="ptq", choices=MODES)
    parser.add_argument("--artifact", default=None, help="deploy mode (not ported)")
    parser.add_argument("--mem_dtype", default=None, choices=["bfloat16", "int8", "mixed"],
                        help="deploy mode (not ported)")
    parser.add_argument("--compute", default=None,
                        choices=["bfloat16", "int8", "hybrid", "hybrid8"],
                        help="deploy mode, UNet engine (not ported)")
    parser.add_argument("--phase_decoders", action="store_true",
                        help="deploy mode, UNet engine (not ported)")
    parser.add_argument("--z_int8", action="store_true", help="deploy mode (not ported)")
    parser.add_argument("--calibration_batches", type=int, default=50)
    parser.add_argument("--auto_tune_lif", action="store_true",
                        help="profile per-layer membrane ranges")
    parser.add_argument("--profile_batches", type=int, default=100)
    parser.add_argument("--path_runs", default="runs")
    parser.add_argument("--path_results", default="results_inference/")
    parser.add_argument("--debug", action="store_true", help="don't save stuff")
    parser.add_argument("--max_windows", type=int, default=None)
    parser.add_argument("--chunk", type=int, default=1,
                        help="run K windows as one dispatch (one CUDA graph replay)")
    parser.add_argument("--device_metrics", action="store_true",
                        help="compute the metrics inside the chunk's dispatch (needs --chunk > 1)")
    parser.add_argument("--device", default="cuda", help="torch device (cpu for the tests)")
    args = parser.parse_args(argv)
    deploy = [flag for flag, on in (("--mode deploy", args.mode == "deploy"),
                                    ("--artifact", args.artifact),
                                    ("--mem_dtype", args.mem_dtype),
                                    ("--compute", args.compute),
                                    ("--phase_decoders", args.phase_decoders),
                                    ("--z_int8", args.z_int8)) if on]
    if deploy:
        raise NotImplementedError(f"{', '.join(deploy)}: the int8 serving engines come with "
                                  "ROADMAP.md queue 1 item 8")
    if args.checkpoint is None:
        parser.error("a checkpoint is required")
    return args


def quantized_model(config: Dict[str, Any], weights: Dict[str, Any], mode: str,
                    calibration_batches: int = 50, auto_tune_lif: bool = False,
                    profile_batches: int = 100, device: Optional[str] = None):
    """The config's model with ``weights`` and the quantization of ``mode``
    (see the module's docstring)."""
    from evflow_torch import registry
    from evflow_torch.quant.calibrate import calibrate_model_ptq
    from evflow_torch.quant.fake_quant import dynamic_conv_quant, state_quant_fn

    if mode in ("ptq", "hybrid"):
        return calibrate_model_ptq(config, weights, mode="full" if mode == "ptq" else "states_only",
                                   num_batches=calibration_batches, auto_tune=auto_tune_lif,
                                   profile_batches=profile_batches, device=device)
    model = registry.build_model(config["model"], device=device)
    model.load_state_dict(weights)
    if mode == "full_qat":
        return model.set_quant(state_quant=state_quant_fn(), conv_fake_quant=dynamic_conv_quant())
    return model.set_quant(conv_fake_quant=dynamic_conv_quant())


def describe(model, mode: str, name: str) -> str:
    """The quantization report printed before the evaluation."""
    from evflow_torch.models.summary import summarize

    if model.conv_fake_quant_per_layer is not None:
        conv = "int8 static per-layer (calibrated scales)"
    elif model.conv_fake_quant is not None:
        conv = "int8 dynamic per-tensor"
    else:
        conv = "disabled (fp32)"
    if model.cell_family != "snn":
        mem = "not quantised (sigmoid-family cells)"
    elif model.state_quant_per_layer is not None:
        mem = "per-layer auto-tuned ranges"
    elif model.state_quant is not None:
        mem = "int8 uniform [-250, 1] (snntorch default)"
    else:
        mem = "disabled (fp32 membranes)"
    return "\n".join([f"=== quantized evaluation: mode={mode} ===", summarize(model, name),
                      f"conv fake-quant: {conv}", f"membrane quant: {mem}"])


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, str]]:
    args = parse_args(argv)
    from evflow_torch.config import load_config
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow import resolve_checkpoint
    from evflow_torch.weights import load_checkpoint

    ckpt, _, config = resolve_checkpoint(args.checkpoint, args.path_runs,
                                         load_config(args.config))
    model = quantized_model(config, load_checkpoint(ckpt), args.mode,
                            calibration_batches=args.calibration_batches,
                            auto_tune_lif=args.auto_tune_lif,
                            profile_batches=args.profile_batches, device=args.device)
    print(describe(model, args.mode, config["model"].get("name", "model")))
    results = evaluate(config, model=model, path_results=args.path_results,
                       runid=f"quant_{args.mode}", debug=args.debug,
                       max_windows=args.max_windows, chunk=args.chunk,
                       device_metrics=args.device_metrics, device=args.device)
    print()
    for metric, per_file in results.items():
        for fname, val in per_file.items():
            print(f"{metric:16s} {fname:32s} {val}")
    return results


if __name__ == "__main__":
    main()
