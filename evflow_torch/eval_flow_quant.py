"""Quantized evaluation: PTQ, hybrid, mixed precision, full QAT and the int8
serving engine (port of the reference package's ``eval_flow_quant.py``)::

    python -m evflow_torch.eval_flow_quant <.pth or run id> --config configs/eval_MVSEC.yml \\
        --mode ptq [--auto_tune_lif] [--chunk 8 --device_metrics]
    python -m evflow_torch.eval_flow_quant <.pth, model.msgpack or run id> --mode deploy \\
        [--mem_dtype bfloat16|int8|mixed] [--z_int8] [--chunk 8 --device_metrics]
    python -m evflow_torch.eval_flow_quant --mode deploy --artifact engine.npz

Modes:
  ptq      -- an FP32 checkpoint with int8 conv activations at static
              per-layer scales (calibrated over ``--calibration_batches``
              batches) and int8 membranes (``--auto_tune_lif``: per-layer
              ranges profiled over ``--profile_batches`` batches);
  hybrid   -- int8 membranes alone (for a conv-only QAT checkpoint; the
              calibration's ``states_only`` mode);
  mixed    -- dynamic int8 conv activations, the config's membranes;
  full_qat -- dynamic int8 conv activations and int8 membranes;
  deploy   -- the int8 serving engine (``evflow_torch.deploy``): folded BN,
              per-channel int8 weights, int8 spike carries, int8 GEMMs;
              membranes in ``--mem_dtype`` (int8 and mixed: ranges profiled
              over ``--profile_batches`` windows), ``--z_int8`` requantises
              each GEMM's output (scales calibrated over
              ``--calibration_batches`` windows). The input's int8 grid:
              ``1 / (ph * pw)`` for counts pooled by ph x pw, a scale
              calibrated on the profile windows for voxels. ``--artifact``
              evaluates a ``save_engine`` artifact instead (it fixes the
              tiers and the input scale).

The checkpoint is read as by ``eval_flow``: a ``.pth`` (the reference's or
a port checkpoint), a reference package's ``model.msgpack``, or a run id of
either package under ``--path_runs``. The quantised model runs unfused (the
fused kernels run no fake quant); ``--chunk K`` runs K windows as one CUDA
graph replay and ``--device_metrics`` computes the metrics in it. Results
go to ``<path_results>/quant_<mode>/`` unless ``--debug``. It runs on the
GPU unless ``--device cpu``. ``--compute`` and ``--phase_decoders`` belong
to the UNet engine and raise: it comes with ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

MODES = ("ptq", "hybrid", "mixed", "full_qat", "deploy")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help=".pth or model.msgpack checkpoint, or a run id under --path_runs "
                             "(not with --artifact)")
    parser.add_argument("--config", default="configs/eval_MVSEC.yml")
    parser.add_argument("--mode", default="ptq", choices=MODES)
    parser.add_argument("--artifact", default=None,
                        help="deploy mode: evaluate a save_engine .npz artifact (it fixes the "
                             "membrane tiers, the input scale and the z requantisation)")
    parser.add_argument("--mem_dtype", default=None, choices=["bfloat16", "int8", "mixed"],
                        help="deploy mode: membrane carries (mixed: bf16 head, int8 "
                             "elsewhere); bfloat16 by default")
    parser.add_argument("--compute", default=None,
                        choices=["bfloat16", "int8", "hybrid", "hybrid8"],
                        help="deploy mode, UNet engine (not ported)")
    parser.add_argument("--phase_decoders", action="store_true",
                        help="deploy mode, UNet engine (not ported)")
    parser.add_argument("--z_int8", action="store_true",
                        help="deploy mode: calibrated int8 GEMM intermediates")
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
    unet = [flag for flag, on in (("--compute", args.compute),
                                  ("--phase_decoders", args.phase_decoders)) if on]
    if unet:
        raise NotImplementedError(f"{', '.join(unet)}: the UNet serving engine comes with the "
                                  "UNet family, ROADMAP.md queue 1 item 9")
    if args.mode != "deploy" and (args.artifact or args.mem_dtype or args.z_int8):
        parser.error("--artifact, --mem_dtype and --z_int8 need --mode deploy")
    if args.artifact:
        if args.checkpoint is not None:
            parser.error("pass a checkpoint OR --artifact, not both (the artifact already "
                         "contains the prepared parameters)")
        if args.mem_dtype not in (None, "bfloat16") or args.z_int8:
            parser.error("--mem_dtype/--z_int8 cannot override an artifact: its prepared "
                         "parameters fix the tier and z-config")
    elif args.checkpoint is None:
        parser.error("a checkpoint is required (or --mode deploy --artifact)")
    args.mem_dtype = args.mem_dtype or "bfloat16"
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


def sample_windows(config: Dict[str, Any], key: str, n: int) -> list:
    """The first ``n`` windows' ``key`` arrays of the config's stream."""
    from evflow_torch.data.h5_stream import H5EventStream

    stream = H5EventStream(config, config["model"].get("num_bins", 2),
                           config["model"].get("round_encoding", False))
    try:
        return [stream.next_batch()[key] for _ in range(n)]
    finally:
        stream.close()


def deploy_engine(config: Dict[str, Any], weights: Optional[Dict[str, Any]] = None,
                  mem_dtype: str = "bfloat16", z_int8: bool = False,
                  calibration_batches: int = 50, profile_batches: int = 100,
                  artifact: Optional[str] = None, device: Optional[str] = None):
    """The int8 serving engine of the config's model with ``weights`` (see
    the module's docstring), or of ``artifact``."""
    import numpy as np

    from evflow_torch import registry
    from evflow_torch.deploy import Int8DeployEngine, check_artifact, profile_mem_ranges

    if artifact:
        check_artifact(artifact)
        return Int8DeployEngine.from_artifact(
            registry.build_model(config["model"], device=device), artifact)
    model = registry.build_model(config["model"], device=device)
    model.load_state_dict(weights)
    encoding = config["model"].get("encoding", "cnt")
    key = "event_voxel" if encoding == "voxel" else "event_cnt"
    input_scale = 1.0
    if encoding == "cnt":
        # pooled counts are multiples of 1 / (ph * pw): exact on that grid
        th, tw = config["loader"]["resolution"]
        sh, sw = config["loader"].get("std_resolution", [th, tw])
        if (sh, sw) != (th, tw):
            input_scale = 1.0 / ((sh // th) * (sw // tw))
    mem_ranges = None
    if mem_dtype in ("int8", "mixed") or encoding == "voxel":
        windows = sample_windows(config, key, profile_batches)
        if encoding == "voxel":
            input_scale = max(float(np.max(np.abs(w))) for w in windows) / 127.0 or 1.0
        if mem_dtype in ("int8", "mixed"):
            mem_ranges = profile_mem_ranges(model, windows, input_scale=input_scale)
    engine = Int8DeployEngine(model, mem_dtype=mem_dtype, mem_ranges=mem_ranges,
                              input_scale=input_scale)
    if z_int8:
        engine.calibrate_z(sample_windows(config, key, calibration_batches))
    return engine


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, str]]:
    args = parse_args(argv)
    from evflow_torch.config import load_config
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow import resolve_checkpoint
    from evflow_torch.weights import load_checkpoint

    config = load_config(args.config)
    if args.mode == "deploy":
        weights = None
        if not args.artifact:
            ckpt, _, config = resolve_checkpoint(args.checkpoint, args.path_runs, config)
            weights = load_checkpoint(ckpt)
        model = deploy_engine(config, weights, mem_dtype=args.mem_dtype, z_int8=args.z_int8,
                              calibration_batches=args.calibration_batches,
                              profile_batches=args.profile_batches, artifact=args.artifact,
                              device=args.device)
        print("=== quantized evaluation: mode=deploy (int8 serving engine) ===")
        if args.artifact:
            print(f"artifact: {args.artifact}")
        print("weights: per-channel int8 (folded BN); spikes: int8 carries")
        print(f"membranes: {model.mem_dtype}; input scale: {model.input_scale}")
        print(f"GEMM intermediates: {'calibrated int8' if model.z_int8 else 'bf16'}")
    else:
        ckpt, _, config = resolve_checkpoint(args.checkpoint, args.path_runs, config)
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
