"""Quantized evaluation: PTQ, hybrid, mixed precision, full QAT and the int8
serving engine (port of the reference package's ``eval_flow_quant.py``)::

    python -m evflow_torch.eval_flow_quant <.pth or run id> --config configs/eval_MVSEC.yml \\
        --mode ptq [--auto_tune_lif] [--chunk 8 --device_metrics]
    python -m evflow_torch.eval_flow_quant <.pth, model.msgpack or run id> --mode deploy \\
        [--mem_dtype bfloat16|int8|mixed] [--z_int8] [--chunk 8 --device_metrics]
    python -m evflow_torch.eval_flow_quant <SpikingRecEVFlowNet .pth> --mode deploy \
        [--compute bfloat16|int8|hybrid|hybrid8] [--phase_decoders]
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
              calibrated on the profile windows for voxels. A
              ``SpikingRecEVFlowNet`` config runs the UNet engine
              (``evflow_torch.deploy_unet``): bf16 membranes, the conv tier
              ``--compute`` (``hybrid`` by default), ``--phase_decoders``
              folds the decoders' bilinear x2 into their kernels;
              ``--z_int8`` and int8 membranes are the FireNet engine's.
              ``--artifact`` evaluates a ``save_engine`` or
              ``save_unet_engine`` artifact instead (its ``model`` picks the
              engine; it fixes the tiers and the input scale).

The checkpoint is read as by ``eval_flow``: a ``.pth`` (the reference's or
a port checkpoint), a reference package's ``model.msgpack``, or a run id of
either package under ``--path_runs``. The quantised model runs unfused (the
fused kernels run no fake quant); ``--chunk K`` runs K windows as one CUDA
graph replay and ``--device_metrics`` computes the metrics in it. Results
go to ``<path_results>/quant_<mode>/`` unless ``--debug``. It runs on the
GPU unless ``--device cpu``. The fake-quant modes refuse a
``SpikingRecEVFlowNet`` (they hook the FireNet family's cells).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from evflow_torch.deploy_unet import COMPUTE_TIERS

MODES = ("ptq", "hybrid", "mixed", "full_qat", "deploy")


ENGINE_FLAGS = ("--artifact", "--mem_dtype", "--z_int8", "--compute", "--phase_decoders")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help=".pth or model.msgpack checkpoint, or a run id under --path_runs "
                             "(not with --artifact)")
    parser.add_argument("--config", default="configs/eval_MVSEC.yml")
    parser.add_argument("--mode", default="ptq", choices=MODES)
    parser.add_argument("--artifact", default=None,
                        help="deploy mode: evaluate a save_engine or save_unet_engine .npz "
                             "artifact (it fixes the tiers, the input scale and the z "
                             "requantisation)")
    parser.add_argument("--mem_dtype", default=None, choices=["bfloat16", "int8", "mixed"],
                        help="deploy mode: membrane carries (mixed: bf16 head, int8 "
                             "elsewhere; the UNet engine: bfloat16 only); bfloat16 by default")
    parser.add_argument("--compute", default=None, choices=COMPUTE_TIERS,
                        help="deploy mode, UNet engine: the conv tier (hybrid by default)")
    parser.add_argument("--phase_decoders", action="store_true",
                        help="deploy mode, UNet engine: fold the decoders' bilinear x2 into "
                             "four low-resolution kernels (a 1-2 px border diverges)")
    parser.add_argument("--z_int8", action="store_true",
                        help="deploy mode, FireNet engine: calibrated int8 GEMM intermediates")
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
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = _parser()
    args = parser.parse_args(argv)
    given = [f for f, on in zip(ENGINE_FLAGS, (args.artifact, args.mem_dtype, args.z_int8,
                                               args.compute, args.phase_decoders)) if on]
    if args.mode != "deploy" and given:
        parser.error(f"{', '.join(given)}: the engine flags need --mode deploy")
    if args.artifact:
        if args.checkpoint is not None:
            parser.error("pass a checkpoint OR --artifact, not both (the artifact already "
                         "contains the prepared parameters)")
        if (args.mem_dtype not in (None, "bfloat16") or args.z_int8 or args.compute
                or args.phase_decoders):
            parser.error("--mem_dtype/--z_int8/--compute/--phase_decoders cannot override an "
                         "artifact: its prepared parameters fix the tiers")
    elif args.checkpoint is None:
        parser.error("a checkpoint is required (or --mode deploy --artifact)")
    args.mem_dtype = args.mem_dtype or "bfloat16"
    return args


def check_engine_flags(args: argparse.Namespace, unet: bool):
    """The flags of the other engine family are usage errors: ``--z_int8``
    and int8 membranes on a UNet, ``--compute`` and ``--phase_decoders`` on
    a FireNet."""
    if unet and args.z_int8:
        _parser().error("--z_int8 applies to the FireNet dy-pack engine; the UNet engine has "
                        "no Z buffer")
    if unet and args.mem_dtype != "bfloat16":
        _parser().error("the UNet engine carries bf16 membranes (int8/mixed tiers are "
                        "FireNet-engine only)")
    if not unet and (args.compute or args.phase_decoders):
        _parser().error("--compute/--phase_decoders apply to the SpikingRecEVFlowNet engine")


def quantized_model(config: Dict[str, Any], weights: Dict[str, Any], mode: str,
                    calibration_batches: int = 50, auto_tune_lif: bool = False,
                    profile_batches: int = 100, device: Optional[str] = None):
    """The config's model with ``weights`` and the quantization of ``mode``
    (see the module's docstring)."""
    from evflow_torch import registry
    from evflow_torch.quant.calibrate import UNET_FAKE_QUANT, calibrate_model_ptq
    from evflow_torch.quant.fake_quant import dynamic_conv_quant, state_quant_fn

    if registry.is_unet(config["model"]):
        raise ValueError(UNET_FAKE_QUANT)
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
                  artifact: Optional[str] = None, device: Optional[str] = None,
                  compute: Optional[str] = None, phase_decoders: bool = False):
    """The int8 serving engine of the config's model with ``weights`` (see
    the module's docstring), or of ``artifact`` (its ``model`` picks the
    engine)."""
    import numpy as np

    from evflow_torch import registry
    from evflow_torch.deploy import Int8DeployEngine, check_artifact, profile_mem_ranges
    from evflow_torch.deploy_unet import Int8UNetEngine

    model = registry.build_model(config["model"], device=device)
    if artifact:
        unet_artifact = check_artifact(artifact).get("model") == "SpikingRecEVFlowNet"
        return (Int8UNetEngine if unet_artifact else Int8DeployEngine).from_artifact(
            model, artifact)
    model.load_state_dict(weights)
    unet = registry.is_unet(config["model"])
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
    if unet:
        return Int8UNetEngine(model, input_scale=input_scale, compute=compute or "hybrid",
                              phase_decoders=phase_decoders)
    engine = Int8DeployEngine(model, mem_dtype=mem_dtype, mem_ranges=mem_ranges,
                              input_scale=input_scale)
    if z_int8:
        engine.calibrate_z(sample_windows(config, key, calibration_batches))
    return engine


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, str]]:
    args = parse_args(argv)
    from evflow_torch import registry
    from evflow_torch.config import load_config
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow import resolve_checkpoint
    from evflow_torch.weights import load_checkpoint

    config = load_config(args.config)
    if args.mode == "deploy":
        weights = None
        if not args.artifact:
            ckpt, _, config = resolve_checkpoint(args.checkpoint, args.path_runs, config)
            check_engine_flags(args, registry.is_unet(config["model"]))
            weights = load_checkpoint(ckpt)
        model = deploy_engine(config, weights, mem_dtype=args.mem_dtype, z_int8=args.z_int8,
                              calibration_batches=args.calibration_batches,
                              profile_batches=args.profile_batches, artifact=args.artifact,
                              device=args.device, compute=args.compute,
                              phase_decoders=args.phase_decoders)
        print("=== quantized evaluation: mode=deploy (int8 serving engine) ===")
        if args.artifact:
            print(f"artifact: {args.artifact}")
        print(f"membranes: {model.mem_dtype}; input scale: {model.input_scale}")
        if hasattr(model, "compute"):
            print(f"SpikingRecEVFlowNet engine: per-channel int8 weights, compute "
                  f"{model.compute}, phase decoders {'on' if model.phase_decoders else 'off'}")
        else:
            print("weights: per-channel int8 (folded BN); spikes: int8 carries")
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
