"""The UNet family through the port's CLIs on the CPU, on a small synthetic
set with ``configs/eval_MVSEC.yml``'s settings (16x16 pooled from 32x32),
the model swapped for a 4-channel ``SpikingRecEVFlowNet`` with seeded
weights: ``eval_flow`` and ``eval_flow_quant --mode deploy --compute
--phase_decoders`` equal to the same runs in-process, a
``save_unet_engine`` artifact through ``--artifact``, the usage errors and
refusals (``--fused``, the fake-quant modes, ``train``, the other family's
engine flags), a voxel UNet's calibrated input scale, and the visual
protocol's ``collect_vis`` per window and in chunks. That the new
modules import neither JAX nor the reference package is held by
``tests/test_torch_deploy_cli.py``."""

import os

import numpy as np
import pytest
import torch
import yaml

from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import eval_config, unet_cfg


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The evaluation set, its config (the UNet) and seeded weights as a
    ``.pth``."""
    from evflow_torch.data.synthetic import make_dataset
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_unet_state_dict

    d = tmp_path_factory.mktemp("unet_cli")
    root = str(d / "eval")
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.3, flows=[(12.0, -6.0), (-8.0, 4.0)])
    cfg = eval_config(root, res=16, std=32, metrics=("AEE", "AAE"))
    cfg["model"] = unet_cfg(mask_output=True, norm_input=False, round_encoding=False)
    yml = d / "eval.yml"
    yml.write_text(yaml.safe_dump(cfg))
    model = build_model(cfg["model"], device="cpu")
    pth = str(d / "seeded.pth")
    torch.save(seeded_unet_state_dict(model, seed=2), pth)
    return {"d": d, "cfg": cfg, "yml": str(yml), "pth": pth}


def metrics_file(out, sub):
    with open(os.path.join(out, sub, "metrics_0.yml")) as f:
        got = yaml.safe_load(f)
    got.pop("runid")
    return got


def test_eval_flow_runs_the_unet(ws, tmp_path):
    """``eval_flow`` on a UNet ``.pth`` with ``--chunk 4 --device_metrics``
    writes the in-process per-window results; ``--fused`` refuses before
    any launch."""
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow import main
    from evflow_torch.registry import build_model
    from evflow_torch.weights import load_checkpoint

    out = str(tmp_path / "res")
    got = main([ws["pth"], "--config", ws["yml"], "--chunk", "4", "--device_metrics",
                "--path_results", out, "--device", "cpu"])
    model = build_model(ws["cfg"]["model"], device="cpu")
    model.load_state_dict(load_checkpoint(ws["pth"]))
    ref = evaluate(ws["cfg"], model=model, device="cpu", debug=True)
    assert set(ref) == {"AEE", "AAE", "AEE_percent", "AAE_percent"} and len(ref["AEE"]) == 2
    for k in ref:
        for f in ref[k]:
            assert abs(float(got[k][f]) - float(ref[k][f])) <= 1e-5 * abs(float(ref[k][f]))
    assert metrics_file(out, "seeded.pth") == got
    with pytest.raises(ValueError, match="FireNet family"):
        main([ws["pth"], "--config", ws["yml"], "--fused", "--device", "cpu", "--debug"])


def test_deploy_cli_compute_and_phase_decoders(ws, tmp_path, capsys):
    """``--mode deploy --compute hybrid --phase_decoders``: the CLI's
    ``metrics_0.yml`` equals the same engine evaluated in-process; the
    input grid is the pooling's 1/4."""
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow_quant import deploy_engine, main
    from evflow_torch.weights import load_checkpoint

    out = str(tmp_path / "res")
    got = main([ws["pth"], "--config", ws["yml"], "--mode", "deploy", "--compute", "hybrid",
                "--phase_decoders", "--path_results", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "compute hybrid, phase decoders on" in text and "input scale: 0.25" in text
    engine = deploy_engine(ws["cfg"], load_checkpoint(ws["pth"]), compute="hybrid",
                           phase_decoders=True, device="cpu")
    assert (engine.compute, engine.phase_decoders, engine.input_scale) == ("hybrid", True, 0.25)
    assert got == evaluate(ws["cfg"], model=engine, device="cpu", debug=True) == \
        metrics_file(out, "quant_deploy")


def test_deploy_cli_unet_artifact(ws, tmp_path):
    """``--artifact``: a ``save_unet_engine`` file (int8 tier) evaluates as
    the engine that wrote it, its model picking the UNet engine."""
    from evflow_torch.deploy_unet import save_unet_engine
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow_quant import deploy_engine, main
    from evflow_torch.weights import load_checkpoint

    engine = deploy_engine(ws["cfg"], load_checkpoint(ws["pth"]), compute="int8", device="cpu")
    art = save_unet_engine(engine, str(tmp_path / "unet_engine.npz"))
    out = str(tmp_path / "res")
    got = main(["--config", ws["yml"], "--mode", "deploy", "--artifact", art, "--chunk", "4",
                "--path_results", out, "--device", "cpu"])
    assert got == evaluate(ws["cfg"], model=engine, device="cpu", debug=True) == \
        metrics_file(out, "quant_deploy")
    with pytest.raises(SystemExit):
        main(["--config", ws["yml"], "--mode", "deploy", "--artifact", art, "--compute", "int8"])


@pytest.mark.parametrize("flags", [["--z_int8"], ["--mem_dtype", "int8"]])
def test_deploy_cli_unet_usage_errors(ws, flags):
    """The FireNet engine's flags on a UNet are usage errors."""
    from evflow_torch.eval_flow_quant import main

    with pytest.raises(SystemExit):
        main([ws["pth"], "--config", ws["yml"], "--mode", "deploy", "--device", "cpu",
              "--debug", *flags])


def test_unet_refusals(ws, tmp_path):
    """The fake-quant modes refuse a UNet, naming its engine; ``train``
    refuses it naming queue 1 item 14; ``--compute`` on a FireNet config is
    a usage error."""
    from _torch_port import model_cfg
    from evflow_torch.eval_flow_quant import main
    from evflow_torch.registry import build_model
    from evflow_torch.train import train
    from evflow_torch.weights import seeded_state_dict

    for mode in ("ptq", "mixed"):
        with pytest.raises(ValueError, match="mode deploy"):
            main([ws["pth"], "--config", ws["yml"], "--mode", mode, "--device", "cpu", "--debug"])
    cfg = dict(ws["cfg"], data=dict(ws["cfg"]["data"], mode="events"))
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        train(cfg, path_runs=str(tmp_path / "runs"), device="cpu", max_steps=1)
    fire = dict(ws["cfg"], model=model_cfg("LIFFireNet", 8))
    yml = tmp_path / "fire.yml"
    yml.write_text(yaml.safe_dump(fire))
    pth = str(tmp_path / "fire.pth")
    torch.save(seeded_state_dict(build_model(fire["model"], device="cpu")), pth)
    with pytest.raises(SystemExit):
        main([pth, "--config", str(yml), "--mode", "deploy", "--compute", "int8", "--device",
              "cpu", "--debug"])


def test_voxel_unet_calibrates_its_input_scale(ws):
    """A voxel UNet's engine takes ``max |voxel| / 127`` over the profile
    windows as its input grid, as the reference CLI does."""
    from evflow_torch.eval_flow_quant import deploy_engine, sample_windows
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_unet_state_dict

    cfg = dict(ws["cfg"], model=unet_cfg(encoding="voxel", num_bins=2))
    sd = seeded_unet_state_dict(build_model(cfg["model"], device="cpu"))
    engine = deploy_engine(cfg, sd, profile_batches=3, device="cpu")
    wins = sample_windows(cfg, "event_voxel", 3)
    assert engine.input_scale == pytest.approx(max(float(np.max(np.abs(w))) for w in wins) / 127)
    assert engine.input_scale != 1.0


def test_visual_protocol_runs_the_unet(ws):
    """``collect_vis`` (the IWE beside the step per window, on the host over
    the fetched flows in chunks of 3): the same results and, window by
    window, the same flow, counts and IWE."""
    from evflow_torch.eval import evaluate
    from evflow_torch.registry import build_model
    from evflow_torch.weights import load_checkpoint

    cfg = dict(ws["cfg"], loader=dict(ws["cfg"]["loader"], keep_gt_full_res=False))
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(load_checkpoint(ws["pth"]))
    (r1, f1), (r3, f3) = (evaluate(cfg, model=model, device="cpu", debug=True,
                                   collect_vis=True, chunk=k) for k in (1, 3))
    assert r1 == r3 and len(f1) == len(f3) == 6
    for a, b in zip(f1, f3):
        assert a["flow"].shape == (1, 16, 16, 2) and np.array_equal(a["flow"], b["flow"])
        assert np.array_equal(a["event_cnt"], b["event_cnt"])
        assert np.array_equal(a["iwe"], b["iwe"]) and a["iwe"].sum() > 0
