"""The port's two quantization CLIs on the CPU, on a tiny synthetic set:
``evflow_torch.train_flow_quant`` (QAT from an FP32 run: static
calibration from its run id, dynamic ``--conv_only`` from a ``.pth`` in
the reference's form)
and ``evflow_torch.eval_flow_quant`` in each mode (``ptq`` with
``--auto_tune_lif`` in chunks with the metrics on the device, equal to the
same run in-process; ``hybrid``, ``mixed`` and ``full_qat`` on the QAT
run's id), the UNet engine's flags and misused deploy flags refused before
any file opens, and the modules importing neither JAX nor the reference
(``--mode deploy`` itself: ``tests/test_torch_deploy_cli.py``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import _torch_train as T
from _torch_port import eval_config
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.train import train
from evflow_torch.utils.checkpoint import load_training_checkpoint

ROOT = Path(__file__).resolve().parents[1]


def write_yaml(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """An FP32 run (one epoch of LIFFireNet_short, 8 channels) and the
    evaluation config of its model on a small GT-flow set."""
    d = tmp_path_factory.mktemp("qcli")
    cfg = T.train_config(T.make_data(d / "data", duration=0.2))
    cfg["loader"]["n_epochs"] = 1
    runs = str(d / "runs")
    run = train(cfg, path_runs=runs, device="cpu", verbose=False)
    ckpt = os.path.join(run.dir, "checkpoints", "lowest_loss", "0", "model.pth")
    eroot = str(d / "eval")
    make_dataset(eroot, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.4, flows=[(12.0, -6.0), (-8.0, 4.0)])
    ecfg = eval_config(eroot, res=16, std=32, metrics=("AEE", "AAE"))
    ecfg["model"] = dict(cfg["model"])
    return {"d": d, "cfg": cfg, "train_yml": write_yaml(d / "train.yml", cfg),
            "eval_yml": write_yaml(d / "eval.yml", ecfg), "ecfg": ecfg, "runs": runs,
            "fp32": run, "fp32_ckpt": ckpt}


@pytest.fixture(scope="module")
def qat_run(ws):
    """``train_flow_quant --prev_runid <FP32 run id> --calibration static``."""
    from evflow_torch.train_flow_quant import main

    return main(["--config", ws["train_yml"], "--path_runs", ws["runs"], "--prev_runid",
                 ws["fp32"].runid, "--calibration", "static", "--calibration_batches", "3",
                 "--device", "cpu"])


def test_train_flow_quant_static_from_a_run_id(ws, qat_run):
    """The run trains the QAT graph from the FP32 run's checkpoint: its
    params hold the quantization and the 12 calibrated scales, a
    checkpoint and the int8-scale histograms are written."""
    with open(os.path.join(qat_run.dir, "params.yaml")) as f:
        q = yaml.safe_load(f)["model"]["quantization"]
    assert q["enabled"] is True and len(q["static_scales"]) == 12
    assert all(s > 0 for s in q["static_scales"].values())
    assert os.listdir(os.path.join(qat_run.dir, "checkpoints", "lowest_loss")) == ["0"]
    with open(os.path.join(qat_run.dir, "histograms.jsonl")) as f:
        assert "quant_scales" in {json.loads(line)["group"] for line in f}


def test_train_flow_quant_conv_only_from_a_pth(ws, tmp_path, capsys):
    """``--conv_only`` (dynamic scales) from a ``.pth`` in the reference's
    form (a bare state dict: no optimizer state) runs its steps."""
    from evflow_torch.train_flow_quant import main

    bare = str(tmp_path / "fp32.pth")
    torch.save(load_training_checkpoint(ws["fp32_ckpt"])["model_state_dict"], bare)
    run = main(["--config", ws["train_yml"], "--path_runs", str(tmp_path), "--prev_runid",
                bare, "--conv_only", "--max_steps", "2", "--device", "cpu"])
    assert f"Run dir: {run.dir}" in capsys.readouterr().out
    with open(os.path.join(run.dir, "params.yaml")) as f:
        q = yaml.safe_load(f)["model"]["quantization"]
    assert q == {"enabled": True, "Conv_only": True}
    with pytest.raises(SystemExit, match="prev_runid"):
        main(["--config", ws["train_yml"], "--calibration", "static", "--device", "cpu"])


def results_file(d, mode):
    with open(os.path.join(d, f"quant_{mode}", "metrics_0.yml")) as f:
        out = yaml.safe_load(f)
    out.pop("runid")
    return out


def test_eval_flow_quant_ptq_equals_in_process(ws, tmp_path, capsys):
    """``--mode ptq --auto_tune_lif --chunk 4 --device_metrics`` on the
    FP32 ``.pth``: its ``metrics_0.yml`` equals the same calibration and
    evaluation run in-process; the report names the quantization."""
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow_quant import main, quantized_model
    from evflow_torch.weights import load_checkpoint

    out = str(tmp_path / "res")
    got = main([ws["fp32_ckpt"], "--config", ws["eval_yml"], "--mode", "ptq", "--auto_tune_lif",
                "--calibration_batches", "3", "--profile_batches", "3", "--chunk", "4",
                "--device_metrics", "--path_results", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "int8 static per-layer" in text and "per-layer auto-tuned" in text
    model = quantized_model(ws["ecfg"], load_checkpoint(ws["fp32_ckpt"]), "ptq",
                            calibration_batches=3, auto_tune_lif=True, profile_batches=3,
                            device="cpu")
    ref = evaluate(ws["ecfg"], model=model, device="cpu", debug=True, chunk=4,
                   device_metrics=True)
    assert got == ref == results_file(out, "ptq")
    assert np.isfinite([float(v) for m in ref.values() for v in m.values()]).all()


@pytest.mark.parametrize("mode,conv,mem", [
    ("hybrid", "disabled", "per-layer"), ("mixed", "int8 static", "int8 uniform"),
    ("full_qat", "int8 static", "int8 uniform")])
def test_eval_flow_quant_modes_on_the_qat_run(ws, qat_run, tmp_path, capsys, mode, conv, mem):
    """The QAT run's id: its params' model (static QAT scales) under each
    mode's quantization; ``metrics_0.yml`` written and finite."""
    from evflow_torch.eval_flow_quant import main

    out = str(tmp_path / "res")
    main([qat_run.runid, "--config", write_yaml(tmp_path / "e.yml", dict(
        ws["ecfg"], model={})), "--path_runs", ws["runs"], "--mode", mode,
          "--calibration_batches", "2", "--profile_batches", "2", "--auto_tune_lif",
          "--path_results", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"conv fake-quant: {conv}" in text and f"membrane quant: {mem}" in text
    res = results_file(out, mode)
    assert set(res) == {"AEE", "AAE", "AEE_percent", "AAE_percent"}
    assert np.isfinite([float(v) for m in res.values() for v in m.values()]).all()


@pytest.mark.parametrize("flags,exc,match", [
    (["--mode", "full_qat", "--compute", "int8"], SystemExit, None),
    (["--mode", "deploy", "--artifact", "a.npz"], SystemExit, None),
    (["--compute", "int8"], SystemExit, None),
    (["--phase_decoders"], SystemExit, None),
    (["--mem_dtype", "int8"], SystemExit, None), (["--z_int8"], SystemExit, None)])
def test_eval_flow_quant_refuses_the_deploy_flags(flags, exc, match, tmp_path):
    """The engine flags outside ``--mode deploy`` (the UNet engine's
    ``--compute`` and ``--phase_decoders`` too), and a checkpoint beside
    ``--artifact``, are usage errors; all before any file opens (the
    checkpoint and config do not exist)."""
    from evflow_torch.eval_flow_quant import main

    with pytest.raises(exc, match=match):
        main([str(tmp_path / "none.pth"), "--config", str(tmp_path / "none.yml"), *flags])
    assert not any(tmp_path.iterdir())


def test_qat_checkpoint_keeps_the_fp32_layout(qat_run, ws):
    """The QAT checkpoint is a plain port state dict (the hooks are not
    weights): it loads into the FP32 model."""
    from evflow_torch.registry import build_model

    state = load_training_checkpoint(os.path.join(qat_run.dir, "checkpoints", "lowest_loss",
                                                  "0"))
    build_model(ws["cfg"]["model"], device="cpu").load_state_dict(state["model_state_dict"])
    assert all(t.dtype in (torch.float32, torch.int64)
               for t in state["model_state_dict"].values())


def test_quant_modules_import_neither_jax_nor_the_reference():
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "evflow"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import evflow_torch.train_flow_quant, evflow_torch.eval_flow_quant, evflow_torch.models.summary
import evflow_torch.quant.fake_quant, evflow_torch.quant.calibrate, evflow_torch.quant.qcheckpoint
assert not any(m.split(".")[0] in ("jax", "flax", "evflow") for m in sys.modules)
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
