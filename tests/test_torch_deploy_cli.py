"""``python -m evflow_torch.eval_flow_quant --mode deploy`` (the int8 serving
engine under the evaluation protocol) on the CPU, on a small synthetic set
with ``configs/eval_MVSEC.yml``'s settings (16x16 pooled from 32x32, so
the engine's input grid is 1/4) and seeded weights: each tier's
``metrics_0.yml`` equal to the same engine evaluated in-process; an
artifact written by ``save_engine`` equal to the engine that wrote it;
a reference package's run (``model.msgpack`` written by
``evflow.utils.checkpoint.save_checkpoint``) read by its run id by
``eval_flow`` and ``eval_flow_quant --mode deploy``, scoring as the same
weights in a ``.pth``; and the serving modules (the UNet's too) importing
neither JAX nor the reference package."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from _torch_port import eval_config, model_cfg, seeded_flax_firenet
from evflow_torch.weights import from_jax_variables

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The evaluation set and config, seeded weights as a ``.pth`` and as a
    reference package's run."""
    from evflow.utils.checkpoint import save_checkpoint
    from evflow_torch.data.synthetic import make_dataset

    d = tmp_path_factory.mktemp("deploy_cli")
    root = str(d / "eval")
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.4, flows=[(12.0, -6.0), (-8.0, 4.0)])
    cfg = eval_config(root, res=16, std=32, metrics=("AEE", "AAE"))
    yml = d / "eval.yml"
    yml.write_text(yaml.safe_dump(cfg))
    _, v = seeded_flax_firenet(model_cfg("LIFFireNet"), seed=1)
    pth = str(d / "seeded.pth")
    torch.save(from_jax_variables(v), pth)
    runs = d / "runs"
    save_checkpoint(str(runs / "reference" / "ref_run" / "checkpoints" / "lowest_loss" / "0"),
                    {"params": v["params"], "batch_stats": v["batch_stats"], "opt_state": None,
                     "epoch": 0, "loss": 0.0, "loss_variance": 0.0})
    (runs / "reference" / "ref_run" / "params.yaml").write_text(yaml.safe_dump(cfg))
    return {"d": d, "cfg": cfg, "yml": str(yml), "pth": pth, "runs": str(runs)}


def metrics_file(out, sub="quant_deploy"):
    with open(os.path.join(out, sub, "metrics_0.yml")) as f:
        got = yaml.safe_load(f)
    got.pop("runid")
    return got


@pytest.mark.parametrize("tier,z_int8", [("bfloat16", False), ("int8", False), ("mixed", True)])
def test_deploy_cli_equals_in_process(ws, tmp_path, capsys, tier, z_int8):
    """Per tier (``mixed`` with ``--z_int8``), ``--chunk 4
    --device_metrics``: the CLI's ``metrics_0.yml`` equals the same engine
    evaluated in-process per window; the report names the tier."""
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow_quant import deploy_engine, main
    from evflow_torch.weights import load_checkpoint

    out = str(tmp_path / "res")
    flags = ["--z_int8"] if z_int8 else []
    got = main([ws["pth"], "--config", ws["yml"], "--mode", "deploy", "--mem_dtype", tier,
                "--profile_batches", "3", "--calibration_batches", "3", "--chunk", "4",
                "--device_metrics", "--path_results", out, "--device", "cpu", *flags])
    text = capsys.readouterr().out
    assert f"membranes: {tier}" in text and "input scale: 0.25" in text
    assert ("calibrated int8" in text) == z_int8
    engine = deploy_engine(ws["cfg"], load_checkpoint(ws["pth"]), mem_dtype=tier, z_int8=z_int8,
                           calibration_batches=3, profile_batches=3, device="cpu")
    ref = evaluate(ws["cfg"], model=engine, device="cpu", debug=True)
    assert got == ref == metrics_file(out)
    assert set(ref) == {"AEE", "AAE", "AEE_percent", "AAE_percent"}


def test_deploy_cli_artifact(ws, tmp_path):
    """``--artifact``: a ``save_engine`` file evaluates as the engine that
    wrote it; no checkpoint, tier or z flag may come with it."""
    from evflow_torch.deploy import save_engine
    from evflow_torch.eval import evaluate
    from evflow_torch.eval_flow_quant import deploy_engine, main
    from evflow_torch.weights import load_checkpoint

    engine = deploy_engine(ws["cfg"], load_checkpoint(ws["pth"]), mem_dtype="int8",
                           z_int8=True, calibration_batches=3, profile_batches=3, device="cpu")
    art = save_engine(engine, str(tmp_path / "engine.npz"))
    out = str(tmp_path / "res")
    got = main(["--config", ws["yml"], "--mode", "deploy", "--artifact", art, "--chunk", "4",
                "--path_results", out, "--device", "cpu"])
    assert got == evaluate(ws["cfg"], model=engine, device="cpu", debug=True) == metrics_file(out)
    for flags in ([ws["pth"]], ["--mem_dtype", "int8"], ["--z_int8"]):
        with pytest.raises(SystemExit):
            main(["--config", ws["yml"], "--mode", "deploy", "--artifact", art, *flags])


def test_reference_run_by_its_id(ws, tmp_path):
    """A reference package's run id: ``eval_flow`` scores it as the same
    weights in a ``.pth``, and so does ``eval_flow_quant --mode deploy``."""
    from evflow_torch.eval_flow import main as eval_main
    from evflow_torch.eval_flow_quant import main as quant_main

    common = ["--config", ws["yml"], "--path_runs", ws["runs"], "--device", "cpu", "--debug"]
    assert eval_main(["ref_run", *common]) == eval_main([ws["pth"], *common])
    deploy = ["--mode", "deploy", "--mem_dtype", "mixed", "--profile_batches", "3"]
    assert quant_main(["ref_run", *common, *deploy]) == quant_main([ws["pth"], *common, *deploy])


def test_deploy_modules_import_neither_jax_nor_the_reference():
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "evflow", "msgpack"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import evflow_torch.deploy, evflow_torch.bench, evflow_torch.export, evflow_torch.ops.dypack
import evflow_torch.utils.msgpack, evflow_torch.probes.deploy_step, evflow_torch.eval_flow_quant
import evflow_torch.models.unet, evflow_torch.deploy_unet, evflow_torch.bench_unet
import evflow_torch.probes.unet_step
assert not any(m.split(".")[0] in ("jax", "flax", "evflow", "msgpack") for m in sys.modules)
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
