"""The port's eval CLI (``python -m evflow_torch.eval_flow``) against the
reference package's ``evaluate``: seeded port weights saved as a ``.pth``,
read by both, and the results files each writes."""

import numpy as np
import pytest
import torch
import yaml

from _torch_port import eval_config
from evflow.config import load_config as jax_load_config
from evflow.eval import evaluate as jax_evaluate
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.eval_flow import main
from evflow_torch.registry import build_model
from evflow_torch.weights import seeded_state_dict


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    make_dataset(str(root / "data"), num_sequences=2, resolution=(32, 32),
                 events_per_sec=30000, duration=0.6, flows=[(12.0, -6.0), (-8.0, 4.0)])
    cfg = eval_config(str(root / "data"), res=16, std=32)
    cfg_path = root / "eval.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(seeded_state_dict(model, seed=5))
    ckpt = root / "seeded.pth"
    torch.save(model.state_dict(), ckpt)
    return {"root": root, "cfg": str(cfg_path), "ckpt": str(ckpt)}


def read(path):
    with open(path) as f:
        return yaml.safe_load(f)


def test_cli_results_files_match_reference(workspace, tmp_path, capsys):
    """eval_0.yml equal, metrics_0.yml within 1e-4; a second run writes
    the files numbered 1; the per-file lines are printed."""
    ckpt, cfg = workspace["ckpt"], workspace["cfg"]
    jax_evaluate(jax_load_config(cfg), checkpoint=ckpt, path_results=str(tmp_path / "ref"),
                 runid="seeded.pth", verbose=False)
    args = [ckpt, "--config", cfg, "--path_results", str(tmp_path / "port"), "--device", "cpu"]
    ours = main(args + ["--chunk", "4", "--device_metrics"])
    out = capsys.readouterr().out
    assert any(line.split()[:1] == ["AEE"] and ours["AEE"][line.split()[1]] == line.split()[2]
               for line in out.splitlines())
    ref_dir, port_dir = tmp_path / "ref" / "seeded.pth", tmp_path / "port" / "seeded.pth"
    assert read(port_dir / "eval_0.yml") == read(ref_dir / "eval_0.yml")
    ref, port = read(ref_dir / "metrics_0.yml"), read(port_dir / "metrics_0.yml")
    assert port.pop("runid") == ref.pop("runid") == "seeded.pth"
    assert set(port) == set(ref) == {"AEE", "AEE_percent", "AAE", "AAE_percent", "AE_ofMeans"}
    for metric, per_file in ref.items():
        assert set(port[metric]) == set(per_file) and len(per_file) == 2
        for fname, value in per_file.items():
            np.testing.assert_allclose(float(port[metric][fname]), float(value), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{metric} {fname}")
    main(args)
    assert read(port_dir / "metrics_1.yml") == read(port_dir / "metrics_0.yml")
    assert read(port_dir / "eval_1.yml") == read(port_dir / "eval_0.yml")


def test_cli_debug_writes_nothing(workspace, tmp_path):
    main([workspace["ckpt"], "--config", workspace["cfg"], "--path_results", str(tmp_path / "r"),
          "--device", "cpu", "--debug", "--max_windows", "2"])
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("extra,error,match", [
    (["--num_devices", "2"], ValueError, "batch_size 1 must be divisible by the mesh size 2"),
    (["--profile", "trace"], NotImplementedError, "queue 1 item 10"),
])
def test_cli_refuses_what_is_not_ported(workspace, tmp_path, extra, error, match):
    """``--profile`` is not ported; ``--num_devices`` that does not divide
    the batch raises before any rank starts or any file is written."""
    with pytest.raises(error, match=match):
        main([workspace["ckpt"], "--config", workspace["cfg"], "--device", "cpu",
              "--path_results", str(tmp_path / "r"), *extra])
    assert not (tmp_path / "r").exists()


def test_cli_refuses_a_run_id(workspace, tmp_path):
    """A name that is no file but a port training run under --path_runs
    resolves to the run's newest ``lowest_loss`` checkpoint (the same
    results as the file itself, written under the run id); a run without
    one, and any other missing name, raise ``FileNotFoundError``."""
    runs = tmp_path / "runs" / "Default"
    (runs / "empty1").mkdir(parents=True)
    (runs / "empty1" / "params.yaml").write_text(yaml.safe_dump(read(workspace["cfg"])))
    for epoch in (3, 12):
        ckpt_dir = runs / "abc123" / "checkpoints" / "lowest_loss" / str(epoch)
        ckpt_dir.mkdir(parents=True)
        sd = torch.load(workspace["ckpt"]) if epoch == 12 else {}
        torch.save({"model_state_dict": sd, "epoch": epoch}, ckpt_dir / "model.pth")
    (runs / "abc123" / "params.yaml").write_text(yaml.safe_dump(read(workspace["cfg"])))
    base = ["--config", workspace["cfg"], "--device", "cpu", "--path_runs",
            str(tmp_path / "runs"), "--path_results", str(tmp_path / "r"), "--max_windows", "3"]
    with pytest.raises(FileNotFoundError, match="lowest_loss"):
        main(["empty1", *base])
    with pytest.raises(FileNotFoundError):
        main(["nothing.pth", *base])
    assert not (tmp_path / "r").exists()
    by_run = main(["abc123", *base])
    assert read(tmp_path / "r" / "abc123" / "metrics_0.yml")["runid"] == "abc123"
    assert by_run == main([workspace["ckpt"], *base])


def test_cli_runs_on_the_card_unless_asked(workspace, tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLI asks for the card, and without CUDA
    it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([workspace["ckpt"], "--config", workspace["cfg"], "--debug",
              "--path_results", str(tmp_path)])
