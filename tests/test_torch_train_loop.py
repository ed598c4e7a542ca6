"""The port's trainer (``evflow_torch.train.train``) and its two CLIs on the
CPU, on the port's synthetic data: the run directory, the checkpoints the
policies write, resuming, ``train_flow`` and ``train_flow_validation``
through ``main(argv)``, the eval CLI on the run id, a port checkpoint read
by the reference package's ``import_torch_checkpoint`` (equal flows), the
refusals, and the package importing neither JAX nor the reference."""

import copy
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import _torch_train as T
from evflow_torch.train import TrainStep, train
from evflow_torch.utils.checkpoint import CheckpointPolicy, load_training_checkpoint

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer")
    root = T.make_data(d / "data", duration=0.2)
    cfg = T.train_config(root)
    cfg["loader"]["n_epochs"] = 2
    cfg["vis"].update(store_grads=True, store_hists=True, hist_every=10)
    stats = {}
    run = train(cfg, path_runs=str(d / "runs"), device="cpu", stats=stats, verbose=False)
    return {"dir": d, "data": root, "cfg": cfg, "run": run, "stats": stats}


def metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_the_run(workspace):
    """Two epochs: the params, each epoch's loss (the mean of its steps'
    losses) and variance, the policies' checkpoints (in the reference's
    ``.pth`` form, on the CPU) with their configs, the gradient CSV and the
    histograms."""
    run, cfg, stats = workspace["run"], workspace["cfg"], workspace["stats"]
    with open(os.path.join(run.dir, "params.yaml")) as f:
        assert yaml.safe_load(f) == cfg
    assert stats["steps"] == len(stats["losses"]) > 10
    assert np.isfinite(stats["losses"]).all()
    rows = metrics(run.dir)
    assert [(r["name"], r["step"]) for r in rows] == [
        ("loss", 0), ("loss_variance", 0), ("loss", 1), ("loss_variance", 1)]
    assert min(stats["losses"]) <= rows[0]["value"] <= max(stats["losses"])
    ck = os.path.join(run.dir, "checkpoints")
    assert os.listdir(os.path.join(ck, "most_recent")) == ["1"]
    assert len(os.listdir(os.path.join(ck, "lowest_loss"))) == 1
    state = load_training_checkpoint(os.path.join(ck, "most_recent", "1"))
    assert set(state) == {"model_state_dict", "optimizer_state_dict", "epoch", "loss",
                          "loss_variance"}
    assert state["epoch"] == 1 and state["loss"] == pytest.approx(rows[2]["value"])
    assert all(t.device.type == "cpu" for t in state["model_state_dict"].values())
    assert "G1.lif.threshold" in state["model_state_dict"]
    assert os.path.exists(os.path.join(ck, "most_recent", "1", "config.yaml"))
    with open(os.path.join(run.dir, "grads_w.csv")) as f:
        header = f.readline()
    assert "head.ff.weight/mean" in header
    groups = {json.loads(line)["group"] for line in open(os.path.join(run.dir, "histograms.jsonl"))}
    assert groups == {"weights", "lif", "quant_scales", "grads"}
    assert os.path.exists(os.path.join(run.dir, "artifacts", "train_diff.txt"))


def test_thresholds_stay_clamped(workspace):
    state = load_training_checkpoint(os.path.join(workspace["run"].dir, "checkpoints",
                                                  "most_recent", "1"))
    thr = [t for k, t in state["model_state_dict"].items() if k.endswith("lif.threshold")]
    assert min(float(t.min()) for t in thr) >= 0.01


def test_resume_restores_weights_stats_and_optimizer(workspace, monkeypatch, tmp_path):
    """``prev_ckpt`` puts the checkpoint's weights, running statistics and
    Adam moments in place before the first step."""
    seen = {}
    real = TrainStep.__call__

    def first(self, states, window):
        if not seen:
            seen["model"] = {k: v.clone() for k, v in self.model.state_dict().items()}
            seen["opt"] = copy.deepcopy(self.optimizer.state_dict())
        return real(self, states, window)

    monkeypatch.setattr(TrainStep, "__call__", first)
    ckpt = os.path.join(workspace["run"].dir, "checkpoints", "most_recent", "1")
    train(workspace["cfg"], path_runs=str(tmp_path), prev_ckpt=ckpt, max_steps=1,
          device="cpu", verbose=False)
    state = load_training_checkpoint(ckpt)
    for k, v in state["model_state_dict"].items():
        assert torch.equal(seen["model"][k], v), k
    saved, got = state["optimizer_state_dict"]["state"], seen["opt"]["state"]
    assert saved.keys() == got.keys() and len(saved) > 0
    for i in saved:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][k], saved[i][k])


def test_smoothest_loss_needs_history(tmp_path):
    """``smoothest_loss`` waits for more than 10 losses of history, then
    follows the lowest variance; ``lowest_loss`` needs an improvement over
    1e-6; each policy keeps one directory."""
    policy = CheckpointPolicy(str(tmp_path))
    state = {"model_state_dict": {"w": torch.ones(2)}}
    w = policy.update(0, 1.0, 0.5, 10, state)
    assert w == {"lowest_loss": True, "smoothest_loss": False, "most_recent": True}
    w = policy.update(1, 1.0 - 1e-7, 0.4, 11, state)
    assert w == {"lowest_loss": False, "smoothest_loss": True, "most_recent": True}
    w = policy.update(2, 0.5, 0.6, 12, state)
    assert w == {"lowest_loss": True, "smoothest_loss": False, "most_recent": True}
    assert {k: os.listdir(tmp_path / k) for k in w} == {
        "lowest_loss": ["2"], "smoothest_loss": ["1"], "most_recent": ["2"]}
    assert load_training_checkpoint(str(tmp_path / "smoothest_loss" / "1"))["loss_variance"] == 0.4


def write_yaml(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_flow_cli(workspace, tmp_path, capsys):
    from evflow_torch.train_flow import main

    cfg = dict(workspace["cfg"], loader=dict(workspace["cfg"]["loader"], n_epochs=1),
               vis={"verbose": False})
    path = write_yaml(tmp_path / "train.yml", cfg)
    run = main(["--config", path, "--path_runs", str(tmp_path / "runs"), "--device", "cpu"])
    assert f"Run dir: {run.dir}" in capsys.readouterr().out
    assert os.listdir(os.path.join(run.dir, "checkpoints", "lowest_loss")) == ["0"]
    resumed = main(["--config", path, "--path_runs", str(tmp_path / "runs"), "--device", "cpu",
                    "--max_steps", "2", "--prev_runid",
                    os.path.join(run.dir, "checkpoints", "lowest_loss", "0")])
    assert resumed.dir != run.dir


@pytest.mark.parametrize("extra,error,match", [
    (["--num_devices", "3"], ValueError, "batch_size 8 must be divisible by the mesh size 3"),
    (["--profile", "trace"], NotImplementedError, "queue 1 item 10")])
def test_train_flow_refuses_what_is_not_ported(workspace, tmp_path, extra, error, match):
    """``--profile`` is not ported; ``--num_devices`` that does not divide
    the batch raises (the reference would train on one device instead)."""
    from evflow_torch.train_flow import main

    with pytest.raises(error, match=match):
        main(["--config", "configs/train_SNN.yml", "--device", "cpu",
              "--path_runs", str(tmp_path / "runs"), *extra])
    assert not (tmp_path / "runs").exists()


def test_train_flow_over_two_ranks(workspace, tmp_path, capsys):
    """``--num_devices 2 --device cpu``: two gloo ranks train on their
    shards; rank 0 writes the one run directory, whose path every rank
    returns."""
    from evflow_torch.train_flow import main

    path = write_yaml(tmp_path / "train.yml", workspace["cfg"])
    run = main(["--config", path, "--path_runs", str(tmp_path / "runs"), "--device", "cpu",
                "--num_devices", "2", "--max_steps", "2"])
    assert f"Run dir: {run.dir}" in capsys.readouterr().out
    assert os.listdir(tmp_path / "runs" / "test") == [run.runid]
    with open(os.path.join(run.dir, "params.yaml")) as f:
        params = yaml.safe_load(f)  # the global config, not a rank's shard of it
    assert params["loader"]["batch_size"] == 2 and "num_shards" not in params["loader"]


def test_train_runs_on_the_card_unless_asked(workspace, tmp_path, monkeypatch):
    from evflow_torch.train_flow import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = write_yaml(tmp_path / "train.yml", workspace["cfg"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", path, "--path_runs", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


def val_config(data):
    return {"data": {"path": data, "mode": "gtflow_dt1", "window": 1},
            "loader": {"resolution": [T.H, T.W], "batch_size": 1, "augment": [], "seed": 0},
            "metrics": {"name": ["AEE", "AAE"], "flow_scaling": 16, "heat_map": False},
            "hot_filter": {"enabled": False}, "vis": {"enabled": False, "store": False}}


def test_train_flow_validation_cli(workspace, tmp_path, capsys):
    """Validation every epoch inside the run, logged as ``val_AAE`` and
    ``val_AEE``; the best keeps one ``best_val_aae`` checkpoint with the
    optimizer state."""
    from evflow_torch.train_flow_validation import main

    cfg = dict(workspace["cfg"], loader=dict(workspace["cfg"]["loader"], n_epochs=2))
    run, best = main(["--config", write_yaml(tmp_path / "train.yml", cfg),
                      "--val_config", write_yaml(tmp_path / "val.yml", val_config(
                          workspace["data"])),
                      "--path_runs", str(tmp_path / "runs"), "--val_every", "1",
                      "--val_max_windows", "3", "--device", "cpu"])
    names = [r["name"] for r in metrics(run.dir)]
    assert names.count("val_AAE") == 2 and names.count("val_AEE") == 2
    kept = os.listdir(os.path.join(run.dir, "checkpoints", "best_val_aae"))
    assert len(kept) == 1 and np.isfinite(best["val_aae"])
    state = load_training_checkpoint(os.path.join(run.dir, "checkpoints", "best_val_aae", kept[0]))
    assert state["optimizer_state_dict"]["state"]
    assert "best val AAE" in capsys.readouterr().out


def test_eval_cli_reads_the_run(workspace, tmp_path):
    """``eval_flow <runid> --path_runs`` takes the run's model (the config
    has none) and its lowest_loss checkpoint."""
    from evflow_torch.eval_flow import main

    path = write_yaml(tmp_path / "val.yml", val_config(workspace["data"]))
    run = workspace["run"]
    runs_root = os.path.dirname(os.path.dirname(run.dir))
    res = main([run.runid, "--config", path, "--path_runs", runs_root, "--device", "cpu",
                "--path_results", str(tmp_path / "r"), "--max_windows", "3"])
    ckpt_dir = os.path.join(run.dir, "checkpoints", "lowest_loss")
    ckpt = os.path.join(ckpt_dir, os.listdir(ckpt_dir)[0], "model.pth")
    with_model = write_yaml(tmp_path / "val_model.yml", dict(
        val_config(workspace["data"]), model=workspace["cfg"]["model"]))
    direct = main([ckpt, "--config", with_model, "--device", "cpu", "--debug",
                   "--max_windows", "3"])
    assert res == direct and set(res) >= {"AEE", "AAE"}
    with open(tmp_path / "r" / run.runid / "eval_0.yml") as f:
        assert yaml.safe_load(f)["model"]["name"] == "LIFFireNet_short"


def test_port_checkpoint_loads_into_the_reference(workspace):
    """The reference package's ``import_torch_checkpoint`` reads a port
    checkpoint completely, and its FireNet then gives the port's flows."""
    from evflow.registry import build_model as jax_build
    from evflow.utils.checkpoint import import_torch_checkpoint
    from evflow_torch.registry import build_model

    ckpt = os.path.join(workspace["run"].dir, "checkpoints", "most_recent", "1", "model.pth")
    jm = jax_build(workspace["cfg"]["model"])
    states = jm.init_states(T.B, T.H, T.W)
    v = jm.init(jax.random.PRNGKey(0), None, jnp.zeros((T.B, T.H, T.W, 2)), states)
    jv, leftover = import_torch_checkpoint(ckpt, v)
    assert all(k.endswith("num_batches_tracked") for k in leftover)
    tm = build_model(workspace["cfg"]["model"], device="cpu")
    tm.load_state_dict(load_training_checkpoint(ckpt)["model_state_dict"])
    cnt = np.random.default_rng(0).poisson(0.6, (T.B, T.H, T.W, 2)).astype(np.float32)
    tst = tm.init_states(T.B, T.H, T.W)
    for _ in range(2):
        jout, states = jm.apply(jv, None, jnp.asarray(cnt), states)
        with torch.no_grad():
            tout, tst = tm(None, torch.tensor(cnt), tst)
        np.testing.assert_allclose(tout["flow"][0].numpy(), np.asarray(jout["flow"][0]),
                                   atol=1e-5)


def test_num_workers_refused_before_any_file_opens(tmp_path):
    """``loader.num_workers`` outside ``[1, batch_size]`` (the multi-process
    loader's worker count) raises in ``evaluate`` and ``train`` before the
    data, the run directory or the results are touched: the data path does
    not exist."""
    from evflow_torch.eval import evaluate

    cfg = T.train_config(tmp_path / "missing")
    cfg["loader"]["num_workers"] = 3  # B=2
    with pytest.raises(ValueError, match="num_workers must be in"):
        train(cfg, path_runs=str(tmp_path / "runs"), device="cpu")
    assert not (tmp_path / "runs").exists()
    ecfg = val_config(str(tmp_path / "missing"))
    ecfg["loader"]["num_workers"] = 2  # B=1
    ecfg["model"] = cfg["model"]
    with pytest.raises(ValueError, match="num_workers must be in"):
        evaluate(ecfg, device="cpu", path_results=str(tmp_path / "results"))
    assert not (tmp_path / "results").exists()


def test_progress_bar_renders():
    from evflow_torch.utils.progress import ProgressBar

    out = io.StringIO()
    bar = ProgressBar("train", max=4, width=8, stream=out)
    bar.next(2)
    bar.finish()
    text = out.getvalue()
    assert "\rtrain |####----|  50%" in text and text.endswith("\n")


def test_training_modules_import_neither_jax_nor_the_reference():
    """The trainer, its CLIs and the loss import in a process where
    ``jax``, ``flax`` and ``evflow`` cannot be imported."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "evflow"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import evflow_torch.train, evflow_torch.train_flow, evflow_torch.train_flow_validation
import evflow_torch.loss.warp_loss, evflow_torch.utils.checkpoint, evflow_torch.utils.progress
import evflow_torch.eval_flow
assert not any(m.split(".")[0] in ("jax", "flax", "evflow") for m in sys.modules)
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
