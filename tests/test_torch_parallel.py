"""Data parallelism over ``torch.distributed`` ranks
(``evflow_torch.parallel.mesh``) with 2 gloo ranks on the CPU, spawned once
for the file: the data-parallel TBPTT step, each rank on its slot of one
loss window, against the reference's ``evflow.train.make_train_step`` on
the whole batch at the train bars (loss rtol 1e-5; gradients rtol 5e-4,
atol 5e-7; no membrane within 1e-5 of its threshold), with the norms'
running statistics, the gradients summed (not averaged) and the parameters
bit-equal across the ranks; ``evaluate`` per window and in chunks of 4
with ``device_metrics`` against the port's single process (1e-6
relative) and the reference's ``evaluate`` (tests/test_torch_eval.py's
bar); a mesh of one joining a process group; the refusals; the eval CLI
over 2 ranks (the train CLI's run is in
tests/test_torch_train_loop.py); and the new modules' imports."""

import ast
import os
import threading

import numpy as np
import pytest
import torch
import yaml

import _torch_train as T
from _torch_port import eval_config, one_torch_thread, seeded_flax_firenet  # noqa: F401
from evflow.eval import evaluate as jax_evaluate
from evflow_torch.config import load_config
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.eval import evaluate
from evflow_torch.parallel.mesh import (Mesh, _free_port, check_mesh, launch, make_mesh,
                                        pad_batch_to_devices, rank_config)
from evflow_torch.probes.parallel import jobs_rank, step_rank
from evflow_torch.weights import from_jax_variables

EVAL_MODES = {"window": {}, "chunk4_dm": dict(chunk=4, device_metrics=True)}
STEP_CASE = ("LIFFireNet_short", 1, 3)  # test_torch_train_step.py's: model, weight seed, skip


def numpy_state(variables):
    return {k: v.numpy() for k, v in from_jax_variables(variables).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both workloads, and what 2 gloo ranks made of them (one launch)."""
    tmp = tmp_path_factory.mktemp("dp")
    name, seed, skip = STEP_CASE
    tcfg = T.train_config(T.make_data(tmp / "train"), name=name)
    tvars = T.seeded(tcfg, seed)
    window = T.loss_window(tcfg, skip)
    make_dataset(str(tmp / "eval"), num_sequences=2, resolution=(32, 32),
                 events_per_sec=30000, duration=0.6, flows=[(12.0, -6.0), (-8.0, 4.0)])
    ecfg = eval_config(str(tmp / "eval"), res=16, std=32)
    ecfg["loader"]["batch_size"] = 2
    evars = seeded_flax_firenet(ecfg["model"], seed=11)[1]
    jobs = [("step", tcfg, numpy_state(tvars), window)]
    jobs += [("eval", ecfg, numpy_state(evars), kw) for kw in EVAL_MODES.values()]
    box = {}

    def run_ranks():
        try:
            box["ranks"] = launch(jobs_rank, 2, "cpu", args=(jobs,))
        except BaseException as e:  # re-raised below
            box["error"] = e

    ranks_thread = threading.Thread(target=run_ranks)
    ranks_thread.start()  # the ranks run while the reference computes
    try:
        ref_step = T.jax_step(tcfg, tvars, window)
        ref_eval = jax_evaluate(ecfg, variables=evars, debug=True, verbose=False)
        single_loss, _, single_grads, _ = T.port_step(tcfg, tvars, window)
    finally:
        ranks_thread.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    return {"tcfg": tcfg, "tvars": tvars, "window": window, "ecfg": ecfg, "evars": evars,
            "ref_step": ref_step, "ref_eval": ref_eval, "steps": [r[0] for r in ranks],
            "single_step": (single_loss, {k: g.numpy() for k, g in single_grads.items()}),
            "evals": {m: [r[i]["results"] for r in ranks] for i, m in enumerate(EVAL_MODES, 1)},
            "windows": {m: [r[i]["windows"] for r in ranks] for i, m in enumerate(EVAL_MODES, 1)},
            "tmp": tmp}


def test_dp_step_matches_reference_whole_batch(setup):
    """The ranks' global loss and summed gradients equal the reference step
    on the whole batch; the parameters and the BatchNorm running statistics
    after the step (moments of the global batch) too."""
    cfg, v = setup["tcfg"], setup["tvars"]
    jloss, jvars, jgrads = setup["ref_step"]
    got = setup["steps"][0]
    T.check_margins([r["margin"] for r in setup["steps"]])
    np.testing.assert_allclose(got["loss"], jloss, rtol=T.LOSS_RTOL)
    T.assert_grads_match({k: torch.from_numpy(g) for k, g in got["grads"].items()}, jgrads, v)
    model = T.port_model(cfg, v)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in got["state"].items()})
    T.assert_step_matches(model, cfg, v, jvars, jgrads)  # running statistics within 1e-5
    ref = T.in_port_layout(jvars)
    for key in (k for k in got["state"] if k.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(got["state"][key], ref[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_dp_step_sums_the_gradients_over_the_ranks(setup):
    """The reduction is a sum: the ranks' gradients are the single process's
    gradients of the summed loss on both slots (a mean would halve them),
    and the loss is the global one."""
    loss, grads = setup["single_step"]
    got = setup["steps"][0]
    np.testing.assert_allclose(got["loss"], loss, rtol=T.LOSS_RTOL)
    for name, g in grads.items():
        np.testing.assert_allclose(got["grads"][name], g, **T.GRAD_TOL, err_msg=name)


def test_one_rank_mesh_with_an_address_runs_the_collectives(setup, monkeypatch):
    """A mesh of one given an address (as ``launch`` gives every rank; one
    card runs NCCL so) joins a process group of one: the step's norm and
    gradient all-reduces run over it, and it equals the single process's
    step at the train bars."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    mesh = make_mesh(1, "cpu", init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        assert mesh.distributed and mesh.group is not None
        got = step_rank(mesh, setup["tcfg"], numpy_state(setup["tvars"]), setup["window"])
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()
    loss, grads = setup["single_step"]
    np.testing.assert_allclose(got["loss"], loss, rtol=T.LOSS_RTOL)
    for name, g in grads.items():
        np.testing.assert_allclose(got["grads"][name], g, **T.GRAD_TOL, err_msg=name)
    assert not make_mesh(1, "cpu").distributed  # no address: the single-process path


def test_dp_step_keeps_the_ranks_bit_equal(setup):
    a, b = setup["steps"]
    assert a["loss"] == b["loss"]
    assert set(a["state"]) == set(b["state"])
    for key, arr in a["state"].items():
        np.testing.assert_array_equal(arr, b["state"][key], err_msg=key)


@pytest.mark.parametrize("mode", list(EVAL_MODES))
def test_dp_evaluate_matches_single_process(setup, mode):
    """Every rank returns the merged per-file metrics, within 1e-6 relative
    of one process over both slots; the windows are counted over the ranks."""
    stats = {}
    single = evaluate(setup["ecfg"], variables=setup["evars"], device="cpu", debug=True,
                      stats=stats, **EVAL_MODES[mode])
    r0, r1 = setup["evals"][mode]
    assert r0 == r1 and set(r0) == set(single) and len(single["AEE"]) == 2
    for metric, per_file in single.items():
        assert set(r0[metric]) == set(per_file)
        for fname, value in per_file.items():
            np.testing.assert_allclose(float(r0[metric][fname]), float(value), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{metric} {fname}")
    assert setup["windows"][mode] == [stats["windows"]] * 2


def test_dp_evaluate_matches_reference(setup):
    """The ranks' per-window results against the reference's ``evaluate`` of
    the whole batch, at tests/test_torch_eval.py's unfused bar."""
    ref = setup["ref_eval"]
    got = setup["evals"]["window"][0]
    assert set(got) == set(ref)
    for metric, per_file in ref.items():
        assert set(got[metric]) == set(per_file), metric
        for fname, value in per_file.items():
            np.testing.assert_allclose(float(got[metric][fname]), float(value), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{metric} {fname}")


def test_mesh_refusals_before_any_file_opens(setup, tmp_path):
    """Fused with a mesh, a batch the mesh does not divide, and too few
    cards for NCCL raise before a file opens or a rank starts."""
    mesh = Mesh(2, 0, torch.device("cpu"), "gloo")  # refused before any collective
    cfg = dict(setup["ecfg"], data=dict(setup["ecfg"]["data"], path=str(tmp_path / "none")))
    results = tmp_path / "results"
    with pytest.raises(ValueError, match="fused.*mesh|mesh.*fused"):
        evaluate(cfg, fused=True, mesh=mesh, path_results=str(results))
    odd = dict(cfg, loader=dict(cfg["loader"], batch_size=3))
    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        evaluate(odd, mesh=mesh, path_results=str(results))
    tcfg = dict(setup["tcfg"], data=dict(setup["tcfg"]["data"], path=str(tmp_path / "none")),
                loader=dict(setup["tcfg"]["loader"], batch_size=3))
    from evflow_torch.train import train

    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        train(tcfg, path_runs=str(tmp_path / "runs"), mesh=mesh)
    assert not results.exists() and not (tmp_path / "runs").exists()
    for call in (lambda: check_mesh(2, "cuda"), lambda: make_mesh(2, "cuda"),
                 lambda: launch(jobs_rank, 2, "cuda", args=([],))):
        with pytest.raises(ValueError, match="2-device nccl mesh but torch reports 0"):
            call()
    with pytest.raises(ValueError, match="NCCL"):
        check_mesh(2, "cpu", "nccl")
    assert rank_config(setup["ecfg"], Mesh(2, 1, torch.device("cpu"), "gloo"))["loader"] == dict(
        setup["ecfg"]["loader"], batch_size=1, num_shards=2, shard_index=1)
    assert pad_batch_to_devices(5, 2) == 6 and pad_batch_to_devices(4, 2) == 4


def test_eval_cli_over_two_ranks(setup):
    """``eval_flow --num_devices 2 --device cpu``: rank 0's
    ``metrics_0.yml`` equals the in-process ranks' results."""
    from evflow_torch.eval_flow import main

    d = setup["tmp"] / "cli"
    d.mkdir()
    ckpt = d / "seeded.pth"
    torch.save(from_jax_variables(setup["evars"]), ckpt)
    (d / "eval.yml").write_text(yaml.safe_dump(setup["ecfg"]))
    main([str(ckpt), "--config", str(d / "eval.yml"), "--path_results", str(d / "r"),
          "--num_devices", "2", "--device", "cpu"])
    got = yaml.safe_load((d / "r" / "seeded.pth" / "metrics_0.yml").read_text())
    assert got == {"runid": "seeded.pth", **setup["evals"]["window"][0]}
    assert sorted(os.listdir(d / "r" / "seeded.pth")) == ["eval_0.yml", "metrics_0.yml"]
    assert yaml.safe_load((d / "r" / "seeded.pth" / "eval_0.yml").read_text()) == load_config(
        str(d / "eval.yml"))  # the global config, not a rank's shard of it


def imports(path, top_level_only=False):
    """The modules ``path`` imports (at its top level only, if asked)."""
    tree = ast.parse(open(path).read())
    nodes = tree.body if top_level_only else list(ast.walk(tree))
    names = []
    for node in nodes:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names += [node.module] + [f"{node.module}.{a.name}" for a in node.names]
    return names


def test_parallel_modules_import_neither_jax_nor_the_reference():
    """The new modules and ``chip_smoke.py`` import neither JAX nor the
    reference package anywhere, and the loader's import graph holds no
    torch: its worker processes stay light and never touch CUDA."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    new = ["evflow_torch/data/mp_loader.py", "evflow_torch/parallel/__init__.py",
           "evflow_torch/parallel/mesh.py", "evflow_torch/probes/parallel.py",
           "evflow_torch/eval_flow.py", "evflow_torch/train_flow.py", "chip_smoke.py"]
    for path in new:
        bad = [m for m in imports(os.path.join(root, path))
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "evflow")]
        assert not bad, (path, bad)
    seen, todo = set(), ["evflow_torch.data.mp_loader"]
    while todo:  # the modules a worker imports: top-level imports, followed
        mod = todo.pop()
        base = os.path.join(root, *mod.split("."))
        path = base + ".py" if os.path.exists(base + ".py") else os.path.join(base, "__init__.py")
        if mod in seen or not os.path.exists(path):  # a name, not a module
            continue
        seen.add(mod)
        for m in imports(path, top_level_only=True) + [mod.rsplit(".", 1)[0]] * ("." in mod):
            assert m.split(".")[0] not in ("torch", "jax", "evflow"), (mod, m)
            if m.startswith("evflow_torch"):
                todo.append(m)
    assert {"evflow_torch", "evflow_torch.data.h5_stream", "evflow_torch.data.encodings"} <= seen
