"""The reference package's msgpack runs in the port, on the CPU: the port's
own msgpack reader and writer (``evflow_torch/utils/msgpack.py``, no
``msgpack`` package) against flax's, ``evflow.utils.checkpoint
.save_checkpoint`` read back array for array and as the same FireNet
function, the optax state (Adam's moments and count, SGD's trace,
RMSprop's ``nu``) as the port optimizer's, a step from it equal to
optax's, and ``train`` resuming from such a checkpoint."""

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import counts, model_cfg, seeded_flax_firenet
from evflow.utils.checkpoint import save_checkpoint
from evflow_torch import registry
from evflow_torch.utils.msgpack import is_flax_checkpoint, packb, read_flax_checkpoint, unpackb
from evflow_torch.weights import from_jax_variables, load_checkpoint


def tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_reader_and_writer_agree_with_flax():
    """Maps, lists, str and bin of every length class, ints and floats of
    every width, nil, bool, complex, numpy arrays (bf16 widened to f32) and
    scalars, and a chunked array, both ways."""
    rng = np.random.default_rng(0)
    tree = {"arrays": {"f32": rng.normal(size=(3, 5)).astype(np.float32),
                       "i8": rng.integers(-128, 127, (7,)).astype(np.int8),
                       "u16": np.arange(70000, dtype=np.uint32), "empty": np.zeros((0, 2))},
            "ints": [0, 1, 127, 128, 255, 65536, 2 ** 40, -1, -32, -33, -200, -2 ** 40],
            "floats": [0.5, -1e300], "none": None, "flags": [True, False],
            "strs": ["", "x" * 31, "y" * 200, "z" * 70000], "nested": [[{}], []],
            "scalar": np.int32(7), "big": {str(i): i for i in range(20)}}
    back = fs.msgpack_restore(packb(tree))
    tree_equal({**tree, "scalar": 7}, {**back, "scalar": int(back["scalar"])})
    assert back["scalar"].dtype == np.int32
    ours = unpackb(fs.msgpack_serialize(tree))
    assert ours["scalar"] == 7 and ours["scalar"].dtype == np.int32
    tree_equal({k: v for k, v in tree.items() if k != "scalar"},
               {k: v for k, v in ours.items() if k != "scalar"})
    assert unpackb(fs.msgpack_serialize({"c": 1 + 2j}))["c"] == 1 + 2j
    bf = jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)
    got = unpackb(fs.msgpack_serialize({"b": np.asarray(bf)}))["b"]
    assert got.dtype == np.float32 and np.array_equal(got, np.asarray(bf, np.float32))
    chunked = fs._chunk(np.arange(10, dtype=np.float32))
    path_tree = {"w": chunked}
    from evflow_torch.utils.msgpack import _unchunk

    assert np.array_equal(_unchunk(unpackb(fs.msgpack_serialize(path_tree)))["w"],
                          np.arange(10, dtype=np.float32))
    for bad in (b"\xc1", b"\x92\x01"):
        with pytest.raises(ValueError):
            unpackb(bad)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A reference package's checkpoint: seeded LIFFireNet variables and an
    Adam state with moments and count of its own."""
    cfg = model_cfg("LIFFireNet")
    jm, v = seeded_flax_firenet(cfg, seed=4)
    tx = optax.adam(1e-3)
    opt = tx.init(v["params"])
    rng = np.random.default_rng(1)
    moment = lambda p: rng.normal(0, 1e-2, np.shape(p)).astype(np.float32)  # noqa: E731
    opt = (opt[0]._replace(count=jnp.asarray(7, jnp.int32),
                           mu=jax.tree.map(moment, v["params"]),
                           nu=jax.tree.map(lambda p: np.abs(moment(p)), v["params"])),) + opt[1:]
    d = str(tmp_path_factory.mktemp("msgpack_run") / "checkpoints" / "lowest_loss" / "3")
    state = {"params": v["params"], "batch_stats": v["batch_stats"], "opt_state": opt,
             "epoch": 3, "loss": 0.25, "loss_variance": 0.01}
    path = save_checkpoint(d, state, {"model": cfg})
    return {"cfg": cfg, "jm": jm, "v": v, "tx": tx, "opt": opt, "dir": d, "path": path,
            "state": state}


def test_save_checkpoint_reads_back(run):
    """Every array of the file equal to flax's state dict of what was
    saved; the weights give the reference's FireNet function."""
    assert is_flax_checkpoint(run["dir"]) and is_flax_checkpoint(run["path"])
    got = read_flax_checkpoint(run["dir"])
    tree_equal(fs.to_state_dict(jax.tree.map(np.asarray, run["state"])), got)
    sd = load_checkpoint(run["path"])
    ref = from_jax_variables(run["v"])
    assert set(sd) == set(ref) and all(torch.equal(sd[k], ref[k]) for k in sd)
    model = registry.build_model(run["cfg"], device="cpu")
    model.load_state_dict(load_checkpoint(run["dir"]))
    x = counts(np.random.default_rng(0), (1, 16, 16, 2))
    jo, _ = run["jm"].apply(run["v"], None, jnp.asarray(x), run["jm"].init_states(1, 16, 16))
    with torch.no_grad():
        po, _ = model(None, torch.tensor(x), model.init_states(1, 16, 16))
    np.testing.assert_allclose(po["flow"][0].numpy(), np.asarray(jo["flow"][0]), atol=1e-5)


@pytest.mark.parametrize("opt_cfg", [{"name": "Adam", "lr": 1e-3},
                                     {"name": "SGD", "lr": 1e-2, "momentum": 0.9},
                                     {"name": "RMSprop", "lr": 1e-3, "momentum": 0.5}],
                         ids=["adam", "sgd", "rmsprop"])
def test_optimizer_state_resumes_as_optax(run, tmp_path, opt_cfg):
    """The checkpoint's optax state (its moments random, Adam's count 5)
    restored into the port optimizer (``train``'s resume): one step from it
    with the same gradients moves every parameter as optax's update does
    (rtol 1e-5)."""
    from evflow import registry as jreg
    from evflow_torch.train import _resume

    v = run["v"]
    tx = jreg.build_optimizer(opt_cfg)
    opt = tx.init(v["params"])
    rng = np.random.default_rng(2)
    opt = jax.tree.map(lambda a: (rng.normal(0, 1e-2, np.shape(a)) ** 2).astype(np.float32)
                       if np.ndim(a) else np.asarray(5, np.asarray(a).dtype), opt)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, {"params": v["params"], "batch_stats": v["batch_stats"],
                        "opt_state": opt, "epoch": 0, "loss": 0.0, "loss_variance": 0.0})
    model = registry.build_model(run["cfg"], device="cpu")
    optimizer = registry.build_optimizer(opt_cfg, model.parameters())
    _resume(d, model, optimizer)
    grads = jax.tree.map(lambda p: rng.normal(0, 1e-2, np.shape(p)).astype(np.float32),
                         v["params"])
    updates, _ = tx.update(grads, opt, v["params"])
    after = from_jax_variables({"params": optax.apply_updates(v["params"], updates),
                                "batch_stats": v["batch_stats"]})
    port_grads = from_jax_variables({"params": grads, "batch_stats": v["batch_stats"]})
    for name, p in model.named_parameters():
        p.grad = port_grads[name].clone()
    optimizer.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_train_resumes_from_a_reference_run(run, tmp_path):
    """``train(prev_ckpt=<model.msgpack directory>)`` starts from the run's
    weights (its first loss equals that of the same weights in a bare
    ``.pth``) and from its Adam state (the first step then moves the
    weights otherwise than a fresh Adam does)."""
    import _torch_train as T

    from evflow_torch.train import train

    cfg = T.train_config(T.make_data(tmp_path / "data"), name="LIFFireNet",
                         optimizer={"name": "Adam", "lr": 1e-3})
    pth = str(tmp_path / "weights.pth")
    torch.save(from_jax_variables(run["v"]), pth)
    stats = {ckpt: {} for ckpt in (run["dir"], pth)}
    for ckpt, st in stats.items():
        train(cfg, path_runs=str(tmp_path / "runs"), prev_ckpt=ckpt, max_steps=1,
              verbose=False, device="cpu", stats=st)
    a, b = stats[run["dir"]], stats[pth]
    assert a["steps"] == b["steps"] == 1
    assert a["losses"][0] == b["losses"][0]
    assert a["params_moved"] != b["params_moved"]
