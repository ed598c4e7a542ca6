"""Shared fixtures of the port's tests (``tests/test_torch_*.py``): seeded
flax FireNet and spiking-UNet variables, the synthetic evaluation config, and the JAX probe
kernels of ``benchmarks/probe_*.py`` without their benchmarks.

The flax variables are drawn with numpy so both packages get the same
numbers: kernels in the flax init range, BN statistics and LIF parameters
drawn so that every unit of a small FireNet fires on Poisson count input
(with the init statistics, mean 0 and var 1, deep units stay silent and a
parity test would compare zeros).
"""

from __future__ import annotations

import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evflow.registry import build_model as build_jax_model

SN = {"leak": [0.0, 1.0], "thresh": [0.0, 0.8]}
ROOT = Path(__file__).resolve().parents[1]


def model_cfg(name="LIFFireNet", C=8, **extra):
    return {"name": name, "num_bins": 2, "base_num_channels": C, "kernel_size": 3,
            "encoding": "cnt", "spiking_neuron": dict(SN), **extra}


def _draw(rng, path, leaf):
    names = [getattr(p, "key", str(p)) for p in path]
    shape = np.shape(leaf)
    last = names[-1]
    if names[0] == "pred":
        return (rng.uniform(-0.3, 0.3, shape) if last == "kernel"
                else rng.normal(0, 0.05, shape))
    if last == "kernel":  # HWIO
        return rng.uniform(-1, 1, shape) * math.sqrt(1.0 / shape[2])
    if last == "beta":
        return rng.uniform(0.0, 1.0, shape)
    if last == "threshold":
        return rng.uniform(0.05, 0.8, shape)
    if last == "scale":
        return rng.uniform(0.8, 1.2, shape)
    if last == "bias":
        return rng.uniform(0.0, 0.2, shape)
    if last == "mean":
        return rng.normal(0.0, 0.05, shape)
    if last == "var":
        return rng.uniform(0.05, 0.2, shape)
    if last == "p":
        return rng.uniform(0.8, 1.2, shape)
    if last == "leak":  # sigmoid-family cells
        return rng.normal(0.0, 1.0, shape)
    if last == "thresh":
        return rng.uniform(0.05, 0.8, shape)
    raise KeyError("/".join(names))


def seeded_flax_firenet(cfg, seed=0, H=16, W=16):
    """(flax model, numpy variables) of the config, every leaf from ``seed``."""
    model = build_jax_model(cfg)
    states = model.init_states(1, H, W)
    v = model.init(jax.random.PRNGKey(0), None, jnp.zeros((1, H, W, 2)), states)
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: _draw(rng, p, x).astype(np.float32), jax.device_get(dict(v)))
    return model, v


def counts(rng, shape, lam=0.6):
    return rng.poisson(lam, shape).astype(np.float32)


def eval_config(root, res=16, std=32, C=8, metrics=("AEE", "AAE", "AE_ofMeans")):
    """configs/eval_MVSEC.yml's settings on a small synthetic dataset:
    downsampling from ``std`` to ``res``, ``keep_gt_full_res``, hot filter."""
    return {
        "data": {"path": root, "mode": "gtflow_dt1", "window": 1},
        "model": model_cfg("LIFFireNet", C, mask_output=True, norm_input=False,
                           round_encoding=False),
        "loader": {"resolution": [res, res], "std_resolution": [std, std],
                   "keep_gt_full_res": True, "batch_size": 1, "augment": [],
                   "seed": 0, "native_encoder": True},
        "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5, "max_rate": 0.8},
        "metrics": {"name": list(metrics), "flow_scaling": 128, "heat_map": False},
        "vis": {"enabled": False, "store": False, "activity": False},
        "loss": {},
    }


def probe_namespace(name: str, **consts):
    """The imports and functions of ``benchmarks/<name>.py``, with ``consts``
    bound as module globals; nothing of its top-level benchmark runs (nor
    any other module-level assignment: pass derived constants too)."""
    tree = ast.parse((ROOT / "benchmarks" / f"{name}.py").read_text())
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = dict(consts)
    exec(compile(ast.Module(body=keep, type_ignores=[]), f"{name}.py", "exec"), ns)
    return ns


UNET_SN = {"leak": [-4.0, 0.1], "thresh": [0.8, 0.0]}


def unet_cfg(**extra):
    return {"name": "SpikingRecEVFlowNet", "num_bins": 2, "base_num_channels": 4,
            "kernel_size": 3, "encoding": "cnt", "spiking_neuron": dict(UNET_SN), **extra}


def unet_draw(rng, path, leaf):
    """Seeded weights in which every state slot fires: kernels ``U(-3, 3) /
    sqrt(fan_in)``, leaks N(-2, 0.5), thresholds U(0.3, 0.8)."""
    names = [getattr(p, "key", str(p)) for p in path]
    shape, last = np.shape(leaf), names[-1]
    if last == "kernel":
        if any(n.startswith("pred") for n in names):
            return rng.uniform(-0.3, 0.3, shape)
        return rng.uniform(-1, 1, shape) * 3.0 / math.sqrt(shape[0] * shape[1] * shape[2])
    if last == "leak":
        return rng.normal(-2.0, 0.5, shape)
    if last == "thresh":
        return rng.uniform(0.3, 0.8, shape)
    if last == "bias":
        return rng.normal(0.0, 0.05, shape)
    if last == "scale":
        return rng.uniform(0.8, 1.2, shape)
    raise KeyError(names)


def seeded_flax_unet(cfg, B, H, W, seed=0):
    """(flax model, numpy variables) of a UNet config, seeded."""
    jm = build_jax_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), None, jnp.zeros((B, H, W, 2)),
                            jm.init_states(B, H, W))
    rng = np.random.default_rng(seed)
    return jm, jax.tree_util.tree_map_with_path(
        lambda p, x: unet_draw(rng, p, np.zeros(x.shape)).astype(np.float32), dict(shapes))


def run_flax_unet(jm, v, wins):
    """The reference's ``(flows, states)`` a window over ``wins``, from
    zero states, as one jitted step."""
    step = jax.jit(jm.apply)
    st = jm.init_states(*wins[0].shape[:3])
    runs = []
    for x in wins:
        o, st = step(v, None, jnp.asarray(x), st)
        runs.append(([np.asarray(f) for f in o["flow"]],
                     [(np.array(s.mem), np.array(s.spk)) for s in st]))
    return runs


def port_unet(cfg, variables):
    from evflow_torch.registry import build_model
    from evflow_torch.weights import from_jax_variables

    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(from_jax_variables(variables))
    return pm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a test file's torch ops (an autouse fixture
    for the files that import it): under xdist the workers already share
    every core, and idle intra-op threads spin on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
