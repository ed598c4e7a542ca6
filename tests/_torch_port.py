"""Shared fixtures of the port's tests (``tests/test_torch_*.py``): seeded
flax FireNet variables, the synthetic evaluation config, and the JAX probe
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
