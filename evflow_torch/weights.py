"""Weight carry between the reference package, reference ``.pth`` files and
the port (counterpart of the torch import in ``evflow/utils/checkpoint.py``).

* ``from_jax_variables``: flax ``{"params", "batch_stats"}`` trees (numpy or
  array-likes) -> a port ``FireNet`` or ``SpikingRecEVFlowNet`` state
  dict: HWIO -> OIHW kernels,
  ``[C]`` -> ``[C, 1, 1]`` leak/threshold (snn cells: ``lif.beta``,
  ``lif.threshold``; sigmoid cells: ``leak``, ``thresh``), BN
  scale/bias/mean/var -> ``weight``/``bias``/``running_mean``/``running_var``.
* ``to_port_layout``: a reference state dict as it is (plain layout, or the
  PTQ layout with ``{unit}.beta``/``{unit}.threshold``) -> port key names,
  every per-channel LIF vector in the model's shape.
* ``load_checkpoint``: the state dict inside a reference ``.pth`` file, or
  of a reference package's ``model.msgpack`` (``utils/msgpack.py``).
* ``flax_optimizer_state``: a msgpack checkpoint's optax state (Adam's
  moments and count, a momentum trace, RMSprop's ``nu``) as the port
  optimizer's ``state_dict``.
* ``seeded_state_dict``: seeded FireNet weights in the flax init
  distributions, with BN statistics drawn so that every unit fires;
  ``seeded_unet_state_dict`` the spiking UNet's, every state slot firing.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_variables", "to_port_layout", "load_checkpoint",
           "seeded_state_dict", "seeded_unet_state_dict", "flax_optimizer_state"]

_BN_LEAVES = (("scale", "weight"), ("bias", "bias"))
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _t(a) -> torch.Tensor:
    return torch.tensor(np.array(a, dtype=np.float32))


def _oihw(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)))


def _bn(prefix: str, params: Mapping, stats: Mapping, out: Dict[str, torch.Tensor]):
    p = params["BatchNorm_0"]
    s = stats["BatchNorm_0"]
    for src, dst in _BN_LEAVES:
        out[f"{prefix}.{dst}"] = _t(p[src])
    for src, dst in _BN_STATS:
        out[f"{prefix}.{dst}"] = _t(s[src])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _unet_from_jax(u: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The spiking UNet's flax tree (``params["multires_unetrec"]``) under
    the reference's torch names."""
    out: Dict[str, torch.Tensor] = {}

    def cell(prefix: str, p: Mapping[str, Any]):
        for conv in ("ff", "rec"):
            if conv in p:
                out[f"{prefix}.{conv}.weight"] = _oihw(p[conv]["kernel"])
        for leaf in ("leak", "thresh"):
            out[f"{prefix}.{leaf}"] = _t(p[leaf]).reshape(-1, 1, 1)
        for norm in ("norm", "norm_ff", "norm_rec"):
            if norm in p:
                out[f"{prefix}.{norm}.weight"] = _t(p[norm]["scale"])
                out[f"{prefix}.{norm}.bias"] = _t(p[norm]["bias"])

    i = 0
    while f"encoder{i}" in u:
        for sub in ("conv", "recurrent_block"):
            cell(f"multires_unetrec.encoders.{i}.{sub}", u[f"encoder{i}"][sub])
        i += 1
    i = 0
    while f"resblock{i}" in u:
        for sub in ("conv1", "conv2"):
            cell(f"multires_unetrec.resblocks.{i}.{sub}", u[f"resblock{i}"][sub])
        i += 1
    i = 0
    while f"decoder{i}" in u:
        cell(f"multires_unetrec.decoders.{i}.conv2d", u[f"decoder{i}"]["conv2d"])
        pred = u[f"pred{i}"]["conv2d"]
        out[f"multires_unetrec.preds.{i}.conv2d.weight"] = _oihw(pred["kernel"])
        out[f"multires_unetrec.preds.{i}.conv2d.bias"] = _t(pred["bias"])
        i += 1
    return out


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Port state dict of the FireNet or spiking UNet whose flax variables
    are given."""
    params = variables["params"]
    if "multires_unetrec" in params:
        return _unet_from_jax(params["multires_unetrec"])
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for unit, up in params.items():
        if unit == "pred":
            continue
        us = stats.get(unit, {})
        for conv in ("ff", "rec"):
            if conv in up:
                out[f"{unit}.{conv}.weight"] = _oihw(up[conv]["kernel"])
        if "leak" in up:  # sigmoid-family cell: no norm
            for leaf in ("leak", "thresh"):
                out[f"{unit}.{leaf}"] = _t(up[leaf]).reshape(-1, 1, 1)
            continue
        for leaf in ("beta", "threshold"):
            out[f"{unit}.lif.{leaf}"] = _t(up[leaf]).reshape(-1, 1, 1)
        if "p" in up["bn"]:  # TEBN: BN one level deeper, p [T, C] -> [T, C, 1, 1]
            _bn(f"{unit}.bn.bn", up["bn"], us["bn"], out)
            out[f"{unit}.bn.p"] = _t(up["bn"]["p"])[..., None, None]
        else:
            _bn(f"{unit}.bn", up["bn"], us["bn"], out)
        if "mpbn" in up:
            _bn(f"{unit}.mpbn.bn", up["mpbn"], us["mpbn"], out)
    pred = params["pred"]["conv2d"]
    out["pred.conv2d.weight"] = _oihw(pred["kernel"])
    out["pred.conv2d.bias"] = _t(pred["bias"])
    return out


def to_port_layout(state_dict: Mapping[str, torch.Tensor],
                   model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Rename a reference state dict's PTQ-layout LIF keys (``{unit}.beta``,
    ``{unit}.threshold``) to the port's (``{unit}.lif.beta``, ...), reshape
    ``[C]`` leak/threshold vectors (``lif.beta``, ``lif.threshold``,
    ``leak``, ``thresh``) to the model's ``[C, 1, 1]``, and add BN
    ``num_batches_tracked`` counters that the file may lack."""
    out = dict(state_dict)
    expected = model.state_dict()
    for key in list(out):
        unit, _, leaf = key.rpartition(".")
        if leaf in ("beta", "threshold") and f"{unit}.lif.{leaf}" in expected:
            out[f"{unit}.lif.{leaf}"] = out.pop(key)
    for key, ref in expected.items():
        if key.endswith(("lif.beta", "lif.threshold", ".leak", ".thresh")) and key in out:
            out[key] = out[key].reshape(ref.shape)
        if key.endswith("num_batches_tracked") and key not in out:
            out[key] = torch.zeros_like(ref)
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a reference checkpoint file: a bare state
    dict, ``{"model_state_dict": ...}``, or a pickled module; or of the
    reference package's ``model.msgpack`` (the file or its directory)."""
    from evflow_torch.utils.msgpack import is_flax_checkpoint, read_flax_checkpoint

    if is_flax_checkpoint(path):
        return from_jax_variables(read_flax_checkpoint(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(v)
            for k, v in sd.items()}


def seeded_state_dict(model, seed: int = 0, pred_scale: float = 0.1) -> Dict[str, torch.Tensor]:
    """Random FireNet weights from a numpy seed, exact in bf16.

    Kernels, leaks and thresholds follow the flax init (``U(-sqrt(1/fan_in),
    +)``, ``U(leak)``, ``U(thresh)``); a sigmoid-family cell's ``leak`` is
    drawn from N(0, 1) (its normal init under the config's ``leak: [0.0,
    1.0]``) and its ``thresh`` from ``U(0.05, 0.8)``, so that no threshold
    sits at the clamp. Untrained BN statistics (mean 0, var
    1) leave deep units silent, where a trained model's BN brings each
    unit's input current to the scale of its threshold; so the BN
    statistics are drawn too (``running_var`` ~ U(0.1, 0.4),
    ``running_mean`` ~ N(0, 0.05), bias ~ U(-0.1, 0.1)), which keeps every
    unit of a 32-channel LIFFireNet firing on event-count input. The pred
    head is ``U(-pred_scale, pred_scale)`` with zero bias: the flax init's
    0.01 gives flows below 0.06, too small for a flow comparison to mean
    much.

    A random spiking net at this width is chaotic: one spike flipped by a
    rounding difference flips about ten in the next unit. So that the fused
    and the unfused forward round alike, the kernels are bf16 values and
    every BN gain ``scale / sqrt(var + eps)`` is a power of two (the scale
    is drawn as ``2**k * sqrt(var + eps)``, k in {0, 1}): folding BN into a
    bf16 kernel is then exact, and the two paths differ by f32 sums only.
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}

    def bf16(a):
        return _t(a).to(torch.bfloat16).float()

    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(ref)
        elif key.startswith("pred."):
            bound = UNET_SEED_PRED_SCALE
            out[key] = bf16(rng.uniform(-bound, bound, shape) if leaf == "weight"
                            else np.zeros(shape))
        elif key.endswith((".ff.weight", ".rec.weight")):
            out[key] = bf16(rng.uniform(-1.0, 1.0, shape) * math.sqrt(1.0 / shape[1]))
        elif key.endswith("lif.beta"):
            out[key] = _t(rng.uniform(0.0, 1.0, shape))
        elif key.endswith("lif.threshold"):
            out[key] = _t(rng.uniform(0.0, 0.8, shape))
        elif leaf == "leak":
            out[key] = _t(rng.normal(0.0, 1.0, shape))
        elif leaf == "thresh":
            out[key] = _t(rng.uniform(0.05, 0.8, shape))
        elif leaf == "running_var":
            prefix = key[: -len("running_var")]
            var = _t(rng.uniform(0.1, 0.4, shape))
            gain = 2.0 ** rng.integers(0, 2, shape)
            out[key] = var
            out[prefix + "weight"] = _t(gain) * torch.sqrt(var + 1e-5)
            out[prefix + "bias"] = _t(rng.uniform(-0.1, 0.1, shape))
            out[prefix + "running_mean"] = _t(rng.normal(0.0, 0.05, shape))
        elif leaf in ("weight", "bias", "running_mean"):
            continue  # BN leaves, drawn with running_var
        elif leaf == "p":  # TEBN per-timestep scale
            out[key] = torch.ones(shape)
        else:
            raise KeyError(f"no seeded draw for {key}")
    return out


# the seeded UNet's kernel gain over the flax init's scale (at 1 the deep
# slots of a random net stay silent on sparse event windows) and the bound
# of its flow heads' weights
UNET_SEED_GAIN = 3.0
UNET_SEED_PRED_SCALE = 0.1


def seeded_unet_state_dict(model, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random ``SpikingRecEVFlowNet`` weights from a numpy seed, exact in
    bf16: kernels ``U(-1, 1) * UNET_SEED_GAIN / sqrt(fan_in)``, leaks
    N(-2, 0.5) (``sigmoid(leak)`` ~ 0.12: the membrane follows its input
    current), thresholds U(0.3, 0.8), the flow heads ``U(-UNET_SEED_PRED_SCALE,
    UNET_SEED_PRED_SCALE)`` with zero bias, GroupNorms as initialised
    (scale 1, bias 0). At the default width every state slot fires on
    Poisson(0.05) count windows."""
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}

    def bf16(a):
        return _t(a).to(torch.bfloat16).float()

    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        leaf = key.rsplit(".", 1)[-1]
        if ".preds." in key:
            bound = UNET_SEED_PRED_SCALE
            out[key] = bf16(rng.uniform(-bound, bound, shape) if leaf == "weight"
                            else np.zeros(shape))
        elif key.endswith((".ff.weight", ".rec.weight")):
            fan_in = shape[1] * shape[2] * shape[3]
            out[key] = bf16(rng.uniform(-1.0, 1.0, shape) * UNET_SEED_GAIN
                            / math.sqrt(fan_in))
        elif leaf == "leak":
            out[key] = bf16(rng.normal(-2.0, 0.5, shape))
        elif leaf == "thresh":
            out[key] = bf16(rng.uniform(0.3, 0.8, shape))
        elif ".norm" in key:
            out[key] = ref.detach().cpu().float().clone()
        else:
            raise KeyError(f"no seeded draw for {key}")
    return out


def _optax_nodes(tree: Any):
    """(fields, node) of every optax state in a msgpack ``opt_state`` tree
    that holds per-parameter trees: ScaleByAdamState, ScaleByRmsState,
    TraceState."""
    if not isinstance(tree, dict):
        return
    keys = frozenset(tree)
    if keys in (frozenset({"count", "mu", "nu"}), frozenset({"nu"}), frozenset({"trace"})):
        yield keys, tree
        return
    for v in tree.values():
        yield from _optax_nodes(v)


def flax_optimizer_state(opt_state: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The port ``optimizer``'s ``state_dict`` holding the reference's optax
    state (as a msgpack checkpoint stores it): Adam and AdamW's ``mu``,
    ``nu`` and ``count`` as ``exp_avg``, ``exp_avg_sq`` and ``step``; SGD's
    momentum trace as ``momentum_buffer``; ``OptaxRMSprop``'s ``nu`` and
    ``trace`` (optax traces the update after the learning rate, the port
    before it: divided by ``-lr``). Each moment tree is laid out as
    ``from_jax_variables`` lays out the parameters."""
    names = [n for n, _ in model.named_parameters()]

    def port(tree):
        sd = from_jax_variables({"params": tree, "batch_stats": batch_stats})
        return [sd[n] for n in names]

    state: Dict[int, Dict[str, torch.Tensor]] = {i: {} for i in range(len(names))}
    for keys, node in _optax_nodes(opt_state):
        if "mu" in keys:
            step = torch.tensor(float(np.asarray(node["count"])))
            for i, (m, v) in enumerate(zip(port(node["mu"]), port(node["nu"]))):
                state[i].update(step=step.clone(), exp_avg=m, exp_avg_sq=v)
        elif "nu" in keys:
            for i, v in enumerate(port(node["nu"])):
                state[i]["nu"] = v
        elif isinstance(optimizer, torch.optim.SGD):
            for i, t in enumerate(port(node["trace"])):
                state[i]["momentum_buffer"] = t
        else:
            lr = float(optimizer.param_groups[0]["lr"])
            for i, t in enumerate(port(node["trace"])):
                state[i]["trace"] = t / -lr
    sd = optimizer.state_dict()
    return {"state": {i: s for i, s in state.items() if s},
            "param_groups": sd["param_groups"]}
