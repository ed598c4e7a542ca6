"""Shared pieces of the port's training tests (``tests/test_torch_train*.py``):
the training config at the small sizes of ``tests/test_reference_parity.py``
(B=2, 16x16, 8 channels, P=3), loss windows streamed from a synthetic
dataset, one TBPTT step of each package on the same weights and window,
and the gradient and parameter comparisons in the port's layout."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from _torch_port import model_cfg, seeded_flax_firenet
from evflow import registry as jreg
from evflow.loss.warp_loss import EventWarpingConfig as JaxWarpConfig
from evflow.train import make_train_step
from evflow_torch import registry
from evflow_torch.loss.warp_loss import EventWarpingConfig
from evflow_torch.train import TrainStep, stack_window, upload_window
from evflow_torch.weights import from_jax_variables

B, H, W, P = 2, 16, 16, 3
MARGIN = 1e-5  # the spike-margin guard of tests/test_reference_parity.py
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=5e-4, atol=5e-7)


def train_config(root, name="LIFFireNet_short", optimizer=None, remat="full", tebn=False,
                 window=64, **model_extra):
    cfg = model_cfg(name, mask_output=True, **model_extra)
    if tebn:
        cfg["tebn"] = {"enabled": True, "num_timesteps": 4}
    return {
        "experiment": "test",
        "data": {"path": str(root), "mode": "events", "window": window,
                 "window_loss": P * window},
        "model": cfg,
        "loss": {"flow_regul_weight": 0.001, "clip_grad": 1.0,
                 "overwrite_intermediate": False, "remat": remat},
        "optimizer": optimizer or {"name": "Adam", "lr": 2e-4},
        "loader": {"n_epochs": 100, "batch_size": B, "resolution": [H, W],
                   "std_resolution": [H, W], "augment": [], "augment_prob": [], "seed": 0},
        "vis": {"verbose": False, "enabled": False, "store_grads": False, "bars": False},
        "hot_filter": {"enabled": False},
    }


def make_data(root, n=2, res=(H, W), duration=0.3, rate=20_000, fmt="h5"):
    from evflow_torch.data.synthetic import make_dataset

    make_dataset(str(root), num_sequences=n, resolution=res, events_per_sec=rate,
                 duration=duration, flows=[(6.0, -3.0), (-4.0, 2.0)] * n,
                 gt_hz=10.0, fmt=fmt)
    return str(root)


def loss_window(cfg, skip=0):
    """The full-f32 loss window (``stack_window`` of P streamed batches,
    the hot mask dropped) after ``skip`` windows."""
    from evflow_torch.data.h5_stream import H5EventStream

    stream = H5EventStream(cfg, 2)
    batches = [stream.next_batch() for _ in range(skip + P)][skip:]
    stream.close()
    w = stack_window(batches)
    w.pop("hot_mask", None)
    return w


def check_margins(margins):
    """The spike-margin guard over ``probes.train_step.spike_margins``'
    record: no membrane within float noise of its threshold."""
    assert margins and min(margins) > MARGIN, f"spike margin {min(margins):.2e}: pick another seed"


def jax_step(cfg, variables, window, clip=True):
    """One ``evflow.train.make_train_step`` step (the reference trainer's
    optimizer chain): ``(loss, new variables, grads)`` as numpy trees."""
    model = jreg.build_model(cfg["model"])
    tx = jreg.build_optimizer(cfg["optimizer"])
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(float(cfg["loss"]["clip_grad"])), tx)
    params = jax.tree.map(jnp.asarray, variables["params"])
    bs = jax.tree.map(jnp.asarray, variables.get("batch_stats", {}))
    step = make_train_step(model, tx, JaxWarpConfig(cfg), 4, remat=cfg["loss"]["remat"],
                           resolution=(H, W))
    loss, new_params, new_bs, _, _, grads = step(
        params, bs, tx.init(params), model.init_states(B, H, W),
        jax.tree.map(jnp.asarray, window))
    get = jax.device_get
    return float(loss), {"params": get(new_params), "batch_stats": get(new_bs)}, get(grads)


def port_model(cfg, variables, device="cpu"):
    m = registry.build_model(cfg["model"], device=device)
    m.load_state_dict(from_jax_variables(variables))
    return m


def port_step(cfg, variables, window, device="cpu", clip=True):
    """One port ``TrainStep`` on the same weights and window: ``(loss,
    model after the step, raw grads by name, the step)``."""
    model = port_model(cfg, variables, device)
    opt = registry.build_optimizer(cfg["optimizer"], model.parameters())
    step = TrainStep(model, opt, EventWarpingConfig(cfg), 4, remat=cfg["loss"]["remat"],
                     clip_grad=cfg["loss"]["clip_grad"] if clip else None,
                     resolution=(H, W), keep_grads=True)
    loss, _ = step(model.init_states(B, H, W), upload_window(window, torch.device(device)))
    return float(loss), model, step.grads, step


def in_port_layout(variables, grads=None):
    """A flax variables tree (or its gradient tree, with the batch stats it
    goes with) as a port state dict: a layout map only."""
    if grads is None:
        return from_jax_variables(variables)
    return from_jax_variables({"params": grads, "batch_stats": variables["batch_stats"]})


def seeded(cfg, seed=1):
    return seeded_flax_firenet(cfg["model"], seed=seed, H=H, W=W)[1]


def assert_grads_match(port_grads, jax_grads, variables):
    ref = in_port_layout(variables, jax_grads)
    assert set(port_grads) <= set(ref)
    for name, g in port_grads.items():
        np.testing.assert_allclose(g.cpu().numpy(), ref[name].numpy(), **GRAD_TOL,
                                   err_msg=f"gradient of {name}")


def update_bound(name, g, lr):
    """How far one first step of optimizer ``name`` can move a parameter
    when its gradient ``g`` moves within the gradient bar ``dg`` (the clip
    scales both alike, so the unclipped ``g`` bounds it):
    SGD's update is ``lr g``; Adam's and AdamW's ``lr g / (|g| + eps)``
    and RMSprop's ``lr g / sqrt(0.1 g^2 + eps)`` are bounded by ``lr`` and
    ``lr / sqrt(0.1)``, and a tiny gradient may even turn their sign."""
    dg = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(g)
    if name == "SGD":
        return lr * dg
    amp = 1.0 if name.startswith("Adam") else 1.0 / np.sqrt(0.1)
    return lr * amp * np.minimum(2.0, 2.0 * dg / (np.abs(g) + 1e-8))


def assert_step_matches(model, cfg, variables, jax_after, jax_grads):
    """The port's parameters after its step within ``update_bound`` (plus
    an f32 rounding of the parameter) of the reference's, and the
    buffers (running statistics) within 1e-5."""
    after = in_port_layout(jax_after)
    grads = in_port_layout(variables, jax_grads)
    opt = cfg["optimizer"]
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(t) == P, key  # one running-statistics update a pass
            continue
        got, want = t.numpy(), after[key].numpy()
        if key in dict(model.named_parameters()):
            bound = update_bound(opt["name"], grads[key].numpy(), opt["lr"])
            bound = bound + 2.4e-7 * np.abs(want) + 1e-9
        else:
            bound = 1e-5 * (1.0 + np.abs(want))
        bad = np.abs(got - want) > bound
        assert not bad.any(), (key, got[bad][:4], want[bad][:4])
