"""One TBPTT step of the port (``evflow_torch.train.TrainStep``) against the
reference package's ``evflow.train.make_train_step`` on the CPU, the same
weights (the JAX variables through ``from_jax_variables``) and the same
streamed loss window (B=2, 16x16, 8 channels, P=3, 64 events a pass):
LIFFireNet_short and LIFFireNet, TEBN off and on, Adam with the clip
active, ``remat`` full. Held: the loss (rtol 1e-5), every parameter's
gradient (rtol 5e-4, atol 5e-7, the JAX package's cross-framework bar), the
parameters and the norms' running statistics after the step.

Preconditions, not tolerances: no membrane within 1e-5 of its threshold at
any spike (the guard of ``tests/test_reference_parity.py``), and the
gradients' global norm above the clip. The gradient bar lies at the f32
noise floor of both packages: against the port's own float64 gradients,
the two f32 gradients (the port's and the reference's) each miss it on
many windows (a 2-5 pass deep net through train-mode BN and the warp's
bilinear kinks), so each case's weight seed and window are ones where both
preconditions hold and the two f32 gradients meet the bar; the float64
check below holds the port no farther from exact than the reference."""

import numpy as np
import pytest
import torch

import _torch_train as T
from evflow_torch.probes.train_step import spike_margins
from evflow_torch.loss.warp_loss import EventWarpingConfig
from evflow_torch.train import restore_window, upload_window

# (model, TEBN, weight seed, windows skipped)
CASES = [("LIFFireNet_short", False, 1, 3), ("LIFFireNet_short", True, 2, 0),
         ("LIFFireNet", False, 11, 3), ("LIFFireNet", True, 10, 0)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return T.make_data(tmp_path_factory.mktemp("step"))


def f64_grads(cfg, variables, window):
    """The port's gradients of the same step's loss in float64."""
    m = T.port_model(cfg, variables).double().train()
    rw = restore_window(upload_window(window, torch.device("cpu")), (T.H, T.W))
    states = [s._replace(mem=s.mem.double(), spk=s.spk.double())
              for s in m.init_states(T.B, T.H, T.W)]
    flows = []
    for p in range(T.P):
        h = rw["event_cnt"][p].double()
        for i, name in enumerate(m.unit_names):
            h, states[i] = getattr(m, name)(h, states[i], timestep=p)
        flows.append(m.pred(h))
    EventWarpingConfig(cfg)([torch.stack(flows)], *(rw[k].double() for k in (
        "event_list", "event_list_pol_mask", "event_mask", "event_valid"))).backward()
    return {n: p.grad.numpy() for n, p in m.named_parameters() if p.grad is not None}


def bar_ratio(a, exact):
    return float((np.abs(a - exact) / (5e-7 + 5e-4 * np.abs(exact))).max())


@pytest.mark.parametrize("name,tebn,seed,skip", CASES,
                         ids=[f"{c[0]}-{'tebn' if c[1] else 'bn'}" for c in CASES])
def test_step_matches_reference(data, name, tebn, seed, skip):
    cfg = T.train_config(data, name=name, tebn=tebn)
    v = T.seeded(cfg, seed)
    window = T.loss_window(cfg, skip)
    jloss, jvars, jgrads = T.jax_step(cfg, v, window)
    with spike_margins() as margins:
        loss, model, grads, _ = T.port_step(cfg, v, window)
    T.check_margins(margins)
    gnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    assert gnorm > cfg["loss"]["clip_grad"], "the clip must be active"

    np.testing.assert_allclose(loss, jloss, rtol=T.LOSS_RTOL)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    T.assert_grads_match(grads, jgrads, v)
    T.assert_step_matches(model, cfg, v, jvars, jgrads)

    exact = f64_grads(cfg, v, window)
    ref = T.in_port_layout(v, jgrads)
    port_r = max(bar_ratio(grads[n].double().numpy(), g) for n, g in exact.items())
    ref_r = max(bar_ratio(ref[n].double().numpy(), g) for n, g in exact.items())
    assert port_r <= 2 * ref_r + 0.5, (port_r, ref_r)
