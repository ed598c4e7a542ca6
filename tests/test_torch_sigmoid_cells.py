"""The sigmoid-family LIF math of the port against the reference package on
the CPU: the five surrogate spike functions, ``sigmoid_lif_step``,
``export_lif_step``, the ``ConvLIF``/``ConvLIFRecurrent`` cells and the four
FireNet builders with ``cell_family: sigmoid`` through the registry
(``activations``, ``act_width``), on seeded numpy inputs and the JAX
variables carried by ``from_jax_variables``.

Bars: surrogate forwards equal, backwards within rtol 1e-6 / atol 1e-7;
``sigmoid_lif_step`` membranes within rtol 1e-6, spikes equal, gradients
within rtol 1e-5; ``export_lif_step`` equal; cells and models: membranes
and flow within atol 1e-5, spikes equal. Precondition, not a tolerance: no
membrane within 1e-5 of its threshold at a spike (``margins``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import counts, model_cfg, seeded_flax_firenet
from evflow.models import cells as jcells
from evflow.ops import lif as jlif
from evflow.ops import surrogate as jsur
from evflow_torch.models import cells as tcells
from evflow_torch.ops import lif as tlif
from evflow_torch.ops import surrogate as tsur
from evflow_torch.probes.quant_step import sigmoid_margins as margins
from evflow_torch.registry import build_model
from evflow_torch.weights import from_jax_variables

B, H, W, C = 2, 16, 16, 8
MARGIN = 1e-5
SURROGATES = sorted(tsur.SURROGATES)


def check(m):
    assert m and min(m) > MARGIN, f"spike margin {min(m):.2e}: pick another seed"


@pytest.mark.parametrize("name", SURROGATES)
@pytest.mark.parametrize("width", [None, 3.0])
def test_surrogate_matches_reference(name, width):
    """Forward equal; the gradient to x and to the threshold (through
    ``x - thresh``; a threshold an element, so that no sum over a
    broadcast adds its own rounding) within rtol 1e-6, atol 1e-7."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 0.6, (4, 5, C)).astype(np.float32)
    th = rng.uniform(0.1, 0.9, x.shape).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    kw = {} if width is None else {("alpha" if name == "atanspike_snn" else "width"): width}
    jf = jsur.SURROGATES[name]

    def jloss(a, t):
        return jnp.sum(jf(a, t, **kw) * g)

    jy = np.asarray(jf(jnp.asarray(x), jnp.asarray(th), **kw))
    jgx, jgt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(th))
    xt, tt = torch.tensor(x, requires_grad=True), torch.tensor(th, requires_grad=True)
    ty = tsur.spike_fn(name)(xt, tt, **kw)
    (ty * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), rtol=1e-6, atol=1e-7)


def test_spike_fn_refuses_an_unknown_name():
    with pytest.raises(KeyError, match="Available"):
        tsur.spike_fn("sigmoidspike")


@pytest.mark.parametrize("activation", [s for s in SURROGATES if s != "atanspike_snn"])
@pytest.mark.parametrize("hard_reset", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("detach", [True, False], ids=["detach", "nodetach"])
def test_sigmoid_lif_step_matches_reference(activation, hard_reset, detach):
    """Two steps (the second from the first's state): membranes within
    rtol 1e-6, spikes equal, every input's gradient within rtol 1e-5."""
    rng = np.random.default_rng(2)
    ffs = rng.normal(0.6, 0.8, (2, B, 4, 4, C)).astype(np.float32)
    leak = rng.normal(0.0, 1.0, C).astype(np.float32)
    th = rng.uniform(0.05, 0.8, C).astype(np.float32)
    th[0] = 0.0  # one threshold at the clamp
    gz, gv = rng.normal(size=(2,) + ffs.shape[1:]).astype(np.float32)
    kw = dict(hard_reset=hard_reset, detach_reset=detach, activation=activation, act_width=4.0)

    def run(step, ff, lk, t, zeros):
        v = z = zeros
        outs = []
        for k in range(2):
            z, v = step(ff[k], v, z, lk, t, **kw)
            outs.append((z, v))
        return outs

    def jloss(ff, lk, t):
        outs = run(jlif.sigmoid_lif_step, ff, lk, t, jnp.zeros(ffs.shape[1:]))
        return sum(jnp.sum(z * gz) + jnp.sum(v * gv) for z, v in outs), outs

    (_, jouts), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(ffs), jnp.asarray(leak), jnp.asarray(th))
    tin = [torch.tensor(a, requires_grad=True) for a in (ffs, leak, th)]
    with margins() as m:
        touts = run(tlif.sigmoid_lif_step, *tin, torch.zeros(ffs.shape[1:]))
    check(m)
    sum((z * torch.tensor(gz)).sum() + (v * torch.tensor(gv)).sum() for z, v in touts).backward()
    for (jz, jv), (tz, tv) in zip(jouts, touts):
        np.testing.assert_array_equal(tz.detach().numpy(), np.asarray(jz))
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
    for t, g in zip(tin, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)


def test_export_lif_step_matches_reference():
    """Spikes at ``>=`` (one membrane exactly at its threshold), the hard
    zero reset and the raw beta: equal."""
    rng = np.random.default_rng(2)
    x = rng.normal(0.4, 0.5, (B, 4, 4, C)).astype(np.float32)
    mem = rng.normal(0.2, 0.5, x.shape).astype(np.float32)
    beta = rng.uniform(0.5, 1.2, C).astype(np.float32)
    th = rng.uniform(0.2, 0.8, C).astype(np.float32)
    x[0, 0, 0, 0] = th[0] - beta[0] * mem[0, 0, 0, 0]
    js, jm = jlif.export_lif_step(*map(jnp.asarray, (x, mem, beta, th)))
    ts, tm = tlif.export_lif_step(*map(torch.tensor, (x, mem, beta, th)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert ts.sum() > 0


def _cell_params(rng, cin, recurrent):
    p = {"ff": {"kernel": rng.uniform(-1, 1, (3, 3, cin, C)) / np.sqrt(cin)},
         "leak": rng.normal(0.0, 1.0, C), "thresh": rng.uniform(0.05, 0.8, C)}
    if recurrent:
        p["rec"] = {"kernel": rng.uniform(-1, 1, (3, 3, C, C)) / np.sqrt(C)}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


@pytest.mark.parametrize("recurrent", [False, True], ids=["ConvLIF", "ConvLIFRecurrent"])
@pytest.mark.parametrize("hard_reset", [True, False], ids=["hard", "soft"])
def test_cell_matches_reference(recurrent, hard_reset):
    """Three steps of a cell (Cin=2, counts in), state carried: membranes
    within atol 1e-5, spikes equal; the feedforward cell with a residual."""
    rng = np.random.default_rng(3)
    params = _cell_params(rng, 2, recurrent)
    kw = dict(activation="trianglespike", act_width=2.0, hard_reset=hard_reset,
              leak=(0.0, 1.0), thresh=(0.0, 0.8))
    jcell = (jcells.ConvLIFRecurrent if recurrent else jcells.ConvLIF)(2, C, **kw)
    tcell = (tcells.ConvLIFRecurrent if recurrent else tcells.ConvLIF)(2, C, **kw)
    sd = {"ff.weight": torch.tensor(params["ff"]["kernel"].transpose(3, 2, 0, 1)),
          "leak": torch.tensor(params["leak"]).reshape(C, 1, 1),
          "thresh": torch.tensor(params["thresh"]).reshape(C, 1, 1)}
    if recurrent:
        sd["rec.weight"] = torch.tensor(params["rec"]["kernel"].transpose(3, 2, 0, 1))
    tcell.load_state_dict(sd)
    resid = {} if recurrent else {"residual": 0.5}
    js = ts = None
    with margins() as m:
        for _ in range(3):
            x = counts(rng, (B, H, W, 2))
            jo, js = jcell.apply({"params": params}, jnp.asarray(x), js, **resid)
            with torch.no_grad():
                to, ts = tcell(torch.tensor(x), ts, **resid)
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
            np.testing.assert_allclose(ts.mem.numpy(), np.asarray(js.mem), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(ts.spk.numpy(), np.asarray(js.spk))
    check(m)
    assert 0 < float(ts.spk.mean()) < 1


BUILDERS = ["LIFFireNet", "LIFFireNet_short", "LIFFireFlowNet", "LIFFireFlowNet_short"]


def sigmoid_cfg(name, activation="superspike", **extra):
    sn = {"leak": [0.0, 1.0], "thresh": [0.0, 0.8], "act_width": 5.0}
    return model_cfg(name, cell_family="sigmoid", activations=[activation, activation],
                     spiking_neuron=sn, **extra)


@pytest.mark.parametrize("name,activation,seed", [
    ("LIFFireNet", "superspike", 7), ("LIFFireNet_short", "arctanspike", 4),
    ("LIFFireFlowNet", "mgspike", 9), ("LIFFireFlowNet_short", "trianglespike", 6)])
def test_sigmoid_firenet_matches_reference(name, activation, seed):
    """The registry builds each builder with ``cell_family: sigmoid``; three
    windows with the state carried: flow and every membrane within atol
    1e-5, every unit's spikes equal, every unit firing."""
    cfg = sigmoid_cfg(name, activation)
    jm, v = seeded_flax_firenet(cfg, seed=seed)
    tm = build_model(cfg, device="cpu")
    assert tm.cell_family == "sigmoid" and type(tm.head).__name__ == "ConvLIF"
    assert tm.head.activation == activation and tm.head.act_width == 5.0
    tm.load_state_dict(from_jax_variables(v))
    rng = np.random.default_rng(seed)
    js = ts = None
    with margins() as m:
        for _ in range(3):
            x = counts(rng, (B, H, W, 2))
            jo, js = jm.apply(v, None, jnp.asarray(x), js)
            with torch.no_grad():
                to, ts = tm(None, torch.tensor(x), ts)
            np.testing.assert_allclose(to["flow"][0].numpy(), np.asarray(jo["flow"][0]),
                                       rtol=0, atol=1e-5)
            for a, b in zip(js, ts):
                np.testing.assert_allclose(b.mem.numpy(), np.asarray(a.mem), rtol=0, atol=1e-5)
                np.testing.assert_array_equal(b.spk.numpy(), np.asarray(a.spk))
    check(m)
    assert all(float(s.spk.mean()) > 0 for s in ts)


def test_sigmoid_cells_take_no_state_quant():
    """``state_quant`` reaches the snn cells only (the sigmoid cells have
    no membrane quant in the reference either); the conv hooks reach both."""
    from evflow_torch.quant.fake_quant import dynamic_conv_quant, state_quant_fn

    sq, cq = state_quant_fn(), dynamic_conv_quant()
    sig = build_model(sigmoid_cfg("LIFFireNet_short"), device="cpu").set_quant(
        state_quant=sq, conv_fake_quant=cq)
    snn = build_model(model_cfg("LIFFireNet_short"), device="cpu").set_quant(
        state_quant=sq, conv_fake_quant=cq)
    assert not hasattr(sig.head, "state_quant") and sig.G1.conv_fake_quant is cq
    assert snn.head.state_quant is sq and snn.pred.conv_fake_quant is cq
    with pytest.raises(ValueError, match="cell_family"):
        build_model(model_cfg("LIFFireNet", cell_family="relu"), device="cpu")
