"""Port models against the reference package: FireNet (f32) against the flax
FireNet, FusedFireNet against the JAX FusedFireNet (interpret-mode Pallas)
in both layouts, the refusals of ``from_firenet``, and the weight carry."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import counts, model_cfg, seeded_flax_firenet
from evflow.models.fused import FusedFireNet as JaxFusedFireNet
from evflow.utils.checkpoint import import_torch_checkpoint
from evflow_torch.models.fused import FusedFireNet
from evflow_torch.ops import lif as tlif
from evflow_torch.registry import build_model
from evflow_torch.weights import from_jax_variables

B, H, W = 2, 16, 16


def port_model(cfg, variables):
    m = build_model(cfg, device="cpu")
    m.load_state_dict(from_jax_variables(variables))
    return m


@pytest.mark.parametrize("name", ["LIFFireNet", "LIFFireNet_short"])
def test_firenet_f32_matches_flax(name, monkeypatch):
    """Three windows through both models with the same weights: flow and
    every unit's membrane within 1e-5; spikes equal wherever the port's
    membrane lies more than 1e-5 from the threshold."""
    cfg = model_cfg(name)
    jm, v = seeded_flax_firenet(cfg, seed=1)
    tm = port_model(cfg, v)
    margins = []
    real = tlif.atanspike_snn

    def tracked(u, thresh=0.0, alpha=2.0):
        margins.append((u - thresh).detach())
        return real(u, thresh, alpha)

    monkeypatch.setattr(tlif, "atanspike_snn", tracked)
    rng = np.random.default_rng(2)
    jst, tst = jm.init_states(B, H, W), tm.init_states(B, H, W)
    rates = []
    for t in range(3):
        cnt = counts(rng, (B, H, W, 2))
        jout, jst = jm.apply(v, None, jnp.asarray(cnt), jst, train=False)
        with torch.no_grad():
            tout, tst = tm(None, torch.tensor(cnt), tst)
        np.testing.assert_allclose(tout["flow"][0].numpy(), np.asarray(jout["flow"][0]),
                                   atol=1e-5)
        for i, (js, ts) in enumerate(zip(jst, tst)):
            np.testing.assert_allclose(ts.mem.numpy(), np.asarray(js.mem), atol=1e-5)
            far = margins[t * tm.num_units + i].abs().numpy() > 1e-5
            np.testing.assert_array_equal(ts.spk.numpy()[far], np.asarray(js.spk)[far])
            rates.append(float(ts.spk.mean()))
    assert min(rates) > 0.005, rates  # every unit fires: the comparison means something


@pytest.mark.parametrize("layout", ["nhwc", "cmajor"])
def test_fused_firenet_matches_jax_fused(layout):
    """Two windows through the port's FusedFireNet (plain kernel versions)
    and the JAX FusedFireNet (interpret-mode Pallas): flow within 1e-4,
    per-unit spike agreement >= 0.999."""
    cfg = model_cfg("LIFFireNet")
    jm, v = seeded_flax_firenet(cfg, seed=3)
    jf = JaxFusedFireNet.from_firenet(jm, v, tile_rows=8, layout=layout)
    tf = FusedFireNet.from_firenet(port_model(cfg, v), layout=layout)
    rng = np.random.default_rng(4)
    jst, tst = jf.init_states(B, H, W), tf.init_states(B, H, W)
    assert [tuple(s.mem.shape) for s in tst] == [tuple(s.mem.shape) for s in jst]
    for _ in range(2):
        cnt = counts(rng, (B, H, W, 2))
        with pltpu.force_tpu_interpret_mode():
            jflow, jst = jf.step(jf.params, jnp.asarray(cnt), jst)
        tflow, tst = tf.step(torch.tensor(cnt), tst)
        np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow), atol=1e-4)
        agree = [float((ts.spk.numpy() == np.asarray(js.spk)).mean())
                 for ts, js in zip(tst, jst)]
        assert min(agree) >= 0.999, agree
        np.testing.assert_allclose(tst[0].mem.numpy(), np.asarray(jst[0].mem), atol=1e-5)


def test_fused_scan_windows_matches_steps():
    cfg = model_cfg("LIFFireNet_short")
    _, v = seeded_flax_firenet(cfg, seed=5)
    tf = FusedFireNet.from_firenet(port_model(cfg, v), layout="cmajor")
    wins = torch.tensor(counts(np.random.default_rng(6), (3, 1, H, W, 2)))
    st, flows = tf.scan_windows(wins, tf.init_states(1, H, W))
    st2 = tf.init_states(1, H, W)
    for t in range(3):
        f, st2 = tf.step(wins[t], st2)
        torch.testing.assert_close(flows[t], f, rtol=0, atol=0)
    torch.testing.assert_close(st[-1].mem, st2[-1].mem, rtol=0, atol=0)


@pytest.mark.parametrize("setting", ["norm_input", "mpbn", "sigmoid"])
def test_from_firenet_refuses_other_functions(setting):
    """The fused step has no input normalisation, no membrane BN and only
    snn.Leaky cells: a FireNet with any of them computes another function,
    so folding it is refused rather than silently changing the result."""
    if setting == "sigmoid":
        model = types.SimpleNamespace(cell_family="sigmoid", norm_input=False, mpbn=False)
    else:
        extra = {"norm_input": True} if setting == "norm_input" else {"mpbn": {"enabled": True}}
        model = build_model(model_cfg("LIFFireNet_short", **extra), device="cpu")
    with pytest.raises(ValueError, match="FusedFireNet"):
        FusedFireNet.from_firenet(model)


def reference_state_dict(C=8, ptq_layout=False):
    """A state dict in the reference's key layout (LIFFireNet_short)."""
    rng = np.random.default_rng(0)
    sd = {}
    for u in ("head", "G1", "R1a", "G2", "R2a"):
        cin = 2 if u == "head" else C
        sd[f"{u}.ff.weight"] = torch.tensor(rng.normal(0, 0.1, (C, cin, 3, 3)), dtype=torch.float32)
        if u in ("G1", "G2"):
            sd[f"{u}.rec.weight"] = torch.tensor(rng.normal(0, 0.1, (C, C, 3, 3)),
                                                 dtype=torch.float32)
        prefix = f"{u}." if ptq_layout else f"{u}.lif."
        sd[f"{prefix}beta"] = torch.tensor(rng.uniform(0, 1, (C, 1, 1)), dtype=torch.float32)
        sd[f"{prefix}threshold"] = torch.tensor(rng.uniform(0.1, 0.8, (C, 1, 1)),
                                                dtype=torch.float32)
        for leaf, a in (("weight", rng.uniform(0.5, 2, C)), ("bias", rng.normal(0, 0.1, C)),
                        ("running_mean", rng.normal(0, 0.1, C)),
                        ("running_var", rng.uniform(0.5, 2, C))):
            sd[f"{u}.bn.{leaf}"] = torch.tensor(a, dtype=torch.float32)
        sd[f"{u}.bn.num_batches_tracked"] = torch.tensor(10)
    sd["pred.conv2d.weight"] = torch.tensor(rng.normal(0, 0.01, (2, C, 1, 1)), dtype=torch.float32)
    sd["pred.conv2d.bias"] = torch.zeros(2)
    return sd


@pytest.mark.parametrize("ptq_layout", [False, True])
def test_reference_state_dict_loads(tmp_path, ptq_layout):
    """A reference ``.pth`` state dict, plain or PTQ layout, loads into the
    port as it is, and its forward equals the flax model's on the same file
    imported by the reference package."""
    from evflow_torch.weights import load_checkpoint

    sd = reference_state_dict(ptq_layout=ptq_layout)
    path = str(tmp_path / "model.pth")
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    cfg = model_cfg("LIFFireNet_short")
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(load_checkpoint(path))
    key = "G1.beta" if ptq_layout else "G1.lif.beta"
    torch.testing.assert_close(tm.G1.lif.beta, sd[key])
    jm, v = seeded_flax_firenet(cfg)
    v, _ = import_torch_checkpoint(path, v)
    cnt = counts(np.random.default_rng(7), (1, H, W, 2))
    jout, _ = jm.apply(v, None, jnp.asarray(cnt), jm.init_states(1, H, W), train=False)
    with torch.no_grad():
        tout, _ = tm(None, torch.tensor(cnt))
    np.testing.assert_allclose(tout["flow"][0].numpy(), np.asarray(jout["flow"][0]), atol=1e-5)


@pytest.mark.parametrize("cfg_extra", [{}, {"tebn": {"enabled": True, "num_timesteps": 4}},
                                       {"mpbn": {"enabled": True}}])
def test_from_jax_variables_round_trip(tmp_path, cfg_extra):
    """flax variables -> port state dict -> .pth -> the reference package's
    importer -> flax variables: every leaf comes back unchanged."""
    cfg = model_cfg("LIFFireNet", **cfg_extra)
    jm, v = seeded_flax_firenet(cfg, seed=8)
    tm = build_model(cfg, device="cpu")
    sd = from_jax_variables(v)
    tm.load_state_dict(sd)  # strict: the names and shapes are the port's
    path = str(tmp_path / "port.pth")
    torch.save(tm.state_dict(), path)
    _, blank = seeded_flax_firenet(cfg, seed=9)
    back, leftover = import_torch_checkpoint(path, blank)
    assert all("num_batches_tracked" in k for k in leftover), leftover
    import jax

    flat_a = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path_, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path_]), leaf, err_msg=str(path_))


def test_conv_impl_int8_is_refused():
    """``conv_impl: dypack_int8`` runs every 3x3 conv in int8 in the
    reference; the port has no int8 conv yet, so the config is refused (in
    ``firenet_kwargs`` and ``build_model``) before any model is built or
    kernel launched, instead of silently running f32 convs."""
    from evflow_torch.ops.conv_lif import fused_conv_lif
    from evflow_torch.ops.conv_lif_cmajor import fused_conv_lif_cmajor
    from evflow_torch.registry import firenet_kwargs

    before = (fused_conv_lif.launches, fused_conv_lif_cmajor.launches)
    cfg = model_cfg("LIFFireNet", conv_impl="dypack_int8")
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        firenet_kwargs(cfg)
    with pytest.raises(NotImplementedError, match="dypack_int8"):
        build_model(cfg, device="cpu")
    assert (fused_conv_lif.launches, fused_conv_lif_cmajor.launches) == before


@pytest.mark.parametrize("impl", ["auto", "im2col", "dypack", "lax"])
def test_conv_impl_f32_values_build_the_default_model(impl):
    """The four f32 ``conv_impl`` values compute the same conv: each builds
    a model whose flow and states on a seeded window equal the default's."""
    cfg = model_cfg("LIFFireNet")
    _, v = seeded_flax_firenet(cfg, seed=10)
    ref, tm = port_model(cfg, v), port_model(dict(cfg, conv_impl=impl), v)
    cnt = torch.tensor(counts(np.random.default_rng(11), (B, H, W, 2)))
    with torch.no_grad():
        rout, rst = ref(None, cnt)
        tout, tst = tm(None, cnt)
    assert torch.equal(tout["flow"][0], rout["flow"][0])
    assert all(torch.equal(a.mem, b.mem) and torch.equal(a.spk, b.spk) for a, b in zip(tst, rst))
    assert float(rout["flow"][0].abs().max()) > 0  # a flow, not zeros
