"""The UNet family of the port (``evflow_torch/models/unet.py``,
``models/ann.py``, the sigmoid cells' ``stride`` and ``norm``) against the
reference package's on the CPU, at small size (base 4 channels, 4
encoders, B=2, 32x32 and 20x28, which pads to 32x32 and crops back).

Bars: ``SpikingRecEVFlowNet``'s four multires flows and its 16 state
slots within 1e-5 of ``evflow.models.unet``'s over 3 windows, spikes
equal, and a guard on every element of every membrane: its distance to the
threshold at least 10x its own difference between the two packages, so
that no spike decision is left to conv rounding. The ANN UNets and every
``ann.py`` module within 1e-5 (rtol 1e-5). A reference-layout ``.pth``
(``tests/_torch_ref.py::MirrorEVFlowNet``) loads with ``strict=True`` and
gives the mirror's flows; port weights cross into flax through
``import_torch_checkpoint`` and back unchanged.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref as tref
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import port_unet, run_flax_unet, seeded_flax_unet, unet_cfg, unet_draw
from evflow.models import ann as JA
from evflow.models import unet as JU
from evflow.registry import build_model as build_jax_model
from evflow_torch.models import ann as PA
from evflow_torch.models import unet as PU
from evflow_torch.registry import build_model, model_names
from evflow_torch.weights import from_jax_variables

TOL = 1e-5


def cells_in_slot_order(pm):
    u = pm.multires_unetrec
    cells = [c for e in u.encoders for c in (e.conv, e.recurrent_block)]
    cells += [c for r in u.resblocks for c in (r.conv1, r.conv2)]
    return cells + [d.conv2d for d in u.decoders]


CASES = {"32x32": (unet_cfg(), 32, 32), "pad_20x28": (unet_cfg(), 20, 28)}


@pytest.fixture(scope="module")
def reference_runs():
    """Per case: (config, variables, 3 windows, the reference's (flows,
    states) a window), computed once."""
    out = {}
    for name, (cfg, H, W) in CASES.items():
        jm, v = seeded_flax_unet(cfg, 2, H, W)
        rng = np.random.default_rng(1)
        wins = [rng.poisson(0.5, (2, H, W, 2)).astype(np.float32) for _ in range(3)]
        out[name] = (cfg, v, wins, run_flax_unet(jm, v, wins))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_spiking_unet_matches_reference(reference_runs, case):
    """Every multires flow and every state slot within 1e-5 of the
    reference's over 3 windows (spikes equal), under the per-element
    spike-margin guard; every slot fires."""
    cfg, v, wins, runs = reference_runs[case]
    pm = port_unet(cfg, v)
    thresholds = [torch.clamp(c.thresh.reshape(-1), min=0.01) for c in cells_in_slot_order(pm)]
    st = pm.init_states(*wins[0].shape[:3])
    for x, (jflows, jstates) in zip(wins, runs):
        with torch.no_grad():
            out, st = pm(None, torch.tensor(x), st)
        assert len(out["flow"]) == 4 and len(st) == pm.num_states == 16
        for jf, pf in zip(jflows, out["flow"]):
            assert pf.shape == jf.shape == (2, *x.shape[1:3], 2)
            np.testing.assert_allclose(pf.numpy(), jf, atol=TOL, rtol=TOL)
        assert_states_match(st, jstates, thresholds)
    assert min(float(s.spk.mean()) for s in st) > 0.02


def assert_states_match(states, ref, thresholds):
    """Membranes within 1e-5, spikes equal, and the guard: every membrane
    element at least 10x its own cross-package difference away from its
    threshold."""
    for (jmem, jspk), s, th in zip(ref, states, thresholds):
        np.testing.assert_allclose(s.mem.numpy(), jmem, atol=TOL, rtol=TOL)
        assert np.array_equal(s.spk.numpy(), jspk)
        margin = (s.mem - th.reshape(-1)).abs()
        noise = (s.mem - torch.from_numpy(jmem)).abs()
        assert bool((margin >= 10 * noise).all()), "a spike decision is within conv noise"


@pytest.mark.parametrize("recurrent", [False, True])
def test_group_norm_cells_match_reference(recurrent):
    """``norm="group"``: the feedforward cell (at stride 2) normalises its
    input, the recurrent one its input and the previous spikes, with flax's
    GroupNorm; 3 steps at B=2, 16x16, under the same bars and guard."""
    from evflow.models.cells import ConvLIF as JConvLIF, ConvLIFRecurrent as JConvLIFRec
    from evflow.ops.lif import LIFState as JLIFState

    rng = np.random.default_rng(9)
    xs = [rng.poisson(0.6, (2, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    kw = dict(leak=(-4.0, 0.1), thresh=(0.8, 0.0), norm="group")
    if recurrent:
        jm, pm = JConvLIFRec(3, 6, 3, **kw), PU.ConvLIFRecurrent(3, 6, 3, **kw)
    else:
        jm, pm = JConvLIF(3, 6, 3, stride=2, **kw), PU.ConvLIF(3, 6, 3, stride=2, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(xs[0]), None)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: unet_draw(rng, p, np.zeros(x.shape)).astype(np.float32), dict(shapes))
    p = v["params"]
    sd = {"ff.weight": torch.tensor(p["ff"]["kernel"].transpose(3, 2, 0, 1).copy()),
          "leak": torch.tensor(p["leak"]).reshape(-1, 1, 1),
          "thresh": torch.tensor(p["thresh"]).reshape(-1, 1, 1)}
    for n in ("norm", "norm_ff", "norm_rec"):
        if n in p:
            sd[f"{n}.weight"], sd[f"{n}.bias"] = (torch.tensor(p[n][k]) for k in ("scale", "bias"))
    if recurrent:
        sd["rec.weight"] = torch.tensor(p["rec"]["kernel"].transpose(3, 2, 0, 1).copy())
    pm.load_state_dict(sd)
    step = jax.jit(jm.apply)
    js = ps = None
    for x in xs:
        with torch.no_grad():
            po, new = pm(torch.tensor(x), ps)
        jo, js = step(v, jnp.asarray(x), JLIFState(*zeros_like_states(tuple(new))) if ps is None
                      else js)
        ps = new
        np.testing.assert_allclose(po.numpy(), np.asarray(jo))
        assert_states_match([ps], [(np.array(js.mem), np.array(js.spk))],
                            [torch.clamp(pm.thresh.reshape(-1), min=0.01)])
    assert 0.02 < float(ps.spk.mean()) < 0.98


def test_stride2_conv_pads_like_torch_not_flax_same():
    """At stride 2 the port's encoder conv pads k//2 on each side, as the
    reference's torch conv and the reference package's strided cell do;
    flax's "SAME" would pad (0, 1) on an even size and shift every tap."""
    rng = np.random.default_rng(0)
    x = rng.poisson(0.7, (1, 16, 16, 2)).astype(np.float32)
    k = rng.uniform(-1, 1, (3, 3, 2, 4)).astype(np.float32)
    cell = PU.ConvLIF(2, 4, 3, stride=2)
    with torch.no_grad():
        cell.ff.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    from evflow_torch.models.cells import conv_nhwc

    with torch.no_grad():
        port = conv_nhwc(torch.tensor(x), cell.ff).numpy()

    def flax_conv(padding):
        return np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (2, 2), padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC")))

    np.testing.assert_allclose(port, flax_conv(((1, 1), (1, 1))), atol=TOL)
    assert port.shape == (1, 8, 8, 4)
    assert np.abs(port - flax_conv("SAME")).max() > 0.1


@pytest.mark.parametrize("groups", [1, 4])
def test_group_norm_matches_flax(groups):
    """``models.norm.GroupNorm`` is flax's ``nn.GroupNorm`` (eps 1e-6, the
    fast variance), one group (the cells' ``norm``) or one a channel
    (``ConvLayer``'s "IN")."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.poisson(0.4, (2, 6, 5, 4)) + rng.normal(3.0, 0.1, (2, 6, 5, 4))).astype(np.float32)
    m = fnn.GroupNorm(num_groups=groups)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                    "bias": rng.normal(0, 0.1, 4).astype(np.float32)}}
    from evflow_torch.models.norm import GroupNorm

    g = GroupNorm(groups, 4)
    g.load_state_dict({"weight": torch.tensor(v["params"]["scale"]),
                       "bias": torch.tensor(v["params"]["bias"])})
    with torch.no_grad():
        np.testing.assert_allclose(g(torch.tensor(x)).numpy(),
                                   np.asarray(m.apply(v, jnp.asarray(x))), atol=TOL, rtol=TOL)


# -- the ANN modules and UNets -----------------------------------------------------------


def flax_to_port(params, stats=None, resblock_root=False):
    """A flax ANN tree under the port's (the reference's torch) names."""
    out = {}
    plural = {"encoder": "encoders", "resblock": "resblocks", "decoder": "decoders",
              "pred": "preds"}

    def rename(parts):
        res = []
        for i, n in enumerate(parts):
            m = re.fullmatch(r"(encoder|resblock|decoder|pred)(\d+)", n)
            if m:
                res += [plural[m[1]], m[2]]
                continue
            in_res = (resblock_root and i == 0) or (i > 0 and parts[i - 1].startswith("resblock"))
            if n.startswith("BatchNorm_"):
                res.append(f"bn{int(n[10:]) + 1}" if in_res else "norm_layer")
            else:
                res.append({"GroupNorm_0": "norm_layer", "Conv_0": "conv2d", "gates": "Gates",
                            "ConvTranspose_0": "transposed_conv2d"}.get(n, n))
        return ".".join(res)

    def walk(tree, parts, is_stats):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, parts + [k], is_stats)
                continue
            a = np.asarray(v, np.float32)
            pre = rename(parts)
            norm = parts[-1].startswith(("BatchNorm_", "GroupNorm_"))
            if is_stats:
                stat = {"mean": "running_mean", "var": "running_var"}[k]
                out[f"{pre}.{stat}"] = torch.tensor(a)
                out[f"{pre}.num_batches_tracked"] = torch.tensor(0)
            elif k == "kernel":
                # HWIO -> OIHW; a transpose_kernel ConvTranspose's [kh, kw, out, in] is
                # ConvTranspose2d's [in, out, kh, kw] by the same transpose
                out[f"{pre}.weight"] = torch.tensor(a.transpose(3, 2, 0, 1).copy())
            else:
                out[f"{pre}.{'weight' if norm and k == 'scale' else k}"] = torch.tensor(a)

    walk(params, [], False)
    walk(stats or {}, [], True)
    return out


def seeded_flax(module, *args, seed=0):
    """Seeded variables of a flax module (shapes by ``jax.eval_shape``, no
    init run): kernels ``U(-1, 1) * sqrt(3 / fan_in)``, biases N(0, 0.1),
    norm scales U(0.8, 1.2), batch statistics mean N(0, 0.1) and var
    U(0.5, 1.5), so that eval-mode BN is not the identity."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, x):
        last = path[-1].key
        if last == "kernel":
            a = rng.uniform(-1, 1, x.shape) * math.sqrt(3.0 / np.prod(x.shape[:-1]))
        elif last in ("bias", "mean"):
            a = rng.normal(0, 0.1, x.shape)
        elif last == "scale":
            a = rng.uniform(0.8, 1.2, x.shape)
        else:
            a = rng.uniform(0.5, 1.5, x.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("size", [(5, 7), (6, 4)])
def test_upsample2x_bilinear_matches_jax_image_resize(size):
    """Edges and odd sizes included."""
    x = np.random.default_rng(3).normal(0, 1, (2, *size, 3)).astype(np.float32)
    close(PA.upsample2x_bilinear(torch.tensor(x)).numpy(), JA.upsample2x_bilinear(jnp.asarray(x)))


ANN_LAYERS = {
    "conv_relu": (lambda: JA.ConvLayer(6, 3, 1), lambda: PA.ConvLayer(3, 6, 3, 1)),
    "conv_s2_bn_tanh": (lambda: JA.ConvLayer(6, 3, 2, activation="tanh", norm="BN"),
                        lambda: PA.ConvLayer(3, 6, 3, 2, activation="tanh", norm="BN")),
    "conv_in_sigmoid": (lambda: JA.ConvLayer(6, 5, 1, activation="sigmoid", norm="IN"),
                        lambda: PA.ConvLayer(3, 6, 5, 1, activation="sigmoid", norm="IN")),
    "conv_1x1_none_wscale": (lambda: JA.ConvLayer(2, 1, activation=None, w_scale=0.01),
                             lambda: PA.ConvLayer(3, 2, 1, activation=None, w_scale=0.01)),
    "transposed_bn": (lambda: JA.TransposedConvLayer(5, 3, norm="BN"),
                      lambda: PA.TransposedConvLayer(3, 5, 3, norm="BN")),
    "transposed_k5": (lambda: JA.TransposedConvLayer(5, 5),
                      lambda: PA.TransposedConvLayer(3, 5, 5)),
    "upsample_bn": (lambda: JA.UpsampleConvLayer(5, 3, norm="BN"),
                    lambda: PA.UpsampleConvLayer(3, 5, 3, norm="BN")),
    "residual_bn": (lambda: JA.ResidualBlock(3, norm="BN"),
                    lambda: PA.ResidualBlock(3, 3, norm="BN")),
    "residual": (lambda: JA.ResidualBlock(3), lambda: PA.ResidualBlock(3, 3)),
}


@pytest.mark.parametrize("name", sorted(ANN_LAYERS))
def test_ann_layer_matches_reference(name):
    make_j, make_p = ANN_LAYERS[name]
    x = np.random.default_rng(4).normal(0, 1, (2, 7, 6, 3)).astype(np.float32)
    jm, pm = make_j(), make_p()
    v = seeded_flax(jm, jnp.asarray(x))
    pm.load_state_dict(flax_to_port(v["params"], v.get("batch_stats"),
                                    resblock_root=name.startswith("residual")))
    with torch.no_grad():
        got = pm.eval()(torch.tensor(x))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    for a, b in zip(*(([got], [ref]) if not name.startswith("residual") else (got, ref))):
        assert a.shape == b.shape
        close(a.numpy(), b)


def test_conv_layer_stateful_matches_reference():
    x = np.random.default_rng(5).normal(0, 1, (2, 6, 6, 3)).astype(np.float32)
    r = np.random.default_rng(6).normal(0, 1, (2, 6, 6, 4)).astype(np.float32)
    jm, pm = JA.ConvLayerStateful(4, 3, norm="BN"), PA.ConvLayerStateful(3, 4, 3, norm="BN")
    v = seeded_flax(jm, jnp.asarray(x))
    pm.load_state_dict(flax_to_port(v["params"], v["batch_stats"]))
    with torch.no_grad():
        out, st = pm.eval()(torch.tensor(x), None, residual=torch.tensor(r))
    jo, js = jm.apply(v, jnp.asarray(x), None, residual=jnp.asarray(r))
    close(out.numpy(), jo)
    assert float(st) == float(js) == 0.0


def zeros_like_states(states):
    """Zero numpy arrays shaped as a port state tree (tensors, tuples)."""
    return jax.tree_util.tree_map(lambda t: np.zeros(t.shape, np.float32), states)


@pytest.mark.parametrize("kind", ["convlstm", "convgru", "convrnn"])
def test_recurrent_conv_layer_matches_reference(kind):
    """The strided ConvLayer and the recurrent block over 3 steps, state
    carried (the port's first step from None, the reference's from zeros)."""
    rng = np.random.default_rng(7)
    xs = [rng.normal(0, 1, (2, 8, 6, 3)).astype(np.float32) for _ in range(3)]
    jm = JA.RecurrentConvLayer(5, 3, stride=2, recurrent_block_type=kind, norm="BN")
    pm = PA.RecurrentConvLayer(3, 5, 3, stride=2, recurrent_block_type=kind, norm="BN")
    v = seeded_flax(jm, jnp.asarray(xs[0]), None)
    pm.load_state_dict(flax_to_port(v["params"], v["batch_stats"]))
    step = jax.jit(jm.apply)
    js = ps = None
    for x in xs:
        with torch.no_grad():
            po, new = pm.eval()(torch.tensor(x), ps)
        jo, js = step(v, jnp.asarray(x), zeros_like_states(new) if ps is None else js)
        ps = new
        close(po.numpy(), jo)
        for a, b in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(ps)):
            close(b.numpy(), a)


ANN_UNETS = {
    "unetrec_convlstm_bn": (JU.UNetRecurrent, PU.UNetRecurrent,
                            dict(recurrent_block_type="convlstm", norm="BN", kernel_size=3)),
    "multires_in": (JU.MultiResUNet, PU.MultiResUNet, dict(norm="IN", final_activation="tanh")),
    "multiresrec_convgru": (JU.MultiResUNetRecurrent, PU.MultiResUNetRecurrent,
                            dict(recurrent_block_type="convgru")),
    "multiresrec_convrnn_bn": (JU.MultiResUNetRecurrent, PU.MultiResUNetRecurrent,
                               dict(recurrent_block_type="convrnn", norm="BN")),
}


@pytest.mark.parametrize("name", sorted(ANN_UNETS))
def test_ann_unet_matches_reference(name):
    """Base 4, 4 encoders, 2 residual blocks at 32x32, B=2; the recurrent
    ones over 2 windows with their states carried (the port's first from
    None, the reference's from zeros)."""
    jcls, pcls, kw = ANN_UNETS[name]
    rng = np.random.default_rng(8)
    xs = [rng.poisson(0.5, (2, 32, 32, 2)).astype(np.float32) for _ in range(2)]
    jm, pm = jcls(2, base_num_channels=4, **kw), pcls(2, base_num_channels=4, **kw)
    recurrent = jcls is not JU.MultiResUNet
    v = seeded_flax(jm, *((jnp.asarray(xs[0]), None) if recurrent else (jnp.asarray(xs[0]),)))
    pm.load_state_dict(flax_to_port(v["params"], v.get("batch_stats")))
    pm.eval()
    step = jax.jit(jm.apply)
    js = ps = None
    for x in xs if recurrent else xs[:1]:
        with torch.no_grad():
            po = pm(torch.tensor(x), ps) if recurrent else pm(torch.tensor(x))
        if recurrent:
            po, new = po
            jo, js = step(v, jnp.asarray(x), zeros_like_states(new) if ps is None else js)
            ps = new
        else:
            jo = step(v, jnp.asarray(x))
        jl, pl = jax.tree_util.tree_leaves(jo), jax.tree_util.tree_leaves(po)
        assert len(jl) == len(pl) and len(pl) in (1, 4)
        for a, b in zip(jl, pl):
            close(b.numpy(), a)


def test_spiking_transposed_layer_raises_as_the_reference():
    with pytest.raises(NotImplementedError, match="matches reference"):
        PU.SpikingTransposedConvLayer(4, 4)(None)


# -- checkpoints and the registry ------------------------------------------------------


def test_reference_pth_loads_strict_and_gives_the_mirrors_flows(tmp_path):
    """A ``MirrorEVFlowNet`` (the reference's torch module names)
    ``.pth``: ``load_state_dict(strict=True)`` takes it as it is (its
    ``act_width`` buffers checked), and the port's four flows equal the
    mirror's over 3 windows (atol 2e-5, the mirror parity test's), no
    mirror membrane within 1e-5 of its threshold."""
    from evflow_torch.weights import load_checkpoint

    torch.manual_seed(41)
    tm = tref.MirrorEVFlowNet(num_bins=2, base_num_channels=4)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, tref.MirrorConvLIF):
                m.leak.copy_(torch.randn_like(m.leak) * 0.5 - 2.0)
                m.thresh.copy_(torch.rand_like(m.thresh) * 0.5 + 0.3)
    path = str(tmp_path / "unet.pth")
    torch.save({"model_state_dict": tm.state_dict()}, path)
    pm = build_model(unet_cfg(), device="cpu")
    pm.load_state_dict(load_checkpoint(path), strict=True)
    tm.eval()
    tm.reset_states()
    rng = np.random.default_rng(42)
    tref.SPIKE_MARGINS.clear()
    st = None
    for _ in range(3):
        cnt = rng.poisson(0.4, (1, 32, 32, 2)).astype(np.float32)
        with torch.no_grad():
            tflows = tm(torch.tensor(cnt).permute(0, 3, 1, 2))
            out, st = pm(None, torch.tensor(cnt), st)
        for tf, pf in zip(tflows, out["flow"]):
            np.testing.assert_allclose(pf.numpy(), tf.permute(0, 2, 3, 1).numpy(), atol=2e-5)
    assert min(tref.SPIKE_MARGINS) > 1e-5
    bad = dict(tm.state_dict())
    bad["multires_unetrec.encoders.0.conv.act_width"] = torch.tensor(5.0)
    with pytest.raises(ValueError, match="surrogate width"):
        pm.load_state_dict(bad)


def test_port_weights_cross_into_flax_and_back(reference_runs, tmp_path):
    """``import_torch_checkpoint`` takes a port UNet's ``.pth`` into the
    flax tree; ``from_jax_variables`` gives the same state dict back."""
    from evflow.utils.checkpoint import import_torch_checkpoint

    cfg, v, _, _ = reference_runs["32x32"]
    pm = port_unet(cfg, v)
    path = str(tmp_path / "port.pth")
    torch.save(pm.state_dict(), path)
    jm = build_jax_model(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1), None, jnp.zeros((1, 32, 32, 2)),
                            jm.init_states(1, 32, 32))
    jv, leftover = import_torch_checkpoint(path, jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), dict(shapes)))
    assert leftover == []
    back = from_jax_variables(jv)
    sd = pm.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_registry_builds_the_unet_with_the_reference_keys():
    """``model_names`` lists it; the registry reads the reference's keys."""
    assert "SpikingRecEVFlowNet" in model_names()
    m = build_model(unet_cfg(base_num_channels=8, norm="group", encoding="voxel",
                             norm_input=True, spiking_neuron={
                                 "leak": [-3.0, 0.1], "thresh": [0.5, 0.0], "hard_reset": False,
                                 "learn_leak": False, "detach": False}), device="cpu")
    assert (m.base_num_channels, m.norm, m.encoding, m.norm_input, m.hard_reset) == \
        (8, "group", "voxel", True, False)
    cell = m.multires_unetrec.encoders[0].conv
    assert cell.learn_leak is False and cell.detach is False and cell.norm_type == "group"
    assert torch.allclose(cell.thresh, torch.full_like(cell.thresh, 0.5))
    assert m.unit_names[:2] == ("enc0.conv", "enc0.rec") and len(m.unit_names) == 16


def test_reference_msgpack_run_loads(reference_runs, tmp_path):
    """A reference package's ``model.msgpack`` of the UNet (written by
    ``evflow.utils.checkpoint.save_checkpoint``) reads through the port's
    own reader into the state dict ``from_jax_variables`` gives."""
    from evflow.utils.checkpoint import save_checkpoint
    from evflow_torch.weights import load_checkpoint

    cfg, v, _, _ = reference_runs["32x32"]
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, {"params": v["params"], "batch_stats": {}, "opt_state": None,
                        "epoch": 0, "loss": 0.0, "loss_variance": 0.0})
    got, ref = load_checkpoint(d), from_jax_variables(v)
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    port_unet(cfg, v).load_state_dict(got, strict=True)
