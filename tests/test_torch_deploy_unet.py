"""The UNet int8 serving engine (``evflow_torch/deploy_unet.py``) against
the reference's ``evflow.deploy_unet`` on the CPU, at small size (base 4
channels, 4 encoders, B=2, 32x32, seeded weights in which every state slot
fires).

Bars. The prepared tensors (int8 kernels, scales, ``in_scale``, the phase
kernels) bit-equal to the reference's. Over 3 windows, for each compute
tier with bf16 membranes, the int8 tier with f32 ones, and the phase
decoders: ``probes.unet_step.engine_agreement``, bit-equal or spikes agreeing on all but 1e-5 of each
slot's elements, membranes within one bf16 ulp where they agree, flows
within 1e-4 (the packages' ``sigmoid`` and ``tanh`` differ in the last f32
bits; bf16 membranes come out bit-equal). Against the port's own fake-quant
twin, ``tests/test_deploy_unet.py:63-93``'s bar; the hybrid dy-pack
branch, the phase decoders' interior and their slot independence as
``tests/test_deploy_unet.py:96-186`` hold the reference's. Artifacts cross
both ways; every refusal of ``tests/test_deploy_unet.py:207-227``;
``evaluate`` per window equals ``chunk=3``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import port_unet, seeded_flax_unet, unet_cfg
from evflow import deploy_unet as JD
from evflow_torch import deploy_unet as PD
from evflow_torch.probes.unet_step import engine_agreement, run_engine

B, H, W = 2, 32, 32


@pytest.fixture(scope="module")
def net():
    """(flax model, variables, port model, 3 windows)."""
    jm, v = seeded_flax_unet(unet_cfg(), B, H, W, seed=3)
    rng = np.random.default_rng(4)
    wins = [rng.poisson(0.5, (B, H, W, 2)).astype(np.float32) for _ in range(3)]
    return jm, v, port_unet(unet_cfg(), v), wins


@pytest.fixture(scope="module")
def init_net():
    """The port model in its own init distributions (flax's: small kernels,
    leaks N(-4, 0.1), thresholds 0.8, flow heads U(-0.01, 0.01)), from a
    torch seed, as ``tests/test_deploy_unet.py`` runs the reference's."""
    from evflow_torch.registry import build_model

    torch.manual_seed(3)
    return build_model(unet_cfg(), device="cpu")


_COMPILED = {}


def run_reference(je, wins):
    """The reference engine over ``wins``, as one compiled step that rounds
    every bf16 op as the eager ``apply`` does: XLA's CPU fusions would
    otherwise carry the dy-pack epilogue's bf16 chain in f32
    (``xla_allow_excess_precision``) and compute another function. The
    step reads its weights from its argument, so engines of one
    configuration share one compile."""
    st = je.init_states(*wins[0].shape[:3])
    key = (je.compute, je.mem_dtype, je.phase_decoders, je.dypack_min_spatial, wins[0].shape)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(lambda p, x, s: je.apply(p, None, x, s)).lower(
            je.params, jnp.asarray(wins[0]), st).compile({"xla_allow_excess_precision": False})
    step = _COMPILED[key]
    out = []
    for x in wins:
        o, st = step(je.params, jnp.asarray(x), st)
        out.append(([np.asarray(f) for f in o["flow"]],
                    [(np.asarray(s.mem, np.float32), np.asarray(s.spk, np.float32))
                     for s in st]))
    return out


def flat_params(tree, prefix=""):
    """``{path: array}`` of an engine's ``params`` tree (either package's)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat_params(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat_params(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("compute,phase", [("int8", True), ("bfloat16", False)])
def test_prepared_tensors_equal_reference(net, compute, phase):
    """Every prepared tensor of the reference's engine (phase kernels
    included), bit for bit and dtype for dtype."""
    jm, v, pm, _ = net
    jp = flat_params(JD.Int8UNetEngine(jm, v, compute=compute, phase_decoders=phase).params)
    pp = flat_params(PD.Int8UNetEngine(pm, compute=compute, phase_decoders=phase).params)
    assert set(jp) == set(pp)
    for k, a in jp.items():
        b = pp[k]
        assert str(np.asarray(a).dtype) == str(b.dtype).replace("torch.", ""), k
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy()), k


# every tier with the serving membranes (bf16), f32 membranes on the int8
# GEMMs, and the phase decoders
ENGINE_CASES = [(c, "bfloat16", False) for c in PD.COMPUTE_TIERS] + [
    ("int8", "float32", False), ("hybrid", "bfloat16", True)]


@pytest.mark.parametrize("compute,mem,phase", ENGINE_CASES)
def test_engine_matches_reference(net, compute, mem, phase):
    """The port's engine against the reference's over 3 windows (the hybrid
    tiers with their dy-pack crossover at 8, so that both branches run)."""
    jm, v, pm, wins = net
    je = JD.Int8UNetEngine(jm, v, mem_dtype=mem, compute=compute, phase_decoders=phase)
    pe = PD.Int8UNetEngine(pm, mem_dtype=mem, compute=compute, phase_decoders=phase)
    je.dypack_min_spatial = pe.dypack_min_spatial = 8
    rec = engine_agreement(run_reference(je, wins), run_engine(pe, wins))
    assert rec["ok"], rec
    assert rec["spike_share_differ"] == 0.0
    if mem == "bfloat16":
        assert rec["mem_max_bf16_ulps"] == 0
    states = run_engine(pe, wins[:1])[0][1]
    assert all(z.dtype == (torch.int8 if compute in ("int8", "hybrid8") else torch.bfloat16)
               for _, z in states)
    assert min(float(z.float().mean()) for _, z in states) > 0


@pytest.fixture(scope="module")
def reference_twin_gap(net, init_net, tmp_path_factory):
    """The reference's own first-window gap between its int8 engine and its
    fake-quant twin (``quantize_unet_weights``) on the init model's weights,
    per flow scale."""
    from evflow.registry import build_model as build_jax_model
    from evflow.utils.checkpoint import import_torch_checkpoint

    path = str(tmp_path_factory.mktemp("twin") / "init.pth")
    torch.save(init_net.state_dict(), path)
    jm = build_jax_model(unet_cfg())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), None, jnp.zeros((B, H, W, 2)),
                            jm.init_states(B, H, W))
    v, _ = import_torch_checkpoint(path, jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), dict(shapes)))
    je = JD.Int8UNetEngine(jm, v, mem_dtype="float32", compute="int8")
    je.dypack_min_spatial = 8  # the int8 tier never reads it: share the case's compile
    x = jnp.asarray(net[3][0])
    twin, _ = jax.jit(jm.apply)({"params": JD.quantize_unet_weights(jm, v["params"])}, None, x,
                                jm.init_states(B, H, W))
    eng = run_reference(je, net[3][:1])[0][0]
    return [float(np.abs(np.asarray(a) - b).max()) for a, b in zip(twin["flow"], eng)]


@pytest.mark.parametrize("compute", PD.COMPUTE_TIERS)
def test_engine_matches_its_fake_quant_twin(net, init_net, reference_twin_gap, compute):
    """f32 membranes, the init model: the engine against the port's f32
    model on the engine's own dequantised kernels (``quantize_unet_weights``):
    >99.5% of every flow within 0.02 at each of 6 windows. The reference's
    test also holds its first window within 1e-4; on these weights the
    reference's own engine misses its twin there by a spike flipped by f32
    rounding, so the port's first-window gap is held to the reference's
    (within 1e-6)."""
    from evflow_torch.registry import build_model

    wins, pm = net[3], init_net
    twin = build_model(unet_cfg(), device="cpu")
    twin.load_state_dict(PD.quantize_unet_weights(pm))
    engine = PD.Int8UNetEngine(pm, mem_dtype="float32", compute=compute)
    rng = np.random.default_rng(5)
    more = wins + [rng.poisson(0.4, (B, H, W, 2)).astype(np.float32) for _ in range(3)]
    for t, ((ff, _), (fe, _)) in enumerate(zip(run_engine(twin, more), run_engine(engine, more))):
        for s, (a, b) in enumerate(zip(ff, fe)):
            d = (a - b).abs()
            assert float((d < 0.02).float().mean()) > 0.995, t
            if t == 0:
                assert float(d.max()) <= reference_twin_gap[s] + 1e-6, (s, reference_twin_gap)


def test_hybrid_dypack_branch_on_every_layer(net, init_net):
    """At ``dypack_min_spatial=2`` every stride-1 conv rides the dy-packed
    GEMM (a bf16 Z): the flows agree with the uniform bf16 tier on >99% of
    the pixels within 0.02."""
    wins, pm = net[3], init_net
    ebf = PD.Int8UNetEngine(pm, mem_dtype="float32", compute="bfloat16")
    ehy = PD.Int8UNetEngine(pm, mem_dtype="float32", compute="hybrid", dypack_min_spatial=2)
    for (fb, _), (fh, _) in zip(run_engine(ebf, wins), run_engine(ehy, wins)):
        for a, b in zip(fb, fh):
            assert float(((a - b).abs() < 0.02).float().mean()) > 0.99


def test_phase_decoders_interior_and_slots(net, init_net):
    """The folded decoders reproduce the resize path away from the border
    frame (>99% within 0.02 inside an 8 px frame, the init model); B=2
    equals two B=1 runs bit for bit (the seeded model, every slot firing:
    the phase-stacked carries mix no slots)."""
    wins = net[3]
    e_rs = PD.Int8UNetEngine(init_net, mem_dtype="float32")
    e_ph = PD.Int8UNetEngine(init_net, mem_dtype="float32", phase_decoders=True)
    for (fr, _), (fp, _) in zip(run_engine(e_rs, wins), run_engine(e_ph, wins)):
        for a, b in zip(fr, fp):
            d = (a - b).abs()[:, 8:-8, 8:-8]
            assert float((d < 0.02).float().mean()) > 0.99
    e_ph = PD.Int8UNetEngine(net[2], mem_dtype="float32", phase_decoders=True)
    both = run_engine(e_ph, wins[:3])
    for slot in range(B):
        solo = run_engine(e_ph, [w[slot:slot + 1] for w in wins[:3]])
        for (f2, s2), (f1, s1) in zip(both, solo):
            assert all(torch.equal(a[slot:slot + 1], b) for a, b in zip(f2, f1))
            assert all(torch.equal(m2[slot:slot + 1], m1) and torch.equal(z2[slot:slot + 1], z1)
                       for (m2, z2), (m1, z1) in zip(s2, s1))


def test_artifacts_cross_both_ways(net, tmp_path):
    """A reference-written artifact (phase decoders, int8 tier) runs in the
    port bit-equal to the port's own engine of the same weights; a
    port-written one (hybrid, serving dict) loads in the reference with its
    prepared tensors equal, and in the port again unchanged."""
    jm, v, pm, wins = net
    je = JD.Int8UNetEngine(jm, v, compute="int8", phase_decoders=True)
    path = JD.save_unet_engine(je, str(tmp_path / "ref"))
    pe = PD.Int8UNetEngine.from_artifact(pm, path)
    assert (pe.compute, pe.phase_decoders, pe.mem_dtype) == ("int8", True, "bfloat16")
    own = PD.Int8UNetEngine(pm, compute="int8", phase_decoders=True)
    for (fa, sa), (fb, sb) in zip(run_engine(pe, wins[:2]), run_engine(own, wins[:2])):
        assert all(torch.equal(a, b) for a, b in zip(fa, fb))
        assert all(torch.equal(a, c) and torch.equal(b, d) for (a, b), (c, d) in zip(sa, sb))

    port = PD.Int8UNetEngine(pm, compute="hybrid")
    port.serving = {"chunk": 4}
    ppath = PD.save_unet_engine(port, str(tmp_path / "port"))
    assert ppath.endswith(".npz")
    je2 = JD.Int8UNetEngine.from_artifact(jm, ppath)
    assert (je2.compute, je2.phase_decoders, je2.serving) == ("hybrid", False, {"chunk": 4})
    ref = flat_params(JD.Int8UNetEngine(jm, v, compute="hybrid").params)
    got = flat_params(je2.params)
    assert set(ref) == set(got)
    assert all(np.array_equal(np.asarray(ref[k], np.float32), np.asarray(got[k], np.float32))
               for k in ref)
    back = PD.Int8UNetEngine.from_artifact(pm, ppath)
    assert back.serving == {"chunk": 4}
    assert all(torch.equal(a, b) for a, b in zip(back.buffers(), port.buffers()))


def test_refusals(net, tmp_path):
    """The reference's refusals (a FireNet, norm_input, voxels without an
    input scale, int8 membranes, an unknown tier, residual blocks past the
    1/16 grid, an artifact of another net), the tensor-parallel step naming
    its item, and the FireNet engine on a UNet artifact naming this one."""
    from evflow_torch.deploy import Int8DeployEngine
    from evflow_torch.registry import build_model

    _, _, pm, _ = net
    fire = build_model({"name": "LIFFireNet_short", "num_bins": 2, "base_num_channels": 8},
                       device="cpu")
    for model, kw, match in (
            (fire, {}, "FireNet"),
            (build_model(unet_cfg(norm_input=True), device="cpu"), {}, "norm_input"),
            (build_model(unet_cfg(norm="group"), device="cpu"), {}, "normalized"),
            (build_model(unet_cfg(encoding="voxel"), device="cpu"), {}, "input_scale"),
            (pm, {"mem_dtype": "int8"}, "mem_dtype"),
            (pm, {"compute": "float16"}, "compute")):
        with pytest.raises(ValueError, match=match):
            PD.Int8UNetEngine(model, **kw)
    deep = build_model(unet_cfg(), device="cpu")
    deep.num_residual_blocks = 7
    with pytest.raises(ValueError, match="residual blocks"):
        PD.Int8UNetEngine(deep)
    path = PD.save_unet_engine(PD.Int8UNetEngine(pm), str(tmp_path / "e.npz"))
    small = build_model(unet_cfg(), device="cpu")
    small.num_encoders = 3
    with pytest.raises(ValueError, match="encoder"):
        PD.Int8UNetEngine.from_artifact(small, path)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        PD.Int8UNetEngine(pm).tp_jit_step(None)
    with pytest.raises(ValueError, match="Int8UNetEngine"):
        Int8DeployEngine.from_artifact(fire, path)


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    from evflow_torch.data.synthetic import make_dataset

    root = str(tmp_path_factory.mktemp("unet_eval"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.3, flows=[(12.0, -6.0), (-8.0, 4.0)])
    return root


def test_evaluate_per_window_equals_chunks(net, eval_set):
    """Under ``evaluate`` (configs/eval_MVSEC.yml's settings at 16x16 from
    32x32 counts, both sequences, rollovers included) the engine's chunks of
    3 equal its per-window run, and so do the f32 model's; the metrics are
    finite."""
    from _torch_port import eval_config
    from evflow_torch.eval import evaluate

    _, _, pm, _ = net
    cfg = eval_config(eval_set, res=16, std=32)
    cfg["model"] = unet_cfg()
    for model in (pm, PD.Int8UNetEngine(pm, input_scale=0.25, compute="int8")):
        window = evaluate(cfg, model=model, device="cpu", debug=True)
        chunked = evaluate(cfg, model=model, device="cpu", debug=True, chunk=3)
        assert window == chunked
        assert len(window["AEE"]) == 2
        assert np.isfinite([float(x) for m in window.values() for x in m.values()]).all()
