"""The int8 serving engine (``evflow_torch/deploy.py``) against the
reference's ``evflow.deploy`` on the CPU, at small size (B=2, 16x16, 8
channels, seeded numpy weights in which every unit fires).

Bars: the engine's states (membranes and spike carries) bit-equal to the
reference's over 6 windows, the flow within one bf16 ulp, for every
membrane tier with and without ``z_int8``, recurrent and feedforward;
``profile_mem_ranges``, ``profile_mem_scales`` and ``calibrate_z`` equal. Artifacts cross both ways
(and the reference's before ``mem_inv_scale``). On grid weights the engine
tracks the port's f32 FireNet as ``tests/test_deploy.py:88-113`` holds the
reference's. Under ``evaluate`` its chunks equal its per-window run across
sequence rollovers (int8 membranes restart at their zero point, the
feedforward units' spike slots stay None).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import counts, eval_config, model_cfg, seeded_flax_firenet
from evflow import deploy as JD
from evflow.registry import build_model as build_jax_model
from evflow_torch import deploy as PD
from evflow_torch.probes.deploy_step import bf16_ulps
from evflow_torch.registry import build_model
from evflow_torch.weights import from_jax_variables

B, H, W = 2, 16, 16
TIERS = ("bfloat16", "int8", "mixed")


def port_model(cfg, variables):
    m = build_model(cfg, device="cpu")
    m.load_state_dict(from_jax_variables(variables))
    return m


@pytest.fixture(scope="module")
def nets():
    """Per model: (flax model, variables, port model, 6 windows, the port's
    membrane ranges over the first 3)."""
    out = {}
    for name in ("LIFFireNet", "LIFFireFlowNet_short"):
        cfg = model_cfg(name)
        jm, v = seeded_flax_firenet(cfg, seed=1)
        rng = np.random.default_rng(0)
        wins = [counts(rng, (B, H, W, 2)) for _ in range(6)]
        pm = port_model(cfg, v)
        out[name] = (jm, v, pm, wins, PD.profile_mem_ranges(pm, wins[:3]))
    return out


def test_profile_mem_ranges_match_reference(nets):
    """Per channel and per tensor, the port's ranges equal the reference's;
    the symmetric scales of ``profile_mem_scales`` too."""
    jm, v, pm, wins, ranges = nets["LIFFireNet"]
    for (a, b), (c, d) in zip(JD.profile_mem_ranges(jm, v, wins[:3]), ranges):
        assert np.array_equal(a, c) and np.array_equal(b, d) and a.shape == (8,)
    jr = JD.profile_mem_scales(jm, v, wins[:2], per_channel=False)
    pr = PD.profile_mem_scales(pm, wins[:2], per_channel=False)
    assert all(np.array_equal(a, b) and np.shape(a) == () for a, b in zip(jr, pr))


def run_engine(engine, wins, voxel=False, torch_engine=False):
    """``[(flow, states)]`` a window of ``engine`` (the reference's, or the
    port's with ``torch_engine``) over ``wins``: the flow as an f32 torch
    tensor, the states as ``(mem, spk or None)`` pairs."""
    st = engine.init_states(B, H, W)
    out = []
    for x in wins:
        args = (x, None) if voxel else (None, x)
        if torch_engine:
            with torch.no_grad():
                o, st = engine(*(None if a is None else torch.tensor(a) for a in args), st)
            flow = o["flow"][0]
        else:
            o, st = engine.apply(engine.params,
                                 *(None if a is None else jnp.asarray(a) for a in args), st)
            flow = torch.tensor(np.asarray(o["flow"][0]))
        out.append((flow, [(s.mem, s.spk) for s in st]))
    return out


def assert_same_states(ref, got):
    """States bit-equal (values, dtypes, None slots), flows within 1 ulp."""
    for (jf, js), (pf, ps) in zip(ref, got):
        for (jm, jsp), (pm, psp) in zip(js, ps):
            assert np.array_equal(np.asarray(jm).astype(np.float32), pm.float().numpy())
            assert str(np.asarray(jm).dtype) == str(pm.dtype).replace("torch.", "")
            assert (jsp is None) == (psp is None)
            assert jsp is None or np.array_equal(np.asarray(jsp), psp.numpy())
        assert bf16_ulps(pf, jf) <= 1
        assert pf.dtype == torch.float32


def assert_same_run(je, pe, wins, voxel=False):
    """Both engines over ``wins``: states bit-equal, flows within 1 ulp."""
    assert_same_states(run_engine(je, wins, voxel), run_engine(pe, wins, voxel, True))


@pytest.fixture(scope="module")
def reference_runs(nets):
    """One reference engine per (model, tier), run as prepared, then again
    after ``calibrate_z``, over the 6 windows: ``{(name, tier): (engine,
    {z_int8: (prepared units, run)})}``, built at first use and shared by
    the two ``z_int8`` cases."""
    cache = {}

    def get(name, tier):
        if (name, tier) not in cache:
            jm, v, _, wins, ranges = nets[name]
            kw = {"mem_ranges": ranges} if tier != "bfloat16" else {}
            je = JD.Int8DeployEngine(jm, v, mem_dtype=tier, **kw)
            runs = {False: ([dict(u) for u in je.params["units"]], run_engine(je, wins))}
            je.calibrate_z(wins[:2])
            runs[True] = ([dict(u) for u in je.params["units"]], run_engine(je, wins))
            cache[name, tier] = (je, runs)
        return cache[name, tier]

    return get


@pytest.mark.parametrize("z_int8", [False, True], ids=["bf16_z", "int8_z"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", ["LIFFireNet", "LIFFireFlowNet_short"])
def test_engine_matches_reference(nets, reference_runs, name, tier, z_int8):
    """The port's engine against the reference's: every prepared tensor
    (and with ``z_int8`` the calibrated Z scales) equal, then the run."""
    _, _, pm, wins, ranges = nets[name]
    je, runs = reference_runs(name, tier)
    units, ref = runs[z_int8]
    kw = {"mem_ranges": ranges} if tier != "bfloat16" else {}
    pe = PD.Int8DeployEngine(pm, mem_dtype=tier, **kw)
    assert pe.unit_recurrent == je.unit_recurrent and pe.mem_dtype == je.mem_dtype
    if z_int8:
        pe.calibrate_z(wins[:2])
        assert pe.z_int8
    for ju, pu in zip(units, pe.params["units"]):
        assert set(ju) == set(pu)
        for k in ju:
            assert np.array_equal(np.asarray(ju[k]).astype(np.float32), pu[k].float().numpy()), k
    assert_same_states(ref, run_engine(pe, wins, torch_engine=True))


def test_engine_input_scales_match_reference():
    """A voxel model with a calibrated input scale, and pooled counts on
    the 1/4 grid (``input_scale=0.25``)."""
    cfg = model_cfg("LIFFireNet", encoding="voxel")
    jm, v = seeded_flax_firenet(model_cfg("LIFFireNet"), seed=2)
    jm = build_jax_model(cfg)
    rng = np.random.default_rng(3)
    vox = [(rng.random((B, H, W, 2)) * 0.5).astype(np.float32) for _ in range(4)]
    s_in = max(float(np.abs(x).max()) for x in vox) / 127.0
    pm = port_model(cfg, v)
    assert_same_run(JD.Int8DeployEngine(jm, v, input_scale=s_in),
                    PD.Int8DeployEngine(pm, input_scale=s_in), vox, voxel=True)
    jm = build_jax_model(model_cfg("LIFFireNet"))
    raw = rng.poisson(0.4, (4, B, 2 * H, 2 * W, 2)).astype(np.float32)
    pooled = list(raw.reshape(4, B, H, 2, W, 2, 2).mean(axis=(3, 5)))
    assert_same_run(JD.Int8DeployEngine(jm, v, mem_dtype="int8", input_scale=0.25),
                    PD.Int8DeployEngine(port_model(model_cfg("LIFFireNet"), v), mem_dtype="int8",
                                        input_scale=0.25), pooled)


def snap_to_int8_grid(model):
    """Each conv kernel on its per-output-channel int8 grid (recurrent
    units: one scale for ff and rec), as ``tests/test_deploy.py`` snaps."""
    with torch.no_grad():
        for name in model.unit_names:
            cell = getattr(model, name)
            convs = [cell.ff.weight] + ([cell.rec.weight] if hasattr(cell, "rec") else [])
            s = torch.stack([w.abs().amax(dim=(1, 2, 3)) for w in convs]).amax(0)
            s = torch.clamp_min(s, 1e-12)[:, None, None, None] / 127.0
            for w in convs:
                w.copy_(torch.clamp(torch.round(w / s), -127, 127) * s)


def test_engine_matches_f32_on_grid_weights():
    """The reference test's setting (``tests/test_deploy.py:88-113``:
    LIFFireNet_short, flax's init from PRNGKey(3), kernels snapped to the
    int8 grid, integer counts): the engine differs from the port's f32
    FireNet by bf16 rounding only, |dflow| < 0.02 on more than 99.5% of the
    pixels."""
    import jax

    cfg = model_cfg("LIFFireNet_short")
    jm = build_jax_model(cfg)
    v = jax.device_get(dict(jm.init(jax.random.PRNGKey(3), None, jnp.zeros((B, H, W, 2)),
                                    jm.init_states(B, H, W))))
    model = port_model(cfg, v)
    snap_to_int8_grid(model)
    engine = PD.Int8DeployEngine(model)
    fs, es = model.init_states(B, H, W), engine.init_states(B, H, W)
    rng = np.random.default_rng(0)
    agree = []
    with torch.no_grad():
        for _ in range(6):
            x = torch.tensor(rng.poisson(0.3, (B, H, W, 2)).astype(np.float32))
            fo, fs = model(None, x, fs)
            eo, es = engine(None, x, es)
            agree.append(float(((fo["flow"][0] - eo["flow"][0]).abs() < 0.02).float().mean()))
    assert np.mean(agree) > 0.995


def test_artifacts_cross_both_ways(nets, tmp_path):
    """The reference's artifact read by the port and the port's by the
    reference: every tensor equal, the same run; a reference artifact
    without ``mem_inv_scale`` (power-of-two scales) runs as the
    reference runs it."""
    jm, v, pm, wins, ranges = nets["LIFFireNet"]
    je = JD.Int8DeployEngine(jm, v, mem_dtype="mixed", mem_ranges=ranges)
    je.calibrate_z(wins[:2])
    je.serving = {"batch": 2}
    JD.save_engine(je, str(tmp_path / "ref.npz"))
    pe = PD.Int8DeployEngine.from_artifact(pm, str(tmp_path / "ref.npz"))
    assert pe.z_int8 and pe.mem_dtype == "mixed" and pe.serving == {"batch": 2}
    assert_same_run(je, pe, wins[:3])
    path = PD.save_engine(pe, str(tmp_path / "port"))
    assert path.endswith(".npz")
    back = JD.Int8DeployEngine.from_artifact(jm, path)
    assert back.z_int8 and back.unit_mem_int8 == je.unit_mem_int8 and back.serving == {"batch": 2}
    for ju, bu in zip(je.params["units"], back.params["units"]):
        for k in ju:
            assert ju[k].dtype == bu[k].dtype
            assert np.array_equal(np.asarray(ju[k], np.float32), np.asarray(bu[k], np.float32))
    assert_same_run(back, pe, wins[:3])

    old = JD.Int8DeployEngine(jm, v, mem_dtype="int8", mem_scales=[0.5] * jm.num_units)
    for u in old.params["units"]:
        del u["mem_inv_scale"]
    JD.save_engine(old, str(tmp_path / "old.npz"))
    pe = PD.Int8DeployEngine.from_artifact(pm, str(tmp_path / "old.npz"))
    assert "mem_inv_scale" not in pe.params["units"][0]
    assert_same_run(old, pe, wins[:3])


def test_engine_refusals(nets, tmp_path):
    """The reference's refusals, and those of the port: a UNet artifact
    names its item, a unit count that differs, FusedFireNet of an engine."""
    _, v, pm, _, _ = nets["LIFFireNet"]
    for extra, match in (({"norm_input": True}, "norm_input"),
                         ({"mpbn": {"enabled": True}}, "TEBN/MPBN"),
                         ({"encoding": "voxel"}, "input_scale")):
        with pytest.raises(ValueError, match=match):
            PD.Int8DeployEngine(build_model(model_cfg(**extra), device="cpu"))
    with pytest.raises(ValueError, match="snn"):
        PD.Int8DeployEngine(build_model(model_cfg(cell_family="sigmoid"), device="cpu"))
    with pytest.raises(ValueError, match="bfloat16 or int8"):
        PD.Int8DeployEngine(pm, mem_dtype="float16")
    with pytest.raises(ValueError, match="entries"):
        PD.Int8DeployEngine(pm, mem_dtype=["int8"] * (pm.num_units + 1))
    PD.save_engine(PD.Int8DeployEngine(pm), str(tmp_path / "e.npz"))
    with pytest.raises(ValueError, match="units"):
        PD.Int8DeployEngine.from_artifact(
            build_model(model_cfg("LIFFireNet_short"), device="cpu"), str(tmp_path / "e.npz"))
    np.savez(tmp_path / "unet.npz", __meta__=np.asarray('{"model": "SpikingRecEVFlowNet"}'))
    with pytest.raises(ValueError, match="Int8UNetEngine"):
        PD.Int8DeployEngine.from_artifact(pm, str(tmp_path / "unet.npz"))
    from evflow_torch.models.fused import FusedFireNet

    with pytest.raises(ValueError, match="FireNet"):
        FusedFireNet.from_firenet(PD.Int8DeployEngine(pm))


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    from evflow_torch.data.synthetic import make_dataset

    root = str(tmp_path_factory.mktemp("deploy_eval"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.4, flows=[(12.0, -6.0), (-8.0, 4.0)])
    return eval_config(root, res=16, std=32)


def test_engine_under_evaluate_rolls_over(nets, eval_set):
    """``evaluate(model=engine)``: per window, in chunks of 4 (the chunk
    graph's carry holds None slots) and with the metrics on the device,
    equal across the sequence rollover; ``reset_slot_states`` restarts an
    int8 membrane at its zero point and leaves None slots None."""
    from evflow_torch.eval import evaluate, reset_slot_states

    _, v, pm, _, ranges = nets["LIFFireNet"]
    engine = PD.Int8DeployEngine(pm, mem_dtype="mixed", mem_ranges=ranges, input_scale=0.25)
    runs = [evaluate(eval_set, model=engine, device="cpu", debug=True, **kw)
            for kw in ({}, {"chunk": 4}, {"chunk": 4, "device_metrics": True})]
    assert runs[0] == runs[1] == runs[2] and len(runs[0]["AEE"]) == 2
    st = engine.init_states(2, H, W)
    st = tuple(type(s)(torch.full_like(s.mem, 5), None if s.spk is None else
                       torch.ones_like(s.spk)) for s in st)
    out = reset_slot_states(st, engine, np.array([True, False]), 2, H, W)
    fresh = engine.init_states(2, H, W)
    for o, f, s in zip(out, fresh, st):
        assert torch.equal(o.mem[0], f.mem[0]) and torch.equal(o.mem[1], s.mem[1])
        assert (o.spk is None) == (s.spk is None)
    assert int(fresh[1].mem[0, 0, 0, 0]) == int(round(float(engine.params["units"][1]
                                                            ["mem_zp"][0])))
