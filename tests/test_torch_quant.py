"""The port's quantization path against the reference package on the CPU:
every fake-quant function (bit-equal, the straight-through gradient the
identity), the QAT wiring of the registry, one QAT training step (full and
``Conv_only``, dynamic and static conv hooks) against
``evflow.train.make_train_step``, the PTQ calibration (activation scales,
membrane profiles and histograms, the recommended ranges, the hooks of each
mode), the PTQ model under ``evaluate`` with the reference's scales carried
across, quantized checkpoints, the model summary, and ``FusedFireNet``'s
refusal of a quantised model.

The QAT step's preconditions, not tolerances. Its conv kernels (and the
pred bias) lie on a 2^-12 grid, so that every conv of spikes sums exactly
in f32 in both packages: the hooks then quantise the same values in both,
however close to a half-integer an ``x / s`` lies (with continuous kernels
some of the ~90,000 conv values of a step always lie within 1e-4 of one).
The head's conv is the exception: its input, the event counts quantised to
``k * s``, is not integer-valued, so its sums depend on the summation
order. ``conv_quant_margins`` tracks every conv output that is not exact by
construction (the head's, and any off the grid), and no ``x / s`` of them
lies within 1e-4 of a half-integer or of the clip's kink at +-127 (the
largest value of a dynamic scale sits on the kink by construction: its
side must not turn within 4 ulps of it). The membrane quantiser's ``(u -
qmin) / step`` stays more than 4e-5 (over 2 ulps there) from a
half-integer and from its clip's kinks, and no membrane lies within 1e-5
of its threshold at a spike. Each case names the weight seed and window
where all of these hold and the gradients meet PR 21's bar (rtol 5e-4,
atol 5e-7), which sits at both packages' f32 noise floor. The static
cases calibrate their scales on the stream's first 6 windows, before
their step's, so that no calibrated maximum is one of the step's
values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from _torch_port import eval_config, model_cfg, seeded_flax_firenet
from evflow.data.h5_stream import H5EventStream as JaxStream
from evflow.eval import evaluate as jax_evaluate
from evflow.quant import calibrate as JC
from evflow.quant import fake_quant as JQ
from evflow_torch.data.h5_stream import H5EventStream
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.eval import evaluate
from evflow_torch.models.fused import FusedFireNet
from evflow_torch.probes.quant_step import (CONV_QUANT_MARGIN, MEMBRANE_QUANT_MARGIN,
                                            conv_quant_margins, membrane_quant_margins)
from evflow_torch.probes.train_step import spike_margins
from evflow_torch.quant import calibrate as TC
from evflow_torch.quant import fake_quant as TQ
from evflow_torch.registry import build_model
from evflow_torch.weights import from_jax_variables



def on_grid(variables):
    """Every conv kernel and the pred bias rounded to a multiple of 2^-12."""
    def fix(path, x):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] == "kernel" or (names[0] == "pred" and names[-1] == "bias"):
            return (np.round(x * 4096) / 4096).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fix, variables)


def grads_of(fn, x, g):
    """(forward, gradient of sum(fn(x) * g)) in the reference package."""
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


QUANT_FNS = {
    "symmetric": (lambda a: JQ.fake_quant_symmetric(a, jnp.float32(0.0371)),
                  lambda a: TQ.fake_quant_symmetric(a, 0.0371), 3.0),
    "minmax": (lambda a: JQ.fake_quant_minmax(a, -3.5, 2.0, 6),
               lambda a: TQ.fake_quant_minmax(a, -3.5, 2.0, 6), 2.0),
    "state_quant": (JQ.state_quant_fn(), TQ.state_quant_fn(), 80.0),
    "state_quant_4bit": (JQ.state_quant_fn(4, 2.0, 9.0, 0.5),
                         TQ.state_quant_fn(4, 2.0, 9.0, 0.5), 10.0),
    "state_range": (JQ.state_quant_from_range(-15.3, 1.0),
                    TQ.state_quant_from_range(-15.3, 1.0), 6.0),
    "dynamic": (lambda a: JQ.dynamic_conv_quant()(a, "output"),
                lambda a: TQ.dynamic_conv_quant()(a, "output"), 3.0),
    "static_layer": (lambda a: JQ.static_conv_quant({"G1/input": 0.021}, "G1")(a, "input"),
                     lambda a: TQ.static_conv_quant({"G1/input": 0.021}, "G1")(a, "input"), 3.0),
    "static_tag": (lambda a: JQ.static_conv_quant({"output": 0.013}, "G1")(a, "output"),
                   lambda a: TQ.static_conv_quant({"output": 0.013}, "G1")(a, "output"), 3.0),
    "static_missing": (lambda a: JQ.static_conv_quant({}, "G1")(a, "output"),
                       lambda a: TQ.static_conv_quant({}, "G1")(a, "output"), 3.0),
}


@pytest.mark.parametrize("name", sorted(QUANT_FNS))
def test_fake_quant_is_bit_equal(name):
    """Forward and gradient bit-equal, values past the clip included."""
    jf, tf, scale = QUANT_FNS[name]
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 6, 6, 8)) * scale).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jy, jg = grads_of(jf, x, g)
    xt = torch.tensor(x, requires_grad=True)
    ty = tf(xt)
    (ty * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), jy)
    np.testing.assert_array_equal(xt.grad.numpy(), jg)


def test_ste_round_gradient_is_identity():
    """Round half to even forward; the gradient passes unchanged."""
    x = torch.tensor([-2.5, -0.5, 0.5, 1.5, 2.4, 7.6], requires_grad=True)
    y = TQ.ste_round(x)
    (y * torch.arange(6.0)).sum().backward()
    assert y.tolist() == [-2.0, -0.0, 0.0, 2.0, 2.0, 8.0]
    assert x.grad.tolist() == list(range(6))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(JQ.ste_round(x.detach().numpy())))


def test_quantize_weights_and_quantized_checkpoint(tmp_path):
    """``quantize_weights_symmetric``: the reference's scales and kernels
    (its keys as state-dict names); the quantized checkpoint round trip
    and its metadata sidecar."""
    from evflow_torch.models.summary import count_params, summarize
    from evflow_torch.quant.qcheckpoint import (inspect_quantized_checkpoint,
                                                load_quantized_checkpoint,
                                                save_quantized_checkpoint)

    cfg = model_cfg("LIFFireNet_short")
    _, v = seeded_flax_firenet(cfg, seed=1)
    sd = from_jax_variables(v)
    jparams, jscales = JQ.quantize_weights_symmetric(v["params"])
    qsd, scales = TQ.quantize_weights_symmetric(sd)
    assert scales == {k.replace("/kernel", ".weight").replace("/", "."): s
                      for k, s in jscales.items()}
    ref = from_jax_variables({"params": jax.device_get(jparams), "batch_stats": v["batch_stats"]})
    for k, t in qsd.items():
        np.testing.assert_array_equal(t.numpy(), ref[k].numpy(), err_msg=k)

    ranges = {"0": (-20.0, 1.0), "3": (-15.0, 1.0)}
    d = str(tmp_path / "q")
    save_quantized_checkpoint(d, {"model_state_dict": sd, "epoch": 3}, {"model": cfg},
                              state_quant_ranges=ranges)
    state, meta = load_quantized_checkpoint(d)
    assert state["epoch"] == 3 and set(state["model_state_dict"]) == set(sd)
    for k, t in qsd.items():
        np.testing.assert_array_equal(state["model_state_dict"][k].numpy(), t.numpy())
    assert meta["num_bits"] == 8 and meta["weight_scales"] == scales
    assert meta["zero_points"] == {k: 0 for k in scales}
    assert meta["state_quant_ranges"] == {k: list(r) for k, r in ranges.items()}
    assert sorted(meta["lif_params"]) == [f"{u}.lif" for u in sorted(("head", "G1", "R1a",
                                                                      "G2", "R2a"))]
    report = inspect_quantized_checkpoint(d, verbose=False)
    assert report["weight_scales"] == scales and report["lif_units"] == sorted(meta["lif_params"])

    from evflow.models.summary import count_params as jcount, summarize as jsummarize
    assert count_params(sd) == jcount(v)
    assert summarize(sd, "m") == jsummarize(v, "m")


def test_registry_builds_the_qat_hooks():
    """``quantization.enabled`` (without PTQ): the dynamic conv hook on
    every unit and the pred head, the membrane quant unless ``Conv_only``;
    ``static_scales`` swaps in per-layer static hooks; PTQ and a disabled
    section build the FP32 model; ``state_dtype: bfloat16`` builds bf16
    state (the int8 serving item brought it), another ``state_dtype``
    raises."""
    def built(**q):
        return build_model(model_cfg("LIFFireNet_short", quantization=q), device="cpu")

    full, conv = built(enabled=True), built(enabled=True, Conv_only=True)
    assert full.quant_hooks == ("state_quant", "conv_fake_quant")
    assert full.G2.state_quant is full.state_quant and full.pred.conv_fake_quant is not None
    assert conv.quant_hooks == ("conv_fake_quant",) and conv.head.state_quant is None
    assert built(enabled=True, PTQ=True).quant_hooks == () == built(enabled=False).quant_hooks
    static = built(enabled=True, static_scales={"head/output": 0.1})
    assert static.quant_hooks == ("state_quant", "conv_fake_quant_per_layer")
    assert len({id(getattr(static, u).conv_fake_quant) for u in static.unit_names}) == 5
    bf16 = build_model(model_cfg("LIFFireNet", state_dtype="bfloat16"), device="cpu")
    assert bf16.init_states(1, 4, 4)[0].mem.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="state_dtype"):
        build_model(model_cfg("LIFFireNet", state_dtype="float16"), device="cpu")


def calibrated_scales(cfg, variables, batches=6):
    """The FP32 model's conv activation scales over the config's stream."""
    fp32 = dict(cfg, model={k: x for k, x in cfg["model"].items() if k != "quantization"})
    stream = H5EventStream(fp32, 2)
    try:
        return TC.collect_activation_scales(T.port_model(fp32, variables), stream, batches)
    finally:
        stream.close()


# (mode, conv hooks, weight seed, windows skipped: at least the 6 that
# calibrate the static scales)
QAT_CASES = [("full", "dynamic", 168, 3), ("full", "static", 101, 7),
             ("conv_only", "dynamic", 5, 3), ("conv_only", "static", 6, 6)]


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    return T.make_data(tmp_path_factory.mktemp("qat"))


@pytest.mark.parametrize("mode,hooks,seed,skip", QAT_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in QAT_CASES])
def test_qat_step_matches_reference(train_data, mode, hooks, seed, skip):
    """One QAT TBPTT step (LIFFireNet_short, B=2, 16x16, 8 channels, P=3,
    Adam, clip active, ``remat`` full): loss within rtol 1e-5, every
    gradient within rtol 5e-4, atol 5e-7, the parameters after the step
    (see the module's docstring for the preconditions)."""
    q = {"enabled": True, "Conv_only": mode == "conv_only"}
    cfg = T.train_config(train_data, quantization=q)
    v = on_grid(T.seeded(cfg, seed))
    if hooks == "static":
        q["static_scales"] = calibrated_scales(cfg, v)
    window = T.loss_window(cfg, skip)
    jloss, jvars, jgrads = T.jax_step(cfg, v, window)
    with spike_margins() as spikes, membrane_quant_margins() as mq, conv_quant_margins() as cq:
        loss, model, grads, _ = T.port_step(cfg, v, window)
    T.check_margins(spikes)
    assert (mode == "conv_only") == (not mq) and min(mq or [1.0]) > MEMBRANE_QUANT_MARGIN, min(mq)
    assert cq and min(cq) > CONV_QUANT_MARGIN, f"conv-quant margin {min(cq):.2e}: pick another seed"
    assert model.quant_hooks == ((() if mode == "conv_only" else ("state_quant",))
                                 + (("conv_fake_quant",) if hooks == "dynamic"
                                    else ("conv_fake_quant_per_layer",)))
    np.testing.assert_allclose(loss, jloss, rtol=T.LOSS_RTOL)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    T.assert_grads_match(grads, jgrads, v)
    T.assert_step_matches(model, cfg, v, jvars, jgrads)


def test_interpolation_gradient_at_a_pixel_matches_reference():
    """A warp onto a pixel (a zero flow, as the QAT pred hook gives where
    the conv output rounds to 0) puts the bilinear corners at the kinks of
    ``|d|`` and ``max(0, 1 - |d|)``: the gradient equals the reference's
    (``jnp.abs``'s +1 at 0, ``jnp.maximum``'s half at a tie)."""
    from evflow.ops import iwe as JI
    from evflow_torch.ops import iwe as TI

    rng = np.random.default_rng(4)
    n = 64
    ev = np.stack([rng.uniform(0, 1, n), rng.integers(0, 16, n), rng.integers(0, 16, n),
                   rng.integers(0, 2, n)], -1).astype(np.float32)[None]
    flow = np.zeros((1, n, 2), np.float32)
    flow[0, n // 2:] = rng.normal(0, 0.05, (n - n // 2, 2))
    g = rng.normal(size=(1, 4 * n)).astype(np.float32)
    for tref in (0.0, 1.0):
        def jf(f):
            return JI.get_interpolation(jnp.asarray(ev), f, tref, (16, 16), 16.0)[1]
        _, jg = grads_of(jf, flow, g)
        ft = torch.tensor(flow, requires_grad=True)
        (TI.get_interpolation(torch.tensor(ev), ft, tref, (16, 16), 16.0)[1]
         * torch.tensor(g)).sum().backward()
        np.testing.assert_allclose(ft.grad.numpy(), jg, rtol=1e-6, atol=1e-6)
        assert np.abs(jg[0, : n // 2]).max() > 0


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    """configs/eval_MVSEC.yml's settings on a small synthetic set, the
    seeded 8-channel LIFFireNet with its kernels on the 2^-12 grid."""
    root = str(tmp_path_factory.mktemp("ptq"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.6, flows=[(12.0, -6.0), (-8.0, 4.0)])
    cfg = eval_config(root, res=16, std=32)
    jm, v = seeded_flax_firenet(cfg["model"], seed=11)
    return cfg, jm, on_grid(v)


def both_streams(cfg, jfn, tfn):
    js, ts = JaxStream(cfg, 2), H5EventStream(cfg, 2)
    try:
        return jfn(js), tfn(ts)
    finally:
        js.close()
        ts.close()


def test_collect_activation_scales_matches_reference(calib):
    """Same keys (every unit's input and output, the pred head's), values
    within rtol 1e-5, through a model whose own (dynamic) conv hooks still
    run after the observers, as the reference's captures do; the hooks are
    back after."""
    cfg, jm, v = calib
    jm = jm.clone(conv_fake_quant=JQ.dynamic_conv_quant())
    model = T.port_model(cfg, v).set_quant(conv_fake_quant=TQ.dynamic_conv_quant())
    hook = model.conv_fake_quant
    jscales, tscales = both_streams(
        cfg, lambda s: JC.collect_activation_scales(jm, v, s, num_batches=5),
        lambda s: TC.collect_activation_scales(model, s, num_batches=5))
    assert set(tscales) == set(jscales)
    assert len(tscales) == 2 * (model.num_units + 1)
    for k, s in jscales.items():
        np.testing.assert_allclose(tscales[k], s, rtol=1e-5, err_msg=k)
    assert model.conv_fake_quant is hook and model.R2a.conv_fake_quant is hook


def jax_histograms(jm, v, stream, n):
    """Each unit's membrane histogram summed over ``n`` batches in the
    reference package (its profiling statistics, ``_membrane_stats``)."""
    B, (H, W) = 1, stream.config["loader"]["resolution"]
    step = jax.jit(lambda vv, c, st: jm.apply(vv, None, c, st)[1])
    states, out = jm.init_states(B, H, W), {}
    for _ in range(n):
        batch = stream.next_batch()
        if batch["new_seq"].any():
            states = jm.init_states(B, H, W)
        states = step(v, jnp.asarray(batch["event_cnt"]), states)
        for k, s in JC._membrane_stats(states).items():
            out[k] = out.get(k, 0) + np.asarray(s["hist"], np.float64)
    return out


def test_profile_membrane_ranges_matches_reference(calib):
    """Across a sequence rollover: every unit's min and max within rtol
    1e-5, the histogram counts equal (the reference's bins), so the
    percentiles and ``recommend_ranges`` are equal too; the port's bin
    edges are ``jnp.histogram``'s."""
    cfg, jm, v = calib
    np.testing.assert_array_equal(
        TC.hist_edges(), np.asarray(jnp.histogram(jnp.zeros(1), 1024, (-300.0, 10.0))[1]))
    model = T.port_model(cfg, v)
    hists = {}
    jprof, tprof = both_streams(cfg, lambda s: JC.profile_membrane_ranges(jm, v, s, 8),
                                lambda s: TC.profile_membrane_ranges(model, s, 8, hists=hists))
    jh = both_streams(cfg, lambda s: jax_histograms(jm, v, s, 8), lambda s: None)[0]
    assert set(tprof) == set(jprof) == set(hists) == {str(i) for i in range(7)}
    for k, p in jprof.items():
        np.testing.assert_allclose([tprof[k]["min"], tprof[k]["max"]], [p["min"], p["max"]],
                                   rtol=1e-5)
        np.testing.assert_array_equal(hists[k], jh[k])
        assert {n: tprof[k][n] for n in p if n not in ("min", "max", "mean")} == \
            {n: p[n] for n in p if n not in ("min", "max", "mean")}
        np.testing.assert_allclose(tprof[k]["mean"], p["mean"], rtol=1e-12)
    assert TC.recommend_ranges(tprof) == JC.recommend_ranges(jprof)


HOOKS = ("state_quant", "state_quant_per_layer", "conv_fake_quant", "conv_fake_quant_per_layer")


@pytest.mark.parametrize("mode,auto_tune,batches", [
    ("full", True, 3), ("conv_only", False, 3), ("states_only", False, 3), ("full", False, 0)])
def test_calibrate_model_ptq_builds_the_reference_hooks(calib, mode, auto_tune, batches):
    """Each mode sets the hooks the reference's sets (per layer where it
    sets them per layer); the weights are the FP32 ones."""
    cfg, _, v = calib
    jq, _ = JC.calibrate_model_ptq(cfg, v, mode=mode, num_batches=batches,
                                   auto_tune=auto_tune, profile_batches=3)
    stats = {}
    tq = TC.calibrate_model_ptq(cfg, from_jax_variables(v), mode=mode, num_batches=batches,
                                auto_tune=auto_tune, profile_batches=3, device="cpu",
                                stats=stats)
    for h in HOOKS:
        jh, th = getattr(jq, h), getattr(tq, h)
        assert (jh is None) == (th is None), h
        if h.endswith("per_layer") and jh is not None:
            assert [x is None for x in jh] == [x is None for x in th], h
    assert set(stats) == ({"scales"} if batches and mode != "states_only" else set()) | (
        {"profiles", "ranges"} if auto_tune else set())
    for k, t in from_jax_variables(v).items():
        torch.testing.assert_close(tq.state_dict()[k], t, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        TC.calibrate_model_ptq(cfg, mode="int4", device="cpu")


def test_ptq_evaluate_matches_reference(calib):
    """The PTQ model (static per-layer conv scales and auto-tuned membrane
    ranges, the reference's numbers carried across) under ``evaluate``:
    AEE within 1e-3 relative of the reference's; the port's chunks of 4
    with the metrics on the device within 1e-5 of its per-window run."""
    cfg, jm, v = calib
    units = (*jm.unit_names, "pred")

    def calibrate(s):
        scales = JC.collect_activation_scales(jm, v, s, num_batches=8)
        s.close()
        s2 = JaxStream(cfg, 2)
        ranges = JC.recommend_ranges(JC.profile_membrane_ranges(jm, v, s2, 8))
        s2.close()
        return scales, ranges

    scales, ranges = both_streams(cfg, calibrate, lambda s: None)[0]
    jq = jm.clone(state_quant_per_layer=JC.build_per_layer_state_quants(ranges, jm.num_units),
                  conv_fake_quant_per_layer=tuple(JQ.static_conv_quant(scales, u) for u in units))
    ref = jax_evaluate(cfg, variables=v, model=jq, debug=True, max_windows=10, verbose=False)
    tq = T.port_model(cfg, v).set_quant(
        state_quant_per_layer=TC.build_per_layer_state_quants(ranges, jm.num_units),
        conv_fake_quant_per_layer=tuple(TQ.static_conv_quant(scales, u) for u in units))
    ours = evaluate(cfg, model=tq, device="cpu", debug=True, max_windows=10)
    assert set(ours) == set(ref) and len(ref["AEE"]) == 2
    for f, val in ref["AEE"].items():
        np.testing.assert_allclose(float(ours["AEE"][f]), float(val), rtol=1e-3, err_msg=f)
    chunked = evaluate(cfg, model=tq, device="cpu", debug=True, max_windows=10, chunk=4,
                       device_metrics=True)
    for m, per_file in ours.items():
        for f, val in per_file.items():
            np.testing.assert_allclose(float(chunked[m][f]), float(val), rtol=1e-5, atol=1e-7)


def test_fused_firenet_refuses_quant_hooks(calib):
    """The fused kernels run no fake quant: folding a quantised FireNet
    raises naming the hook, and so does ``evaluate(fused=True)`` with it."""
    cfg, _, v = calib
    model = T.port_model(cfg, v).set_quant(conv_fake_quant=TQ.dynamic_conv_quant())
    with pytest.raises(ValueError, match="conv_fake_quant"):
        FusedFireNet.from_firenet(model)
    per_layer = T.port_model(cfg, v).set_quant(
        state_quant_per_layer=(None,) * 6 + (TQ.state_quant_fn(),))
    with pytest.raises(ValueError, match="state_quant_per_layer"):
        FusedFireNet.from_firenet(per_layer)
    with pytest.raises(ValueError, match="FusedFireNet runs no fake quantization"):
        evaluate(cfg, model=model, fused=True, device="cpu", debug=True, max_windows=1)
    FusedFireNet.from_firenet(T.port_model(cfg, v).set_quant(
        state_quant_per_layer=(None,) * 7))
