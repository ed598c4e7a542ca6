"""The port's training pieces below the step against the reference
package's on the CPU: the event-warping loss (value rtol 1e-5,
d(loss)/d(flow) rtol 5e-4 atol 1e-6, the bars of
``tests/test_reference_parity.py``), the train-mode norms and their running
statistics after P passes, the clamps' half gradient at a tie, the
optimizers and the clip against optax, and the compact wire."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from evflow.loss.warp_loss import event_warping_loss as jax_loss
from evflow.models import cells as JC
from evflow.models import norm as JN
from evflow_torch import registry
from evflow_torch.loss.warp_loss import EventWarpingConfig, event_warping_loss
from evflow_torch.models import cells as TC
from evflow_torch.models import norm as TN
from evflow_torch.train import (clip_by_global_norm, compact_window, pass_count,
                                restore_window, stack_window, upload_window)

P, B, N, H, W = 3, 2, 48, 12, 12


@pytest.fixture(scope="module")
def window():
    """Random loss-window inputs (fractional coordinates, 8 padded events
    a slot, a random event mask) and flows."""
    rng = np.random.default_rng(51)
    ts = np.sort(rng.uniform(0, 1, (P, B, N)), -1)
    ys, xs = rng.uniform(0, H - 1, (P, B, N)), rng.uniform(0, W - 1, (P, B, N))
    ps = rng.choice([-1.0, 1.0], (P, B, N))
    valid = np.ones((P, B, N))
    valid[..., -8:] = 0.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(events=f32(np.stack([ts, ys, xs, ps], -1)),
                pol=f32(np.stack([ps > 0, ps < 0], -1) * valid[..., None]),
                mask=f32(rng.uniform(size=(P, B, H, W, 1)) > 0.4), valid=f32(valid),
                flows=f32(rng.normal(0, 0.2, (P, B, H, W, 2))))


def losses(w, flows, **kw):
    """(JAX loss, JAX d/dflow, port loss, port d/dflow)."""
    keys = ("events", "pol", "mask", "valid")
    kw = dict(flow_scaling=float(W), smoothness_weight=0.01, **kw)
    jv, jg = jax.value_and_grad(lambda f: jax_loss([f], *(jnp.asarray(w[k]) for k in keys),
                                                   **kw))(jnp.asarray(flows))
    tf = torch.tensor(flows, requires_grad=True)
    tv = event_warping_loss([tf], *(torch.tensor(w[k]) for k in keys), **kw)
    tv.backward()
    return float(jv), np.asarray(jg), float(tv.detach()), tf.grad.numpy()


@pytest.mark.parametrize("overwrite", [False, True], ids=["per_pass", "overwrite"])
@pytest.mark.parametrize("smoothing_mask", [False, True], ids=["nomask", "mask"])
def test_warp_loss_and_flow_gradient_match_reference(window, smoothing_mask, overwrite):
    jv, jg, tv, tg = losses(window, window["flows"], smoothing_mask=smoothing_mask,
                            overwrite_intermediate=overwrite)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=5e-4, atol=1e-6)
    assert np.abs(tg).max() > 0.01


def test_padded_events_contribute_nothing(window):
    """Moving and flipping the padded events changes neither the loss nor
    its gradient."""
    w = dict(window)
    ev = w["events"].copy()
    ev[..., -8:, 1:] = [3.5, 7.25, 1.0]
    w["events"] = ev
    a = losses(window, window["flows"])
    b = losses(w, window["flows"])
    assert a[2] == b[2]
    np.testing.assert_array_equal(a[3], b[3])


def test_config_adapter_matches_reference_settings(window):
    from evflow.loss.warp_loss import EventWarpingConfig as JaxConfig

    cfg = {"loader": {"resolution": [H, W]}, "loss": {"flow_regul_weight": 0.001,
                                                      "overwrite_intermediate": True},
           "model": {"mask_output": True}}
    j, t = JaxConfig(cfg), EventWarpingConfig(cfg)
    assert (t.res, t.flow_scaling, t.weight, t.smoothing_mask, t.overwrite_intermediate) == (
        j.res, j.flow_scaling, j.weight, j.smoothing_mask, j.overwrite_intermediate)
    args = [window[k] for k in ("events", "pol", "mask", "valid")]
    jv = j([jnp.asarray(window["flows"])], *map(jnp.asarray, args))
    tv = t([torch.tensor(window["flows"])], *map(torch.tensor, args))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)


@pytest.mark.parametrize("kind", ["bn", "tebn_t", "tebn_mean", "mpbn"])
def test_train_mode_norms_match_flax(kind):
    """Outputs and running statistics over P passes in training mode, each
    pass's batch different, against flax's ``mutable=["batch_stats"]``."""
    C = 8
    rng = np.random.default_rng(7)
    xs = [rng.normal(0.3, 1.5, (B, H, W, C)).astype(np.float32) for _ in range(P)]
    if kind == "bn":
        jm, tm, inner = JN.BatchNorm(), TN.BatchNorm(C), None
    elif kind == "mpbn":
        jm, tm, inner = JN.MPBN(), TN.MPBN(C), "bn"
    else:
        jm, tm, inner = JN.TEBN(C, 4), TN.TEBN(C, 4), "bn"
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), False)
    v = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), v)
    bn = tm if inner is None else tm.bn
    src = v["params"]["BatchNorm_0"]
    stats = v["batch_stats"]["BatchNorm_0"]
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(src["scale"]))
        bn.bias.copy_(torch.tensor(src["bias"]))
        bn.running_mean.copy_(torch.tensor(stats["mean"]))
        bn.running_var.copy_(torch.tensor(stats["var"]))
        if kind.startswith("tebn"):
            tm.p.copy_(torch.tensor(v["params"]["p"])[..., None, None])
    tm.train()
    for p, x in enumerate(xs):
        kw = {"timestep": p} if kind == "tebn_t" else {}
        jy, mut = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"], **kw)
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        ty = tm(torch.tensor(x), **kw)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    js = v["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), js["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), js["var"], rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == P


def test_frozen_running_stats_normalise_but_do_not_update():
    bn = TN.BatchNorm(4).train()
    x = torch.randn(2, 5, 5, 4)
    y = bn(x)
    before = bn.running_mean.clone(), bn.running_var.clone()
    with TN.frozen_running_stats(bn):
        y2 = bn(x)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])


def test_clamp_ties_split_the_gradient_like_jax():
    """A threshold at exactly 0.01 (where ``clamp_thresholds`` puts it) and
    leaks at exactly 0 and 1 get half the gradient, as jnp.maximum and
    jnp.clip give it; every other channel all of it."""
    C = 8
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    mem = rng.normal(0.2, 0.5, (B, H, W, C)).astype(np.float32)
    r = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    jcell = JC.SNNConvLIF(input_size=C, features=C)
    v = jcell.init(jax.random.PRNGKey(0), jnp.asarray(x), None)
    v = jax.device_get(v)
    theta = rng.uniform(0.05, 0.8, C).astype(np.float32)
    theta[[1, 4]] = np.float32(0.01)
    beta = rng.uniform(0.1, 0.9, C).astype(np.float32)
    beta[2], beta[5] = 0.0, 1.0
    v["params"]["threshold"], v["params"]["beta"] = theta, beta

    def jloss(params):
        from evflow.ops.lif import LIFState

        spk, _ = jcell.apply({"params": params, "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), LIFState(jnp.asarray(mem), jnp.zeros_like(mem)))
        return (spk * r).sum()

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, v["params"]))
    from evflow_torch.ops.lif import LIFState

    bn_p, bn_s = v["params"]["bn"]["BatchNorm_0"], v["batch_stats"]["bn"]["BatchNorm_0"]
    tcell = TC.SNNConvLIF(C, C).eval()
    tcell.load_state_dict({
        "ff.weight": torch.tensor(np.transpose(v["params"]["ff"]["kernel"], (3, 2, 0, 1))),
        "bn.weight": torch.tensor(bn_p["scale"]), "bn.bias": torch.tensor(bn_p["bias"]),
        "bn.running_mean": torch.tensor(bn_s["mean"]), "bn.running_var": torch.tensor(bn_s["var"]),
        "bn.num_batches_tracked": torch.tensor(0),
        "lif.beta": torch.tensor(beta).reshape(C, 1, 1),
        "lif.threshold": torch.tensor(theta).reshape(C, 1, 1)})
    spk, _ = tcell(torch.tensor(x), LIFState(torch.tensor(mem), torch.zeros(mem.shape)))
    (spk * torch.tensor(r)).sum().backward()
    for name, jgrad in (("threshold", jg["threshold"]), ("beta", jg["beta"])):
        tgrad = getattr(tcell.lif, name).grad.reshape(-1).numpy()
        np.testing.assert_allclose(tgrad, np.asarray(jgrad), rtol=5e-4, atol=5e-7)
    assert np.all(np.asarray(jg["threshold"])[[1, 4]] != 0)


def test_learn_flags_and_detach_cut_the_gradient():
    """``learn_leak``/``learn_thresh`` false: no gradient reaches the leak
    and threshold; ``detach=False`` keeps the membrane carry's."""
    x = torch.randn(B, H, W, 4)
    for learn in (True, False):
        cell = TC.SNNConvLIF(4, 4, thresh=(0.05, 0.3), learn_leak=learn, learn_thresh=learn)
        spk, st = cell(x, None)
        spk2, _ = cell(x, st)
        spk2.sum().backward()
        for p in (cell.lif.beta, cell.lif.threshold):
            assert (p.grad is not None and p.grad.abs().sum() > 0) == learn
    for detach in (True, False):
        cell = TC.SNNConvLIF(4, 4, thresh=(0.05, 0.3), detach=detach)
        _, st = cell(x, None)
        assert st.mem.requires_grad != detach


@pytest.mark.parametrize("name,kw", [
    ("Adam", {}), ("Adam", {"b1": 0.8, "b2": 0.99, "eps": 1e-6}), ("AdamW", {}),
    ("AdamW", {"weight_decay": 0.05}), ("SGD", {}), ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True}), ("RMSprop", {}),
    ("RMSprop", {"decay": 0.8, "initial_scale": 0.1, "momentum": 0.5}),
    ("RMSprop", {"momentum": 0.5, "nesterov": True}),
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v)) or "default")
def test_optimizers_follow_optax(name, kw):
    """Three steps of the port's optimizer against optax's on the same
    gradients (zeros in one tensor, as ``learn_leak: false`` gives),
    clipped by the global norm."""
    from evflow.registry import build_optimizer as jax_optimizer

    rng = np.random.default_rng(0)
    cfg = {"name": name, "lr": 1e-2, **kw}
    p0 = [rng.normal(0, 1, (3, 4)).astype(np.float32), rng.normal(0, 1, 5).astype(np.float32)]
    grads = [[rng.normal(0, 2, p0[0].shape).astype(np.float32), np.zeros(5, np.float32)]
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), jax_optimizer(cfg))
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(a)) for a in p0]
    opt = registry.build_optimizer(cfg, tp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for t, a in zip(tp, g):
            t.grad = torch.tensor(a)
        clip_by_global_norm([t.grad for t in tp], 1.0)
        opt.step()
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_optimizer_defaults_and_refusals():
    ps = [torch.nn.Parameter(torch.zeros(2))]
    adamw = registry.build_optimizer({"name": "AdamW"}, ps)
    assert adamw.defaults["weight_decay"] == 1e-4 and adamw.defaults["lr"] == 2e-4
    assert registry.build_optimizer({"name": "RMSprop", "lr": 1.0}, ps).defaults["decay"] == 0.9
    with pytest.raises(TypeError):
        registry.build_optimizer({"name": "Adam", "weight_decay": 0.1}, ps)
    with pytest.raises(KeyError, match="Unknown optimizer"):
        registry.build_optimizer({"name": "Lion"}, ps)


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below", "clipped"])
def test_global_norm_clip_matches_optax(scale):
    rng = np.random.default_rng(1)
    g = [(rng.normal(0, 1, s) * scale).astype(np.float32) for s in ((3, 3), (7,))]
    j, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(a) for a in g], None)
    t = [torch.tensor(a) for a in g]
    norm = clip_by_global_norm(t, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                                        for a in g)), rtol=1e-6)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("window_loss,window,expected", [(10000, 1000, 10), (0.5, 0.1, 5),
                                                         (1000, 1000, 1)])
def test_pass_count_rounds(window_loss, window, expected):
    assert pass_count({"data": {"window": window, "window_loss": window_loss}}) == expected


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Six streamed batches of 32x32 windows with hot filtering and every
    flip (``tests/test_train_eval.py``'s derive_cnt inputs), by the port's
    stream."""
    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.data.synthetic import make_dataset

    root = str(tmp_path_factory.mktemp("wire"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30_000,
                 duration=0.5, flows=[(10.0, -5.0), (-8.0, 4.0)], gt_hz=10.0)
    cfg = {"data": {"path": root, "mode": "events", "window": 250},
           "model": {"encoding": "cnt"},
           "loader": {"batch_size": 2, "resolution": [32, 32], "augment": [
               "Horizontal", "Vertical", "Polarity"], "augment_prob": [0.5, 0.5, 0.5], "seed": 0},
           "hot_filter": {"enabled": True, "max_px": 4, "min_obvs": 1, "max_rate": 0.05}}
    stream = H5EventStream(cfg, 2)
    batches = [stream.next_batch() for _ in range(6)]
    stream.close()
    assert any((b["hot_mask"] == 0).any() for b in batches)  # the filter fires
    return batches


def restored(w, **kw):
    return {k: (None if v is None else v.numpy())
            for k, v in restore_window(upload_window(w, torch.device("cpu")), **kw).items()}


@pytest.mark.parametrize("pol_bits", [False, True], ids=["pol_mask", "pol_bits"])
@pytest.mark.parametrize("coords", [None, "f32", "u16"])
def test_compact_restore_equals_stack_window(streamed, coords, pol_bits):
    """The derive_cnt wire rebuilds the loader's counts and mask bit for
    bit on the device, and every event column; (y, x) as uint16 on
    integral coordinates (the flooring leaves the loader's counts as they
    are: the encoders truncate)."""
    window = stack_window(streamed[:3])
    ref = dict(window)
    if coords == "u16":
        el = window["event_list"].copy()
        el[..., 1:3] = np.floor(el[..., 1:3])
        window = dict(window, event_list=el)
        ref = window
    cw = compact_window(window, "cnt", derive_mask=True, derive_cnt=True,
                        coords_dtype={None: None, "f32": np.float32, "u16": np.uint16}[coords],
                        pol_bits=pol_bits)
    assert cw["event_cnt"] is None and cw["event_mask"] is None and "hot_mask" not in cw
    assert cw["hot_bits"].dtype == np.uint8
    if coords == "u16":
        assert cw["event_yx"].dtype == np.uint16
    rw = restored(cw, resolution=(32, 32))
    for key in ("event_cnt", "event_mask", "event_list", "event_valid", "event_list_pol_mask"):
        np.testing.assert_array_equal(rw[key], ref[key], err_msg=key)


def test_narrow_count_wire_is_exact(streamed):
    """Counts that ride the wire: uint8 when they fit, int16 past 255 (the
    trainer's sticky flip), each restored to the same f32 counts."""
    window = stack_window(streamed[:3])
    assert compact_window(window, "cnt")["event_cnt"].dtype == np.uint8
    big = dict(window, event_cnt=window["event_cnt"] * 200)
    cw = compact_window(big, "cnt")
    assert cw["event_cnt"].dtype == np.int16
    np.testing.assert_array_equal(restored(cw)["event_cnt"], big["event_cnt"])
    cw8 = compact_window(window, "cnt", cnt_dtype=np.uint8)
    np.testing.assert_array_equal(restored(cw8)["event_cnt"], window["event_cnt"])


def test_derived_voxel_matches_loader(streamed, tmp_path):
    """The derive_voxel wire: the voxel grid splatted on the device from
    the event list (and the mask from its histogram) against the stream's
    voxel grids, equal up to f32 summation order."""
    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.data.synthetic import make_dataset

    make_dataset(str(tmp_path), num_sequences=1, resolution=(32, 32), events_per_sec=30_000,
                 duration=0.2, flows=[(10.0, -5.0)], gt_hz=10.0)
    cfg = {"data": {"path": str(tmp_path), "mode": "events", "window": 250},
           "model": {"encoding": "voxel"},
           "loader": {"batch_size": 2, "resolution": [32, 32], "augment": [], "seed": 0},
           "hot_filter": {"enabled": False}}
    stream = H5EventStream(cfg, 5)
    window = stack_window([stream.next_batch() for _ in range(3)])
    stream.close()
    cw = compact_window(window, "voxel", derive_mask=True, derive_voxel=True)
    assert cw["event_voxel"] is None and cw["event_mask"] is None
    rw = restored(cw, resolution=(32, 32), num_bins=5)
    np.testing.assert_allclose(rw["event_voxel"], window["event_voxel"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rw["event_mask"], window["event_mask"])


@pytest.mark.parametrize("wire", ["u16_coords", "f32_coords", "int16_counts", "full_mask"])
def test_wire_flips_leave_the_step_unchanged(streamed, wire):
    """Each sticky wire the trainer may fall back to (f32 coordinates for
    fractional events, int16 counts past 255, the full polarity mask) gives
    the same loss and gradients as the full f32 window: the narrow wire
    changes bytes, not numbers."""
    from evflow_torch.loss.warp_loss import EventWarpingConfig
    from evflow_torch.train import TrainStep

    window = stack_window(streamed[:3])
    window.pop("hot_mask")  # the grids ride the wire here: no device derivation
    kw = {"u16_coords": dict(coords_dtype=np.uint16, pol_bits=True),
          "f32_coords": dict(coords_dtype=np.float32, pol_bits=True),
          "int16_counts": dict(cnt_dtype=np.int16),
          "full_mask": dict(coords_dtype=np.float32, pol_bits=False)}[wire]
    if wire == "u16_coords":  # integral coordinates: the encoders truncate, counts unchanged
        window["event_list"][..., 1:3] = np.floor(window["event_list"][..., 1:3])
    cfg = {"loader": {"resolution": [32, 32]}, "loss": {"flow_regul_weight": 0.001},
           "model": {"mask_output": True}}
    model_cfg = {"name": "LIFFireNet_short", "base_num_channels": 4, "encoding": "cnt",
                 "spiking_neuron": {"leak": [0.0, 1.0], "thresh": [0.0, 0.8]}}

    def step(w):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = registry.build_model(model_cfg, device="cpu")
        opt = registry.build_optimizer({"name": "Adam"}, model.parameters())
        st = TrainStep(model, opt, EventWarpingConfig(cfg), 4, clip_grad=1.0,
                       resolution=(32, 32), keep_grads=True)
        loss, _ = st(model.init_states(2, 32, 32), upload_window(w, torch.device("cpu")))
        return float(loss), st.grads

    full_loss, full_grads = step(window)
    loss, grads = step(compact_window(window, "cnt", **kw))
    assert loss == full_loss
    for k, g in full_grads.items():
        torch.testing.assert_close(grads[k], g, rtol=0, atol=0, msg=k)
