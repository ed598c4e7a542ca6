"""The port's whole-network FireNet step (``evflow_torch.ops.fused_net*``,
plain versions on the CPU) against the JAX whole-network kernels
(``benchmarks/pallas_archive``, interpret-mode Pallas) and the JAX per-layer
``FusedFireNet``.

LIFFireNet at C=8, 32x16 pixels, ``tile_rows=8``, with the seeded flax
weights of ``_torch_port`` made bf16-exact (kernels and BN bias rounded to
bf16, unit BN gain, zero BN mean), so that every path sums the same exact
products and only f32 summation order could differ.

The JAX whole-network kernels never zero the rows outside the image: a
unit's spikes at row -1 come from a conv of row 0 and feed back into row 0
at the next unit. So they are compared with the port only on the rows that
fault cannot reach (unit k on rows [k, H-k), the flow on [L-1, H-L+1)),
and the port is held against the per-layer path on every row.
``test_reference_wholenet_leaks_border_rows`` records the fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import counts, model_cfg, seeded_flax_firenet
from benchmarks.pallas_archive.fused_net import PallasFusedFireNet
from benchmarks.pallas_archive.fused_net_batch import BatchFusedFireNet
from benchmarks.pallas_archive.fused_net_lgrid import LayerGridFusedFireNet
from benchmarks.pallas_archive.fused_net_loop2 import LoopFusedFireNet2
from evflow.models.fused import FusedFireNet as JaxFusedFireNet
from evflow_torch.models.fused import FusedFireNet
from evflow_torch.ops.fused_net import WholeNetFireNet, fused_firenet_step, launch_wholenet
from evflow_torch.ops.fused_net_batch import BatchFireNet, fused_firenet_step_batch
from evflow_torch.ops.fused_net_lgrid import LayerGridFireNet, fused_firenet_step_lgrid
from evflow_torch.ops.fused_net_loop2 import LoopFireNet, fused_firenet_step_loop2
from evflow_torch.registry import build_model
from evflow_torch.weights import from_jax_variables

B, H, W, TH, L = 1, 32, 16, 8, 7
TOL = 1e-5
RUNNERS = {  # name: (port runner, JAX runner)
    "fused_net": (WholeNetFireNet, PallasFusedFireNet),
    "lgrid": (LayerGridFireNet, LayerGridFusedFireNet),
    "loop2": (LoopFireNet, LoopFusedFireNet2),
    "batch": (BatchFireNet, BatchFusedFireNet),
}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def bf16_exact(v):
    """Kernels and BN bias rounded to bf16, BN gain scale/sqrt(var+eps) = 1
    and mean 0: folding is exact and the folded weights are bf16 values."""
    params = {k: dict(u) for k, u in v["params"].items()}
    stats = {k: dict(u) for k, u in v["batch_stats"].items()}
    for unit, up in params.items():
        for conv in ("ff", "rec", "conv2d"):
            if conv in up:
                up[conv] = {**up[conv], "kernel": bf16(up[conv]["kernel"])}
        if unit == "pred":
            continue
        bs = dict(stats[unit]["bn"]["BatchNorm_0"])
        var = np.asarray(bs["var"], np.float32)
        bs["mean"] = np.zeros_like(var)
        stats[unit] = {"bn": {"BatchNorm_0": bs}}
        scale = np.sqrt(var + np.float32(1e-5)).astype(np.float32)
        up["bn"] = {"BatchNorm_0": {"scale": scale,
                                    "bias": bf16(up["bn"]["BatchNorm_0"]["bias"])}}
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def nets():
    """(flax model, bf16-exact variables, port FusedFireNet)."""
    cfg = model_cfg("LIFFireNet")
    jm, v = seeded_flax_firenet(cfg, seed=11)
    v = bf16_exact(v)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, FusedFireNet.from_firenet(tm, layout="cmajor")


@pytest.fixture(scope="module")
def windows():
    return counts(np.random.default_rng(12), (4, B, H, W, 2))


def jax_unit_states(name, states, recurrent):
    """Per unit (mem, spikes or None) of a JAX whole-net runner's padded
    states, with the padding rows stripped."""
    def strip(a):
        return np.asarray(a, np.float32)[..., TH:TH + H, :]

    mems, spks = states
    if name == "fused_net":
        it = iter(spks)
        return [strip(m) for m in mems], [strip(next(it)) if r else None for r in recurrent]
    mems = [strip(m) for m in mems]
    if name == "lgrid":
        return mems, [strip(s) for s in spks]
    rec = [l for l, r in enumerate(recurrent) if r]
    spikes = [None] * len(recurrent)
    for s, l in enumerate(rec):
        spikes[l] = strip(spks[s])
    spikes[len(recurrent) - 1] = strip(spks[2])  # slot 2: the last (feedforward) unit
    return mems, spikes


@pytest.fixture(scope="module")
def jax_window0(nets, windows):
    """Window 0 through every JAX whole-net runner (f32 state) and through
    PallasFusedFireNet in bf16 state: {(name, dtype): (flow, mems, spikes)}."""
    jm, v, _ = nets
    recurrent = [u.recurrent for u in nets[2].units]
    out = {}
    cases = [(n, "f32") for n in RUNNERS] + [("fused_net", "bf16")]
    for name, dt in cases:
        runner = RUNNERS[name][1](jm, v, tile_rows=TH)
        states = runner.init_states(B, H, W, dtype=DTYPES[dt][1])
        with pltpu.force_tpu_interpret_mode():
            flow, states = runner.step(jnp.asarray(windows[0]), states)
        out[name, dt] = (np.asarray(flow), *jax_unit_states(name, states, recurrent))
    return out


@pytest.fixture(scope="module")
def jax_perlayer(nets, windows):
    """The JAX per-layer FusedFireNet (cmajor, f32 state) over every window:
    a list of (flow, mems, spikes)."""
    jm, v, _ = nets
    jf = JaxFusedFireNet.from_firenet(jm, v, tile_rows=TH, layout="cmajor")
    st = jf.init_states(B, H, W)
    out = []
    with pltpu.force_tpu_interpret_mode():
        for x in windows:
            flow, st = jf.step(jf.params, jnp.asarray(x), st)
            out.append((np.asarray(flow), [np.asarray(s.mem) for s in st],
                        [np.asarray(s.spk) for s in st]))
    return out


def port_run(runner, windows, n):
    """(flow, mems, spikes) per window of a port runner, as numpy."""
    states = runner.init_states(B, H, W)
    out = []
    for x in windows[:n]:
        flow, states = runner.step(torch.tensor(x), states)
        mems, spikes = runner.unit_states(states)
        out.append((flow.numpy(), [m.float().numpy() for m in mems],
                    [None if s is None else s.float().numpy() for s in spikes]))
    return out


def test_seeded_units_fire(nets, windows):
    """Every unit fires in the first windows: the comparisons below are not
    of silent units."""
    runs = port_run(LayerGridFireNet(nets[2], torch.float32), windows, 2)
    rates = [float(np.mean([r[2][l] for r in runs])) for l in range(L)]
    assert min(rates) > 0.005, rates


@pytest.mark.parametrize("name,dt", [(n, "f32") for n in RUNNERS] + [("fused_net", "bf16")])
def test_runner_matches_jax_wholenet_off_border(nets, windows, jax_window0, name, dt):
    """Window 0, port runner (plain version) against its JAX runner
    (interpret mode): flow within 1e-5 on rows [L-1, H-L+1), unit k's mem
    and spikes within 1e-5 on rows [k, H-k)."""
    runner = RUNNERS[name][0](nets[2], DTYPES[dt][0])
    flow, mems, spikes = port_run(runner, windows, 1)[0]
    jflow, jmems, jspikes = jax_window0[name, dt]
    assert flow.shape == jflow.shape == (B, H, W, 2)
    np.testing.assert_allclose(flow[:, L - 1:H - L + 1], jflow[:, L - 1:H - L + 1], atol=TOL)
    for k in range(L):
        rows = slice(k, H - k)
        np.testing.assert_allclose(mems[k][..., rows, :], jmems[k][..., rows, :], atol=TOL,
                                   err_msg=f"unit {k} mem")
        assert (spikes[k] is None) == (jspikes[k] is None)
        if spikes[k] is not None:
            np.testing.assert_allclose(spikes[k][..., rows, :], jspikes[k][..., rows, :],
                                       atol=TOL, err_msg=f"unit {k} spikes")


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runner_matches_jax_per_layer_everywhere(nets, windows, jax_perlayer, name):
    """Four windows, port runner (f32 state) against the JAX per-layer
    FusedFireNet (cmajor) on every row: flow, membranes and kept spikes
    within 1e-5."""
    runs = port_run(RUNNERS[name][0](nets[2], torch.float32), windows, len(windows))
    for t, ((flow, mems, spikes), (jflow, jmems, jspikes)) in enumerate(zip(runs, jax_perlayer)):
        np.testing.assert_allclose(flow, jflow, atol=TOL, err_msg=f"window {t}")
        for k in range(L):
            np.testing.assert_allclose(mems[k], jmems[k], atol=TOL, err_msg=f"window {t} unit {k}")
            if spikes[k] is not None:
                np.testing.assert_allclose(spikes[k], jspikes[k], atol=TOL,
                                           err_msg=f"window {t} unit {k} spikes")


def test_reference_wholenet_leaks_border_rows(nets, windows, jax_window0, jax_perlayer):
    """Records the reference fault: JAX ``PallasFusedFireNet`` differs from
    the JAX per-layer ``FusedFireNet`` (FireNet's SAME padding) in image
    row 0 at window 0, because its halo rows outside the image are not
    zeroed; the port's whole-net step agrees with the per-layer path there."""
    jflow = jax_window0["fused_net", "f32"][0]
    ref = jax_perlayer[0][0]
    assert float(np.abs(jflow[:, 0] - ref[:, 0]).max()) > 1e-3
    flow = port_run(WholeNetFireNet(nets[2], torch.float32), windows, 1)[0][0]
    np.testing.assert_allclose(flow[:, 0], ref[:, 0], atol=TOL)
    # the interior rows agree: the fault is the border only
    np.testing.assert_allclose(jflow[:, L:H - L], ref[:, L:H - L], atol=TOL)


def test_port_runners_agree(nets, windows):
    """The four runners compute one function: equal flow, membranes and
    kept spikes over two windows."""
    runs = {name: port_run(cls(nets[2], torch.float32), windows, 2)
            for name, (cls, _) in RUNNERS.items()}
    ref = runs.pop("lgrid")  # keeps every unit's spikes
    for name, run in runs.items():
        for (flow, mems, spikes), (rflow, rmems, rspikes) in zip(run, ref):
            assert torch.equal(torch.tensor(flow), torch.tensor(rflow)), name
            for k in range(L):
                assert torch.equal(torch.tensor(mems[k]), torch.tensor(rmems[k])), (name, k)
                if spikes[k] is not None:
                    assert torch.equal(torch.tensor(spikes[k]), torch.tensor(rspikes[k])), (name, k)


def test_plain_step_equals_per_layer_fused(nets, windows):
    """On the CPU the shared plain version runs the per-layer path's exact
    operations: bit-equal to the port's FusedFireNet (cmajor) over three
    windows."""
    fused = nets[2]
    runner = WholeNetFireNet(fused, torch.float32)
    st, rst = fused.init_states(B, H, W), runner.init_states(B, H, W)
    for x in windows[:3]:
        flow, st = fused.step(torch.tensor(x), st)
        rflow, rst = runner.step(torch.tensor(x), rst)
        assert torch.equal(flow, rflow)
        mems, spikes = runner.unit_states(rst)
        for k, s in enumerate(st):
            assert torch.equal(s.mem, mems[k])
            if spikes[k] is not None:
                assert torch.equal(s.spk, spikes[k])


@pytest.mark.parametrize("step", [fused_firenet_step, fused_firenet_step_lgrid,
                                  fused_firenet_step_loop2, fused_firenet_step_batch])
def test_steps_refuse_other_devices(nets, step):
    """A wrapper runs the plain version on the CPU, the kernel on CUDA, and
    raises on any other device."""
    runner = LayerGridFireNet(nets[2], torch.float32)
    x = torch.zeros(B, H, W, 2, device="meta")
    mems = torch.zeros(L, B, 8, H, W, device="meta")
    args = ((mems.unbind(0), mems[:2].unbind(0), runner.weights) if step is fused_firenet_step
            else (mems, mems, runner.w_stack, runner.weights))
    with pytest.raises(ValueError, match="cpu or cuda"):
        step(x, *args)


def test_launch_refuses_other_widths(nets):
    """The kernels run 32-channel units: a C=8 net is refused before any
    build or launch."""
    runner = WholeNetFireNet(nets[2], torch.float32)
    mems, _ = runner.init_states(B, H, W)
    with pytest.raises(ValueError, match="C=32"):
        launch_wholenet("fused_net", torch.zeros(B, H, W, 2), mems, [None] * L,
                        runner.weights.wk, runner.weights, mems, [None] * L)
