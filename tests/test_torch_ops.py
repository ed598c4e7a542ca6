"""Port ops against the reference package: LIF update, ATan surrogate, the
plain versions of the fused conv+LIF kernels against the interpret-mode
Pallas kernels, and flow upsampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from evflow.ops import lif as jlif
from evflow.ops import surrogate as jsur
from evflow.ops.iwe import upsample_flow as jax_upsample
from evflow.ops.pallas.conv_lif import fused_conv_lif as jax_conv_lif
from evflow.ops.pallas.conv_lif_cmajor import fused_conv_lif_cmajor as jax_conv_lif_cmajor
from evflow_torch.ops import lif as tlif
from evflow_torch.ops.conv_lif import fused_conv_lif, pack_weights
from evflow_torch.ops.conv_lif_cmajor import fused_conv_lif_cmajor
from evflow_torch.ops.iwe import upsample_flow
from evflow_torch.ops.surrogate import atanspike_snn


@pytest.mark.parametrize("reset", ["zero", "subtract"])
def test_leaky_step_bit_equal(reset):
    rng = np.random.default_rng(3)
    shape = (2, 8, 8, 6)
    ff, mem = rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)
    beta = rng.uniform(-0.2, 1.2, 6).astype(np.float32)  # exercises the clip
    theta = rng.uniform(0.01, 0.8, 6).astype(np.float32)
    js, jm = jlif.leaky_step(jnp.asarray(ff), jnp.asarray(mem), jnp.asarray(beta),
                             jnp.asarray(theta), reset=reset)
    ts, tm = tlif.leaky_step(torch.tensor(ff), torch.tensor(mem), torch.tensor(beta),
                             torch.tensor(theta), reset=reset)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_leaky_step_state_quant_hook_and_bad_reset():
    ff, mem = torch.ones(4), torch.zeros(4)
    spk, m = tlif.leaky_step(ff, mem, torch.tensor(0.5), torch.tensor(2.0),
                             state_quant=lambda u: u * 3.0)
    assert spk.tolist() == [1.0] * 4 and m.tolist() == [0.0] * 4
    with pytest.raises(ValueError):
        tlif.leaky_step(ff, mem, torch.tensor(0.5), torch.tensor(2.0), reset="none")


def test_atanspike_snn_backward_matches_jax_grad():
    x = np.linspace(-1.0, 1.5, 251).astype(np.float32)  # crosses theta
    theta, alpha = 0.3, 2.0
    jg = jax.grad(lambda v: jsur.atanspike_snn(v, theta, alpha).sum())(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = atanspike_snn(xt, theta, alpha)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jsur.atanspike_snn(jnp.asarray(x), theta, alpha)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), atol=1e-6)


def draw_layer(C, seed=0):
    """One unit's operands at B=2, 16x16 with C channels, drawn with numpy."""
    rng = np.random.default_rng(seed)
    B, H, W = 2, 16, 16
    return dict(
        x=rng.normal(size=(B, H, W, C)).astype(np.float32),
        x2=rng.normal(size=(B, H, W, 2)).astype(np.float32),
        mem=rng.normal(size=(B, H, W, C)).astype(np.float32),
        w=rng.normal(0, 0.1, (3, 3, C, C)).astype(np.float32),
        w2=rng.normal(0, 0.3, (3, 3, 2, C)).astype(np.float32),
        w_rec=rng.normal(0, 0.1, (3, 3, C, C)).astype(np.float32),
        bias=rng.normal(size=C).astype(np.float32),
        beta=rng.uniform(0, 1, C).astype(np.float32),
        theta=rng.uniform(0.1, 0.8, C).astype(np.float32),
        prev=(rng.uniform(size=(B, H, W, C)) > 0.5).astype(np.float32),
    )


@pytest.fixture
def layer():
    return draw_layer(8)


@pytest.fixture
def layer24():
    """A width the kernels pad to 32 output channels (and a recurrent
    unit's [x | prev_spk] of 48 channels, not a multiple of 32)."""
    return draw_layer(24, seed=1)


@pytest.fixture
def layer5():
    """An odd width: the kernels pad it to 16 output channels and store its
    channel pairs element by element."""
    return draw_layer(5, seed=2)


CASES = {
    "feedforward": dict(head=False, recurrent=False, hard_reset=True),
    "recurrent": dict(head=False, recurrent=True, hard_reset=True),
    "soft_reset": dict(head=False, recurrent=False, hard_reset=False),
    "head": dict(head=True, recurrent=False, hard_reset=True),
}


@pytest.mark.parametrize("layout", ["nhwc", "cmajor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_lif_plain_matches_pallas(layer, case, layout):
    """The plain version a CPU tensor runs against the TPU kernel in
    interpret mode: spikes equal, mem within 1e-5 (f32 sums in another
    order)."""
    check_plain_against_pallas(layer, case, layout)


@pytest.mark.parametrize("layout", ["nhwc", "cmajor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_lif_plain_matches_pallas_at_24_channels(layer24, case, layout):
    """As ``test_conv_lif_plain_matches_pallas`` at C = 24, a width the
    kernels take since they pad the output channels to 16."""
    check_plain_against_pallas(layer24, case, layout)


@pytest.mark.parametrize("layout", ["nhwc", "cmajor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_lif_plain_matches_pallas_at_odd_width(layer5, case, layout):
    """As ``test_conv_lif_plain_matches_pallas`` at C = 5, an odd width the
    kernels take."""
    check_plain_against_pallas(layer5, case, layout)


def check_plain_against_pallas(layer, case, layout):
    c = CASES[case]
    x, w = (layer["x2"], layer["w2"]) if c["head"] else (layer["x"], layer["w"])
    prev = layer["prev"] if c["recurrent"] else None
    w_rec = layer["w_rec"] if c["recurrent"] else None

    def to_layout(a):
        return None if a is None else (np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                                       if layout == "cmajor" else a)

    jfn = jax_conv_lif_cmajor if layout == "cmajor" else jax_conv_lif
    with pltpu.force_tpu_interpret_mode():
        js, jm = jfn(jnp.asarray(to_layout(x)), jnp.asarray(to_layout(layer["mem"])),
                     jnp.asarray(w), jnp.asarray(layer["bias"]), jnp.asarray(layer["beta"]),
                     jnp.asarray(layer["theta"]),
                     prev_spk=None if prev is None else jnp.asarray(to_layout(prev)),
                     w_rec=None if w_rec is None else jnp.asarray(w_rec),
                     hard_reset=c["hard_reset"], tile_rows=8)
    tfn = fused_conv_lif_cmajor if layout == "cmajor" else fused_conv_lif
    wk = pack_weights(torch.tensor(w), None if w_rec is None else torch.tensor(w_rec))
    ts, tm = tfn(torch.tensor(to_layout(x)), torch.tensor(to_layout(layer["mem"])), wk,
                 torch.tensor(layer["bias"]), torch.tensor(layer["beta"]),
                 torch.tensor(layer["theta"]),
                 prev_spk=None if prev is None else torch.tensor(to_layout(prev)),
                 hard_reset=c["hard_reset"])
    assert 0.05 < ts.mean() < 0.95
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)


def test_conv_lif_wrappers_count_only_kernel_launches(layer):
    """A CPU tensor takes the plain version and leaves the launch counters
    alone; a tensor on neither the CPU nor a GPU is refused."""
    before = (fused_conv_lif.launches, fused_conv_lif_cmajor.launches)
    wk = pack_weights(torch.tensor(layer["w"]))
    args = [torch.tensor(layer[k]) for k in ("x", "mem")] + [wk] + [
        torch.tensor(layer[k]) for k in ("bias", "beta", "theta")]
    fused_conv_lif(*args)
    assert (fused_conv_lif.launches, fused_conv_lif_cmajor.launches) == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        fused_conv_lif(*meta)
    with pytest.raises(ValueError):
        fused_conv_lif_cmajor(*meta)


@pytest.mark.parametrize("size", [(32, 32), (40, 24)])
def test_upsample_flow_matches_jax_image_resize(size):
    """Nearest upsampling picks jax.image.resize's source pixels, also for
    ratios that are not integers (torch's "nearest-exact")."""
    flow = np.random.default_rng(1).normal(size=(2, 16, 16, 2)).astype(np.float32)
    ref = np.asarray(jax_upsample(jnp.asarray(flow), *size))
    np.testing.assert_array_equal(upsample_flow(torch.tensor(flow), *size).numpy(), ref)
