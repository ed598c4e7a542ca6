"""The whole-net bisection files that reach no kernel of their own:
``benchmarks/probe_wholenet_bisect2.py`` and ``probe_wholenet_bisect4.py``
call the JAX K3 ``fused_firenet_step`` (``benchmarks/pallas_archive/
fused_net.py``) with cut layer lists. The port's K3 ``fused_firenet_step``
(plain version on the CPU) is held against it, in interpret mode, for
``bisect2.py``'s lists (1 ff, 2 ff, 1 ff + 1 rec, 7 ff, the full net) at
Cin 2 and 8 and for ``bisect4.py``'s (2 ff at Cin 32, 8 and 2), C = 8,
H = 32, W = 16, TH = 16, B = 2, bf16 state, on operands that make every
sum exact.

The JAX K3 never zeros the rows outside the image, so, as
``tests/test_torch_wholenet.py`` does, unit k is compared on rows
[k, H - k) and the flow on [L - 1, H - L + 1): membranes and spikes equal,
the flow within 1e-5 (two tanh implementations). The port's K3 launch
takes a head of up to 32 input channels (packed to 16 or 32) and refuses a
wider one before any build: ``test_port_k3_launch_refuses_cin_above_32``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks.pallas_archive.fused_net import fused_firenet_step as jax_k3
from evflow_torch.ops.conv_lif import pack_weights
from evflow_torch.ops.fused_net import WholeNetWeights, fused_firenet_step, launch_wholenet

B, H, W, C, TH = 2, 32, 16, 8, 16
TOL = 1e-5
LAYERS = {  # probe_wholenet_bisect2.py:39-43
    "1ff": [False], "2ff": [False, False], "1ff+1rec": [False, True], "7ff": [False] * 7,
    "full": [False, True, False, False, True, False, False],
}
BISECT4 = {"2ff cin32": 32, "2ff cin8": 8, "2ff cin2 again": 2}  # probe_wholenet_bisect4.py:38-40


def operands(recs, cin, seed=0):
    """numpy operands in the JAX layouts: event counts x [B, Cin, H, W] in
    0..3, membranes multiples of 1/4 in [-1, 1], binary previous spikes,
    weights [C, 9 Cin (+ 9C)] k/8 with |k| <= 4, per unit [C, 3] bias k/8,
    beta k/4 in [0, 1], theta an odd multiple of 1/8, pw [2, C] k/8, pb k/16."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (B, cin, H, W)).astype(np.float32)
    mems = [rng.integers(-4, 5, (B, C, H, W)) / 4.0 for _ in recs]
    spks = [(rng.random((B, C, H, W)) < 0.5) * 1.0 for r in recs if r]
    ws = [rng.integers(-4, 5, (C, 9 * (cin if l == 0 else C) + (9 * C if r else 0))) / 8.0
          for l, r in enumerate(recs)]
    params = [np.stack([rng.integers(-4, 5, C) / 8.0, rng.integers(0, 5, C) / 4.0,
                        (2 * rng.integers(0, 8, C) + 1) / 8.0], axis=-1) for _ in recs]
    return x, mems, spks, ws, params, rng.integers(-8, 9, (2, C)) / 8.0, \
        rng.integers(-8, 9, (2, 1)) / 16.0


def run_jax(recs, x, mems, spks, ws, params, pw, pb):
    """The JAX K3 on padded arrays (zero border rows, as its runner pads),
    the slots numbered as ``bisect2.py`` numbers them; outputs unpadded, the
    flow as [B, H, W, 2]."""
    def pad(a, dtype=jnp.bfloat16):
        return jnp.asarray(np.pad(np.asarray(a, np.float32), ((0, 0), (0, 0), (TH, TH), (0, 0))),
                           dtype)

    slots, s = [], 0
    for r in recs:
        slots.append(s if r else -1)
        s += bool(r)
    with pltpu.force_tpu_interpret_mode():
        flow, m2, s2 = jax_k3(pad(x), tuple(pad(m) for m in mems), tuple(pad(p) for p in spks),
                              tuple(jnp.asarray(w, jnp.bfloat16) for w in ws),
                              tuple(jnp.asarray(p, jnp.float32) for p in params),
                              jnp.asarray(pw, jnp.bfloat16), jnp.asarray(pb, jnp.float32),
                              recurrent_slots=tuple(slots), tile_rows=TH)

    def strip(a):
        return np.asarray(a, np.float32)[..., TH:TH + H, :]

    return np.asarray(flow).transpose(0, 2, 3, 1), [strip(m) for m in m2], [strip(p) for p in s2]


def port_weights(recs, cin, ws, params, pw, pb, c=C):
    """The JAX K3's operands as the port's ``WholeNetWeights``: each [C, K]
    matrix (the unit's input taps, then its previous spikes' taps) as HWIO
    kernels packed by ``pack_weights``; params [L, 3, C]; pred [C, 2]."""
    wk = []
    for l, (r, w) in enumerate(zip(recs, ws)):
        ci = cin if l == 0 else c
        wt = torch.tensor(w, dtype=torch.float32)
        hwio = wt[:, :9 * ci].reshape(c, 3, 3, ci).permute(1, 2, 3, 0)
        rec = wt[:, 9 * ci:].reshape(c, 3, 3, c).permute(1, 2, 3, 0) if r else None
        wk.append(pack_weights(hwio, rec))
    return WholeNetWeights(
        recurrent=tuple(recs), wk=tuple(wk),
        params=torch.tensor(np.stack(params), dtype=torch.float32).transpose(1, 2).contiguous(),
        pred_w=torch.tensor(pw.T, dtype=torch.float32).contiguous(),
        pred_b=torch.tensor(pb[:, 0], dtype=torch.float32), hard_reset=True)


def check_parity(recs, cin):
    """One window through the port's K3 (plain version) and the JAX K3
    (interpret mode): unit k's membrane and a recurrent unit's spikes equal
    on rows [k, H - k), the flow within 1e-5 on rows [L - 1, H - L + 1)."""
    x, mems, spks, ws, params, pw, pb = operands(recs, cin)
    jflow, jmems, jspks = run_jax(recs, x, mems, spks, ws, params, pw, pb)
    weights = port_weights(recs, cin, ws, params, pw, pb)
    before = fused_firenet_step.launches
    flow, m2, s2 = fused_firenet_step(
        torch.tensor(x).permute(0, 2, 3, 1).contiguous(),
        tuple(torch.tensor(m, dtype=torch.bfloat16) for m in mems),
        tuple(torch.tensor(s, dtype=torch.bfloat16) for s in spks), weights)
    assert fused_firenet_step.launches == before  # the CPU runs the plain version
    L = len(recs)
    assert flow.shape == jflow.shape == (B, H, W, 2)
    np.testing.assert_allclose(flow.numpy()[:, L - 1:H - L + 1], jflow[:, L - 1:H - L + 1],
                               atol=TOL, rtol=0)
    assert len(m2) == len(jmems) == L and len(s2) == len(jspks) == sum(recs)
    for k in range(L):
        np.testing.assert_array_equal(m2[k].float().numpy()[..., k:H - k, :],
                                      jmems[k][..., k:H - k, :], err_msg=f"unit {k} mem")
    for s, k in enumerate(l for l, r in enumerate(recs) if r):
        got = s2[s].float().numpy()[..., k:H - k, :]
        np.testing.assert_array_equal(got, jspks[s][..., k:H - k, :], err_msg=f"unit {k} spikes")
        assert 0.05 < got.mean() < 0.95  # the unit fires, and not everywhere
    assert float(np.abs(jmems[-1]).mean()) > 0.05  # the last unit's state moved


@pytest.mark.parametrize("cin", [2, 8])
@pytest.mark.parametrize("name", list(LAYERS))
def test_port_k3_matches_jax_k3_on_bisect2_layer_lists(name, cin):
    """``bisect2.py``'s layer lists, as ``check_parity`` holds them."""
    check_parity(LAYERS[name], cin)


@pytest.mark.parametrize("name", list(BISECT4))
def test_port_k3_matches_jax_k3_on_bisect4_layer_lists(name):
    """``bisect4.py``'s two feedforward units at Cin 32, 8 and 2, as
    ``check_parity`` holds them: the port's K3 takes the head packed to 32
    input channels as well as to 16."""
    check_parity([False, False], BISECT4[name])


def test_port_k3_launch_refuses_cin_above_32():
    """The port's K3 launch takes a head of at most 32 input channels
    (``pack_weights`` packs Cin = 33 to 48) and refuses a wider window with
    a ValueError before any build or launch; the plain version (CPU)
    computes it."""
    recs = [False, False]
    weights = port_weights(recs, 33, [np.zeros((32, 9 * 33)), np.zeros((32, 9 * 32))],
                           [np.zeros((32, 3))] * 2, np.zeros((2, 32)), np.zeros((2, 1)), c=32)
    assert weights.wk[0].shape == (32, 9 * 48)
    xw = torch.zeros(1, 4, 4, 33)
    mem = [torch.zeros(1, 32, 4, 4) for _ in recs]
    with pytest.raises(ValueError, match="Cin <= 32"):
        launch_wholenet("fused_net", xw, mem, [None] * 2, weights.wk, weights, mem, [None] * 2)
    flow, _, _ = fused_firenet_step(xw, mem, (), weights)
    assert tuple(flow.shape) == (1, 4, 4, 2)
