"""The port's IWE functions (``evflow_torch/ops/iwe.py``) against the
reference package's (``evflow/ops/iwe.py``) on the CPU: the same f32 inputs
give bit-equal outputs (the splats add in event order on both sides),
including warped coordinates exactly on .5 under ``round_idx`` (both round
half to even) and padded events masked by ``valid``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evflow.ops import iwe as J
from evflow_torch.ops import iwe as T

B, N, H, W = 2, 300, 16, 20


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ev = np.stack([rng.uniform(0, 1, (B, N)), rng.uniform(0, H, (B, N)),
                   rng.uniform(0, W, (B, N)), rng.choice([-1.0, 1.0], (B, N))], -1)
    return dict(
        events=ev.astype(np.float32),
        flow_map=rng.normal(0, 0.03, (B, H, W, 2)).astype(np.float32),
        flow=rng.normal(0, 0.03, (B, N, 2)).astype(np.float32),
        valid=(rng.uniform(size=(B, N)) > 0.2).astype(np.float32),
        pos=(ev[..., 3] > 0).astype(np.float32),
        neg=(ev[..., 3] < 0).astype(np.float32),
    )


def both(inputs, *keys):
    return ([jnp.asarray(inputs[k]) for k in keys], [torch.tensor(inputs[k]) for k in keys])


def assert_same(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_lookup_event_flow(inputs):
    (jf, je), (tf, te) = both(inputs, "flow_map", "events")
    assert_same(J.lookup_event_flow(jf, je), T.lookup_event_flow(tf, te))
    assert_same(J._event_linear_idx(je, (H, W)), T._event_linear_idx(te, (H, W)))
    with pytest.raises(ValueError, match="resolution"):
        T.lookup_event_flow(tf, te, (H + 1, W))


@pytest.mark.parametrize("round_idx", [True, False])
@pytest.mark.parametrize("tref", [1.0, 0.25])
def test_get_interpolation_and_interpolate(inputs, round_idx, tref):
    (je, jf, jv, jp), (te, tf, tv, tp) = both(inputs, "events", "flow", "valid", "pos")
    ji, jw = J.get_interpolation(je, jf, tref, (H, W), 64.0, round_idx=round_idx, valid=jv)
    ti, tw = T.get_interpolation(te, tf, tref, (H, W), 64.0, round_idx=round_idx, valid=tv)
    assert_same(ji, ti)
    assert_same(jw, tw)
    pm = jnp.tile(jp, (1, 1 if round_idx else 4))
    assert_same(J.interpolate(ji, jw, (H, W), polarity_mask=pm),
                T.interpolate(ti, tw, (H, W), polarity_mask=torch.tensor(np.asarray(pm))))
    w3 = np.stack([np.asarray(jw), np.asarray(jw) * 0.5, np.asarray(jw) * np.asarray(pm)], -1)
    assert_same(J.interpolate_multi(ji, jnp.asarray(w3), (H, W)),
                T.interpolate_multi(ti, torch.tensor(w3), (H, W)))


def test_round_idx_ties_at_half(inputs):
    """Warped coordinates exactly on .5 (zero displacement at tref = ts):
    both round half to even, so 2.5 -> 2 and 3.5 -> 4."""
    ev = inputs["events"].copy()
    ev[..., 0] = 1.0
    ev[..., 1] = np.floor(ev[..., 1]) + 0.5
    ev[..., 2] = np.floor(ev[..., 2]) + 0.5
    flow = np.zeros((B, N, 2), np.float32)
    ji, jw = J.get_interpolation(jnp.asarray(ev), jnp.asarray(flow), 1.0, (H, W), 64.0,
                                 round_idx=True)
    ti, tw = T.get_interpolation(torch.tensor(ev), torch.tensor(flow), 1.0, (H, W), 64.0,
                                 round_idx=True)
    assert_same(ji, ti)
    assert_same(jw, tw)
    y, x = ti.numpy() // W, ti.numpy() % W
    inb = tw.numpy() > 0
    np.testing.assert_array_equal(y[inb] % 2, 0)
    np.testing.assert_array_equal(x[inb] % 2, 0)


@pytest.mark.parametrize("round_idx", [True, False])
def test_deblur_and_pol_iwe(inputs, round_idx):
    (jf, je, jv, jp, jn), (tf, te, tv, tp, tn) = both(inputs, "flow_map", "events", "valid",
                                                      "pos", "neg")
    assert_same(J.deblur_events(jf, je, (H, W), 64.0, round_idx, jp, jv, tref=0.5),
                T.deblur_events(tf, te, (H, W), 64.0, round_idx, tp, tv, tref=0.5))
    assert_same(J.compute_pol_iwe(jf, je, (H, W), jp, jn, 64.0, round_idx, jv),
                T.compute_pol_iwe(tf, te, (H, W), tp, tn, 64.0, round_idx, tv))
