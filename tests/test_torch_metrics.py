"""The seven validation metrics of the port against the reference package's
on the same seeded draws: the functions, the classes' heat-map aggregates
after three windows, and ``merge_aggregated``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evflow.loss import metrics as JM
from evflow.registry import build_metrics as jax_build_metrics
from evflow_torch.loss import metrics as TM
from evflow_torch.registry import build_metrics

FUNCS = [("aee", {}), ("nee", {}), ("aae", {}), ("aae", {"strict": True}), ("naae", {}),
         ("ae_of_means", {}), ("aae_weighted", {}), ("aae_filtered", {"mag_threshold": 0.5}),
         ("aae_filtered", {"mag_threshold": 0.0})]
ALL = ["AEE", "NEE", "AAE", "NAAE", "AE_ofMeans", "AAE_Weighted", "AAE_Filtered"]


def draw(seed, B=2, H=16, W=16):
    """Flow, GT with invalid rows, an event mask and dt, one slot with
    ``dt_gt = 0``."""
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 2, (B, H, W, 2)).astype(np.float32)
    gt[:, :2] = 0.0
    return dict(
        flow=rng.normal(0, 0.05, (B, H, W, 2)).astype(np.float32),
        gtflow=gt,
        event_mask=(rng.uniform(size=(B, H, W)) > 0.4).astype(np.float32),
        dt_gt=np.array([0.1, 0.0], np.float32)[:B],
        dt_input=np.array([0.1, 0.07], np.float32)[:B],
    )


@pytest.mark.parametrize("name,kw", FUNCS, ids=[f"{n}-{kw}" for n, kw in FUNCS])
@pytest.mark.parametrize("seed", [0, 1])
def test_metric_functions_match_reference(name, kw, seed):
    d = draw(seed)
    j = getattr(JM, name)(*[jnp.asarray(v) for v in d.values()], flow_scaling=128.0, **kw)
    t = getattr(TM, name)(*[torch.tensor(v) for v in d.values()], flow_scaling=128.0, **kw)
    j, t = (j, t) if isinstance(j, tuple) else ((j,), (t,))
    assert len(j) == len(t)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def config(names, res=16, std=32):
    return {"loader": {"resolution": [res, res], "std_resolution": [std, std]},
            "metrics": {"name": list(names)}}


@pytest.mark.parametrize("std", [16, 32])
def test_metric_classes_and_heatmaps_match_reference(std):
    """Every class over 3 windows (association, a slot reset, the call) and
    the heat maps aggregated at the std resolution, then the same sums
    folded in once more through ``merge_aggregated``."""
    cfg = config(ALL, std=std)
    jc, tc = jax_build_metrics(cfg, 64.0), build_metrics(cfg, 64.0)
    for w in range(3):
        d = draw(10 + w)
        inp = {k: d[k] for k in ("gtflow", "dt_gt", "dt_input")}
        inp["event_mask"] = d["event_mask"][..., None]
        for jm, tm in zip(jc, tc):
            jm.event_flow_association([jnp.asarray(d["flow"])],
                                      {k: jnp.asarray(v) for k, v in inp.items()})
            tm.event_flow_association([torch.tensor(d["flow"])],
                                      {k: torch.tensor(v) for k, v in inp.items()})
            if w == 1:
                jm.reset(slots=np.array([False, True]))
                tm.reset(slots=np.array([False, True]))
            jv, tv = jm(), tm()
            jv, tv = (jv, tv) if isinstance(jv, tuple) else ((jv,), (tv,))
            for a, b in zip(tv, jv):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
            assert tm.has_percent == jm.has_percent
    for name, jm, tm in zip(ALL, jc, tc):
        ja, jn = jm.get_final_error_heatmap()
        ta, tn = tm.get_final_error_heatmap()
        if name not in ("AEE", "AAE", "NAAE"):
            assert ja is None and ta is None
            continue
        assert ta.shape == (std, std)
        np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tn, jn)
        # sums at the std resolution (copies: the aggregates are returned as they are)
        e, c, tn = ja * (jn + 1e-9), jn.copy(), tn.copy()
        jm.merge_aggregated(e, c)
        tm.merge_aggregated(e, c)
        np.testing.assert_allclose(tm.get_final_error_heatmap()[0],
                                   jm.get_final_error_heatmap()[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tm.get_final_error_heatmap()[1], 2 * tn)


def test_registry_builds_all_seven_and_rejects_the_rest():
    got = build_metrics(config(ALL), 128.0)
    assert [type(m).__name__ for m in got] == [type(m).__name__
                                              for m in jax_build_metrics(config(ALL), 128.0)]
    assert got[-1].mag_threshold == 0.5 and got[2].strict is False
    with pytest.raises(KeyError) as ours:
        build_metrics(config(["AEE", "EPE"]), 128.0)
    with pytest.raises(KeyError) as ref:
        jax_build_metrics(config(["AEE", "EPE"]), 128.0)
    assert str(ours.value) == str(ref.value)


def test_save_error_heatmap(tmp_path):
    """The image is written where something was scored; nothing else."""
    m = TM.AEE(config(["AEE"]), 64.0)
    assert m.save_error_heatmap(str(tmp_path / "none.png")) is False
    d = draw(3)
    m.event_flow_association([torch.tensor(d["flow"])],
                             {"gtflow": torch.tensor(d["gtflow"]),
                              "event_mask": torch.tensor(d["event_mask"][..., None]),
                              "dt_gt": torch.tensor(d["dt_gt"]),
                              "dt_input": torch.tensor(d["dt_input"])})
    m()
    assert m.save_error_heatmap(str(tmp_path / "aee.png"), title="AEE")
    assert (tmp_path / "aee.png").stat().st_size > 0
