"""The port's ``evaluate`` with the settings of
``configs/eval_MVSEC_visual.yml`` (LIFFireFlowNet, downsampling without
``keep_gt_full_res``, hot filter, AEE / AAE, ``vis.store``), with
``vis.activity`` and with ``model.temporal_cnt``, against the reference
package's ``evaluate`` on the same synthetic data and weights: results,
the collected frames (flow, IWE, counts, GT), the stored panels and the
activity log."""

import os

import numpy as np
import pytest

from _torch_port import eval_config, model_cfg, seeded_flax_firenet
from evflow.eval import evaluate as jax_evaluate
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.eval import evaluate

WINDOWS = 8  # the 6 windows of the first sequence, then 2 of the second


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_eval_vis"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.6, flows=[(12.0, -6.0), (-8.0, 4.0)])
    return root


def visual_config(root, name="LIFFireFlowNet", res=16):
    cfg = eval_config(root, res=res, std=32, metrics=("AEE", "AAE"))
    cfg["model"] = model_cfg(name, 8, mask_output=True, round_encoding=False)
    cfg["loader"]["keep_gt_full_res"] = False
    cfg["vis"] = {"enabled": False, "px": 400, "bars": False, "activity": False,
                  "store": True, "store_interval": 0.0, "store_type": "video"}
    return cfg


@pytest.fixture(scope="module")
def visual(root):
    cfg = visual_config(root)
    return cfg, seeded_flax_firenet(cfg["model"], seed=11)[1]


def assert_results_close(ours, ref, rel=1e-4):
    assert set(ours) == set(ref)
    for metric, per_file in ref.items():
        assert set(ours[metric]) == set(per_file), metric
        for fname, value in per_file.items():
            np.testing.assert_allclose(float(ours[metric][fname]), float(value), rtol=rel,
                                       atol=1e-7, err_msg=f"{metric} {fname}")


@pytest.mark.parametrize("chunk", [1, 3])
def test_collect_vis_matches_reference(visual, chunk):
    """Per window (the IWE beside the step) and in chunks of 3 (the IWE on
    the host over the fetched flows): the results within 1e-4, and each
    window's flow within 1e-5, its counts and GT equal and its IWE equal
    on all but 1% of the pixels (an event whose warped coordinate lies
    within f32 rounding of a .5 may land one pixel over)."""
    cfg, v = visual
    ref, ref_frames = jax_evaluate(cfg, variables=v, debug=True, max_windows=WINDOWS,
                                   collect_vis=True, verbose=False, chunk=chunk)
    stats = {}
    ours, frames = evaluate(cfg, variables=v, device="cpu", debug=True, max_windows=WINDOWS,
                            collect_vis=True, chunk=chunk, stats=stats)
    assert stats["encoder"] == "native_fused"
    assert_results_close(ours, ref)
    assert len(frames) == len(ref_frames) >= WINDOWS
    for a, b in zip(frames, ref_frames):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["flow"], np.asarray(b["flow"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a["event_cnt"], b["event_cnt"])
        np.testing.assert_array_equal(a["gtflow"], b["gtflow"])
        iwe, ref_iwe = a["iwe"], np.asarray(b["iwe"])
        assert iwe.shape == ref_iwe.shape == (1, 16, 16, 2) and iwe.sum() == ref_iwe.sum() > 0
        assert (iwe != ref_iwe).mean() <= 0.01


def test_vis_store_writes_what_the_reference_writes(visual, tmp_path):
    """``vis.store`` (not debug): the same panel files per sequence (a
    video a panel, as the config asks), the results files beside them."""
    cfg, v = visual
    jax_evaluate(cfg, variables=v, path_results=str(tmp_path / "ref"), runid="run",
                 max_windows=WINDOWS, verbose=False)
    evaluate(cfg, variables=v, device="cpu", path_results=str(tmp_path / "ours"), runid="run",
             max_windows=WINDOWS)

    def files(d):
        return sorted(os.path.relpath(os.path.join(p, f), d)
                      for p, _, fs in os.walk(d) for f in fs)

    ours, ref = files(tmp_path / "ours"), files(tmp_path / "ref")
    assert ours == ref
    panels = [f for f in ours if f.endswith(".mp4")]
    assert {os.path.basename(f) for f in panels} >= {"events.mp4", "flow.mp4", "gtflow.mp4",
                                                     "iwe.mp4", "masked_flow_vec.mp4",
                                                     "stitched.mp4"}
    assert {f.split(os.sep)[2] for f in panels} == {"seq_000", "seq_001"}


@pytest.fixture
def jax_activity(monkeypatch):
    """The reference's activity log: what its ``vis_activity`` returns last."""
    from evflow.utils import viz as jviz

    seen = {}
    real = jviz.vis_activity

    def spy(activity, log, *a, **kw):
        seen["log"] = real(activity, log, *a, **kw)
        return seen["log"]

    monkeypatch.setattr(jviz, "vis_activity", spy)
    return seen


@pytest.mark.parametrize("kw", [dict(), dict(chunk=3, device_metrics=True)],
                         ids=["window", "chunk3_dm"])
def test_activity_matches_reference(root, jax_activity, tmp_path, kw):
    """``vis.activity`` through the unfused step: each layer's nonzero
    fraction a window, reset at the rollover, equal to the reference's
    (within f32 rounding of the mean), and the plot written unless debug."""
    cfg = visual_config(root, "LIFFireNet")
    cfg["vis"].update(store=False, activity=True)
    v = seeded_flax_firenet(cfg["model"], seed=12)[1]
    ref = jax_evaluate(cfg, variables=v, debug=True, max_windows=WINDOWS, verbose=False, **kw)
    stats = {}
    ours = evaluate(cfg, variables=v, device="cpu", path_results=str(tmp_path), runid="act",
                    max_windows=WINDOWS, stats=stats, **kw)
    assert_results_close(ours, ref)
    log, ref_log = stats["activity"], jax_activity["log"]
    assert list(log) == list(ref_log) == ["0:input", "1:head", "2:G1", "3:R1a", "4:R1b",
                                          "5:G2", "6:R2a", "7:R2b", "8:pred"]
    for k in log:
        assert len(log[k]) == len(ref_log[k]) >= 2
        np.testing.assert_allclose(log[k], ref_log[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert 0 < log["1:head"][0] < 1
    assert (tmp_path / "act" / "activity.png").exists()


@pytest.mark.parametrize("kw", [dict(), dict(chunk=3, device_metrics=True)],
                         ids=["window", "chunk3_dm"])
def test_temporal_cnt_matches_reference(root, kw):
    """``model.temporal_cnt`` at the sensor's resolution: channel 0 of the
    counts is signed, so they cross as f32 (the compact wire would wrap
    them); the results match the reference's."""
    cfg = visual_config(root, "LIFFireNet", res=32)
    cfg["model"]["temporal_cnt"] = True
    cfg["vis"]["store"] = False
    v = seeded_flax_firenet(cfg["model"], seed=13)[1]
    ref = jax_evaluate(cfg, variables=v, debug=True, max_windows=WINDOWS, verbose=False, **kw)
    ours = evaluate(cfg, variables=v, device="cpu", debug=True, max_windows=WINDOWS, **kw)
    assert_results_close(ours, ref)


def test_collect_vis_refused_with_device_metrics(visual):
    cfg, v = visual
    kw = dict(debug=True, collect_vis=True, chunk=3, device_metrics=True)
    with pytest.raises(ValueError) as ref:
        jax_evaluate(cfg, variables=v, verbose=False, **kw)
    with pytest.raises(ValueError) as ours:
        evaluate(cfg, variables=v, device="cpu", **kw)
    assert str(ours.value) == str(ref.value)
