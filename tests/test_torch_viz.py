"""The port's visualisation (``evflow_torch/utils/viz.py``) against the
reference package's (``evflow/utils/viz.py``): every rendering bit-equal,
the stored files alike, the activity log and plot, and a host without cv2
(panels rendered, nothing written, one notice)."""

import os

import matplotlib.colors
import numpy as np
import pytest

from evflow.utils import viz as J
from evflow_torch.utils import viz as T


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    H, W = 24, 32
    return dict(
        flow=rng.normal(0, 2, (H, W, 2)).astype(np.float32),
        gt=rng.normal(0, 2, (H, W, 2)).astype(np.float32),
        cnt=rng.poisson(0.8, (H, W, 2)).astype(np.float32),
        err=rng.uniform(0, 3, (H, W)).astype(np.float32),
        mask=rng.uniform(size=(H, W)) > 0.6,
    )


def test_hsv_to_rgb_matches_matplotlib():
    rng = np.random.default_rng(1)
    hsv = rng.uniform(0, 1, (64, 48, 3))
    hsv[::5, :, 1] = 0.0  # grey
    hsv[::7, :, 0] = 1.0  # the wrap of the hue
    np.testing.assert_array_equal(T.hsv_to_rgb(hsv), matplotlib.colors.hsv_to_rgb(hsv))


def test_renderings_bit_equal(arrays):
    a = arrays
    uniform = np.ones_like(a["flow"]) * [1.5, -0.5]
    for flow in (a["flow"], uniform, np.zeros_like(a["flow"])):
        np.testing.assert_array_equal(T.flow_to_image(flow), J.flow_to_image(flow))
    np.testing.assert_array_equal(T.flow_to_image(uniform, 0.5), J.flow_to_image(uniform, 0.5))
    np.testing.assert_array_equal(T.events_to_image(a["cnt"]), J.events_to_image(a["cnt"]))
    for deg in (False, True):
        np.testing.assert_array_equal(T.error_to_image(a["err"], a["mask"], deg),
                                      J.error_to_image(a["err"], a["mask"], deg))
    bg = T.events_to_image(a["cnt"]) // 2
    for mode in ("grid", "sparse", "center"):
        np.testing.assert_array_equal(
            T.flow_to_vector(a["flow"], 4, 2.0, a["gt"], mode, a["mask"], bg),
            J.flow_to_vector(a["flow"], 4, 2.0, a["gt"], mode, a["mask"], bg))


def stored_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_store_writes_what_the_reference_writes(arrays, tmp_path):
    a = arrays
    cfg = {"vis": {"store_type": "image", "store_interval": 0.05, "vec_mode": "sparse"}}
    inputs = {"event_cnt": a["cnt"][None], "gtflow": a["gt"][None],
              "event_mask": a["mask"][None, ..., None].astype(np.float32)}
    visions = {}
    for name, mod in (("ours", T), ("ref", J)):
        vis = mod.Visualization(cfg, eval_id=3, path_results=str(tmp_path / name))
        for i, ts in enumerate((0.0, 0.01, 0.1)):  # the second is throttled
            vis.store(inputs, a["flow"][None] * (i + 1), a["cnt"][None], "seq_000",
                      masked_flow=a["flow"][None] * a["mask"][None, ..., None], ts=ts,
                      error_map=a["err"][None], error_is_angle=True)
        vis.close_videos()
        visions[name] = vis
    ours, ref = stored_files(tmp_path / "ours"), stored_files(tmp_path / "ref")
    assert ours == ref and len(ours) == 2 * len(J.Visualization.KINDS)
    import cv2

    for f in ours:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours" / f)),
                                      cv2.imread(str(tmp_path / "ref" / f)), err_msg=f)


def test_without_cv2_nothing_is_written(arrays, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(T, "cv2", None)
    a = arrays
    vis = T.Visualization({"vis": {"store_type": "video"}}, path_results=str(tmp_path))
    for _ in range(3):
        vis.store({"event_cnt": a["cnt"]}, a["flow"], a["cnt"], "seq")
    assert stored_files(tmp_path) == [] and vis.unwritten == 3 * 3
    assert capsys.readouterr().err.count("no cv2") == 1
    np.testing.assert_array_equal(T.flow_to_vector(a["flow"]), np.zeros((24, 32, 3), np.uint8))


def test_vis_activity_log_and_plot(tmp_path):
    log_t = log_j = None
    for i in range(4):
        act = {"0:input": 0.1 * i, "1:head": 0.5}
        log_t, log_j = T.vis_activity(act, log_t), J.vis_activity(act, log_j)
    assert log_t == log_j
    assert T.vis_activity(None, log_t) is log_t
    T.vis_activity({}, log_t, save_path=str(tmp_path / "activity.png"))
    assert (tmp_path / "activity.png").stat().st_size > 0
