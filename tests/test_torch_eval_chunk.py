"""``evaluate(chunk=K)`` and ``evaluate(device_metrics=True)`` of the port:
against the port's per-window path and against the reference package's
``evaluate`` on the same synthetic data and weights, with rollovers inside
chunks, the ``max_windows`` overshoot, heat maps and all seven metrics.

Two sequences of 20 windows, so that chunks of 3 and 8 leave partial
chunks at each rollover and at the end."""

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from _torch_port import eval_config, seeded_flax_firenet
from evflow.eval import evaluate as jax_evaluate
from evflow.loss.metrics import _BaseMetric as JaxMetric
from evflow_torch.chunk import ChunkProgram
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.eval import evaluate
from evflow_torch.loss.metrics import _BaseMetric as PortMetric

ALL = ["AEE", "NEE", "AAE", "NAAE", "AE_ofMeans", "AAE_Weighted", "AAE_Filtered"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_eval_chunk"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=20000,
                 duration=2.0, flows=[(12.0, -6.0), (-8.0, 4.0)])
    cfg = eval_config(root, res=16, std=32)
    _, v = seeded_flax_firenet(cfg["model"], seed=11)
    return cfg, v


@pytest.fixture(scope="module")
def per_window(setup):
    cfg, v = setup
    stats = {}
    res = evaluate(cfg, variables=v, device="cpu", debug=True, stats=stats)
    assert stats["windows"] == 40
    return res


def assert_results_close(ours, ref, rel, atol=1e-7):
    assert set(ours) == set(ref)
    for metric, per_file in ref.items():
        assert set(ours[metric]) == set(per_file), metric
        for fname, value in per_file.items():
            np.testing.assert_allclose(float(ours[metric][fname]), float(value),
                                       rtol=rel, atol=atol, err_msg=f"{metric} {fname}")


def with_metrics(cfg, names=None, **metrics):
    out = dict(cfg, metrics=dict(cfg["metrics"], **metrics))
    if names is not None:
        out["metrics"]["name"] = list(names)
    return out


@pytest.fixture
def chunk_runs(monkeypatch):
    """Counts the chunk dispatches of the runs in a test."""
    runs = []
    orig = ChunkProgram.run

    def counted(self):
        runs.append(1)
        return orig(self)

    monkeypatch.setattr(ChunkProgram, "run", counted)
    return runs


@pytest.mark.parametrize("chunk", [3, 8])
@pytest.mark.parametrize("device_metrics", [False, True])
def test_chunks_match_per_window(setup, per_window, chunk_runs, chunk, device_metrics):
    """Chunks of 3 and 8 (full chunks of 18 and 16 windows a sequence, the
    rest per window at each rollover and at the end) give the per-window
    results."""
    cfg, v = setup
    stats = {}
    ours = evaluate(cfg, variables=v, device="cpu", debug=True, chunk=chunk,
                    device_metrics=device_metrics, stats=stats)
    assert stats["windows"] == 40
    assert len(chunk_runs) == 2 * (20 // chunk)
    assert_results_close(ours, per_window, 1e-6)


@pytest.mark.parametrize("fused,rel", [(False, 1e-4), (True, 1e-3)])
def test_chunk_matches_reference(setup, fused, rel):
    """The port's chunks against the reference's scanned chunks: the
    unfused f32 path over both sequences; the fused bf16-conv path
    (reference in interpret mode) over the first 12 windows."""
    cfg, v = setup
    kw = dict(max_windows=12) if fused else {}
    with pltpu.force_tpu_interpret_mode():
        ref = jax_evaluate(cfg, variables=v, fused=fused, debug=True, chunk=8,
                           verbose=False, **kw)
    ours = evaluate(cfg, variables=v, fused=fused, device="cpu", debug=True, chunk=8, **kw)
    assert_results_close(ours, ref, rel)


@pytest.fixture
def heatmaps(monkeypatch):
    """The aggregates each run saves, by run: set ``maps["run"]`` first."""
    maps = {"run": None}

    def patch(cls):
        orig = cls.save_error_heatmap

        def capture(self, save_path, **kw):
            avg, count = self.get_final_error_heatmap()
            maps.setdefault(maps["run"], []).append((np.array(avg), np.array(count)))
            return orig(self, save_path, **kw)

        monkeypatch.setattr(cls, "save_error_heatmap", capture)

    patch(JaxMetric)
    patch(PortMetric)
    return maps


@pytest.mark.parametrize("res", [16, 32])
def test_device_metrics_match_reference_with_heatmaps(setup, tmp_path, heatmaps, res):
    """device_metrics with heat maps against the reference's device_metrics
    and the port's host path: model resolution 16 of std 32 (GT pooled,
    mask uploaded) and 32 of 32 (the mask rebuilt from the count wire)."""
    cfg, v = setup
    cfg = dict(with_metrics(cfg, ["AEE", "AAE", "NAAE"], heat_map=True),
               loader=dict(cfg["loader"], resolution=[res, res], keep_gt_full_res=False))
    heatmaps["run"] = "ref"
    ref = jax_evaluate(cfg, variables=v, path_results=str(tmp_path / "ref"), verbose=False,
                       chunk=4, device_metrics=True)
    for name, dm in (("dev", True), ("host", False)):
        heatmaps["run"] = name
        ours = evaluate(cfg, variables=v, device="cpu", path_results=str(tmp_path / name),
                        chunk=4, device_metrics=dm)
        assert_results_close(ours, ref, 1e-4)
    assert len(heatmaps["ref"]) == len(heatmaps["dev"]) == len(heatmaps["host"]) == 3
    for (ra, rc), (da, dc), (ha, hc) in zip(heatmaps["ref"], heatmaps["dev"], heatmaps["host"]):
        assert da.shape == (32, 32)
        np.testing.assert_array_equal(dc, hc)
        np.testing.assert_array_equal(dc, rc)
        np.testing.assert_allclose(da, ha, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(da, ra, rtol=1e-4, atol=1e-5)
    assert (tmp_path / "dev" / "eval" / "heatmaps" / "NAAE_heatmap.png").exists()


def test_device_metrics_keep_gt_full_res_heatmaps_match_host(setup, tmp_path, heatmaps):
    """keep_gt_full_res upsamples inside the chunk and the heat maps live at
    the GT's resolution (the reference's device path sizes them from the
    wrong axes and cannot run this): against the port's host path."""
    cfg, v = setup
    cfg = with_metrics(cfg, ["AEE", "NAAE"], heat_map=True)
    results = {}
    for name, dm in (("dev", True), ("host", False)):
        heatmaps["run"] = name
        results[name] = evaluate(cfg, variables=v, device="cpu", chunk=8, device_metrics=dm,
                                 path_results=str(tmp_path / name))
    assert_results_close(results["dev"], results["host"], 1e-6)
    assert len(heatmaps["dev"]) == len(heatmaps["host"]) == 2
    for (da, dc), (ha, hc) in zip(heatmaps["dev"], heatmaps["host"]):
        assert da.shape == (32, 32) and dc.sum() > 0
        np.testing.assert_array_equal(dc, hc)
        np.testing.assert_allclose(da, ha, rtol=1e-6, atol=1e-6)


def test_refusals_match_reference(setup):
    cfg, v = setup
    bad = [
        (dict(device_metrics=True), "chunk > 1"),
        (dict(chunk=4, device_metrics=True, cfg=with_metrics(cfg, [])), "does nothing"),
        (dict(chunk=4, device_metrics=True,
              cfg=dict(with_metrics(cfg, ["AEE"], heat_map=True),
                       data=dict(cfg["data"], mode="gtflow_dt4", window=0.25))), "heat_map"),
        (dict(cfg=dict(cfg, data=dict(cfg["data"], mode="events"))), "ground-truth"),
        (dict(cfg=dict(cfg, data=dict(cfg["data"], window=2))), "window > 1"),
    ]
    for kw, match in bad:
        c = kw.pop("cfg", cfg)
        with pytest.raises(ValueError, match=match) as ref:
            jax_evaluate(c, variables=v, debug=True, verbose=False, **kw)
        with pytest.raises(ValueError, match=match) as ours:
            evaluate(c, variables=v, device="cpu", debug=True, **kw)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("key", ["enabled", "store", "activity"])
def test_vis_settings_raise(setup, key, tmp_path):
    """The visualisation settings raise where the reference's do, with its
    message: the live and stored panels with ``device_metrics`` (which never
    fetches a flow map), the activity log with the fused step."""
    cfg, v = setup
    cfg = dict(cfg, vis=dict(cfg["vis"], **{key: True}))
    kw = (dict(fused=True) if key == "activity" else dict(chunk=8, device_metrics=True))
    kw.update(debug=key != "store", path_results=str(tmp_path))
    with pytest.raises(ValueError) as ref:
        jax_evaluate(cfg, variables=v, verbose=False, **kw)
    with pytest.raises(ValueError) as ours:
        evaluate(cfg, variables=v, device="cpu", **kw)
    assert str(ours.value) == str(ref.value)
    assert ("activity" if key == "activity" else "vis/collect_vis") in str(ours.value)


@pytest.mark.parametrize("device_metrics", [False, True])
def test_max_windows_overshoot_matches_reference(setup, device_metrics):
    """max_windows=10 at chunk 8 stops after the second full chunk (16
    windows), as the reference does."""
    cfg, v = setup
    ref = jax_evaluate(cfg, variables=v, debug=True, verbose=False, chunk=8, max_windows=10,
                       device_metrics=device_metrics)
    stats = {}
    ours = evaluate(cfg, variables=v, device="cpu", debug=True, chunk=8, max_windows=10,
                    device_metrics=device_metrics, stats=stats)
    assert stats["windows"] == 16
    assert_results_close(ours, ref, 1e-4)


def test_seven_metrics_match_reference(setup):
    """All seven metrics in one config: the reference's per-window path
    against the port's per-window path and its device metrics."""
    cfg, v = setup
    cfg = with_metrics(cfg, ALL)
    ref = jax_evaluate(cfg, variables=v, debug=True, verbose=False)
    assert set(ref) == set(ALL) | {"AEE_percent", "NEE_percent", "AAE_percent"}
    for kw in (dict(), dict(chunk=8, device_metrics=True)):
        ours = evaluate(cfg, variables=v, device="cpu", debug=True, **kw)
        assert_results_close(ours, ref, 1e-4, atol=1e-6)


def test_split_stats_on_the_cpu(setup):
    """``stats={"split": True}`` times each part of a window; the device
    part is not measured off the card."""
    cfg, v = setup
    stats = {"split": True}
    evaluate(cfg, variables=v, device="cpu", debug=True, chunk=8, device_metrics=True,
             max_windows=16, stats=stats)
    ms = stats["split_ms"]
    assert set(ms) == {"prefetch", "encode_upload", "enqueue", "device", "metrics", "capture"}
    assert ms["capture"] == 0.0  # no graphs off the card
    assert ms["device"] is None
    assert all(ms[p] > 0 for p in ("prefetch", "encode_upload", "enqueue", "metrics"))


def test_voxel_chunks_match_per_window(setup):
    """Voxel input crosses as f32 and the event mask rides up with the GT
    (no count wire to rebuild it from)."""
    cfg, v = setup
    cfg = dict(cfg, model=dict(cfg["model"], encoding="voxel"))
    base = evaluate(cfg, variables=v, device="cpu", debug=True, max_windows=16)
    for kw in (dict(chunk=4), dict(chunk=4, device_metrics=True)):
        ours = evaluate(cfg, variables=v, device="cpu", debug=True, max_windows=16, **kw)
        assert_results_close(ours, base, 1e-6)


def test_two_slots_match_reference(setup):
    """Two batch slots (each streaming its own sequence): chunks with the
    metrics on the device against the per-window path and the reference's
    device metrics."""
    cfg, v = setup
    cfg = dict(cfg, loader=dict(cfg["loader"], batch_size=2))
    ref = jax_evaluate(cfg, variables=v, debug=True, verbose=False, chunk=4,
                       device_metrics=True, max_windows=24)
    base = evaluate(cfg, variables=v, device="cpu", debug=True, max_windows=24)
    ours = evaluate(cfg, variables=v, device="cpu", debug=True, chunk=4, device_metrics=True,
                    max_windows=24)
    assert len(ours["AEE"]) == 2
    assert_results_close(ours, base, 1e-6)
    assert_results_close(ours, ref, 1e-4)
