"""Port host data path and metrics against the reference package: the HDF5
stream window by window, the synthetic generator, the numpy encodings, and
AEE / AAE / AE_ofMeans."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import eval_config
from evflow.data import encodings as jenc
from evflow.data.h5_stream import H5EventStream as JaxStream
from evflow.data.synthetic import make_dataset as jax_make_dataset
from evflow.loss import metrics as JM
from evflow_torch.data import encodings as tenc
from evflow_torch.data.h5_stream import H5EventStream, Prefetcher
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.loss import metrics as TM


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_stream"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.8, flows=[(10.0, -5.0), (-6.0, 3.0)])
    return root


def test_synthetic_files_match_reference_generator(dataset, tmp_path):
    ref = str(tmp_path / "ref")
    jax_make_dataset(ref, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                     duration=0.8, flows=[(10.0, -5.0), (-6.0, 3.0)])
    for name in ("seq_000.h5", "seq_001.h5"):
        with h5py.File(f"{dataset}/{name}") as a, h5py.File(f"{ref}/{name}") as b:
            for key in ("events/xs", "events/ys", "events/ts", "events/ps",
                        "flow_dt1/frame_000003"):
                np.testing.assert_array_equal(a[key][...], b[key][...])
            assert dict(a.attrs) == dict(b.attrs)


STREAM_KEYS = ("event_cnt", "event_mask", "gtflow", "dt_gt", "dt_input", "new_seq",
               "hot_mask", "ts")


@pytest.mark.parametrize("res,keep_full,batch", [(16, True, 1), (16, False, 2), (32, True, 1)])
def test_stream_matches_reference_window_by_window(dataset, res, keep_full, batch):
    """Every key the evaluation reads, array-equal, across a rollover, with
    the hot filter on and with / without downsampling."""
    cfg = eval_config(dataset, res=res, std=32)
    cfg["loader"].update(keep_gt_full_res=keep_full, batch_size=batch)
    ours, ref = H5EventStream(cfg, 2), JaxStream(cfg, 2)
    try:
        saw_rollover = saw_hot = False
        for _ in range(10):
            a, b = ours.next_batch(), ref.next_batch()
            for k in STREAM_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for k in ("epoch_done", "seq_num", "file_names"):
                assert a[k] == b[k], k
            saw_rollover |= bool(a["new_seq"].any())
            saw_hot |= bool((a["hot_mask"] == 0).any())
        assert saw_rollover and saw_hot
    finally:
        ours.close()
        ref.close()


def test_npz_sequences_stream_like_h5(dataset, tmp_path):
    """The numpy-archive form of the same sequences (for hosts without
    h5py) gives the same batches as the HDF5 files."""
    npz = str(tmp_path / "npz")
    make_dataset(npz, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.8, flows=[(10.0, -5.0), (-6.0, 3.0)], fmt="npz")
    a = H5EventStream(eval_config(dataset), 2)
    b = H5EventStream(eval_config(npz), 2)
    try:
        for _ in range(10):
            x, y = a.next_batch(), b.next_batch()
            for k in STREAM_KEYS:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            assert [f.replace(".h5", "") for f in x["file_names"]] == [
                f.replace(".npz", "") for f in y["file_names"]]
    finally:
        a.close()
        b.close()


def test_prefetcher_yields_the_stream_in_order(dataset):
    cfg = eval_config(dataset)
    direct, behind = H5EventStream(cfg, 2), H5EventStream(cfg, 2)
    fetch = Prefetcher(behind, depth=2)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(next(fetch)["event_cnt"],
                                          direct.next_batch()["event_cnt"])
    finally:
        fetch.close()
        direct.close()
        behind.close()


def test_numpy_encodings_match_reference():
    rng = np.random.default_rng(0)
    n, res = 500, (12, 10)
    xs = rng.integers(0, res[1], n).astype(np.float32)
    ys = rng.integers(0, res[0], n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    np.testing.assert_array_equal(tenc.np_events_to_channels(xs, ys, ps, res),
                                  jenc.np_events_to_channels(xs, ys, ps, res))
    np.testing.assert_array_equal(tenc.np_events_to_mask(xs, ys, ps, res),
                                  jenc.np_events_to_mask(xs, ys, ps, res))
    np.testing.assert_array_equal(tenc.np_events_to_voxel(xs, ys, ts, ps, 5, res),
                                  jenc.np_events_to_voxel(xs, ys, ts, ps, 5, res))
    np.testing.assert_array_equal(tenc.np_polarity_mask(ps), jenc.np_polarity_mask(ps))
    rate = rng.uniform(0, 1, res).astype(np.float32)
    np.testing.assert_array_equal(tenc.np_hot_event_mask(rate.copy(), 9, max_px=7),
                                  jenc.np_hot_event_mask(rate.copy(), 9, max_px=7))


@pytest.fixture
def metric_inputs():
    rng = np.random.default_rng(0)
    B, H, W = 2, 12, 10
    gt = rng.normal(0, 2, (B, H, W, 2)).astype(np.float32)
    gt[:, :3] = 0.0  # invalid GT rows
    return dict(
        flow=rng.normal(0, 0.05, (B, H, W, 2)).astype(np.float32),
        gtflow=gt,
        event_mask=(rng.uniform(size=(B, H, W)) > 0.4).astype(np.float32),
        dt_gt=np.array([0.1, 0.05], np.float32),
        dt_input=np.array([0.1, 0.07], np.float32),
    )


@pytest.mark.parametrize("name,strict", [("aee", False), ("aae", False), ("aae", True),
                                         ("ae_of_means", False)])
def test_metric_functions_match_reference(metric_inputs, name, strict):
    kw = {"strict": strict} if name == "aae" else {}
    j = getattr(JM, name)(*[jnp.asarray(metric_inputs[k]) for k in metric_inputs],
                          flow_scaling=128.0, **kw)
    t = getattr(TM, name)(*[torch.tensor(metric_inputs[k]) for k in metric_inputs],
                          flow_scaling=128.0, **kw)
    j, t = (j, t) if isinstance(j, tuple) else ((j,), (t,))
    # values and outlier rates within rtol 1e-5; the per-pixel angle maps
    # within 1e-5 absolute, since arccos next to its clip at 1 - 1e-5
    # magnifies an f32 rounding of cos about 224-fold
    for a, b in zip(t[:2], j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    if len(t) == 4:
        np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


@pytest.mark.parametrize("cls", ["AEE", "AAE", "AEofMeans"])
def test_metric_classes_match_reference(metric_inputs, cls):
    """Association, a per-slot reset and heatmap accumulation at the std
    resolution."""
    cfg = {"loader": {"resolution": [12, 10], "std_resolution": [24, 20]}}
    jc, tc = getattr(JM, cls)(cfg, flow_scaling=64), getattr(TM, cls)(cfg, flow_scaling=64)
    inp = {k: metric_inputs[k] for k in ("gtflow", "dt_gt", "dt_input")}
    inp["event_mask"] = metric_inputs["event_mask"][..., None]
    for _ in range(2):
        jc.event_flow_association([jnp.asarray(metric_inputs["flow"])],
                                  {k: jnp.asarray(v) for k, v in inp.items()})
        tc.event_flow_association([torch.tensor(metric_inputs["flow"])],
                                  {k: torch.tensor(v) for k, v in inp.items()})
        jc.reset(slots=np.array([False, True]))
        tc.reset(slots=np.array([False, True]))
        jv, tv = jc(), tc()
        jv, tv = (jv, tv) if isinstance(jv, tuple) else ((jv,), (tv,))
        for a, b in zip(tv, jv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    ja, jn = jc.get_final_error_heatmap()
    ta, tn = tc.get_final_error_heatmap()
    if ja is None:
        assert ta is None
    else:
        assert ta.shape == (24, 20)
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5)  # angle maps, as above
        np.testing.assert_array_equal(tn, jn)


# -- every window mode, by every encoder --------------------------------------

ALL_KEYS = ("event_cnt", "event_mask", "event_voxel", "event_list", "event_list_pol_mask",
            "event_valid", "gtflow", "frames", "hot_mask", "dt_input", "dt_gt", "new_seq", "ts")
AUGMENT = dict(augment=["Horizontal", "Vertical", "Polarity"], augment_prob=[0.5, 0.5, 0.5])
MODE_CASES = {  # name: (windows, resolution, config sections to update)
    "gtflow_pooled": (10, 16, {}),
    "gtflow_dt4_voxel": (40, 32, dict(data=dict(mode="gtflow_dt4", window=0.25),
                                      model=dict(encoding="voxel", num_bins=5))),
    "voxel_round_pooled": (10, 16, dict(model=dict(encoding="voxel", num_bins=3,
                                                   round_encoding=True),
                                        loader=dict(keep_gt_full_res=False))),
    "temporal_cnt": (10, 32, dict(model=dict(temporal_cnt=True))),
    "augment_b2": (12, 16, dict(loader=dict(batch_size=2, **AUGMENT))),
    "no_caches_fetch2": (12, 16, dict(loader=dict(batch_size=2, event_cache_bytes=0,
                                                  ts_cache_bytes=0, fetch_workers=2))),
    "events": (16, 32, dict(data=dict(mode="events", window=2000), loader=dict(batch_size=2))),
    "events_filtered": (20, 16, dict(data=dict(mode="events", window=1000),
                                     loader=dict(batch_size=2, **AUGMENT))),
    "time": (20, 32, dict(data=dict(mode="time", window=0.05), loader=dict(batch_size=2))),
    "frames": (12, 16, dict(data=dict(mode="frames", window=1),
                            loader=dict(batch_size=2, **AUGMENT))),
}


@pytest.fixture(scope="module")
def frames_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_stream_frames"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.8, flows=[(10.0, -5.0), (-6.0, 3.0)], with_frames=True)
    return root


def mode_config(root, case, encoder):
    _, res, updates = MODE_CASES[case]
    cfg = eval_config(root, res=res, std=32)
    for section, values in updates.items():
        cfg[section].update(values)
    cfg["loader"].update(native_encoder=encoder != "numpy",
                         fused_assembly=encoder == "native_fused")
    return cfg


@pytest.mark.parametrize("encoder", ["native_fused", "native", "numpy"])
@pytest.mark.parametrize("case", list(MODE_CASES))
def test_every_mode_matches_reference(frames_dataset, case, encoder):
    """Each window mode (with the spatially filtered read, temporal_cnt,
    augmentation at B=2, the caches off and two fetch workers) by each of
    the three encoders: every key of every batch equal to the reference's,
    in value and type, across rollovers; get_iters alike."""
    import copy

    cfg = mode_config(frames_dataset, case, encoder)
    bins = cfg["model"]["num_bins"]
    ours, ref = H5EventStream(cfg, bins), JaxStream(copy.deepcopy(cfg), bins)
    assert ours.encoder == encoder
    try:
        saw_rollover = False
        for _ in range(MODE_CASES[case][0]):
            a, b = ours.next_batch(), ref.next_batch()
            assert set(a) == set(b)
            for k in ALL_KEYS:
                if k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            for k in ("epoch_done", "seq_num", "file_names"):
                assert a[k] == b[k], k
            assert [ours.get_iters(s) for s in range(ours.batch_size)] == [
                ref.get_iters(s) for s in range(ref.batch_size)]
            saw_rollover |= bool(a["new_seq"].any())
        assert saw_rollover
        if case == "no_caches_fetch2":  # the uncached reads ran
            assert not ours._ev_cache and all(f.ts_cache is None for f in ours.open_files)
    finally:
        ours.close()
        ref.close()


def test_shuffle_and_end_epoch_match_reference(frames_dataset):
    cfg = mode_config(frames_dataset, "frames", "native_fused")
    ours, ref = H5EventStream(cfg, 2), JaxStream(cfg, 2)
    try:
        ours.shuffle()
        ref.shuffle()
        assert ours.files == ref.files
        ours.end_epoch()
        ref.end_epoch()
        assert (ours.epoch, ours.samples) == (ref.epoch, ref.samples) == (1, 0)
    finally:
        ours.close()
        ref.close()


def test_failed_host_build_raises(dataset, tmp_path, monkeypatch):
    """A host library that does not build stops the stream with the
    compiler's message; numpy encodes only when the config asks for it."""
    from evflow_torch.data import native

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    cfg = eval_config(dataset)
    with pytest.raises(RuntimeError, match="host library build failed"):
        H5EventStream(cfg, 2)
    cfg["loader"]["native_encoder"] = False
    stream = H5EventStream(cfg, 2)
    assert stream.encoder == "numpy"
    assert stream.next_batch()["event_cnt"].shape == (1, 16, 16, 2)
    stream.close()
