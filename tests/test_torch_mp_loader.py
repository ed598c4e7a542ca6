"""The port's multi-process loader (``evflow_torch.data.mp_loader``) against
the reference package's streams, on the 24x24 synthetic set of
``tests/test_mp_loader.py``: each worker's batches bit-equal to the JAX
``H5EventStream`` over the worker's shard refinement (``num_shards=2``,
``shard_index=w``, ``B/2`` slots, seed ``+ w``), concatenated and
re-padded, in ``events`` and ``gtflow_dt1`` mode; ``epoch_done`` on the
slowest shard; a failing and a dead worker raising in the parent; the
worker-count refusals and ``build_stream``'s choice; and ``evaluate`` and
``train`` through the loader."""

import shutil

import numpy as np
import pytest

from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from evflow.data.h5_stream import H5EventStream as JaxStream
from evflow_torch.data.h5_stream import H5EventStream
from evflow_torch.data.mp_loader import MPEventStream, build_stream, worker_configs
from evflow_torch.data.synthetic import make_dataset

ARRAY_KEYS = (
    "event_cnt", "event_voxel", "event_mask", "event_list",
    "event_list_pol_mask", "event_valid", "dt_input", "new_seq", "ts",
)
PADDED = ("event_list", "event_list_pol_mask", "event_valid")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mp_synth"))
    make_dataset(root, num_sequences=4, resolution=(24, 24), events_per_sec=20_000,
                 duration=0.4, gt_hz=10.0,
                 flows=[(10.0, -5.0), (-8.0, 4.0), (6.0, 6.0), (-4.0, -9.0)])
    return root


def base_cfg(root, batch=4, workers=1, window=600, seed=3, mode="events"):
    return {
        "data": {"path": root, "mode": mode, "window": window},
        "loader": {
            "resolution": [24, 24], "std_resolution": [24, 24],
            "batch_size": batch, "num_workers": workers, "seed": seed,
            "augment": ["Horizontal", "Polarity"], "augment_prob": [0.5, 0.5],
        },
        "hot_filter": {"enabled": False},
        "vis": {"bars": False},
    }


def reference_shards(cfg, workers):
    """The reference streams of the workers' shards, configured by hand."""
    refs = []
    for w in range(workers):
        c = base_cfg(cfg["data"]["path"], batch=cfg["loader"]["batch_size"] // workers,
                     window=cfg["data"]["window"], seed=3 + w, mode=cfg["data"]["mode"])
        c["loader"].update(num_shards=workers, shard_index=w)
        del c["loader"]["num_workers"]
        refs.append(JaxStream(c, 2))
    return refs


def worker_libraries(pid):
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    return {"libtorch": "libtorch" in maps, "libcuda": "libcuda" in maps}


@pytest.mark.parametrize("mode,window,batches", [("events", 600, 10), ("gtflow_dt1", 1, 6)])
def test_worker_batches_equal_reference_shard_streams(dataset, mode, window, batches):
    """Every batch of ``MPEventStream(W=2)`` is the concatenation of the
    reference's shard streams' batches, the event lists zero-padded to the
    widest, bit for bit; the workers load neither torch nor CUDA."""
    cfg = base_cfg(dataset, batch=4, workers=2, window=window, mode=mode)
    stream = MPEventStream(cfg, 2)
    refs = reference_shards(cfg, 2)
    try:
        for _ in range(batches):
            got = stream.next_batch()
            subs = [r.next_batch() for r in refs]
            n_pad = max(s["event_list"].shape[1] for s in subs)
            for k in ARRAY_KEYS:
                parts = [np.pad(s[k], [(0, 0), (0, n_pad - s[k].shape[1])]
                                + [(0, 0)] * (s[k].ndim - 2)) if k in PADDED else s[k]
                         for s in subs]
                np.testing.assert_array_equal(got[k], np.concatenate(parts), err_msg=k)
            assert got["file_names"] == sum((s["file_names"] for s in subs), [])
        for pid in stream.pids:
            assert worker_libraries(pid) == {"libtorch": False, "libcuda": False}
    finally:
        stream.close()
        for r in refs:
            r.close()


def test_epoch_done_follows_the_slowest_shard(dataset):
    """``epoch_done`` fires only when every worker's shard has ended since
    the last global epoch, and re-arms: the reference shard streams'
    cadence replayed beside it."""
    s = MPEventStream(base_cfg(dataset, batch=2, workers=2, window=900), 2)
    refs = reference_shards(base_cfg(dataset, batch=2, window=900), 2)
    try:
        counts, emitted = [0, 0], 0
        for _ in range(40):
            got = s.next_batch()
            for w, r in enumerate(refs):
                counts[w] += bool(r.next_batch()["epoch_done"])
            expect = min(counts) > emitted
            emitted = max(emitted, min(counts))
            assert got["epoch_done"] == expect
        assert emitted >= 1
    finally:
        s.close()
        for r in refs:
            r.close()


def test_a_failing_worker_raises_in_the_parent(dataset, tmp_path):
    """A worker whose files vanished between the inventory and its start
    raises in the consumer with the worker's traceback, instead of hanging."""
    root = str(tmp_path / "vanishing")
    shutil.copytree(dataset, root)
    s = MPEventStream(base_cfg(root, batch=2, workers=2), 2)
    shutil.rmtree(root)  # workers start at the first batch
    try:
        with pytest.raises(RuntimeError, match="loader worker"):
            s.next_batch()
    finally:
        s.close()


def test_a_dead_worker_raises_in_the_parent(dataset):
    """A killed worker raises within about a second once the batches it
    queued are drained."""
    s = MPEventStream(base_cfg(dataset, batch=2, workers=1), 2)
    try:
        s.next_batch()
        s._procs[0].terminate()
        s._procs[0].join(timeout=10.0)
        with pytest.raises(RuntimeError, match="worker 0 exited"):
            for _ in range(s.depth + 3):
                s.next_batch()
    finally:
        s.close()


def test_worker_counts_and_the_stream_factory(dataset):
    for workers in (0, 3):
        with pytest.raises(ValueError, match="num_workers"):
            MPEventStream(base_cfg(dataset, batch=2, workers=workers), 2)
    with pytest.raises(ValueError, match="has no files"):
        worker_configs(base_cfg(dataset, batch=8, workers=8))
    one = build_stream(base_cfg(dataset, workers=1), 2)
    assert isinstance(one, H5EventStream)
    one.close()
    three = build_stream(base_cfg(dataset, batch=4, workers=3), 2)
    assert isinstance(three, MPEventStream) and three.slot_counts == [2, 1, 1]
    three.close()  # never started: nothing to join
    cfg = base_cfg(dataset, batch=4, workers=2)
    cfg["loader"].update(num_shards=2, shard_index=1)  # a rank's shard, refined again
    shards = [(c["loader"]["num_shards"], c["loader"]["shard_index"], c["loader"]["seed"])
              for c in worker_configs(cfg)]
    assert shards == [(4, 2, 3), (4, 3, 4)] and cfg["loader"]["num_workers"] == 2


def eval_cfg(root, workers):
    return {
        "data": {"path": root, "mode": "gtflow_dt1", "window": 1},
        "model": {"name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
                  "base_num_channels": 8, "kernel_size": 3, "mask_output": True,
                  "spiking_neuron": {"leak": [0.0, 1.0], "thresh": [0.0, 0.8]}},
        "loader": {"resolution": [24, 24], "std_resolution": [24, 24], "batch_size": 2,
                   "num_workers": workers, "augment": [], "seed": 0},
        "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5, "max_rate": 0.8},
        "metrics": {"name": ["AEE", "AAE"], "flow_scaling": 24},
    }


def test_evaluate_with_two_workers_equals_one(dataset):
    """Two workers stream the slots' files in the order one stream does
    here (slot b, then b + 2), so the per-file metrics are equal."""
    from evflow_torch.eval import evaluate
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    cfg = eval_cfg(dataset, 1)
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(seeded_state_dict(model, seed=4))
    stats = [{}, {}]
    one = evaluate(cfg, model=model, device="cpu", debug=True, stats=stats[0])
    two = evaluate(eval_cfg(dataset, 2), model=model, device="cpu", debug=True, stats=stats[1])
    assert len(one["AEE"]) == 4 and two == one
    assert stats[1]["windows"] == stats[0]["windows"] and stats[1]["encoder"] == "native_fused"


def test_train_with_two_workers_runs(dataset, tmp_path):
    """``train`` on the loader: workers started after the shuffle, the
    Prefetcher over them, two steps, a clean close."""
    from evflow_torch.train import train

    cfg = {
        "experiment": "mp",
        "data": {"path": dataset, "mode": "events", "window": 250, "window_loss": 500},
        "model": dict(eval_cfg(dataset, 1)["model"], name="LIFFireNet_short"),
        "loss": {"flow_regul_weight": 0.001, "clip_grad": 1.0},
        "optimizer": {"name": "Adam", "lr": 0.0002},
        "loader": {"n_epochs": 100, "batch_size": 2, "num_workers": 2,
                   "resolution": [24, 24], "std_resolution": [24, 24], "augment": [],
                   "seed": 0},
        "vis": {"verbose": False}, "hot_filter": {"enabled": False},
    }
    stats = {}
    train(cfg, path_runs=str(tmp_path / "runs"), max_steps=2, verbose=False, device="cpu",
          stats=stats)
    assert stats["steps"] == 2 and np.isfinite(stats["losses"]).all()
    assert stats["params_moved"] > 0
