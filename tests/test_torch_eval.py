"""The slice as a whole: the port's ``evaluate`` against the reference
package's on the same synthetic data and weights, across a sequence
rollover, with the settings of ``configs/eval_MVSEC.yml`` (downsampling,
``keep_gt_full_res``, hot filter, AEE / AAE / AE_ofMeans)."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import eval_config, seeded_flax_firenet
from evflow.eval import evaluate as jax_evaluate
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.eval import evaluate


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_eval"))
    make_dataset(root, num_sequences=2, resolution=(32, 32), events_per_sec=30000,
                 duration=0.6, flows=[(12.0, -6.0), (-8.0, 4.0)])
    cfg = eval_config(root, res=16, std=32)
    _, v = seeded_flax_firenet(cfg["model"], seed=11)
    return cfg, v


def assert_results_close(ours, ref, rel):
    assert set(ours) == set(ref)
    for metric, per_file in ref.items():
        assert set(ours[metric]) == set(per_file), metric
        for fname, value in per_file.items():
            np.testing.assert_allclose(float(ours[metric][fname]), float(value),
                                       rtol=rel, atol=1e-7, err_msg=f"{metric} {fname}")


@pytest.mark.parametrize("fused,layout,rel", [(False, "nhwc", 1e-4), (True, "nhwc", 1e-3),
                                              (True, "cmajor", 1e-3)])
def test_evaluate_matches_reference(setup, fused, layout, rel):
    """Per-file metrics of 8 windows (the 6 windows of the first sequence,
    then 2 of the second): the unfused f32 path within 1e-4, the fused
    bf16-conv path (reference in interpret mode) within 1e-3."""
    cfg, v = setup
    with pltpu.force_tpu_interpret_mode():
        ref = jax_evaluate(cfg, variables=v, fused=fused, debug=True, max_windows=8,
                           verbose=False)
    stats = {}
    ours = evaluate(cfg, variables=v, fused=fused, layout=layout, device="cpu",
                    debug=True, max_windows=8, stats=stats)
    assert stats["windows"] == 8
    assert len(ref["AEE"]) == 2  # both sequences were scored
    assert_results_close(ours, ref, rel)


def test_evaluate_count_wire_past_255_matches_reference(tmp_path):
    """Without downsampling the counts cross as uint8 and, once a pixel
    passes 255 events, as uint16 (shipped as int16 bits): the results
    still match the reference package's."""
    from evflow_torch.data.h5_stream import H5EventStream

    root = str(tmp_path / "dense")
    make_dataset(root, num_sequences=1, resolution=(32, 32), events_per_sec=150000,
                 duration=0.4, flows=[(0.5, 0.2)])
    cfg = eval_config(root, res=32, std=32, metrics=("AEE",))
    cfg["hot_filter"]["enabled"] = False
    stream = H5EventStream(cfg, 2)
    assert max(stream.next_batch()["event_cnt"].max() for _ in range(3)) > 255
    stream.close()
    _, v = seeded_flax_firenet(cfg["model"], seed=12)
    ref = jax_evaluate(cfg, variables=v, debug=True, max_windows=3, verbose=False)
    ours = evaluate(cfg, variables=v, device="cpu", debug=True, max_windows=3)
    assert_results_close(ours, ref, 1e-4)


def test_evaluate_rejects_what_the_protocol_cannot_score(setup):
    cfg, _ = setup
    bad = dict(cfg, data=dict(cfg["data"], mode="events"))
    with pytest.raises(ValueError, match="ground-truth"):
        evaluate(bad, device="cpu", debug=True)
    bad = dict(cfg, data=dict(cfg["data"], window=0.3))
    with pytest.raises(ValueError, match="inverse"):
        evaluate(bad, device="cpu", debug=True)


def test_entry_points_default_to_the_gpu(setup, monkeypatch):
    """Without a device the port runs on CUDA, and without CUDA it raises
    instead of running on the CPU."""
    cfg, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(cfg, debug=True, max_windows=1)
