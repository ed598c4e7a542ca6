"""The port's config loader against ``evflow.config`` on every config file
of the repository, and ``merge_configs`` on a training run's stringified
params."""

from pathlib import Path

import pytest

from evflow import config as JC
from evflow_torch import config as TC

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_load_config_matches_reference(path):
    ours = TC.load_config(str(path))
    assert ours == JC.load_config(str(path))
    assert "spiking_neuron" not in ours and "spiking_neuron" in ours["model"]
    assert TC.seed_from(ours) == JC.seed_from(ours)
    twin = TC.clone(ours)
    assert twin == ours and twin["model"] is not ours["model"]


def test_merge_configs_matches_reference():
    """Stringified dicts come back as dicts (a malformed one stays a
    string), and the evaluation's settings win."""
    run = {"model": str({"name": "LIFFireNet", "base_num_channels": 32,
                         "spiking_neuron": {"leak": [0.0, 1.0]}}),
           "loader": str({"resolution": [128, 128], "batch_size": 8}),
           "experiment": "train", "broken": "{not a dict", "empty": "",
           "spiking_neuron": str({"hard_reset": True})}
    cfg = TC.load_config(str(CONFIGS[0]))
    ours = TC.merge_configs(run, TC.clone(cfg))
    assert ours == JC.merge_configs(run, JC.clone(cfg))
    assert ours["broken"] == "{not a dict"
    assert ours["loader"]["resolution"] == cfg["loader"]["resolution"]


def test_defaults_and_parse_dict_match_reference():
    assert TC.default_config() == JC.default_config()
    src = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert TC.parse_dict(src, {"a": 5, "f": 6}) == JC.parse_dict(src, {"a": 5, "f": 6})
    assert TC.combine_entries({"spiking_neuron": {}}) == JC.combine_entries({"spiking_neuron": {}})
