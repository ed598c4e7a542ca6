"""Config system: YAML files over programmatic defaults, merged recursively
(port of ``evflow/config.py``).

``load_config`` reads a YAML file over ``default_config()``, and
``combine_entries`` moves a top-level ``spiking_neuron`` section under
``model``. ``merge_configs`` overlays the current evaluation config on a
training run's stringified params (the current config wins), turning
stringified dicts back into dicts with ``ast.literal_eval``. PyYAML is
imported when a file is read, so the rest of the package runs without it.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, Mapping, Optional

__all__ = ["default_config", "load_config", "parse_dict", "merge_configs", "combine_entries",
           "seed_from", "clone", "Config"]

Config = Dict[str, Any]


def default_config() -> Config:
    """The defaults every loaded config starts from."""
    return {
        "experiment": "Default",
        "data": {"mode": "events", "window": 5000},
        "loader": {"resolution": [180, 240], "batch_size": 1, "augment": [],
                   "augment_prob": [], "seed": 0},
        "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5, "max_rate": 0.8},
        "model": {},
        "spiking_neuron": {},
        "vis": {"bars": False},
    }


def parse_dict(src: Mapping[str, Any], dst: Optional[Config] = None) -> Config:
    """Recursive merge: the leaves of ``src`` overwrite ``dst``'s. Returns
    ``dst``."""
    if dst is None:
        dst = {}
    for key, val in src.items():
        if isinstance(val, Mapping):
            if not isinstance(dst.get(key), dict):
                dst[key] = {}
            parse_dict(val, dst[key])
        else:
            dst[key] = val
    return dst


def load_config(path: str) -> Config:
    """Defaults, the YAML file over them, then ``combine_entries``."""
    import yaml

    cfg = default_config()
    with open(path) as fid:
        overlay = yaml.safe_load(fid) or {}
    parse_dict(overlay, cfg)
    return combine_entries(cfg)


def combine_entries(cfg: Config) -> Config:
    """Move a top-level ``spiking_neuron`` section under ``model``."""
    if "spiking_neuron" in cfg:
        sn = cfg.pop("spiking_neuron")
        if sn:
            cfg.setdefault("model", {})["spiking_neuron"] = sn
        else:
            cfg.setdefault("model", {}).setdefault("spiking_neuron", {})
    return cfg


def merge_configs(run_params: Mapping[str, str], cfg: Config) -> Config:
    """A training run's stringified params with ``cfg`` over them: the
    current settings win, keys only the run has (the model's) survive."""
    base: Config = {}
    for key, val in run_params.items():
        if isinstance(val, str) and val.startswith("{"):
            try:
                base[key] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                base[key] = val
        else:
            base[key] = val
    parse_dict(cfg, base)
    return combine_entries(base)


def seed_from(cfg: Config) -> int:
    return int(cfg.get("loader", {}).get("seed", 0))


def clone(cfg: Config) -> Config:
    return copy.deepcopy(cfg)
