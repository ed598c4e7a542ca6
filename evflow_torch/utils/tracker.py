"""Results files of an evaluation run (port of the evaluation part of
``evflow/utils/tracker.py``).

``create_model_dir`` makes ``<path_results>/<runid>``; ``log_config``
stores the evaluation's config there as ``eval_N.yml``, N the first free
number, and ``log_results`` the per-file results as ``metrics_N.yml``.
PyYAML is imported when a file is written.
"""

from __future__ import annotations

import os

__all__ = ["create_model_dir", "log_config", "log_results"]


def create_model_dir(path_results: str, runid: str) -> str:
    path = os.path.join(path_results, runid)
    os.makedirs(path, exist_ok=True)
    return path


def log_config(path_results: str, runid: str, config: dict) -> int:
    """Write ``config`` as ``eval_N.yml``; returns N."""
    import yaml

    eval_id = 0
    while os.path.exists(os.path.join(path_results, f"eval_{eval_id}.yml")):
        eval_id += 1
    with open(os.path.join(path_results, f"eval_{eval_id}.yml"), "w") as f:
        yaml.safe_dump(config, f)
    return eval_id


def log_results(runid: str, results: dict, path_results: str, eval_id: int):
    """Write ``{"runid": runid, **results}`` as ``metrics_<eval_id>.yml``."""
    import yaml

    with open(os.path.join(path_results, f"metrics_{eval_id}.yml"), "w") as f:
        yaml.safe_dump({"runid": runid, **results}, f)
