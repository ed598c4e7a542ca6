"""Experiment tracking: training run directories and the results files of
an evaluation (port of ``evflow/utils/tracker.py``).

``Run`` is a local run directory ``<root>/<experiment>/<runid>/`` holding
``params.yaml`` (the config), ``metrics.jsonl`` (one JSON line a metric
value), ``histograms.jsonl`` and ``artifacts/``; the port's eval CLI reads
a run back by its id. ``create_model_dir`` makes ``<path_results>/<runid>``;
``log_config`` stores an evaluation's config there as ``eval_N.yml``, N
the first free number, and ``log_results`` the per-file results as
``metrics_N.yml``. ``save_csv`` appends rows of dicts to a CSV and
``grad_stats`` gives each parameter's |grad| mean, min and max. PyYAML is
imported when a file is written.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import uuid
from typing import Any, Dict, Mapping, Optional

__all__ = ["Run", "create_model_dir", "log_config", "log_results", "save_csv", "grad_stats"]


class Run:
    """A local tracking run (the reference's MLflow run)."""

    def __init__(self, root: str = "runs", experiment: str = "Default",
                 runid: Optional[str] = None):
        self.runid = runid or uuid.uuid4().hex[:12]
        self.dir = os.path.join(root, experiment, self.runid)
        os.makedirs(os.path.join(self.dir, "artifacts"), exist_ok=True)
        self._metrics_path = os.path.join(self.dir, "metrics.jsonl")

    def log_params(self, params: Dict[str, Any]):
        import yaml

        with open(os.path.join(self.dir, "params.yaml"), "w") as f:
            yaml.safe_dump(params, f)

    def log_metric(self, name: str, value: float, step: int = 0):
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps({"t": time.time(), "name": name, "value": float(value),
                                "step": step}) + "\n")

    def log_histograms(self, tensors: Mapping[str, Any], step: int, bins: int = 64,
                       group: str = "params"):
        """Append each tensor's histogram and stats (its finite values) to
        ``histograms.jsonl``."""
        import numpy as np

        with open(os.path.join(self.dir, "histograms.jsonl"), "a") as f:
            for name, v in tensors.items():
                a = np.asarray(v, np.float64).ravel()
                if a.size == 0 or not np.isfinite(a).any():
                    continue
                a = a[np.isfinite(a)]
                counts, edges = np.histogram(a, bins=bins)
                f.write(json.dumps({
                    "t": time.time(), "step": step, "group": group, "name": name,
                    "min": float(a.min()), "max": float(a.max()),
                    "mean": float(a.mean()), "std": float(a.std()),
                    "counts": counts.tolist(), "lo": float(edges[0]), "hi": float(edges[-1]),
                }) + "\n")

    def save_diff(self, name: str = "train_diff.txt"):
        """Record the working tree's ``git diff`` (empty outside a git
        checkout) as an artifact."""
        try:
            diff = subprocess.run(["git", "diff"], capture_output=True, text=True,
                                  timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            diff = ""
        with open(os.path.join(self.dir, "artifacts", name), "w") as f:
            f.write(diff)

    @staticmethod
    def load_params(root: str, experiment: str, runid: str) -> Dict[str, Any]:
        import yaml

        with open(os.path.join(root, experiment, runid, "params.yaml")) as f:
            return yaml.safe_load(f)


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


def save_csv(rows, path: str):
    """Append rows of dicts to a CSV, with a header when the file is new."""
    import csv

    if not rows:
        return
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=sorted(rows[0].keys()))
        if not exists:
            w.writeheader()
        for r in rows:
            w.writerow(r)


def grad_stats(grads: Mapping[str, Any]) -> Dict[str, float]:
    """Each named gradient's |grad| mean, min and max, keyed
    ``<name>/mean`` and so on."""
    import torch

    if not grads:
        return {}
    abs_ = [torch.as_tensor(g).detach().abs() for g in grads.values()]
    vals = torch.stack([torch.stack([a.mean(), a.min(), a.max()]) for a in abs_]).cpu().tolist()
    out = {}
    for name, (mean, lo, hi) in zip(grads, vals):
        out.update({f"{name}/mean": mean, f"{name}/min": lo, f"{name}/max": hi})
    return out
