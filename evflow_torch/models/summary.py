"""Model summaries: trainable parameter counts per module (port of
``evflow/models/summary.py``), over a port state dict or model."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["count_params", "summarize"]

_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _split(model_or_sd) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(parameters, norm running statistics) of a state dict or model."""
    sd: Mapping[str, torch.Tensor] = (model_or_sd.state_dict()
                                      if hasattr(model_or_sd, "state_dict") else model_or_sd)
    params = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] not in _STATS}
    stats = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in _STATS[:2]}
    return params, stats


def count_params(model_or_sd) -> int:
    return int(sum(v.numel() for v in _split(model_or_sd)[0].values()))


def summarize(model_or_sd, name: str = "model") -> str:
    """A per-top-level-module parameter table and its total."""
    params, stats = _split(model_or_sd)
    per_module: Dict[str, int] = defaultdict(int)
    for key, v in params.items():
        per_module[key.split(".", 1)[0]] += v.numel()
    lines = [f"{name} parameter summary:"]
    for mod in sorted(per_module):
        lines.append(f"  {mod:16s} {per_module[mod]:>10,d}")
    lines.append(f"  {'TOTAL':16s} {sum(per_module.values()):>10,d}")
    if stats:
        n_stats = int(sum(v.numel() for v in stats.values()))
        lines.append(f"  (+ {n_stats:,d} BatchNorm running-stat values)")
    return "\n".join(lines)
