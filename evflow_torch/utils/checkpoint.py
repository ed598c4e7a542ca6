"""Training checkpoints: atomic saves, the three retention policies, resume
(port of ``evflow/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file, ``model.pth``, in the reference's
``.pth`` form: ``{"model_state_dict", "optimizer_state_dict", "epoch",
"loss", "loss_variance"}``, the state dict under the reference's names (so
``evflow_torch.weights.load_checkpoint``, the port's ``evaluate`` and the
reference package's torch import read it), every tensor on the CPU, with
``config.yaml`` beside it. ``CheckpointPolicy`` keeps ``lowest_loss`` (an
improvement over 1e-6), ``smoothest_loss`` (lowest loss variance, once the
history is longer than 10 losses) and ``most_recent``, each under
``<base>/<kind>/<epoch>/``, deleting the directory it supersedes.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "load_training_checkpoint", "CheckpointPolicy", "CKPT_NAME"]

CKPT_NAME = "model.pth"


def _cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(directory: str, state: Dict[str, Any],
                    config: Optional[dict] = None) -> str:
    """Write ``state`` (tensors moved to the CPU) as ``<directory>/model.pth``
    through a temporary file and ``os.replace``; ``config`` as
    ``config.yaml`` beside it."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CKPT_NAME)
    tmp = path + ".tmp"
    torch.save(_cpu(state), tmp)
    os.replace(tmp, path)
    if config is not None:
        import yaml

        with open(os.path.join(directory, "config.yaml"), "w") as f:
            yaml.safe_dump(config, f)
    return path


def load_training_checkpoint(path: str) -> Dict[str, Any]:
    """The dict a ``save_checkpoint`` wrote (a file or its directory)."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_NAME)
    return torch.load(path, map_location="cpu", weights_only=False)


class CheckpointPolicy:
    """Three-way retention policy, updated at every epoch end."""

    def __init__(self, base_dir: str, improvement_eps: float = 1e-6, min_history: int = 10):
        self.base_dir = base_dir
        self.eps = improvement_eps
        self.min_history = min_history
        self.best_loss = float("inf")
        self.best_variance = float("inf")
        self.paths: Dict[str, Optional[str]] = {
            "lowest_loss": None, "smoothest_loss": None, "most_recent": None}

    def _save(self, kind: str, epoch: int, state, config) -> str:
        old = self.paths[kind]
        new_dir = os.path.join(self.base_dir, kind, str(epoch))
        save_checkpoint(new_dir, state, config)
        if old is not None and os.path.exists(old) and old != new_dir:
            shutil.rmtree(old, ignore_errors=True)
        self.paths[kind] = new_dir
        return new_dir

    def update(self, epoch: int, avg_loss: float, loss_variance: float, history_len: int,
               state: Dict[str, Any], config: Optional[dict] = None) -> Dict[str, bool]:
        """Write what the policies ask for at this epoch's end; returns
        which checkpoints were written."""
        wrote = {"lowest_loss": False, "smoothest_loss": False, "most_recent": True}
        full_state = dict(state, epoch=epoch, loss=avg_loss, loss_variance=loss_variance)
        if avg_loss < self.best_loss - self.eps:
            self._save("lowest_loss", epoch, full_state, config)
            self.best_loss = avg_loss
            wrote["lowest_loss"] = True
        if loss_variance < self.best_variance and history_len > self.min_history:
            self._save("smoothest_loss", epoch, full_state, config)
            self.best_variance = loss_variance
            wrote["smoothest_loss"] = True
        self._save("most_recent", epoch, full_state, config)
        return wrote
