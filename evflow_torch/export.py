"""Deployment export helpers (port of ``fold_batchnorm_params`` in
``evflow/export.py``; the rest of that module is ROADMAP.md queue 1
item 10)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["fold_batchnorm_params"]


def fold_batchnorm_params(kernel: np.ndarray, bn_scale: np.ndarray, bn_bias: np.ndarray,
                          bn_mean: np.ndarray, bn_var: np.ndarray,
                          eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """Fold eval-mode ``BN(conv(x))`` into ``conv'(x) + b``: the OIHW
    ``kernel`` scaled per output channel by ``g = scale / sqrt(var + eps)``,
    and ``b = bias - mean * g`` (numpy, in the arrays' dtype)."""
    g = bn_scale / np.sqrt(bn_var + eps)
    return kernel * g[:, None, None, None], bn_bias - bn_mean * g
