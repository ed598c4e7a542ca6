"""Flow upsampling (the part of ``evflow/ops/iwe.py`` the eval needs)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["upsample_flow"]


def upsample_flow(flow: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of ``[B, H, W, C]`` flow.

    ``jax.image.resize(method="nearest")`` samples source index
    ``floor((i + 0.5) * in / out)``, which is torch's ``"nearest-exact"``;
    plain ``"nearest"`` (``floor(i * in / out)``) agrees only for integer
    ratios.
    """
    out = F.interpolate(flow.permute(0, 3, 1, 2), size=(target_h, target_w),
                        mode="nearest-exact")
    return out.permute(0, 2, 3, 1)
