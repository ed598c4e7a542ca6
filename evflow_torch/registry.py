"""Model and metric registries (port of the FireNet builders and
``build_metrics`` of ``evflow/registry.py``).

Whitelisted factories keyed by the config's ``model.name`` and
``metrics.name``, over the same config schema as the reference package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch

from evflow_torch.device import resolve_device

__all__ = ["build_model", "build_metrics", "model_names", "firenet_kwargs"]

_FIRENETS: Dict[str, Dict[str, bool]] = {
    "LIFFireNet": dict(recurrent=True, short=False),
    "LIFFireNet_short": dict(recurrent=True, short=True),
    "LIFFireFlowNet": dict(recurrent=False, short=False),
    "LIFFireFlowNet_short": dict(recurrent=False, short=True),
}


def model_names() -> List[str]:
    return sorted(_FIRENETS)


def _enabled(section) -> bool:
    return section.get("enabled", False) if isinstance(section, dict) else bool(section)


def firenet_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """FireNet constructor arguments from a ``model`` config section."""
    sn = cfg.get("spiking_neuron") or {}
    tebn = cfg.get("tebn") or {}
    q = cfg.get("quantization") or {}
    if q.get("enabled"):
        raise NotImplementedError("quantized FireNet models are not ported yet")
    if cfg.get("state_dtype") not in (None, "float32"):
        raise NotImplementedError("only f32 LIF state is ported")
    # auto, im2col, dypack and lax all compute the same f32 conv; dypack_int8
    # quantises every 3x3 conv to int8, which the port does not do yet
    if cfg.get("conv_impl") == "dypack_int8":
        raise NotImplementedError("conv_impl 'dypack_int8' (int8 convs) is not ported yet: "
                                  "ROADMAP.md queue 1, item 8")
    kwargs = dict(
        num_bins=int(cfg.get("num_bins", 2)),
        base_num_channels=int(cfg.get("base_num_channels", 32)),
        kernel_size=int(cfg.get("kernel_size", 3)),
        encoding=cfg.get("encoding", "cnt"),
        norm_input=bool(cfg.get("norm_input", False)),
        mask_output=bool(cfg.get("mask_output", True)),
        tebn=_enabled(tebn),
        num_timesteps=int(tebn.get("num_timesteps", 4)) if isinstance(tebn, dict) else 4,
        mpbn=_enabled(cfg.get("mpbn") or {}),
        cell_family=cfg.get("cell_family", "snn"),
    )
    for key in ("leak", "thresh"):
        if key in sn:
            kwargs[key] = tuple(sn[key])
    if "hard_reset" in sn:
        kwargs["hard_reset"] = bool(sn["hard_reset"])
    if cfg.get("compute_dtype") == "bfloat16":
        kwargs["compute_dtype"] = torch.bfloat16
    return kwargs


def build_model(model_cfg: Dict[str, Any],
                device: Optional[Union[str, torch.device]] = None):
    """Build a FireNet from the config's ``model`` section (with its
    ``spiking_neuron`` sub-section), in eval mode on ``device`` (the GPU
    unless the caller names another device)."""
    from evflow_torch.models.firenet import FireNet

    name = model_cfg.get("name")
    if name not in _FIRENETS:
        raise KeyError(f"Unknown model {name!r}. Registered: {model_names()}")
    model = FireNet(**_FIRENETS[name], **firenet_kwargs(model_cfg))
    return model.to(resolve_device(device)).eval()


def build_metrics(config: Dict[str, Any], flow_scaling: float) -> List[Callable]:
    """Metric objects for ``config["metrics"]["name"]``."""
    from evflow_torch.loss import metrics as M

    table = {"AEE": M.AEE, "AAE": M.AAE, "AE_ofMeans": M.AEofMeans}
    out = []
    for n in config.get("metrics", {}).get("name", []):
        if n not in table:
            raise KeyError(f"Unknown metric {n!r}. Ported: {sorted(table)}")
        out.append(table[n](config, flow_scaling=flow_scaling))
    return out
