"""Model, optimizer and metric registries (port of the model factories,
``build_optimizer`` and ``build_metrics`` of ``evflow/registry.py``).

Whitelisted factories keyed by the config's ``model.name``,
``optimizer.name`` and ``metrics.name``, over the same config schema as the
reference package. The optimizers follow optax's defaults and update rules
(the reference trains with optax), on ``torch.optim``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import torch

from evflow_torch.device import resolve_device

__all__ = ["build_model", "build_metrics", "build_optimizer", "model_names",
           "firenet_kwargs", "unet_kwargs", "is_unet", "apply_static_qat", "OptaxRMSprop"]

_FIRENETS: Dict[str, Dict[str, bool]] = {
    "LIFFireNet": dict(recurrent=True, short=False),
    "LIFFireNet_short": dict(recurrent=True, short=True),
    "LIFFireFlowNet": dict(recurrent=False, short=False),
    "LIFFireFlowNet_short": dict(recurrent=False, short=True),
}


UNET = "SpikingRecEVFlowNet"


def model_names() -> List[str]:
    return sorted([*_FIRENETS, UNET])


def is_unet(model_cfg: Dict[str, Any]) -> bool:
    """Whether the ``model`` config section names the spiking UNet."""
    return model_cfg.get("name") == UNET


def _enabled(section) -> bool:
    return section.get("enabled", False) if isinstance(section, dict) else bool(section)


def firenet_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """FireNet constructor arguments from a ``model`` config section."""
    sn = cfg.get("spiking_neuron") or {}
    tebn = cfg.get("tebn") or {}
    q = cfg.get("quantization") or {}
    if cfg.get("state_dtype") not in (None, "float32", "bfloat16"):
        raise ValueError(f"state_dtype must be float32 or bfloat16, got {cfg['state_dtype']!r}")
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
    acts = cfg.get("activations")
    if acts:
        kwargs["activation"] = acts[0]
    for key in ("leak", "thresh"):
        if key in sn:
            kwargs[key] = tuple(sn[key])
    for key in ("learn_leak", "learn_thresh", "hard_reset", "detach"):
        if key in sn:
            kwargs[key] = bool(sn[key])
    if "act_width" in sn:
        kwargs["act_width"] = float(sn["act_width"])
    if cfg.get("compute_dtype") == "bfloat16":
        kwargs["compute_dtype"] = torch.bfloat16
    if "conv_impl" in cfg:
        kwargs["conv_impl"] = cfg["conv_impl"]
    if cfg.get("state_dtype") == "bfloat16":
        kwargs["state_dtype"] = torch.bfloat16
    # QAT: quantization.enabled without PTQ puts the fake-quant hooks in the
    # training graph: dynamic absmax conv quant (static_scales swaps in the
    # calibrated per-layer hooks, apply_static_qat), plus the membrane quant
    # unless Conv_only
    if q.get("enabled") and not q.get("PTQ"):
        from evflow_torch.quant.fake_quant import dynamic_conv_quant, state_quant_fn

        kwargs["conv_fake_quant"] = dynamic_conv_quant()
        if not q.get("Conv_only"):
            kwargs["state_quant"] = state_quant_fn()
    return kwargs


def unet_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``SpikingRecEVFlowNet`` constructor arguments from a ``model`` config
    section: the keys the reference package's registry reads."""
    sn = cfg.get("spiking_neuron") or {}
    kwargs = dict(
        num_bins=int(cfg.get("num_bins", 2)),
        base_num_channels=int(cfg.get("base_num_channels", 32)),
        kernel_size=int(cfg.get("kernel_size", 3)),
        encoding=cfg.get("encoding", "cnt"),
        norm_input=bool(cfg.get("norm_input", False)),
        mask_output=bool(cfg.get("mask_output", True)),
        norm=cfg.get("norm"),
        use_upsample_conv=bool(cfg.get("use_upsample_conv", True)),
    )
    for key in ("leak", "thresh"):
        if key in sn:
            kwargs[key] = tuple(sn[key])
    for key in ("learn_leak", "learn_thresh", "hard_reset", "detach"):
        if key in sn:
            kwargs[key] = bool(sn[key])
    return kwargs


def apply_static_qat(model, cfg: Dict[str, Any]):
    """Swap the dynamic QAT conv hook for static per-layer hooks at the
    scales in ``quantization.static_scales`` (``train_flow_quant
    --calibration static`` calibrates them on the FP32 start, so the
    training and the deployed quantisation grids agree)."""
    q = cfg.get("quantization") or {}
    scales = q.get("static_scales")
    if not (q.get("enabled") and not q.get("PTQ") and scales):
        return model
    from evflow_torch.quant.fake_quant import static_conv_quant

    hooks = tuple(static_conv_quant(scales, layer=u) for u in (*model.unit_names, "pred"))
    return model.set_quant(conv_fake_quant=None, conv_fake_quant_per_layer=hooks)


def build_model(model_cfg: Dict[str, Any],
                device: Optional[Union[str, torch.device]] = None):
    """Build a FireNet or the spiking UNet from the config's ``model``
    section (with its ``spiking_neuron`` and, for a FireNet,
    ``quantization`` sub-sections), in eval mode on ``device`` (the GPU
    unless the caller names another device)."""
    from evflow_torch.models.firenet import FireNet

    name = model_cfg.get("name")
    if name == UNET:
        from evflow_torch.models.unet import SpikingRecEVFlowNet

        return SpikingRecEVFlowNet(**unet_kwargs(model_cfg)).to(resolve_device(device)).eval()
    if name not in _FIRENETS:
        raise KeyError(f"Unknown model {name!r}. Registered: {model_names()}")
    model = apply_static_qat(FireNet(**_FIRENETS[name], **firenet_kwargs(model_cfg)), model_cfg)
    return model.to(resolve_device(device)).eval()


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (uncentered, without bias correction)::

      nu  = (1 - decay) * g^2 + decay * nu      (nu starts at initial_scale)
      u   = rsqrt(nu + eps) * g                 (eps inside the root)
      t   = u + momentum * t  (with momentum; nesterov: u + momentum * t_new)
      p  -= lr * (t or u)

    ``torch.optim.RMSprop`` differs (alpha 0.99, eps outside the root, nu
    from 0), so no torch flag reproduces it."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, decay: float = 0.9,
                 eps: float = 1e-8, initial_scale: float = 0.0,
                 momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
                                      momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.full_like(p, group["initial_scale"])
                    if group["momentum"] is not None:
                        st["trace"] = torch.zeros_like(p)
                g, nu = p.grad, st["nu"]
                nu.copy_((1 - group["decay"]) * (g * g) + group["decay"] * nu)
                u = torch.rsqrt(nu + group["eps"]) * g
                if group["momentum"] is not None:
                    t = st["trace"]
                    t.copy_(u + group["momentum"] * t)
                    u = u + group["momentum"] * t if group["nesterov"] else t.clone()
                p.sub_(group["lr"] * u)


def _adam(params, lr, b1=0.9, b2=0.999, eps=1e-8):
    return torch.optim.Adam(params, lr=lr, betas=(float(b1), float(b2)), eps=float(eps))


def _adamw(params, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    # optax decays by 1e-4 by default (torch: 1e-2); both decay the old weights
    return torch.optim.AdamW(params, lr=lr, betas=(float(b1), float(b2)), eps=float(eps),
                             weight_decay=float(weight_decay))


def _sgd(params, lr, momentum=None, nesterov=False):
    return torch.optim.SGD(params, lr=lr, momentum=float(momentum or 0.0),
                           nesterov=bool(nesterov))


# optax's keyword names and defaults
_OPTIMIZERS: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "Adam": _adam, "AdamW": _adamw, "SGD": _sgd, "RMSprop": OptaxRMSprop}


def build_optimizer(opt_cfg: Dict[str, Any],
                    params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """The config's ``optimizer`` section (``name``, ``lr`` and optax's
    keywords: ``b1``, ``b2``, ``eps``, ``weight_decay`` for AdamW,
    ``momentum``, ``nesterov``, ``decay``, ``initial_scale``) as a torch
    optimizer over ``params``. An unknown keyword raises ``TypeError``, as
    optax does."""
    name = opt_cfg.get("name", "Adam")
    if name not in _OPTIMIZERS:
        raise KeyError(f"Unknown optimizer {name!r}. Registered: {sorted(_OPTIMIZERS)}")
    kw = {k: v for k, v in opt_cfg.items() if k not in ("name", "lr")}
    return _OPTIMIZERS[name](list(params), float(opt_cfg.get("lr", 2e-4)), **kw)


def build_metrics(config: Dict[str, Any], flow_scaling: float) -> List[Callable]:
    """Metric objects for ``config["metrics"]["name"]``."""
    from evflow_torch.loss import metrics as M

    table = {"AEE": M.AEE, "NEE": M.NEE, "AAE": M.AAE, "NAAE": M.NAAE,
             "AE_ofMeans": M.AEofMeans, "AAE_Weighted": M.AAEWeighted,
             "AAE_Filtered": M.AAEFiltered}
    out = []
    for n in config.get("metrics", {}).get("name", []):
        if n not in table:
            raise KeyError(f"Unknown metric {n!r}. Registered: {sorted(table)}")
        out.append(table[n](config, flow_scaling=flow_scaling))
    return out
