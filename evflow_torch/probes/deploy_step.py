"""The int8 serving engine on the card: its states against the CPU's, its
kernels a window, and a reference-package run written without flax
(``chip_smoke.py`` phase ``deploy``).

* ``compare_card_cpu``: the engine of one model on the card and on the CPU
  over the same windows, tier by tier (membrane ranges profiled and z scales
  calibrated on each side and compared); the states must be bit-equal, the
  flows within 1 bf16 ulp (``bf16_ulps``).
* ``profile_engine``: kernels launched and their device time a window, by
  ``torch.profiler``, with the kernels that take the most.
* ``flax_variables`` / ``write_reference_run``: a port ``FireNet``'s weights
  in the reference's flax layout, written as the reference package writes a
  run (``params.yaml``, ``checkpoints/lowest_loss/0/model.msgpack``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from evflow_torch.deploy import Int8DeployEngine, profile_mem_ranges

__all__ = ["bf16_ulps", "compare_card_cpu", "profile_engine", "flax_variables",
           "write_reference_run"]


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns mapped to integers in the order of their values."""
    bits = t.to(torch.bfloat16).view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of ``a`` from ``b`` in bf16 ulps (both hold
    bf16 values)."""
    return int((_ordered(a.cpu()) - _ordered(b.cpu())).abs().max())


def _run(engine, windows, states):
    flows = []
    with torch.no_grad():
        for x in windows:
            out, states = engine(None, x, states)
            flows.append(out["flow"][0])
    return flows, states


def compare_card_cpu(model_gpu, model_cpu, windows: torch.Tensor, tiers: Sequence[str],
                     profile: int = 4) -> List[Dict[str, Any]]:
    """Each tier, without and with ``z_int8``, on the card and on the CPU
    over ``windows [T, B, H, W, 2]`` (on the card); see the module's
    docstring. Returns one record a (tier, z) with ``ok``."""
    cpu_windows = windows.cpu()
    out = []
    for tier in tiers:
        ranges = {}
        if tier != "bfloat16":
            ranges = {dev: profile_mem_ranges(m, w[:profile]) for dev, m, w in (
                ("gpu", model_gpu, windows), ("cpu", model_cpu, cpu_windows))}
        ranges_equal = all(np.array_equal(a, b) for (lg, hg), (lc, hc) in zip(
            ranges.get("gpu", []), ranges.get("cpu", [])) for a, b in ((lg, lc), (hg, hc)))
        for z in (False, True):
            engines = {}
            for dev, m, w in (("gpu", model_gpu, windows), ("cpu", model_cpu, cpu_windows)):
                e = Int8DeployEngine(m, mem_dtype=tier, mem_ranges=ranges.get(dev))
                if z:
                    e.calibrate_z(list(w[:profile].cpu().numpy()))
                engines[dev] = e
            params_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
                engines["gpu"].buffers(), engines["cpu"].buffers()))
            fg, sg = _run(engines["gpu"], windows, engines["gpu"].init_states(*windows.shape[1:4]))
            fc, sc = _run(engines["cpu"], cpu_windows,
                          engines["cpu"].init_states(*windows.shape[1:4]))
            mem_equal = all(torch.equal(a.mem.cpu(), b.mem) for a, b in zip(sg, sc))
            spk_equal = all((a.spk is None and b.spk is None) or torch.equal(a.spk.cpu(), b.spk)
                            for a, b in zip(sg, sc))
            ulps = max(bf16_ulps(a, b) for a, b in zip(fg, fc))
            differ = float(np.mean([float((a.cpu() != b).float().mean()) for a, b in zip(fg, fc)]))
            rates = [float(s.spk.float().mean()) for s in sg if s.spk is not None]
            ok = ranges_equal and params_equal and mem_equal and spk_equal and ulps <= 1
            out.append({"tier": tier, "z_int8": z, "windows": len(windows),
                        "ranges_equal": ranges_equal, "params_equal": params_equal,
                        "mem_equal": mem_equal, "spk_equal": spk_equal, "flow_max_ulps": ulps,
                        "flow_share_differ": differ, "recurrent_spike_rates": rates,
                        "flow_finite": bool(torch.isfinite(torch.stack(fg)).all()),
                        "ok": ok and bool(torch.isfinite(torch.stack(fg)).all())})
    return out


@torch.no_grad()
def profile_engine(step, window: torch.Tensor, states, n: int = 8, top: int = 8) -> Dict[str, Any]:
    """Kernels a window of ``step(x, states) -> (flow, states)`` and their
    device ms a window, over ``n`` windows after a warm one (the kernels
    that take the most listed)."""
    from torch.profiler import ProfilerActivity, profile

    _, states = step(window, states)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            _, states = step(window, states)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[2])
    return {"kernels_per_window": len(kernels) / n,
            "kernel_ms_per_window": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n,
            "top_kernels": [{"name": k[:100], "launches": c, "ms": ms} for k, c, ms in rows[:top]]}


def flax_variables(model) -> Dict[str, Any]:
    """A port snn ``FireNet``'s weights (no TEBN, no MPBN) as the reference
    package's flax ``{"params", "batch_stats"}`` numpy tree."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}

    def hwio(key):
        return np.ascontiguousarray(sd[key].transpose(2, 3, 1, 0))

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for u in model.unit_names:
        p = {"ff": {"kernel": hwio(f"{u}.ff.weight")},
             "bn": {"BatchNorm_0": {"scale": sd[f"{u}.bn.weight"], "bias": sd[f"{u}.bn.bias"]}},
             "beta": sd[f"{u}.lif.beta"].reshape(-1), "threshold": sd[f"{u}.lif.threshold"]
             .reshape(-1)}
        if f"{u}.rec.weight" in sd:
            p["rec"] = {"kernel": hwio(f"{u}.rec.weight")}
        params[u] = p
        stats[u] = {"bn": {"BatchNorm_0": {"mean": sd[f"{u}.bn.running_mean"],
                                           "var": sd[f"{u}.bn.running_var"]}}}
    params["pred"] = {"conv2d": {"kernel": hwio("pred.conv2d.weight"),
                                 "bias": sd["pred.conv2d.bias"]}}
    return {"params": params, "batch_stats": stats}


def write_reference_run(path_runs: str, experiment: str, runid: str, model,
                        config: Dict[str, Any]) -> str:
    """``model``'s weights as a reference package's run, ``config`` its
    ``params.yaml``; returns the checkpoint's path."""
    import yaml

    from evflow_torch.utils.msgpack import MSGPACK_NAME, packb

    run = os.path.join(path_runs, experiment, runid)
    ckpt = os.path.join(run, "checkpoints", "lowest_loss", "0")
    os.makedirs(ckpt, exist_ok=True)
    with open(os.path.join(run, "params.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    state = dict(flax_variables(model), opt_state=None, epoch=np.asarray(0),
                 loss=np.asarray(0.0), loss_variance=np.asarray(0.0))
    path = os.path.join(ckpt, MSGPACK_NAME)
    with open(path, "wb") as f:
        f.write(packb(state))
    return path
