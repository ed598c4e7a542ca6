"""The int8 serving engine of the FireNet family (port of
``evflow/deploy.py``).

A trained FP32 ``FireNet`` is prepared once on the host: BatchNorm folded
into the conv kernels (eval statistics), the kernels quantised to int8 per
output channel (a recurrent unit's ff and rec kernels share one scale, so
that the two sum in one int32 GEMM), leak and threshold clamped and kept in
bf16. Inference then carries int8 spikes and runs each unit as one
dy-packed int8 x int8 -> int32 GEMM (``ops/dypack.py``, ``torch._int_mm``)
with a bf16 epilogue and the bf16 ``leaky_step``. Membranes are carried in
bf16, in int8 on a per-channel affine grid with an exact zero point (ranges
from ``profile_mem_ranges``, or the reference's default range (-250, 1)),
or ``"mixed"``: the head's in bf16, the others in int8. ``calibrate_z``
adds an int8 requantisation of each GEMM's output.

Every op after the exact int32 GEMM is one correctly rounded bf16 or f32
op, in the reference's order, so the engine computes the reference's
function op for op: its states equal the reference's bit for bit, its flow
within one bf16 ulp (the pred head's sum is exact here, the reference's an
f32 sum; tanh's formulas differ). Divisors are device tensors, never host scalars (CUDA divides by
a host scalar through its reciprocal).

``Int8DeployEngine`` is an ``nn.Module`` whose prepared tensors are
buffers; its ``forward`` has ``FireNet``'s call and returns its structure,
so ``evaluate(config, model=engine)`` runs it under the protocol, per
window or in chunks (one CUDA graph replay). Feedforward units carry no
spikes: their state is ``LIFState(mem, None)``. ``save_engine`` and
``Int8DeployEngine.from_artifact`` write and read the reference's ``.npz``
artifacts (bf16 stored as f32, each key's dtype in ``__meta__``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from evflow_torch.export import fold_batchnorm_params
from evflow_torch.models.firenet import activity_fractions
from evflow_torch.ops.dypack import cols_dx, cols_dx_dual, dy_epilogue, int8_matmul, pack_kernel_dy
from evflow_torch.ops.lif import THRESH_MIN, LIFState, leaky_step

__all__ = ["Int8DeployEngine", "prepare_int8_params", "profile_mem_scales",
           "profile_mem_ranges", "save_engine", "check_artifact"]

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8, "float32": torch.float32}
_REC_UNITS = ("G1", "G2")


def _quantize_per_channel(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """OIHW kernel -> (int8 kernel, per-output-channel f32 scale)."""
    absmax = np.max(np.abs(kernel), axis=(1, 2, 3))
    scale = np.maximum(absmax, 1e-12) / 127.0
    w_i8 = np.clip(np.round(kernel / scale[:, None, None, None]), -127, 127).astype(np.int8)
    return w_i8, scale.astype(np.float32)


def _pack(w_i8: np.ndarray) -> torch.Tensor:
    return pack_kernel_dy(torch.from_numpy(w_i8)).contiguous()


def prepare_int8_params(model, mem_scales: Optional[Sequence[Any]] = None,
                        mem_ranges: Optional[Sequence[Tuple[Any, Any]]] = None,
                        input_scale: float = 1.0) -> Dict[str, Any]:
    """Fold and quantise a port ``FireNet``'s weights into the engine's
    tensors (on the CPU, in the reference's artifact layout: packed
    ``[(dx, ci), (dy, co)]`` int8 GEMM weights, HWIO ``pred_kernel``).
    Int8 membranes take ``mem_scales`` (one symmetric scale, scalar or
    per channel, a unit) or ``mem_ranges`` (per-unit (lo, hi): an
    asymmetric grid with an exact zero point)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    rec_units = set(_REC_UNITS) if model.recurrent else set()
    out: Dict[str, Any] = {"units": []}
    for i, name in enumerate(model.unit_names):
        def a(key):
            return sd[f"{name}.{key}"].numpy().astype(np.float32)

        scale_bn, var = a("bn.weight"), a("bn.running_var")
        fk, fb = fold_batchnorm_params(a("ff.weight"), scale_bn, a("bn.bias"),
                                       a("bn.running_mean"), var)
        unit: Dict[str, torch.Tensor] = {}
        if name in rec_units:
            g = scale_bn / np.sqrt(var + 1e-5)
            rk = a("rec.weight") * g[:, None, None, None]
            absmax = np.maximum(np.max(np.abs(fk), axis=(1, 2, 3)),
                                np.max(np.abs(rk), axis=(1, 2, 3)))
            scale = np.maximum(absmax, 1e-12) / 127.0
            wf = np.clip(np.round(fk / scale[:, None, None, None]), -127, 127).astype(np.int8)
            wr = np.clip(np.round(rk / scale[:, None, None, None]), -127, 127).astype(np.int8)
            unit["w"] = torch.cat([_pack(wf), _pack(wr)], dim=0)
        else:
            w_i8, scale = _quantize_per_channel(fk)
            unit["w"] = _pack(w_i8)
        # the dequant scale of GEMM column (dy, co) is scale[co]; the head's
        # folds the input scale in as well
        col = np.tile(scale, 3) * (input_scale if i == 0 else 1.0)
        unit["col_scale"] = torch.from_numpy(np.asarray(col, np.float32)).to(torch.bfloat16)
        unit["bias"] = torch.from_numpy(np.asarray(fb, np.float32)).to(torch.bfloat16)
        unit["beta"] = torch.from_numpy(
            np.clip(a("lif.beta").reshape(-1), 0.0, 1.0)).to(torch.bfloat16)
        unit["theta"] = torch.from_numpy(
            np.maximum(a("lif.threshold").reshape(-1), THRESH_MIN)).to(torch.bfloat16)
        if mem_ranges is not None:
            lo = np.asarray(mem_ranges[i][0], np.float32)
            hi = np.asarray(mem_ranges[i][1], np.float32)
            s = np.maximum(hi - lo, 1e-6) / 254.0
            zp = np.round(-127.0 - lo / s)  # integer zero point: mem 0 -> q zp
            unit["mem_scale"] = torch.from_numpy(np.asarray(s, np.float32))
            unit["mem_inv_scale"] = torch.from_numpy(np.asarray(1.0 / s, np.float32))
            unit["mem_zp"] = torch.from_numpy(np.asarray(zp, np.float32))
        elif mem_scales is not None:
            s = np.asarray(mem_scales[i], np.float32)
            unit["mem_scale"] = torch.from_numpy(s.copy())
            unit["mem_inv_scale"] = torch.from_numpy(
                np.asarray(1.0 / np.maximum(s, 1e-12), np.float32))
            unit["mem_zp"] = torch.from_numpy(np.zeros_like(s))
        out["units"].append(unit)
    pk = sd["pred.conv2d.weight"].numpy().astype(np.float32).transpose(2, 3, 1, 0)
    out["pred_kernel"] = torch.from_numpy(np.ascontiguousarray(pk)).to(torch.bfloat16)
    pb = sd.get("pred.conv2d.bias")
    out["pred_bias"] = None if pb is None else pb.float().to(torch.bfloat16)
    return out


def _mem_dequant(mem: torch.Tensor, unit: Dict[str, torch.Tensor]) -> torch.Tensor:
    """int8 (affine grid, exact zero point) -> bf16 membrane, in f32."""
    return ((mem.float() - unit["mem_zp"]) * unit["mem_scale"]).to(torch.bfloat16)


def _mem_quant(mem_out: torch.Tensor, unit: Dict[str, torch.Tensor]) -> torch.Tensor:
    """bf16 membrane -> int8: times the prepared reciprocal scale; an
    artifact older than ``mem_inv_scale`` takes ``1 / mem_scale`` here, as
    the reference does."""
    inv = unit.get("mem_inv_scale")
    if inv is None:
        inv = torch.ones_like(unit["mem_scale"]) / unit["mem_scale"]
    q = torch.round(mem_out.float() * inv) + unit["mem_zp"]
    return torch.clamp(q, -127, 127).to(torch.int8)


def _gemm_epilogue(Zi: torch.Tensor, unit: Dict[str, torch.Tensor], B: int, H: int, W: int,
                   C: int, z_int8: bool) -> torch.Tensor:
    """int32 GEMM output -> dequant (or int8 requant) -> dy shift-add -> + bias."""
    if z_int8:
        Zq = torch.clamp(torch.round(Zi.to(torch.bfloat16) * unit["z_requant"].to(torch.bfloat16)),
                         -127, 127).to(torch.int8).reshape(B, H, W, 3 * C)
        Z = Zq.to(torch.bfloat16) * unit["z_scale"]
    else:
        Z = Zi.to(torch.bfloat16).reshape(B, H, W, 3 * C) * unit["col_scale"]
    return dy_epilogue(Z, H, C) + unit["bias"]


class Int8DeployEngine(nn.Module):
    """The int8 serving engine of a port ``FireNet`` (its weights as
    loaded: ``weights.from_jax_variables``, a ``.pth`` or a msgpack run).

    ``mem_dtype``: ``"bfloat16"``, ``"int8"``, ``"mixed"`` (bf16 head,
    int8 elsewhere) or one name a unit. Int8 membranes without
    ``mem_scales``/``mem_ranges`` take the reference's default range
    (-250, 1). ``input_scale`` sets the input's int8 grid (pooled counts:
    ``1 / (ph * pw)``; voxels: a calibrated scale, required). ``prepared``
    takes tensors of ``prepare_int8_params`` (or an artifact's) instead of
    the model's weights: the model then gives only the architecture.
    """

    def __init__(self, model, mem_dtype: Any = "bfloat16",
                 mem_scales: Optional[Sequence[Any]] = None,
                 mem_ranges: Optional[Sequence[Tuple[Any, Any]]] = None,
                 input_scale: float = 1.0, prepared: Optional[Dict[str, Any]] = None):
        super().__init__()
        if model.cell_family != "snn":
            raise ValueError("Int8DeployEngine supports the snn cell family")
        if model.norm_input:
            raise ValueError("norm_input is not supported on the int8 path")
        if model.tebn or model.mpbn:
            raise ValueError("TEBN/MPBN models are not supported on the int8 path")
        if model.head.ff.kernel_size[0] != 3:
            raise ValueError("the dy-packed int8 path requires 3x3 kernels")
        if model.encoding != "cnt" and input_scale == 1.0:
            raise ValueError(
                "voxel-encoding models need a calibrated input_scale: voxel values are "
                "fractional in (0, 1) and would be rounded to int8 on the unit grid, "
                "destroying the input signal")
        n = model.num_units
        if mem_dtype == "mixed":
            per_unit = ("bfloat16",) + ("int8",) * (n - 1)
        elif isinstance(mem_dtype, str):
            per_unit = (mem_dtype,) * n
        else:
            per_unit = tuple(mem_dtype)
            if len(per_unit) != n:
                raise ValueError(f"mem_dtype sequence must have {n} entries")
        for d in per_unit:
            if d not in ("bfloat16", "int8"):
                raise ValueError(f"mem_dtype must be bfloat16 or int8, got {d!r}")
        if "int8" in per_unit and mem_scales is None and mem_ranges is None:
            mem_ranges = [(-250.0, 1.0)] * n  # the reference's state_quant range
        self.encoding = model.encoding
        self.unit_names = tuple(model.unit_names)
        rec = set(_REC_UNITS) if model.recurrent else set()
        self.unit_recurrent = tuple(u in rec for u in self.unit_names)
        self.num_units = n
        self.features = model.base_num_channels
        self.unit_mem_int8 = tuple(d == "int8" for d in per_unit)
        self.mem_dtype = ("int8" if all(self.unit_mem_int8) else
                          "bfloat16" if not any(self.unit_mem_int8) else "mixed")
        self.hard_reset = model.hard_reset
        self.model_name = type(model).__name__
        if prepared is None:
            prepared = prepare_int8_params(model, mem_scales=mem_scales, mem_ranges=mem_ranges,
                                           input_scale=input_scale)
        self.input_scale = float(input_scale)
        self.register_buffer("input_scale_t", torch.tensor(self.input_scale, dtype=torch.float32))
        self._unit_keys: List[List[str]] = []
        for i, unit in enumerate(prepared["units"]):
            self._unit_keys.append(sorted(unit))
            for k, v in unit.items():
                self.register_buffer(f"u{i}_{k}", v.clone())
        self.register_buffer("pred_kernel", prepared["pred_kernel"].clone())
        self.register_buffer("pred_bias", None if prepared["pred_bias"] is None
                             else prepared["pred_bias"].clone())
        self.serving: Optional[Dict[str, Any]] = None
        self.z_int8 = all("z_requant" in keys for keys in self._unit_keys)
        self.to(model.device)

    @property
    def params(self) -> Dict[str, Any]:
        """The prepared tensors, in the reference's ``engine.params`` tree."""
        return {"units": [{k: getattr(self, f"u{i}_{k}") for k in keys}
                          for i, keys in enumerate(self._unit_keys)],
                "pred_kernel": self.pred_kernel, "pred_bias": self.pred_bias}

    @property
    def device(self) -> torch.device:
        return self.pred_kernel.device

    @classmethod
    def from_artifact(cls, model, path: str) -> "Int8DeployEngine":
        """The engine of a ``save_engine`` artifact (the reference's or the
        port's) on ``model``'s device; ``model`` gives the architecture, the
        artifact the tensors, the membrane tiers and the input scale."""
        if check_artifact(path).get("model") == "SpikingRecEVFlowNet":
            raise ValueError(f"{path} is a SpikingRecEVFlowNet artifact: "
                             "evflow_torch.deploy_unet.Int8UNetEngine.from_artifact reads it")
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))

            def arr(key):
                return torch.from_numpy(np.array(z[key])).to(_TORCH_DTYPES[meta["dtypes"][key]])

            units = [{k: arr(f"unit{i}.{k}") for k in meta["unit_keys"][i]}
                     for i in range(meta["num_units"])]
            prepared = {"units": units, "pred_kernel": arr("pred_kernel"),
                        "pred_bias": arr("pred_bias") if "pred_bias" in z.files else None}
        if meta["num_units"] != model.num_units:
            raise ValueError(f"artifact has {meta['num_units']} units, model has "
                             f"{model.num_units}")
        engine = cls(model, mem_dtype=meta["mem_dtype"], input_scale=meta["input_scale"],
                     prepared=prepared)
        engine.serving = meta.get("serving")
        return engine

    def init_states(self, batch: int, height: int, width: int) -> Tuple[LIFState, ...]:
        """Zero states: an int8 membrane at its grid's zero point, a bf16 one
        at 0; int8 spike carries for the recurrent units only (the others'
        are never read back)."""
        shape = (batch, height, width, self.features)
        dev = self.device
        out = []
        for i, (rec, i8) in enumerate(zip(self.unit_recurrent, self.unit_mem_int8)):
            if i8:
                zp = torch.round(getattr(self, f"u{i}_mem_zp")).to(torch.int8)
                mem = zp.expand(shape).contiguous()
            else:
                mem = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
            spk = torch.zeros(shape, dtype=torch.int8, device=dev) if rec else None
            out.append(LIFState(mem, spk))
        return tuple(out)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.input_scale != 1.0:
            x = x / self.input_scale_t
        return torch.clamp(torch.round(x), -127, 127).to(torch.int8)

    def _units(self, x: torch.Tensor, states: Sequence[LIFState], zmax=None, taps=None):
        """The units' step; with ``zmax`` (a list) the calibration's pass:
        the f32 dequantised GEMM output, its column maxima appended."""
        B, H, W, _ = x.shape
        C = self.features
        reset = "zero" if self.hard_reset else "subtract"
        h = self._input(x)
        new_states: List[LIFState] = []
        for i, unit in enumerate(self.params["units"]):
            mem, prev_spk = states[i]
            mem_f = _mem_dequant(mem, unit) if self.unit_mem_int8[i] else mem
            cols = cols_dx_dual(h, prev_spk) if self.unit_recurrent[i] else cols_dx(h)
            Zi = int8_matmul(cols.reshape(-1, cols.shape[-1]), unit["w"])
            if zmax is None:
                y = _gemm_epilogue(Zi, unit, B, H, W, C, self.z_int8)
            else:
                Zf = Zi.float() * unit["col_scale"].float()
                zmax.append(Zf.abs().amax(dim=0))
                y = dy_epilogue(Zf.to(torch.bfloat16).reshape(B, H, W, 3 * C), H, C) + \
                    unit["bias"]
            spk, mem_out = leaky_step(y, mem_f, unit["beta"], unit["theta"], reset=reset)
            h = spk.to(torch.int8)
            if self.unit_mem_int8[i]:
                mem_out = _mem_quant(mem_out, unit)
            new_states.append(LIFState(mem_out, h if self.unit_recurrent[i] else None))
            if taps is not None:
                taps[f"{i + 1}:{self.unit_names[i]}"] = spk
        return h, tuple(new_states)

    def forward(self, event_voxel: Optional[torch.Tensor], event_cnt: Optional[torch.Tensor],
                states: Sequence[LIFState], log: bool = False, timestep: Optional[int] = None):
        """One window on the int8 path: ``({"flow": [flow [B, H, W, 2] f32],
        "activity": ...}, new_states)``, as ``FireNet.forward``."""
        del timestep
        x = event_cnt if self.encoding == "cnt" else event_voxel
        if x is None:
            raise ValueError("Selected encoding input is None")
        taps = {"0:input": x.float()} if log else None
        h, new_states = self._units(x, states, taps=taps)
        # the pred head: at most C bf16 weights a pixel, summed exactly in
        # f64 (no TF32, no reduced-precision reduction, no dependence on the
        # GEMM's order), rounded to f32 and then to bf16; + bias, tanh in bf16
        B, H, W, C = h.shape
        flow = (h.reshape(-1, C).double() @ self.pred_kernel[0, 0].double()).float()
        flow = flow.to(torch.bfloat16).reshape(B, H, W, -1)
        if self.pred_bias is not None:
            flow = flow + self.pred_bias
        flow = torch.tanh(flow).float()
        activity = None
        if log:
            taps[f"{self.num_units + 1}:pred"] = flow
            activity = activity_fractions(taps)
        return {"flow": [flow], "activity": activity}, new_states

    @torch.no_grad()
    def calibrate_z(self, windows: Sequence[Any], margin: float = 1.05):
        """Enable the int8 requantisation of each GEMM's output, with
        per-column scales from the maxima over ``windows`` (``[B, H, W, 2]``
        input windows of the evaluation's distribution)."""
        if len(windows) == 0:
            raise ValueError("calibrate_z needs at least one sample window")
        dev = self.device
        states = self.init_states(*windows[0].shape[:3])
        maxes = [np.zeros(u["w"].shape[-1], np.float32) for u in self.params["units"]]
        for w in windows:
            zmax: List[torch.Tensor] = []
            _, states = self._units(torch.as_tensor(w).to(dev), states, zmax=zmax)
            for i, m in enumerate(zmax):
                maxes[i] = np.maximum(maxes[i], m.cpu().numpy().astype(np.float32))
        for i, m in enumerate(maxes):
            s_z = np.maximum(m * margin, 1e-8) / 127.0
            col = getattr(self, f"u{i}_col_scale").float().cpu().numpy()
            self.register_buffer(f"u{i}_z_scale",
                                 torch.from_numpy(np.asarray(s_z, np.float32))
                                 .to(torch.bfloat16).to(dev))
            self.register_buffer(f"u{i}_z_requant",
                                 torch.from_numpy(np.asarray(col / s_z, np.float32)).to(dev))
            self._unit_keys[i] = sorted(set(self._unit_keys[i]) | {"z_scale", "z_requant"})
        self.z_int8 = True


def check_artifact(path: str) -> Dict[str, Any]:
    """An artifact's ``__meta__`` (its ``model`` says which engine reads it)."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def save_engine(engine: Int8DeployEngine, path: str, serving=None) -> str:
    """Write the engine's prepared tensors and configuration as one ``.npz``
    artifact in the reference's format (``evflow.deploy.Int8DeployEngine
    .from_artifact`` reads it): bf16 stored as f32, every key's dtype in
    ``__meta__``. ``serving``, a dict (or an object with ``to_meta()``),
    is carried as ``meta["serving"]``; it defaults to the engine's own."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    def put(key, v: torch.Tensor):
        dtypes[key] = str(v.dtype).replace("torch.", "")
        v = v.detach().cpu()
        arrays[key] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()

    params = engine.params
    unit_keys = []
    for i, u in enumerate(params["units"]):
        unit_keys.append(sorted(u))
        for k, v in u.items():
            put(f"unit{i}.{k}", v)
    put("pred_kernel", params["pred_kernel"])
    if params["pred_bias"] is not None:
        put("pred_bias", params["pred_bias"])
    meta = {"num_units": engine.num_units, "unit_keys": unit_keys, "dtypes": dtypes,
            "mem_dtype": ["int8" if b else "bfloat16" for b in engine.unit_mem_int8],
            "input_scale": engine.input_scale, "model": engine.model_name}
    if serving is None:
        serving = engine.serving
    if serving is not None:
        meta["serving"] = serving if isinstance(serving, dict) else serving.to_meta()
    if not path.endswith(".npz"):
        path = path + ".npz"  # np.savez appends it anyway: return the real name
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)
    return path


@torch.no_grad()
def profile_mem_ranges(model, windows: Sequence[Any], margin: float = 1.1, floor: float = 1e-3,
                       per_channel: bool = True,
                       input_scale: float = 1.0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-unit (lo, hi) membrane ranges (per channel unless not
    ``per_channel``) for int8 membranes on an asymmetric grid, from the
    bf16-membrane engine of ``model`` streamed over ``windows`` (the
    model's encoding; voxels need ``input_scale``): the extremes times
    ``margin``, at least ``floor`` away from 0."""
    probe = Int8DeployEngine(model, input_scale=input_scale)
    states = probe.init_states(*windows[0].shape[:3])
    dims = (0, 1, 2) if per_channel else None
    shape = (probe.features,) if per_channel else ()
    lo = [np.zeros(shape) for _ in range(probe.num_units)]
    hi = [np.zeros(shape) for _ in range(probe.num_units)]
    is_cnt = probe.encoding == "cnt"
    for w in windows:
        x = torch.as_tensor(w).to(probe.device)
        _, states = probe(None if is_cnt else x, x if is_cnt else None, states)
        for i, s in enumerate(states):
            m = s.mem.float()
            mn = m.amin(dim=dims) if dims else m.amin()
            mx = m.amax(dim=dims) if dims else m.amax()
            lo[i] = np.minimum(lo[i], mn.cpu().numpy())
            hi[i] = np.maximum(hi[i], mx.cpu().numpy())
    return [(np.minimum(l * margin, -floor), np.maximum(h * margin, floor))
            for l, h in zip(lo, hi)]


def profile_mem_scales(model, windows: Sequence[Any], margin: float = 1.1, floor: float = 1e-3,
                       per_channel: bool = True, input_scale: float = 1.0) -> List[np.ndarray]:
    """Per-unit symmetric membrane scales: ``max(|lo|, |hi|) / 127`` of
    ``profile_mem_ranges``."""
    ranges = profile_mem_ranges(model, windows, margin=margin, floor=floor,
                                per_channel=per_channel, input_scale=input_scale)
    return [np.maximum(np.abs(lo), np.abs(hi)) / 127.0 for lo, hi in ranges]
