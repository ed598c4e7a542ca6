"""The int8 serving engine of the spiking UNet (port of
``evflow/deploy_unet.py``).

A port ``SpikingRecEVFlowNet`` is prepared once on the host, in the
reference's layout: every conv kernel quantised to int8 per output channel
(HWIO ``w``, f32 ``scale``); a recurrent encoder's ff and rec kernels
concatenated on the input axis under one scale, since both read unit
spikes; the head's kernel times ``input_scale``; each decoder's kernel
times its input channels' grids (``in_scale``: 1/16 for the spike
channels, whose bilinear x2 lands on sixteenths, 1/127 for the two
prediction channels it reads after the first decoder) before it is
quantised. Inference carries spikes as small integers (bf16, or int8 on
the ``int8`` and ``hybrid8`` tiers), membranes in bf16 or f32
(``mem_dtype``), and runs every conv as an exact integer sum:

* ``compute="bfloat16"``: every conv as a cuDNN f32 conv of the integer
  values (in full f32, not TF32; the reference's bf16 conv with an f32
  output: ``F.conv2d`` on bf16 operands would round the sum to bf16);
* ``compute="int8"``: every conv, stride 2 included, as an im2col buffer of
  int8 values times the int8 kernel, ``ops/dypack.py::int8_matmul``
  (``torch._int_mm``, int32 out);
* ``compute="hybrid"`` / ``"hybrid8"``: stride-1 convs whose input is at
  least ``dypack_min_spatial`` pixels high ride the dy-packed int8 GEMM
  (``cols_dx`` -> ``int8_matmul`` -> bf16 -> per-column scale in bf16 ->
  ``dy_epilogue`` in bf16), the others the f32 conv.

Each sum times the per-channel scale gives the f32 input current of the
exact sigmoid-LIF update; each decoder's input is ``[pred | h | skip]``
upsampled bilinearly and requantised onto its grids, as the reference
does: the spike channels exactly on sixteenths, the prediction channels as
``round(up(pred_q) * 127)`` clipped to int8, where ``pred_q = round(flow *
127)`` is already on the 1/127 grid, so they saturate at ±127 wherever the
upsampled prediction is not 0 (the reference's function, which the port
keeps so that states and artifacts stay bit-equal; ROADMAP.md queue 3).
With ``phase_decoders`` the bilinear x2 is folded into four phase kernels
at the low resolution (``_phase_decoder_params``), the prediction feedback
by its own conv of ``pred_q`` on the 1/127 grid (the one lossy activation
there); the decoder carries then hold the four phases stacked on the
channels. The flow heads sum their spike
terms exactly (f64, then rounded to f32) and take tanh in f64: the flow
feeds back through ``round(flow * 127)``. ``sigmoid(leak)`` is computed
once on the host. Divisors are device tensors (CUDA divides by a host
scalar through its reciprocal).

``Int8UNetEngine`` is an ``nn.Module`` whose prepared tensors are buffers;
its ``forward`` has ``SpikingRecEVFlowNet``'s call, so ``evaluate(config,
model=engine)`` runs it under the protocol, per window or in chunks (one
CUDA graph replay). ``save_unet_engine`` and ``Int8UNetEngine.from_artifact``
write and read the reference's ``.npz`` artifacts.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from evflow_torch.deploy import _TORCH_DTYPES, _quantize_per_channel
from evflow_torch.models.cells import full_f32_convs
from evflow_torch.models.firenet import activity_fractions
from evflow_torch.models.unet import CropParameters, upsample_nearest
from evflow_torch.ops.dypack import cols_dx, cols_dx_dual, dy_epilogue, int8_matmul, pack_kernel_dy
from evflow_torch.ops.lif import THRESH_MIN, LIFState

__all__ = ["Int8UNetEngine", "prepare_unet_int8_params", "quantize_unet_weights",
           "save_unet_engine", "COMPUTE_TIERS"]

COMPUTE_TIERS = ("bfloat16", "int8", "hybrid", "hybrid8")
_UP_GRID = 16.0  # bilinear x2 taps are sixteenths: the exact grid of upsampled spikes
_PRED_GRID = 127.0  # the tanh flow feedback in (-1, 1)
_CANONICAL = ("w", "scale", "leak", "thresh", "in_scale", "kernel", "bias")

# half-pixel bilinear x2 row weights: _PHASE_A[n + 1, m + 1] is the
# coefficient of x[i + m] in the upsampled row at output index 2i + n
_PHASE_A = np.zeros((4, 3), np.float32)
_PHASE_A[0, 0], _PHASE_A[0, 1] = 0.75, 0.25
_PHASE_A[1, 0], _PHASE_A[1, 1] = 0.25, 0.75
_PHASE_A[2, 1], _PHASE_A[2, 2] = 0.75, 0.25
_PHASE_A[3, 1], _PHASE_A[3, 2] = 0.25, 0.75


def _quantize_hwio(kernel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """HWIO kernel -> (int8 HWIO kernel, per-output-channel f32 scale)."""
    w, s = _quantize_per_channel(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0)), s


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def _pack_hwio(w: np.ndarray) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` -> dy-packed ``[3 Cin, 3 Cout]``."""
    return pack_kernel_dy(_oihw(torch.from_numpy(np.ascontiguousarray(w)))).contiguous()


def _phase_interleave(z_ph: torch.Tensor, cout: int) -> torch.Tensor:
    """``[B, Hc, Wc, 4 cout]`` phase-stacked -> ``[B, 2Hc, 2Wc, cout]``
    (phase ``2p + q`` -> output pixel ``(2i + p, 2j + q)``)."""
    B, Hc, Wc, _ = z_ph.shape
    return z_ph.reshape(B, Hc, Wc, 2, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(
        B, 2 * Hc, 2 * Wc, cout)


def _phase_decoder_params(du: Dict[str, torch.Tensor], num_pred_channels: int,
                          first: bool) -> Dict[str, torch.Tensor]:
    """The bilinear x2 folded into the decoder's kernel: four per-phase 3x3
    kernels at the low resolution. The spike part (``[h | skip]``, equal
    channel counts) is dy-packed for ``cols_dx_dual(h, skip)`` and quantised
    per (phase, output channel): ``pw{p}{q}``, scales ``ps{p}{q}`` (bf16,
    tiled over dy); the prediction part (after the first decoder) is one
    HWIO kernel with the four phases stacked on the output axis (``pwp``,
    ``psp``). ``pleak``/``pthresh`` tile the LIF parameters over the phases.
    Away from a 1-2 pixel border frame this is the conv of the upsampled
    map (resize clamps the edge, the phase convs zero-pad)."""
    k = du["w"].float().numpy() * du["scale"].numpy()
    k = k / du["in_scale"].numpy()[None, None, :, None]
    npred = 0 if first else num_pred_channels
    k_pred = k[:, :, :npred] / _PRED_GRID
    k_spk = k[:, :, npred:]
    ch = k_spk.shape[2] // 2

    def fold(kin: np.ndarray, p: int, q: int) -> np.ndarray:
        kp = np.zeros_like(kin)
        for dy in range(3):
            for dx in range(3):
                for my in range(3):
                    for mx in range(3):
                        kp[my, mx] += kin[dy, dx] * _PHASE_A[p + dy, my] * _PHASE_A[q + dx, mx]
        return kp

    out: Dict[str, torch.Tensor] = {}
    for p in range(2):
        for q in range(2):
            w8, sc = _quantize_hwio(fold(k_spk, p, q))
            out[f"pw{p}{q}"] = torch.cat([_pack_hwio(w8[:, :, :ch]), _pack_hwio(w8[:, :, ch:])],
                                         dim=0)
            out[f"ps{p}{q}"] = torch.from_numpy(np.tile(sc, 3)).to(torch.bfloat16)
    if npred:
        kph = np.concatenate([fold(k_pred, p, q) for p in range(2) for q in range(2)], axis=3)
        w8, sc = _quantize_hwio(kph)
        out["pwp"] = torch.from_numpy(w8)
        out["psp"] = torch.from_numpy(np.asarray(sc, np.float32))
    for name in ("leak", "thresh"):
        out[f"p{name}"] = du[name].repeat(4)
    return out


def _unit(kernel: np.ndarray, leak, thresh) -> Dict[str, torch.Tensor]:
    w, s = _quantize_hwio(kernel)
    return {"w": torch.from_numpy(w), "scale": torch.from_numpy(np.asarray(s, np.float32)),
            "leak": torch.from_numpy(np.asarray(leak, np.float32).reshape(-1).copy()),
            "thresh": torch.from_numpy(np.asarray(thresh, np.float32).reshape(-1).copy())}


def prepare_unet_int8_params(model, input_scale: float = 1.0) -> Dict[str, Any]:
    """Quantise a port ``SpikingRecEVFlowNet``'s weights into the engine's
    tensors, on the CPU, in the reference's tree: ``{"enc": [{"conv": u,
    "rec": u}], "res": [(u, u)], "dec": [u], "pred": [{"kernel", "bias"}]}``,
    each conv unit ``u`` with int8 HWIO ``w``, f32 ``scale``, ``leak`` and
    ``thresh``; a decoder's also its folded per-input-channel ``in_scale``."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}
    E, R = model.num_encoders, model.num_residual_blocks
    npred = model.multires_unetrec.num_output_channels

    def hwio(key):
        return np.ascontiguousarray(sd[key].transpose(2, 3, 1, 0))

    def cell(prefix):
        return sd[f"{prefix}.leak"], sd[f"{prefix}.thresh"]

    u = "multires_unetrec"
    out: Dict[str, Any] = {"enc": [], "res": [], "dec": [], "pred": []}
    for i in range(E):
        c, r = f"{u}.encoders.{i}.conv", f"{u}.encoders.{i}.recurrent_block"
        k = hwio(f"{c}.ff.weight")
        if i == 0:
            k = k * input_scale  # the head folds the input grid in
        kcat = np.concatenate([hwio(f"{r}.ff.weight"), hwio(f"{r}.rec.weight")], axis=2)
        out["enc"].append({"conv": _unit(k, *cell(c)), "rec": _unit(kcat, *cell(r))})
    for i in range(R):
        b = f"{u}.resblocks.{i}"
        out["res"].append(tuple(_unit(hwio(f"{b}.{n}.ff.weight"), *cell(f"{b}.{n}"))
                                for n in ("conv1", "conv2")))
    for i in range(E):
        d = f"{u}.decoders.{i}.conv2d"
        k = hwio(f"{d}.ff.weight")
        s_in = np.full((k.shape[2],), 1.0 / _UP_GRID, np.float32)
        if i > 0:
            s_in[:npred] = 1.0 / _PRED_GRID  # skip(pred, skip(x, block)): pred leads
        unit = _unit(k * s_in[None, None, :, None], *cell(d))
        unit["in_scale"] = torch.from_numpy(s_in)
        out["dec"].append(unit)
    for i in range(E):
        p = f"{u}.preds.{i}.conv2d"
        out["pred"].append({"kernel": torch.from_numpy(hwio(f"{p}.weight")),
                            "bias": torch.from_numpy(sd[f"{p}.bias"].copy())})
    return out


def quantize_unet_weights(model, input_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The port state dict of ``model`` with every conv kernel replaced by
    its dequantised int8 image (the engine's shared and folded scales
    undone): the fake-quant f32 twin of the engine, which isolates the
    weight rounding, so that the engine's integer arithmetic can be held
    against it."""
    prepared = prepare_unet_int8_params(model, input_scale=input_scale)
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    def deq(unit) -> np.ndarray:
        return unit["w"].float().numpy() * unit["scale"].numpy()

    def put(key, k_hwio):
        sd[key] = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))

    u = "multires_unetrec"
    for i, enc in enumerate(prepared["enc"]):
        kq = deq(enc["conv"])
        if i == 0 and input_scale != 1.0:
            kq = kq / input_scale
        put(f"{u}.encoders.{i}.conv.ff.weight", kq)
        kcat = deq(enc["rec"])
        cin = kcat.shape[2] // 2
        put(f"{u}.encoders.{i}.recurrent_block.ff.weight", kcat[:, :, :cin])
        put(f"{u}.encoders.{i}.recurrent_block.rec.weight", kcat[:, :, cin:])
    for i, pair in enumerate(prepared["res"]):
        for name, cu in zip(("conv1", "conv2"), pair):
            put(f"{u}.resblocks.{i}.{name}.ff.weight", deq(cu))
    for i, du in enumerate(prepared["dec"]):
        put(f"{u}.decoders.{i}.conv2d.ff.weight",
            deq(du) / du["in_scale"].numpy()[None, None, :, None])
    return sd


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``[B, Ho, Wo, (dy, dx, ci)]`` patches of NHWC ``x`` padded by k//2:
    the rows of an HWIO kernel reshaped to ``[k k Cin, Cout]``."""
    p = k // 2
    B, H, W, _ = x.shape
    Ho, Wo = (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1
    xp = F.pad(x, (0, 0, p, p, p, p))
    return torch.cat([xp[:, dy:dy + stride * (Ho - 1) + 1:stride,
                         dx:dx + stride * (Wo - 1) + 1:stride, :]
                      for dy in range(k) for dx in range(k)], dim=-1)


def _conv_f32(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1,
              padding: Optional[int] = None) -> torch.Tensor:
    """NHWC conv of integer values in f32 (full f32 on the card): exact
    below 2^24."""
    ctx = full_f32_convs() if x.is_cuda else contextlib.nullcontext()
    with ctx:
        y = F.conv2d(x.float().permute(0, 3, 1, 2), w_oihw, stride=stride,
                     padding=w_oihw.shape[-1] // 2 if padding is None else padding)
    return y.permute(0, 2, 3, 1)


def _conv_int8(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC conv of int8 values by an int8 HWIO kernel as im2col +
    ``int8_matmul``: the exact int32 sums."""
    k, cout = w_hwio.shape[0], w_hwio.shape[3]
    cols = _im2col(x.to(torch.int8), k, stride)
    B, Ho, Wo, K = cols.shape
    return int8_matmul(cols.reshape(-1, K), w_hwio.reshape(K, cout)).reshape(B, Ho, Wo, cout)


class Int8UNetEngine(nn.Module):
    """The int8 serving engine of a port ``SpikingRecEVFlowNet`` (its
    weights as loaded). ``compute``: ``bfloat16``, ``int8``, ``hybrid`` or
    ``hybrid8`` (see the module's docstring); ``mem_dtype``: ``bfloat16``
    (serving) or ``float32``; ``input_scale``: the input's int8 grid
    (voxels need a calibrated one); ``dypack_min_spatial``: the hybrid
    tiers' crossover (a plain attribute: the tests lower it);
    ``phase_decoders``: the folded decoders. ``prepared`` takes tensors of
    ``prepare_unet_int8_params`` (or an artifact's) instead of the model's
    weights: the model then gives only the architecture."""

    def __init__(self, model, mem_dtype: str = "bfloat16", input_scale: float = 1.0,
                 compute: str = "hybrid", phase_decoders: bool = False,
                 dypack_min_spatial: int = 128, prepared: Optional[Dict[str, Any]] = None):
        super().__init__()
        if type(model).__name__ != "SpikingRecEVFlowNet":
            raise ValueError("Int8UNetEngine deploys SpikingRecEVFlowNet; the FireNet family "
                             "uses evflow_torch.deploy.Int8DeployEngine")
        if model.norm is not None:
            raise ValueError("normalized cells are not supported on the int8 path")
        if model.norm_input:
            raise ValueError("norm_input is not supported on the int8 path")
        if model.encoding != "cnt" and input_scale == 1.0:
            raise ValueError("voxel-encoding models need a calibrated input_scale "
                             "(fractional voxel values would round to the unit grid)")
        if mem_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"mem_dtype must be bfloat16/float32, got {mem_dtype!r}")
        if compute not in COMPUTE_TIERS:
            raise ValueError(f"compute must be bfloat16/int8/hybrid/hybrid8, got {compute!r}")
        if _UP_GRID * (1 + model.num_residual_blocks) > 127:
            raise ValueError(f"{model.num_residual_blocks} residual blocks overflow the exact "
                             "1/16 decoder grid")
        self.model_name = type(model).__name__
        self.encoding = model.encoding
        self.num_encoders = model.num_encoders
        self.num_residual_blocks = model.num_residual_blocks
        self.base_num_channels = model.base_num_channels
        self.num_output_channels = model.multires_unetrec.num_output_channels
        self.hard_reset = model.hard_reset
        self.mem_dtype = mem_dtype
        self._mem_tdtype = _TORCH_DTYPES[mem_dtype]
        self.compute = compute
        self.hybrid = compute in ("hybrid", "hybrid8")
        self._cdtype = torch.int8 if compute in ("int8", "hybrid8") else torch.bfloat16
        self.input_scale = float(input_scale)
        self.phase_decoders = bool(phase_decoders)
        self.dypack_min_spatial = int(dypack_min_spatial)
        self.serving: Optional[Dict[str, Any]] = None
        if prepared is None:
            prepared = prepare_unet_int8_params(model, input_scale=input_scale)
        self.register_buffer("input_scale_t", torch.tensor(self.input_scale))
        for i, e in enumerate(prepared["enc"]):
            self._put(f"enc{i}_conv", e["conv"], stride=2)
            self._put(f"enc{i}_rec", e["rec"])
        for i, pair in enumerate(prepared["res"]):
            for j, u in enumerate(pair):
                self._put(f"res{i}_{j}", u)
        for i, du in enumerate(prepared["dec"]):
            self._put(f"dec{i}", du)
            if self.phase_decoders:
                for k, v in _phase_decoder_params(du, self.num_output_channels,
                                                  first=i == 0).items():
                    self.register_buffer(f"dec{i}_{k}", v.clone())
                self.register_buffer(f"dec{i}_pleak_s", torch.sigmoid(du["leak"].repeat(4)))
                self.register_buffer(f"dec{i}_pthresh_c", self._thresh_c(du["thresh"].repeat(4)))
                if i > 0:
                    self.register_buffer(f"dec{i}_pwp_oihw", _oihw(getattr(
                        self, f"dec{i}_pwp").float()))
        for i, pu in enumerate(prepared["pred"]):
            self.register_buffer(f"pred{i}_kernel", pu["kernel"].float().clone())
            self.register_buffer(f"pred{i}_bias", pu["bias"].float().clone())
        self.to(model.device)

    @staticmethod
    def _thresh_c(thresh: torch.Tensor) -> torch.Tensor:
        return torch.maximum(thresh, thresh.new_full((), THRESH_MIN))

    def _put(self, name: str, unit: Dict[str, torch.Tensor], stride: int = 1):
        """Register a conv unit's canonical tensors (``w`` in the tier's
        dtype: int8, or its exact bf16 image on the bf16 tier) and what the
        tier's convs read: the f32 OIHW kernel, the dy-packed int8 kernel and
        its bf16 column scales (hybrid tiers, stride 1), ``sigmoid(leak)``
        and the clamped threshold."""
        w = unit["w"].to(torch.int8)
        self.register_buffer(f"{name}_w", w.to(torch.bfloat16) if self.compute == "bfloat16"
                             else w.clone())
        for k in ("scale", "leak", "thresh", "in_scale"):
            if k in unit:
                self.register_buffer(f"{name}_{k}", unit[k].float().clone())
        self.register_buffer(f"{name}_oihw", _oihw(w.float()))
        if self.hybrid and stride == 1 and w.shape[0] == 3:
            self.register_buffer(f"{name}_packed", pack_kernel_dy(_oihw(w)).contiguous())
            self.register_buffer(f"{name}_col_scale",
                                 unit["scale"].float().repeat(3).to(torch.bfloat16))
        self.register_buffer(f"{name}_leak_s", torch.sigmoid(unit["leak"].float()))
        self.register_buffer(f"{name}_thresh_c", self._thresh_c(unit["thresh"].float()))

    def _unit(self, name: str) -> Dict[str, torch.Tensor]:
        keys = ("w", "scale", "leak", "thresh", "in_scale")
        return {k: getattr(self, f"{name}_{k}") for k in keys if hasattr(self, f"{name}_{k}")}

    @property
    def params(self) -> Dict[str, Any]:
        """The prepared tensors in the reference's ``engine.params`` tree
        (the phase tensors included with ``phase_decoders``)."""
        E, R = self.num_encoders, self.num_residual_blocks
        dec = []
        for i in range(E):
            du = self._unit(f"dec{i}")
            if self.phase_decoders:
                for k in ("pw00", "pw01", "pw10", "pw11", "ps00", "ps01", "ps10", "ps11",
                          "pwp", "psp", "pleak", "pthresh"):
                    if hasattr(self, f"dec{i}_{k}"):
                        du[k] = getattr(self, f"dec{i}_{k}")
            dec.append(du)
        return {"enc": [{s: self._unit(f"enc{i}_{s}") for s in ("conv", "rec")}
                        for i in range(E)],
                "res": [tuple(self._unit(f"res{i}_{j}") for j in range(2)) for i in range(R)],
                "dec": dec,
                "pred": [{"kernel": getattr(self, f"pred{i}_kernel"),
                          "bias": getattr(self, f"pred{i}_bias")} for i in range(E)]}

    @property
    def device(self) -> torch.device:
        return self.input_scale_t.device

    @classmethod
    def from_artifact(cls, model, path: str) -> "Int8UNetEngine":
        """The engine of a ``save_unet_engine`` artifact (the reference's or
        the port's) on ``model``'s device: ``model`` gives the architecture,
        the artifact the tensors, the tiers and the input scale."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))

            def arr(key):
                return torch.from_numpy(np.array(z[key])).to(_TORCH_DTYPES[meta["dtypes"][key]])

            E, R = meta["num_encoders"], meta["num_residual_blocks"]
            conv_keys = ("w", "scale", "leak", "thresh")
            prepared = {
                "enc": [{side: {k: arr(f"enc/{i}/{side}/{k}") for k in conv_keys}
                         for side in ("conv", "rec")} for i in range(E)],
                "res": [tuple({k: arr(f"res/{i}/{j}/{k}") for k in conv_keys} for j in range(2))
                        for i in range(R)],
                "dec": [{k: arr(f"dec/{i}/{k}") for k in conv_keys + ("in_scale",)}
                        for i in range(E)],
                "pred": [{k: arr(f"pred/{i}/{k}") for k in ("kernel", "bias")} for i in range(E)],
            }
        if E != model.num_encoders or R != model.num_residual_blocks:
            raise ValueError(f"artifact is a {E}-encoder/{R}-resblock net, model has "
                             f"{model.num_encoders}/{model.num_residual_blocks}")
        engine = cls(model, mem_dtype=meta["mem_dtype"], compute=meta.get("compute", "int8"),
                     phase_decoders=meta.get("phase_decoders", False),
                     input_scale=meta["input_scale"], prepared=prepared)
        engine.serving = meta.get("serving")
        return engine

    def tp_jit_step(self, *args, **kwargs):
        raise NotImplementedError("the tensor-parallel engine step comes with the multi-device "
                                  "paths, ROADMAP.md queue 1 item 11")

    # -- state ---------------------------------------------------------------

    def init_states(self, batch: int, height: int, width: int) -> Tuple[LIFState, ...]:
        """Zero states in the model's slot order (2 an encoder, 2 a residual
        block, 1 a decoder): membranes in ``mem_dtype``, spikes in the
        carrier dtype; with ``phase_decoders`` a decoder slot is
        ``[B, Hc, Wc, 4 C]`` at the low resolution."""
        crop = CropParameters(width, height, self.num_encoders)
        h, w = crop.height_crop, crop.width_crop
        C, E = self.base_num_channels, self.num_encoders
        out_sizes = [int(C * 2 ** (i + 1)) for i in range(E)]
        in_sizes = [int(C * 2 ** i) for i in range(E)]
        dev = self.device

        def zs(h, w, c):
            return LIFState(torch.zeros((batch, h, w, c), dtype=self._mem_tdtype, device=dev),
                            torch.zeros((batch, h, w, c), dtype=self._cdtype, device=dev))

        states = []
        for c in out_sizes:
            h, w = h // 2, w // 2
            states += [zs(h, w, c), zs(h, w, c)]
        for _ in range(2 * self.num_residual_blocks):
            states.append(zs(h, w, out_sizes[-1]))
        for c in reversed(in_sizes):
            if self.phase_decoders:
                states.append(zs(h, w, 4 * c))
                h, w = h * 2, w * 2
            else:
                h, w = h * 2, w * 2
                states.append(zs(h, w, c))
        return tuple(states)

    # -- inference -------------------------------------------------------------

    def _conv_ff(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        """The unit's f32 input current on the tier's path (see the module's
        docstring)."""
        if self.hybrid and stride == 1 and x.shape[1] >= self.dypack_min_spatial:
            B, H, W, _ = x.shape
            packed = getattr(self, f"{name}_packed")
            cout = packed.shape[1] // 3
            cols = cols_dx(x.to(torch.int8))
            Z = int8_matmul(cols.reshape(-1, cols.shape[-1]), packed).to(torch.bfloat16)
            Z = Z.reshape(B, H, W, 3 * cout) * getattr(self, f"{name}_col_scale")
            return dy_epilogue(Z, H, cout).float()
        if self.compute == "int8":
            w = getattr(self, f"{name}_w")
            acc = _conv_int8(x, w, stride).float()
        else:
            acc = _conv_f32(x, getattr(self, f"{name}_oihw"), stride)
        return acc * getattr(self, f"{name}_scale")

    def _lif(self, ff: torch.Tensor, name: str, state: LIFState, prefix: str = ""):
        """The exact sigmoid-LIF update (forward of ``sigmoid_lif_step``)
        on the f32 input current: ``(spikes in the carrier dtype, state)``."""
        leak_s = getattr(self, f"{name}_{prefix}leak_s")
        thresh_c = getattr(self, f"{name}_{prefix}thresh_c")
        v, z = state.mem.float(), state.spk.float()
        if self.hard_reset:
            v_out = v * leak_s * (1.0 - z) + (1.0 - leak_s) * ff
        else:
            v_out = v * leak_s + (1.0 - leak_s) * ff - z * thresh_c
        zi = (v_out - thresh_c > 0).to(self._cdtype)
        return zi, LIFState(v_out.to(self._mem_tdtype), zi)

    def _flow(self, z: torch.Tensor, i: int) -> torch.Tensor:
        """``tanh(z @ kernel + bias)``: the spike terms summed exactly (f64,
        rounded once to f32), + bias in f32, tanh in f64 rounded to f32."""
        k = getattr(self, f"pred{i}_kernel")[0, 0]
        s = (z.reshape(-1, z.shape[-1]).double() @ k.double()).float()
        s = s.reshape(*z.shape[:-1], k.shape[1]) + getattr(self, f"pred{i}_bias")
        return torch.tanh(s.double()).float()

    def _pred_q(self, flow: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(flow * _PRED_GRID), -127, 127).to(self._cdtype)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.input_scale != 1.0:
            x = x / self.input_scale_t
        return torch.clamp(torch.round(x), -127, 127).to(self._cdtype)

    def _phase_decoder(self, i: int, h, skip, pred_q, state: LIFState):
        """One folded decoder: four int8 phase GEMMs over one low-resolution
        ``cols_dx_dual(h, skip)``, the prediction feedback by its own f32
        conv; returns the phase-stacked ``(spikes, state)``."""
        name = f"dec{i}"
        hq, sq = h.to(torch.int8), skip.to(torch.int8)
        B, Hc, Wc, _ = hq.shape
        cols = cols_dx_dual(hq, sq)
        cols = cols.reshape(-1, cols.shape[-1])
        ys = []
        for p in range(2):
            for q in range(2):
                pw = getattr(self, f"{name}_pw{p}{q}")
                cout = pw.shape[1] // 3
                Z = int8_matmul(cols, pw).to(torch.bfloat16).reshape(B, Hc, Wc, 3 * cout)
                ys.append(dy_epilogue(Z * getattr(self, f"{name}_ps{p}{q}"), Hc, cout))
        ff = torch.cat(ys, dim=-1).float()
        if i > 0:
            ff = ff + getattr(self, f"{name}_psp") * _conv_f32(
                pred_q, getattr(self, f"{name}_pwp_oihw"))
        return self._lif(ff, name, state, prefix="p")

    def forward(self, event_voxel: Optional[torch.Tensor], event_cnt: Optional[torch.Tensor],
                states: Sequence[LIFState], log: bool = False, timestep: Optional[int] = None):
        """One window on the int8 path: ``({"flow": [4 flows [B, H, W, 2]
        f32], "activity": ...}, new_states)``, as ``SpikingRecEVFlowNet``."""
        del timestep
        x = event_cnt if self.encoding == "cnt" else event_voxel
        if x is None:
            raise ValueError("Selected encoding input is None")
        B, H, W, _ = x.shape
        E = self.num_encoders
        crop = CropParameters(W, H, E)
        h = crop.pad(self._input(x))
        states = list(states)
        new_states: List[LIFState] = list(states)
        taps = {"0:input": x.float()} if log else None
        si = 0
        blocks = []
        for i in range(E):
            z1, new_states[si] = self._lif(self._conv_ff(h, f"enc{i}_conv", 2), f"enc{i}_conv",
                                           states[si])
            cat = torch.cat([z1, states[si + 1].spk], dim=-1)
            h, new_states[si + 1] = self._lif(self._conv_ff(cat, f"enc{i}_rec"), f"enc{i}_rec",
                                              states[si + 1])
            si += 2
            blocks.append(h)
            if log:
                taps[f"enc{i}"] = h.float()
        for i in range(self.num_residual_blocks):
            residual = h
            z1, new_states[si] = self._lif(self._conv_ff(h, f"res{i}_0"), f"res{i}_0", states[si])
            z2, new_states[si + 1] = self._lif(self._conv_ff(z1, f"res{i}_1"), f"res{i}_1",
                                               states[si + 1])
            si += 2
            h = z2 + residual  # small integers, exact in either carrier
            if log:
                taps[f"res{i}"] = h.float()
        predictions = []
        pred_q = None
        npred = self.num_output_channels
        for i in range(E):
            skip = blocks[E - i - 1]
            if self.phase_decoders:
                z_ph, new_states[si] = self._phase_decoder(i, h, skip, pred_q, states[si])
                Bc, Hc, Wc, C4 = z_ph.shape
                cout = C4 // 4
                zf = z_ph.float().reshape(Bc, Hc, Wc, 4, cout)
                flow = _phase_interleave(self._flow(zf, i).reshape(Bc, Hc, Wc, 4 * npred), npred)
                if i < E - 1 or log:
                    h = _phase_interleave(z_ph, cout)
            else:
                parts = [h, skip] if i == 0 else [pred_q, h, skip]
                cat = torch.cat([p.float() for p in parts], dim=-1)
                up = F.interpolate(cat.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                                   align_corners=False).permute(0, 2, 3, 1)
                q_up = torch.clamp(torch.round(up / getattr(self, f"dec{i}_in_scale")),
                                   -127, 127).to(self._cdtype)
                h, new_states[si] = self._lif(self._conv_ff(q_up, f"dec{i}"), f"dec{i}",
                                              states[si])
                flow = self._flow(h, i)
            si += 1
            predictions.append(flow)
            pred_q = self._pred_q(flow)
            if log:
                taps[f"dec{i}"] = h.float()
        fh, fw = predictions[-1].shape[1:3]
        flows = [crop.crop(upsample_nearest(p, fh, fw)) for p in predictions]
        activity = activity_fractions(taps) if log else None
        return {"flow": flows, "activity": activity}, tuple(new_states)


def save_unet_engine(engine: Int8UNetEngine, path: str, serving=None) -> str:
    """Write the engine's canonical tensors and configuration as one
    ``.npz`` artifact in the reference's format (``evflow.deploy_unet
    .Int8UNetEngine.from_artifact`` reads it): keys ``enc/0/conv/w`` ...,
    weights int8 whatever the tier, every key's dtype in ``__meta__``
    (phase kernels are derived again at load). ``serving`` (a dict, or an
    object with ``to_meta()``) defaults to the engine's own."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            leaf = prefix.rsplit("/", 1)[-1]
            if leaf not in _CANONICAL:
                return
            v = tree.detach().cpu()
            if leaf == "w":
                dtypes[prefix] = "int8"
                arrays[prefix] = v.float().numpy().astype(np.int8)
                return
            dtypes[prefix] = str(v.dtype).replace("torch.", "")
            arrays[prefix] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()

    walk(engine.params, "")
    meta = {"dtypes": dtypes, "num_encoders": engine.num_encoders,
            "num_residual_blocks": engine.num_residual_blocks, "mem_dtype": engine.mem_dtype,
            "compute": engine.compute, "phase_decoders": engine.phase_decoders,
            "input_scale": engine.input_scale, "model": engine.model_name}
    if serving is None:
        serving = engine.serving
    if serving is not None:
        meta["serving"] = serving if isinstance(serving, dict) else serving.to_meta()
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)
    return path
