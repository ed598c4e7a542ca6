"""ctypes binding of the port's host runtime (``evflow_torch/csrc/evflow_host.cpp``).

The library is built on first use with the host compiler (``$CXX``, else
``g++``; ``-O3 -fPIC -std=c++17 -shared``) into
``evflow_torch/_build/libevflow_host-<hash>.so``, the hash covering the
source and the flags, so an edited source is rebuilt. Each build writes a
temporary file named after its process and thread and moves it into place
with ``os.replace``, so processes that build at once (test workers) never
load a half-written library. A failed build raises ``RuntimeError`` with the
compiler's output: nothing falls back to numpy behind the caller's back
(the stream runs numpy only when ``loader.native_encoder`` is false).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["load", "library_path", "NativeEncoder", "lif_forward", "CXX_FLAGS"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "evflow_host.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_EMPTY_F32 = np.empty(0, np.float32)


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (set CXX or install g++): the host "
                           f"library is built from {SOURCE} at first use")
    return cxx


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libevflow_host-{h.hexdigest()[:12]}.so"


def build() -> float:
    """Compile the library if it is missing; returns the seconds it took
    (0.0 when it was there)."""
    import time

    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed ({proc.args[0]} exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, c_int = ctypes.c_int64, ctypes.c_int
    dbl_p = ctypes.POINTER(ctypes.c_double)
    lib.ev_count_encoding.argtypes = [_f32p, _f32p, _f32p, i64, i64, i64, _f32p]
    lib.ev_voxel_encoding.argtypes = [_f32p, _f32p, _f32p, _f32p, i64, i64, i64, i64,
                                      c_int, _f32p]
    lib.ev_mask_encoding.argtypes = [_f32p, _f32p, _f32p, i64, i64, i64, _f32p]
    lib.ev_image.argtypes = [_f32p, _f32p, _f32p, i64, i64, i64, _f32p]
    lib.ev_polarity_mask.argtypes = [_f32p, i64, _f32p]
    lib.lif_forward.argtypes = [_f32p, _f32p, _f32p, _f32p, i64, i64, _f32p, _f32p]
    lib.ev_normalize_ts.argtypes = [_f64p, i64]
    lib.ev_normalize_ts.restype = ctypes.c_double
    lib.ev_window_assemble.argtypes = [
        _f32p, _f32p, _f64p, _f32p, i64, i64, i64, i64,
        c_int, c_int, c_int, c_int, c_int,
        _f32p, _f32p, _f32p, _f32p, _f32p, dbl_p, dbl_p,
    ]
    lib.ev_window_assemble.restype = c_int
    return lib


def load() -> ctypes.CDLL:
    """The library, built first if needed. Raises ``RuntimeError`` when the
    build fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            _LIB = _bind(ctypes.CDLL(str(library_path())))
    return _LIB


def _c(a, dtype=np.float32):
    return np.ascontiguousarray(a, dtype=dtype)


class NativeEncoder:
    """The host event encodings in C++ (numpy arrays in and out), with the
    signatures of the reference package's ``NativeEncoder``."""

    def __init__(self):
        self.lib = load()

    def count_encoding(self, xs, ys, ps, sensor_size):
        H, W = int(sensor_size[0]), int(sensor_size[1])
        out = np.zeros((H, W, 2), np.float32)
        self.lib.ev_count_encoding(_c(xs), _c(ys), _c(ps), len(xs), H, W, out)
        return out

    def voxel_encoding(self, xs, ys, ts, ps, num_bins, sensor_size, round_ts=False):
        H, W = int(sensor_size[0]), int(sensor_size[1])
        out = np.zeros((H, W, num_bins), np.float32)
        self.lib.ev_voxel_encoding(_c(xs), _c(ys), _c(ts), _c(ps), len(xs), num_bins, H, W,
                                   int(round_ts), out)
        return out

    def mask_encoding(self, xs, ys, ps, sensor_size):
        H, W = int(sensor_size[0]), int(sensor_size[1])
        out = np.zeros((H, W), np.float32)
        self.lib.ev_mask_encoding(_c(xs), _c(ys), _c(ps), len(xs), H, W, out)
        return out[..., None]

    def image(self, xs, ys, vals, sensor_size):
        H, W = int(sensor_size[0]), int(sensor_size[1])
        out = np.zeros((H, W), np.float32)
        self.lib.ev_image(_c(xs), _c(ys), _c(vals), len(xs), H, W, out)
        return out

    def polarity_mask(self, ps):
        out = np.zeros((len(ps), 2), np.float32)
        self.lib.ev_polarity_mask(_c(ps), len(ps), out)
        return out

    def normalize_ts(self, ts):
        ts = np.ascontiguousarray(ts, np.float64)
        rng = self.lib.ev_normalize_ts(ts, len(ts))
        return ts, float(rng)

    def window_assemble(self, xs, ys, ts, ps, sensor_size, num_bins, flip_h=False,
                        flip_v=False, flip_p=False, build_voxel=True, round_ts=False):
        """One window in one pass: polarity to +-1 (when none is negative),
        min-max normalised timestamps, flip augmentation and every encoding.

        Returns ``(cnt [H,W,2], mask [H,W,1], voxel [H,W,bins] or None,
        event_list [n,4] (ts, y, x, p), pol_mask [n,2], dt_input, last_ts)``;
        raises ``ValueError`` on a non-finite timestamp.
        """
        H, W = int(sensor_size[0]), int(sensor_size[1])
        n = len(xs)
        cnt = np.empty((H, W, 2), np.float32)
        mask = np.empty((H, W, 1), np.float32)
        voxel = np.empty((H, W, num_bins), np.float32) if build_voxel else _EMPTY_F32
        event_list = np.empty((n, 4), np.float32)
        pol_mask = np.empty((n, 2), np.float32)
        dt, last_ts = ctypes.c_double(), ctypes.c_double()
        rc = self.lib.ev_window_assemble(
            _c(xs), _c(ys), np.ascontiguousarray(ts, np.float64), _c(ps), n, H, W, num_bins,
            int(flip_h), int(flip_v), int(flip_p), int(build_voxel), int(round_ts),
            cnt, mask, voxel, event_list if n else _EMPTY_F32, pol_mask if n else _EMPTY_F32,
            ctypes.byref(dt), ctypes.byref(last_ts))
        if rc != 0:
            raise ValueError("NaN/Inf event timestamps")
        return (cnt, mask, voxel if build_voxel else None, event_list, pol_mask,
                float(dt.value), float(last_ts.value))


def lif_forward(x, mem, beta, theta):
    """The deployment LIF on NHWC arrays with per-channel ``beta``/``theta``:
    ``u = beta mem + x``, ``spike = u >= theta``, ``mem' = 0`` where it
    spiked, else ``u``. Returns ``(spike, mem')``."""
    lib = load()
    x = _c(x)
    C = x.shape[-1]
    spike = np.zeros_like(x)
    mem_out = np.zeros_like(x)
    lib.lif_forward(x, _c(mem), _c(beta), _c(theta), x.size // C, C, spike, mem_out)
    return spike, mem_out
