"""Build and load the port's hand-written CUDA kernels.

Each ``evflow_torch/csrc/<name>.cu`` is compiled on first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface,
``evflow_torch/_build/lib<name>-<hash>.so`` (the hash covers the source and
the headers it includes, so an edited source is rebuilt), and loaded with
``ctypes``. Nothing here runs at import time. A build failure raises; there
is no fallback.

``build()`` compiles every missing library at once, one ``nvcc`` process per
source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["SOURCES", "SIGNATURES", "ENTRY_SOURCES", "build", "entry_point", "nvcc_path",
           "BUILD_DIR", "ptxas_functions", "kernel_name", "ptxas_kernels"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("conv_lif", "conv_lif_cmajor", "fused_net", "fused_net_loop", "fused_net_loop2",
           "fused_net_lgrid", "fused_net_batch", "probe_inkernel_dot", "probe_staging",
           "probe_unit_loop", "probe_loop_dyn", "probe_mosaic_ops", "probe_wholenet_bisect")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_ENTRIES: Dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from evflow_torch/csrc at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile the libraries that are missing, in parallel.

    Returns the seconds each compile took (0.0 for one already built). The
    ptxas register/shared-memory report of each compile is kept next to the
    library as ``<name>.ptxas.txt``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")


def ptxas_functions(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (its mangled name) in an ``nvcc -Xptxas -v`` log: the
    registers it uses and its stack frame, spill store and spill load
    bytes."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "stack": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def kernel_name(mangled: str) -> str:
    """A kernel's name without its namespaces and parameter types, with its
    integer and bool template arguments:
    ``_ZN6evflow5probe12probe_kernelILi32ELi0ELb1ELb0EEEvNS0_9ProbeArgsE``
    -> ``probe_kernel<32,0,1,0>``. A name that is not mangled stays as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():  # <length><identifier> ...
        m = re.match(r"\d+", mangled[pos:])
        n, pos = int(m.group()), pos + m.end()
        name, pos = mangled[pos:pos + n], pos + n
    args = re.match(r"I((?:L[a-z]n?\d+E)+)E", mangled[pos:])
    if args is None:
        return name
    values = re.findall(r"L[a-z](n?\d+)E", args.group(1))
    return f"{name}<{','.join(v.replace('n', '-') for v in values)}>"


def ptxas_kernels(expected: Dict[str, Sequence[str]],
                  build_dir: Path = BUILD_DIR) -> Tuple[Dict[str, Dict[str, int]], list]:
    """The ptxas rows (``ptxas_functions``) of the kernels ``expected``
    names per source, as ``kernel_name`` writes them, read from the sources'
    ``<source>.ptxas.txt`` logs; and the expected names that no log reports
    (a missing log, a renamed kernel, an instantiation gone)."""
    rows: Dict[str, Dict[str, int]] = {}
    missing = []
    for source, names in expected.items():
        log = build_dir / f"{source}.ptxas.txt"
        found = ({kernel_name(fn): r for fn, r in ptxas_functions(log.read_text()).items()}
                 if log.exists() else {})
        for name in names:
            if name in found:
                rows[name] = found[name]
            else:
                missing.append(name)
    return rows, missing


_CONV_LIF_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# the whole-network kernels take one pointer to a ``WholeNetArgs`` struct
# (``csrc/fused_net_common.cuh``, mirrored by ``ops/fused_net.py``) and the
# stream; the probes their own structs (``probes/inkernel_dot.py``,
# ``probes/staging.py``, ``probes/unit_loop.py``, ``probes/loop_dyn.py``,
# ``probes/mosaic_ops.py``, ``probes/wholenet_bisect.py``)
_STRUCT_ARGS = [ctypes.c_void_p, ctypes.c_void_p]
SIGNATURES = {
    "conv_lif": _CONV_LIF_ARGS,
    "conv_lif_cmajor": _CONV_LIF_ARGS,
    "fused_net": _STRUCT_ARGS,
    "fused_net_loop": _STRUCT_ARGS,
    "fused_net_loop2": _STRUCT_ARGS,
    "fused_net_lgrid": _STRUCT_ARGS,
    "fused_net_batch": _STRUCT_ARGS,
    "probe_inkernel_dot": _STRUCT_ARGS,
    "probe_row_window": _STRUCT_ARGS,
    "probe_layer_grid": _STRUCT_ARGS,
    "probe_unit_loop": _STRUCT_ARGS,
    "probe_loop_dyn": _STRUCT_ARGS,
    "probe_mosaic_ops": _STRUCT_ARGS,
    "probe_wholenet_bisect": _STRUCT_ARGS,
}
# entry points whose source is named otherwise (the rest live in ``<name>.cu``)
ENTRY_SOURCES = {"probe_row_window": "probe_staging", "probe_layer_grid": "probe_staging"}


def entry_point(name: str):
    """The C entry point ``name`` of ``csrc/<name>.cu`` (or of the source
    ``ENTRY_SOURCES`` names), building and loading the library on first use.

    Its argument types come from ``SIGNATURES``: the conv+LIF kernels take
    nine pointers, seven ints and the stream; the whole-network kernels a
    struct pointer and the stream. Every entry point returns the launch's
    ``cudaError_t``.
    """
    with _LOCK:
        fn = _ENTRIES.get(name)
        if fn is None:
            source = ENTRY_SOURCES.get(name, name)
            build([source])
            fn = getattr(ctypes.CDLL(str(_lib_path(source))), name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _ENTRIES[name] = fn
        return fn
