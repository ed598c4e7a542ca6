"""Each ctypes mirror of a kernel's argument struct against the struct in
its CUDA source: the same fields, in the same order, of the same C types
(a pointer of any type as ``c_void_p``, an array of ``N`` elements as
``type * N``). A field added, dropped or moved on one side only would
hand the kernel garbage: the card tests would fail, this test names it on
the CPU."""

import ctypes
import re
from pathlib import Path

import pytest

from evflow_torch.ops import fused_net
from evflow_torch.probes import (inkernel_dot, loop_dyn, mosaic_ops, staging, unit_loop,
                                 wholenet_bisect)

CSRC = Path(__file__).resolve().parents[1] / "evflow_torch" / "csrc"
SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}

MIRRORS = [
    (inkernel_dot.ProbeArgs, "probe_inkernel_dot.cu"),
    (loop_dyn.LoopDynArgs, "probe_loop_dyn.cu"),
    (mosaic_ops.MosaicArgs, "probe_mosaic_ops.cu"),
    (staging.RowWindowArgs, "probe_staging.cu"),
    (staging.LayerGridArgs, "probe_staging.cu"),
    (unit_loop.UnitLoopArgs, "probe_unit_loop.cu"),
    (wholenet_bisect.BisectArgs, "probe_wholenet_bisect.cu"),
    (fused_net.WholeNetArgs, "fused_net_common.cuh"),
]


def c_fields(source: str, struct: str):
    """``[(name, ctypes type)]`` of ``struct`` as the source declares it."""
    text = (CSRC / source).read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        head, *rest = decl.split(",")
        ptr = "*" in head
        base, first = head.rsplit("*", 1) if ptr else head.rsplit(None, 1)
        for name in (n.strip() for n in [first, *rest]):
            ctype = ctypes.c_void_p if ptr else SCALARS[base.replace("const", "").strip()]
            count = re.search(r"\[(\w+)\]", name)
            if count:
                n = count.group(1)
                if not n.isdigit():
                    n = re.search(r"constexpr int %s = (\d+);" % n, text).group(1)
                ctype = ctype * int(n)
            fields.append((name.split("[")[0], ctype))
    return fields


def kind(ctype):
    """A ctypes type by what it lays out: scalar types by size and kind,
    arrays by element and length."""
    if hasattr(ctype, "_length_"):
        return (kind(ctype._type_), ctype._length_)
    return (ctypes.sizeof(ctype), ctype in (ctypes.c_float, ctypes.c_double))


@pytest.mark.parametrize("mirror,source", MIRRORS, ids=lambda v: getattr(v, "__name__", v))
def test_ctypes_mirror_matches_the_source(mirror, source):
    c = c_fields(source, mirror.__name__)
    py = list(mirror._fields_)
    assert [n for n, _ in py] == [n for n, _ in c]
    assert [kind(t) for _, t in py] == [kind(t) for _, t in c]
