"""Data parallelism over ``torch.distributed`` ranks (port of
``evflow/parallel/mesh.py``).

One process a device. Rank ``k`` of ``D`` owns the batch slots
``k*B/D .. (k+1)*B/D`` (``mesh.py:9-11`` of the reference package): its
config is its shard of the global one (``rank_config``: ``B/D`` slots, the
file shard ``h*D + k`` of ``S*D``), so a rank streams its own sequences,
as the reference's multi-process topology does. Parameters are replicated:
every rank builds the model from one seed, and the trainer sums the
gradients over the ranks (the loss is a sum over slots) before its clip.

A ``Mesh`` holds the rank, the world size, the rank's device and two
process groups: ``group`` for the device's tensors (NCCL on CUDA, one card a
rank; gloo on the CPU, or on CUDA when asked for, which lets several ranks
share one card: NCCL refuses that) and ``host_group``, always gloo, for the
host's bookkeeping (the trainer's per-batch flags, gathering results), so
that none of it waits on the device. A mesh of one device built without an
address has no process group: the callers run their single-process path.
Given an address (``launch`` gives one), it joins a group of one, and the
callers run the data-parallel path with every collective over that group:
one card runs the NCCL path so.

``launch(fn, num_devices, ...)`` spawns the ranks on this host
(``torch.multiprocessing``, ``spawn``), each joining the group at a free
local port, and returns each rank's ``fn(mesh, *args)`` in rank order; a
rank that raises raises in the caller (the others are stopped). Nothing
carries on with fewer ranks: too few cards, a world size that does not
divide the batch or a rank that fails all raise.
"""

from __future__ import annotations

import copy
import datetime
import os
import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "check_mesh", "check_batch", "launch", "rank_config", "rank_device",
           "pad_batch_to_devices", "all_reduce_sum"]

_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class Mesh:
    """One rank's view of a 1-D data mesh."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any = None
    host_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.size > 1 or self.group is not None

    def host_max(self, values: Sequence[int]) -> List[int]:
        """The element-wise maximum of ``values`` over the ranks (host
        integers, through the gloo group)."""
        t = torch.tensor(list(values), dtype=torch.int64)
        if self.distributed:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return t.tolist()

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        if not self.distributed:
            return [obj]
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def close(self):
        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()


def check_mesh(num_devices: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None,
               backend: Optional[str] = None) -> tuple:
    """``(num_devices, device type, backend)`` resolved and checked:
    ``num_devices`` None means every visible card on CUDA (at least one) and
    1 on the CPU; the backend defaults to NCCL on CUDA and gloo on the CPU.
    Raises ``ValueError`` when NCCL is asked for on the CPU, or when a mesh
    of more than one device finds fewer cards than NCCL's one a rank (gloo
    ranks share the cards there are). A mesh of one checks nothing more:
    its device resolves as a single process's does."""
    kind = torch.device("cuda" if device is None else device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {kind!r}")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    if num_devices is None:
        num_devices = max(cards, 1)
    num_devices = int(num_devices)
    if num_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {num_devices}")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("the NCCL backend runs on CUDA devices; the CPU takes gloo")
    needed = num_devices if backend == "nccl" else 1
    if num_devices > 1 and kind == "cuda" and cards < needed:
        raise ValueError(f"requested a {num_devices}-device {backend} mesh but torch reports "
                         f"{cards} CUDA device(s)")
    return num_devices, kind, backend


def make_mesh(num_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None, backend: Optional[str] = None,
              rank: int = 0, init_method: Optional[str] = None) -> Mesh:
    """This process's rank of a ``num_devices`` mesh (see ``check_mesh``
    for the defaults and refusals). Rank ``r`` runs on ``cuda:r`` under
    NCCL, on ``cuda:(r % cards)`` under gloo, or on the CPU. A mesh of
    more than one device, or of one given ``init_method``, joins the process
    group there (as ``launch`` gives it) and adds the gloo group for the
    host."""
    n, kind, backend = check_mesh(num_devices, device, backend)
    if kind == "cuda":
        from evflow_torch.device import resolve_device

        dev = resolve_device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if n == 1 and init_method is None:
        return Mesh(1, 0, dev, backend)
    if init_method is None:
        raise ValueError("a mesh of more than one device needs the process group's address "
                         "(launch() gives each rank its own)")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n}")
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                            timeout=_TIMEOUT)
    group = dist.group.WORLD
    host = group if backend == "gloo" else dist.new_group(backend="gloo", timeout=_TIMEOUT)
    return Mesh(n, rank, dev, backend, group, host)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, device, backend, init_method, args, out_q):
    # every rank is on this host: the groups' sockets stay on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = make_mesh(n, device, backend, rank=rank, init_method=init_method)
    try:
        out_q.put((rank, fn(mesh, *args)))
    finally:
        mesh.close()


def launch(fn: Callable, num_devices: Optional[int] = None,
           device: Optional[Union[str, torch.device]] = None, backend: Optional[str] = None,
           args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a ``num_devices`` mesh (one
    spawned process a rank, ``fn`` picklable, a process group even for one
    rank) and return the ranks' results in rank order (picklable; tensors
    go as numpy)."""
    n, kind, backend = check_mesh(num_devices, device, backend)
    import torch.multiprocessing as tmp

    out_q = tmp.get_context("spawn").SimpleQueue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    ctx = tmp.start_processes(_rank_main, args=(fn, n, kind, backend, init, tuple(args), out_q),
                              nprocs=n, join=False, start_method="spawn")
    results: Dict[int, Any] = {}
    done = False
    while not done:
        done = ctx.join(timeout=0.05)  # raises if a rank raised, stopping the others
        while not out_q.empty():  # read as they come: a full pipe would block a rank
            rank, out = out_q.get()
            results[rank] = out
    if sorted(results) != list(range(n)):
        raise RuntimeError(f"ranks {sorted(set(range(n)) - set(results))} returned nothing")
    return [results[r] for r in range(n)]


def check_batch(config: Dict[str, Any], num_devices: int) -> int:
    """``loader.batch_size``; raises ``ValueError`` unless ``num_devices``
    divides it."""
    B = int(config["loader"].get("batch_size", 1))
    if B % num_devices:
        raise ValueError(f"batch_size {B} must be divisible by the mesh size {num_devices}")
    return B


def rank_config(config: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The rank's shard of ``config``: ``loader.batch_size = B / D`` and the
    file shard ``h*D + k`` of ``S*D`` (``S``, ``h`` the config's own
    ``num_shards`` / ``shard_index``, default 1 / 0). Raises ``ValueError``
    unless ``D`` divides ``B``."""
    loader = config["loader"]
    B, D = check_batch(config, mesh.size), mesh.size
    if D == 1:
        return config
    cfg = copy.deepcopy(config)
    S, h = int(loader.get("num_shards", 1)), int(loader.get("shard_index", 0))
    cfg["loader"].update(batch_size=B // D, num_shards=S * D, shard_index=h * D + mesh.rank)
    return cfg


def rank_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """The mesh rank's device (a ``device`` given must name it), or without
    a mesh ``device`` resolved (``evflow_torch.device.resolve_device``)."""
    from evflow_torch.device import resolve_device

    if mesh is None:
        return resolve_device(device)
    asked = torch.device(device) if device is not None else mesh.device
    if asked.type != mesh.device.type or asked.index not in (None, mesh.device.index):
        raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
    return mesh.device


def pad_batch_to_devices(batch_size: int, num_devices: int) -> int:
    """The smallest batch >= ``batch_size`` that the device count divides."""
    return ((batch_size + num_devices - 1) // num_devices) * num_devices


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its gradient is the sum of the ranks' gradients
    (each rank's loss reads the global sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)
