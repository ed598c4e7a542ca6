"""Multi-process event-stream loader: slot-sharded worker processes (port
of ``evflow/data/mp_loader.py``).

The stream is stateful (one open file and cursor per batch slot), so
worker processes cannot share one stream; instead the batch slots are split
into contiguous groups, each owned by ONE worker process that streams its
own shard of the sequence files with a full ``H5EventStream`` (the host
library's one-pass assembly, the event cache, the lot). The data path then
scales with host cores instead of sharing one interpreter with the loop.

Contract, as in the reference package:

* worker ``w`` of ``W`` streams the file shard ``files[h*W + w :: S*W]``,
  ``(S, h)`` the enclosing shard (``loader.num_shards`` /
  ``loader.shard_index``, default 1 / 0; a data-parallel rank's, see
  ``evflow_torch.parallel.mesh.rank_config``), with ``B // W`` slots (the
  first ``B % W`` workers one more) and the seed ``loader.seed + w``;
* so each worker's stream is bit-equal to an in-process ``H5EventStream``
  over the same shard, and a batch is the workers' batches concatenated
  over the slot axis, the event lists re-padded to the widest worker's
  (``bucket_size`` of it outside ``events`` mode);
* ``epoch_done`` fires when every worker has finished its shard at least
  once since the last global epoch (the slowest shard's cadence);
* a worker that raises or dies raises in the parent within about a second;
* ``1 <= loader.num_workers <= loader.batch_size``, else ``ValueError``.

Workers are ``spawn`` processes that import numpy and the data modules,
never torch (``evflow_torch/__init__`` imports nothing eagerly), so no
worker can hold a CUDA context. The host library is built in the parent
before the workers start. A worker's batch crosses in one of its
shared-memory blocks (a ring of them, reused: a pipe would carry the
arrays in 64 KiB pieces), which the parent copies into the global batch;
a pipe carries the block's name and layout, and ``depth`` credits (a
semaphore the parent releases a batch) bound a worker's run-ahead.
"""

from __future__ import annotations

import copy
import ctypes
import multiprocessing as mp
import os
import time
import traceback
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional

import numpy as np

from evflow_torch.data.h5_stream import H5EventStream, bucket_size

__all__ = ["MPEventStream", "build_stream", "check_workers", "worker_configs"]

_PADDED = {"event_list": 4, "event_list_pol_mask": 2, "event_valid": None}
_GLOBAL = ("epoch_done", "seq_num", "file_names")


def check_workers(config: Dict[str, Any]) -> int:
    """``loader.num_workers`` (default 1); raises ``ValueError`` unless
    ``1 <= num_workers <= batch_size``."""
    loader = config["loader"]
    workers = int(loader.get("num_workers", 1))
    batch = int(loader.get("batch_size", 1))
    if not 1 <= workers <= batch:
        raise ValueError(f"loader.num_workers must be in [1, batch_size]: {workers} vs B={batch}")
    return workers


def _walk(path: str) -> List[str]:
    files = [os.path.join(root, f) for root, _dirs, names in os.walk(path)
             for f in sorted(names) if f.endswith((".h5", ".npz"))]
    if not files:
        raise FileNotFoundError(f"No .h5/.npz files under {path}")
    return files


def worker_configs(config: Dict[str, Any], files: Optional[List[str]] = None
                   ) -> List[Dict[str, Any]]:
    """Each worker's ``H5EventStream`` config: its slots, its file shard
    (``shard_index = h*W + w`` of ``num_shards = S*W``) and its seed
    (``seed + w``); ``files`` is the walk of ``data.path`` (walked if None).
    Raises ``ValueError`` for a worker whose shard holds no file."""
    W = check_workers(config)
    loader = config["loader"]
    S, h = int(loader.get("num_shards", 1)), int(loader.get("shard_index", 0))
    files = _walk(config["data"]["path"]) if files is None else files
    base, rem = divmod(int(loader.get("batch_size", 1)), W)
    out = []
    for w in range(W):
        if not files[h * W + w::S * W]:
            raise ValueError(f"worker {w} of shard {h}/{S} has no files "
                             f"({len(files)} files for {S * W} shards)")
        cfg = copy.deepcopy(config)
        cfg["loader"].update(batch_size=base + (w < rem), num_shards=S * W,
                             shard_index=h * W + w, seed=int(loader.get("seed", 0)) + w)
        cfg["loader"].pop("num_workers", None)
        out.append(cfg)
    return out


class _Packed:
    """A worker's batch in transit: the ring index and name of the
    shared-memory block holding its arrays, their layout, and the rest of
    the batch."""

    def __init__(self, index: int, name: str, layout: list, rest: Dict[str, Any]):
        self.index, self.name, self.layout, self.rest = index, name, layout, rest


class _Ring:
    """A worker's shared-memory blocks, written in turn: ``depth + 2`` of
    them, so that the parent has copied a block's batch out before the
    worker writes the block again (at most ``depth`` batches are in flight:
    the credits). Reused blocks stay mapped on both sides, so a batch costs a
    copy in and a copy out and no page faults; a block grows with its
    batch. The worker unlinks its blocks when it ends."""

    def __init__(self, depth: int):
        self.blocks: List[Optional[shared_memory.SharedMemory]] = [None] * (depth + 2)
        self.turn = 0

    def pack(self, batch: Dict[str, Any]) -> _Packed:
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        layout, size = [], 0
        for k, a in arrays.items():
            size = -(-size // 64) * 64
            layout.append((k, a.dtype.str, a.shape, size))
            size += a.nbytes
        i = self.turn
        self.turn = (i + 1) % len(self.blocks)
        block = self.blocks[i]
        if block is None or block.size < size:
            if block is not None:
                block.close()
                block.unlink()
            block = self.blocks[i] = shared_memory.SharedMemory(create=True, size=max(size, 1))
        for (_, dtype, shape, offset), a in zip(layout, arrays.values()):
            np.ndarray(shape, dtype, block.buf, offset)[...] = a
        return _Packed(i, block.name, layout,
                       {k: v for k, v in batch.items() if k not in arrays})

    def close(self):
        for block in self.blocks:
            if block is not None:
                block.close()
                block.unlink()


def _keep_heap():
    """Ask glibc to keep freed memory in the heap (no trimming, no mmap
    below 32 MiB). A fresh worker's heap is small, so each batch's arrays
    were returned to the system when freed and faulted in anew by the next
    batch: on a host where page faults are dear, that made a worker's
    ``next_batch`` ~3x slower than the same stream in a long-lived process
    (1.3-1.4 ms against 0.43-0.60 at B=4, on an NVIDIA H100 machine's
    host). Not glibc: nothing to do."""
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 32 << 20)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass


def _worker_main(w, cfg, num_bins, round_encoding, shuffle, depth, conn, credits, stop_evt):
    """A worker's body: its own ``H5EventStream`` over its file shard, each
    batch sent on ``conn`` for one of the ``depth`` ``credits`` (the parent
    returns one a batch it receives), until ``stop_evt``. A failure
    goes to the parent as a ``RuntimeError`` carrying the worker's
    traceback. The main thread writes to the pipe itself: a queue's feeder
    thread would wait for the interpreter lock up to a switch interval (5
    ms) while the stream assembles the next batch."""
    _keep_heap()
    stream, ring = None, _Ring(depth)
    try:
        stream = H5EventStream(cfg, num_bins, round_encoding)
        stream.shuffle(shuffle)
        while not stop_evt.is_set():
            item = ring.pack(stream.next_batch())
            while not stop_evt.is_set():
                if credits.acquire(timeout=0.1):
                    conn.send(item)
                    break
    except Exception:  # reported to the parent, which raises it
        conn.send(RuntimeError(f"loader worker {w} failed:\n{traceback.format_exc()}"))
    finally:
        conn.close()
        if stream is not None:
            stream.close()
        ring.close()


class MPEventStream:
    """``H5EventStream``'s surface (``batch_size``, ``files``, ``epoch``,
    ``samples``, ``seq_num``, ``encoder``, ``next_batch``, ``end_epoch``,
    ``shuffle``, ``close``) over ``loader.num_workers`` worker processes;
    the sharding contract is the module's. Workers start at the first
    ``next_batch``."""

    def __init__(self, config: Dict[str, Any], num_bins: int, round_encoding: bool = False,
                 depth: int = 2):
        self.num_workers = W = check_workers(config)
        loader = config["loader"]
        self.batch_size = int(loader.get("batch_size", 1))
        self.mode = config["data"]["mode"]
        self.depth = int(depth)
        files = _walk(config["data"]["path"])
        # the enclosing shard, for progress displays
        self.files = files[int(loader.get("shard_index", 0))::int(loader.get("num_shards", 1))]
        self._worker_cfgs = worker_configs(config, files)
        self.slot_counts = [c["loader"]["batch_size"] for c in self._worker_cfgs]

        self.encoder = "numpy"
        if bool(loader.get("native_encoder", True)):
            from evflow_torch.data import native

            native.build()  # once here, not once a worker
            self.encoder = "native_fused" if bool(loader.get("fused_assembly", True)) else "native"
        self._num_bins = num_bins
        self._round_encoding = round_encoding
        self._shuffle = False
        self._ctx = mp.get_context("spawn")
        self._procs: List[Any] = []
        self._conns: List[Any] = []  # a worker's pipe, read end
        self._credits: List[Any] = []  # a worker's batches that may be in flight
        self._blocks: List[Dict[int, shared_memory.SharedMemory]] = []  # a worker's, by ring index
        self._stop = None
        self._dead: Optional[BaseException] = None

        self.epoch = 0
        self.samples = 0
        self.seq_num = 0
        self._epoch_counts = [0] * W  # shard epochs each worker has finished
        self._epochs_emitted = 0

    @property
    def pids(self) -> List[int]:
        """The worker processes' ids (empty before the first batch)."""
        return [p.pid for p in self._procs]

    def _start(self):
        self._stop = self._ctx.Event()
        for w in range(self.num_workers):
            reader, writer = self._ctx.Pipe(duplex=False)
            credits = self._ctx.Semaphore(self.depth)
            p = self._ctx.Process(
                target=_worker_main, name=f"evflow-loader-{w}", daemon=True,
                args=(w, self._worker_cfgs[w], self._num_bins, self._round_encoding,
                      self._shuffle, self.depth, writer, credits, self._stop))
            p.start()
            writer.close()  # the worker holds the only write end: its exit ends the pipe
            self._conns.append(reader)
            self._credits.append(credits)
            self._procs.append(p)
            self._blocks.append({})

    def shuffle(self, flag: bool = True):
        """Shuffle each worker's file shard; before the first batch only."""
        if self._procs:
            raise RuntimeError("shuffle() must be called before streaming")
        self._shuffle = bool(flag)

    def _get(self, w: int):
        while self._dead is None:
            try:
                # a short poll, so that a worker that hangs after dying surfaces too
                if not self._conns[w].poll(1.0):
                    if not self._procs[w].is_alive():
                        raise EOFError
                    continue
                item = self._conns[w].recv()
            except (EOFError, OSError):  # the worker's end closed: it has ended
                self._procs[w].join(timeout=1.0)
                self._dead = RuntimeError(
                    f"worker {w} exited (code {self._procs[w].exitcode}) without a batch")
                break
            if isinstance(item, BaseException):
                self._dead = item
                raise item
            self._credits[w].release()
            return item
        raise RuntimeError(f"loader worker died: {self._dead}") from self._dead

    def next_batch(self) -> Dict[str, Any]:
        """One batch: the workers' batches concatenated over the slot axis,
        the event lists re-padded to the widest worker's."""
        if not self._procs:
            self._start()
        parts = [self._open(w, self._get(w)) for w in range(self.num_workers)]
        return self._assemble(parts)

    def _open(self, w: int, item: _Packed) -> Dict[str, Any]:
        """The worker's batch, its arrays views of the block (each block
        mapped once)."""
        block = self._blocks[w].get(item.index)
        if block is None or block.name != item.name:
            if block is not None:
                block.close()
            block = self._blocks[w][item.index] = shared_memory.SharedMemory(name=item.name)
        batch = dict(item.rest)
        for k, dtype, shape, offset in item.layout:
            batch[k] = np.ndarray(shape, dtype, block.buf, offset)
        return batch

    def _assemble(self, parts: List[Dict[str, Any]]) -> Dict[str, Any]:
        n_pad = max(p["event_list"].shape[1] for p in parts)
        if self.mode != "events":
            n_pad = bucket_size(n_pad)
        batch: Dict[str, Any] = {}
        for key, width in _PADDED.items():
            shape = (self.batch_size, n_pad) + ((width,) if width else ())
            buf = np.zeros(shape, np.float32)
            b0 = 0
            for p in parts:
                a = p[key]
                buf[b0:b0 + a.shape[0], :a.shape[1]] = a
                b0 += a.shape[0]
            batch[key] = buf
        for key in parts[0]:
            if key not in batch and key not in _GLOBAL:
                batch[key] = np.concatenate([p[key] for p in parts], axis=0)
        batch["file_names"] = [n for p in parts for n in p["file_names"]]
        for w, p in enumerate(parts):
            self._epoch_counts[w] += bool(p["epoch_done"])
        done = min(self._epoch_counts) > self._epochs_emitted
        if done:
            self._epochs_emitted = min(self._epoch_counts)
        batch["epoch_done"] = done
        self.seq_num = sum(int(p["seq_num"]) for p in parts)
        batch["seq_num"] = self.seq_num
        return batch

    def end_epoch(self):
        self.epoch += 1
        self.samples = 0

    def close(self):
        """Stop the workers and join them (a worker waits for a credit in
        0.1 s turns, and its small messages never fill the pipe), then
        terminate any that hangs; unmap the blocks."""
        if self._stop is not None:
            self._stop.set()
        deadline = time.monotonic() + 10.0
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.0))
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for conn in self._conns:
            conn.close()
        for blocks in self._blocks:
            for block in blocks.values():
                block.close()
        self._procs, self._conns, self._credits, self._blocks = [], [], [], []


def build_stream(config: Dict[str, Any], num_bins: int, round_encoding: bool = False):
    """``loader.num_workers > 1``: the multi-process ``MPEventStream``, else
    the in-process ``H5EventStream``."""
    if check_workers(config) > 1:
        return MPEventStream(config, num_bins, round_encoding)
    return H5EventStream(config, num_bins, round_encoding)
