"""K windows as one dispatch (the port's counterpart of ``jit(lax.scan)`` in
``evflow/eval.py::make_chunk_eval_step``).

``ChunkProgram(body, device, counted)`` runs ``body(inputs, carry) ->
(outputs, carry')`` over a chunk: ``inputs`` a dict of ``[K, ...]`` tensors,
``carry`` a list of tensors (the model's states, and whatever else rolls
over from one chunk to the next). A call is split in two, so that a caller
can time each part: ``stage`` takes the chunk's host arrays and the carry,
``run`` dispatches. A carry entry may be None (a state with no tensor in
that slot, like the int8 engine's feedforward spike carries): it stays None
through every chunk.

On a CUDA device the first chunk of each input signature (names, shapes,
dtypes) runs ``body`` eagerly on static device buffers. That is real work
on the chunk's data, and it builds the kernels and sets their attributes
before a capture. Then ``body`` is captured into a CUDA graph, whose last
ops ``copy_`` the new carry into the static carry buffers. Later chunks
copy their inputs into the static buffers (through pinned staging buffers,
two per input, in turns) and replay the graph: one dispatch. A capture
that fails raises; nothing falls back to eager calls. On the CPU every
chunk runs ``body`` eagerly: the same chunk logic, as the tests run it.

The launch counters of ``counted`` (the kernel wrappers, each with a
``launches`` attribute) count kernels that ran: a capture launches nothing
and leaves them as they were, and each replay adds the launches that the
capture recorded.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ChunkProgram", "copy_carry"]

Body = Callable[[Dict[str, torch.Tensor], List[torch.Tensor]],
                Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]]


class _Graph:
    """Static buffers, pinned staging and the captured graph of one input
    signature."""

    def __init__(self, inputs: Dict[str, Sequence[np.ndarray]],
                 carry: Sequence[torch.Tensor], device: torch.device):
        self.static_in = {k: torch.empty((len(v),) + v[0].shape,
                                         dtype=torch.from_numpy(v[0][:0]).dtype, device=device)
                          for k, v in inputs.items()}
        self.staging = [{k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for k, t in self.static_in.items()} for _ in range(2)]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0
        self.static_carry = [None if c is None else torch.empty_like(c) for c in carry]
        self.graph = None
        self.static_out: Dict[str, torch.Tensor] = {}
        self.delta: List[int] = []

    def stage(self, inputs, carry):
        s = self.turn
        self.turn ^= 1
        self.copied[s].synchronize()  # the copy that last read this staging slot
        for k, arrs in inputs.items():
            np.stack(arrs, out=self.staging[s][k].numpy())
            self.static_in[k].copy_(self.staging[s][k], non_blocking=True)
        self.copied[s].record()
        copy_carry(self.static_carry, carry)


def copy_carry(dst: Sequence, src: Sequence):
    """``copy_`` each tensor of ``src`` into its slot of ``dst``; None slots
    (and a slot that already holds the same tensor) are left as they are."""
    for d, s in zip(dst, src):
        if d is not None and d is not s:
            d.copy_(s)


class ChunkProgram:
    """``body`` over chunks of windows: one CUDA-graph replay a chunk on a
    CUDA device, an eager call on the CPU."""

    def __init__(self, body: Body, device: torch.device, counted: Sequence = ()):
        self.body = body
        self.device = torch.device(device)
        self.counted = tuple(counted)
        self.graphs: Dict[tuple, _Graph] = {}
        self._staged = None
        self.captured = False  # whether the last run captured a graph

    def stage(self, inputs: Dict[str, Sequence[np.ndarray]], carry: Sequence[torch.Tensor]):
        """Upload a chunk: ``inputs`` maps each name to the K windows' host
        arrays (one shape and dtype per name); ``carry`` is the carry going
        in."""
        if self.device.type != "cuda":
            x = {k: torch.from_numpy(np.stack(v)).to(self.device) for k, v in inputs.items()}
            self._staged = (None, x, list(carry))
            return
        key = (tuple((k, len(v), v[0].shape, v[0].dtype.str) for k, v in sorted(inputs.items()))
               + tuple(None if c is None else (tuple(c.shape), c.dtype) for c in carry))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = _Graph(inputs, carry, self.device)
        g.stage(inputs, carry)
        self._staged = (g, None, None)

    def run(self) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """Dispatch the staged chunk; returns ``(outputs, carry)``. On a
        CUDA device both are static buffers, valid until the next run."""
        g, x, carry = self._staged
        self._staged = None
        self.captured = False
        if g is None:
            return self.body(x, carry)
        if g.graph is not None:
            g.graph.replay()
            for w, d in zip(self.counted, g.delta):
                w.launches += d
            return g.static_out, g.static_carry
        out, new = self.body(g.static_in, g.static_carry)
        copy_carry(g.static_carry, new)
        self._capture(g)
        self.captured = True
        return out, g.static_carry

    def _capture(self, g: _Graph):
        before = [w.launches for w in self.counted]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out, new = self.body(g.static_in, g.static_carry)
                copy_carry(g.static_carry, new)
        except Exception as e:
            raise RuntimeError(f"a chunk of {len(next(iter(g.static_in.values())))} windows "
                               f"could not be captured as one CUDA graph: {e}") from e
        finally:
            g.delta = [w.launches - b for w, b in zip(self.counted, before)]
            for w, b in zip(self.counted, before):
                w.launches = b
        g.graph, g.static_out = graph, out
