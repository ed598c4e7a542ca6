"""Hopper counterparts of the TPU lowering probes under ``benchmarks/``.

Each module is one probe file's micro-kernels as CUDA C++ kernels under
``evflow_torch/csrc``, with a plain PyTorch version, a launch counter per
wrapper and a ``main()`` that prints the probe's measurements on the card:

* ``inkernel_dot``: ``benchmarks/probe_inkernel_dot.py`` and
  ``probe_inkernel_dot2.py``, the whole-network kernels' mma.sync mainloop on
  operands resident in shared memory
  (``python -m evflow_torch.probes.inkernel_dot``);
* ``staging``: ``benchmarks/probe_manual_dma.py``, ``probe_manual_dma2.py``
  and ``probe_layer_grid.py``, halo'd row windows and a layer loop staged
  from device memory with TMA bulk copies on an mbarrier
  (``python -m evflow_torch.probes.staging``).
"""
