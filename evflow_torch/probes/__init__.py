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
  (``python -m evflow_torch.probes.staging``);
* ``unit_loop``: ``benchmarks/probe_loop_dyn4.py`` and ``probe_loop_dyn5.py``,
  one conv+LIF unit as the body of a runtime layer loop, its membrane,
  weights and spike slots staged per layer with TMA tensor copies
  (``python -m evflow_torch.probes.unit_loop``);
* ``loop_dyn``: ``benchmarks/probe_loop_dyn.py``, ``probe_loop_dyn2.py`` and
  ``probe_loop_dyn3.py``, a runtime layer loop reading and writing a
  shared-memory scratch at the runtime layer index: load-sums, stores, a
  TMA bulk store (whole layers or a row window), dots, a narrow load and a
  SAME conv (``python -m evflow_torch.probes.loop_dyn``);
* ``mosaic_ops``: ``benchmarks/probe_mosaic_ops.py``, a bf16 block rolled
  along both axes and added, added to its masked self, and a dot of a 3-D
  operand (``python -m evflow_torch.probes.mosaic_ops``).
* ``wholenet_bisect``: ``benchmarks/probe_wholenet_bisect.py``,
  ``probe_wholenet_bisect3.py``, ``bisect5.py`` and ``bisect6.py``, one
  conv, seven chained convs and two chained conv+LIF units in nine
  variants over a row window whose rows outside the image are read as
  they are (``python -m evflow_torch.probes.wholenet_bisect``).

Beside them, ``protocol_host`` times the protocol's host work and
``train_step`` holds and measures the training step on the card
(``python -m evflow_torch.probes.train_step``); neither has a kernel.
"""
