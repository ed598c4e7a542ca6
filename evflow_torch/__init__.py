"""evflow_torch — the PyTorch/CUDA port of evflow for NVIDIA Hopper.

Mirrors ``evflow``'s module layout (``ops``, ``models``, ``data``, ``loss``,
``registry``, ``config``, ``eval``, ``train``, ``parallel``, ``utils``) so
each counterpart is easy to find; ``evflow`` stays the reference.
``eval_flow``, ``train_flow`` and ``train_flow_validation`` are the
counterparts of its CLIs, run as ``python -m evflow_torch.<cli>``. The package
imports ``torch`` and ``numpy``, and ``h5py``, ``yaml`` and ``matplotlib``
only where a call needs them; importing the package itself imports nothing
(the loader's worker processes import the data modules alone, without
torch). The kernels that ``evflow`` wrote in Pallas for the TPU are
hand-written CUDA C++ under ``csrc/``, built at first use (see
``evflow_torch.ops.cuda_build``); each has a plain PyTorch version beside
it that CPU tensors run.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from evflow_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'evflow_torch' has no attribute {name!r}")
