"""GraphLab on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors ``repro``'s module names so each counterpart is easy
to find (``repro_torch.core.graph`` <-> ``repro.core.graph``, ...).  It
imports ``torch`` and ``numpy`` only — never ``jax`` and never ``repro``
— so it installs on a GPU host without JAX.  The one hot loop of the
main path, the sliced-ELL neighbour aggregation, is a hand-written CUDA
kernel (``kernels/csrc/ell_spmv.cu``) built with ``nvcc`` at first use.

Entry points (``api.run``, ``DataGraph.from_edges``, ``pagerank.build``)
put tensors on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise instead of running on the CPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
