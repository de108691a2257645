"""GraphLab on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors ``repro``'s module names so each counterpart is easy
to find (``repro_torch.core.graph`` <-> ``repro.core.graph``, ...).  It
imports ``torch`` and ``numpy`` only — never ``jax`` and never ``repro``
— so it installs on a GPU host without JAX.  The hot loops of the
ported paths are hand-written CUDA kernels built with ``nvcc`` at first
use: the sliced-ELL neighbour aggregation of PageRank
(``kernels/csrc/ell_spmv.cu``), ALS's normal equations
(``kernels/csrc/als_normal_eq.cu``) and the decode attention of LLM
serving (``kernels/csrc/window_attention.cu``).

Entry points (``api.run``, ``DataGraph.from_edges``, ``pagerank.build``,
``als.synthetic_netflix``, ``models.model.init_params``,
``serve.engine.init_cache``, ``interop.params_from_arrays``,
``launch.serve``, ``api.serve``, ``launch.graph_serve``) put tensors on
``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise instead
of running on the CPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
