"""agentainer_tpu_torch — the PyTorch/CUDA port of ``agentainer_tpu``.

Reference: ``agentainer_tpu/__init__.py``. The JAX package stays the
behavioural reference; this package mirrors its layout module for module
(``agentainer_tpu_torch/ops/attention.py`` replaces
``agentainer_tpu/ops/attention.py``, and so on) and runs on one NVIDIA H100.

Ported so far: the single-device ``llm`` engine (model configs, the Llama
and MoE forward, sampling, the continuous-batching engine, its HTTP serve
layer, the training step), whose four Pallas flash-attention kernels and
int8 products are hand-written CUDA C++ for Hopper (``csrc/``), each with a
plain PyTorch version beside it; and the control plane (``daemon.py``,
``server/``, ``manager/``, ``runtime/``, ``store/``, the ``echo`` engine).

The port imports ``torch``, ``numpy`` and the standard library only — never
``jax`` and never ``agentainer_tpu``; where it needs code that lives in the
JAX package it keeps its own copy. The control plane imports the standard
library only, so the daemon never creates a CUDA context.
"""

__version__ = "0.1.0"
