"""agentainer_tpu_torch — the PyTorch/CUDA port of ``agentainer_tpu``.

Reference: ``agentainer_tpu/__init__.py``. The JAX package stays the
behavioural reference; this package mirrors its layout module for module
(``agentainer_tpu_torch/ops/attention.py`` replaces
``agentainer_tpu/ops/attention.py``, and so on) and runs on one NVIDIA H100.

What is ported so far is the dense, single-device main path of the ``llm``
engine: model config registry, the Llama forward pass, sampling, the
continuous-batching engine and its HTTP serve layer. The two Pallas
flash-attention kernels on that path are hand-written CUDA C++ for Hopper
(``csrc/flash_attention.cu``), each with a plain PyTorch version beside it.

The port imports ``torch``, ``numpy`` and the standard library only — never
``jax`` and never ``agentainer_tpu``; where it needs code that lives in the
JAX package it keeps its own copy.
"""

__version__ = "0.1.0"
