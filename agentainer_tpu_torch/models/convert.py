"""Carry a parameter tree across frameworks (no reference counterpart).

The JAX ``init_params`` tree, already turned into numpy arrays by the
caller (``jax.tree.map(np.asarray, params)``), becomes the port's
parameters. The port keeps the reference's tree and its ``[in, out]``
matmul layout (``x @ w``), so no leaf is transposed: each array is copied
as it is onto ``device`` in ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    """Nested dict/list/tuple of numpy arrays → the same structure of torch
    tensors on ``device`` in ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind not in "fc":  # e.g. ml_dtypes bfloat16 arrives as kind 'V'
        arr = arr.astype(np.float32)
    # copy: arrays handed out by JAX are read-only, torch tensors are not
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(device=device, dtype=dtype)
