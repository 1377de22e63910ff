"""Carry a parameter tree across frameworks (no reference counterpart).

The JAX ``init_params`` tree, already turned into numpy arrays by the
caller (``jax.tree.map(np.asarray, params)``), becomes the port's
parameters. The port keeps the reference's tree and its ``[in, out]``
matmul layout (``x @ w``), so no leaf is transposed: each array is copied
as it is onto ``device`` in ``dtype``. A quantized tree
(``engine/quant.quantize_params``) carries its int8 leaves across as the
port's ``QTensor``: ``q`` stays int8, ``scale`` comes into ``dtype``.

``adamw_state_from_numpy`` carries the reference's ``optax.adamw`` state
across the same way, so a run trained in JAX resumes in the port's
``train.make_train_step`` with its moments and its bias-correction count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import QTensor


def _is_qtensor(tree) -> bool:
    """A quantized leaf of either framework, known by its fields (the
    port does not import the JAX package's type)."""
    return isinstance(tree, tuple) and getattr(tree, "_fields", None) == ("q", "scale")


def _tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind not in "fc":  # e.g. ml_dtypes bfloat16 arrives as kind 'V'
        arr = arr.astype(np.float32)
    # copy: arrays handed out by JAX are read-only, torch tensors are not
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(device=device, dtype=dtype)


def params_from_numpy(tree, device="cpu", dtype=torch.float32, mesh=None):
    """Nested dict/list/tuple of numpy arrays → the same structure of torch
    tensors on ``device`` in ``dtype``; a ``(q, scale)`` leaf → ``QTensor``
    with int8 ``q``. With ``mesh`` (a params tree), the per-shard trees of
    ``parallel/sharding.shard_params``, each on its shard's device."""
    if mesh is not None:
        from ..parallel.sharding import shard_params

        return shard_params(params_from_numpy(tree, device, dtype), mesh)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if _is_qtensor(tree):
        q = np.asarray(tree.q)
        if q.dtype != np.int8:
            raise ValueError(f"quantized leaf with q of dtype {q.dtype}, expected int8")
        return QTensor(
            q=torch.from_numpy(np.array(q, order="C", copy=True)).to(device),
            scale=_tensor(tree.scale, device, dtype),
        )
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return _tensor(tree, device, dtype)


def adamw_state_from_numpy(opt_state, params: dict) -> dict:
    """The reference's ``optax.adamw`` state, turned into numpy by the
    caller (``jax.tree.map(np.asarray, opt_state)``): the chain's tuple
    ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``,
    whose first member carries the step count and the moments. Returns
    ``{"step": count, "exp_avg": mu, "exp_avg_sq": nu}`` with the moments
    as f32 trees on the device of ``params`` (the port's tree the state
    belongs to, whose structure and shapes they must have), which
    ``train.make_train_step``'s ``init_fn(params=..., opt_state=...)``
    puts into ``torch.optim.AdamW``."""
    adam = opt_state[0]
    if not all(hasattr(adam, f) for f in ("count", "mu", "nu")):
        raise ValueError(f"expected optax's ScaleByAdamState first, got {type(adam).__name__}")
    device = _first_leaf(params).device
    mu = params_from_numpy(adam.mu, device, torch.float32)
    nu = params_from_numpy(adam.nu, device, torch.float32)
    for name, tree in (("mu", mu), ("nu", nu)):
        if _shapes(tree) != _shapes(params):
            raise ValueError(f"optax {name} does not have the params' tree")
    return {"step": int(np.asarray(adam.count)), "exp_avg": mu, "exp_avg_sq": nu}


def _first_leaf(tree) -> torch.Tensor:
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)
