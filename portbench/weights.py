"""The weights of a cell, made by the benchmark on the device from the
run's seed: one ``torch.Generator`` on the device and one fill per leaf,
in the type they are served in. The same tensors go to the program (as its
parameter tree, ``core.program_params``) and to the plain reference.

bf16 leaves are normal with std 0.02 (the published initializer range);
an int8 leaf is ``{"q": int8 uniform in [-127, 127], "scale": bf16
[.., 1, out]}`` with column scales uniform in ±25% around the one that
gives a std of 0.02. Norm weights are ones. Tree and layout are the
published model's, matrices stored ``[in, out]``: ``embed [V, D]``,
``lm_head [D, V]``, ``final_norm [D]`` and per layer (leading ``[L]``)
``attn_norm``, ``mlp_norm``, ``wq``, ``wk``, ``wv``, ``wo`` and the FFN:
``w_gate``/``w_up [D, F]``, ``w_down [F, D]``, or with experts ``router
[D, E]`` and ``w_gate``/``w_up [E, D, F]``, ``w_down [E, F, D]``."""

from __future__ import annotations

import torch

STD = 0.02
INT8_STD = 73.33  # std of a uniform integer in [-127, 127]


def shapes_of_leaves(s) -> dict:
    hd, L = s.head_dim, s.n_layers
    layer = {
        "wq": (L, s.dim, s.n_heads * hd),
        "wk": (L, s.dim, s.n_kv_heads * hd),
        "wv": (L, s.dim, s.n_kv_heads * hd),
        "wo": (L, s.n_heads * hd, s.dim),
    }
    if s.is_moe:
        e = s.n_experts
        layer.update({
            "router": (L, s.dim, e),
            "w_gate": (L, e, s.dim, s.ffn_dim),
            "w_up": (L, e, s.dim, s.ffn_dim),
            "w_down": (L, e, s.ffn_dim, s.dim),
        })
    else:
        layer.update({"w_gate": (L, s.dim, s.ffn_dim), "w_up": (L, s.dim, s.ffn_dim), "w_down": (L, s.ffn_dim, s.dim)})
    return {"embed": (s.vocab, s.dim), "lm_head": (s.dim, s.vocab), "layers": layer}


def _leaf(shape, int8: bool, device, dtype):
    if not int8:
        return torch.empty(shape, dtype=dtype, device=device)
    return {
        "q": torch.empty(shape, dtype=torch.int8, device=device),
        "scale": torch.empty(shape[:-2] + (1,) + shape[-1:], dtype=dtype, device=device),
    }


def _fill(leaf, gen: torch.Generator) -> None:
    if isinstance(leaf, dict):
        leaf["q"].random_(-127, 128, generator=gen)
        leaf["scale"].uniform_(0.75 * STD / INT8_STD, 1.25 * STD / INT8_STD, generator=gen)
    else:
        leaf.normal_(0.0, STD, generator=gen)


def make_weights(s, device, dtype=torch.bfloat16) -> dict:
    """An unfilled tree for shapes ``s`` (``fill_weights`` draws it), its
    floating leaves in ``dtype`` (bf16, as served on the card; float32 for
    the engine on the CPU in the tests)."""
    int8 = s.quant == "int8"
    leaves = shapes_of_leaves(s)
    ones = dict(dtype=dtype, device=device)
    return {
        "embed": _leaf(leaves["embed"], int8, device, dtype),
        "lm_head": _leaf(leaves["lm_head"], int8, device, dtype),
        "final_norm": torch.ones((s.dim,), **ones),
        "layers": {
            "attn_norm": torch.ones((s.n_layers, s.dim), **ones),
            "mlp_norm": torch.ones((s.n_layers, s.dim), **ones),
            **{name: _leaf(shape, int8, device, dtype) for name, shape in leaves["layers"].items()},
        },
    }


def fill_weights(tree: dict, seed: int, device) -> dict:
    """Draw every matrix of ``tree`` in place from ``seed``, in a fixed
    order: the same seed gives the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    _fill(tree["embed"], gen)
    _fill(tree["lm_head"], gen)
    for name in sorted(tree["layers"]):
        if name not in ("attn_norm", "mlp_norm"):
            _fill(tree["layers"][name], gen)
    if torch.device(device).type == "cuda":
        # the fills run on this thread's stream and the engine serves on its
        # own: no step may read a weight before it is drawn
        torch.cuda.synchronize(device)
    return tree
