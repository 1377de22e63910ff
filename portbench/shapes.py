"""A configuration's file, and the shapes the benchmark reads from it.

A configuration file (``configs/<name>.json``) holds the model's published
``config.json`` keys at its top level, as the source states them, with
``source``, the engine options it is served with (``engine``), the memory
reckoning and what was ``assumed``. The benchmark reads the model's shapes
from the published keys alone."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Shapes:
    name: str
    vocab: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int
    rope_theta: float
    norm_eps: float
    n_experts: int  # 0: a dense FFN
    experts_per_token: int
    quant: str  # "" (weights in bf16) or "int8"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def load_json(kind: str, name: str, root: str = ROOT) -> dict:
    """``<root>/<kind>/<name>.json``: a configuration, traffic mix or cell."""
    with open(os.path.join(root, kind, f"{name}.json")) as f:
        return json.load(f)


def shapes_of(name: str, raw: dict) -> Shapes:
    """The shapes a configuration file states, under its published keys."""
    dim, heads = int(raw["hidden_size"]), int(raw["num_attention_heads"])
    return Shapes(
        name=name,
        vocab=int(raw["vocab_size"]),
        dim=dim,
        n_layers=int(raw["num_hidden_layers"]),
        n_heads=heads,
        n_kv_heads=int(raw["num_key_value_heads"]),
        head_dim=int(raw.get("head_dim") or dim // heads),
        ffn_dim=int(raw["intermediate_size"]),
        rope_theta=float(raw["rope_theta"]),
        norm_eps=float(raw["rms_norm_eps"]),
        n_experts=int(raw.get("num_local_experts", 0) or 0),
        experts_per_token=int(raw.get("num_experts_per_tok", 2) or 2),
        quant=str(raw.get("engine", {}).get("quant", "") or ""),
    )
