"""Model config registry.

Reference: ``agentainer_tpu/models/configs.py`` — an own copy, field for
field, so the port never imports the JAX package. Keep the two registries
identical: the parity tests build the same configs in both packages.

The flagship targets are Llama-3-8B and Mixtral-8x7B. Tiny variants exist
for CI — same code path, small shapes.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    # MoE (0 experts → dense FFN)
    n_experts: int = 0
    experts_per_token: int = 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Exact parameter count of models/llama.init_params' tree."""
        embed = self.vocab_size * self.dim
        per_layer_attn = self.dim * self.dim + 2 * self.dim * (
            self.n_kv_heads * self.head_dim
        ) + self.dim * self.dim
        ffn = 3 * self.dim * self.ffn_dim
        if self.is_moe:
            ffn = self.n_experts * ffn + self.dim * self.n_experts
        per_layer = per_layer_attn + ffn + 2 * self.dim
        return 2 * embed + self.n_layers * per_layer + self.dim

    def param_bytes(self, dtype_bytes: int = 2) -> int:
        """Rough weight footprint (bf16 default)."""
        return dtype_bytes * self.param_count()

    def active_param_count(self) -> int:
        """Params a single token's forward actually touches: for MoE only
        ``experts_per_token`` of the expert FFNs contract with each token."""
        if not self.is_moe:
            return self.param_count()
        full_ffn = 3 * self.dim * self.ffn_dim
        unused = (self.n_experts - self.experts_per_token) * full_ffn
        return self.param_count() - self.n_layers * unused

    def flops_per_token(self, context_len: int) -> float:
        """Forward-pass FLOPs to process ONE token with ``context_len``
        tokens of attendable KV (matmul FLOPs = 2 × MACs; norms/rope/softmax
        excluded). The engine's MFU is computed from this model."""
        matmul = 2.0 * self.active_param_count()
        # q·K^T and p·V: 2 * heads * head_dim * context MACs → 4 FLOPs/slot
        attn = 4.0 * self.n_heads * self.head_dim * context_len
        return matmul + self.n_layers * attn


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# Llama-3-8B architecture (public numbers: 32 layers, 4096 dim, 32 heads /
# 8 KV heads (GQA), 14336 FFN, 128256 vocab, rope theta 5e5).
LLAMA3_8B = register(
    ModelConfig(
        name="llama3-8b",
        vocab_size=128_256,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=14_336,
        max_seq_len=8192,
        rope_theta=500_000.0,
    )
)

# Mixtral-8x7B architecture (32 layers, 4096 dim, 32/8 heads, 14336 FFN,
# 8 experts top-2, 32000 vocab, theta 1e6).
MIXTRAL_8X7B = register(
    ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32_000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_dim=14_336,
        max_seq_len=32_768,
        rope_theta=1_000_000.0,
        n_experts=8,
        experts_per_token=2,
    )
)

# Tiny CI configs — same code paths, small shapes.
TINY = register(
    ModelConfig(
        name="tiny",
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_dim=128,
        max_seq_len=256,
        rope_theta=10_000.0,
    )
)

TINY_MOE = register(
    ModelConfig(
        name="tiny-moe",
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_dim=128,
        max_seq_len=256,
        rope_theta=10_000.0,
        n_experts=4,
        experts_per_token=2,
    )
)

# A mid-size single-device benchmark config.
BENCH_1B = register(
    ModelConfig(
        name="bench-1b",
        vocab_size=32_000,
        dim=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=8,
        ffn_dim=5632,
        max_seq_len=4096,
        rope_theta=500_000.0,
    )
)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model config {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
