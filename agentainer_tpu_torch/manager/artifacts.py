"""Model-artifact builder — the image-builder analogue.

Reference: ``agentainer_tpu/manager/artifacts.py``, with the same names,
store keys, build log, document and errors. A user-supplied checkpoint
directory becomes a deployable, dedup-named artifact:

1. **detect** the layout (``detect_layout``: ``hf`` for ``config.json`` +
   ``*.safetensors``, ``orbax`` for a ``params/`` directory);
2. **validate** it against the model config its ``config.json`` gives —
   every expected tensor present with the right shape, read from the
   safetensors headers alone (``engine/safetensors_meta.py``), so an 8B
   checkpoint validates in milliseconds without loading a byte of weights;
3. **register** it under a dedup'd name (``name``, ``name-2``, ...) in the
   store, so ``deploy`` can name the artifact and ``models`` can list it.

Progress goes through a callback (the CLI prints the lines; the API returns
them in the document's ``build_log``).

What differs from the reference: an orbax directory is refused at build
with a 400 that says why, where the reference registers it and defers its
validation to the engine's load. The port's engine reads HF checkpoints
only (``engine/checkpoint.py``), so registering one would only move the
failure to the agent's start. Nothing here imports torch or numpy: the
daemon builds artifacts without a CUDA context.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Callable

from ..core.errors import AgentainerError
from ..store.base import Store

ARTIFACT_KEY = "artifact:{name}"
ARTIFACTS_LIST = "artifacts:list"

Progress = Callable[[str], None]


class ArtifactError(AgentainerError):
    http_status = 400


def detect_layout(path: str | Path) -> str | None:
    """'hf' | 'orbax' | None — the IsDockerfile-style heuristic."""
    p = Path(path).expanduser()
    if not p.is_dir():
        return None
    if (p / "config.json").exists() and any(p.glob("*.safetensors")):
        return "hf"
    if (p / "params").is_dir():  # the reference's save_params layout
        return "orbax"
    return None


def _expected_tensors(cfg) -> dict[str, tuple]:
    """HF tensor name → expected shape, derived from the model config
    (mirror of engine/hf_convert.py's mapping, torch [out, in] layout)."""
    d, hd = cfg.dim, cfg.head_dim
    exp: dict[str, tuple] = {
        "model.embed_tokens.weight": (cfg.vocab_size, d),
        "model.norm.weight": (d,),
    }
    for i in range(cfg.n_layers):
        L = f"model.layers.{i}."
        exp[L + "input_layernorm.weight"] = (d,)
        exp[L + "post_attention_layernorm.weight"] = (d,)
        exp[L + "self_attn.q_proj.weight"] = (cfg.n_heads * hd, d)
        exp[L + "self_attn.k_proj.weight"] = (cfg.n_kv_heads * hd, d)
        exp[L + "self_attn.v_proj.weight"] = (cfg.n_kv_heads * hd, d)
        exp[L + "self_attn.o_proj.weight"] = (d, cfg.n_heads * hd)
        if cfg.is_moe:
            exp[L + "block_sparse_moe.gate.weight"] = (cfg.n_experts, d)
            for e in range(cfg.n_experts):
                E = L + f"block_sparse_moe.experts.{e}."
                exp[E + "w1.weight"] = (cfg.ffn_dim, d)
                exp[E + "w2.weight"] = (d, cfg.ffn_dim)
                exp[E + "w3.weight"] = (cfg.ffn_dim, d)
        else:
            exp[L + "mlp.gate_proj.weight"] = (cfg.ffn_dim, d)
            exp[L + "mlp.up_proj.weight"] = (cfg.ffn_dim, d)
            exp[L + "mlp.down_proj.weight"] = (d, cfg.ffn_dim)
    return exp


def _validate_hf(path: Path, progress: Progress) -> dict:
    """Metadata-only validation: shapes from safetensors headers, no weight
    bytes loaded. Returns {n_params, n_tensors, files, config}."""
    from ..engine.safetensors_meta import config_from_hf, open_shards

    try:
        cfg = config_from_hf(path)
    except (OSError, KeyError, ValueError) as e:
        raise ArtifactError(f"unreadable model config: {e}") from e
    progress(
        f"config: dim={cfg.dim} layers={cfg.n_layers} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} vocab={cfg.vocab_size}"
        + (f" experts={cfg.n_experts}x{cfg.experts_per_token}" if cfg.is_moe else "")
    )
    shards = open_shards(path)
    progress(f"{len(shards)} tensors across {len({f.path for f in shards.values()})} shard file(s)")
    shapes = {name: f.shape(name) for name, f in shards.items()}
    exp = _expected_tensors(cfg)
    missing = [n for n in exp if n not in shapes]
    # tied embeddings: lm_head may legitimately be absent
    if missing:
        raise ArtifactError(f"missing tensors (first 5): {missing[:5]}")
    bad = [(n, shapes[n], want) for n, want in exp.items() if shapes[n] != want]
    if bad:
        n, got, want = bad[0]
        raise ArtifactError(f"shape mismatch: {n} is {got}, expected {want}")
    n_params = sum(math.prod(s) for s in shapes.values())
    progress(f"validated {len(shapes)} tensors, {n_params / 1e6:.1f}M params")
    return {
        "n_params": n_params,
        "n_tensors": len(shapes),
        "files": sorted({f.path.name for f in shards.values()}),
        "config": {
            "dim": cfg.dim,
            "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads,
            "vocab_size": cfg.vocab_size,
            "is_moe": cfg.is_moe,
        },
    }


class ArtifactRegistry:
    def __init__(self, store: Store):
        self.store = store

    def _names(self) -> set[str]:
        return set(self.store.smembers(ARTIFACTS_LIST))

    def dedup_name(self, base: str) -> str:
        """``base``, else ``base-2``, ``base-3``, ..."""
        names = self._names()
        if base not in names:
            return base
        n = 2
        while f"{base}-{n}" in names:
            n += 1
        return f"{base}-{n}"

    def build(
        self, path: str | Path, name: str = "", progress: Progress | None = None
    ) -> dict:
        """Validate + register a model directory; returns the artifact doc."""
        lines: list[str] = []

        def note(msg: str) -> None:
            lines.append(msg)
            if progress is not None:
                progress(msg)

        p = Path(path).expanduser().resolve()
        layout = detect_layout(p)
        if layout is None:
            raise ArtifactError(
                f"{p} is not a model directory (expected HF config.json + "
                f"*.safetensors, or an orbax params/ dir)"
            )
        if layout == "orbax":
            raise ArtifactError(
                f"{p} is an orbax params/ directory: the PyTorch port's engine loads "
                f"HF checkpoints only (config.json + *.safetensors), so it is not registered"
            )
        note(f"detected {layout} checkpoint layout at {p}")
        info = _validate_hf(p, note)
        final = self.dedup_name(name or p.name or "model")
        if final != (name or p.name):
            note(f"name in use; registering as {final!r}")
        doc = {
            "name": final,
            "path": str(p),
            "layout": layout,
            "created_at": time.time(),
            "build_log": lines,
            **info,
        }
        self.store.set_json(ARTIFACT_KEY.format(name=final), doc)
        self.store.sadd(ARTIFACTS_LIST, final)
        note(f"registered artifact {final!r}")
        return doc

    def get(self, name: str) -> dict | None:
        return self.store.get_json(ARTIFACT_KEY.format(name=name))

    def list(self) -> list[dict]:
        out = []
        for name in sorted(self._names()):
            doc = self.get(name)
            if doc:
                out.append(doc)
        return out

    def remove(self, name: str) -> bool:
        if self.get(name) is None:
            return False
        self.store.delete(ARTIFACT_KEY.format(name=name))
        self.store.srem(ARTIFACTS_LIST, name)
        return True
