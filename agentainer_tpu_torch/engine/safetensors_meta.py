"""HuggingFace checkpoint metadata, on the standard library alone.

Reference: the header half of ``agentainer_tpu/engine/hf_convert.py``
(``config_from_hf``, ``_open_shards``'s index handling) and the
``safetensors`` package's ``safe_open(...).get_slice(name).get_shape()``
that ``agentainer_tpu/manager/artifacts.py`` validates with. A
``.safetensors`` file is an 8-byte little-endian header length, a JSON
header of ``dtype``, ``shape`` and ``data_offsets`` per tensor, then the
raw data; this module reads the header only, so a directory validates in
milliseconds and the daemon (``manager/artifacts.py``) never imports
torch or numpy. ``engine/hf_convert.py`` builds its loader on these
classes, so loading and validation read one parser.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, TypeVar

from ..models.configs import ModelConfig

INDEX_FILE = "model.safetensors.index.json"


def is_hf_checkpoint(path: str | Path) -> bool:
    p = Path(path).expanduser()
    return p.is_dir() and any(p.glob("*.safetensors"))


class SafetensorsHeader:
    """One ``.safetensors`` file's header: each tensor's dtype tag, shape
    and byte range; no tensor data is read."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: not a safetensors file (no header length)")
            n = int.from_bytes(head, "little")
            raw = f.read(n)
        if len(raw) != n:
            raise ValueError(f"{self.path}: header of {n} bytes is cut short")
        header = json.loads(raw)
        header.pop("__metadata__", None)
        self.header: dict = header
        self._data_start = 8 + n

    def names(self) -> list[str]:
        return list(self.header)

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self.header[name]["shape"])


H = TypeVar("H", bound=SafetensorsHeader)


def open_shards(path: Path, cls: Callable[[Path], H] = SafetensorsHeader) -> dict[str, H]:
    """name → its file (one ``cls`` per file). Handles single-file and
    index-sharded layouts."""
    index = path / INDEX_FILE
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        files = {shard: cls(path / shard) for shard in sorted(set(weight_map.values()))}
        return {name: files[shard] for name, shard in weight_map.items()}
    out: dict[str, H] = {}
    for shard in sorted(path.glob("*.safetensors")):
        f = cls(shard)
        for name in f.names():
            out[name] = f
    return out


def config_from_hf(path: str | Path) -> ModelConfig:
    """Derive a ModelConfig from the checkpoint's own config.json."""
    doc = json.loads((Path(path).expanduser() / "config.json").read_text())
    n_experts = int(doc.get("num_local_experts", 0) or 0)
    return ModelConfig(
        name=doc.get("model_type", "hf") + "-import",
        vocab_size=int(doc["vocab_size"]),
        dim=int(doc["hidden_size"]),
        n_layers=int(doc["num_hidden_layers"]),
        n_heads=int(doc["num_attention_heads"]),
        n_kv_heads=int(doc.get("num_key_value_heads", doc["num_attention_heads"])),
        ffn_dim=int(doc["intermediate_size"]),
        max_seq_len=int(doc.get("max_position_embeddings", 8192)),
        rope_theta=float(doc.get("rope_theta", 500_000.0)),
        norm_eps=float(doc.get("rms_norm_eps", 1e-5)),
        n_experts=n_experts,
        experts_per_token=int(doc.get("num_experts_per_tok", 2)),
    )
