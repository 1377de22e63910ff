"""The port's HuggingFace import (``engine/hf_convert.py``) against the JAX
package's on the CPU.

The checkpoints are written by the real ``safetensors`` package, so the
port's standard-library reader is checked against an independent writer:
single-file and index-sharded layouts, tied and untied heads, BF16, F16 and
F32 files. Held: every leaf of the port's ``load_hf_params`` equals the
reference's exactly (f32), ``config_from_hf`` equals field for field, the
Mixtral expert stacking equals the reference's, and an engine built by
``create(checkpoint=dir)`` decodes the JAX engine's greedy tokens. A
``tokenizer.json`` without the ``tokenizers`` package raises instead of
falling back to the byte tokenizer.
"""

import asyncio
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from agentainer_tpu.engine import hf_convert as jhf
from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu_torch.engine import hf_convert as thf
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import load_tokenizer
from agentainer_tpu_torch.models import configs as tconfigs

NP_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16}


def _hf_tensors(cfg, tied: bool, seed: int) -> dict:
    """HF-named f32 tensors of a Llama (or Mixtral) checkpoint of ``cfg``
    (tests/test_hf_convert.py's layout)."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.dim, cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)

    tensors = {"model.embed_tokens.weight": w(cfg.vocab_size, d), "model.norm.weight": norm()}
    if not tied:
        tensors["lm_head.weight"] = w(cfg.vocab_size, d)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = norm()
        tensors[p + "post_attention_layernorm.weight"] = norm()
        tensors[p + "self_attn.q_proj.weight"] = w(cfg.n_heads * hd, d)
        tensors[p + "self_attn.k_proj.weight"] = w(cfg.n_kv_heads * hd, d)
        tensors[p + "self_attn.v_proj.weight"] = w(cfg.n_kv_heads * hd, d)
        tensors[p + "self_attn.o_proj.weight"] = w(d, cfg.n_heads * hd)
        if cfg.is_moe:
            tensors[p + "block_sparse_moe.gate.weight"] = w(cfg.n_experts, d)
            for e in range(cfg.n_experts):
                x = p + f"block_sparse_moe.experts.{e}."
                tensors[x + "w1.weight"] = w(cfg.ffn_dim, d)
                tensors[x + "w2.weight"] = w(d, cfg.ffn_dim)
                tensors[x + "w3.weight"] = w(cfg.ffn_dim, d)
        else:
            tensors[p + "mlp.gate_proj.weight"] = w(cfg.ffn_dim, d)
            tensors[p + "mlp.up_proj.weight"] = w(cfg.ffn_dim, d)
            tensors[p + "mlp.down_proj.weight"] = w(d, cfg.ffn_dim)
    return tensors


def write_hf(path, cfg, *, tied=False, dtype="F32", shards=1, seed=0) -> dict:
    """Write a synthetic HF checkpoint of ``cfg`` with the safetensors
    package: one file, or ``shards`` files and an index."""
    tensors = {k: t.astype(NP_DTYPES[dtype]) for k, t in _hf_tensors(cfg, tied, seed).items()}
    if shards == 1:
        save_file(tensors, str(path / "model.safetensors"))
    else:
        names = sorted(tensors)
        weight_map = {}
        for i in range(shards):
            shard = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
            part = names[i::shards]
            save_file({n: tensors[n] for n in part}, str(path / shard))
            weight_map.update({n: shard for n in part})
        (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    doc = {
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.ffn_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
    }
    if cfg.is_moe:
        doc.update(num_local_experts=cfg.n_experts, num_experts_per_tok=cfg.experts_per_token)
    (path / "config.json").write_text(json.dumps(doc))
    return tensors


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


LAYOUTS = [
    # (tied, dtype, shards)
    (False, "F32", 1),
    (True, "BF16", 3),
    (False, "BF16", 1),
    (True, "F16", 2),
]


@pytest.mark.parametrize("tied,dtype,shards", LAYOUTS)
def test_every_leaf_equals_the_reference(tmp_path, tied, dtype, shards):
    cfg = tconfigs.get_config("tiny")
    write_hf(tmp_path, cfg, tied=tied, dtype=dtype, shards=shards)
    want = jhf.load_hf_params(jconfigs.get_config("tiny"), tmp_path, dtype=jnp.float32)
    stats = {}
    got = thf.load_hf_params(cfg, tmp_path, dtype=torch.float32, device="cpu", stats=stats)
    want_leaves, got_leaves = dict(_flat(want)), dict(_flat(got))
    assert sorted(got_leaves) == sorted(want_leaves)
    for name, w in want_leaves.items():
        g = got_leaves[name]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    itemsize = np.dtype(NP_DTYPES[dtype]).itemsize
    n_read = cfg.param_count() - (cfg.vocab_size * cfg.dim if tied else 0)
    assert stats["bytes_read"] == n_read * itemsize


def test_config_from_hf_equals_the_reference(tmp_path):
    write_hf(tmp_path, tconfigs.get_config("tiny"))
    got = dataclasses.asdict(thf.config_from_hf(tmp_path))
    assert got == dataclasses.asdict(jhf.config_from_hf(tmp_path))
    assert got["name"] == "llama-import"


def test_moe_expert_stacking_equals_the_reference(tmp_path):
    cfg = tconfigs.get_config("tiny-moe")
    write_hf(tmp_path, cfg, shards=2)
    want = jhf.load_hf_params(jconfigs.get_config("tiny-moe"), tmp_path, dtype=jnp.float32)
    got = thf.load_hf_params(cfg, tmp_path, dtype=torch.float32)
    assert tuple(got["layers"]["w_gate"].shape) == (cfg.n_layers, cfg.n_experts, cfg.dim, cfg.ffn_dim)
    for name, w in dict(_flat(want)).items():
        np.testing.assert_array_equal(dict(_flat(got))[name].numpy(), np.asarray(w), err_msg=name)
    # the engine serves the checkpoint's MoE model: its tree is the loaded one
    eng = TEngine.create(
        "", checkpoint=str(tmp_path), options={"device": "cpu", "max_batch": 1, "max_seq": 64, "skip_warmup": True}
    )
    try:
        assert eng.cfg.is_moe and torch.equal(eng.params["layers"]["w_down"], got["layers"]["w_down"])
        assert asyncio.run(eng.generate("moe", max_tokens=3, ignore_eos=True))["completion_tokens"] == 3
    finally:
        eng.shutdown()


def test_reader_refuses_another_dtype_and_a_bad_header(tmp_path):
    save_file({"x": np.zeros((2, 3), np.float64)}, str(tmp_path / "a.safetensors"))
    f = thf.SafetensorsFile(tmp_path / "a.safetensors")
    assert f.names() == ["x"] and f.header["x"]["shape"] == [2, 3]
    with pytest.raises(ValueError, match="F64"):
        f.array("x")
    (tmp_path / "b.safetensors").write_bytes((1000).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="cut short"):
        thf.SafetensorsFile(tmp_path / "b.safetensors")


# the engines' shapes: small, features off, so the JAX engine compiles little
OPTS = {
    "max_batch": 2, "max_seq": 64, "decode_chunk": 4, "prefill_chunk": 32,
    "speculative": False, "prefix_cache": False,
}


def test_create_from_a_checkpoint_decodes_the_reference_tokens(tmp_path):
    write_hf(tmp_path, tconfigs.get_config("tiny"), dtype="BF16", shards=2)
    jeng = JEngine.create("", checkpoint=str(tmp_path), options=dict(OPTS, skip_warmup=True))
    teng = TEngine.create("", checkpoint=str(tmp_path), options=dict(OPTS, device="cpu"))
    try:
        assert teng.cfg.name == "llama-import" and teng.params["embed"].dtype == torch.float32

        async def turns(eng):
            a = await eng.chat("s", "a checkpoint turn", max_tokens=9, ignore_eos=True)
            b = await eng.generate("another prompt", max_tokens=7, ignore_eos=True)
            return a["tokens"], b["tokens"]

        assert asyncio.run(turns(teng)) == asyncio.run(turns(jeng))
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_a_checkpoint_without_config_json_raises_naming_it(tmp_path):
    write_hf(tmp_path, tconfigs.get_config("tiny"))
    (tmp_path / "config.json").unlink()
    with pytest.raises(ValueError, match="config.json"):
        TEngine.create("", checkpoint=str(tmp_path), options={"device": "cpu"})


def test_tokenizer_json_without_the_package_raises(tmp_path, monkeypatch):
    """Without the ``tokenizers`` package the port reads a tokenizer.json
    itself; a file outside the family it reads (here one with no
    pre-tokenizer) raises naming the file and the component, and never
    falls back to the byte tokenizer."""
    (tmp_path / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(NotImplementedError) as e:
        load_tokenizer(512, str(tmp_path))
    assert "tokenizer.json" in str(e.value) and "pre_tokenizer" in str(e.value)
    # without a checkpoint the byte tokenizer serves, as before
    assert load_tokenizer(512).eos_id == 2
