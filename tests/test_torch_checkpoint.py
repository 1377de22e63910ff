"""The port's checkpoint plane (``engine/checkpoint.py``) against the JAX
package's on the CPU.

- Blobs move both ways bit for bit: a blob written by the reference's
  ``pack_kv_snapshot`` (dense and paged headers, f32, and bf16 from
  ``ml_dtypes``) deserializes in the port to the same bits, and the port's
  blob deserializes in the reference to the same bits and header.
- v1 (fp16 payload), v2 and v3 blobs are accepted; another version and a
  malformed payload raise.
- ``restore_kv_slot`` writes what the reference's writes, leaves the rest of
  the arena bit-equal, and writes in place (the tensors keep their
  ``data_ptr``).
- ``load_params`` refuses the reference's orbax layout.
"""

import io
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from agentainer_tpu.engine import checkpoint as jck
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import KVCache as JKVCache
from agentainer_tpu_torch.engine import checkpoint as tck
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.llama import KVCache

L, KV, HD = 2, 2, 16


def _kv(seed, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, n, KV, HD)).astype(np.float32)
    v = rng.standard_normal((L, n, KV, HD)).astype(np.float32)
    return k.astype(dtype), v.astype(dtype)


def _bits(x) -> np.ndarray:
    """Raw bits of a numpy array or a torch tensor (bf16 through uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


CASES = {
    "dense-f32": (np.float32, {"session": "s", "pending_token": 7}),
    "paged-f32": (np.float32, {"session": "s", "pending_token": None, "page_size": 16}),
    "dense-bf16": (ml_dtypes.bfloat16, {"session": "agent::s", "pending_token": 3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_blob_moves_both_ways_bit_for_bit(case):
    dtype, meta = CASES[case]
    k, v = _kv(0, 40, dtype)  # staged buffers past the live prefix
    position = 29
    jblob = jck.pack_kv_snapshot(k, v, position, meta)
    tk, tv, header = tck.deserialize_kv_slot(jblob)
    np.testing.assert_array_equal(_bits(tk), _bits(k[:, :position]))
    np.testing.assert_array_equal(_bits(tv), _bits(v[:, :position]))
    assert header == {"version": 3, "position": position, "dtype": np.dtype(dtype).name, **meta}

    tblob = tck.pack_kv_snapshot(_torch(k), _torch(v), position, meta)
    jk, jv, jheader = jck.deserialize_kv_slot(tblob)
    assert jheader == header
    assert jk.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(_bits(jk), _bits(k[:, :position]))
    np.testing.assert_array_equal(_bits(jv), _bits(v[:, :position]))


def _npz(version, k, v, dtype_name, position):
    buf = io.BytesIO()
    header = {"version": version, "position": position, "dtype": dtype_name}
    if version == 1:
        header.pop("dtype")
    np.savez_compressed(
        buf, k=k, v=v, header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    )
    return buf.getvalue()


@pytest.mark.parametrize("version", [1, 2, 3])
def test_every_snapshot_version_is_accepted(version):
    dtype = np.float16 if version == 1 else np.float32
    k, v = _kv(1, 9, dtype)
    blob = _npz(version, k, v, np.dtype(dtype).name, 9)
    tk, tv, header = tck.deserialize_kv_slot(blob)
    jk, jv, _ = jck.deserialize_kv_slot(blob)
    assert header["version"] == version and tk.dtype == torch.from_numpy(k).dtype
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(tv.numpy(), jv)


def test_unknown_version_and_malformed_payload_raise():
    k, v = _kv(2, 5)
    with pytest.raises(ValueError, match="version"):
        tck.deserialize_kv_slot(_npz(4, k, v, "float32", 5))
    with pytest.raises(ValueError, match="malformed"):
        tck.deserialize_kv_slot(_npz(3, k, v[:, :4], "float32", 5))
    with pytest.raises(ValueError, match="malformed"):
        tck.deserialize_kv_slot(_npz(3, k, v, "float32", 6))


def test_restore_kv_slot_writes_in_place_what_the_reference_writes():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    b, s = 3, 32
    rng = np.random.default_rng(3)
    shape = (jcfg.n_layers, b, s, jcfg.n_kv_heads, jcfg.head_dim)
    base_k = rng.standard_normal(shape).astype(np.float32)
    base_v = rng.standard_normal(shape).astype(np.float32)
    snap_k = rng.standard_normal((jcfg.n_layers, 11, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    snap_v = rng.standard_normal(snap_k.shape).astype(np.float32)
    want = jck.restore_kv_slot(JKVCache(jnp.asarray(base_k), jnp.asarray(base_v)), 1, snap_k, snap_v)

    cache = KVCache.create(tcfg, b, s, dtype=torch.float32)
    cache.k.copy_(torch.from_numpy(base_k))
    cache.v.copy_(torch.from_numpy(base_v))
    ptrs = (cache.k_store.data_ptr(), cache.v_store.data_ptr())
    tck.restore_kv_slot(cache, 1, torch.from_numpy(snap_k), torch.from_numpy(snap_v))
    assert (cache.k_store.data_ptr(), cache.v_store.data_ptr()) == ptrs
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(want.v))
    # rows 0 and 2 and row 1 past the snapshot are the arena as it was
    untouched = np.ones(shape, dtype=bool)
    untouched[:, 1, :11] = False
    np.testing.assert_array_equal(cache.k.numpy()[untouched], base_k[untouched])


def test_load_params_refuses_the_orbax_layout(tmp_path):
    (tmp_path / "params").mkdir()
    (tmp_path / "params" / "checkpoint").write_bytes(b"\0")
    with pytest.raises(ValueError, match="orbax"):
        tck.load_params(tconfigs.get_config("tiny"), tmp_path, dtype=torch.float32)

    from agentainer_tpu_torch.engine.llm import LLMEngine

    with pytest.raises(ValueError, match="orbax"):
        LLMEngine.create("tiny", checkpoint=str(tmp_path), options={"device": "cpu"})
