"""Sequence-parallel training: ring attention and Ulysses, and the train
step over dp × sp, against the JAX package's on the CPU.

Held against ``tests/test_train_sp.py`` and the ring/Ulysses cases of
``tests/test_longcontext.py``: the port's ``ring_attention`` and
``ulysses_attention`` in the reference's global view (q ``[B, T, H, hd]``
cut over the mesh, the result joined) equal the reference's shard_map
versions on the same mesh shape in outputs (2e-5) and in gradients
(``jax.grad`` through them); its refusal; the train step's two losses and
updated params over dp2 × sp2 through the ring and through Ulysses equal
the reference's (``tests/test_torch_train.py``'s tolerances), and ``auto``
falls back to the ring at sp=4 (tiny has 2 kv heads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.parallel.mesh import make_mesh as jmake_mesh
from agentainer_tpu.parallel.ring_attention import ring_attention as jring
from agentainer_tpu.parallel.ulysses import ulysses_attention as julysses
from agentainer_tpu_torch.ops import cuda_attention as ca
from agentainer_tpu_torch.parallel import collectives
from agentainer_tpu_torch.parallel.ring_attention import ring_attention
from agentainer_tpu_torch.parallel.ulysses import ulysses_attention
from tests.test_torch_train import _tokens
from tests.test_torch_train_mesh import assert_steps_match, cpu_mesh, jax_steps, torch_steps

TOL = 2e-5


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    b, t, h, kv, hd = 2, 32, 4, 2, 16
    return tuple(rng.standard_normal((b, t, n, hd)).astype(np.float32) for n in (h, kv, kv))


# (name, mesh size, sp, causal): the reference's cases (test_longcontext.py)
CASES = [
    ("ring", 8, 4, True),
    ("ring", 8, 8, False),
    ("ulysses", 8, 2, True),
]


def _jax(kind, n, sp, causal):
    jm = jmake_mesh(n, sp=sp)
    fn = jring if kind == "ring" else julysses
    return jax.jit(lambda q, k, v: fn(q, k, v, jm, axis="sp", causal=causal))


def _port(kind, n, sp, causal):
    mesh = cpu_mesh(n, sp=sp)
    fn = ring_attention if kind == "ring" else ulysses_attention
    return lambda q, k, v: fn(q, k, v, mesh, axis="sp", causal=causal)


@pytest.mark.parametrize("kind,n,sp,causal", CASES, ids=["ring-sp4", "ring-sp8-noncausal", "ulysses-sp2"])
def test_outputs_and_gradients_match_jax(qkv, kind, n, sp, causal):
    """Outputs at 2e-5 and dq/dk/dv against ``jax.grad`` of ``sum(out * w)``
    through the reference's shard_map version; the forward launches
    ``flash_prefill`` sp² (ring) or sp (Ulysses) times a mesh group (here
    its plain version: CPU tensors), the backward none."""
    w = np.random.default_rng(1).standard_normal(qkv[0].shape).astype(np.float32)
    jfn = _jax(kind, n, sp, causal)
    want = np.asarray(jfn(*qkv))
    want_grads = jax.jit(jax.grad(lambda *x: jnp.sum(jfn(*x) * w), argnums=(0, 1, 2)))(*qkv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in qkv]
    before = ca.flash_prefill.launches
    out = _port(kind, n, sp, causal)(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL, atol=TOL)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for a, g in zip(got, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=TOL, atol=TOL)
    assert ca.flash_prefill.launches == before  # a CPU tensor runs the plain version, counts nothing


def test_ring_long_sequence_matches_jax():
    """test_longcontext.py's long case: T 128 over sp=8 (16 tokens a shard)."""
    rng = np.random.default_rng(2)
    b, t, h, kv, hd = 1, 128, 2, 2, 8
    q, k, v = (rng.standard_normal((b, t, n, hd)).astype(np.float32) for n in (h, kv, kv))
    want = np.asarray(_jax("ring", 8, 8, True)(q, k, v))
    got = _port("ring", 8, 8, True)(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)


def test_the_kernel_ring_equals_the_plain_ring(qkv):
    """The forward (each visiting block through ``flash_prefill``'s lse
    entry, joined by lse) against the plain ring (the reference's online
    softmax), and the collectives a call logs: sp - 1 rotations of k and
    of v."""
    mesh = cpu_mesh(8, sp=4)
    q, k, v = (torch.from_numpy(x) for x in qkv)
    with collectives.record() as log:
        got = ring_attention(q, k, v, mesh)
    plain = ring_attention(q, k, v, mesh, plain=True)
    torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)
    assert [e["kind"] for e in log] == ["ring_shift"] * 6
    with collectives.record() as log:
        ulysses_attention(q, k, v, cpu_mesh(8, sp=2))
    assert [e["kind"] for e in log] == ["all_to_all"] * 4


def test_ulysses_rejects_an_sp_that_splits_a_kv_head(qkv):
    """sp=4 does not divide tiny's 2 kv heads: the reference's ValueError."""
    q, k, v = (torch.from_numpy(x) for x in qkv)
    with pytest.raises(ValueError, match="sp=4 must divide n_kv_heads=2 for Ulysses"):
        ulysses_attention(q, k, v, cpu_mesh(8, sp=4), axis="sp")


@pytest.mark.parametrize("seq_attn", ["ring", "ulysses"])
def test_sp_train_steps_match_jax(seq_attn):
    """tests/test_train_sp.py's dp2 × sp2 mesh: two steps through the ring
    and through Ulysses against the reference's on the same mesh, every
    loss and updated leaf; the loss falls."""
    tokens = np.random.default_rng(7).integers(0, 512, (4, 17)).astype(np.int32)
    losses, _, _ = assert_steps_match("tiny", 4, {"sp": 2}, tokens, seq_attn=seq_attn)
    assert losses[1] < losses[0]


def test_auto_falls_back_to_the_ring_at_sp4():
    """sp=4 > tiny's 2 kv heads: ``auto`` takes the ring (its rotations in
    the step's log, no all-to-all) and equals the reference's dense loss;
    ``none`` (k and v gathered over sp) equals it too, and an unknown
    ``seq_attn`` raises the reference's error."""
    cfg = jconfigs.get_config("tiny")
    tokens = _tokens(cfg, b=4, seed=7)
    p0, dense, _, _ = jax_steps("tiny", 1, {}, tokens, steps=1, seq_attn="none")
    mesh = cpu_mesh(4, sp=4)
    with collectives.record() as log:
        losses, _ = torch_steps("tiny", mesh, p0, tokens, steps=1, seq_attn="auto")
    np.testing.assert_allclose(losses, dense, rtol=TOL, atol=TOL)
    kinds = {e["kind"] for e in log}
    assert "ring_shift" in kinds and "all_to_all" not in kinds
    none, _ = torch_steps("tiny", mesh, p0, tokens, steps=1, seq_attn="none")
    np.testing.assert_allclose(none, dense, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="unknown seq_attn 'zigzag'"):
        torch_steps("tiny", mesh, p0, tokens, steps=1, seq_attn="zigzag")


def test_a_sequence_sharded_forward_needs_its_attention():
    """Over sp > 1 each shard holds one block of the sequence, so a
    per-shard attention would see only its own block: ``forward`` refuses
    such a split without ``seq_attn_impl``, and with the ring it equals the
    unsharded forward."""
    from agentainer_tpu_torch.models import configs as tconfigs
    from agentainer_tpu_torch.models.llama import forward, init_params
    from agentainer_tpu_torch.parallel.sharding import shard_batch, shard_params, unshard_tensor

    cfg = tconfigs.get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    tokens = torch.from_numpy(_tokens(cfg, b=2, t=16, seed=3)).long()
    positions = torch.arange(16).expand(2, 16)
    mesh = cpu_mesh(2, sp=2)
    trees = shard_params(params, mesh)
    seq = (None, "sp")
    toks, poss = shard_batch(tokens, mesh, seq), shard_batch(positions, mesh, seq)
    with pytest.raises(ValueError, match="needs seq_attn_impl"):
        forward(trees, cfg, toks, poss, cache=None, use_flash=False, mesh=mesh)
    ring = lambda qs, ks, vs: ring_attention(qs, ks, vs, mesh, axis="sp")  # noqa: E731
    got = forward(trees, cfg, toks, poss, cache=None, use_flash=False, mesh=mesh, local_logits=True,
                  seq_attn_impl=ring)
    want = forward(params, cfg, tokens, positions, cache=None, use_flash=False)
    got = unshard_tensor(got, (None, "sp", None), mesh)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=TOL, atol=TOL)
