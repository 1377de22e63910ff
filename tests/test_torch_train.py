"""The port's training step against the JAX package's, on the CPU.

Both sides start from one f32 param tree (the JAX ``init_params``, carried
across by ``params_from_numpy``) and take the same numpy tokens; JAX runs
``make_train_step(cfg, make_mesh(1))``, once on its einsum path and once
with ``ATPU_FORCE_MESH_FLASH=1``, where its attention is the interpret-mode
Pallas ``flash_prefill`` forward under the einsum VJP (as
tests/test_flash_mesh.py runs it). The port's step always goes through
``trainable_causal_attention``, whose forward is ``flash_prefill``'s plain
version on a CPU tensor.

Tolerances, and why:
- losses, logits-level: ``LOSS_TOL`` 2e-5, the repo's f32 tolerance for one
  computation summed in another order (tests/test_torch_llama.py);
- gradients: ``rtol=GRAD_RTOL`` 1e-4 with ``atol`` 1e-5 of the leaf's
  largest gradient: f32 sums of a few hundred terms over two summation
  orders, whose error scales with the largest term, not with each element;
- parameters after AdamW steps: Adam divides each gradient by its own
  running magnitude, so an element's update is ``lr * m / (sqrt(v) + eps)``,
  about ``lr`` in size whatever the gradient's scale. An element whose
  gradient is many times eps moves by ``lr`` times a ratio the two sides
  agree on to the gradients' relative error, which is small: those elements
  are held to ``PARAM_ATOL`` 1e-6 (0.3% of one step's update at lr 3e-4).
  An element whose gradient comes within ``SENSITIVE`` = 10 eps of zero,
  but not to it, at some step has a ratio set by the gradient's own
  rounding error (``sign(g)`` at |g| >> eps, g / eps near it), so the two
  sides may differ there by up to the update itself: such elements are held to ``2 * lr`` per step, and
  must be fewer than 1% of the leaf (0.4% at most on these inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu import train as jtrain
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models import llama as jl
from agentainer_tpu.ops.attention import attention_reference as j_attention_reference
from agentainer_tpu.parallel.mesh import make_mesh
from agentainer_tpu_torch import train as ttrain
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models import llama as tl
from agentainer_tpu_torch.models.convert import adamw_state_from_numpy, params_from_numpy
from agentainer_tpu_torch.ops import cuda_attention as ca
from agentainer_tpu_torch.ops.attention import (
    attention_reference,
    causal_mask,
    trainable_causal_attention,
)

LOSS_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
PARAM_ATOL = 1e-6
EPS = 1e-8  # optax's and torch's AdamW eps
SENSITIVE = 10 * EPS
LR = 3e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in _paths(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tokens(cfg, b=2, t=17, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _jax_steps(cfg, tokens, n, monkeypatch, force_flash=False, key=0):
    """``n`` steps of the reference's one-device step from init: the
    initial params, each step's loss and the gradient it took (computed
    again at the pre-step params), and the final state."""
    if force_flash:
        monkeypatch.setenv("ATPU_FORCE_MESH_FLASH", "1")
    else:
        monkeypatch.delenv("ATPU_FORCE_MESH_FLASH", raising=False)
    mesh = make_mesh(1)
    init_fn, step_fn, shard_batch = jtrain.make_train_step(cfg, mesh)
    state = init_fn(jax.random.PRNGKey(key))
    p0 = _np_tree(state.params)
    grad = jax.jit(jax.grad(lambda p, x: jtrain.loss_fn(p, cfg, x)))
    losses, grads = [], []
    batch = shard_batch(jnp.asarray(tokens))
    for _ in range(n):
        grads.append(_np_tree(grad(state.params, batch)))
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    return p0, losses, grads, state


def _torch_steps(tcfg, params_np, tokens, n, opt_state=None):
    init_fn, step_fn, shard_batch = ttrain.make_train_step(tcfg, device="cpu")
    params = params_from_numpy(params_np)
    state = init_fn(
        params=params,
        opt_state=None if opt_state is None else adamw_state_from_numpy(opt_state, params),
    )
    batch = shard_batch(tokens)
    losses = []
    for _ in range(n):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    return losses, state


def _assert_params_close(want_tree, got_tree, grads, n_steps):
    """Every leaf within ``PARAM_ATOL``, except elements whose gradient came
    within ``SENSITIVE`` of zero, and was not zero, at some step (a gradient
    of exactly zero, an embedding row no token reads, is zero on both
    sides and moves only by the decay): those within ``2 * lr`` per
    step, and fewer than 1% of the leaf (see the module docstring)."""
    got = dict(_paths(got_tree))
    grad_paths = [dict(_paths(g)) for g in grads]
    for path, want in _paths(want_tree):
        want = np.asarray(want)
        diff = np.abs(_np(got[path]) - want)
        mags = [np.abs(g[path]) for g in grad_paths]
        sensitive = np.any([(m > 0) & (m < SENSITIVE) for m in mags], axis=0)
        assert sensitive.mean() < 1e-2, (path, int(sensitive.sum()), sensitive.size)
        assert diff[~sensitive].max(initial=0.0) <= PARAM_ATOL, (path, diff[~sensitive].max())
        assert diff[sensitive].max(initial=0.0) <= 2 * LR * n_steps, (path, diff[sensitive].max())


CONFIGS = ["tiny", "tiny-moe"]


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    jcfg, tcfg = jconfigs.get_config(request.param), tconfigs.get_config(request.param)
    params = _np_tree(jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    return jcfg, tcfg, params


def test_loss_matches_jax(model):
    jcfg, tcfg, params = model
    toks = _tokens(jcfg)
    want = float(jtrain.loss_fn(params, jcfg, jnp.asarray(toks)))
    with torch.no_grad():
        plain = ttrain.loss_fn(params_from_numpy(params), tcfg, torch.from_numpy(toks).long())
        seam = ttrain.loss_fn(
            params_from_numpy(params), tcfg, torch.from_numpy(toks).long(),
            trainable_causal_attention,
        )
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(float(plain), want, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(seam), want, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_grads_match_jax(model):
    """Per-leaf gradients of the loss through the training step's attention
    against ``jax.grad(loss_fn)``."""
    jcfg, tcfg, params = model
    toks = _tokens(jcfg, seed=1)
    want = _np_tree(jax.grad(lambda p: jtrain.loss_fn(p, jcfg, jnp.asarray(toks)))(params))
    tp = params_from_numpy(params)
    for p in ttrain.leaves(tp):
        p.requires_grad_(True)
    ttrain.loss_fn(tp, tcfg, torch.from_numpy(toks).long(), trainable_causal_attention).backward()
    got = dict(_paths(tp))
    for path, w in _paths(want):
        g = got[path].grad
        assert g is not None, path
        scale = np.abs(w).max()
        assert scale > 0, path
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale, err_msg=path
        )


def test_forward_grads_reach_qkv_on_cpu():
    """``forward`` with grad-requiring params on the CPU (its default
    ``use_flash=True`` takes the plain attention there) gives wq/wk/wv
    non-zero gradients equal to JAX's."""
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    params = _np_tree(jl.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    w = rng.standard_normal((2, 12, jcfg.vocab_size)).astype(np.float32)

    def jloss(p):
        logits, _ = jl.forward(p, jcfg, jnp.asarray(toks), jnp.asarray(pos))
        return jnp.sum(logits * w)

    want = _np_tree(jax.grad(jloss)(params))["layers"]
    tp = params_from_numpy(params)
    for p in ttrain.leaves(tp):
        p.requires_grad_(True)
    logits = tl.forward(tp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos.copy()))
    (logits * torch.from_numpy(w)).sum().backward()
    for name in ("wq", "wk", "wv"):
        g = tp["layers"][name].grad
        assert g is not None and g.abs().max() > 0, name
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale, err_msg=name
        )


@pytest.mark.parametrize("force_flash", [False, True], ids=["einsum", "mesh-flash"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps_match_jax(name, force_flash, monkeypatch):
    """3 steps of ``make_train_step`` against the reference's one-device
    step: the loss of every step and every final leaf."""
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    toks = _tokens(jcfg, seed=2)
    p0, want_losses, grads, state = _jax_steps(jcfg, toks, 3, monkeypatch, force_flash)
    losses, tstate = _torch_steps(tcfg, p0, toks, 3)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert losses[-1] < losses[0]
    assert tstate.step == 3
    _assert_params_close(_np_tree(state.params), tstate.params, grads, 3)


def test_adamw_state_carries_across(monkeypatch):
    """2 JAX steps, then the params and the optax state carried into the
    port; one more step on each side gives the same loss and leaves."""
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    toks = _tokens(jcfg, seed=4)
    _, _, grads, state = _jax_steps(jcfg, toks, 2, monkeypatch)
    params_np, opt_np = _np_tree(state.params), _np_tree(state.opt_state)
    assert int(opt_np[0].count) == 2
    grad = jax.grad(lambda p: jtrain.loss_fn(p, jcfg, jnp.asarray(toks)))
    grads = [_np_tree(grad(state.params))]
    _, step_fn, shard_batch = jtrain.make_train_step(jcfg, make_mesh(1))
    state, want_loss = step_fn(state, shard_batch(jnp.asarray(toks)))
    losses, tstate = _torch_steps(tcfg, params_np, toks, 1, opt_state=opt_np)
    np.testing.assert_allclose(losses[0], float(want_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    p = tstate.params["layers"]["wq"]
    assert float(tstate.opt_state.state[p]["step"]) == 3.0
    _assert_params_close(_np_tree(state.params), tstate.params, grads, 1)


def test_adamw_state_rejects_a_foreign_tree():
    tcfg = tconfigs.get_config("tiny")
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    moments = {"embed": np.zeros((3, 3), np.float32)}

    class Adam:
        count, mu, nu = np.int32(1), moments, moments

    with pytest.raises(ValueError, match="tree"):
        adamw_state_from_numpy((Adam(), (), ()), params)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        adamw_state_from_numpy(((), (), ()), params)


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (8, 1), (2, 2)])
def test_trainable_attention_grads_match_reference(heads, kv_heads):
    """The Function's output against ``attention_reference`` and its
    dq/dk/dv against autograd through it (the backward is the same
    recomputation, so they agree to f32 rounding of one path), and both
    against the JAX reference's VJP."""
    b, t, hd = 2, 19, 16
    rng = np.random.default_rng(5)
    q, k, v = (
        rng.standard_normal((b, t, n, hd)).astype(np.float32) for n in (heads, kv_heads, kv_heads)
    )
    g = rng.standard_normal((b, t, heads, hd)).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = trainable_causal_attention(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    ref_leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mask = causal_mask(t).expand(b, t, t)
    ref = attention_reference(*ref_leaves, mask=mask)
    want = torch.autograd.grad(ref, ref_leaves, torch.from_numpy(g))
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    jmask = jnp.broadcast_to(jnp.tril(jnp.ones((t, t), bool))[None], (b, t, t))
    jout, vjp = jax.vjp(lambda *x: j_attention_reference(*x, mask=jmask), q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
    for a, w in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_trainable_attention_forward_is_flash_prefill_on_cpu():
    """On a CPU tensor the forward is ``flash_prefill``'s plain version at
    positions arange(T), bit for bit: the CPU runs the card's seam."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32)) for _ in "kv")
    pos = torch.arange(9, dtype=torch.int32)[None]
    assert torch.equal(
        trainable_causal_attention(q.requires_grad_(), k, v),
        ca.flash_prefill_plain(q.detach(), k, v, pos),
    )


def test_train_step_runs_and_learns():
    """The one-device version of tests/test_parallel.py's
    ``test_train_step_runs_and_learns``: a repetitive corpus is memorized."""
    cfg = tconfigs.get_config("tiny")
    init_fn, step_fn, shard_batch = ttrain.make_train_step(cfg, device="cpu", learning_rate=1e-2)
    state = init_fn(torch.Generator().manual_seed(0))
    tokens = shard_batch(np.tile(np.arange(16, dtype=np.int32)[None], (8, 1)) % cfg.vocab_size)
    state, loss0 = step_fn(state, tokens)
    losses = []
    for _ in range(10):
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < float(loss0) * 0.7, (float(loss0), losses)
    assert state.step == 11
    assert all(p.dtype == torch.float32 for p in ttrain.leaves(state.params))


def test_make_train_step_device_rules(monkeypatch):
    """The card by default: no card and no explicit "cpu" raises; on the
    card a head the kernel does not take raises, as ``LLMEngine.create``."""
    cfg = tconfigs.get_config("tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.make_train_step(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no attention kernel"):
        ttrain.make_train_step(cfg, device="cuda")
    init_fn, _, shard_batch = ttrain.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="generator or a params tree"):
        init_fn()
    assert shard_batch(np.zeros((1, 3), np.int32)).device.type == "cpu"


def test_refuse_grad_only_under_grad_mode():
    """The kernel wrappers' guard: an input that requires grad under grad
    mode raises, naming the wrapper and the differentiable path; under
    ``no_grad`` or with no such input it passes."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_prefill.*trainable_causal_attention"):
        ca.refuse_grad("flash_prefill", x)
    with torch.no_grad():
        ca.refuse_grad("flash_prefill", x)
    ca.refuse_grad("flash_prefill", x.detach())
