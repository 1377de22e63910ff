"""The port's training step over a dp × tp (× ep) mesh against the JAX
package's, on the CPU.

Both sides start from one f32 param tree (the JAX ``make_train_step``'s
``init_fn``, carried across by ``params_from_numpy``) and take the same
numpy tokens; JAX runs ``make_train_step(cfg, mesh)`` on the virtual
8-device CPU mesh of ``tests/conftest.py``, the port on a mesh of the same
shape whose shards are all ``"cpu"``. Held against
``tests/test_parallel.py``'s train cases and ``tests/test_flash_mesh.py``'s
meshed attention. Tolerances are ``tests/test_torch_train.py``'s: losses
``LOSS_TOL`` 2e-5, gradients ``GRAD_RTOL`` 1e-4 (with an atol of 1e-5 of
the leaf's largest), updated params ``PARAM_ATOL`` 1e-6 outside the
elements whose gradient came near zero (that file's docstring).

Each JAX run and each one-device gradient is computed once a process for
each distinct input (``_shared``) and shared with the sp and pp files.

Also here: the reference's optimizer state carried onto a mesh, the
gradient through each collective equals the unsharded gradient, and a leaf
copied over dp gets its gradient summed over its replicas exactly once,
whether they share one tensor or are copies.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu import train as jtrain
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.ops.attention import attention_reference as j_attention_reference
from agentainer_tpu.parallel import flash_mesh as jflash
from agentainer_tpu.parallel.mesh import make_mesh as jmake_mesh
from agentainer_tpu_torch import train as ttrain
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.ops.attention import attention_reference, causal_mask
from agentainer_tpu_torch.parallel import collectives, flash_mesh
from agentainer_tpu_torch.parallel.mesh import make_mesh, pick_tp
from agentainer_tpu_torch.parallel.sharding import shard_batch, shard_train_params, unshard_params, unshard_tensor
from tests.test_torch_train import (
    GRAD_ATOL_REL,
    GRAD_RTOL,
    LOSS_TOL,
    _assert_params_close,
    _np_tree,
    _paths,
    _tokens,
)


def cpu_mesh(n: int, **axes):
    return make_mesh(n, devices=["cpu"] * n, **axes)


# The references, computed once a process for each distinct input and shared
# by the tests (and by test_torch_train_sp.py and test_torch_train_pp.py,
# which import these helpers): pp's five meshes, for one, start from the same
# params and tokens, so their first step's one-device gradient is one run.
_REFERENCES: dict = {}


def _shared(key, compute):
    if key not in _REFERENCES:
        _REFERENCES[key] = compute()
    return _REFERENCES[key]


def _digest(tree) -> str:
    h = hashlib.sha1()
    for path, leaf in _paths(tree):
        leaf = np.ascontiguousarray(leaf)
        h.update(f"{path}{leaf.shape}{leaf.dtype}".encode())
        h.update(leaf.tobytes())
    return h.hexdigest()


def _torch_grads(name: str, params_np, tokens):
    """The one-device gradient of the loss at ``params_np``, through the
    port's ``loss_fn`` (which ``tests/test_torch_train.py`` holds to
    ``jax.grad``'s): ``_assert_params_close`` reads it only to find the
    elements whose gradient is near zero."""
    tokens = np.asarray(tokens)
    key = ("grads", name, _digest(params_np), tokens.shape, tokens.tobytes())
    return _shared(key, lambda: _one_device_grads(name, params_np, tokens))


def _one_device_grads(name: str, params_np, tokens):
    params = params_from_numpy(params_np)
    for p in ttrain.leaves(params):
        p.requires_grad_(True)
    ttrain.loss_fn(params, tconfigs.get_config(name), torch.from_numpy(np.asarray(tokens)).long(),
                   ttrain.trainable_causal_attention).backward()

    def grads(tree):
        return {k: grads(v) if isinstance(v, dict) else v.grad.numpy() for k, v in tree.items()}

    return grads(params)


def jax_steps(name: str, n: int, axes: dict, tokens, steps: int = 2, **kw):
    """``steps`` steps of the reference's ``make_train_step`` on its mesh
    ``make_mesh(n, **axes)`` from ``init_fn(PRNGKey(0))``: the initial
    params, each step's loss, the gradient each step took (at its pre-step
    params, one device) and the final params; one run for each distinct
    set of arguments."""
    tokens = np.asarray(tokens)
    key = ("jax", name, n, tuple(sorted(axes.items())), tokens.shape, tokens.tobytes(), steps,
           tuple(sorted(kw.items())))
    return _shared(key, lambda: _jax_run(name, n, axes, tokens, steps, **kw))


def _jax_run(name: str, n: int, axes: dict, tokens, steps: int, **kw):
    cfg = jconfigs.get_config(name)
    init_fn, step_fn, shard_batch_ = jtrain.make_train_step(cfg, jmake_mesh(n, **axes), **kw)
    state = init_fn(jax.random.PRNGKey(0))
    p0 = _np_tree(state.params)
    batch = shard_batch_(jnp.asarray(tokens))
    losses, grads, params = [], [], p0
    for _ in range(steps):
        grads.append(_torch_grads(name, params, tokens))
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
        params = _np_tree(state.params)
    return p0, losses, grads, params


def torch_steps(name: str, mesh, p0, tokens, steps: int = 2, **kw):
    """The port's steps over ``mesh`` from the same params: each loss and
    the final state."""
    init_fn, step_fn, shard_batch_ = ttrain.make_train_step(tconfigs.get_config(name), mesh, **kw)
    state = init_fn(params=params_from_numpy(p0))
    batch = shard_batch_(tokens)
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    return losses, state


def assert_steps_match(name, n, axes, tokens, steps=2, **kw):
    """The port's steps over its mesh against the reference's on the same
    mesh shape: every loss and every updated leaf, gathered back."""
    p0, want_losses, grads, want = jax_steps(name, n, axes, tokens, steps, **kw)
    mesh = cpu_mesh(n, **axes)
    losses, state = torch_steps(name, mesh, p0, tokens, steps, **kw)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert state.step == steps
    got = unshard_params(state.params.trees, mesh, state.params.specs)
    _assert_params_close(want, got, grads, steps)
    return losses, state, mesh


@pytest.mark.parametrize(
    "name,n,axes",
    [("tiny", 4, {"tp": 2}), ("tiny-moe", 8, {"tp": 2, "ep": 2})],
    ids=["dp2xtp2", "moe-dp2xtp2xep2"],
)
def test_two_steps_match_jax_on_the_same_mesh(name, n, axes):
    """Two steps over dp × tp (tiny) and dp × tp × ep (tiny-moe, the dense
    einsum over ep-sharded experts, as the reference's MoE step runs):
    losses and updated params against the reference's on its mesh."""
    losses, state, mesh = assert_steps_match(name, n, axes, _tokens(jconfigs.get_config(name), b=4, seed=8))
    assert losses[1] < losses[0]
    # each distinct slice is one optimizer leaf, its moments cut like it
    opt = state.opt_state
    assert [p for g in opt.param_groups for p in g["params"]] == state.params.leaves
    for leaf in state.params.leaves:
        assert opt.state[leaf]["exp_avg"].shape == leaf.shape


def test_adamw_state_carries_across_onto_a_mesh():
    """Two steps of the reference's dp2 × tp2 step, then its params and
    optax state carried into the port's mesh (cut like the params: each
    slice's moments beside it); one more step on each side gives the same
    loss and leaves."""
    from agentainer_tpu_torch.models.convert import adamw_state_from_numpy

    cfg = jconfigs.get_config("tiny")
    tokens = _tokens(cfg, b=4, seed=5)
    jm = jmake_mesh(4, tp=2)
    init_fn, step_fn, shard_batch_ = jtrain.make_train_step(cfg, jm)
    state = init_fn(jax.random.PRNGKey(0))
    batch = shard_batch_(jnp.asarray(tokens))
    for _ in range(2):
        state, _ = step_fn(state, batch)
    params_np, opt_np = _np_tree(state.params), _np_tree(state.opt_state)
    grads = [_torch_grads("tiny", params_np, tokens)]
    state, want_loss = step_fn(state, batch)
    mesh = cpu_mesh(4, tp=2)
    tinit, tstep, tshard = ttrain.make_train_step(tconfigs.get_config("tiny"), mesh)
    params = params_from_numpy(params_np)
    tstate = tinit(params=params, opt_state=adamw_state_from_numpy(opt_np, params))
    leaf = tstate.params.leaves[0]
    assert float(tstate.opt_state.state[leaf]["step"]) == 2.0
    tstate, loss = tstep(tstate, tshard(tokens))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    got = unshard_params(tstate.params.trees, mesh, tstate.params.specs)
    _assert_params_close(_np_tree(state.params), got, grads, 1)


def test_moe_step_runs_on_the_reference_batch():
    """tests/test_parallel.py's ``test_moe_train_step_runs``: tiny-moe at
    dp2 × tp2 × ep2 on ``ones((4, 12))``, the loss finite and the
    reference's."""
    tokens = np.ones((4, 12), np.int32)
    p0, want, _, _ = jax_steps("tiny-moe", 8, {"tp": 2, "ep": 2}, tokens, steps=1)
    losses, _ = torch_steps("tiny-moe", cpu_mesh(8, tp=2, ep=2), p0, tokens, steps=1)
    assert np.isfinite(losses[0])
    np.testing.assert_allclose(losses, want, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_train_step_runs_and_learns():
    """tests/test_parallel.py's ``test_train_step_runs_and_learns``: a
    repetitive corpus is memorized over ``make_mesh(8, tp=pick_tp)``."""
    cfg = tconfigs.get_config("tiny")
    mesh = cpu_mesh(8, tp=pick_tp(cfg, 8))
    init_fn, step_fn, shard_batch_ = ttrain.make_train_step(cfg, mesh, learning_rate=1e-2)
    state = init_fn(torch.Generator().manual_seed(0))
    tokens = shard_batch_(np.tile(np.arange(16, dtype=np.int32)[None], (8, 1)) % cfg.vocab_size)
    assert [x.shape for x in tokens] == [(2, 16)] * 8
    state, loss0 = step_fn(state, tokens)
    losses = []
    for _ in range(10):
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < float(loss0) * 0.7, (float(loss0), losses)
    assert state.step == 11


def test_meshed_trainable_attention_matches_jax():
    """tests/test_flash_mesh.py's meshed causal attention at tp=2: the
    port's per-shard wrappers on each shard's heads against the
    reference's ``make_meshed_causal_attention`` (interpret-mode Pallas),
    and the trainable one's dq/dk/dv against ``jax.vjp`` of the reference's
    ``make_trainable_causal_attention``."""
    b, t, h, kv, hd = 2, 32, 4, 2, 16
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, t, n, hd)).astype(np.float32) for n in (h, kv, kv))
    g = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    jm = jmake_mesh(2, tp=2)
    fwd_fn = jflash.make_meshed_causal_attention(jm, interpret=True)
    train_fn = jflash.make_trainable_causal_attention(jm, interpret=True)

    def reference(q, k, v, g):
        out, vjp = jax.vjp(train_fn, q, k, v)
        return fwd_fn(q, k, v), out, vjp(g)

    with jm:
        want_fwd, want, want_grads = jax.jit(reference)(q, k, v, g)
    mesh = cpu_mesh(2, tp=2)
    heads = (None, None, "tp", None)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    qs, ks, vs = (shard_batch(x, mesh, heads) for x in leaves)
    fwd_impl = flash_mesh.make_meshed_causal_attention(mesh)
    fwd = unshard_tensor([fwd_impl(*x) for x in zip(qs, ks, vs)], heads, mesh)
    np.testing.assert_allclose(fwd.detach().numpy(), np.asarray(want_fwd), rtol=2e-5, atol=2e-5)
    train_impl = flash_mesh.make_trainable_causal_attention(mesh)
    out = unshard_tensor([train_impl(*x) for x in zip(qs, ks, vs)], heads, mesh)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, w in zip(got, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
    mask = causal_mask(t).expand(b, t, t)
    plain = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), mask=mask)
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)
    jplain = j_attention_reference(q, k, v, mask=jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jplain), rtol=2e-5, atol=2e-5)


def test_resolve_mesh_flash_is_the_kernels_on_the_card_and_plain_on_the_cpu():
    """The reference's one policy without its einsum branch: kernels on the
    card where every shard's head is the kernels', the plain versions on
    the CPU, a refusal on the card for a head the kernels do not take."""
    llama = tconfigs.get_config("llama3-8b")
    assert flash_mesh.resolve_mesh_flash(llama, 2, ["cuda:0", "cuda:0"]) is True
    assert flash_mesh.resolve_mesh_flash(tconfigs.get_config("tiny"), 2, ["cpu", "cpu"]) is False
    with pytest.raises(ValueError, match="no attention kernel"):
        flash_mesh.resolve_mesh_flash(tconfigs.get_config("tiny"), 2, ["cuda:0", "cuda:0"])


# ---------------------------------------------------------------------------
# gradients through the collectives, and replicas summed once


def _collective_cases(mesh):
    """(name, sharded f, unsharded f) over one x ``[8, 6]``: each sharded f
    cuts x over an axis, runs one collective and joins the shards' results
    (one tensor per shard, stacked); the unsharded f computes the same
    values from x directly."""
    n, size = mesh.size, mesh.shape["sp"]
    sp_of = [mesh.index("sp", s) for s in range(n)]

    def parts(x):  # a shard holds the rows of its sp block
        return [x.narrow(0, j * (8 // size), 8 // size) for j in sp_of]

    def stack(outs):
        return torch.stack([o.float() for o in outs])

    return [
        ("all_reduce",
         lambda x: stack(collectives.all_reduce(parts(x), mesh, "sp")),
         lambda x: stack([sum(x.narrow(0, i * (8 // size), 8 // size) for i in range(size))] * n)),
        ("all_gather",
         lambda x: stack(collectives.all_gather(parts(x), mesh, "sp", dim=0)),
         lambda x: stack([x] * n)),
        ("all_to_all",
         lambda x: stack(collectives.all_to_all(parts(x), mesh, "sp", split_dim=1, concat_dim=0)),
         lambda x: stack([x.narrow(1, j * (6 // size), 6 // size) for j in sp_of])),
        ("ring_shift",
         lambda x: stack(collectives.ring_shift(parts(x), mesh, "sp")),
         lambda x: stack([x.narrow(0, ((j - 1) % size) * (8 // size), 8 // size) for j in sp_of])),
        ("handoff",
         lambda x: collectives.handoff(x * 2, mesh, n - 1),
         lambda x: x * 2),
        ("broadcast",
         lambda x: stack(collectives.broadcast([x[:2] * 3], mesh, ("dp", "tp", "sp"), [0])),
         lambda x: stack([x[:2] * 3] * n)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_gradient_through_each_collective_is_the_unsharded_gradient(case):
    """Every collective is ``.to``/``.float``/``narrow``/``torch.cat``, so
    autograd flows: a loss's gradient through it equals the gradient of
    the same values computed on the unsharded tensor."""
    mesh = cpu_mesh(8, tp=2, sp=2)
    name, sharded, plain = _collective_cases(mesh)[case]
    rng = np.random.default_rng(case)
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    with collectives.record() as log:
        got = sharded(a)
    want = plain(b)
    torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)
    w = torch.from_numpy(rng.standard_normal(tuple(got.shape)).astype(np.float32))
    (ga,), (gb,) = torch.autograd.grad(got, [a], w), torch.autograd.grad(want, [b], w)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6, msg=name)
    assert [e["kind"] for e in log] == [name]


def _grad_tree(shards):
    """The whole gradient tree of a cut after a backward: each shard's
    tensor stands for its optimizer leaf, whose gradient holds the slice's
    sum."""
    lead = {id(t): leaf for leaf, copies in zip(shards.leaves, shards.copies) for t in (leaf, *copies)}

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else lead[id(v)].grad for k, v in tree.items()}

    return [walk(t) for t in shards.trees]


@pytest.mark.parametrize("share", [True, False], ids=["shared", "copies"])
def test_a_replicated_leaf_gets_its_dp_sum_once(share):
    """dp2 × tp2: every leaf copied over dp (norms: over tp too) gets the
    gradient of the whole batch, the one-device step's, once: when the
    shards of one device share one tensor (autograd sums them), and when
    each shard holds a copy of its own, as on separate cards (the copies'
    gradients summed into the leaf's); after the update every copy equals
    its leaf."""
    cfg = tconfigs.get_config("tiny")
    params = ttrain.init_params(cfg, torch.Generator().manual_seed(4), dtype=torch.float32)
    tokens = _tokens(cfg, b=4, seed=9)
    ref = {path: leaf.detach().clone().requires_grad_() for path, leaf in _paths(params)}

    def nest(flat):
        out: dict = {}
        for path, v in flat.items():
            *head, last = path.strip("/").split("/")
            node = out
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
        return out

    ttrain.loss_fn(nest(ref), cfg, torch.from_numpy(tokens).long(),
                   ttrain.trainable_causal_attention).backward()
    mesh = cpu_mesh(4, tp=2)
    _, step_fn, shard_batch_ = ttrain.make_train_step(cfg, mesh)
    shards = shard_train_params(params, mesh, cfg.is_moe, share=share, dtype=torch.float32)
    state = ttrain.TrainState(shards, torch.optim.AdamW(shards.leaves, lr=3e-4, weight_decay=0.01), 0)
    trees = state.params.trees
    # shards 0 and 2 are dp replicas of tp slice 0
    assert (trees[0]["final_norm"] is trees[2]["final_norm"]) == share
    assert (trees[0]["layers"]["wq"] is trees[2]["layers"]["wq"]) == share
    assert all(not c for c in state.params.copies) == share
    state, _ = step_fn(state, shard_batch_(tokens))
    got = dict(_paths(unshard_params(_grad_tree(state.params), mesh, state.params.specs)))
    for path, leaf in ref.items():
        w = leaf.grad.numpy()
        np.testing.assert_allclose(got[path].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(w).max(), err_msg=path)
    for leaf, copies in zip(state.params.leaves, state.params.copies):
        for c in copies:
            assert torch.equal(c, leaf)
