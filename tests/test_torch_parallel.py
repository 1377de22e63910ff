"""The port's ``parallel/`` (mesh, sharding, collectives, flash_mesh, expert)
and the meshed forward against the JAX package's, on the CPU.

The JAX side runs on the virtual 8-device CPU mesh (``tests/conftest.py``),
as its own tests do, with its meshed flash kernels in interpret mode; the
port's shards all sit on ``cpu``. Inputs are made with numpy from a seed.
Held:

- ``pick_tp``/``pick_ep`` equal for every registered config and n = 1-8,
  and ``make_mesh``'s device order equal to the reference's;
- each shard of ``shard_params`` equal to the JAX ``NamedSharding``'s shard
  on the same device, for every leaf (int8 ``q`` and ``scale`` included) at
  tp=2, ep=2 and tp=2×ep=2 on ``tiny``/``tiny-moe``;
- meshed cache attention, dense and paged, within f32 2e-5 of the JAX
  meshed kernels (dense) and of the JAX paged body under GSPMD;
- the ports of the tp cases of ``tests/test_paged_hlo.py`` and
  ``tests/test_spec_verify_hlo.py``: the collective log of the meshed step
  holds ``NoLargeAllGather`` (the reference's compiled-HLO check), and the
  numbers match the unsharded body;
- the tp=2 forward against JAX's tp forward (``tests/test_parallel.py``),
  and the ep=2 MoE, dense fallback and routed, against JAX's
  ``moe_expert_parallel``/``make_routed_moe``, within f32 2e-5;
- the collectives and the collective contracts themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from agentainer_tpu.engine import quant as jeq
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models import llama as jl
from agentainer_tpu.ops.attention import attention_reference as j_attention
from agentainer_tpu.ops.attention import cache_mask as j_cache_mask
from agentainer_tpu.ops.attention import gather_pages as j_gather_pages
from agentainer_tpu.ops.attention import scatter_paged_kv as j_scatter_paged_kv
from agentainer_tpu.parallel import expert as jexpert
from agentainer_tpu.parallel import flash_mesh as jflash_mesh
from agentainer_tpu.parallel import mesh as jmesh
from agentainer_tpu.parallel import sharding as jsharding
from agentainer_tpu_torch.analysis.contracts import ContractViolation, HasCrossReduction, NoLargeAllGather, check
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models import llama as tl
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.ops import quant as tq
from agentainer_tpu_torch.parallel import collectives, expert, flash_mesh, mesh, sharding

TOL = 2e-5

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the virtual 8-device mesh")


def _cpu_mesh(tp=1, ep=1):
    return mesh.make_mesh(tp * ep, tp=tp, ep=ep, devices=["cpu"] * (tp * ep))


# ---------------------------------------------------------------------------
# mesh


@pytest.mark.parametrize("name", tconfigs.list_configs())
def test_pick_tp_and_pick_ep_equal_the_reference(name):
    assert tconfigs.list_configs() == jconfigs.list_configs()
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    for n in range(1, 9):
        assert mesh.pick_tp(tcfg, n) == jmesh.pick_tp(jcfg, n), n
        assert mesh.pick_ep(tcfg, n) == jmesh.pick_ep(jcfg, n), n


@pytest.mark.parametrize("tp,ep,pp", [(2, 1, 1), (1, 2, 1), (2, 2, 1), (2, 2, 2), (4, 1, 2), (1, 1, 8)])
def test_make_mesh_keeps_the_reference_device_order(tp, ep, pp):
    """Shard s is the s-th device of the reference's ``mesh.devices``
    flattened: the same device for the same (dp, tp, sp, ep, pp) place."""
    jm = jmesh.make_mesh(8, tp=tp, ep=ep, pp=pp)
    tm = mesh.make_mesh(8, tp=tp, ep=ep, pp=pp, devices=[torch.device("cuda", i) for i in range(8)])
    assert [d.id for d in jm.devices.reshape(-1)] == [d.index for d in tm.device_list]
    assert dict(jm.shape) == tm.shape
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(6, tp=4, devices=["cpu"] * 6)


def test_make_mesh_without_devices_takes_the_visible_cards_or_raises(monkeypatch):
    """No ``devices``: the visible cards, never a silent CPU mesh; a mesh
    on the CPU or on a shared card is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 visible"):
        mesh.make_mesh(2, tp=2)
    assert mesh.make_mesh(1).device_list == [torch.device("cuda", 0)]
    assert mesh.make_mesh().device_list == [torch.device("cuda", 0)]
    assert mesh.make_mesh(2, tp=2, devices=["cuda:0"] * 2).device_list == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.make_mesh(4, tp=2).device_list == [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for n in (1, 2, None):
        with pytest.raises(ValueError, match="0 visible"):
            mesh.make_mesh(n)
    assert mesh.make_mesh(2, tp=2, devices=["cpu"] * 2).device_list == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="4 devices asked for, 2 given"):
        mesh.make_mesh(4, tp=2, devices=["cpu"] * 2)


def test_a_mesh_repeats_a_device_and_groups_its_shards():
    m = _cpu_mesh(tp=2, ep=2)
    assert m.size == 4 and m.distinct_devices == [torch.device("cpu")]
    assert m.groups(("tp",)) == [[0, 2], [1, 3]]
    assert m.groups(("ep",)) == [[0, 1], [2, 3]]
    assert m.groups(("tp", "ep")) == [[0, 1, 2, 3]]
    assert m.first_of(("tp",)) == [0, 2]
    assert [m.index("tp", s) for s in range(4)] == [0, 0, 1, 1]


# ---------------------------------------------------------------------------
# sharding


def _jax_tree(name, quant, seed=0):
    cfg = jconfigs.get_config(name)
    params = jl.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if quant:
        params = jeq.quantize_params(params, dtype=jnp.float32)
    return params


def _leaves(tree, prefix=""):
    """(path, array) of every leaf, a quantized leaf as its two fields."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, tuple) and getattr(v, "_fields", None) == ("q", "scale"):
            yield f"{prefix}{k}.q", v.q
            yield f"{prefix}{k}.scale", v.scale
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name,tp,ep", [("tiny", 2, 1), ("tiny-moe", 1, 2), ("tiny-moe", 2, 2)])
def test_shard_params_equal_the_named_sharding_shards(name, tp, ep, quant):
    jparams = _jax_tree(name, quant)
    jm = jmesh.make_mesh(tp * ep, tp=tp, ep=ep)
    cfg = jconfigs.get_config(name)
    placed = jax.device_put(jparams, jsharding.param_shardings_for(jparams, jm, cfg.is_moe))
    tm = _cpu_mesh(tp, ep)
    shards = params_from_numpy(jax.tree.map(np.asarray, jparams), mesh=tm)
    assert len(shards) == tm.size
    devices = list(jm.devices.reshape(-1))
    for path, arr in _leaves(placed):
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for s, dev in enumerate(devices):
            got = dict(_leaves(shards[s]))[path]
            assert got.is_contiguous(), path
            np.testing.assert_array_equal(got.numpy(), by_device[dev], err_msg=f"{path} shard {s}")
    # the footprint of the shards is the unsharded tree's
    assert sharding.unsharded_bytes(shards, tm) == jeq.param_bytes_actual(jparams)


def test_int8_shards_keep_the_scale_of_the_whole_contraction():
    """A row-parallel int8 weight (wo, w_down) splits q on the contraction
    axis and keeps every output column's scale whole: each shard's
    dequantized rows are the unsharded dequantized rows."""
    tparams = params_from_numpy(jax.tree.map(np.asarray, _jax_tree("tiny", True)))["layers"]["wo"]
    assert isinstance(tparams, tq.QTensor)
    tm = _cpu_mesh(tp=2)
    full = tq.dequant(tparams)
    for s in range(2):
        part = sharding.shard_leaf(tparams, (None, "tp", None), tm, s)
        assert part.scale.shape == tparams.scale.shape
        rows = full.shape[1] // 2
        torch.testing.assert_close(tq.dequant(part), full[:, s * rows : (s + 1) * rows], rtol=0, atol=0)


def test_shard_tensor_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_tensor(torch.zeros(3, 5), (None, "tp"), _cpu_mesh(tp=2), 0)


# ---------------------------------------------------------------------------
# collectives and the collective contracts


def test_all_reduce_sums_each_group_in_f32_and_all_gather_concatenates():
    m = _cpu_mesh(tp=2, ep=2)
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(4)]
    with collectives.record() as log:
        red = collectives.all_reduce(parts, m, "tp")
        both = collectives.all_reduce(parts, m, ("tp", "ep"))
        gat = collectives.all_gather(parts, m, "tp", dim=-1)
    torch.testing.assert_close(red[0], parts[0] + parts[2], rtol=0, atol=0)
    torch.testing.assert_close(red[3], parts[1] + parts[3], rtol=0, atol=0)
    assert red[0] is red[2]  # one device: every shard of a group gets the one sum
    torch.testing.assert_close(both[1], ((parts[0] + parts[1]) + parts[2]) + parts[3])
    torch.testing.assert_close(gat[2], torch.cat([parts[0], parts[2]], dim=-1), rtol=0, atol=0)
    assert log == [
        {"kind": "all_reduce", "axes": ("tp",), "elements": 12},
        {"kind": "all_reduce", "axes": ("tp", "ep"), "elements": 12},
        {"kind": "all_gather", "axes": ("tp",), "elements": 12},
    ]
    bf = [p.bfloat16() for p in parts]
    out = collectives.all_reduce(bf, m, "ep")
    assert out[0].dtype == torch.bfloat16
    torch.testing.assert_close(out[0], (bf[0].float() + bf[1].float()).bfloat16(), rtol=0, atol=0)
    # an axis of size 1: nothing to do, nothing recorded
    with collectives.record() as log:
        assert collectives.all_reduce(parts[:2], _cpu_mesh(ep=2), "tp") == parts[:2]
    assert log == []


def test_collective_contracts_hold_and_fail():
    good = [{"kind": "all_reduce", "axes": ("tp",), "elements": 64},
            {"kind": "all_gather", "axes": ("tp",), "elements": 100}]
    check(good, NoLargeAllGather(101), HasCrossReduction())
    with pytest.raises(ContractViolation, match="all-gather of the KV shard"):
        check(good, NoLargeAllGather(100))
    with pytest.raises(ContractViolation, match="no cross-shard reduction"):
        check(good[1:], HasCrossReduction())


# ---------------------------------------------------------------------------
# meshed cache attention (flash_mesh)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _shard_caches(tm, k, v, paged=False):
    """One shard's one-layer cache per shard of ``tm``: its kv heads of the
    arena ``[B, S, KV, hd]`` (the dense arena with its spare slot) or of
    the pool ``[P, page, KV, hd]``."""
    out = []
    for s in range(tm.size):
        ks, vs = (sharding.shard_tensor(x, (None, None, "tp", None), tm, s) for x in (k, v))
        if paged:
            out.append(tl.PagedKVCache(ks[None].clone(), vs[None].clone()))
        else:
            spare = torch.zeros_like(ks[:, :1])
            out.append(tl.KVCache(torch.cat([ks, spare], 1)[None], torch.cat([vs, spare], 1)[None]))
    return out


def _t_attend(tm, q, k_new, v_new, k, v, pos, bt=None):
    """The serving forward's attention (``make_meshed_cache_attention``) on
    ``tm``'s shards: each shard writes its heads of the step's rows into
    its cache, then attends on them; the shards' outputs joined on the
    head axis."""
    heads = (None, None, "tp", None)
    sh = [[sharding.shard_tensor(x, heads, tm, s) for s in range(tm.size)] for x in (q, k_new, v_new)]
    attend = flash_mesh.make_meshed_cache_attention(paged=bt is not None)
    with collectives.record() as log:
        outs = attend(sh[0], list(zip(sh[1], sh[2])), _shard_caches(tm, k, v, paged=bt is not None), 0,
                      [pos] * tm.size, None if bt is None else [bt] * tm.size)
    return torch.cat([outs[s] for s in tm.first_of(("tp",))], dim=2), log


@pytest.mark.parametrize("t", [1, 5], ids=["decode", "prefill"])
def test_meshed_cache_attention_matches_the_reference_meshed_kernels(t):
    b, s, h, kv, hd = 2, 64, 4, 2, 16
    rng = np.random.default_rng(1)
    ck, cv, q = _rand(rng, b, s, kv, hd), _rand(rng, b, s, kv, hd), _rand(rng, b, t, h, hd)
    pos = np.stack([np.arange(30, 30 + t), np.arange(50, 50 + t)]).astype(np.int32)
    jimpl = jflash_mesh.make_meshed_cache_attention(jmesh.make_mesh(2, tp=2), interpret=True)
    want = np.asarray(jimpl(*(jnp.asarray(x) for x in (q, ck, cv, pos))))
    # the step's rows are the arena's own at those positions: the write
    # leaves it as the reference reads it
    rows = np.arange(b)[:, None]
    got, log = _t_attend(_cpu_mesh(tp=2), *(torch.from_numpy(x) for x in (q, ck[rows, pos], cv[rows, pos], ck, cv,
                                                                          pos)))
    assert log == []  # no collective inside
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# the fixtures of tests/test_paged_hlo.py and tests/test_spec_verify_hlo.py
PB, PKV, PG, PHD, PS, NB, PT = 2, 2, 2, 16, 16, 4, 5
POOL = PB * NB + 2
PAGED_SHARD_ELEMS = POOL * PS * (PKV // 2) * PHD  # one shard's pool
VB, VS, VKV, VG, VHD, VK = 2, 64, 2, 2, 16, 4
VERIFY_SHARD_ELEMS = VB * VS * (VKV // 2) * VHD  # one shard's arena


def _paged_inputs():
    rng = np.random.default_rng(2)
    pool_k, pool_v = _rand(rng, POOL, PS, PKV, PHD), _rand(rng, POOL, PS, PKV, PHD)
    q = _rand(rng, PB, PT, PKV * PG, PHD)
    k_new, v_new = _rand(rng, PB, PT, PKV, PHD), _rand(rng, PB, PT, PKV, PHD)
    bt = np.arange(PB * NB, dtype=np.int32).reshape(PB, NB)
    pos = np.broadcast_to(np.arange(40, 40 + PT, dtype=np.int32), (PB, PT)).copy()
    return q, k_new, v_new, pool_k, pool_v, bt, pos


def _j_paged_attention(q, k_new, v_new, pool_k, pool_v, bt, positions):
    """tests/test_paged_hlo.py's body: scatter through the table, gather
    the page view, attend under the position mask."""
    pool_k, pool_v = j_scatter_paged_kv(pool_k, pool_v, k_new, v_new, bt, positions)
    ck, cv = j_gather_pages(pool_k, pool_v, bt)
    return j_attention(q, ck, cv, mask=j_cache_mask(positions, NB * PS))


def _t_paged(args):
    q, k_new, v_new, pool_k, pool_v, bt, pos = (torch.from_numpy(x) for x in args)
    return _t_attend(_cpu_mesh(tp=2), q, k_new, v_new, pool_k, pool_v, pos, bt)


def test_tp_paged_gather_keeps_pool_shard_local():
    _, log = _t_paged(_paged_inputs())
    check(log, NoLargeAllGather(PAGED_SHARD_ELEMS, what="the paged KV pool shard"))


def test_tp_paged_numerics_match_unsharded():
    args = _paged_inputs()
    want = _j_paged_attention(*(jnp.asarray(x) for x in args))
    got, _ = _t_paged(args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # and the JAX body under GSPMD on its tp mesh
    jm = jmesh.make_mesh(2, tp=2)
    head, repl = NamedSharding(jm, P(None, None, "tp", None)), NamedSharding(jm, P())
    placed = [jax.device_put(jnp.asarray(x), sh) for x, sh in zip(args, [head] * 5 + [repl] * 2)]
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(_j_paged_attention)(*placed)), atol=TOL)


def _verify_inputs():
    rng = np.random.default_rng(3)
    ck, cv = _rand(rng, VB, VS, VKV, VHD), _rand(rng, VB, VS, VKV, VHD)
    q = _rand(rng, VB, VK + 1, VKV * VG, VHD)
    k_new, v_new = _rand(rng, VB, VK + 1, VKV, VHD), _rand(rng, VB, VK + 1, VKV, VHD)
    pos = np.broadcast_to(np.arange(40, 40 + VK + 1, dtype=np.int32), (VB, VK + 1)).copy()
    return q, k_new, v_new, ck, cv, pos


def _j_verify_attention(q, k_new, v_new, ck, cv, positions):
    """tests/test_spec_verify_hlo.py's body: write the k+1 rows at
    per-lane positions, attend with the position mask."""
    batch_idx = jnp.arange(VB)[:, None]
    ck = ck.at[batch_idx, positions].set(k_new)
    cv = cv.at[batch_idx, positions].set(v_new)
    return j_attention(q, ck, cv, mask=j_cache_mask(positions, VS))


def _t_verify(args):
    q, k_new, v_new, ck, cv, pos = (torch.from_numpy(x) for x in args)
    return _t_attend(_cpu_mesh(tp=2), q, k_new, v_new, ck, cv, pos)


def test_tp_verify_keeps_kv_shard_local():
    _, log = _t_verify(_verify_inputs())
    check(log, NoLargeAllGather(VERIFY_SHARD_ELEMS, what="the tp verify KV shard"))


def test_tp_verify_numerics_match_unsharded():
    args = _verify_inputs()
    want = _j_verify_attention(*(jnp.asarray(x) for x in args))
    got, _ = _t_verify(args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_supported_is_the_reference_check_per_shard():
    for name in tconfigs.list_configs():
        tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
        for tp in (1, 2, 4, 8):
            if jcfg.n_kv_heads % tp == 0:
                want = jcfg.n_kv_heads % tp == 0 and jcfg.head_dim == 128 and (
                    (jcfg.n_heads // tp) // (jcfg.n_kv_heads // tp) in (1, 2, 4, 8, 16)
                )
                assert flash_mesh.supported(tcfg, tp) == want, (name, tp)
    assert flash_mesh.supported(tconfigs.get_config("llama3-8b"), 2)
    assert flash_mesh.supported(tconfigs.get_config("llama3-8b"), 8)


# ---------------------------------------------------------------------------
# the model over a mesh


def test_tp_forward_matches_the_reference_tp_forward():
    """tests/test_parallel.py's case: the tp forward's logits (no cache)
    equal the reference's on its tp mesh, and the port's unsharded ones."""
    cfg = jconfigs.get_config("tiny")
    jparams = _jax_tree("tiny", False)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    positions = np.broadcast_to(np.arange(8, dtype=np.int32), (4, 8)).copy()
    jm = jmesh.make_mesh(8, tp=jmesh.pick_tp(cfg, 8))  # dp=4, tp=2
    sharded = jsharding.shard_params(jparams, jm)
    tok = jax.device_put(jnp.asarray(tokens), NamedSharding(jm, P("dp", None)))
    pos = jax.device_put(jnp.asarray(positions), NamedSharding(jm, P("dp", None)))
    want = np.asarray(jax.jit(lambda p, t, q: jl.forward(p, cfg, t, q, use_flash=False)[0])(sharded, tok, pos))
    tcfg = tconfigs.get_config("tiny")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tm = _cpu_mesh(tp=2)
    got = tl.forward(sharding.shard_params(tparams, tm), tcfg, torch.from_numpy(tokens),
                     torch.from_numpy(positions), mesh=tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    plain = tl.forward(tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)


def _moe_inputs():
    cfg = jconfigs.get_config("tiny-moe")
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 6, cfg.dim)) * 0.5).astype(np.float32)
    return cfg, x


@pytest.mark.parametrize("routed", [False, True], ids=["dense_fallback", "routed"])
@pytest.mark.parametrize("tp,ep", [(1, 2), (2, 2)])
def test_ep_moe_matches_the_reference(routed, tp, ep):
    """One MoE layer over ep-sharded experts (and tp-split widths): the
    port's per-shard impl against the reference's shard_map on its mesh."""
    cfg, x = _moe_inputs()
    jparams = _jax_tree("tiny-moe", False, seed=6)
    jlp = {k: jnp.asarray(np.asarray(jparams["layers"][k])[0]) for k in ("router", "w_gate", "w_up", "w_down")}
    jm = jmesh.make_mesh(tp * ep, tp=tp, ep=ep)
    if routed:
        want = jexpert.make_routed_moe(jm, cfg, capacity_factor=2.0)(jnp.asarray(x), jlp)
    else:
        want = jexpert.moe_expert_parallel(jnp.asarray(x), jlp, cfg, jm)
    tcfg = tconfigs.get_config("tiny-moe")
    tm = _cpu_mesh(tp, ep)
    shards = params_from_numpy(jax.tree.map(np.asarray, jparams), mesh=tm)
    lps = [{k: v[0] for k, v in sh["layers"].items()} for sh in shards]
    hs = [torch.from_numpy(x)] * tm.size
    with collectives.record() as log:
        if routed:
            got = expert.make_routed_moe(tm, tcfg, capacity_factor=2.0)(hs, lps)
        else:
            got = expert.moe_expert_parallel(hs, lps, tcfg, tm)
    assert [e["axes"] for e in log] == [("tp", "ep")]
    for g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_meshed_forward_records_the_layer_collectives():
    """A meshed forward's collective log: per layer one attention and one
    MLP all-reduce, the embedding's all-reduce, the logits' all-gather;
    the contracts hold at one shard's KV layer."""
    cfg = tconfigs.get_config("tiny")
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    tm = _cpu_mesh(tp=2)
    cache = tl.MeshCache.create(tm, lambda d: tl.KVCache.create(cfg, 2, 64, torch.float32, d, n_kv_heads=1))
    tokens = torch.randint(0, cfg.vocab_size, (2, 4), generator=torch.Generator().manual_seed(1))
    with collectives.record() as log:
        tl.forward(sharding.shard_params(params, tm), cfg, tokens, torch.arange(4).expand(2, 4), cache, mesh=tm)
    kinds = [e["kind"] for e in log]
    assert kinds == ["all_reduce"] * (1 + 2 * cfg.n_layers) + ["all_gather"]
    kv_layer = 2 * 65 * (cfg.n_kv_heads // 2) * cfg.head_dim
    check(log, NoLargeAllGather(kv_layer), HasCrossReduction())
    with pytest.raises(ValueError, match="moe_impl"):
        moe = tconfigs.get_config("tiny-moe")
        tl.forward(sharding.shard_params(tl.init_params(moe, torch.Generator().manual_seed(0),
                                                        dtype=torch.float32), tm),
                   moe, tokens, torch.arange(4).expand(2, 4), mesh=tm)


def test_routed_moe_is_the_one_device_form_at_ep_1():
    """ep = 1 (tp only): the routed impl is ``_moe_mlp_routed`` with base 0
    on every shard, summed over tp."""
    cfg = tconfigs.get_config("tiny-moe")
    params = tl.init_params(cfg, torch.Generator().manual_seed(2), dtype=torch.float32)
    x = torch.randn(2, 3, cfg.dim, generator=torch.Generator().manual_seed(3))
    lp = {k: v[0] for k, v in params["layers"].items()}
    want = tl._moe_mlp_routed(x, lp, cfg, capacity_factor=2.0)
    tm = _cpu_mesh(tp=2)
    lps = [{k: v[0] for k, v in sh["layers"].items()} for sh in sharding.shard_params(params, tm)]
    got = expert.make_routed_moe(tm, cfg, 2.0)([x, x], lps)
    torch.testing.assert_close(got[0], want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="must divide"):
        expert.make_routed_moe(_cpu_mesh(ep=3), cfg)
