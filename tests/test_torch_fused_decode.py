"""The port's fused decode loop against the JAX package's on the CPU.

Mirrors ``tests/test_fused_decode.py`` (every test there has a counterpart
here under its name): both engines serve ``tiny`` in f32 with the SAME
weights (the JAX ``init_params`` tree through ``params_from_numpy``) and the
reference's default features, and every greedy stream of the port's fused
engine must equal the JAX engine's — solo, mixed batch, paged, with
speculation (in the loop and between loops), ``max_tokens`` at the loop
boundary, EOS in the loop and at the first step, ``ignore_eos``, a lane
injected into a running loop, snapshot/restore. Beside them: the in-loop
drafter held against the reference's on seeded random histories, and one
loop's packed readback, carry and KV held against the reference's jitted
``_fused_fn`` on a carry built from numpy.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import KVCache as JKVCache
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.engine.llm import FUSED_HIST_W, FUSED_SPEC_K, draft_from_hist
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

OPTS = {"max_batch": 4, "max_seq": 128, "decode_chunk": 4}
JSON_LOOP = '{"tool": "search", "args": {"q": "w", "n": 5}}\n' * 4


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def make(weights, side: str, eos: int | None = None, **opts):
    """One engine of either package over the shared weights, built as the
    reference's ``create`` builds it (its default features) without warmup;
    ``eos`` pins the tokenizer's EOS before anything is traced."""
    jcfg, jp, tp = weights
    kw = dict(OPTS, **opts)
    if side == "jax":
        eng = JEngine(jcfg, jp, JTok(jcfg.vocab_size), **kw)
    else:
        tcfg = tconfigs.get_config("tiny")
        eng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **kw, device="cpu")
    if eos is not None:
        eng.tokenizer.eos_id = eos
    return eng


@pytest.fixture(scope="module")
def engines(weights):
    """JAX unfused and fused, port unfused and fused."""
    engs = {
        (side, fused): make(weights, side, fused_decode=fused)
        for side in ("jax", "torch")
        for fused in (False, True)
    }
    yield engs
    for e in engs.values():
        e.shutdown()


def test_fused_flag_is_reported(engines):
    assert engines["torch", False].metrics()["fused_decode"] is False
    assert engines["torch", True].metrics()["fused_decode"] is True
    assert engines["torch", True].inloop_spec is True  # speculative is on by default


def test_greedy_bit_exact_solo(engines):
    want = run(engines["jax", True].generate("hello fused world", max_tokens=12))
    got = run(engines["torch", True].generate("hello fused world", max_tokens=12))
    base = run(engines["torch", False].generate("hello fused world", max_tokens=12))
    assert got["tokens"] == want["tokens"] == base["tokens"]
    assert got["completion_tokens"] == want["completion_tokens"]


def test_greedy_bit_exact_mixed_batch(engines):
    prompts = ["a", "bb longer prompt", "ccc", "dddd even longer prompt here"]

    async def batch(eng):
        return await asyncio.gather(*(eng.generate(p, max_tokens=10) for p in prompts))

    want = run(batch(engines["jax", True]))
    got = run(batch(engines["torch", True]))
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]


def test_fused_loop_counters_move(engines):
    eng = engines["torch", True]
    run(eng.generate("count my loops", max_tokens=9))
    m = eng.metrics()
    assert m["fused_loops_total"] > 0
    assert m["fused_steps_total"] > 0
    assert m["host_syncs_per_token"] is not None
    assert sum(m["fused_exit_reason_hist"].values()) == m["fused_loops_total"]
    # one readback per loop: every sync is a first token or a loop
    assert m["host_syncs_total"] == m["prefills"] + m["fused_loops_total"]


def test_greedy_bit_exact_paged(weights, engines):
    eng = make(weights, "torch", fused_decode=True, paged_kv=True)
    try:
        want = run(engines["jax", False].generate("paged fused parity", max_tokens=12))
        got = run(eng.generate("paged fused parity", max_tokens=12))
        assert got["tokens"] == want["tokens"]
        assert eng.metrics()["fused_loops_total"] > 0
    finally:
        eng.shutdown()


def test_greedy_bit_exact_with_speculation(weights, engines):
    """Host-side speculation composed between fused loops (in-loop spec
    off) gives the plain greedy stream."""
    eng = make(weights, "torch", fused_decode=True, inloop_spec=False)
    try:
        assert eng.inloop_spec is False and eng.speculative is True
        want = run(engines["jax", False].generate("speculate then fuse", max_tokens=14))
        got = run(eng.generate("speculate then fuse", max_tokens=14))
        assert got["tokens"] == want["tokens"]
        json_want = run(engines["jax", False].generate(JSON_LOOP, max_tokens=20))
        json_got = run(eng.generate(JSON_LOOP, max_tokens=20))
        assert json_got["tokens"] == json_want["tokens"]
        assert eng.metrics()["spec_rounds"] > 0
    finally:
        eng.shutdown()


def test_max_tokens_at_loop_boundary(engines):
    for n in (4, 8, 5, 3, 1, 17, 18):
        want = run(engines["jax", True].generate("boundary", max_tokens=n, ignore_eos=True))
        got = run(engines["torch", True].generate("boundary", max_tokens=n, ignore_eos=True))
        assert got["tokens"] == want["tokens"]
        assert got["completion_tokens"] == want["completion_tokens"] == n


def test_temperature_stream_deterministic_per_engine_seed(weights, engines):
    """Sampled lanes draw a loop's uniforms before it starts, so two fresh
    engines with one seed draw the same tokens, and every stream has its
    length (the JAX package's threefry stream cannot be matched)."""
    kw = dict(max_tokens=8, temperature=0.9, top_k=8, top_p=0.9)
    got = run(engines["torch", True].generate("sample me", **kw))
    assert len(got["tokens"]) == got["completion_tokens"]
    streams = []
    for _ in range(2):
        eng = make(weights, "torch", fused_decode=True)
        try:
            streams.append(run(eng.generate("sample me", max_tokens=20, temperature=0.9))["tokens"])
        finally:
            eng.shutdown()
    assert streams[0] == streams[1]


def _eos_pairs(weights, eos_tok, **opts):
    """The JAX and port fused engines with EOS pinned to a token the tiny
    model emits (the only way to reach in-loop EOS with random weights),
    and the port's unfused one."""
    return (
        make(weights, "jax", eos=eos_tok, fused_decode=True, **opts),
        make(weights, "torch", eos=eos_tok, fused_decode=True, **opts),
        make(weights, "torch", eos=eos_tok, fused_decode=False, **opts),
    )


def test_eos_in_loop_and_at_first_step(weights, engines):
    ref = run(engines["jax", False].generate("stop early", max_tokens=8, ignore_eos=True))
    # eos = the 2nd generated token: the loop's first iteration trips the
    # lane's EOS mask; eos = the 1st: the finish before any loop runs
    for eos_tok in (int(ref["tokens"][1]), int(ref["tokens"][0])):
        engs = _eos_pairs(weights, eos_tok)
        try:
            want, got, base = (run(e.generate("stop early", max_tokens=8)) for e in engs)
            assert got["tokens"] == want["tokens"] == base["tokens"]
            assert got["completion_tokens"] == want["completion_tokens"] < 8
            assert int(got["tokens"][-1]) == eos_tok
        finally:
            for e in engs:
                e.shutdown()


def test_eos_early_exit_is_counted(weights, engines):
    ref = run(engines["jax", False].generate("count exits", max_tokens=8, ignore_eos=True))
    engs = _eos_pairs(weights, int(ref["tokens"][1]))
    try:
        want = run(engs[0].generate("count exits", max_tokens=8))
        got = run(engs[1].generate("count exits", max_tokens=8))
        assert got["tokens"] == want["tokens"]
        m = engs[1].metrics()
        assert m["fused_early_exits_total"] > 0
        assert m["fused_exit_reason_hist"].get("early_all_finished", 0) > 0
        assert m["fused_early_exits_total"] == engs[0].metrics()["fused_early_exits_total"]
    finally:
        for e in engs:
            e.shutdown()


def test_ignore_eos_honored_in_loop(weights, engines):
    ref = run(engines["jax", False].generate("ignore me", max_tokens=8, ignore_eos=True))
    engs = _eos_pairs(weights, int(ref["tokens"][1]))
    try:
        want, got, base = (
            run(e.generate("ignore me", max_tokens=8, ignore_eos=True)) for e in engs
        )
        assert got["tokens"] == want["tokens"] == base["tokens"] == ref["tokens"]
        assert got["completion_tokens"] == 8
    finally:
        for e in engs:
            e.shutdown()


def test_inloop_vs_hostside_spec_token_identical(weights):
    """The in-loop drafter and the host-side drafter give the same greedy
    stream as the JAX in-loop engine, and only the in-loop engine drafts
    without host rounds."""
    host = make(weights, "torch", fused_decode=True, inloop_spec=False)
    dev = make(weights, "torch", fused_decode=True, inloop_spec=True)
    jdev = make(weights, "jax", fused_decode=True, inloop_spec=True)
    try:
        assert host.inloop_spec is False and dev.inloop_spec is True
        for prompt, n in ((JSON_LOOP, 24), ("plain prose prompt", 12)):
            want = run(jdev.generate(prompt, max_tokens=n))
            a = run(host.generate(prompt, max_tokens=n))
            b = run(dev.generate(prompt, max_tokens=n))
            assert a["tokens"] == b["tokens"] == want["tokens"]
        m, jm = dev.metrics(), jdev.metrics()
        assert m["inloop_spec"] is True
        assert m["inloop_spec_drafted"] > 0
        assert 0 <= m["inloop_spec_accepted"] <= m["inloop_spec_drafted"]
        assert (m["inloop_spec_drafted"], m["inloop_spec_accepted"]) == (
            jm["inloop_spec_drafted"], jm["inloop_spec_accepted"],
        )
        assert m["spec_rounds"] == 0
    finally:
        for e in (host, dev, jdev):
            e.shutdown()


def test_inloop_spec_matches_nonspec_greedy(weights, engines):
    eng = make(weights, "torch", fused_decode=True, paged_kv=True)
    try:
        assert eng.inloop_spec is True
        for prompt in (JSON_LOOP, "speculate then fuse"):
            want = run(engines["jax", False].generate(prompt, max_tokens=14))
            got = run(eng.generate(prompt, max_tokens=14))
            assert got["tokens"] == want["tokens"]
        assert eng.metrics()["inloop_spec_drafted"] > 0
    finally:
        eng.shutdown()


def _staggered(eng, n_long=28, n_late=8):
    """One long generation, then a late arrival that prefills while the
    first lane's loops are in flight."""

    async def body():
        t1 = asyncio.create_task(eng.generate("spin spin spin", max_tokens=n_long))
        await asyncio.sleep(0.05)
        t2 = asyncio.create_task(eng.generate("late arrival", max_tokens=n_late))
        return await asyncio.gather(t1, t2)

    return run(body())


def test_lane_injection_mid_loop_token_identical(weights, engines):
    """A lane staged into a running loop gives the streams of the
    exit-and-redispatch path and of the JAX engine."""
    want = _staggered(engines["jax", True])
    inj = make(weights, "torch", fused_decode=True)
    ref = make(weights, "torch", fused_decode=True)
    ref._fused_inject = False
    try:
        for _ in range(6):
            got = _staggered(inj)
            plain = _staggered(ref)
            assert [g["tokens"] for g in got] == [p["tokens"] for p in plain]
            assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
            if inj.metrics()["fused_injections_total"] > 0:
                break
        assert inj.metrics()["fused_injections_total"] > 0
        assert ref.metrics()["fused_injections_total"] == 0
    finally:
        inj.shutdown()
        ref.shutdown()


def test_injection_disabled_engine_reports_zero(weights):
    eng = make(weights, "torch", fused_decode=True)
    eng._fused_inject = False
    try:
        got = _staggered(eng)
        assert all(r["completion_tokens"] > 0 for r in got)
        m = eng.metrics()
        assert m["fused_injections_total"] == 0
        assert m["fused_inject_fallbacks_total"] == 0
    finally:
        eng.shutdown()


def test_snapshot_restore_token_identical(weights):
    """Fused port engine -> snapshot -> fresh fused port engine -> restore
    -> continue equals the JAX unfused engines doing the same."""
    opts = {"max_batch": 2}

    def one(side, fused):
        async def body():
            e1 = make(weights, side, fused_decode=fused, **opts)
            try:
                first = await e1.chat("s", "turn one", max_tokens=6)
                blob = await e1.snapshot_session("s")
            finally:
                e1.shutdown()
            e2 = make(weights, side, fused_decode=fused, **opts)
            try:
                assert await e2.restore_session("s", blob) is True
                second = await e2.chat("s", "turn two", max_tokens=6)
            finally:
                e2.shutdown()
            return first["tokens"], second["tokens"]

        return run(body())

    assert one("torch", True) == one("jax", False)


@pytest.mark.parametrize(
    "opts", [{}, {"paged_kv": True}, {"speculative": False}], ids=["dense", "paged", "no-spec"]
)
def test_two_turns_across_several_loops_match(weights, engines, opts):
    """A turn longer than one loop, with each loop dispatched while the one
    before it is in flight (readbacks land only when waited for), leaves the
    session at the unfused engine's position, and the next turn continues
    token for token. With in-loop spec a loop emits more tokens than it
    runs iterations; without it, fewer than its budget (the host's upper
    bound), which the reference's host position keeps as an overshoot."""

    def position(eng):
        if eng.paged:
            return eng.paged_sessions["long"].position
        return eng.slots[eng.sessions["long"]].position

    async def turns(eng):
        a = await eng.chat("long", "ab ab ab ab ab ab", max_tokens=70, ignore_eos=True)
        at = position(eng)
        b = await eng.chat("long", "second turn", max_tokens=10, ignore_eos=True)
        return a["tokens"], at, b["tokens"]

    eng = make(weights, "torch", fused_decode=True, max_seq=256, **opts)
    eng._landed = lambda event: False
    try:
        got = run(turns(eng))
        m = eng.metrics()
        assert m["fused_loops_total"] >= 3
        assert (m["inloop_spec_accepted"] > 0) == eng.inloop_spec
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()
    ref = make(weights, "jax", fused_decode=False, max_seq=256)
    try:
        assert got == run(turns(ref))
    finally:
        ref.shutdown()


# -- the in-loop drafter and one loop against the reference's ---------------

W, K = FUSED_HIST_W, FUSED_SPEC_K


def _reference_draft(hist, hlen):
    """The reference's ``draft_from_hist`` (agentainer_tpu/engine/llm.py,
    inside ``_fused_fn``), as written there."""
    d3_vals = jnp.arange(1, W - 2, dtype=jnp.int32)
    idx3 = (W - 3 - d3_vals)[:, None] + jnp.arange(3)[None, :]
    d2_vals = jnp.arange(1, W - 1, dtype=jnp.int32)
    idx2 = (W - 2 - d2_vals)[:, None] + jnp.arange(2)[None, :]
    tail3 = hist[:, W - 3:]
    win3 = hist[:, idx3]
    m3 = jnp.all(win3 == tail3[:, None, :], -1) & (hlen[:, None] >= d3_vals[None, :] + 3)
    any3 = jnp.any(m3, 1)
    dstar3 = d3_vals[jnp.argmax(m3, 1)]
    tail2 = hist[:, W - 2:]
    win2 = hist[:, idx2]
    m2 = jnp.all(win2 == tail2[:, None, :], -1) & (hlen[:, None] >= d2_vals[None, :] + 2)
    any2 = jnp.any(m2, 1)
    dstar2 = d2_vals[jnp.argmax(m2, 1)]
    dstar = jnp.where(any3, dstar3, dstar2)
    exists = any3 | any2
    gidx = jnp.minimum((W - dstar)[:, None] + jnp.arange(K)[None, :], W - 1)
    drafts = jnp.take_along_axis(hist, gidx, axis=1)
    return exists, dstar, drafts


@pytest.mark.parametrize("seed", range(4))
def test_draft_from_hist_matches_reference(seed):
    """Seeded histories over a small alphabet (repeats: 3-gram and 2-gram
    matches at many distances), with lengths from 0 (hlen < 3 included) to
    W, and one lane of distinct tokens (no match)."""
    g = np.random.default_rng(seed)
    b = 16
    hist = g.integers(0, 5 + seed, size=(b, W)).astype(np.int32)
    hist[0] = np.arange(W)  # no repeat anywhere
    hlen = g.integers(0, W + 1, size=(b,)).astype(np.int32)
    hlen[1:4] = (0, 1, 2)
    want = _reference_draft(jnp.asarray(hist), jnp.asarray(hlen))
    got = draft_from_hist(torch.from_numpy(hist).long(), torch.from_numpy(hlen).long(), K)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), t.numpy())
    assert not bool(got[0][0]) and not bool(got[0][1]) and not bool(got[0][2])


@pytest.mark.parametrize("nsteps", [1, 6, 16])
def test_one_loop_matches_the_reference_fused_fn(weights, nsteps):
    """One loop of the port's fused engine against the reference's jitted
    ``_fused_fn`` on the same carry, KV and inputs (built from numpy):
    greedy lanes at mixed positions with repeating histories (the in-loop
    drafter fires), one lane armed from the shadow carry, one lane with a
    small budget, one parked. The packed readback (the reference's
    [cap + 6, B] rows), the carry, the history and the KV agree."""
    jeng = make(weights, "jax", fused_decode=True)
    teng = make(weights, "torch", fused_decode=True)
    try:
        cap, b, s = teng._fused_cap, 4, OPTS["max_seq"]
        scratch = s - 1
        g = np.random.default_rng(nsteps)
        cfg = teng.cfg
        kshape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        kk = (0.5 * g.standard_normal(kshape)).astype(np.float32)
        vv = (0.5 * g.standard_normal(kshape)).astype(np.float32)
        tok = g.integers(0, 8, size=b).astype(np.int32)
        pos = np.array([20, 37, 50, scratch], dtype=np.int32)
        hist = np.tile(np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int32), (b, W // 8))
        hist[:, -1] = tok
        hlen = np.array([W, 30, 2, 0], dtype=np.int32)
        stok, spos = tok.copy(), np.full(b, scratch, np.int32)
        stok[2], spos[2] = 7, 44
        shist, shlen = hist.copy(), np.zeros(b, np.int32)
        shlen[2] = 40
        zeros_f, ones_f, zeros_i = np.zeros(b, np.float32), np.ones(b, np.float32), np.zeros(b, np.int32)
        armed = np.array([False, False, True, False])
        live = np.array([True, True, True, False])
        budgets = np.array([cap + 1, 3, cap + 1, 0], dtype=np.int32)
        ign = np.zeros(b, bool)

        out = jeng._fused_fn()(
            jeng.params, JKVCache(k=jnp.asarray(kk), v=jnp.asarray(vv)),
            *(jnp.asarray(x) for x in (tok, pos, zeros_f, zeros_i, ones_f, hist, hlen)),
            *(jnp.asarray(x) for x in (stok, spos, zeros_f, zeros_i, ones_f, shist, shlen)),
            *(jnp.asarray(x) for x in (armed, live, budgets, ign)),
            jax.random.split(jax.random.PRNGKey(0), cap), jnp.int32(nsteps),
        )
        jpacked, jtok, jpos, *_, jhist, jhlen, jcache = out

        with torch.no_grad():
            for t, x in (
                (teng._dtok, tok), (teng._dpos, pos), (teng._dhist, hist), (teng._dhlen, hlen),
                (teng._stok, stok), (teng._spos, spos), (teng._shist, shist), (teng._shlen, shlen),
            ):
                t.copy_(torch.from_numpy(x).to(t.dtype))
            teng.cache.k.copy_(torch.from_numpy(kk))
            teng.cache.v.copy_(torch.from_numpy(vv))
            meta = np.concatenate([armed, live, budgets, ign, [nsteps]]).astype(np.int64)
            teng._finput.copy_(torch.from_numpy(meta))
            packed = teng._fused_steps(True).numpy()

        rows = cap + 6
        np.testing.assert_array_equal(packed[:rows], np.asarray(jpacked))
        assert packed[rows, 0] <= packed[cap + 3, 0]  # verify iterations <= iterations
        np.testing.assert_array_equal(teng._dtok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(teng._dpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(teng._dhist.numpy(), np.asarray(jhist))
        np.testing.assert_array_equal(teng._dhlen.numpy(), np.asarray(jhlen))
        np.testing.assert_allclose(teng.cache.k.numpy(), np.asarray(jcache.k), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(teng.cache.v.numpy(), np.asarray(jcache.v), rtol=2e-5, atol=2e-5)
        if nsteps == 16:
            assert packed[cap + 5, 0] > 0  # drafted somewhere
    finally:
        jeng.shutdown()
        teng.shutdown()
