"""The port's LLMEngine against the JAX LLMEngine on the CPU.

Both engines serve ``tiny`` in f32 with the SAME weights (the JAX
``init_params`` tree, carried over by ``params_from_numpy``) and the
reference configured as the port's slice is: ``prefix_cache=False``,
``speculative=False``, ``deadlines=False`` (the features' own parity tests
are tests/test_torch_prefix.py, test_torch_speculative.py and
test_torch_deadlines.py). Greedy tokens must be
identical: single requests, a concurrent mixed batch, a two-turn session
and a prompt longer than ``prefill_chunk``. Each engine is built once.
"""

import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.engine.llm import EngineShutdown
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(max_batch=4, max_seq=128, prefill_chunk=32, decode_chunk=8)


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jeng = JEngine(
        jcfg, jp, JTok(jcfg.vocab_size), **SHAPE,
        prefix_cache=False, speculative=False, deadlines=False,
    )
    teng = TEngine(
        tcfg, tp, TTok(tcfg.vocab_size), **SHAPE,
        prefix_cache=False, speculative=False, deadlines=False, device="cpu",
    )
    teng.warmup()
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def run(coro):
    return asyncio.run(coro)


def _tokens(results):
    return [r["tokens"] for r in results]


@pytest.mark.parametrize("prompt,max_tokens", [("hello", 10), ("the quick brown fox", 17)])
def test_single_request_tokens_match(engines, prompt, max_tokens):
    jeng, teng = engines
    want = run(jeng.generate(prompt, max_tokens=max_tokens, ignore_eos=True))
    got = run(teng.generate(prompt, max_tokens=max_tokens, ignore_eos=True))
    assert got["tokens"] == want["tokens"]
    assert got["completion_tokens"] == max_tokens
    assert got["prompt_tokens"] == want["prompt_tokens"]
    assert got["text"] == want["text"]
    assert got["ttft_ms"] > 0 and set(got["ttft_breakdown"]) == set(want["ttft_breakdown"])


def test_concurrent_mixed_batch_matches(engines):
    jeng, teng = engines
    reqs = [("msg zero", 3), ("a second message", 9), ("third", 6), ("and the fourth one", 12)]

    async def batch(eng):
        return await asyncio.gather(
            *(eng.generate(p, max_tokens=m, ignore_eos=True) for p, m in reqs)
        )

    before = teng.decode_steps
    got = run(batch(teng))
    assert _tokens(got) == _tokens(run(batch(jeng)))
    assert [r["completion_tokens"] for r in got] == [m for _, m in reqs]
    assert teng.decode_steps > before


def test_two_turn_session_matches(engines):
    jeng, teng = engines

    async def turns(eng):
        a = await eng.chat("sess-two", "first turn", max_tokens=6, ignore_eos=True)
        b = await eng.chat("sess-two", "second turn", max_tokens=7, ignore_eos=True)
        return a, b

    got = run(turns(teng))
    assert _tokens(got) == _tokens(run(turns(jeng)))
    slot = teng.slots[teng.sessions["sess-two"]]
    assert slot.position > len("first turn") + len("second turn")  # KV kept across turns


def test_prompt_longer_than_prefill_chunk_matches(engines):
    jeng, teng = engines
    prompt = "a long prompt that spans several prefill chunks " * 2  # 97 tokens
    assert len(teng.tokenizer.encode(prompt)) > 2 * SHAPE["prefill_chunk"]
    want = run(jeng.generate(prompt, max_tokens=8, ignore_eos=True))
    got = run(teng.generate(prompt, max_tokens=8, ignore_eos=True))
    assert got["tokens"] == want["tokens"]


def test_request_id_memo_and_metrics(engines):
    _, teng = engines
    r1 = run(teng.generate("idem", max_tokens=4, request_id="req-1"))
    n = teng.tokens_generated
    r2 = run(teng.generate("idem", max_tokens=4, request_id="req-1"))
    assert r2["tokens"] == r1["tokens"] and r2["replayed"] is True
    assert teng.tokens_generated == n
    m = teng.metrics()
    assert m["device"] == "cpu" and m["tokens_generated"] >= 4
    assert m["prefix_cache"] is False and m["speculative"] is False
    assert m["worker_errors"] == 0


def test_create_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: create() would build a real engine")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine.create("tiny")


def test_engine_init_needs_a_card_unless_the_cpu_is_asked_for():
    """The constructor defaults to the card too, and raises as create()
    does when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the constructor would build a real engine")
    from agentainer_tpu_torch.models.llama import init_params

    cfg = tconfigs.get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(cfg, params, TTok(cfg.vocab_size), max_batch=1, max_seq=64)


def test_card_engine_refuses_a_head_the_kernels_do_not_take(monkeypatch):
    """With a card, a model whose attention head the kernels do not take
    (tiny: head_dim 16) is refused up front rather than served through plain
    attention; llama3-8b's head is taken."""
    from agentainer_tpu_torch.engine.llm import _engine_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no attention kernel"):
        _engine_device("cuda", tconfigs.get_config("tiny"))
    assert _engine_device("cuda", tconfigs.get_config("llama3-8b")).type == "cuda"
    assert _engine_device("cpu", tconfigs.get_config("tiny")).type == "cpu"


@pytest.mark.parametrize(
    "options,match",
    [
        # prefix_cache, speculative, paged_kv, fused_decode and kv_tiering
        # are ported: asked beside the unported routed option, only that one
        # is named
        pytest.param(
            {"prefix_cache": True, "fused_decode": True, "routed": True}, "yet: routed$",
            id="options0-prefix_cache",
        ),
        pytest.param(
            {"speculative": True, "paged_kv": True, "kv_tiering": True, "routed": True},
            "yet: routed$", id="options1-speculative, paged_kv",
        ),
        # streaming and approx_topk are ported too
        pytest.param(
            {"streaming": True, "kv_tiering": True, "tier_quantize": 0, "routed": True},
            "yet: routed$", id="options2-streaming",
        ),
        ({"tp": 2}, "tp=2"),
        # int8 serving is ported: another scheme, and int8 beside an
        # unported axis, still raise
        pytest.param({"quant": "int4"}, "unknown quant scheme 'int4'", id="options4-quant"),
        pytest.param(
            {"approx_topk": True, "fused_decode": True, "inloop_spec": False, "routed": True},
            "yet: routed$", id="options5-approx_topk",
        ),
        pytest.param(
            {"quant": "int8", "synthetic": True, "tp": 2}, "tp=2", id="options6-synthetic"
        ),
        ({"routed": True}, "routed"),
    ],
)
def test_create_rejects_unported_options(options, match):
    with pytest.raises(ValueError, match=match):
        TEngine.create("tiny", options={"device": "cpu", **options})


def test_create_on_cpu_serves():
    eng = TEngine.create("tiny", options={"device": "cpu", "max_batch": 2, "max_seq": 64, "seed": 3})
    try:
        assert eng.params["embed"].dtype == torch.float32
        r = run(eng.generate("hi", max_tokens=5, ignore_eos=True))
        assert r["completion_tokens"] == 5
        assert eng.metrics()["tokens_generated"] == 5  # warmup telemetry dropped
    finally:
        eng.shutdown()


def _dead_worker_engine():
    """A tiny CPU engine whose worker thread died of an unexpected fault."""
    from agentainer_tpu_torch.models.llama import init_params

    cfg = tconfigs.get_config("tiny")
    g = torch.Generator().manual_seed(0)
    eng = TEngine(cfg, init_params(cfg, g, dtype=torch.float32), TTok(cfg.vocab_size),
                  max_batch=1, max_seq=64, device="cpu")

    def boom(block_s):
        raise RuntimeError("injected worker fault")

    eng._pump_queue = boom
    eng._worker.join(timeout=10)
    assert not eng._worker.is_alive()
    return eng


def test_dead_worker_fails_waiters_instead_of_hanging():
    """An unexpected fault that kills the worker thread must fail every
    queued and later request (EngineShutdown), never leave it waiting."""
    eng = _dead_worker_engine()
    with pytest.raises(EngineShutdown):
        run(asyncio.wait_for(eng.generate("hi", max_tokens=2), timeout=10))
    assert "injected worker fault" in eng.last_worker_error
    eng.shutdown()


def test_warmup_on_a_dead_worker_raises_instead_of_hanging():
    """Warmup queues its requests without the API's up-front check: work
    queued after the worker's final drain must still fail, so a worker that
    dies while the engine loads surfaces from create() at once."""
    eng = _dead_worker_engine()
    box = []

    def _warm():
        try:
            eng.warmup()
        except BaseException as e:
            box.append(e)

    t = threading.Thread(target=_warm, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "warmup hung on a dead worker"
    assert len(box) == 1 and isinstance(box[0], EngineShutdown)
    eng.shutdown()
