"""The port's dispatch-ahead readback pipeline against the JAX engine, on the
CPU.

Engines serve ``tiny`` in f32 with the same weights (the JAX
``init_params`` tree through ``params_from_numpy``), speculation and
deadlines on, the prefix cache off (each traffic run then starts from the
same engine state), over the dense and the paged arena. On the CPU the
port's events are stand-ins that report every copy as landed; the JAX
engine is made to match by waiting for each readback's value right after
its dispatch, so both pipelines run the same schedule and the lag shows
only as late processing.

The lag traffic, every step of it set off from inside the worker at a fixed
point of the schedule (never by the wall clock): three requests queued at
once — a JSON tool loop that speculates right after its first decode chunk,
a plain request, a long one — with ``max_tokens`` that no chunk size
divides; a newcomer submitted once the loop has 5 tokens, while lanes
decode; the long request cancelled once it has 9 tokens. Held here:

- greedy tokens, ``tokens_generated`` and ``host_syncs_total`` equal the
  JAX engine's;
- with readiness reporting "not landed" until a wait is forced, the FIFO
  never holds more than ``_PIPELINE_DEPTH + 1`` entries and the tokens are
  the same;
- the carry, the verify inputs and the block table keep their
  ``data_ptr()`` through chunks, verify rounds, injections and parks;
- one host sync per readback that crosses: first tokens, decode chunks and
  verify rounds.
"""

import asyncio
import collections
import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine import llm as jllm
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.engine import llm as tllm
from agentainer_tpu_torch.engine.graphs import KERNEL_WRAPPERS, LANDED, HostTransfers, StepGraphs
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.ops import cuda_attention as ca

SHAPE = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=32, prefix_cache=False)
PAGED = dict(paged_kv=True, page_size=16)
ARENAS = {"dense": {}, "paged": PAGED}
# adaptive_decode off is the reference's fixed-cadence baseline: forced
# waits block without admitting
CASES = [(arena, adaptive) for arena in ARENAS for adaptive in (True, False)]
JSON_LOOP = '{"tool": "search", "args": {"q": "w", "n": 5}}\n' * 4
# (name, prompt, max_tokens): none a multiple of any decode-ladder rung
LAG_TRAFFIC = (
    ("loop", JSON_LOOP + "go", 21),
    ("plain", "a plain request beside it", 13),
    ("long", "a long request that is cancelled", 150),
)
NEWCOMER = ("newcomer", "a newcomer while lanes decode", 11)
NEWCOMER_AFTER, CANCEL_AFTER = 5, 9


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _port(weights, arena: str, adaptive: bool = True):
    _, _, tcfg, tp = weights
    eng = tllm.LLMEngine(
        tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, **ARENAS[arena], adaptive_decode=adaptive,
        device="cpu",
    )
    eng.warmup()
    return eng


def _landed_at_dispatch(eng) -> None:
    """Make the JAX engine's readbacks ready when dispatched, as the port's
    stand-in events are: wait for every queued readback's value after each
    prefill tick and decode dispatch."""
    for name in ("_prefill_tick", "_decode_dispatch"):
        fn = getattr(eng, name)

        def waited(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            for e in list(eng._readbacks):
                jax.block_until_ready(e[3] if e[0] == "first" else e[2])
            return out

        setattr(eng, name, waited)


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The lag traffic through a fresh JAX engine per case."""
    jcfg, jp, _, _ = weights
    out = {}
    for arena, adaptive in CASES:
        eng = jllm.LLMEngine(
            jcfg, jp, JTok(jcfg.vocab_size), **SHAPE, **ARENAS[arena], adaptive_decode=adaptive
        )
        try:
            _landed_at_dispatch(eng)
            out[arena, adaptive] = _lag_traffic(eng, jllm.GenRequest)
        finally:
            eng.shutdown()
    return out


def _submit_together(eng, reqs) -> None:
    """Queue every request in one step, so the worker takes them in one
    pump whatever the timing."""
    q = eng._queue
    with q.mutex:
        q.queue.extend(reqs)
        q.unfinished_tasks += len(reqs)
        q.not_empty.notify()


def _lag_traffic(eng, request_cls) -> dict:
    """The module's lag traffic; returns the tokens of the requests that
    complete, whether the long one was cancelled, and the deltas of
    ``tokens_generated`` and ``host_syncs_total``."""

    async def body():
        loop = asyncio.get_running_loop()

        def make(name, prompt, max_tokens):
            return request_cls(
                id=name, session="", prompt_ids=eng.tokenizer.encode(prompt),
                max_tokens=max_tokens, temperature=0.0, loop=loop, future=loop.create_future(),
                ignore_eos=True,
            )

        reqs = {name: make(name, p, m) for name, p, m in LAG_TRAFFIC}
        newcomer = make(*NEWCOMER)
        fired = set()
        process_chunk = eng._process_chunk

        def hooked(entry):
            process_chunk(entry)
            if "new" not in fired and len(reqs["loop"].generated) >= NEWCOMER_AFTER:
                fired.add("new")
                eng._queue.put(newcomer)
            if "cancel" not in fired and len(reqs["long"].generated) >= CANCEL_AFTER:
                fired.add("cancel")
                eng.cancel("long")

        eng._process_chunk = hooked
        try:
            _submit_together(eng, list(reqs.values()))
            done = await asyncio.wait_for(
                asyncio.gather(*(r.future for r in (*reqs.values(), newcomer)), return_exceptions=True),
                timeout=120,
            )
        finally:
            del eng._process_chunk
        return dict(zip([*reqs, "newcomer"], done)), fired

    tokens0, syncs0 = eng.tokens_generated, eng.host_syncs_total
    done, fired = asyncio.run(body())
    assert fired == {"new", "cancel"}
    return {
        "tokens": {k: v["tokens"] for k, v in done.items() if not isinstance(v, BaseException)},
        "cancelled": type(done["long"]).__name__,
        "tokens_generated": eng.tokens_generated - tokens0,
        "host_syncs": eng.host_syncs_total - syncs0,
    }


class _DepthLog(collections.deque):
    """The readback FIFO, recording the most entries it ever held."""

    most = 0

    def append(self, x):
        super().append(x)
        self.most = max(self.most, len(self))


@pytest.mark.parametrize("arena,adaptive", CASES)
def test_lag_traffic_tokens_and_counts_match_jax(weights, jax_runs, arena, adaptive):
    want = jax_runs[arena, adaptive]
    eng = _port(weights, arena, adaptive)
    try:
        rounds = eng.spec_rounds
        got = _lag_traffic(eng, tllm.GenRequest)
        assert eng.spec_rounds > rounds  # the loop speculated
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()
    assert set(got["tokens"]) == {"loop", "plain", "newcomer"}
    assert [len(got["tokens"][n]) for n in ("loop", "plain", "newcomer")] == [21, 13, 11]
    assert got["cancelled"] == "RequestCancelled" and want["cancelled"] == "RequestCancelled"
    assert got["tokens"] == want["tokens"]
    assert got["tokens_generated"] == want["tokens_generated"]
    assert got["host_syncs"] == want["host_syncs"]


@pytest.mark.parametrize("arena,adaptive", CASES)
def test_fifo_stays_within_depth_when_nothing_lands_until_forced(weights, jax_runs, arena, adaptive):
    """Readiness reports "not landed" until a wait is forced: the worker
    processes an entry only when the FIFO is deeper than the depth, when
    nothing else is dispatchable, or before a verify round; the FIFO never
    holds more than depth + 1 entries, and every token is the same."""
    eng = _port(weights, arena, adaptive)
    eng._landed = lambda event: False
    eng._readbacks = _DepthLog()
    try:
        got = _lag_traffic(eng, tllm.GenRequest)
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()
    assert eng._readbacks.most == eng._PIPELINE_DEPTH + 1
    assert got["tokens"] == jax_runs[arena, adaptive]["tokens"]


@pytest.mark.parametrize("arena", list(ARENAS))
def test_carry_keeps_its_addresses(weights, arena):
    """Every device buffer a step graph replays by address — the carry, the
    verify inputs and the device block table — is written in place through
    decode chunks, verify rounds, first-token injections and parks."""
    eng = _port(weights, arena)
    try:
        buffers = {
            "tok": eng._dtok, "pos": eng._dpos, "temps": eng._dtemps, "topk": eng._dtopk,
            "topp": eng._dtopp, "dlen": eng._vdlen, "table": eng._dbt,
            **{f"drafts{k}": t for k, t in eng._vdrafts.items()},
        }
        ptrs = {k: (v.data_ptr() if v is not None else None) for k, v in buffers.items()}
        steps, rounds, prefills = eng.decode_steps, eng.spec_rounds, eng.prefills
        _lag_traffic(eng, tllm.GenRequest)
        assert eng.decode_steps - steps > eng.spec_rounds - rounds > 0  # chunks and rounds
        assert eng.prefills - prefills == 4 and eng.cancelled_total == 1  # injections, parks
        now = {
            "tok": eng._dtok, "pos": eng._dpos, "temps": eng._dtemps, "topk": eng._dtopk,
            "topp": eng._dtopp, "dlen": eng._vdlen, "table": eng._dbt,
            **{f"drafts{k}": t for k, t in eng._vdrafts.items()},
        }
        assert {k: (v.data_ptr() if v is not None else None) for k, v in now.items()} == ptrs
        assert (buffers["table"] is not None) == (arena == "paged")
        # every lane parked again, at the scratch position
        assert eng._dpos.tolist() == [eng.scratch_pos] * eng.max_batch
    finally:
        eng.shutdown()


def test_one_host_sync_per_crossing(weights):
    """Sequential requests with no stale entry: one sync per first token,
    per decode chunk and per verify round, i.e. prefills + decode steps;
    ``/metrics`` reports it per token."""
    eng = _port(weights, "dense")
    try:
        syncs, prefills, steps = eng.host_syncs_total, eng.prefills, eng.decode_steps

        async def seq():
            for prompt, n in (("one", 1), ("two tokens", 2), ("seventeen", 17), (JSON_LOOP, 30)):
                r = await asyncio.wait_for(eng.generate(prompt, max_tokens=n, ignore_eos=True), 120)
                assert r["completion_tokens"] == n

        asyncio.run(seq())
        crossings = (eng.prefills - prefills) + (eng.decode_steps - steps)
        assert eng.host_syncs_total - syncs == crossings
        assert eng.spec_rounds > 0
        m = eng.metrics()
        assert m["host_syncs_total"] == eng.host_syncs_total
        assert m["host_syncs_per_token"] == round(eng.host_syncs_total / eng.tokens_generated, 4)
        assert m["graphs_captured"] == 0 and m["graph_replays"] == 0
    finally:
        eng.shutdown()


# -- the plumbing, without a card ---------------------------------------------


class _Slot(SimpleNamespace):
    pass


@pytest.mark.parametrize(
    "slots,want",
    [
        ([], False),
        ([dict(request=None, pending_prompt=[], decoding=False)], False),
        ([dict(request=dict(dispatched=0, max_tokens=4), pending_prompt=[1], decoding=False)], True),
        ([dict(request=dict(dispatched=3, max_tokens=4), pending_prompt=[], decoding=True)], True),
        ([dict(request=dict(dispatched=4, max_tokens=4), pending_prompt=[], decoding=True)], False),
        (
            [
                dict(request=dict(dispatched=9, max_tokens=4), pending_prompt=[], decoding=True),
                dict(request=None, pending_prompt=[], decoding=False),
            ],
            False,
        ),
    ],
)
def test_has_dispatchable_matches_jax(slots, want):
    """Whether a forced drain is due because nothing else can be dispatched:
    the reference's rule on the same lanes."""

    def lanes():
        return [
            _Slot(**{**s, "request": SimpleNamespace(**s["request"]) if s["request"] else None})
            for s in slots
        ]

    assert tllm.LLMEngine._has_dispatchable(SimpleNamespace(slots=lanes())) is want
    assert jllm.LLMEngine._has_dispatchable(SimpleNamespace(slots=lanes())) is want


# the prefill buckets a max_seq of 128 reaches (chunks of at most 126 tokens)
PREFILL_KEYS = [("prefill", b, True) for b in (32, 64, 128)]


@pytest.mark.parametrize(
    "options,keys",
    [
        ({}, PREFILL_KEYS + [("decode", c, g) for c in (1, 2, 4, 8) for g in (True, False)]
            + [("verify", k, g) for k in (2, 4, 8) for g in (True, False)]),
        ({"speculative": False},
            PREFILL_KEYS + [("decode", c, g) for c in (1, 2, 4, 8) for g in (True, False)]),
        ({"adaptive_decode": False, "spec_gamma_max": 4},
            PREFILL_KEYS + [("decode", 8, g) for g in (True, False)]
            + [("verify", k, g) for k in (2, 4) for g in (True, False)]),
    ],
)
def test_step_keys_cover_the_ladders(weights, options, keys):
    """One step (one graph on the card) per reachable prefill bucket, per
    decode-ladder rung and per verify bucket, greedy and sampled (a prefill
    step draws nothing); on the CPU nothing is captured."""
    _, _, tcfg, tp = weights
    eng = tllm.LLMEngine(tcfg, tp, TTok(tcfg.vocab_size), max_batch=2, max_seq=128, **options, device="cpu")
    try:
        assert eng._step_keys() == keys
        eng.capture_step_graphs()
        assert eng._graphs is None and eng.metrics()["graphs_captured"] == 0
    finally:
        eng.shutdown()


def test_device_table_is_uploaded_in_place_and_only_when_changed(weights):
    eng = _port(weights, "paged")
    try:
        uploads = []
        upload = eng._xfer.upload
        eng._xfer.upload = lambda dst, src: (uploads.append(dst.data_ptr()), upload(dst, src))
        ptr = eng._dbt.data_ptr()
        eng._sync_table()  # warmup's lanes detached since the last upload
        eng._sync_table()
        assert uploads == [ptr]
        uploads.clear()
        eng._bt[1, 0] = 3
        eng._sync_table()
        eng._sync_table()
        assert uploads == [ptr] and eng._dbt[1, 0].item() == 3
        eng._bt[1, 0] = eng._scratch_page(1)
        eng._sync_table()
        assert eng._dbt.tolist() == eng._bt.tolist()
    finally:
        del eng._xfer.upload
        eng.shutdown()


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.float32])
def test_host_transfers_round_trip_on_the_cpu(dtype):
    xfer = HostTransfers(torch.device("cpu"))
    src = np.arange(12).reshape(3, 4).astype(torch.empty((), dtype=dtype).numpy().dtype)
    dst = torch.zeros((3, 4), dtype=dtype)
    ptr = dst.data_ptr()
    xfer.upload(dst, src)
    assert dst.data_ptr() == ptr and dst.numpy().tolist() == src.tolist()
    host, event = xfer.download(dst * 2)
    assert event is LANDED and event.query()
    assert host.numpy().tolist() == (src * 2).tolist()
    xfer.give(host)
    again, _ = xfer.download(dst)
    assert again is host  # the buffer came back to its free list


class _FakeGraph:
    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph API replaced by stand-ins that record what the
    step functions launch under capture, so the bookkeeping of StepGraphs
    runs without a card."""
    capturing = []

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None, stream=None, capture_error_mode="global"):
        capturing.append(cuda_graph)
        try:
            yield
        finally:
            capturing.pop()

    for name, value in {
        "graph_pool_handle": lambda: (0, 1), "Stream": lambda device=None: object(),
        "CUDAGraph": _FakeGraph, "graph": graph, "synchronize": lambda device=None: None,
        "empty_cache": lambda: None, "memory_reserved": lambda device=None: 4096,
        "is_current_stream_capturing": lambda: bool(capturing),
    }.items():
        monkeypatch.setattr(torch.cuda, name, value)
    for w in KERNEL_WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "captured", 0)
    return capturing


def _fake_steps():
    """Two steps as a 2-layer model records them: a decode step (one decode
    call per layer) and a verify step (one prefill call per layer)."""

    def decode():
        for _ in range(2):
            ca._count(ca.flash_decode)
        return torch.zeros(1)

    def verify():
        for _ in range(2):
            ca._count(ca.fused_paged_flash_prefill)
        return torch.ones(1)

    return {("decode", 1, True): decode, ("verify", 2, False): verify}


def test_step_graphs_add_the_captured_launches_at_every_replay(fake_cuda):
    graphs = StepGraphs(torch.device("cuda"))
    graphs.capture(_fake_steps(), generator="gen", sampled={("verify", 2, False)})
    # the warm eager calls launched; the captures recorded and launched nothing
    assert (ca.flash_decode.launches, ca.fused_paged_flash_prefill.launches) == (2, 2)
    assert (ca.flash_decode.captured, ca.fused_paged_flash_prefill.captured) == (2, 2)
    for _ in range(3):
        assert graphs.replay(("decode", 1, True)).tolist() == [0.0]
    graphs.replay(("verify", 2, False))
    assert ca.flash_decode.launches == 2 + 3 * 2
    assert ca.fused_paged_flash_prefill.launches == 2 + 2
    assert ca.flash_prefill.launches == ca.fused_paged_flash_decode.launches == 0
    assert graphs.replays == 4 and len(graphs) == 2 and graphs.pool_bytes == 0


def test_step_graphs_register_the_generator_with_sampled_steps_only(fake_cuda):
    graphs = StepGraphs(torch.device("cuda"))
    graphs.capture(_fake_steps(), generator="gen", sampled={("verify", 2, False)})
    assert graphs._graphs[("verify", 2, False)][0].generators == ["gen"]
    assert graphs._graphs[("decode", 1, True)][0].generators == []


def test_step_graphs_refuse_a_step_that_was_not_captured(fake_cuda):
    graphs = StepGraphs(torch.device("cuda"))
    graphs.capture(_fake_steps(), generator="gen", sampled=set())
    with pytest.raises(RuntimeError, match="no CUDA graph captured"):
        graphs.replay(("decode", 8, True))
    assert graphs.replays == 0


@pytest.mark.parametrize("capturing", [False, True])
def test_kernel_counts_split_launches_from_captured_calls(fake_cuda, capturing):
    if capturing:
        fake_cuda.append("a graph")
    ca._count(ca.flash_prefill)
    assert (ca.flash_prefill.launches, ca.flash_prefill.captured) == ((0, 1) if capturing else (1, 0))
