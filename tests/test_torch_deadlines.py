"""Deadlines, cancel, shedding and drain in the port, on the CPU.

Engine level: the four engine tests of tests/test_deadlines.py against the
port — an expired queued request fails before prefill; cancelling an
in-flight generation parks its lane and frees the slot for a waiting one;
the submit-side watermark sheds while under-watermark work completes; a
drain stops admission and finishes in-flight lanes. Serve level: the port's
``LLMServeApp`` answers 429 (shed), 504 + ``X-Agentainer-Expired``
(deadline header), 499 (``POST /cancel`` of an in-flight request, whose
lane is then free) and 503 + ``X-Agentainer-Draining``, as the reference's
``_policy_response`` maps them.

An occupant request must outlast the checks made while it holds the only
lane, so ``_slow`` adds 10 ms to each decode chunk and verify round of its
engine.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from agentainer_tpu_torch.core.protocol import (
    DEADLINE_HEADER,
    DRAINING_HEADER,
    EXPIRED_HEADER,
    REQUEST_ID_HEADER,
)
from agentainer_tpu_torch.engine.llm import (
    EngineDraining,
    EngineOverloaded,
    LLMEngine,
    RequestCancelled,
    RequestExpired,
)
from agentainer_tpu_torch.engine.llm_serve import LLMServeApp


def run(coro):
    return asyncio.run(coro)


def _slow(eng, s=0.01):
    for name in ("_decode_n", "_verify"):
        fn = getattr(eng, name)

        def slow(*a, _fn=fn, **k):
            time.sleep(s)
            return _fn(*a, **k)

        setattr(eng, name, slow)
    return eng


def make_engine(**opts) -> LLMEngine:
    o = dict(device="cpu", max_batch=1, max_seq=512, decode_chunk=4, prefill_chunk=32)
    o.update(opts)
    return _slow(LLMEngine.create("tiny", options=o))


async def _wait_admitted(eng, min_prefills: int = 1) -> None:
    for _ in range(500):
        if eng.prefills >= min_prefills:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("background generation never admitted")


# -- engine level (tests/test_deadlines.py) -------------------------------


def test_expired_queued_request_fails_before_prefill():
    async def body():
        eng = make_engine()
        try:
            with pytest.raises(RequestExpired):
                await eng.generate("already too late", max_tokens=4, deadline_at=time.time() - 1.0)
            assert eng.expired_total == 1
            assert eng.prefills == 0  # fail-fast: no device work

            # the deadline passes while it waits for the only lane
            a = asyncio.ensure_future(
                eng.generate("occupy the only slot", max_tokens=300, ignore_eos=True)
            )
            await _wait_admitted(eng)
            before = eng.prefills
            with pytest.raises(RequestExpired):
                await eng.generate("expires in queue", max_tokens=4, deadline_at=time.time() + 0.05)
            assert eng.prefills == before
            assert eng.expired_total == 2
            r = await a
            assert r["completion_tokens"] == 300
        finally:
            eng.shutdown()

    run(body())


def test_cancel_inflight_frees_slot_for_waiting_request():
    async def body():
        eng = make_engine()  # max_batch=1: B runs only if A's slot frees
        try:
            a = asyncio.ensure_future(eng.generate(
                "a very long generation to cancel", max_tokens=400, ignore_eos=True,
                request_id="gen-cancel-a",
            ))
            await _wait_admitted(eng)
            b = asyncio.ensure_future(eng.generate("waiting for the slot", max_tokens=4))
            await asyncio.sleep(0.05)
            assert not b.done()
            assert eng.cancel("gen-cancel-a") is True
            with pytest.raises(RequestCancelled):
                await asyncio.wait_for(a, 30)
            rb = await asyncio.wait_for(b, 30)
            assert rb["completion_tokens"] >= 1
            m = eng.metrics()
            assert m["cancelled_total"] == 1 and m["active_requests"] == 0
            assert eng.cancel("") is False
        finally:
            eng.shutdown()

    run(body())


def test_engine_shed_watermark_overload():
    async def body():
        eng = make_engine(shed_watermark=2)
        try:
            a = asyncio.ensure_future(eng.generate("lane occupant", max_tokens=300, ignore_eos=True))
            await _wait_admitted(eng)
            b = asyncio.ensure_future(eng.generate("queued under watermark", max_tokens=2))
            await asyncio.sleep(0.05)
            with pytest.raises(EngineOverloaded) as ei:
                await eng.generate("over the watermark", max_tokens=2)
            assert ei.value.retry_after_s >= 1.0
            assert eng.shed_total == 1
            ra, rb = await asyncio.gather(a, b)  # under-watermark traffic completes
            assert ra["completion_tokens"] == 300 and rb["completion_tokens"] >= 1
            assert eng.metrics()["shed_watermark"] == 2
        finally:
            eng.shutdown()

    run(body())


def test_drain_stops_admission_and_finishes_inflight():
    async def body():
        eng = make_engine()
        try:
            a = asyncio.ensure_future(
                eng.generate("inflight through the drain", max_tokens=100, ignore_eos=True)
            )
            await _wait_admitted(eng)
            eng.begin_drain()
            with pytest.raises(EngineDraining):
                await eng.generate("late arrival", max_tokens=2)
            assert await asyncio.to_thread(eng.drain, 60.0) is True
            assert (await a)["completion_tokens"] == 100
            assert eng.metrics()["draining"] is True
        finally:
            eng.shutdown()

    run(body())


def test_deadlines_off_ignores_the_deadline():
    async def body():
        eng = make_engine(deadlines=False)
        try:
            r = await eng.generate("late but served", max_tokens=2, deadline_at=time.time() - 1.0)
            assert r["completion_tokens"] == 2 and eng.expired_total == 0
            assert eng.metrics()["deadlines"] is False
        finally:
            eng.shutdown()

    run(body())


# -- serve level ----------------------------------------------------------


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(), method="POST",
        headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def test_serve_maps_policy_rejections_and_cancel():
    app = LLMServeApp(env={
        "AGENTAINER_AGENT_ID": "agent-d",
        "AGENTAINER_MODEL_CONFIG": "tiny",
        "AGENTAINER_MODEL_OPTIONS": json.dumps({
            "device": "cpu", "max_batch": 1, "max_seq": 512, "decode_chunk": 4,
            "prefill_chunk": 32, "drain_budget_s": 5,
        }),
    })
    th = threading.Thread(target=lambda: asyncio.run(app.run("127.0.0.1", 0)), daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 120
        while (app.port is None or app.engine is None) and not app.engine_error:
            assert time.monotonic() < deadline, "server did not come up"
            time.sleep(0.05)
        assert not app.engine_error
        eng = _slow(app.engine)
        occupant = {}

        def occupy():
            occupant["resp"] = _post(
                app.port, "/chat",
                {"message": "occupy the lane", "session": "occ", "max_tokens": 400, "ignore_eos": True},
                {REQUEST_ID_HEADER: "rid-occupant"},
            )

        t_occ = threading.Thread(target=occupy)
        t_occ.start()
        run(_wait_admitted(eng))

        # 429: past the shed watermark
        eng.shed_watermark = 1
        status, headers, doc = _post(app.port, "/chat", {"message": "shed me", "max_tokens": 2})
        eng.shed_watermark = 0
        assert status == 429 and headers["Retry-After"] == "1" and doc["watermark"] == 1

        # 504: the deadline passes while it waits for the only lane
        prefills = eng.prefills
        status, headers, doc = _post(
            app.port, "/generate", {"prompt": "too late", "max_tokens": 2}, {DEADLINE_HEADER: "30"}
        )
        assert status == 504 and headers[EXPIRED_HEADER] == "true", doc
        assert eng.prefills == prefills

        # 499: POST /cancel the in-flight occupant; its lane frees
        status, _, doc = _post(app.port, "/cancel", {"request_id": "rid-occupant"})
        assert status == 200 and doc == {"cancelled": True}
        t_occ.join(timeout=60)
        status, headers, doc = occupant["resp"]
        assert status == 499 and headers[EXPIRED_HEADER] == "true", doc
        status, _, doc = _post(app.port, "/chat", {"message": "after", "max_tokens": 2})
        assert status == 200 and eng.metrics()["cancelled_total"] == 1
        assert _post(app.port, "/cancel", {})[0] == 400

        # 503: draining
        eng.begin_drain()
        status, headers, doc = _post(app.port, "/chat", {"message": "drained", "max_tokens": 2})
        assert status == 503 and headers[DRAINING_HEADER] == "true"
        assert app.unhandled_errors == 0
    finally:
        app.stop()
        th.join(timeout=60)
    assert not th.is_alive()
    assert app.drained_clean is True
