"""The port's control plane end to end, with real engine processes.

- **echo**: the port's counterparts of tests/test_e2e_local.py's scenarios
  (serves and persists history, crash replay with SIGKILL, expired
  requests skipped, resume right after a kill, auto-restart, pause/resume).
- **llm:tiny in f32 on the CPU**: two agents with different personas are
  tenants of one engine host (one process, ``weights_shared``), loading a
  seed-made HuggingFace checkpoint. Two turns; the session's snapshot lands
  in the store (``kv_snapshots``); the host is SIGKILLed; a third turn
  answers 202; resume; the replay drains. The third turn's greedy tokens
  (read off the SSE frames of the replayed, archived stream) and text equal
  those of the JAX ``LLMEngine``'s undisturbed three-turn conversation on
  the same checkpoint, and ``kv_restores`` >= 1 shows the restore came from
  the store.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import signal
import time

from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.runtime.backend import EngineState

from .test_torch_daemon import AUTH, port_stack
from .test_torch_hf_convert import write_hf


def run(coro):
    return asyncio.run(coro)


async def _deployed_echo(st, name: str, **extra) -> str:
    status, doc = await st.call("POST", "/agents", {"name": name, "model": "echo", **extra}, AUTH)
    assert status == 200, doc
    status, doc = await st.call("POST", f"/agents/{doc['data']['id']}/start", headers=AUTH)
    assert status == 200, doc
    return doc["data"]["id"]


def test_subprocess_engine_serves_and_persists_history(tmp_path):
    async def body():
        async with port_stack(tmp_path) as st:
            aid = await _deployed_echo(st, "echo-1")
            status, doc = await st.call("POST", f"/agent/{aid}/chat", {"message": "hello gpu"})
            assert status == 200, doc
            assert doc["response"] == "Echo: hello gpu" and doc["conversation_length"] == 2
            _, hist = await st.call("GET", f"/agent/{aid}/history")
            assert [t["content"] for t in hist["history"]] == ["hello gpu", "Echo: hello gpu"]
            status, logs = await st.call("GET", f"/agents/{aid}/logs", headers=AUTH)
            assert status == 200 and any("POST /chat 200" in ln for ln in logs["data"]["logs"])

    run(body())


def test_crash_replay_with_real_processes(tmp_path):
    async def body():
        async with port_stack(tmp_path) as st:
            s = st.services
            aid = await _deployed_echo(st, "echo-crash")
            assert (await st.call("POST", f"/agent/{aid}/chat", {"message": "before crash"}))[0] == 200
            s.backend.kill_engine_hard(s.manager.get_agent(aid).engine_id)
            # connection refused → 502, the request stays pending
            status, _ = await st.call("POST", f"/agent/{aid}/chat", {"message": "during crash"})
            assert status == 502 and s.journal.stats(aid)["pending"] == 1
            # the reconciler sees the death → stopped → the next request 202
            s.quick_sync.sync_agent(aid)
            assert s.manager.get_agent(aid).status.value == "stopped"
            status, _ = await st.call("POST", f"/agent/{aid}/chat", {"message": "still down"})
            assert status == 202 and s.journal.stats(aid)["pending"] == 2
            status, doc = await st.call("POST", f"/agents/{aid}/resume", headers=AUTH)
            assert status == 200, doc
            assert await s.replay.scan_once() == 2
            assert s.journal.stats(aid) == {"pending": 0, "completed": 3, "failed": 0, "expired": 0}
            _, hist = await st.call("GET", f"/agent/{aid}/history")
            contents = [t["content"] for t in hist["history"]]
            assert {"before crash", "during crash", "still down"} <= set(contents)

    run(body())


def test_crash_replay_skips_expired_requests(tmp_path):
    async def body():
        async with port_stack(tmp_path) as st:
            s = st.services
            aid = await _deployed_echo(st, "echo-dl")
            s.backend.kill_engine_hard(s.manager.get_agent(aid).engine_id)
            s.quick_sync.sync_agent(aid)
            status, doc = await st.call(
                "POST", f"/agent/{aid}/chat", {"message": "doomed"},
                {"X-Agentainer-Deadline-Ms": "150"},
            )
            assert status == 202
            doomed = doc["data"]["request_id"]
            status, doc = await st.call("POST", f"/agent/{aid}/chat", {"message": "survivor"})
            assert status == 202
            survivor = doc["data"]["request_id"]
            await asyncio.sleep(0.3)  # the 150 ms deadline passes
            assert (await st.call("POST", f"/agents/{aid}/resume", headers=AUTH))[0] == 200
            assert await s.replay.scan_once() == 1
            stats = s.journal.stats(aid)
            assert (stats["pending"], stats["expired"], stats["completed"]) == (0, 1, 1)
            assert s.journal.get(aid, doomed).status == "expired"
            assert s.journal.get(aid, survivor).status == "completed"
            _, hist = await st.call("GET", f"/agent/{aid}/history")
            contents = [t["content"] for t in hist["history"]]
            assert "survivor" in contents and "doomed" not in contents

    run(body())


def test_resume_immediately_after_kill_rehydrates(tmp_path):
    """Resume inside the window where the killed process is not yet reaped
    (poll() still None, port refusing): resume probes real liveness and
    rehydrates."""

    async def body():
        async with port_stack(tmp_path) as st:
            s = st.services
            aid = await _deployed_echo(st, "echo-race")
            assert (await st.call("POST", f"/agent/{aid}/chat", {"message": "alive"}))[0] == 200
            rec = s.backend._recs[s.manager.get_agent(aid).engine_id]
            os.killpg(rec.proc.pid, signal.SIGKILL)
            status, doc = await st.call("POST", f"/agents/{aid}/resume", headers=AUTH)
            assert status == 200, doc
            deadline = time.monotonic() + 30
            while (await st.call("POST", f"/agent/{aid}/chat", {"message": "back?"}))[0] != 200:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)

    run(body())


def test_auto_restart_policy_respawns_engine(tmp_path):
    async def body():
        async with port_stack(tmp_path) as st:
            s = st.services
            aid = await _deployed_echo(st, "echo-ar", auto_restart=True)
            engine_id = s.manager.get_agent(aid).engine_id
            s.backend.kill_engine_hard(engine_id)
            for _ in range(100):  # the watcher polls at 200 ms
                await asyncio.sleep(0.1)
                info = s.backend.engine_info(engine_id)
                if info and info.state == EngineState.RUNNING:
                    break
            assert s.backend.engine_info(engine_id).state == EngineState.RUNNING
            assert s.backend.watch_stats(engine_id)["restarts"] == 1
            for _ in range(100):
                status, doc = await st.call("POST", f"/agent/{aid}/chat", {"message": "back"})
                if status == 200:
                    break
                await asyncio.sleep(0.1)
            assert status == 200 and doc["response"] == "Echo: back"

    run(body())


def test_pause_resume_signals(tmp_path):
    async def body():
        async with port_stack(tmp_path) as st:
            s = st.services
            aid = await _deployed_echo(st, "echo-p")
            _, doc = await st.call("POST", f"/agents/{aid}/pause", headers=AUTH)
            assert doc["data"]["status"] == "paused"
            engine_id = s.manager.get_agent(aid).engine_id
            assert s.backend.engine_info(engine_id).state == EngineState.PAUSED
            _, doc = await st.call("POST", f"/agents/{aid}/resume", headers=AUTH)
            assert doc["data"]["status"] == "running"
            assert (await st.call("POST", f"/agent/{aid}/chat", {"message": "awake"}))[0] == 200

    run(body())


# -- llm:tiny: two tenants of one host, killed and replayed ---------------------

TURNS = ("hello", "again", "third")
PERSONAS = ("You are Ada.", "You are Bob.")
OPTS = {"device": "cpu", "max_batch": 2, "max_seq": 256, "streaming": True}


def _jax_conversation(ckpt: str, persona: str) -> list[dict]:
    """The JAX engine's undisturbed conversation: persona + the turns."""
    from agentainer_tpu.engine.llm import LLMEngine

    async def go():
        eng = LLMEngine.create("tiny", checkpoint=ckpt, options={"max_batch": 2, "max_seq": 256})
        try:
            out = []
            for i, msg in enumerate(TURNS):
                prompt = f"{persona}\n\n{msg}" if i == 0 else msg
                out.append(await eng.chat("s", prompt, max_tokens=8))
            return out
        finally:
            eng.shutdown()

    return run(go())


def _sse_tokens(body: bytes) -> tuple[list[int], dict]:
    """The token ids of an SSE body's token events, and its done payload."""
    tokens, done = [], None
    for frame in body.decode().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in frame.splitlines() if ": " in ln)
        if lines.get("event") == "token":
            tokens.append(json.loads(lines["data"])["token"])
        elif lines.get("event") == "done":
            done = json.loads(lines["data"])
    return tokens, done


def test_llm_tenants_crash_replay_matches_jax(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_hf(ckpt, tconfigs.get_config("tiny"))
    want = _jax_conversation(str(ckpt), PERSONAS[0])

    async def body():
        async with port_stack(tmp_path, background=True) as st:
            s = st.services
            ids = []
            for name, persona in zip(("ada", "bob"), PERSONAS):
                model = {"engine": "llm", "config": "tiny", "checkpoint": str(ckpt),
                         "options": {**OPTS, "system_prompt": persona, "kv_snapshot_interval_s": 0}}
                status, doc = await st.call("POST", "/agents", {"name": name, "model": model}, AUTH)
                assert status == 200, doc
                ids.append(doc["data"]["id"])
                status, doc = await st.call("POST", f"/agents/{ids[-1]}/start", headers=AUTH)
                assert status == 200, doc
            a, b = ids
            # one host process serves both agents
            pid = s.backend.engine_pid(a)
            assert pid is not None and pid == s.backend.engine_pid(b)
            deadline = time.monotonic() + 120
            while not (await st.call("GET", f"/agent/{a}/health"))[1].get("model_loaded"):
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)
            got = []
            for msg in TURNS[:2]:
                status, doc = await st.call(
                    "POST", f"/agent/{a}/chat", {"message": msg, "session": "s", "max_tokens": 8}
                )
                assert status == 200, doc
                got.append(doc)
            status, doc = await st.call("POST", f"/agent/{b}/chat", {"message": "hi", "max_tokens": 4})
            assert status == 200 and doc["agent"] == "bob"
            # the second turn's snapshot is in the store
            while True:
                _, m = await st.call("GET", f"/agent/{a}/metrics")
                if m["kv_snapshots"] >= 2:
                    break
                assert time.monotonic() < deadline, m
                await asyncio.sleep(0.2)
            assert m["weights_shared"] is True and m["tenants"] == 2
            os.kill(pid, signal.SIGKILL)
            while (await st.call("GET", f"/agents/{a}", headers=AUTH))[1]["data"]["status"] == "running":
                assert time.monotonic() < deadline
                await asyncio.sleep(0.1)
            status, doc = await st.call(
                "POST", f"/agent/{a}/chat",
                {"message": TURNS[2], "session": "s", "max_tokens": 8, "stream": True},
            )
            assert status == 202, doc
            rid = doc["data"]["request_id"]
            status, doc = await st.call("POST", f"/agents/{a}/resume", headers=AUTH)
            assert status == 200, doc
            assert s.backend.engine_pid(a) not in (None, pid)
            while s.journal.stats(a)["pending"]:
                assert time.monotonic() < deadline, s.journal.stats(a)
                await asyncio.sleep(0.2)
            entry = s.journal.get(a, rid)
            assert entry.status == "completed" and entry.retry_count == 0
            third = base64.b64decode(entry.response["body_b64"])
            _, m = await st.call("GET", f"/agent/{a}/metrics")
            # the co-tenant is not in the respawned host: it reads as
            # stopped until resumed, then serves from the new host
            assert s.quick_sync.sync_agent(b).status.value == "stopped"
            assert (await st.call("POST", f"/agents/{b}/resume", headers=AUTH))[0] == 200
            status, doc = await st.call("POST", f"/agent/{b}/chat", {"message": "back", "max_tokens": 4})
            assert status == 200 and doc["agent"] == "bob"
            assert s.backend.engine_pid(b) == s.backend.engine_pid(a)
            return got, third, m

    got, third, metrics = run(body())
    for doc, ref in zip(got, want):
        assert doc["response"] == ref["text"]
        assert doc["usage"]["completion_tokens"] == len(ref["tokens"])
    tokens, done = _sse_tokens(third)
    assert tokens == want[2]["tokens"]
    assert done["response"] == want[2]["text"]
    assert metrics["kv_restores"] >= 1


def test_llm_engine_that_cannot_load_lands_failed(tmp_path):
    """An llm agent asks for the card (the default device) on a machine
    without one: the host exits, and the agent lands FAILED with the
    engine's error in its logs — it never comes back on the CPU."""

    async def body():
        async with port_stack(tmp_path) as st:
            s = st.services
            model = {"engine": "llm", "config": "tiny", "options": {"max_seq": 64}}
            status, doc = await st.call("POST", "/agents", {"name": "nocard", "model": model}, AUTH)
            assert status == 200, doc
            aid = doc["data"]["id"]
            assert (await st.call("POST", f"/agents/{aid}/start", headers=AUTH))[0] == 200
            deadline = time.monotonic() + 60
            while s.quick_sync.sync_agent(aid).status.value != "failed":
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)
            stats = s.backend.watch_stats(s.manager.get_agent(aid).engine_id)
            _, logs = await st.call("GET", f"/agents/{aid}/logs", headers=AUTH)
            return stats, logs["data"]["logs"]

    stats, logs = run(body())
    assert stats["crash_looping"] and "no CUDA device available" in stats["failed_reason"]
    assert any("no CUDA device available" in ln for ln in logs)
