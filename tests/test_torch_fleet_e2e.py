"""The port's replica fleet end to end, with real engine processes.

``llm:tiny`` in f32 on the CPU, deployed with ``replicas: 2``: two engine
hosts (one per replica ordinal), loading a seed-made HuggingFace
checkpoint, behind the port's daemon with ``features.streaming`` on. Session
S's first turn streams through the journaled proxy and its snapshot lands
in the store; its second turn streams, and after a few token frames the
host of S's affine replica is SIGKILLed (each replica's decode steps are
slowed by the ``engine.decode_step`` failpoint, armed in the agent's
environment, so the kill lands mid-stream). On its one connection the
client sees offsets 0..n-1 with no gap or duplicate and one ``done``, and
the greedy token ids of both turns equal the JAX ``LLMEngine``'s
undisturbed conversation on the same checkpoint; the survivor restored the
session from the store (``kv_restores``), the proxy counted the failover,
and the journal entry completed at the last offset with no retry charged.
"""

from __future__ import annotations

import asyncio
import json
import time

from aiohttp import ClientSession

from agentainer_tpu_torch.core.protocol import REQUEST_ID_HEADER
from agentainer_tpu_torch.models import configs as tconfigs

from .test_torch_daemon import AUTH, port_stack
from .test_torch_daemon_e2e import run
from .test_torch_hf_convert import write_hf

PERSONA = "You are Ada."
TURNS = (("hello", 8), ("tell me a story", 24))
OPTS = {"device": "cpu", "max_batch": 2, "max_seq": 256, "streaming": True, "decode_chunk": 2,
        "kv_snapshot_interval_s": 0, "system_prompt": PERSONA}
SLOW = "engine.decode_step:delay_ms=80,error=none"
KILL_AFTER = 4  # token frames the client reads before the kill


def _jax_conversation(ckpt: str) -> list[list[int]]:
    """The JAX engine's undisturbed two turns: greedy token ids."""
    from agentainer_tpu.engine.llm import LLMEngine

    async def go():
        eng = LLMEngine.create("tiny", checkpoint=ckpt, options={"max_batch": 2, "max_seq": 256})
        try:
            out = []
            for i, (msg, n) in enumerate(TURNS):
                prompt = f"{PERSONA}\n\n{msg}" if i == 0 else msg
                out.append((await eng.chat("s", prompt, max_tokens=n, ignore_eos=True))["tokens"])
            return out
        finally:
            eng.shutdown()

    return run(go())


def _events(raw: bytes) -> list[tuple[str, int | None, dict | None]]:
    out = []
    for block in raw.decode().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in block.splitlines() if ": " in ln and not ln.startswith(":"))
        if "event" in lines:
            eid = int(lines["id"]) if "id" in lines else None
            out.append((lines["event"], eid, json.loads(lines["data"]) if "data" in lines else None))
    return out


def test_llm_fleet_replica_killed_mid_stream_splices_like_jax(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_hf(ckpt, tconfigs.get_config("tiny"))
    want = _jax_conversation(str(ckpt))

    async def body():
        async with port_stack(tmp_path, background=True, streaming=True) as st:
            s = st.services
            model = {"engine": "llm", "config": "tiny", "checkpoint": str(ckpt), "options": OPTS}
            status, doc = await st.call("POST", "/agents", {"name": "ada", "model": model, "replicas": 2,
                                                            "env": {"ATPU_FAULTS": SLOW}}, AUTH)
            assert status == 200, doc
            aid = doc["data"]["id"]
            status, doc = await st.call("POST", f"/agents/{aid}/start", headers=AUTH)
            assert status == 200, doc
            ids = s.manager.get_agent(aid).replica_ids
            assert len(ids) == 2
            pids = {s.backend._hosts[s.backend._recs[e].share_key].proc.pid for e in ids}
            assert len(pids) == 2  # one host process per replica
            deadline = time.monotonic() + 120

            def metrics(eid: str) -> dict:
                return s.backend.stats(eid) or {}

            while not all(metrics(e).get("model_loaded") for e in ids):
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)
            url = f"{st.url}/agent/{aid}/chat"
            async with ClientSession() as client:
                msg, n = TURNS[0]
                body1 = {"message": msg, "session": "S", "max_tokens": n, "ignore_eos": True, "stream": True}
                async with client.post(url, json=body1) as resp:
                    assert resp.status == 200
                    rid1 = resp.headers[REQUEST_ID_HEADER]
                    first = _events(await resp.read())
                affine = s.journal.get(aid, rid1).replica_id
                survivor = next(e for e in ids if e != affine)
                while not (metrics(affine).get("kv_snapshots", 0) >= 1
                           and metrics(affine).get("kv_snapshots_in_flight") == 0):
                    assert time.monotonic() < deadline
                    await asyncio.sleep(0.1)
                msg, n = TURNS[1]
                body2 = {"message": msg, "session": "S", "max_tokens": n, "ignore_eos": True, "stream": True}
                raw = b""
                killed = False
                async with client.post(url, json=body2) as resp:
                    assert resp.status == 200
                    rid2 = resp.headers[REQUEST_ID_HEADER]
                    async for line in resp.content:
                        raw += line
                        if not killed and raw.count(b"event: token") >= KILL_AFTER:
                            await asyncio.to_thread(s.backend.kill_engine_hard, affine)
                            killed = True
            _, faults_doc = await st.call("GET", "/internal/faults", headers=AUTH)
            return (first, _events(raw), s.journal.get(aid, rid2), metrics(survivor),
                    faults_doc["data"], s.journal.get(aid, rid2).replica_id == survivor)

    first, second, entry, survivor_m, proxy, moved = run(body())
    assert [e[2]["token"] for e in first if e[0] == "token"] == want[0]
    toks = [e for e in second if e[0] == "token"]
    assert [e[1] for e in toks] == list(range(len(want[1])))
    assert [e[2]["token"] for e in toks] == want[1]
    assert [e[0] for e in second if e[0] in ("done", "error")] == ["done"]
    assert proxy["stream_failovers_total"] >= 1
    assert survivor_m["kv_restores"] >= 1 and survivor_m["last_kv_restore"]["session"] == "S"
    assert entry.status == "completed" and entry.stream_offset == len(want[1]) - 1
    assert entry.retry_count == 0 and moved
