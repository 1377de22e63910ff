"""The port's backups (``manager/backup.py`` and the ``/backups`` routes)
against the JAX package's, on the CPU.

- the assertions of ``tests/test_server.py::test_backup_create_restore``
  on the port's routes, with the same script's statuses and documents
  equal to the reference daemon's (up to ids and times);
- a manifest written by one package's ``BackupManager`` restores in the
  other's, both ways: agent records, histories and KV blobs byte-equal;
- export confinement (a client's name lands under ``backups/exports/``
  with a uuid, stale exports swept), ``_path``'s refusals, a restore's
  per-record errors: the same paths, errors and messages as the
  reference's;
- end to end on ``llm:tiny`` (f32, CPU), deployed from an HF artifact: two
  turns, their snapshot in the store, a backup, a third turn; the agent
  stopped, the backup restored and started: the restored agent's third
  turn restores the copied KV (``kv_restores`` >= 1) and gives the
  original's token ids, which are the JAX engine's.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import shutil
import tarfile
import time

import pytest

from agentainer_tpu.manager import backup as jbackup
from agentainer_tpu.manager.agents import AgentManager as JAgentManager
from agentainer_tpu.runtime.backend import FakeBackend as JFakeBackend
from agentainer_tpu.runtime.scheduler import SliceScheduler as JSliceScheduler
from agentainer_tpu.runtime.scheduler import SliceTopology as JSliceTopology
from agentainer_tpu.store import MemoryStore as JMemoryStore
from agentainer_tpu_torch.manager import backup as tbackup
from agentainer_tpu_torch.manager.agents import AgentManager
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.runtime.backend import FakeBackend
from agentainer_tpu_torch.runtime.scheduler import SliceScheduler, SliceTopology
from agentainer_tpu_torch.store import MemoryStore
from agentainer_tpu_torch.store.schema import Keys
from agentainer_tpu_torch.utils import http

from .test_torch_daemon import AUTH, _norm, port_stack, reference_stack
from .test_torch_daemon_e2e import _sse_tokens
from .test_torch_hf_convert import write_hf

_BACKUP_ID = re.compile(r"backup-\d+")


def _masked(x):
    return json.loads(_BACKUP_ID.sub("backup-ID", json.dumps(_norm(x))))


async def _route_script(st) -> tuple[list, dict]:
    """test_server.py's backup script; (masked answers, what it checked)."""
    s = st.services
    out, seen = [], {}

    async def step(*call):
        status, doc = await st.call(*call)
        out.append((status, _masked(doc)))
        return status, doc

    _, doc = await step("POST", "/agents", {"name": "alpha", "model": "echo"}, AUTH)
    aid = doc["data"]["id"]
    await step("POST", f"/agents/{aid}/start", None, AUTH)
    s.store.rpush(Keys.conversations(aid), '{"role":"user","content":"hi"}')
    status, doc = await step("POST", "/backups", {"name": "b1"}, AUTH)
    assert status == 200
    backup = doc["data"]
    _, doc = await step("GET", "/backups", None, AUTH)
    assert len(doc["data"]) == 1
    _, doc = await step("POST", f"/backups/{backup['id']}/restore", None, AUTH)
    restored = doc["data"]
    assert len(restored) == 1 and restored[0]["name"] == "alpha-restored"
    seen["convo"] = s.store.lrange(Keys.conversations(restored[0]["id"]), 0, -1)
    # export streams a portable tar.gz to the client; the daemon never
    # writes a path the client chose, and keeps no copy
    status, headers, blob = await http.request(
        "POST", f"{st.url}/backups/{backup['id']}/export", AUTH, b"", timeout=60
    )
    out.append((status, headers.get("Content-Type")))
    seen["tar"] = blob
    # the handler deletes its file once the last byte is written, which
    # may be just after the client has read it
    exports = os.path.join(s.data_dir, "backups", "exports")
    deadline = time.monotonic() + 10
    while os.listdir(exports) and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
    seen["exports_left"] = os.listdir(exports)
    await step("DELETE", f"/backups/{backup['id']}", None, AUTH)
    # export of a deleted backup → a 400 envelope
    await step("POST", f"/backups/{backup['id']}/export", None, AUTH)
    _, doc = await st.call("GET", "/audit?limit=50", headers=AUTH)
    seen["audit"] = [e["action"] for e in doc["data"]]
    return out, seen


def test_backup_create_restore_export_delete_routes(tmp_path):
    async def body():
        async with reference_stack(tmp_path / "ref") as st:
            want, _ = await _route_script(st)
        async with port_stack(tmp_path / "port") as st:
            got, seen = await _route_script(st)
        return want, got, seen

    want, got, seen = asyncio.run(body())
    assert got == want
    assert [status for status, _ in got] == [200, 200, 200, 200, 200, 200, 200, 400]
    assert got[5] == (200, "application/gzip")
    assert seen["convo"] == [b'{"role":"user","content":"hi"}']
    tar_path = tmp_path / "bundle.tar.gz"
    tar_path.write_bytes(seen["tar"])
    with tarfile.open(tar_path) as tar:
        assert any(m.name.endswith(".json") for m in tar.getmembers())
    assert seen["exports_left"] == []
    for action in ("backup-create", "backup-restore", "backup-export", "backup-delete"):
        assert action in seen["audit"]


def _plane(pkg: str, tmp_path):
    """(BackupManager, AgentManager, store) of one package on a fake backend."""
    if pkg == "ref":
        store = JMemoryStore()
        mgr = JAgentManager(store, JFakeBackend(), JSliceScheduler(store, JSliceTopology(total_chips=8)))
        return jbackup.BackupManager(mgr, store, tmp_path / pkg), mgr, store
    store = MemoryStore()
    mgr = AgentManager(store, FakeBackend(), SliceScheduler(store, SliceTopology(total_chips=8)))
    return tbackup.BackupManager(mgr, store, tmp_path / pkg), mgr, store


# a KV blob as the engines write it: binary, not UTF-8
KV_BLOB = bytes(range(256)) * 64 + b"\xff\xfe tail"
_RECORD_KEYS = ("model", "env", "resources", "auto_restart", "token", "health_check")


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_manifest_restores_in_the_other_package(tmp_path, writer, reader):
    wb, wm, ws = _plane(writer, tmp_path)
    rb, rm, rs = _plane(reader, tmp_path)
    agent = wm.deploy(
        name="alpha", model={"engine": "echo", "options": {"greeting": "hi"}}, env={"ROLE": "x"},
        auto_restart=True, token="tok-1",
    )
    ws.rpush(Keys.conversations(agent.id), '{"role":"user","content":"legacy"}')
    for session, lines in (("s1", ["a", "b"]), ("s2", ["c"])):
        ws.rpush(Keys.conversations_session(agent.id, session), *lines)
        ws.set(Keys.kvcache(agent.id, session), KV_BLOB + session.encode())
    summary = wb.create(name="nightly", description="cross-package")
    shutil.copy(wb._path(summary["id"]), rb._path(summary["id"]))
    assert rb.list() == wb.list()
    restored = rb.restore(summary["id"])
    assert len(restored) == 1 and restored[0]["name"] == "alpha-restored"
    new = rm.get_agent(restored[0]["id"])
    old = wm.get_agent(agent.id)
    for key in _RECORD_KEYS:
        assert json.dumps(new.to_dict()[key], sort_keys=True) == json.dumps(old.to_dict()[key], sort_keys=True), key
    assert rs.lrange(Keys.conversations(new.id), 0, -1) == [b'{"role":"user","content":"legacy"}']
    for session, lines in (("s1", [b"a", b"b"]), ("s2", [b"c"])):
        assert rs.lrange(Keys.conversations_session(new.id, session), 0, -1) == lines
        assert rs.get(Keys.kvcache(new.id, session)) == KV_BLOB + session.encode()
    manifest = json.loads(wb._path(summary["id"]).read_text())
    assert manifest["version"] == "1"
    assert set(manifest["app_state"][agent.id]) == {"conversations", "conversations_by_session", "kvcache"}


def _errors(fn, *args) -> tuple[str, str]:
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value).__name__, str(e.value)


def test_export_is_confined_and_paths_refused(tmp_path):
    planes = {pkg: _plane(pkg, tmp_path) for pkg in ("ref", "port")}
    results = {}
    for pkg, (bm, mgr, _) in planes.items():
        mgr.deploy(name="alpha", model="echo")
        bid = bm.create()["id"]
        exports = bm.dir / "exports"
        exports.mkdir(parents=True, exist_ok=True)
        stale, fresh = exports / "old.tar.gz", exports / "new.tar.gz"
        stale.write_bytes(b"x")
        fresh.write_bytes(b"y")
        os.utime(stale, (time.time() - 7200, time.time() - 7200))
        out = bm.export(bid, out_path="../../../etc/evil")
        with tarfile.open(out) as tar:
            members = [m.name for m in tar.getmembers()]
        results[pkg] = {
            "parent": out.parent == exports,
            "name": re.sub(r"^[0-9a-f]{32}-", "UUID-", out.name),
            "members": [_BACKUP_ID.sub("backup-ID", m) for m in members],
            "swept": (stale.exists(), fresh.exists()),
            "errors": [
                _errors(bm._path, "a/b"), _errors(bm._path, "..x"),
                _errors(bm.export, "backup-1"), _errors(bm.delete, "backup-1"), _errors(bm.restore, "backup-1"),
            ],
        }
    assert results["port"] == results["ref"]
    assert results["port"]["parent"] and results["port"]["name"] == "UUID-evil.tar.gz"
    assert results["port"]["swept"] == (False, True)
    assert {kind for kind, _ in results["port"]["errors"]} == {"InvalidInput"}


def test_restore_reports_each_bad_record(tmp_path):
    results = {}
    for pkg in ("ref", "port"):
        bm, mgr, _ = _plane(pkg, tmp_path)
        good = mgr.deploy(name="good", model="echo").to_dict()
        bad = dict(good, id="agent-0", name="bad", model={"engine": "nope"})
        for bid, records in (("backup-1", [good, bad]), ("backup-2", [bad])):
            bm._path(bid).write_text(json.dumps({"id": bid, "version": "1", "agents": records}))
        restored = bm.restore("backup-1")
        results[pkg] = (
            [r.get("name", r.get("restore_error")) for r in restored],
            _errors(bm.restore, "backup-2"),
        )
    assert results["port"] == results["ref"]
    names, (kind, message) = results["port"]
    assert names[0] == "good-restored" and names[1]["agent"] == "bad"
    assert kind == "InvalidInput" and message.startswith("restore failed for all agents")


# -- llm:tiny end to end ------------------------------------------------------

TURNS = ("hello there", "tell me more", "and the third")
OPTS = {"device": "cpu", "max_batch": 2, "max_seq": 256, "streaming": True, "kv_snapshot_interval_s": 0,
        "prefix_cache": False, "speculative": False}


def _jax_turns(ckpt: str) -> list[dict]:
    from agentainer_tpu.engine.llm import LLMEngine

    async def go():
        eng = LLMEngine.create("", checkpoint=ckpt, options={
            "max_batch": 2, "max_seq": 256, "prefix_cache": False, "speculative": False,
        })
        try:
            return [await eng.chat("s", msg, max_tokens=8) for msg in TURNS]
        finally:
            eng.shutdown()

    return asyncio.run(go())


def test_a_restored_llm_agent_continues_from_the_backed_up_kv(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_hf(ckpt, tconfigs.get_config("tiny"))
    want = _jax_turns(str(ckpt))

    async def body():
        async with port_stack(tmp_path / "port") as st:
            deadline = time.monotonic() + 180

            async def until(pred):
                while not (got := await pred()):
                    assert time.monotonic() < deadline
                    await asyncio.sleep(0.2)
                return got

            async def metrics(aid):
                return (await st.call("GET", f"/agent/{aid}/metrics"))[1]

            async def started(aid):
                status, doc = await st.call("POST", f"/agents/{aid}/start", headers=AUTH)
                assert status == 200, doc
                await until(lambda: _loaded(st, aid))

            async def turn(aid, msg):
                status, raw = await st.call(
                    "POST", f"/agent/{aid}/chat", {"message": msg, "session": "s", "max_tokens": 8, "stream": True}
                )
                assert status == 200, raw
                return _sse_tokens(raw.encode())

            status, doc = await st.call("POST", "/artifacts", {"path": str(ckpt), "name": "op"}, AUTH)
            assert status == 200, doc
            status, doc = await st.call("POST", "/agents", {"name": "op", "model": {"artifact": "op", "options": OPTS}}, AUTH)
            assert status == 200, doc
            a = doc["data"]["id"]
            await started(a)
            got = [await turn(a, msg) for msg in TURNS[:2]]

            async def settled():
                m = await metrics(a)
                return m if m["kv_snapshots"] >= 2 and m["kv_snapshots_in_flight"] == 0 else None

            snap = (await until(settled))["last_kv_snapshot"]
            status, doc = await st.call("POST", "/backups", {"name": "before-t3"}, AUTH)
            assert status == 200, doc
            bid = doc["data"]["id"]
            got.append(await turn(a, TURNS[2]))
            assert (await st.call("POST", f"/agents/{a}/stop", headers=AUTH))[0] == 200
            status, doc = await st.call("POST", f"/backups/{bid}/restore", headers=AUTH)
            assert status == 200, doc
            (restored,) = doc["data"]
            assert restored["name"] == "op-restored"
            r = restored["id"]
            await started(r)
            third = await turn(r, TURNS[2])
            m = await metrics(r)
            _, hist = await st.call("GET", f"/agent/{r}/history?session=s")
            return got, third, m, snap, hist

    got, third, m, snap, hist = asyncio.run(body())
    for (tokens, done), ref in zip(got, want):
        assert tokens == ref["tokens"] and done["response"] == ref["text"]
    assert snap["path"] == "http" and snap["bytes"] > 0  # mem://: the store over HTTP
    assert third[0] == got[2][0] and third[1]["usage"] == got[2][1]["usage"]
    assert m["kv_restores"] >= 1 and m["last_kv_restore"]["session"] == "s"
    assert [t["content"] for t in hist["history"] if t["role"] == "user"][:3] == list(TURNS)


async def _loaded(st, aid) -> bool:
    status, doc = await st.call("GET", f"/agent/{aid}/health")
    return status == 200 and bool(doc.get("model_loaded"))
