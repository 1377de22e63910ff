"""The port's model artifacts (``manager/artifacts.py``) against the JAX
package's, on the CPU, on the same directories.

The cases of ``tests/test_artifacts.py``: layout detection, a build that
validates from headers and dedups its name, a directory that holds no
model, a config whose shapes the tensors do not match, an unknown artifact
named by a deploy (404). Each gives the same document (every field but
``created_at``), or the same error class and message, in both packages.
The standing difference: an orbax ``params/`` directory is refused at
build by the port, registered by the reference. End to end: a ``tiny``
HF directory registered through ``POST /artifacts`` and deployed by name
serves ``/chat`` on the CPU with the JAX ``LLMEngine``'s greedy tokens on
the same directory; deployed without ``"device"`` on a machine with no
card, it lands failed naming the missing CUDA device.
"""

from __future__ import annotations

import asyncio
import json
import time

import pytest

from agentainer_tpu.manager import artifacts as jart
from agentainer_tpu.store import MemoryStore as JMemoryStore
from agentainer_tpu_torch.manager import artifacts as tart
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.store import MemoryStore

from .test_torch_daemon import AUTH, _norm, port_stack, reference_stack
from .test_torch_daemon_e2e import _sse_tokens
from .test_torch_hf_convert import write_hf


def _registries():
    return jart.ArtifactRegistry(JMemoryStore()), tart.ArtifactRegistry(MemoryStore())


def _doc(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "created_at"}


def _error(fn, *args, **kw) -> tuple[str, str]:
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return type(e.value).__name__, str(e.value)


def test_detect_layout(tmp_path):
    orb = tmp_path / "orb"
    (orb / "params").mkdir(parents=True)
    hf = tmp_path / "hf"
    hf.mkdir()
    write_hf(hf, tconfigs.get_config("tiny"))
    for path, want in ((tmp_path / "empty", None), (tmp_path / "missing", None), (hf, "hf"), (orb, "orbax")):
        if want is None and path.name == "empty":
            path.mkdir()
        assert tart.detect_layout(path) == jart.detect_layout(path) == want


@pytest.mark.parametrize("config,shards", [("tiny", 1), ("tiny-moe", 2)])
def test_build_validates_and_dedups(tmp_path, config, shards):
    write_hf(tmp_path, tconfigs.get_config(config), shards=shards)
    ref, port = _registries()
    lines: dict[str, list[str]] = {"ref": [], "port": []}
    want = ref.build(tmp_path, name="tiny-chat", progress=lines["ref"].append)
    got = port.build(tmp_path, name="tiny-chat", progress=lines["port"].append)
    assert _doc(got) == _doc(want)
    assert got["layout"] == "hf" and got["n_tensors"] > 0 and got["n_params"] > 0
    assert lines["port"] == lines["ref"] and any("validated" in line for line in lines["port"])
    # the name in use → the dedup suffix
    assert _doc(port.build(tmp_path, name="tiny-chat")) == _doc(ref.build(tmp_path, name="tiny-chat"))
    assert [_doc(a) for a in port.list()] == [_doc(a) for a in ref.list()]
    assert [a["name"] for a in port.list()] == ["tiny-chat", "tiny-chat-2"]
    assert _doc(port.get("tiny-chat-2")) == _doc(ref.get("tiny-chat-2"))
    for reg in (port, ref):
        assert reg.remove("tiny-chat-2") is True and reg.remove("tiny-chat-2") is False


def test_build_rejects_non_model_dir(tmp_path):
    (tmp_path / "README.md").write_text("not a model")
    ref, port = _registries()
    got = _error(port.build, tmp_path)
    assert got == _error(ref.build, tmp_path) and got[0] == "ArtifactError"
    assert tart.ArtifactError.http_status == jart.ArtifactError.http_status == 400


def test_build_rejects_shape_mismatch(tmp_path):
    write_hf(tmp_path, tconfigs.get_config("tiny"))
    # the config lies about the width: every MLP projection mismatches
    conf = json.loads((tmp_path / "config.json").read_text())
    conf["intermediate_size"] = conf["intermediate_size"] * 2
    (tmp_path / "config.json").write_text(json.dumps(conf))
    ref, port = _registries()
    got = _error(port.build, tmp_path)
    assert got == _error(ref.build, tmp_path) and got[1].startswith("shape mismatch")


def test_an_orbax_directory_is_refused_where_the_reference_defers(tmp_path):
    (tmp_path / "params").mkdir()
    ref, port = _registries()
    assert ref.build(tmp_path, name="orb")["layout"] == "orbax"  # registered, validation deferred
    with pytest.raises(tart.ArtifactError, match="orbax params/ directory.*HF checkpoints only"):
        port.build(tmp_path, name="orb")
    assert port.list() == []


def test_deploy_unknown_artifact_404(tmp_path):
    async def body():
        out = []
        for stack in (reference_stack, port_stack):
            async with stack(tmp_path / stack.__name__) as st:
                for model in ({"engine": "llm", "artifact": "nope"}, {"checkpoint": "artifact://nope"}):
                    out.append(await st.call("POST", "/agents", {"name": "x", "model": model}, AUTH))
                out.append(await st.call("DELETE", "/artifacts/nope", headers=AUTH))
        return out[:3], out[3:]

    want, got = asyncio.run(body())
    assert got == want
    assert [s for s, _ in got] == [404, 404, 404] and got[0][1]["message"] == "unknown artifact: nope"


# the engines' options: small, the reference's default features
OPTS = {"max_batch": 2, "max_seq": 128}
TURNS = ("hello from a directory", "and again")


def _jax_turns(ckpt: str) -> list[dict]:
    from agentainer_tpu.engine.llm import LLMEngine

    async def go():
        eng = LLMEngine.create("", checkpoint=ckpt, options=OPTS)
        try:
            return [await eng.chat("s", msg, max_tokens=8) for msg in TURNS]
        finally:
            eng.shutdown()

    return asyncio.run(go())


def test_deploy_from_directory_serves_the_reference_tokens(tmp_path):
    """``POST /artifacts`` registers the directory (the build log in the
    document, the same document as the reference's API gives), a deploy
    names the artifact with ``"device": "cpu"``, and the agent's greedy
    token ids (read off its SSE frames) equal the JAX engine's."""
    model_dir = tmp_path / "ckpt"
    model_dir.mkdir()
    write_hf(model_dir, tconfigs.get_config("tiny"))
    want = _jax_turns(str(model_dir))

    async def body():
        async with reference_stack(tmp_path / "ref") as st:
            _, ref_doc = await st.call("POST", "/artifacts", {"path": str(model_dir), "name": "tiny-hf"}, AUTH)
        async with port_stack(tmp_path / "port") as st:
            status, doc = await st.call("POST", "/artifacts", {"path": str(model_dir), "name": "tiny-hf"}, AUTH)
            assert status == 200, doc
            assert _norm(doc) == _norm(ref_doc) and doc["data"]["build_log"]
            _, listed = await st.call("GET", "/artifacts", headers=AUTH)
            assert [a["name"] for a in listed["data"]] == ["tiny-hf"]
            model = {"artifact": "tiny-hf", "options": {**OPTS, "device": "cpu", "streaming": True}}
            status, doc = await st.call("POST", "/agents", {"name": "from-dir", "model": model}, AUTH)
            assert status == 200, doc
            agent = st.services.manager.get_agent(doc["data"]["id"])
            assert agent.model.engine == "llm" and agent.model.checkpoint == str(model_dir.resolve())
            assert agent.model.options["device"] == "cpu"
            status, doc = await st.call("POST", f"/agents/{agent.id}/start", headers=AUTH)
            assert status == 200, doc
            deadline = time.monotonic() + 120
            while not (await st.call("GET", f"/agent/{agent.id}/health"))[1].get("model_loaded"):
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)
            out = []
            for msg in TURNS:
                status, raw = await st.call(
                    "POST", f"/agent/{agent.id}/chat",
                    {"message": msg, "session": "s", "max_tokens": 8, "stream": True},
                )
                assert status == 200, raw
                out.append(_sse_tokens(raw.encode()))
            audit = st.services.logs.get_audit(limit=50)
            return out, audit

    got, audit = asyncio.run(body())
    for (tokens, done), ref in zip(got, want):
        assert tokens == ref["tokens"] and done["response"] == ref["text"]
    assert any(e["action"] == "artifact-build" and e["resource"] == "tiny-hf" for e in audit)


def test_an_artifact_agent_without_a_device_asks_for_the_card(tmp_path):
    """No fallback hides the device: deployed from an artifact with no
    ``"device"`` option on a machine without a card, the agent's host
    raises and the agent lands failed, naming the missing CUDA device."""
    model_dir = tmp_path / "ckpt"
    model_dir.mkdir()
    write_hf(model_dir, tconfigs.get_config("tiny"))

    async def body():
        async with port_stack(tmp_path / "port") as st:
            s = st.services
            assert (await st.call("POST", "/artifacts", {"path": str(model_dir), "name": "m"}, AUTH))[0] == 200
            status, doc = await st.call("POST", "/agents", {"name": "m", "model": {"artifact": "m"}}, AUTH)
            assert status == 200, doc
            aid = doc["data"]["id"]
            assert (await st.call("POST", f"/agents/{aid}/start", headers=AUTH))[0] == 200
            deadline = time.monotonic() + 60
            while s.quick_sync.sync_agent(aid).status.value != "failed":
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)
            _, logs = await st.call("GET", f"/agents/{aid}/logs", headers=AUTH)
            return logs["data"]["logs"]

    logs = asyncio.run(body())
    assert any("no CUDA device available" in ln for ln in logs)
