"""The ``assistant`` flavor and ``/profile`` of the port's serve layer on the
CPU.

The assistant flavor (``AGENTAINER_ENGINE=assistant``; the reference's
``flatten_history``) generates each turn statelessly from one prompt: the
persona and the session's last ``history_turns`` exchanges, flattened.
The port's app and the reference's aiohttp app, each over its own engine
with the same ``tiny`` weights (f32, the JAX ``init_params`` tree), serve
the same two turns (buffered, then streamed); the greedy replies and the
``persona`` field are equal, and so is the third turn's flattened prompt,
byte for byte.

``/profile`` records a ``torch.profiler`` trace into
``AGENTAINER_PROFILE_DIR``: 200 with the reference's reply keys and a
Chrome trace file, 409 for a second capture while one runs, 400 for a
duration that is not a number.
"""

import asyncio
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.llm_serve import ASSISTANT_PERSONA, LLMServeApp
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

from tests.test_torch_streaming import parse_sse, post

SHAPE = dict(max_batch=4, max_seq=512, decode_chunk=8, prefill_chunk=64)
ENV = {
    "AGENTAINER_AGENT_ID": "asst-t",
    "AGENTAINER_MODEL_CONFIG": "tiny",
    "AGENTAINER_ENGINE": "assistant",
    "ATPU_STREAM_HEARTBEAT_S": "60",
}
TURNS = (
    {"message": "Hi, who are you?", "session": "u", "max_tokens": 12},
    {"message": "Tell me more.", "session": "u", "max_tokens": 12, "stream": True},
)
NEXT = "And then?"


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _reply(status, raw) -> dict:
    """A buffered body, or a stream's done payload."""
    assert status == 200
    if raw.startswith(b"event:"):
        return parse_sse(raw)[-1]["data"]
    return json.loads(raw)


@pytest.fixture(scope="module")
def reference(weights):
    from aiohttp.test_utils import TestClient, TestServer

    from agentainer_tpu.engine.llm_serve import LLMServeApp as JApp

    jcfg, jp, _, _ = weights

    async def drive():
        ref = JApp(env=dict(ENV))
        ref.engine = JEngine(jcfg, jp, JTok(jcfg.vocab_size), **SHAPE, streaming=True)
        replies = []
        async with TestClient(TestServer(ref.app())) as client:
            for body in TURNS:
                resp = await client.post("/chat", json=body)
                replies.append(_reply(resp.status, await resp.read()))
            prompt = await ref._flattened_prompt("u", NEXT)
        return replies, prompt

    return asyncio.run(drive())


@pytest.fixture(scope="module")
def port_app(weights, tmp_path_factory):
    _, _, tcfg, tp = weights
    eng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, streaming=True, device="cpu")
    eng.warmup()
    app = LLMServeApp(env={**ENV, "AGENTAINER_PROFILE_DIR": str(tmp_path_factory.mktemp("prof"))})
    app.engine = eng
    th = threading.Thread(target=lambda: asyncio.run(app.run("127.0.0.1", 0)), daemon=True)
    th.start()
    while app.port is None:
        time.sleep(0.01)
    yield app
    app.stop()
    th.join(timeout=30)


def test_assistant_replies_and_flattened_prompt_equal_the_reference(reference, port_app):
    want_replies, want_prompt = reference
    got = [_reply(*post(port_app, "/chat", body)[::2]) for body in TURNS]
    for g, w in zip(got, want_replies):
        assert g["response"] == w["response"] and g["persona"] == w["persona"] == ASSISTANT_PERSONA
        assert g["usage"] == w["usage"]
    prompt = asyncio.run(port_app._flattened_prompt("u", NEXT))
    assert prompt == want_prompt
    assert prompt.startswith(ASSISTANT_PERSONA + "\n\nUser: Hi, who are you?\nAssistant: ")
    assert prompt.endswith(f"\nUser: {NEXT}\nAssistant:")
    # stateless: the flavor keeps no session in the engine
    assert not port_app.engine.has_session(port_app._sess("u"))


def test_profile_writes_a_trace_and_refuses_a_second_capture(port_app):
    first: dict = {}
    th = threading.Thread(
        target=lambda: first.update(zip(("status", "headers", "raw"), post(
            port_app, "/profile", {"duration_s": 1.0}))),
    )
    th.start()
    while not port_app._profiling and th.is_alive():
        time.sleep(0.01)
    busy = post(port_app, "/profile", {"duration_s": 1.0})
    bad = post(port_app, "/profile", {"duration_s": "soon"})
    th.join(timeout=60)
    assert busy[0] == 409 and bad[0] == 400
    doc = json.loads(first["raw"])
    assert first["status"] == 200 and doc == {
        "trace_dir": port_app._env["AGENTAINER_PROFILE_DIR"], "duration_s": 1.0, "agent_id": "asst-t",
    }
    (name,) = os.listdir(doc["trace_dir"])
    with open(os.path.join(doc["trace_dir"], name)) as f:
        assert "traceEvents" in json.load(f)
