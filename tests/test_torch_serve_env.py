"""The port's serve-layer environment and chip placement against the
reference on the CPU.

- ``_engine_options``: each ``ATPU_*`` fleet default becomes the engine
  option the reference's ``LLMServeApp._engine_options`` makes of it, with
  and without a per-deployment option (which wins), and the assigned chips
  (``AGENTAINER_CHIPS``) ride in ``options["chips"]``;
- a fleet flag for an engine feature the port lacks fails the load (the
  ``assistant`` flavor too, asked with one) with a message that
  ``/health`` and ``/chat`` report;
- ``_engine_device`` maps one chip to ``cuda:{chip}`` (the first device
  for an id past the visible ones), refuses more than one, and leaves the
  CPU alone;
- the persona goes to a session the engine does not hold, asked through
  ``has_session``.
"""

import asyncio
import json

import pytest
import torch

from agentainer_tpu.engine.llm_serve import LLMServeApp as JApp
from agentainer_tpu_torch.engine import llm as tllm
from agentainer_tpu_torch.engine.llm_serve import FLEET_FLAGS, LLMServeApp, Request
from agentainer_tpu_torch.models.configs import get_config

ENV = {"AGENTAINER_AGENT_ID": "env-t", "AGENTAINER_MODEL_CONFIG": "tiny"}


def _clean(monkeypatch):
    for _, name in FLEET_FLAGS:
        monkeypatch.delenv(name, raising=False)
    for name in ("AGENTAINER_CHIPS", "AGENTAINER_WARM_BOOT", "AGENTAINER_MODEL_OPTIONS"):
        monkeypatch.delenv(name, raising=False)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("flag,env_name", FLEET_FLAGS)
@pytest.mark.parametrize("raw", ["1", "true", "YES", "0", "off"])
@pytest.mark.parametrize("deployment", [None, True, False])
def test_engine_options_equal_the_reference(monkeypatch, flag, env_name, raw, deployment):
    _clean(monkeypatch)
    monkeypatch.setenv(env_name, raw)
    monkeypatch.setenv("AGENTAINER_CHIPS", "3")
    opts = {"device": "cpu"} if deployment is None else {"device": "cpu", flag: deployment}
    monkeypatch.setenv("AGENTAINER_MODEL_OPTIONS", json.dumps(opts))
    got = LLMServeApp()._engine_options()
    assert got == JApp()._engine_options()
    assert got[flag] == (raw.lower() in ("1", "true", "yes") if deployment is None else deployment)
    assert got["chips"] == [3]


@pytest.mark.parametrize(
    "options", [{"quant": "int8"}, {"quant": "int8", "synthetic": True}, {"synthetic": True}]
)
def test_quant_and_synthetic_reach_the_engine_unchanged(monkeypatch, options):
    """The deployment's ``quant`` and ``synthetic`` options pass through
    ``_engine_options`` as they are (no ``ATPU_*`` variable sets them), as
    in the reference."""
    _clean(monkeypatch)
    monkeypatch.setenv("AGENTAINER_MODEL_OPTIONS", json.dumps({"device": "cpu", **options}))
    got = LLMServeApp()._engine_options()
    assert got == JApp()._engine_options()
    assert {k: v for k, v in got.items() if k != "chips"} == {"device": "cpu", **options}


def test_the_reference_fleet_flag_list_is_the_ports():
    """FLEET_FLAGS names every ATPU_* variable the reference's
    ``_engine_options`` reads, and no other."""
    import inspect

    src = inspect.getsource(JApp._engine_options)
    names = {name for _, name in FLEET_FLAGS}
    assert names == {w.strip('"(),') for w in src.split() if w.strip('"(),').startswith("ATPU_")}


@pytest.mark.parametrize(
    "env,needle",
    [
        # the assistant flavor and the fleet flags are served now: beside a
        # deployment that asks for what the reference refuses (pp with tp),
        # the load fails on that option alone
        pytest.param(
            {"AGENTAINER_ENGINE": "assistant", "ATPU_KV_TIERING": "1"}, "kv_tiering",
            id="env0-not ported yet",
        ),
        ({"ATPU_FUSED_DECODE": "1"}, "fused_decode"),
        ({"ATPU_KV_TIERING": "true"}, "kv_tiering"),
    ],
)
def test_unported_flavor_and_flags_fail_the_load(env, needle):
    options = {"device": "cpu", "pp": 2, "tp": 2}  # a refusal of the reference's own
    app = LLMServeApp(env={**ENV, "AGENTAINER_MODEL_OPTIONS": json.dumps(options), **env})
    assert app._engine_options()[needle] is True  # the flag reaches create()
    app._load_engine()
    assert app.engine is None and app.engine_error.endswith(
        "serve-time pp does not compose with tp/ep/sp yet"
    )
    assert needle not in app.engine_error
    health = asyncio.run(app.h_health(Request("GET", "/health", {}, b"")))
    assert health.doc["model_loaded"] is False
    chat = asyncio.run(app.h_chat(Request("POST", "/chat", {}, b'{"message": "hi"}')))
    assert chat.status == 503 and "does not compose" in chat.doc["error"]


def test_root_reports_the_assigned_chips(monkeypatch):
    _clean(monkeypatch)
    app = LLMServeApp(env={**ENV, "AGENTAINER_CHIPS": "2,5"})
    doc = asyncio.run(app.h_root(Request("GET", "/", {}, b""))).doc
    assert doc["chips"] == [2, 5]
    assert asyncio.run(LLMServeApp(env=ENV).h_root(Request("GET", "/", {}, b""))).doc["chips"] == [0]


def test_engine_device_maps_one_chip(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = get_config("llama3-8b")  # a head the kernels take
    assert tllm._engine_device("cuda", cfg, [2]) == torch.device("cuda", 2)
    assert tllm._engine_device("cuda", cfg, [0]) == torch.device("cuda", 0)
    assert tllm._engine_device("cuda", cfg, [7]) == torch.device("cuda", 0)  # not visible
    with pytest.raises(ValueError, match="single device"):
        tllm._engine_device("cuda", cfg, [1, 2])
    assert tllm._engine_device("cpu", cfg, [1, 2]) == torch.device("cpu")


def test_cpu_engine_ignores_chips_and_answers_has_session():
    eng = tllm.LLMEngine.create("tiny", options={"device": "cpu", "chips": [1, 2], "max_seq": 64})
    try:
        assert eng.device == torch.device("cpu")
        assert not eng.has_session("x")
        asyncio.run(eng.chat("x", "hi", max_tokens=2))
        assert eng.has_session("x")
    finally:
        eng.shutdown()


def test_the_persona_opens_only_a_session_the_engine_lacks():
    class Engine:
        def __init__(self):
            self.prompts = []

        def has_session(self, name):
            return name == "env-t::known"

        async def chat(self, session, message, **kw):
            self.prompts.append((session, message))
            return {"text": "ok", "prompt_tokens": 1, "completion_tokens": 1}

    app = LLMServeApp(env={**ENV, "AGENTAINER_SYSTEM_PROMPT": "Be brief."})
    app.engine = Engine()
    for session in ("known", "new"):
        body = json.dumps({"message": "hi", "session": session}).encode()
        assert asyncio.run(app.h_chat(Request("POST", "/chat", {}, body))).status == 200
    assert app.engine.prompts == [("env-t::known", "hi"), ("env-t::new", "Be brief.\n\nhi")]
