"""The port's declarative deployments (``manager/deployconfig.py``) against
the JAX package's, on the CPU, on the same files.

The parser cases of ``tests/test_cli_yaml.py``: the shipped
``examples/*.yaml`` and a test document parse to equal configs in both
packages; ``parse_quantity``'s table; ``${VAR}`` expansion; every
validation error (same class and message); a forward ``dependsOn``; and
``apply_deployment``'s start order on a fake backend. Without PyYAML
(``yaml`` made unimportable): a JSON document gives the config PyYAML
gives, and a YAML-only document raises ``InvalidInput`` naming PyYAML.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import pytest
import yaml

from agentainer_tpu.manager import deployconfig as jdc
from agentainer_tpu.manager.agents import AgentManager as JAgentManager
from agentainer_tpu.runtime.backend import FakeBackend as JFakeBackend
from agentainer_tpu.runtime.scheduler import SliceScheduler as JSliceScheduler
from agentainer_tpu.runtime.scheduler import SliceTopology as JSliceTopology
from agentainer_tpu.store import MemoryStore as JMemoryStore
from agentainer_tpu_torch.core.errors import InvalidInput
from agentainer_tpu_torch.manager import deployconfig as tdc
from agentainer_tpu_torch.manager.agents import AgentManager
from agentainer_tpu_torch.runtime.backend import FakeBackend
from agentainer_tpu_torch.runtime.scheduler import SliceScheduler, SliceTopology
from agentainer_tpu_torch.store import MemoryStore

EXAMPLES = sorted((pathlib.Path(__file__).resolve().parent.parent / "examples").glob("*.yaml"))

YAML_DOC = """
apiVersion: agentainer/v1
kind: AgentDeployment
metadata:
  name: demo-fleet
spec:
  agents:
    - name: backendsvc
      model: echo
      replicas: 2
      engineReplicas: 2
      env:
        ROLE: worker
      resources:
        chips: 1
        hbm: 2G
      autoRestart: true
      healthCheck:
        endpoint: /health
        interval_s: 5
        retries: 2
    - name: frontend
      model:
        engine: llm
        config: tiny
        options: {device: cpu, speculative: false}
      dependsOn: [backendsvc]
"""


def _asdict(config) -> dict:
    return dataclasses.asdict(config)


def _error(fn, *args) -> tuple[str, str]:
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_shipped_examples_parse_equal(path):
    got = tdc.load_deployment(str(path))
    assert _asdict(got) == _asdict(jdc.load_deployment(str(path)))
    assert got.agents and all(list(tdc.fan_out(spec)) for spec in got.agents)
    assert [[n for n, _ in tdc.fan_out(s)] for s in got.agents] == [
        [n for n, _ in jdc.fan_out(s)] for s in jdc.load_deployment(str(path)).agents
    ]


def test_parse_quantity():
    for value in ("2G", "2Gi", "512M", "512Mi", 123, 1.5e9, " 3 k ", "1.5Ti", "7", "7b"):
        assert tdc.parse_quantity(value) == jdc.parse_quantity(value)
    assert tdc.parse_quantity("2Gi") == 2 * 1024**3 and tdc.parse_quantity("2G") == 2 * 1000**3
    for bad in ("12q", "G", ""):
        got = _error(tdc.parse_quantity, bad)
        assert got == _error(jdc.parse_quantity, bad) and got[0] == "InvalidInput"
    # a number float() refuses surfaces as its ValueError, in both packages
    assert _error(tdc.parse_quantity, "1.2.3x") == _error(jdc.parse_quantity, "1.2.3x")


def test_load_and_fan_out(tmp_path):
    path = tmp_path / "deploy.yaml"
    path.write_text(YAML_DOC)
    got = tdc.load_deployment(str(path))
    assert _asdict(got) == _asdict(jdc.load_deployment(str(path)))
    assert got.name == "demo-fleet"
    assert [a.name for a in got.agents] == ["backendsvc", "frontend"]  # dependency first
    assert [n for spec in got.agents for n, _ in tdc.fan_out(spec)] == ["backendsvc-1", "backendsvc-2", "frontend"]
    be = got.agents[0]
    assert be.resources.hbm_bytes == 2 * 1000**3 and be.engine_replicas == 2
    assert be.auto_restart and be.health_check.retries == 2


def test_env_expansion(tmp_path, monkeypatch):
    monkeypatch.setenv("MY_MODEL", "echo")
    path = tmp_path / "d.yaml"
    path.write_text("kind: AgentDeployment\nspec:\n  agents:\n    - name: a\n      model: ${MY_MODEL}\n")
    got = tdc.load_deployment(str(path))
    assert got.agents[0].model.engine == "echo"
    assert _asdict(got) == _asdict(jdc.load_deployment(str(path)))


BAD = {
    "kind": {"kind": "Deployment"},
    "empty": {"kind": "AgentDeployment", "spec": {"agents": []}},
    "no-name": {"kind": "AgentDeployment", "spec": {"agents": [{"model": "echo"}]}},
    "duplicate": {"kind": "AgentDeployment", "spec": {"agents": [{"name": "a"}, {"name": "a"}]}},
    "replicas": {"kind": "AgentDeployment", "spec": {"agents": [{"name": "a", "replicas": -1}]}},
    "engine-replicas": {"kind": "AgentDeployment", "spec": {"agents": [{"name": "a", "engineReplicas": 65}]}},
    "hbm": {"kind": "AgentDeployment", "spec": {"agents": [{"name": "a", "resources": {"hbm": "9Q"}}]}},
    "unknown-dep": {"kind": "AgentDeployment", "spec": {"agents": [{"name": "a", "dependsOn": ["zzz"]}]}},
    "cycle": {"kind": "AgentDeployment", "spec": {"agents": [
        {"name": "a", "dependsOn": ["b"]}, {"name": "b", "dependsOn": ["a"]},
    ]}},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_errors(case):
    got = _error(tdc.parse_deployment, BAD[case])
    assert got == _error(jdc.parse_deployment, BAD[case])
    assert got[0] == "InvalidInput" and tdc.InvalidInput is InvalidInput
    if case == "cycle":
        assert "cycle" in got[1]


def test_forward_dependency_ok():
    doc = {"kind": "AgentDeployment", "spec": {"agents": [
        {"name": "first", "dependsOn": ["second"]}, {"name": "second"},
    ]}}
    got = tdc.parse_deployment(doc)
    assert [a.name for a in got.agents] == ["second", "first"]
    assert _asdict(got) == _asdict(jdc.parse_deployment(doc))


def test_apply_deployment_starts_in_order(tmp_path):
    path = tmp_path / "deploy.yaml"
    path.write_text(YAML_DOC.replace("engine: llm", "engine: echo"))
    runs = {}
    for name, dc, manager in (
        ("ref", jdc, JAgentManager(s := JMemoryStore(), JFakeBackend(), JSliceScheduler(s, JSliceTopology(total_chips=8)))),
        ("port", tdc, AgentManager(s := MemoryStore(), FakeBackend(), SliceScheduler(s, SliceTopology(total_chips=8)))),
    ):
        created = dc.apply_deployment(manager, dc.load_deployment(str(path)), start=True)
        runs[name] = (
            [a.name for a in created],
            {a.name: a.status.value for a in manager.list_agents(sync_first=False)},
        )
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == ["backendsvc-1", "backendsvc-2", "frontend"]
    assert set(runs["port"][1].values()) == {"running"}


def test_json_reads_the_same_as_yaml(tmp_path):
    """PyYAML reads a JSON document to the dict ``json`` reads: the two
    paths give one config."""
    doc = yaml.safe_load(YAML_DOC)
    path = tmp_path / "deploy.json"
    path.write_text(json.dumps(doc, indent=2))
    assert yaml.safe_load(path.read_text()) == json.loads(path.read_text()) == doc
    assert _asdict(tdc.load_deployment(str(path))) == _asdict(jdc.load_deployment(str(path)))


def test_without_pyyaml_json_loads_and_yaml_names_the_package(tmp_path, monkeypatch):
    yaml_path = tmp_path / "deploy.yaml"
    yaml_path.write_text(YAML_DOC)
    json_path = tmp_path / "deploy.json"
    json_path.write_text(json.dumps(yaml.safe_load(YAML_DOC)))
    with_yaml = _asdict(tdc.load_deployment(str(yaml_path)))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml → ImportError
    assert _asdict(tdc.load_deployment(str(json_path))) == with_yaml
    with pytest.raises(InvalidInput, match="PyYAML"):
        tdc.load_deployment(str(yaml_path))
