"""Declarative multi-agent deployment config (K8s-flavored YAML).

Reference: ``agentainer_tpu/manager/deployconfig.py``, an own copy with
the same names, fields, validation and messages: ``apiVersion/kind/
metadata/spec.agents[]`` with per-agent replicas, env, resources,
healthCheck, autoRestart and dependencies; ``${VAR}`` expansion in the
file's content; replica fan-out to ``name-N``. Resources are ``chips``
(GPUs in the port) plus a device-memory quantity string (``12G`` /
``512M`` / ``2Gi``). Dependencies resolve against the full agent set
(forward references included) and are ordered topologically for start-up.

What differs: ``yaml`` is imported only when a file is read, never at
import, so the daemon and the CLI load where PyYAML is missing (the
machine with the card has none). There a document that parses as JSON —
which YAML contains, so PyYAML reads it to the same dict — is read with
``json``, and any other document raises ``InvalidInput`` naming PyYAML.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any

from ..core.errors import InvalidInput
from ..core.spec import HealthCheckConfig, ModelRef, Resources

_UNITS = {
    "": 1,
    "b": 1,
    "k": 1000,
    "m": 1000**2,
    "g": 1000**3,
    "t": 1000**4,
    "ki": 1024,
    "mi": 1024**2,
    "gi": 1024**3,
    "ti": 1024**4,
}


def parse_quantity(value: str | int | float) -> int:
    """``"12G"``/``"512Mi"``/``8589934592`` → bytes (ParseMemory parity,
    deployment.go:290-337)."""
    if isinstance(value, (int, float)):
        return int(value)
    m = re.fullmatch(r"\s*([0-9.]+)\s*([a-zA-Z]*)\s*", str(value))
    if not m:
        raise InvalidInput(f"cannot parse quantity {value!r}")
    num, unit = float(m.group(1)), m.group(2).lower()
    if unit not in _UNITS:
        raise InvalidInput(f"unknown unit {m.group(2)!r} in {value!r}")
    return int(num * _UNITS[unit])


@dataclass
class AgentSpecYAML:
    name: str
    model: ModelRef
    # fan-out count: N SEPARATE agents "name-i" (reference `replicas:`
    # semantics, deployment.go) — distinct from engine_replicas below
    replicas: int = 1
    # fleet engine replicas PER agent (health-aware routing, mid-decode
    # failover); 0 = the daemon's fleet.replicas default
    engine_replicas: int = 0
    env: dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    auto_restart: bool = False
    health_check: HealthCheckConfig | None = None
    depends_on: list[str] = field(default_factory=list)


@dataclass
class DeploymentConfig:
    name: str
    agents: list[AgentSpecYAML]


def load_deployment(path: str) -> DeploymentConfig:
    with open(path) as f:
        content = f.read()
    # ${VAR} / $VAR expansion in the file content (deployment.go:97 parity)
    content = os.path.expandvars(content)
    try:
        import yaml
    except ImportError:
        try:
            doc = json.loads(content) if content.strip() else {}
        except ValueError:
            raise InvalidInput(
                f"{path} is not JSON, and reading YAML needs the PyYAML package "
                f"(import yaml), which is not installed"
            ) from None
        return parse_deployment(doc or {})
    doc = yaml.safe_load(content) or {}
    return parse_deployment(doc)


def parse_deployment(doc: dict[str, Any]) -> DeploymentConfig:
    if doc.get("kind", "AgentDeployment") != "AgentDeployment":
        raise InvalidInput(f"unsupported kind {doc.get('kind')!r}")
    meta = doc.get("metadata", {}) or {}
    spec = doc.get("spec", {}) or {}
    agents_doc = spec.get("agents", []) or []
    if not agents_doc:
        raise InvalidInput("spec.agents must not be empty")

    agents: list[AgentSpecYAML] = []
    names: set[str] = set()
    for a in agents_doc:
        name = a.get("name", "")
        if not name:
            raise InvalidInput("every agent needs a name")
        if name in names:
            raise InvalidInput(f"duplicate agent name {name!r}")
        names.add(name)
        replicas = int(a.get("replicas", 1))
        if replicas < 0:
            raise InvalidInput(f"agent {name!r}: replicas must be >= 0")
        engine_replicas = int(
            a.get("engineReplicas", a.get("engine_replicas", 0)) or 0
        )
        if engine_replicas < 0 or engine_replicas > 64:
            raise InvalidInput(
                f"agent {name!r}: engineReplicas must be 0 (fleet default) to 64"
            )
        res_doc = a.get("resources", {}) or {}
        resources = Resources(
            chips=int(res_doc.get("chips", 1)),
            hbm_bytes=parse_quantity(res_doc.get("hbm", res_doc.get("hbm_bytes", 8 * 1024**3))),
        )
        hc_doc = a.get("healthCheck", a.get("health_check"))
        hc = None
        if hc_doc:
            hc = HealthCheckConfig(
                endpoint=hc_doc.get("endpoint", "/health"),
                interval_s=float(hc_doc.get("interval_s", hc_doc.get("interval", 30))),
                timeout_s=float(hc_doc.get("timeout_s", hc_doc.get("timeout", 5))),
                retries=int(hc_doc.get("retries", 3)),
            )
        agents.append(
            AgentSpecYAML(
                name=name,
                model=ModelRef.from_dict(a.get("model", a.get("image", "echo"))),
                replicas=replicas,
                engine_replicas=engine_replicas,
                env={k: str(v) for k, v in (a.get("env", {}) or {}).items()},
                resources=resources,
                auto_restart=bool(a.get("autoRestart", a.get("auto_restart", False))),
                health_check=hc,
                depends_on=list(a.get("dependsOn", a.get("depends_on", []) or [])),
            )
        )

    # dependency validation against the FULL set + cycle detection
    for a in agents:
        for dep in a.depends_on:
            if dep not in names:
                raise InvalidInput(f"agent {a.name!r} depends on unknown agent {dep!r}")
    order = _topo_order(agents)
    return DeploymentConfig(name=meta.get("name", "deployment"), agents=order)


def _topo_order(agents: list[AgentSpecYAML]) -> list[AgentSpecYAML]:
    by_name = {a.name: a for a in agents}
    seen: dict[str, int] = {}  # 0=visiting, 1=done
    out: list[AgentSpecYAML] = []

    def visit(a: AgentSpecYAML, chain: tuple[str, ...]) -> None:
        state = seen.get(a.name)
        if state == 1:
            return
        if state == 0:
            raise InvalidInput(f"dependency cycle: {' -> '.join(chain + (a.name,))}")
        seen[a.name] = 0
        for dep in a.depends_on:
            visit(by_name[dep], chain + (a.name,))
        seen[a.name] = 1
        out.append(a)

    for a in agents:
        visit(a, ())
    return out


def fan_out(spec: AgentSpecYAML) -> list[tuple[str, AgentSpecYAML]]:
    """Replica expansion to ``name-N`` (deployment.go:162-230 parity).
    replicas == 1 keeps the bare name; replicas == 0 deploys nothing
    (scale-to-zero)."""
    if spec.replicas == 0:
        return []
    if spec.replicas == 1:
        return [(spec.name, spec)]
    return [(f"{spec.name}-{i + 1}", spec) for i in range(spec.replicas)]


def apply_deployment(manager, config: DeploymentConfig, start: bool = False) -> list:
    """Deploy (and optionally start) every agent in dependency order."""
    created = []
    for spec in config.agents:
        for name, s in fan_out(spec):
            agent = manager.deploy(
                name=name,
                model=s.model,
                env=s.env,
                resources=s.resources,
                auto_restart=s.auto_restart,
                health_check=s.health_check,
            )
            created.append(agent)
            if start:
                manager.start(agent.id)
    return created
