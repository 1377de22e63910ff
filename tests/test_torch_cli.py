"""The port's CLI (``agentainer_tpu_torch/cli.py``) against the JAX
package's, on the CPU.

- both ``build_parser()``s have the same verbs, ``backup`` subcommands,
  and, for each, the same option strings and positionals;
- ``--help`` runs in a fresh interpreter where ``requests`` and ``yaml``
  cannot be imported;
- against a port stack (real engine processes): ``deploy --model-dir``
  prints the build log and ``built artifact``, and ``models`` lists it;
  ``backup create / list / export / restore`` round-trip, the export
  written to the client's disk; ``deploy -f`` of a JSON deployment with a
  ``${VAR}`` starts two echo agents in dependency order; a failed envelope
  exits 1 with ``error: <message>`` — each call in an interpreter where
  ``requests`` and ``yaml`` cannot be imported.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tarfile

from agentainer_tpu import cli as jcli
from agentainer_tpu_torch import cli as tcli
from agentainer_tpu_torch.models import configs as tconfigs

from .test_torch_daemon import TOKEN, port_stack
from .test_torch_hf_convert import write_hf

_ENV = {"PYTHONPATH": ":".join(p for p in sys.path if p), "PATH": "/usr/bin:/bin"}


def _subparsers(parser: argparse.ArgumentParser) -> dict[str, argparse.ArgumentParser]:
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return dict(action.choices)
    return {}


def _shape(parser: argparse.ArgumentParser) -> dict:
    """Option strings, positionals and the subcommands' shapes, recursively."""
    options, positionals = set(), []
    for action in parser._actions:
        if isinstance(action, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        if action.option_strings:
            options.add(tuple(action.option_strings))
        else:
            positionals.append(action.dest)
    return {
        "options": sorted(options),
        "positionals": positionals,
        "sub": {name: _shape(p) for name, p in _subparsers(parser).items()},
    }


def test_the_parser_has_the_reference_verbs_and_options():
    got, want = _shape(tcli.build_parser()), _shape(jcli.build_parser())
    assert got == want
    assert set(got["sub"]) >= {"server", "deploy", "backup", "models", "faults", "audit", "logs-server", "slice"}
    assert set(got["sub"]["backup"]["sub"]) == {"create", "list", "restore", "delete", "export"}
    assert ("--model-dir",) in got["sub"]["deploy"]["options"] and ("-f", "--file") in got["sub"]["deploy"]["options"]


# the CLI as a script, in an interpreter where neither requests nor yaml
# imports (the machine with the card has neither)
_CLI = """
import runpy, sys
sys.modules["requests"] = None  # import requests -> ImportError
sys.modules["yaml"] = None
sys.argv = ["agentainer-torch", *sys.argv[1:]]
runpy.run_module("agentainer_tpu_torch.cli", run_name="__main__")
"""


def test_help_runs_without_requests_or_yaml():
    out = subprocess.run([sys.executable, "-c", _CLI, "--help"], capture_output=True, text=True, timeout=60, env=_ENV)
    assert out.returncode == 0, out.stderr
    for verb in ("deploy", "start", "stop", "pause", "resume", "backup", "audit", "invoke", "models"):
        assert verb in out.stdout


DEPLOY_JSON = {
    "apiVersion": "agentainer/v1",
    "kind": "AgentDeployment",
    "metadata": {"name": "cli-fleet"},
    "spec": {"agents": [
        {"name": "front", "model": "echo", "dependsOn": ["back"], "env": {"ROLE": "${FLEET_ROLE}"}},
        {"name": "back", "model": "${FLEET_MODEL}"},
    ]},
}


def test_the_cli_drives_a_port_stack(tmp_path):
    model_dir = tmp_path / "ckpt"
    model_dir.mkdir()
    write_hf(model_dir, tconfigs.get_config("tiny"))
    deploy_file = tmp_path / "fleet.json"
    deploy_file.write_text(json.dumps(DEPLOY_JSON))
    export_to = tmp_path / "out.tar.gz"

    async def body():
        async with port_stack(tmp_path / "port") as st:
            base = ["--server", st.url, "--token", TOKEN]

            def cli(*argv):
                return subprocess.run(
                    [sys.executable, "-c", _CLI, *base, *argv],
                    capture_output=True, text=True, timeout=120,
                    env={**_ENV, "FLEET_ROLE": "worker", "FLEET_MODEL": "echo"},
                )

            async def run(*argv):
                return await asyncio.to_thread(cli, *argv)

            out = {"deploy": await run("deploy", "--name", "cli-model", "--model-dir", str(model_dir),
                                       "--no-speculative", "--no-prefix-cache", "--no-deadlines")}
            out["models"] = await run("models")
            out["fleet"] = await run("deploy", "-f", str(deploy_file), "--start")
            out["create"] = await run("backup", "create", "--name", "nightly")
            out["list"] = await run("backup", "list")
            bid = json.loads(out["list"].stdout)[0]["id"]
            out["export"] = await run("backup", "export", bid, "-o", str(export_to))
            out["restore"] = await run("backup", "restore", bid)
            out["agents"] = await run("list", "--json")
            out["audit"] = await run("audit")
            out["missing"] = await run("start", "agent-nope")
            agents = {a.name: a for a in st.services.manager.list_agents(sync_first=False)}
            return out, agents, bid

    out, agents, bid = asyncio.run(body())
    for name, res in out.items():
        assert res.returncode == (1 if name == "missing" else 0), (name, res.stderr)
    assert "validated" in out["deploy"].stdout and "built artifact 'cli-model'" in out["deploy"].stdout
    assert "deployed cli-model" in out["deploy"].stdout
    model = agents["cli-model"].model
    assert model.engine == "llm" and model.checkpoint == str(model_dir.resolve())
    assert model.options == {"speculative": False, "prefix_cache": False, "deadlines": False}
    assert "cli-model" in out["models"].stdout and " hf " in out["models"].stdout
    lines = out["fleet"].stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines if ln.startswith("deployed")] == ["deployed back", "deployed front"]
    assert sum(ln.startswith("started") for ln in lines) == 2
    assert agents["front"].env == {"ROLE": "worker"} and agents["back"].status.value == "running"
    assert out["create"].stdout.startswith("created backup-") and "(3 agents)" in out["create"].stdout
    with tarfile.open(export_to) as tar:
        assert [m.name for m in tar.getmembers()] == [f"{bid}.json"]
    assert out["restore"].stdout.strip() == "restored 3 agents"
    names = {a["name"] for a in json.loads(out["agents"].stdout)}
    assert {"cli-model-restored", "front-restored", "back-restored"} <= names
    for action in ("artifact-build", "deploy", "start", "backup-create", "backup-export", "backup-restore"):
        assert action in out["audit"].stdout
    assert out["missing"].stderr.strip() == "error: agent not found: agent-nope"
    assert not os.path.exists(tmp_path / f"{bid}.tar.gz")  # written where -o said
