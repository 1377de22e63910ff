"""The port imports neither JAX nor the JAX package, nor the packages the
machine with the card lacks (``ml_dtypes``, ``safetensors``, ``orbax``,
``tokenizers``, ``regex``).

Runs in a fresh interpreter (this test process has JAX loaded by
conftest): import every module of ``agentainer_tpu_torch``, then list the
loaded modules. ``agentainer_tpu_torch`` itself starts with the string
``agentainer_tpu``, so the check matches the reference package by its
exact name or its ``agentainer_tpu.`` prefix.
"""

import json
import subprocess
import sys

_PROBE = """
import importlib, json, pkgutil, sys
import agentainer_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
leaked = sorted(
    n for n in sys.modules
    if n == "jax" or n.startswith(("jax.", "jaxlib"))
    or n == "agentainer_tpu" or n.startswith("agentainer_tpu.")
    or n.split(".")[0] in ("ml_dtypes", "safetensors", "orbax", "tokenizers", "regex")
)
print(json.dumps({"imported": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": ":".join(p for p in sys.path if p), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["leaked"] == []
    for mod in (
        "agentainer_tpu_torch.models.configs",
        "agentainer_tpu_torch.models.llama",
        "agentainer_tpu_torch.models.convert",
        "agentainer_tpu_torch.ops.attention",
        "agentainer_tpu_torch.ops.cuda_attention",
        "agentainer_tpu_torch.ops.cuda_quant",
        "agentainer_tpu_torch.ops.quant",
        "agentainer_tpu_torch.engine.quant",
        "agentainer_tpu_torch.engine.checkpoint",
        "agentainer_tpu_torch.engine.hf_convert",
        "agentainer_tpu_torch.engine.llm",
        "agentainer_tpu_torch.engine.graphs",
        "agentainer_tpu_torch.engine.llm_serve",
        "agentainer_tpu_torch.engine.sampling",
        "agentainer_tpu_torch.engine.tokenizer",
        "agentainer_tpu_torch.core.protocol",
        "agentainer_tpu_torch.utils.hw",
        "agentainer_tpu_torch.faults",
        "agentainer_tpu_torch.train",
        "agentainer_tpu_torch.analysis",
        "agentainer_tpu_torch.analysis.framework",
        "agentainer_tpu_torch.analysis.rules",
        "agentainer_tpu_torch.analysis.contracts",
        "agentainer_tpu_torch.analysis.__main__",
        "agentainer_tpu_torch.parallel",
        "agentainer_tpu_torch.parallel.mesh",
        "agentainer_tpu_torch.parallel.sharding",
        "agentainer_tpu_torch.parallel.collectives",
        "agentainer_tpu_torch.parallel.flash_mesh",
        "agentainer_tpu_torch.parallel.expert",
        "agentainer_tpu_torch.parallel.pipeline",
        "agentainer_tpu_torch.parallel.ring_attention",
        "agentainer_tpu_torch.parallel.ulysses",
        "agentainer_tpu_torch.parallel.dcn",
        *CONTROL_PLANE,
        "agentainer_tpu_torch.engine",
        "agentainer_tpu_torch.runtime.engine_main",
    ):
        assert mod in doc["imported"]


# the control plane and the echo engine: standard library only
CONTROL_PLANE = (
    "agentainer_tpu_torch.daemon",
    "agentainer_tpu_torch.config",
    "agentainer_tpu_torch.server.app",
    "agentainer_tpu_torch.server.router",
    "agentainer_tpu_torch.runtime.backend",
    "agentainer_tpu_torch.runtime.scheduler",
    "agentainer_tpu_torch.runtime.store_client",
    "agentainer_tpu_torch.runtime.local",
    "agentainer_tpu_torch.manager.agents",
    "agentainer_tpu_torch.manager.audit",
    "agentainer_tpu_torch.manager.health",
    "agentainer_tpu_torch.manager.journal",
    "agentainer_tpu_torch.manager.metrics",
    "agentainer_tpu_torch.manager.reconcile",
    "agentainer_tpu_torch.manager.replay",
    "agentainer_tpu_torch.store",
    "agentainer_tpu_torch.store.base",
    "agentainer_tpu_torch.store.memory",
    "agentainer_tpu_torch.store.schema",
    "agentainer_tpu_torch.store.native",
    "agentainer_tpu_torch.native",
    "agentainer_tpu_torch.runtime.dataplane",
    "agentainer_tpu_torch.core.errors",
    "agentainer_tpu_torch.core.spec",
    "agentainer_tpu_torch.core.resilience",
    "agentainer_tpu_torch.utils.http",
    "agentainer_tpu_torch.engine.echo",
    "agentainer_tpu_torch.cli",
    "agentainer_tpu_torch.manager.artifacts",
    "agentainer_tpu_torch.manager.backup",
    "agentainer_tpu_torch.manager.deployconfig",
    "agentainer_tpu_torch.engine.safetensors_meta",
    "agentainer_tpu_torch.parallel.dcn",
    "agentainer_tpu_torch.runtime.engine_main",
)

_STDLIB_PROBE = """
import importlib, json, sys
for name in {names!r}:
    importlib.import_module(name)
leaked = sorted(
    n for n in sys.modules
    if n.split(".")[0] in ("torch", "numpy", "aiohttp", "yaml", "requests", "jax", "jaxlib", "triton")
    or n == "agentainer_tpu" or n.startswith("agentainer_tpu.")
)
print(json.dumps(leaked))
"""


def test_control_plane_imports_no_torch_aiohttp_or_yaml():
    """The daemon never creates a CUDA context and runs where aiohttp,
    yaml and requests are missing: its modules, the CLI, the artifact,
    backup and deployment modules, the safetensors header reader, the
    echo engine, the engine entry point and the multi-host module (which
    imports ``torch.distributed`` only when it joins) load, in a fresh
    interpreter, with none of torch, numpy, aiohttp, yaml, requests or the
    JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _STDLIB_PROBE.format(names=CONTROL_PLANE)],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": ":".join(p for p in sys.path if p), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_NO_BUILD_PROBE = """
import importlib, json
for name in {names!r}:
    importlib.import_module(name)
from agentainer_tpu_torch import native
print(json.dumps([native._lib is None, native._load_error is None]))
"""


def test_native_layer_builds_nothing_at_import():
    """Importing the daemon's graph (the native loader, the native store,
    the data plane and the store client among it) neither builds nor loads
    the C++ library: that happens at first use."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_BUILD_PROBE.format(names=CONTROL_PLANE)],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": ":".join(p for p in sys.path if p), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, True]
