"""The port imports neither JAX nor the JAX package, nor the packages the
machine with the card lacks (``ml_dtypes``, ``safetensors``, ``orbax``).

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
    or n.split(".")[0] in ("ml_dtypes", "safetensors", "orbax")
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
    ):
        assert mod in doc["imported"]
