"""Nothing the benchmark imports, or that its run imports transitively, has
the top-level name of JAX or of the JAX package (compared whole, so the
port's ``agentainer_tpu_torch`` passes), and the reference imports nothing
of the program."""

import ast
import os
import subprocess
import sys

from portbench.core import FORBIDDEN, forbidden_modules
from portbench.tests.conftest import CHECKOUT

BENCH = os.path.join(CHECKOUT, "portbench")


def imported(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def sources(under: str):
    for root, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        assert not imported(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        assert "agentainer_tpu_torch" not in imported(path), path


def test_the_names_are_compared_whole():
    names = ["agentainer_tpu_torch", "agentainer_tpu_torch.engine.llm", "jaxtyping", "flax_like"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["jax.numpy", "agentainer_tpu.engine", "jaxlib"]) == [
        "agentainer_tpu", "jax", "jaxlib"]


def test_a_run_loads_neither():
    """A whole run of a tiny cell on the CPU, in a fresh interpreter, holds
    no module of JAX or of the JAX package once its window has closed."""
    code = (
        "import time, torch\n"
        "from portbench import core\n"
        "from portbench.shapes import shapes_of\n"
        "from portbench.tests import tiny\n"
        "run = core.run_cell(s=shapes_of('tiny', tiny.TINY), raw=tiny.TINY, mix_params=tiny.BATCH,"
        " cell=tiny.cell(), seed=3, seconds=0.5, trace=False, device=torch.device('cpu'),"
        " t_start=time.perf_counter(), dtype=torch.float32)\n"
        "assert run['record']['requests']\n"
        "print('FOUND', core.forbidden_modules())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout, out.stdout[-2000:]
