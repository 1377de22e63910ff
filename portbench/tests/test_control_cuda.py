"""The control of ``correct`` on the card, at a size a test run holds: each
configuration as the cell serves it, on 16 lanes and a 5-s window. The
program's number stays within the cell's limit, and the reference in the
next precision below the configuration's (fp8 for bf16 weights, int4 for
int8), read at the same positions, lies over it. Run on the machine with
the card: ``python -m pytest -m cuda portbench/tests/test_control_cuda.py``."""

import time

import pytest

from portbench import core
from portbench.shapes import load_json, shapes_of

pytestmark = pytest.mark.cuda

CELLS = ["mistral-7b.agent-sessions", "mixtral-8x7b-int8.decode-batch"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(card, workload):
    config, mix_name = workload.split(".")
    raw = load_json("configs", config)
    cell = load_json("cells", workload)
    cell = dict(cell, clients=16, engine=dict(cell["engine"], max_batch=16))
    mix = load_json("traffic", mix_name)
    s = shapes_of(config, raw)
    run = core.run_cell(s=s, raw=raw, mix_params=mix, cell=cell, seed=2**31 + 77, seconds=5.0, trace=False,
                        device=card, t_start=time.perf_counter())
    control = "int4" if s.quant == "int8" else "fp8"
    sample = core.pick_contexts(run["contexts"], int(cell["check"]["contexts"]), 2**31 + 77)
    check = core.check_outputs(s, run["weights"], sample, card, ("f32", control))
    number, limit = cell["check"]["number"], cell["check"]["limit"]
    assert check[number] <= limit
    assert check[f"control_{control}_{number}"] > limit
