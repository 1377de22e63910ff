"""The multi-host backend (``parallel/dcn.py``) against the reference's
``tests/test_dcn.py``: two real OS processes join the process group over
loopback (gloo: CPU tensors), build the host mesh, and sum across the
process boundary with ``collectives.all_reduce`` over dp, as the
reference's psum does; then train one step with dp spanning the two
processes, equal to the one-device step over the whole batch. Also
``host_mesh``'s refusals, and the engine host's exit 3 when it cannot
join.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from agentainer_tpu_torch.parallel.dcn import DistConfig, dist_config_from_env, host_count, host_mesh

_WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch

    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import init_params
    from agentainer_tpu_torch.parallel import collectives
    from agentainer_tpu_torch.parallel.dcn import DistConfig, backend, host_count, host_mesh, init_distributed
    from agentainer_tpu_torch.parallel.sharding import unshard_params
    from agentainer_tpu_torch.train import leaves, make_train_step

    coordinator, pid = sys.argv[1], int(sys.argv[2])
    assert init_distributed(DistConfig(coordinator, 2, pid))
    assert init_distributed(DistConfig(coordinator, 2, pid))  # joined once
    assert host_count() == 2

    mesh = host_mesh(devices=["cpu"])  # dp spans both processes
    assert (mesh.shape["dp"], mesh.hosts) == (1, 2), mesh
    # each process contributes its local rows [0, 1]: the sum must cross
    # the process boundary, global [0, 1, 0, 1] -> 2
    local = torch.arange(2, dtype=torch.float32)
    with collectives.record() as log:
        total = collectives.all_reduce([local.sum()], mesh, "dp")[0]
    assert float(total) == 2.0, float(total)

    # one step with dp over the processes, each its half of the batch,
    # against the one-device step over the whole batch
    cfg = get_config("tiny")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    init_fn, step_fn, shard_batch = make_train_step(cfg, device="cpu")
    state, want = step_fn(init_fn(params=params), shard_batch(tokens))
    init_fn, step_fn, shard_batch = make_train_step(cfg, mesh)
    got_state, got = step_fn(init_fn(params=params), shard_batch(tokens[2 * pid : 2 * pid + 2]))
    full = unshard_params(got_state.params.trees, mesh, got_state.params.specs)
    err = max((a - b).abs().max().item() for a, b in zip(leaves(full), leaves(state.params)))
    print(json.dumps({"pid": pid, "sum": float(total), "backend": backend(), "log": [e["kind"] for e in log],
                      "loss": float(got), "want": float(want), "param_err": err}), flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("ATPU_DIST_")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return env


def test_two_processes_sum_and_train_across_the_boundary(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), coordinator, str(i)], env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out.decode())
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        doc = json.loads(out.strip().splitlines()[-1])
        assert doc["pid"] == i and doc["sum"] == 2.0
        assert doc["log"] == ["all_reduce"]
        assert doc["backend"] in ("gloo", "cpu:gloo,cuda:nccl")
        assert abs(doc["loss"] - doc["want"]) <= 2e-5, doc
        assert doc["param_err"] <= 1e-6, doc


def test_without_configuration_nothing_joins(monkeypatch):
    """No ``ATPU_DIST_*``: disabled, one host, and the reference's env
    parsing."""
    from agentainer_tpu_torch.parallel.dcn import init_distributed

    for k in ("ATPU_DIST_COORDINATOR", "ATPU_DIST_NUM_PROCESSES", "ATPU_DIST_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert not dist_config_from_env().enabled
    assert init_distributed() is False
    assert host_count() == 1
    monkeypatch.setenv("ATPU_DIST_COORDINATOR", "h0:9911")
    monkeypatch.setenv("ATPU_DIST_NUM_PROCESSES", "2")
    monkeypatch.setenv("ATPU_DIST_PROCESS_ID", "1")
    assert dist_config_from_env() == DistConfig("h0:9911", 2, 1)
    assert not DistConfig("h0:9911", 1, 0).enabled


@pytest.mark.parametrize("tp,n", [(3, 4), (8, 4)])
def test_host_mesh_keeps_model_axes_within_a_host(tp, n):
    """A model axis that does not divide one host's devices is refused (its
    collectives would straddle hosts); one that does gives the local grid
    with dp spanning the hosts."""
    with pytest.raises(ValueError, match=f"tp\\*sp\\*ep\\*pp={tp} must divide one host's {n} devices"):
        host_mesh(tp=tp, devices=["cpu"] * n)
    mesh = host_mesh(tp=2, devices=["cpu"] * n)
    assert mesh.shape["tp"] == 2 and mesh.shape["dp"] == n // 2 and mesh.hosts == 1


def test_engine_host_exits_3_when_it_cannot_join():
    """The reference's loud failure: an engine told to join a group it
    cannot join exits 3 with the error on stderr, before serving."""
    env = _env() | {
        "AGENTAINER_ENGINE": "llm",
        "ATPU_DIST_COORDINATOR": f"127.0.0.1:{_free_port()}",
        "ATPU_DIST_NUM_PROCESSES": "2",
        "ATPU_DIST_PROCESS_ID": "2",
    }
    out = subprocess.run([sys.executable, "-m", "agentainer_tpu_torch.runtime.engine_main"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, out.stderr
    assert "torch.distributed init failed" in out.stderr
