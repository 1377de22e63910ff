"""The port's sampler against the JAX sampler on identical logits.

Greedy tokens must match exactly. Sampled tokens cannot (JAX threefry vs
torch's generator), so the top-k/top-p KEEP SETS are compared instead: the
JAX keep set is read off many draws at a temperature so high that every
kept token is near-uniformly likely (4000 draws miss a kept token of a
64-token vocab with probability below 1e-26); the port's is read off
``filter_logits`` directly, and the port's own draws must stay inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine import sampling as js
from agentainer_tpu_torch.engine import sampling as ts

V = 64


def _logits(seed=0, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, V)) * 3).astype(np.float32)


def test_greedy_matches_jax_exactly():
    logits = _logits(0, b=6)
    logits[1, 10] = logits[1, 40] = logits[1].max() + 1.0  # tie: first max wins
    temps = np.zeros(6, np.float32)
    topk = np.array([0, 3, 0, 7, 1, 0], np.int32)
    topp = np.array([1.0, 0.5, 0.9, 1.0, 1.0, 0.3], np.float32)
    want = js.sample_step(jnp.asarray(logits), jax.random.PRNGKey(0), temps, topk, topp)
    got = ts.sample_step(
        torch.from_numpy(logits), None, torch.from_numpy(temps), torch.from_numpy(topk),
        torch.from_numpy(topp),
    )
    assert got.tolist() == np.asarray(want).tolist()
    assert got[1].item() == 10
    # scalar API
    want = js.sample(jnp.asarray(logits), jax.random.PRNGKey(0), 0.0)
    assert ts.sample(torch.from_numpy(logits), None, 0.0).tolist() == np.asarray(want).tolist()


def test_all_greedy_fast_path_matches_full_pipeline():
    logits = torch.from_numpy(_logits(1))
    temps = torch.zeros(4)
    topk = torch.tensor([0, 2, 5, 0])
    topp = torch.tensor([1.0, 0.7, 1.0, 0.2])
    fast = ts.sample_step(logits, None, temps, topk, topp, all_greedy=True)
    read = ts.sample_step(logits, None, temps, topk, topp)  # flag read off temps
    full = ts.sample_step(logits, torch.Generator().manual_seed(0), temps, topk, topp, all_greedy=False)
    assert fast.tolist() == read.tolist() == full.tolist() == torch.argmax(logits, -1).tolist()


@pytest.mark.parametrize(
    "topk,topp",
    [
        ([0, 5, 0, 10], [1.0, 1.0, 0.8, 0.5]),
        ([1, 64, 3, 0], [0.95, 0.2, 1.0, 0.99]),
    ],
)
def test_keep_sets_match_jax(topk, topp):
    logits = _logits(2)
    topk = np.asarray(topk, np.int32)
    topp = np.asarray(topp, np.float32)
    hot = np.full(4, 1e6, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), 4000)
    draws = jax.vmap(
        lambda k: js.sample_step(jnp.asarray(logits), k, hot, topk, topp)
    )(keys)
    draws = np.asarray(draws)
    want = [set(draws[:, lane].tolist()) for lane in range(4)]

    filtered = ts.filter_logits(
        torch.from_numpy(logits), torch.from_numpy(topk), torch.from_numpy(topp)
    )
    got = [set(torch.nonzero(row > ts.NEG_INF).flatten().tolist()) for row in filtered]
    assert got == want

    g = torch.Generator().manual_seed(0)
    temps = torch.ones(4)
    for _ in range(50):
        toks = ts.sample_step(
            torch.from_numpy(logits), g, temps, torch.from_numpy(topk), torch.from_numpy(topp)
        )
        assert all(t in keep for t, keep in zip(toks.tolist(), got))


def test_mixed_lanes_keep_greedy_lanes_exact():
    logits = torch.from_numpy(_logits(3))
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7])
    g = torch.Generator().manual_seed(0)
    toks = ts.sample_step(logits, g, temps, torch.zeros(4, dtype=torch.long), torch.ones(4))
    greedy = torch.argmax(logits, -1)
    assert toks[0] == greedy[0] and toks[2] == greedy[2]


def test_approx_topk_not_supported_yet():
    logits = torch.from_numpy(_logits(4))
    with pytest.raises(ValueError, match="approx_topk"):
        ts.sample_step(logits, None, torch.ones(4), torch.zeros(4), torch.ones(4), approx_topk=True)
