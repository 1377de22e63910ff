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
    """``approx_topk`` was refused before the port had it; now it samples.
    Over a vocab narrower than ``APPROX_SEG`` the segment is the whole row,
    so from one generator state it draws what the exact sampler draws."""
    logits = torch.from_numpy(_logits(4))
    temps, topk, topp = torch.ones(4), torch.tensor([0, 3, 0, 9]), torch.tensor([1.0, 1.0, 0.6, 0.8])
    approx = ts.sample_step(
        logits, torch.Generator().manual_seed(5), temps, topk, topp, approx_topk=True
    )
    exact = ts.sample_step(logits, torch.Generator().manual_seed(5), temps, topk, topp)
    assert V < ts.APPROX_SEG and approx.tolist() == exact.tolist()


# approx_topk: the segment matters only past APPROX_SEG entries
V_WIDE = 4 * ts.APPROX_SEG
KEEP_DRAWS = 8192  # rows drawn at once; a kept token of 512 is missed w.p. ~1e-7


def _jax_approx_keep_set(logits: np.ndarray, top_k: int, top_p: float) -> set:
    """The reference ``_approx`` keep set, read off one draw per row of the
    row tiled KEEP_DRAWS times, at a temperature at which every kept token
    is near-uniformly likely."""
    rows = jnp.asarray(np.tile(logits, (KEEP_DRAWS, 1)))
    draws = js.sample_step(
        rows, jax.random.PRNGKey(1), jnp.full((KEEP_DRAWS,), 1e6, jnp.float32),
        jnp.full((KEEP_DRAWS,), top_k, jnp.int32), jnp.full((KEEP_DRAWS,), top_p, jnp.float32),
        approx_topk=True,
    )
    return set(np.asarray(draws).tolist())


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("top_k", [0, 1, 50, 200])
def test_approx_topk_keep_sets_equal_the_reference(top_k, top_p):
    """Over a vocab four segments wide: top_k above the segment clamps to
    it, top-p renormalizes over the segment's mass; with both filters off
    the whole row is kept."""
    logits = (np.random.default_rng(top_k * 7 + int(top_p * 10)).standard_normal(V_WIDE) * 2).astype(np.float32)
    filtered = ts.filter_logits(
        torch.from_numpy(logits)[None], torch.tensor([top_k]), torch.tensor([top_p]), approx_topk=True
    )
    got = set(torch.nonzero(filtered[0] > ts.NEG_INF).flatten().tolist())
    assert got == _jax_approx_keep_set(logits, top_k, top_p)
    if top_k == 200:
        assert len(got) <= ts.APPROX_SEG
    g = torch.Generator().manual_seed(top_k)
    draws = ts.sample_step(
        torch.from_numpy(np.tile(logits, (64, 1))), g, torch.ones(64), torch.full((64,), top_k),
        torch.full((64,), top_p), approx_topk=True,
    )
    assert set(draws.tolist()) <= got


def test_approx_topk_keeps_the_segment_of_a_flat_distribution():
    """Flat logits: the top-p cumulative never reaches 0.99 inside the
    segment, and the cutoff index clamps to the segment's last entry."""
    logits = np.zeros(V_WIDE, np.float32)
    filtered = ts.filter_logits(
        torch.from_numpy(logits)[None], torch.tensor([0]), torch.tensor([0.99]), approx_topk=True
    )
    got = set(torch.nonzero(filtered[0] > ts.NEG_INF).flatten().tolist())
    assert got == _jax_approx_keep_set(logits, 0, 0.99) == set(range(V_WIDE))
