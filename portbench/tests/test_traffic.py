"""The traffic generators: the harness finds a mix's generator by name and
leaves the loop to it; one seed repeats exactly, seeds draw different
sizes, each seed's draws spread evenly over the distribution, and the sizes
keep to the mixes' ranges."""

import asyncio
import math
import statistics
import time

import pytest

from portbench import core
from portbench.shapes import load_json
from portbench.traffic import BOS, BYTE_OFFSET, encode, generator
from portbench.traffic.closed_loop import Client, Mix

SEED = 2**31 + 11
# each mix at the lanes and context of the cell that runs it
MIXES = [("agent-sessions", 32, 12288), ("decode-batch", 64, 1024)]


def plan(mix: Mix, turns: int = 8):
    out = []
    for c in range(mix.clients):
        client = Client(mix, c)
        fill = client.fill_turn() if mix.params.get("fill_tokens") else None
        if fill:
            client.served(fill, [7])
        for _ in range(turns):
            turn = client.next_turn()
            out.append((c, turn.text, turn.max_tokens, turn.think_s, turn.fresh, turn.ctx0))
            client.served(turn, [9] * turn.max_tokens)
    return out


@pytest.mark.parametrize("name,clients,max_seq", MIXES)
def test_one_seed_repeats_and_seeds_differ(name, clients, max_seq):
    params = load_json("traffic", name)
    a = plan(Mix(params, clients, max_seq, SEED))
    assert a == plan(Mix(params, clients, max_seq, SEED))
    b = plan(Mix(params, clients, max_seq, SEED + 1))
    assert [x[1] for x in a] != [x[1] for x in b]
    assert [x[2] for x in a] != [x[2] for x in b]


@pytest.mark.parametrize("name,clients,max_seq", MIXES)
def test_sizes_keep_to_the_ranges(name, clients, max_seq):
    params = load_json("traffic", name)
    mix = Mix(params, clients, max_seq, SEED)
    for c in range(clients):
        for k in range(20):
            p, o = mix.sizes(c, k)
            assert params["prompt_tokens"]["lo"] <= p <= params["prompt_tokens"]["hi"]
            assert params["output_tokens"]["lo"] <= o <= params["output_tokens"]["hi"]
            assert mix.think_s(c, k) >= 0
        if params.get("fill_tokens"):
            assert params["fill_tokens"]["lo"] <= mix.fill_tokens(c) <= params["fill_tokens"]["hi"]
    for c, text, max_tokens, think, fresh, ctx0 in plan(mix, 12):
        assert ctx0 + max_tokens <= max_seq - 1
        assert all(32 <= ord(ch) < 127 for ch in text)
        if not params["sessions"]:
            assert fresh and think == 0


def test_fresh_contexts_open_with_the_shared_system_prompt():
    params = load_json("traffic", "agent-sessions")
    max_seq = 12288
    mix = Mix(params, 4, max_seq, SEED)
    client = Client(mix, 2)
    fill = client.fill_turn()
    assert fill.fresh and fill.need_start == 2048 and fill.ids[:2048] == encode(mix.system_text())
    assert len(encode(mix.system_text())) == 2048
    client.served(fill, [5])
    fresh_seen = 0
    for _ in range(40):
        turn = client.next_turn()
        if turn.fresh:
            fresh_seen += 1
            # the engine resets the context: the fresh prompt does not fit
            # beside the resident one
            assert len(client.ids) + len(turn.ids) + turn.max_tokens > max_seq - 1
            assert turn.ids[:2048] == fill.ids[:2048] and turn.context == turn.ids
        else:
            assert turn.need_start == len(client.ids) - 1
            assert turn.ids[0] == BOS and turn.ids[1] >= BYTE_OFFSET
            assert turn.context == client.ids + turn.ids
        client.served(turn, [5] * turn.max_tokens)
        assert len(client.ids) <= max_seq - 1
    assert fresh_seen >= 2


@pytest.mark.parametrize("name,clients,max_seq", MIXES)
def test_every_seed_draws_sizes_of_its_own(name, clients, max_seq):
    """Seeds differ in the sizes they draw, not only in which client holds
    them."""
    params = load_json("traffic", name)

    def drawn(seed):
        mix = Mix(params, clients, max_seq, seed)
        return sorted(mix.sizes(c, k) for c in range(clients) for k in range(10))

    base = drawn(SEED)
    for seed in range(SEED + 1, SEED + 4):
        assert drawn(seed) != base


@pytest.mark.parametrize("seed", [SEED, SEED + 1, 2**33 + 5])
@pytest.mark.parametrize("name,clients,max_seq", MIXES)
def test_the_draws_spread_like_the_distribution(name, clients, max_seq, seed):
    """On every seed, the mean prompt and output length over the first 400
    draws lies within 2% of the distribution's (400 independent draws would
    miss it by ~3.5%, one standard deviation)."""
    params = load_json("traffic", name)
    mix = Mix(params, clients, max_seq, seed)
    draws = [mix.sizes(c, k) for k in range(14) for c in range(clients)][:400]
    for i, key in ((0, "prompt_tokens"), (1, "output_tokens")):
        lo, hi = params[key]["lo"], params[key]["hi"]
        mean = (hi - lo) / math.log(hi / lo)  # a log-uniform's mean
        assert abs(statistics.mean(d[i] for d in draws) - mean) / mean < 0.02


def test_a_mix_names_its_generator():
    assert generator("closed_loop").make is not None
    for name in ("no_such_generator", "../core", ""):
        with pytest.raises((ValueError, ModuleNotFoundError)):
            core.make_traffic({"generator": name}, {"clients": 1, "engine": {"max_seq": 64}}, SEED)


def test_the_generator_runs_its_own_loop():
    """The closed loop, driven through ``send`` alone: each client sends its
    next turn once its reply has come, until the close; a client whose
    request failed stops."""
    params = {**load_json("traffic", "decode-batch"), "think_s": {"dist": "fixed", "value": 0.001}}
    gen = core.make_traffic(params, {"clients": 3, "engine": {"max_seq": 1024}}, SEED)
    sent = []

    async def send(key, session, turn, setup=False):
        sent.append(key)
        await asyncio.sleep(0.002)
        return None if key == 2 else [BYTE_OFFSET] * turn.max_tokens

    async def go():
        await gen.fill(send)
        await gen.run(send, time.perf_counter() + 0.2)

    asyncio.run(go())
    assert sent.count(2) == 1
    assert sent.count(0) > 5 and sent.count(1) > 5
