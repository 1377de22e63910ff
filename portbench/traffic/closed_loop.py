"""The general generator of closed-loop traffic: a fixed number of clients,
each sending its next request only once its previous reply has come and a
think time has passed (an agent that waits for its reply and then runs a
tool). A mix's ``.json`` sets it:

- ``sessions``: a client keeps one engine session, whose KV stays resident
  between its turns, and a turn sends only its new tokens. A session whose
  next turn would not fit into the engine's ``max_seq`` ends, and the
  client starts a fresh context in its place (the engine resets a
  session's context when a prompt does not fit: ``_admit_prologue``);
- ``system_prompt_tokens``: a fresh context opens with a shared system
  prompt of this many tokens (0: none);
- ``prompt_tokens``, ``output_tokens``, ``think_s``: distributions of a
  turn's new tokens, its output tokens and the wait before it;
- ``fill_tokens``: a distribution of the message of each session's first
  turn, served in set-up, so that the window opens on sessions spread over
  their lives rather than all at their start.

Distributions: ``{"dist": "loguniform"|"uniform", "lo", "hi"}``,
``{"dist": "exponential", "mean"}``, ``{"dist": "fixed", "value"}``,
``{"dist": "none"}`` (0).

Each seed draws its own sizes and think times, each as evenly spread over
its distribution as a stratified sample: the k-th draw of the client in
slot p takes the ``k·clients + p``-th point of a Weyl sequence
(``frac(s + i·α)``, one irrational ``α`` for each quantity), whose offset
``s`` is drawn from the seed, and the seed also sets which client holds
which slot. Two seeds therefore run different requests of the same
distribution, while the work of a run moves little with its seed. The
text of each prompt is printable ASCII drawn from the seed, one token a
character under the engine's byte tokenizer (``encode``)."""

from __future__ import annotations

import asyncio
import math
import time

import numpy as np

from . import Turn, encode

_ALPHA = {"prompt": 0.6180339887498949, "output": 0.41421356237309515, "think": 0.7320508075688772}
_QUANTITIES = ("prompt", "output", "think", "fill")


def draw(spec: dict, u: float) -> float:
    """The ``u``-quantile (0 ≤ u < 1) of a distribution ``spec``."""
    kind = spec.get("dist", "none")
    if kind == "none":
        return 0.0
    if kind == "fixed":
        return float(spec["value"])
    if kind == "uniform":
        return spec["lo"] + u * (spec["hi"] - spec["lo"])
    if kind == "loguniform":
        return math.exp(math.log(spec["lo"]) + u * (math.log(spec["hi"]) - math.log(spec["lo"])))
    if kind == "exponential":
        return -spec["mean"] * math.log1p(-u)
    raise ValueError(f"unknown distribution {kind!r}")


class Mix:
    """One mix's draws for a run: ``params`` (the mix's file), ``clients``,
    the engine's ``max_seq`` and the run's ``seed``."""

    def __init__(self, params: dict, clients: int, max_seq: int, seed: int):
        if params.get("generator") != "closed_loop":
            raise ValueError(f"mix is for generator {params.get('generator')!r}")
        self.params = params
        self.clients = clients
        self.max_seq = max_seq
        self.seed = int(seed) % (1 << 64)
        self.sessions = bool(params.get("sessions", False))
        self.system_tokens = int(params.get("system_prompt_tokens", 0) or 0)
        # the slot each client holds, and each quantity's offset
        self._slot = np.random.default_rng([self.seed, 0]).permutation(clients).tolist()
        self._offset = {q: float(np.random.default_rng([self.seed, 4, i]).random()) for i, q in enumerate(_QUANTITIES)}

    def _u(self, quantity: str, client: int, k: int) -> float:
        i = k * self.clients + self._slot[client]
        return (self._offset[quantity] + i * _ALPHA[quantity]) % 1.0

    def sizes(self, client: int, k: int) -> tuple[int, int]:
        """(prompt tokens, output tokens) of client ``client``'s ``k``-th turn."""
        p = round(draw(self.params["prompt_tokens"], self._u("prompt", client, k)))
        o = round(draw(self.params["output_tokens"], self._u("output", client, k)))
        return max(1, p), max(1, o)

    def think_s(self, client: int, k: int) -> float:
        return draw(self.params.get("think_s", {"dist": "none"}), self._u("think", client, k))

    def fill_tokens(self, client: int) -> int:
        """The message tokens of client ``client``'s set-up turn: one stratum
        of the fill distribution a slot."""
        u = ((self._slot[client] + 0.5) / self.clients + self._offset["fill"]) % 1.0
        return max(1, round(draw(self.params["fill_tokens"], u)))

    def text(self, client: int, k: int, n_chars: int, stream: int = 1) -> str:
        rng = np.random.default_rng([self.seed, stream, client, k])
        return rng.integers(32, 127, n_chars, dtype=np.uint8).tobytes().decode("ascii")

    def system_text(self) -> str:
        """The shared system prompt's text: ``system_prompt_tokens`` tokens
        with the bos."""
        if not self.system_tokens:
            return ""
        rng = np.random.default_rng([self.seed, 3])
        return rng.integers(32, 127, self.system_tokens - 1, dtype=np.uint8).tobytes().decode("ascii")


class Client:
    """One client's context as the engine holds it: ``ids`` is every token
    of the current context, the last output token (held pending by the
    engine until the next turn feeds it) included."""

    def __init__(self, mix: Mix, index: int):
        self.mix = mix
        self.index = index
        self.session = f"client-{index}" if mix.sessions else ""
        self.ids: list[int] = []
        self.k = 0
        self._system = mix.system_text()

    def _fresh(self, message: str, max_tokens: int, think_s: float) -> Turn:
        text = self._system + message
        ids = encode(text)
        return Turn(text, ids, ids, max_tokens, think_s, True, min(self.mix.system_tokens, len(ids) - 1))

    def fill_turn(self) -> Turn:
        """The set-up turn: the system prompt and a fill message, one token
        out."""
        return self._fresh(self.mix.text(self.index, 0, self.mix.fill_tokens(self.index) - 1, stream=2), 1, 0.0)

    def next_turn(self) -> Turn:
        k = self.k
        self.k += 1
        n_prompt, n_out = self.mix.sizes(self.index, k)
        message = self.mix.text(self.index, k, n_prompt - 1)
        think = self.mix.think_s(self.index, k)
        if self.mix.sessions and self.ids and len(self.ids) + n_prompt + n_out <= self.mix.max_seq - 2:
            ids = encode(message)
            # the engine feeds the pending output token, then the prompt
            return Turn(message, ids, self.ids + ids, n_out, think, False, len(self.ids) - 1)
        turn = self._fresh(message, n_out, think)
        if self.mix.sessions and self.ids and len(self.ids) + len(turn.ids) + n_out <= self.mix.max_seq - 1:
            raise ValueError("a fresh context would not reset the session")  # sizes out of range
        if turn.ctx0 + n_out > self.mix.max_seq - 1:
            raise ValueError(f"turn of {turn.ctx0} + {n_out} tokens does not fit max_seq {self.mix.max_seq}")
        return turn

    def served(self, turn: Turn, tokens: list[int]) -> None:
        """Record a turn's output: the context now ends with it."""
        self.ids = turn.context + list(tokens)


class ClosedLoop:
    """The mix's clients, each in its loop: send, wait for the reply, think,
    send again."""

    def __init__(self, mix: Mix):
        self.mix = mix
        self.clients = [Client(mix, c) for c in range(mix.clients)]

    async def _send(self, send, client: Client, turn: Turn, setup: bool = False) -> bool:
        tokens = await send(client.index, client.session, turn, setup=setup)
        if tokens is None:
            return False
        client.served(turn, tokens)
        return True

    async def fill(self, send) -> None:
        """Set-up: each session's first turn, the first alone (its shared
        prefix registers in the prefix cache), the rest together."""
        if not self.mix.params.get("fill_tokens"):
            return
        await self._send(send, self.clients[0], self.clients[0].fill_turn(), setup=True)
        await asyncio.gather(*(self._send(send, c, c.fill_turn(), setup=True) for c in self.clients[1:]))

    async def run(self, send, w1: float) -> None:
        """Every client's loop until ``w1``; a client whose request failed
        stops."""
        async def loop(client: Client) -> None:
            while True:
                turn = client.next_turn()
                await asyncio.sleep(turn.think_s)
                if time.perf_counter() >= w1 or not await self._send(send, client, turn):
                    return

        await asyncio.gather(*(loop(c) for c in self.clients))


def make(params: dict, clients: int, max_seq: int, seed: int) -> ClosedLoop:
    return ClosedLoop(Mix(params, clients, max_seq, seed))
