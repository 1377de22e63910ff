"""Traffic mixes: ``<mix>.json`` files of parameters, each naming the
generator module of this package that reads it (``"generator"``), plus
``ramp_s``, the seconds the traffic runs before the window opens.

A generator module has ``make(params, clients, max_seq, seed)``, which
returns an object with two coroutines, both given ``send``:

- ``fill(send)``: the set-up requests, if the mix has any;
- ``run(send, w1)``: every request from now until the host's clock
  (``time.perf_counter``) reaches ``w1``, sent by the generator's own
  policy (a closed loop, a schedule of arrivals).

``await send(key, session, turn, setup=False)`` serves one ``Turn``
through the engine and returns its output tokens, or None where the request
failed; ``key`` names the context the turn is served in (a client), and
``session`` the engine session that holds it ("" for none). The harness
records every request it is sent, and which of them fall in the window."""

from __future__ import annotations

import importlib
import re
from dataclasses import dataclass

# the engine's byte tokenizer without a checkpoint: bos 1, byte b → b + 3
BOS = 1
BYTE_OFFSET = 3


def encode(text: str) -> list[int]:
    return [BOS] + [b + BYTE_OFFSET for b in text.encode("utf-8")]


@dataclass
class Turn:
    text: str
    ids: list[int]  # the prompt's tokens as the engine encodes the text
    context: list[int]  # every token of the context once the prompt is in
    max_tokens: int
    think_s: float
    fresh: bool  # opens a new context (else continues the resident one)
    need_start: int  # first context position whose compute the turn needs

    @property
    def ctx0(self) -> int:
        """The context length once the prompt is in: the first output's
        position."""
        return len(self.context)


def generator(name: str):
    """The generator module ``<name>.py`` of this package."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name or ""):
        raise ValueError(f"no traffic generator {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
