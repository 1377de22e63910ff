"""The window's record, as the metric readers see it, and the arithmetic
they share.

``record`` (built by ``core.run_cell``):

- ``shapes`` (``shapes.Shapes``), ``peaks`` (``peaks.py``), ``max_batch``;
- ``w0``, ``w1``: the window on the host's clock (``time.perf_counter``);
- ``requests``: one dict a request, those of the ramp before the window
  included (``in_window`` false): ``t_send``,
  ``emits`` (``[t, n]``: n tokens reached the client at t), ``n_out``
  (tokens asked for), ``need_start`` and ``ctx0`` (``work.py``: the first
  prompt position the turn needs computed, and the context length once its
  prompt is in), ``fresh``, ``queue_ms`` (the engine's), ``error``,
  ``cut`` (still running when the engine stopped after the close);
- ``counters``: ``engine.metrics()`` at ``w0`` and at ``w1``;
- ``trace`` (``--trace 1``), else None: ``t0``, ``t1`` (the traced
  interval on the host's clock), ``window_s``, ``busy_s``, ``kernel_s``
  (device seconds by kernel name) and ``counters`` (``engine.metrics()``
  just before and just after the trace)."""

from __future__ import annotations

import re

from . import work


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0-100), linear between closest ranks."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def token_times(req: dict) -> list[float]:
    """The instant each output token reached the client."""
    out: list[float] = []
    for t, n in req["emits"]:
        out.extend([t] * n)
    return out


def first_token_at(req: dict) -> float | None:
    return req["emits"][0][0] if req["emits"] else None


def ttft_ms(req: dict) -> float | None:
    t = first_token_at(req)
    return None if t is None else 1e3 * (t - req["t_send"])


def tpot_ms(req: dict) -> float | None:
    times = token_times(req)
    if len(times) < 2:
        return None
    return 1e3 * (times[-1] - times[0]) / (len(times) - 1)


def completed(req: dict) -> bool:
    return req["error"] is None and len(token_times(req)) == req["n_out"]


def counter_delta(counters: tuple[dict, dict], key: str) -> float:
    return float(counters[1][key] or 0) - float(counters[0][key] or 0)


def live_lanes(record: dict) -> float | None:
    """Live lanes per decode chunk over the window: Δ(batch_occupancy ×
    decode_steps) / Δdecode_steps × max_batch (the engine's counters; its
    ``batch_occupancy`` is the mean share of lanes live at a decode
    dispatch)."""
    before, after = record["counters"]
    steps = counter_delta(record["counters"], "decode_steps")
    if steps <= 0:
        return None
    occ = after["batch_occupancy"] * after["decode_steps"] - before["batch_occupancy"] * before["decode_steps"]
    return record["max_batch"] * occ / steps


def idle_share(record: dict) -> float | None:
    """Share (%) of the traced interval in which no operation ran on the
    device: 1 − the union of its kernel and copy intervals / the interval."""
    trace = record["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def decode_token_steps(counters: tuple[dict, dict]) -> int:
    """Decode steps of the whole batch between two ``metrics()`` readings:
    a chunk of c steps advances every live lane by c tokens."""
    before, after = counters[0]["decode_chunk_hist"], counters[1]["decode_chunk_hist"]
    return sum(int(c) * (n - before.get(c, 0)) for c, n in after.items())


def decode_keys(record: dict, t0: float, t1: float) -> list[int]:
    """For every token a decode step produced that reached its client in
    ``[t0, t1]``: the positions it attended (its context position + 1)."""
    keys = []
    for req in record["requests"]:
        for i, t in enumerate(token_times(req)):
            if i and t0 <= t <= t1:
                keys.append(req["ctx0"] + i)
    return keys


def prefills(record: dict, t0: float, t1: float) -> list[tuple[int, int]]:
    """``(need_start, ctx0)`` of every turn whose first token reached its
    client in ``[t0, t1]``: the prompt positions its prefill had to
    compute."""
    out = []
    for req in record["requests"]:
        t = first_token_at(req)
        if t is not None and t0 <= t <= t1:
            out.append((req["need_start"], req["ctx0"]))
    return out


def needed_flops(record: dict, t0: float, t1: float, decode: bool = True, prefill: bool = True) -> float:
    s = record["shapes"]
    total = 0.0
    if decode:
        total += sum(work.decode_flops(s, k) for k in decode_keys(record, t0, t1))
    if prefill:
        total += sum(work.prefill_flops(s, a, b) for a, b in prefills(record, t0, t1))
    return total


def kernel_seconds(record: dict, pattern: str) -> float:
    """Device seconds of the traced kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(v for k, v in record["trace"]["kernel_s"].items() if rx.search(k))


def share(bound_s: float, kernel_s: float) -> float | None:
    """A roofline share in %, or None where nothing ran or nothing was due."""
    if kernel_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
