"""Runtime contracts over a live engine: the per-token disciplines that keep
serving fast, as loud assertions.

Reference: ``agentainer_tpu/analysis/hlo_contracts.py``. The reference
checks compiler output: a recompile budget over the engine's jit caches,
donated buffers aliased in the compiled module. The port compiles nothing;
its steps are eager functions on the CPU and CUDA-graph replays on the card
(``engine/graphs.py``), so the same promises are checked on what the engine
does:

- ``capture_budget`` (for ``recompile_budget``): a scripted workload
  dispatches no step key outside the warmed ``engine._step_keys()``; on the
  card no graph is captured and every dispatch is a replay.
- ``buffers_in_place`` (for ``DonationAliased``): every step writes the KV
  arena (or the paged pool) in place and rebinds no step buffer to a copy.
- ``no_implicit_sync``: the block makes no implicit host sync on the card.
- ``launches_per_replay``: the device kernels one replay of a captured step
  launches, per kernel wrapper and in all (card only).
- ``NoLargeAllGather`` and ``HasCrossReduction`` (the reference's HLO
  checks of GSPMD's collectives): over the log of the collectives a meshed
  step called (``parallel/collectives.record``), no all-gather as large as
  one shard's KV layer, and at least one cross-shard reduction.

Usage::

    with capture_budget(engine, 0), buffers_in_place(engine), no_implicit_sync():
        ...scripted mixed workload...

The reference's other HLO-text contracts (``compile_hlo``,
``op_result_elems``, ``donated_params``) read compiler output the port does
not have.
"""

from __future__ import annotations

import collections
from contextlib import contextmanager
from dataclasses import dataclass

import torch

__all__ = [
    "ContractViolation",
    "check",
    "capture_budget",
    "buffers_in_place",
    "no_implicit_sync",
    "launches_per_replay",
    "AttentionLaunches",
    "NoLargeAllGather",
    "HasCrossReduction",
]


class ContractViolation(AssertionError):
    """A contract failed; the message carries what broke it."""


def check(subject, *contracts) -> None:
    """Assert every contract (an object with ``failures(subject)``) against
    one subject."""
    problems: list[str] = []
    for c in contracts:
        problems.extend(c.failures(subject))
    if problems:
        raise ContractViolation("\n".join(problems))


@contextmanager
def _dispatch_hook(engine, hook):
    """Call ``hook(key, dispatch)`` for every step the engine dispatches
    inside the block (``LLMEngine._run_step`` is the one place a step is
    dispatched, on the worker thread); ``dispatch()`` runs the step. Hooks
    nest: each restores the one it wrapped."""
    outer = engine.__dict__.get("_run_step")
    run = engine._run_step
    engine._run_step = lambda key: hook(key, lambda: run(key))
    try:
        yield
    finally:
        if outer is None:
            del engine._run_step
        else:
            engine._run_step = outer


@contextmanager
def capture_budget(engine, budget: int):
    """Fail if the scripted workload inside the block dispatches more than
    ``budget`` step keys outside the warmed ``engine._step_keys()``.

    Warmup is the engine's promise: every prefill bucket, decode-ladder rung
    and verify bucket (or the fused loop) it will dispatch was run, and on
    the card captured, before the first request, so a steady mixed workload
    needs no new step. A shape-key regression (a stray non-bucketed size
    reaching a step key) shows up here as a key outside the set. On the card
    the block must also capture nothing (``len(engine._graphs)`` and the
    capture seconds stay) and run every dispatch as a graph replay (the
    replays grow by the dispatches: a step run eagerly after warmup is a
    step that escaped its graph)."""
    warmed = set(engine._step_keys())
    seen: collections.Counter = collections.Counter()
    graphs = engine._graphs
    before = (len(graphs), graphs.capture_s, graphs.replays) if graphs is not None else None

    def hook(key, dispatch):
        seen[key] += 1
        return dispatch()

    with _dispatch_hook(engine, hook):
        yield seen
    problems = []
    new = sorted(set(seen) - warmed, key=str)
    if len(new) > budget:
        problems.append(
            f"capture budget exceeded: {len(new)} step keys outside the warmed set "
            f"(budget {budget}): {', '.join(f'{k} x{seen[k]}' for k in new)}"
        )
    if before is not None:
        n, capture_s, replays = before
        if len(graphs) != n or graphs.capture_s != capture_s:
            problems.append(
                f"graphs captured inside the block: {n} -> {len(graphs)} graphs, "
                f"capture seconds {capture_s:.3f} -> {graphs.capture_s:.3f}"
            )
        dispatched = sum(seen.values())
        if graphs.replays - replays != dispatched:
            problems.append(
                f"{dispatched} steps dispatched but {graphs.replays - replays} graph replays: "
                "a step ran eagerly"
            )
    if problems:
        raise ContractViolation("\n".join(problems))


def _arena(engine) -> dict[str, torch.Tensor]:
    """The KV tensors every step writes: the paged pools or the dense
    arena's storage (every shard's on a mesh)."""
    names = ("k", "v") if engine.paged else ("k_store", "v_store")
    tensors = engine.cache.tensors()
    if len(tensors) == 2:
        return {f"cache.{n}": t for n, t in zip(names, tensors)}
    return {f"cache[{i // 2}].{names[i % 2]}": t for i, t in enumerate(tensors)}


@contextmanager
def buffers_in_place(engine):
    """Fail unless every step dispatched inside the block (prefill, decode,
    verify, fused loop) writes the KV arena's (or the paged pool's) tensors
    in place and no step rebinds a buffer it reads or writes to a copy.

    Each tensor of ``engine._device_state()`` (the decode carry, the verify,
    prefill and loop inputs, the block tables, the arena or pools; on the
    card the static buffers the step graphs were captured over) keeps its
    ``data_ptr()`` after every step. An eager step (the CPU's) must also
    advance the arena's version counters: torch bumps them on an in-place
    write. A graph replay writes through the captured pointers without
    Python and bumps nothing, so on the card the pointers are the check: a
    step that rebound the arena would leave the graphs writing the old one.
    Yields the steps seen, by kind."""
    start = [(t.data_ptr(), tuple(t.shape)) for t in engine._device_state()]
    start_arena = {name: t.data_ptr() for name, t in _arena(engine).items()}
    kinds: collections.Counter = collections.Counter()
    problems: list[str] = []

    def hook(key, dispatch):
        versions = {name: t._version for name, t in _arena(engine).items()}
        eager = engine._graphs is None or engine._warming
        out = dispatch()
        kinds[key[0]] += 1
        for name, t in _arena(engine).items():
            if t.data_ptr() != start_arena[name]:
                problems.append(f"step {key}: {name} rebound to a copy")
            elif eager and t._version <= versions[name]:
                problems.append(f"step {key}: {name} not written in place")
        return out

    with _dispatch_hook(engine, hook):
        yield kinds
    now = [(t.data_ptr(), tuple(t.shape)) for t in engine._device_state()]
    moved = [i for i, (a, b) in enumerate(zip(start, now)) if a != b]
    if len(now) != len(start) or moved:
        problems.append(f"step buffers rebound inside the block: _device_state() entries {moved}")
    if problems:
        raise ContractViolation("\n".join(dict.fromkeys(problems)))


@contextmanager
def no_implicit_sync():
    """Turn an implicit host sync anywhere on the card into an error inside
    the block (``torch.cuda.set_sync_debug_mode("error")``, a process-wide
    mode, so the engine's worker thread is held to it too), and restore the
    previous mode on exit. Explicit waits (an event's or a stream's
    ``synchronize``) stay allowed: they are the engine's designated sync
    points. Without a card there is nothing to sync and the block runs as
    is."""
    if not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


# The device kernels of each wrapper (``csrc/*.cu``), matched in the names
# the profiler records: its kernel's name and the arena type it is
# instantiated for. The decode combine kernel has no arena parameter: it
# belongs to the decode wrapper whose split kernel ran in the same replay.
# ``w8a16_matmul`` is ``w8a16_grouped_kernel`` at E = 1, so the two int8
# wrappers share one device kernel. Device launches per wrapper call:
# decode 2 (split, combine), the others 1.
_DEVICE_LAUNCHES_PER_CALL = {
    "flash_prefill": 1, "fused_paged_flash_prefill": 1, "flash_decode": 2,
    "fused_paged_flash_decode": 2, "w8a16_matmul": 1, "w8a16_grouped_matmul": 1,
}


def _wrapper_of(name: str, decode: str) -> str | None:
    paged = "PagedArena" in name
    if "decode_combine_kernel" in name:
        return decode
    if "decode_kernel" in name:
        return "fused_paged_flash_decode" if paged else "flash_decode"
    if "prefill_kernel" in name:
        return "fused_paged_flash_prefill" if paged else "flash_prefill"
    if "w8a16_grouped_kernel" in name:
        return "w8a16"
    return None


def launches_per_replay(graphs, key) -> dict:
    """The device kernel launches of one replay of the captured step ``key``
    (card only): one replay between two synchronizes under
    ``torch.profiler``. Returns every launch by kernel (base name), their
    total, and per kernel wrapper of ``KERNEL_WRAPPERS`` the calls its
    capture recorded and the device launches attributed to it (the two
    int8 wrappers share their kernel: ``"w8a16"``). The wrappers' ``.launches``
    are left as they were: a counting replay is no main-path call. The
    replay writes what the step writes; run it on an idle engine whose lanes
    and prefill inputs are parked (at their scratch slots).

    A profiler's first trace in a process can lose device records: compare
    the result with what the step must launch, and take it again."""
    from torch.profiler import ProfilerActivity, profile

    from ..engine.graphs import KERNEL_WRAPPERS

    counts_before = [w.launches for w in KERNEL_WRAPPERS]
    calls = {w.__name__: n for w, n in graphs._graphs[key][2]} if key in graphs._graphs else {}
    try:
        torch.cuda.synchronize(graphs.device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graphs.replay(key)
            torch.cuda.synchronize(graphs.device)
    finally:
        for w, n in zip(KERNEL_WRAPPERS, counts_before):
            w.launches = n
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    decode = "fused_paged_flash_decode" if any(
        "decode_kernel" in n and "PagedArena" in n for n in names
    ) else "flash_decode"
    by_kernel: collections.Counter = collections.Counter()
    by_wrapper: collections.Counter = collections.Counter()
    for n in names:
        base = n.removeprefix("void ").replace("(anonymous namespace)::", "").split("<")[0].split("(")[0]
        by_kernel[base] += 1
        w = _wrapper_of(n, decode)
        if w is not None:
            by_wrapper[w] += 1
    wrappers = {
        w.__name__: {
            "calls": calls.get(w.__name__, 0),
            "device": by_wrapper.get(w.__name__, 0),
            "per_call": _DEVICE_LAUNCHES_PER_CALL[w.__name__],
        }
        for w in KERNEL_WRAPPERS
    }
    wrappers["w8a16"] = {
        "calls": calls.get("w8a16_matmul", 0) + calls.get("w8a16_grouped_matmul", 0),
        "device": by_wrapper.get("w8a16", 0),
        "per_call": 1,
    }
    return {"key": list(key), "all": len(names), "kernels": dict(by_kernel), "wrappers": wrappers}


_ATTENTION = ("flash_prefill", "flash_decode", "fused_paged_flash_prefill", "fused_paged_flash_decode")


@dataclass
class AttentionLaunches:
    """What one replay of a step must launch (``launches_per_replay``'s
    result, through ``check``): the engine's arena's attention wrapper of
    the step — its decode wrapper for a decode rung of ``n`` steps, its
    prefill wrapper for a prefill bucket or a verify round (one forward) —
    called once per layer per forward, each call making its device
    launches (decode 2, prefill 1), and no other attention wrapper; the
    int8 kernel exactly as often as the capture called the int8 wrappers (0
    for bf16 weights). A fused loop's launches depend on its data and are
    not held here."""

    n_layers: int
    paged: bool
    shards: int = 1  # a mesh's: every shard attends in every layer

    def failures(self, got: dict) -> list[str]:
        kind, n = got["key"][0], got["key"][1]
        if kind == "fused":
            return []
        prefix = "fused_paged_" if self.paged else ""
        name = f"{prefix}flash_decode" if kind == "decode" else f"{prefix}flash_prefill"
        calls = self.n_layers * self.shards * (n if kind == "decode" else 1)
        problems = []
        for wrapper in (*_ATTENTION, "w8a16"):
            w = got["wrappers"][wrapper]
            want_calls = calls if wrapper == name else 0 if wrapper in _ATTENTION else w["calls"]
            if w["calls"] != want_calls or w["device"] != want_calls * w["per_call"]:
                problems.append(
                    f"step {tuple(got['key'])}: {wrapper} captured {w['calls']} calls and launched "
                    f"{w['device']} device kernels, want {want_calls} and {want_calls * w['per_call']}"
                )
        return problems


@dataclass
class NoLargeAllGather:
    """No all-gather of ``min_elems`` elements or more per shard in a
    collective log (``parallel/collectives.record``; the reference's
    ``hlo_contracts.NoLargeAllGather``). The never-all-gather invariant:
    under a tp mesh the KV arena (or page pool) stays shard-local, so an
    all-gather the size of one shard's KV means the cache was put back
    together and the sharding is decorative. Small gathers (the
    vocab-sharded logits) pass."""

    min_elems: int
    what: str = "the KV shard"

    def failures(self, log: list[dict]) -> list[str]:
        big = [e for e in log if e["kind"] == "all_gather" and e["elements"] >= self.min_elems]
        if big:
            return [f"all-gather of {self.what} (>= {self.min_elems} elements per shard): {big}"]
        return []


@dataclass
class HasCrossReduction:
    """At least one cross-shard reduction in a collective log: the sharded
    computation communicates. None means each shard computed the whole
    answer or the partial sums were dropped."""

    def failures(self, log: list[dict]) -> list[str]:
        if not any(e["kind"] == "all_reduce" for e in log):
            return ["no cross-shard reduction in the collective log: sharding dropped?"]
        return []
