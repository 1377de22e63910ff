"""The reduction of a ``torch.profiler`` trace of the card to the numbers
the benchmark reports: device busy seconds (the union of the intervals in
which a kernel or a copy ran), device seconds by kernel, the operations
that took most time and the longest idle gaps by what the host was doing
during them (the arithmetic of ``scripts/torch_decode_profile.py``'s
``_union_us``, copied)."""

from __future__ import annotations

import bisect
import collections
import re

_ANON = re.compile(r"\(anonymous namespace\)::")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments:
    ``void decode_kernel<__nv_bfloat16, 4, DenseArena>(...)`` →
    ``decode_kernel``."""
    name = _ANON.sub("", name).strip()
    if name.startswith("void "):
        name = name[5:]
    for i, ch in enumerate(name):
        if ch in "<(":
            return name[:i].strip() or name
    return name


def union_s(intervals: list[tuple[int, int]]) -> float:
    """Seconds covered by ``(start_ns, end_ns)`` intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is not None and b <= end:
            continue
        total += b - (a if end is None else max(a, end))
        end = b
    return total / 1e9


def _gaps(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle stretches of ``[lo, hi]`` between merged intervals."""
    out, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def reduce_events(events: list[tuple[str, bool, int, int]], start_ns: int, end_ns: int, top: int = 10) -> dict:
    """``events``: ``(name, on_device, start_ns, end_ns)``. Returns the
    traced interval's seconds, the device's busy seconds, device seconds by
    short kernel name, and the breakdown: the ``top`` device operations by
    seconds and the ``top`` host activities by the idle device seconds
    they spanned (``no_host_call_traced`` where none did)."""
    device = [(a, b, n) for n, dev, a, b in events if dev]
    host = sorted((a, b, n) for n, dev, a, b in events if not dev)
    intervals = [(a, b) for a, b, _ in device]
    by_kernel: dict[str, float] = collections.defaultdict(float)
    for a, b, n in device:
        by_kernel[short_name(n)] += (b - a) / 1e9
    starts = [a for a, _, _ in host]
    idle: dict[str, float] = collections.defaultdict(float)
    for a, b in _gaps(intervals, start_ns, end_ns):
        mid = (a + b) // 2
        who = "no_host_call_traced"
        i = bisect.bisect_right(starts, mid) - 1
        # the innermost host activity spanning the gap's middle: the latest
        # to start among those still running there
        for j in range(i, max(-1, i - 512), -1):
            if host[j][1] >= mid:
                who = host[j][2]
                break
        idle[who] += (b - a) / 1e9
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (end_ns - start_ns) / 1e9,
        "busy_s": union_s(intervals),
        "kernel_s": dict(by_kernel),
        "breakdown": {
            "device_ops": [[n, s] for n, s in ranked[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }


def profiler_events(prof) -> tuple[list[tuple[str, bool, int, int]], int, int]:
    """A stopped ``torch.profiler.profile``'s events as ``reduce_events``
    takes them, and the traced interval in the profiler's nanoseconds
    (the same clock as ``time.time_ns``)."""
    import torch

    results = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    events = []
    for e in results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        events.append((e.name(), e.device_type() == cuda, a, b))
    start = results.trace_start_ns()
    end = max((b for _, _, _, b in events), default=start)
    return events, start, end
