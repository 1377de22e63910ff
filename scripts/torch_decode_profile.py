"""Trace the PyTorch port's served decode on one GPU with torch.profiler.

    python scripts/torch_decode_profile.py [int8] [--fused] [--package DIR]

Builds the port's llama3-8b engine (bf16, random weights from seed 0; with
``int8``, the same weights quantized by ``quant: int8``) on the first CUDA
device, serves LANES concurrent greedy requests of TOKENS
tokens once untraced (warm) and once under torch.profiler, and
prints one JSON line: the card, wall time, tokens, engine ITL/TTFT, device
busy time (the union of GPU kernel intervals, kernels replayed from CUDA
graphs included), the device's idle share, kernel launches in the trace
and per decode step of the batch, the engine's graph replays and host syncs
per token in the traced window, the ten kernels with the most device
time, and, after the warm serve and before any profiler came up, what one
decode step of the engine's 8-step decode graph costs with lanes 0-1 live
at 300 / 312 and 6 parked: its device time (the median of REPLAYS
replays, each timed with CUDA events) and the host time of the replay
call itself (the launch, from an idle device). It also prints the
engine's up seconds (``create``: weights, warmup and graph capture), its
graph capture seconds (the prefill graphs' share beside it) and pool
bytes, and the TTFT, ITL p50 and wall time of the untraced warm serve.
``--fused`` builds the engine with ``fused_decode`` (in-loop spec on, as by
default): its decode step is then one iteration of an idle loop of the
full bound (lanes 0-1 live, no history, every iteration run), timed the
same way per iteration, and again once the loop graphs were assembled
anew after the profiler came up (the traced window runs those), and the
decode steps of the traced window are the loops' iterations. ``--package DIR``
imports ``agentainer_tpu_torch`` from the checkout at DIR instead (another
commit's engine under this script, to time two in turns). Needs a CUDA
device; exits 2 without one.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import subprocess
import sys
import time

LANES = 2
TOKENS = 48
REPLAYS = 10


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _decode_step_ms(eng) -> dict:
    """Device ms and host launch ms of one decode step of the idle
    engine's 8-step greedy graph (a fused engine: one iteration of its
    greedy loop at the full bound, every iteration run), lanes 0-1 live at
    300 / 312, the rest parked."""
    import torch

    from agentainer_tpu_torch.engine import graphs

    fused = getattr(eng, "fused_decode", False)
    key = ("fused", eng._fused_cap, True) if fused else ("decode", 8, True)
    steps = key[1]

    def arm():
        graphs.live_lanes(eng, [300, 312], 0.0, seed=0)
        if fused:
            # budgets past the bound: no lane freezes before it
            graphs.live_fused(eng, [300, 312], 0.0, seed=0, nsteps=steps, budgets=[4 * steps] * 2)
            with eng._on_stream():
                eng._dhlen.zero_()  # no history: every iteration is a plain decode step

    arm()
    try:
        with torch.no_grad(), eng._on_stream():
            host = []
            for _ in range(REPLAYS):
                arm()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng._graphs.replay(key)
                host.append(time.perf_counter() - t0)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            device = []
            for _ in range(REPLAYS):
                arm()
                start.record()
                out = eng._graphs.replay(key)
                end.record()
                end.synchronize()
                device.append(start.elapsed_time(end))
            if fused:
                steps = int(out[eng._fused_cap + 3, 0])
            return {
                "device_ms": sorted(device)[len(device) // 2] / steps,
                "host_launch_ms": 1e3 * sorted(host)[len(host) // 2] / steps,
                "steps_per_replay": steps,
            }
    finally:
        graphs.park_lanes(eng)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "--package" in args:
        i = args.index("--package")
        package = os.path.abspath(args[i + 1])
        del args[i : i + 2]
    sys.path.insert(0, package)
    from agentainer_tpu_torch.engine.llm import LLMEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    fused = "--fused" in args
    if fused:
        args.remove("--fused")
    quant = "int8" if args == ["int8"] else ""
    t_up = time.perf_counter()
    eng = LLMEngine.create(
        "llama3-8b", options={"device": "cuda", "seed": 0, "quant": quant, "fused_decode": fused}
    )
    engine_up_s = time.perf_counter() - t_up

    async def serve():
        return await asyncio.gather(*(
            eng.generate(f"lane {i}: tell me a long story", max_tokens=TOKENS, ignore_eos=True)
            for i in range(LANES)
        ))

    try:
        itl0 = len(eng.itl_ms_recent)
        t0 = time.perf_counter()
        warm = asyncio.run(serve())  # warm, untraced
        warm_wall_s = time.perf_counter() - t0
        itl_warm = sorted(list(eng.itl_ms_recent)[itl0:])
        # the step's time from the graphs built at warmup, before any
        # profiler came up
        step_ms = _decode_step_ms(eng)
        step_rebuilt = None
        if fused:
            # the profiler traces every loop iteration only of a loop graph
            # instantiated after it first came up (StepGraphs.rebuild_loop)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.cuda.synchronize()
            for greedy in (True, False):
                eng._graphs.rebuild_loop(("fused", eng._fused_cap, greedy))
            step_rebuilt = _decode_step_ms(eng)
        steps0, itl0 = eng.decode_steps, len(eng.itl_ms_recent)
        m0 = eng.metrics()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = asyncio.run(serve())
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        itl = sorted(list(eng.itl_ms_recent)[itl0:])
        steps = eng.decode_steps - steps0
        m1 = eng.metrics()
    finally:
        eng.shutdown()

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = collections.defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kernels])
    tokens = sum(r["completion_tokens"] for r in out)
    hist0 = m0["decode_chunk_hist"]
    # batch-wide decode steps: each chunk of c steps advances every lane c
    # tokens; a fused loop's steps are the iterations it ran
    token_steps = (
        m1["fused_steps_total"] - m0["fused_steps_total"] if fused
        else sum(int(c) * (n - hist0.get(c, 0)) for c, n in m1["decode_chunk_hist"].items())
    )
    syncs = m1.get("host_syncs_total", 0) - m0.get("host_syncs_total", 0)
    print(json.dumps({
        "card": card,
        "package": package,
        "quant": quant or None,
        "fused_decode": fused,
        "fused_loops": m1.get("fused_loops_total", 0) - m0.get("fused_loops_total", 0),
        "engine_up_s": engine_up_s,
        "graph_capture_s": m1.get("graph_capture_s"),
        "prefill_graph_capture_s": m1.get("prefill_graph_capture_s"),
        "graphs_captured": m1.get("graphs_captured"),
        "graph_pool_bytes": m1.get("graph_pool_bytes"),
        "ttft_ms_untraced": [r["ttft_ms"] for r in warm],
        "itl_ms_p50_untraced": itl_warm[len(itl_warm) // 2] if itl_warm else None,
        "wall_s_untraced": warm_wall_s,
        "param_hbm_bytes": m1["param_hbm_bytes"],
        "lanes": LANES,
        "tokens": tokens,
        "wall_s": wall_s,
        "decode_chunks": steps,
        "itl_ms_p50": itl[len(itl) // 2] if itl else None,
        "ttft_ms": [r["ttft_ms"] for r in out],
        "kernel_launches": len(kernels),
        "decode_token_steps": token_steps,
        "kernel_launches_per_decode_step": len(kernels) / token_steps if token_steps else None,
        "graph_replays": m1.get("graph_replays", 0) - m0.get("graph_replays", 0),
        "host_syncs_per_token": syncs / tokens if tokens else None,
        "device_busy_s": busy_us / 1e6 if kernels else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s if kernels else None,
        "decode_step_device_ms": step_ms["device_ms"],
        "decode_step_host_launch_ms": step_ms["host_launch_ms"],
        "decode_steps_per_replay": step_ms["steps_per_replay"],
        # the loop graphs assembled again after the profiler came up, as
        # the traced window runs them
        "decode_step_device_ms_rebuilt": step_rebuilt and step_rebuilt["device_ms"],
        "decode_step_host_launch_ms_rebuilt": step_rebuilt and step_rebuilt["host_launch_ms"],
        "top_kernels_ms": {
            name[:80]: round(us / 1e3, 3)
            for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
