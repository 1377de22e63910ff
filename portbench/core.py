"""One run of one cell: build the program's engine from the configuration
and the cell, serve the traffic mix through ``LLMEngine.generate`` in this
process for the window, check what it served against the plain reference,
and reduce the window to the cell's metrics.

The order of a run: weights from the seed on the device; the engine and its
``warmup`` (every prefill bucket and decode rung, captured as graphs); the
set-up turns of a mix that fills its sessions; the window (``--seconds``,
traced for ``PROFILE_S`` in its middle with ``--trace 1``); the engine is
shut down once every request of the window has its first token, and its
memory freed after the device's peak is read; the reference recomputes a
sample of what was served (``check_outputs``)."""

from __future__ import annotations

import asyncio
import gc
import importlib.util
import json
import os
import random
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from . import window
from .peaks import peaks_for
from .reference.check import below_mean, control_gaps, served_gaps
from .reference.model import Reference
from .shapes import ROOT, Shapes
from .traffic import Turn, generator
from .weights import fill_weights, make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "agentainer_tpu")
PROFILE_S = 4.0  # the traced stretch of a --trace 1 window
DRAIN_S = 60.0  # how long past the close in-flight requests may take


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the JAX
    package's, the name compared whole (``agentainer_tpu_torch`` is not
    ``agentainer_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules if names is None else names)} & set(FORBIDDEN))


@dataclass
class Program:
    """What the benchmark takes from ``agentainer_tpu_torch``."""

    LLMEngine: type
    ModelConfig: type
    register: object
    QTensor: type
    load_tokenizer: object


def load_program() -> Program:
    from agentainer_tpu_torch.engine.llm import LLMEngine
    from agentainer_tpu_torch.engine.tokenizer import load_tokenizer
    from agentainer_tpu_torch.models.configs import ModelConfig, register
    from agentainer_tpu_torch.ops.quant import QTensor

    return Program(LLMEngine, ModelConfig, register, QTensor, load_tokenizer)


def program_params(prog: Program, tree: dict) -> dict:
    """The benchmark's weight tree as the program's parameter tree: the same
    tensors, an int8 leaf as its ``QTensor``."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return prog.QTensor(q=tree["q"], scale=tree["scale"])
    if isinstance(tree, dict):
        return {k: program_params(prog, v) for k, v in tree.items()}
    return tree


def build_engine(prog: Program, s: Shapes, raw: dict, cell: dict, params: dict, device):
    """The engine as ``LLMEngine.create`` builds it from its options (the
    configuration's ``engine``, then the cell's), over the benchmark's
    weights, warmed up."""
    cfg = prog.ModelConfig(
        name=s.name, vocab_size=s.vocab, dim=s.dim, n_layers=s.n_layers, n_heads=s.n_heads,
        n_kv_heads=s.n_kv_heads, ffn_dim=s.ffn_dim, max_seq_len=int(raw["max_position_embeddings"]),
        rope_theta=s.rope_theta, norm_eps=s.norm_eps, n_experts=s.n_experts,
        experts_per_token=s.experts_per_token,
    )
    if cfg.head_dim != s.head_dim:
        raise ValueError(f"{s.name}: the program derives head_dim {cfg.head_dim}, the configuration {s.head_dim}")
    prog.register(cfg)
    o = {**raw.get("engine", {}), **cell["engine"]}
    engine = prog.LLMEngine(
        cfg, params, prog.load_tokenizer(cfg.vocab_size, ""),
        max_batch=int(o["max_batch"]),
        max_seq=int(o["max_seq"]),
        decode_chunk=int(o.get("decode_chunk", 8)),
        prefill_chunk=int(o.get("prefill_chunk", 256)),
        adaptive_decode=bool(o.get("adaptive_decode", True)),
        prefix_cache=bool(o.get("prefix_cache", True)),
        prefix_cache_bytes=int(o.get("prefix_cache_bytes", 0) or 0),
        deadlines=bool(o.get("deadlines", True)),
        shed_watermark=int(o.get("shed_watermark", 0) or 0),
        speculative=bool(o.get("speculative", True)),
        spec_gamma_max=int(o.get("spec_gamma_max", 8) or 8),
        paged_kv=bool(o.get("paged_kv", False)),
        page_size=int(o.get("page_size", 64) or 64),
        kv_pages=int(o.get("kv_pages", 0) or 0),
        inloop_spec=bool(o.get("inloop_spec", True)),
        streaming=bool(o.get("streaming", False)),
        approx_topk=bool(o.get("approx_topk", False)),
        fused_decode=bool(o.get("fused_decode", False)),
        kv_tiering=bool(o.get("kv_tiering", False)),
        tier_quantize=int(o.get("tier_quantize", 1)),
        routed_moe=o.get("routed"),
        moe_capacity_factor=float(o.get("moe_cf", 2.0)),
        device=device,
    )
    engine.warmup()
    return engine


@dataclass
class Context:
    """One context a client's turns were served in: its tokens, and the
    position and token of each output the engine served in it."""

    ids: list[int]
    positions: list[int] = field(default_factory=list)
    tokens: list[int] = field(default_factory=list)


class Traffic:
    """What the mix's generator sends, served through ``engine.generate``:
    a record of every request (``window.py``) and the contexts served."""

    def __init__(self, engine):
        self.engine = engine
        self.contexts: list[Context] = []
        self._open: dict[object, Context] = {}
        self.requests: list[dict] = []
        self.w0 = float("inf")  # requests sent from here on are the window's

    async def send(self, key, session: str, turn: Turn, setup: bool = False) -> list[int] | None:
        """Serve ``turn`` in the context ``key``; its output tokens, or None
        where it failed (in set-up, a failure ends the run)."""
        req = {
            "t_send": time.perf_counter(), "emits": [], "n_out": turn.max_tokens, "need_start": turn.need_start,
            "ctx0": turn.ctx0, "fresh": turn.fresh, "queue_ms": None, "error": None, "in_window": False,
            "cut": False,
        }
        if not setup:
            req["in_window"] = req["t_send"] >= self.w0
            self.requests.append(req)
        emits = req["emits"]

        def on_tokens(start: int, ids: list[int]) -> None:  # the engine's worker thread
            emits.append((time.perf_counter(), len(ids)))

        try:
            result = await self.engine.generate(
                turn.text, max_tokens=turn.max_tokens, session=session, ignore_eos=True, emit=on_tokens,
            )
        except Exception as e:  # a failed request: counted
            if setup:
                raise
            req["error"] = repr(e)
            return None
        tokens = list(result["tokens"])
        req["queue_ms"] = (result.get("ttft_breakdown") or {}).get("queue_ms")
        ctx = self._open.get(key)
        if turn.fresh or ctx is None:
            ctx = self._open[key] = Context([])
            self.contexts.append(ctx)
        ctx.ids = turn.context + tokens
        ctx.positions.extend(range(turn.ctx0, turn.ctx0 + len(tokens)))
        ctx.tokens.extend(tokens)
        return tokens


def make_traffic(mix_params: dict, cell: dict, seed: int):
    """The cell's mix as its generator draws it for ``seed``."""
    return generator(mix_params.get("generator", "")).make(
        mix_params, int(cell["clients"]), int(cell["engine"]["max_seq"]), seed,
    )


async def _window(
    engine, traffic: Traffic, gen, ramp_s: float, seconds: float, trace: bool, finish: bool = False,
) -> dict:
    """The generator's traffic: its ramp (``ramp_s`` of the mix: the
    traffic runs before the window opens, so it opens on lanes in their
    steady state), then the
    window of ``seconds``, traced for ``PROFILE_S`` in its middle. At the
    close no client sends again; once every request of the window has its
    first token the engine is shut down, and a reply still running is cut
    there (``cut``: it counts for its first token, and is neither completed
    nor checked). With ``finish``, every reply runs to its end instead and
    the engine keeps serving. Either wait lasts ``DRAIN_S`` at most; a
    request that never came is failed."""
    if trace:
        await engine.profile(0.2)  # the profiler's first start stalls the worker: pay it here
    t_traffic = time.perf_counter()
    w0 = traffic.w0 = t_traffic + ramp_s
    w1 = w0 + seconds
    out: dict = {"t_traffic": t_traffic, "w0": w0, "w1": w1}

    async def marks() -> None:
        await asyncio.sleep(max(0.0, w0 - time.perf_counter()))
        out["m0"] = engine.metrics()
        await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
        out["m1"] = engine.metrics()

    async def profile() -> None:
        await asyncio.sleep(max(0.0, w0 + (seconds - PROFILE_S) / 2 - time.perf_counter()))
        before = engine.metrics()
        clock = (time.time_ns(), time.perf_counter())
        prof = await engine.profile(PROFILE_S)
        out["profile"] = (prof, before, engine.metrics(), clock)

    clients = asyncio.ensure_future(gen.run(traffic.send, w1))
    await asyncio.gather(marks(), *([profile()] if trace else []))
    deadline = w1 + DRAIN_S
    if finish:
        await asyncio.wait([clients], timeout=max(0.0, deadline - time.perf_counter()))
    else:
        while time.perf_counter() < deadline and not clients.done() and any(
            r["error"] is None and not r["emits"] for r in traffic.requests if r["in_window"]
        ):
            await asyncio.sleep(0.02)
        clients.cancel()
        await asyncio.to_thread(engine.shutdown)
    for req in traffic.requests:
        if req["error"] is None and not window.completed(req):
            if finish or not req["emits"]:
                req["error"] = "no reply by the drain's end"
            else:
                req["cut"] = True
    return out


def pick_contexts(contexts: list[Context], count: int, seed: int) -> list[Context]:
    """The longest context and others drawn from the seed, ``count`` in all."""
    served = [c for c in contexts if c.positions]
    if not served:
        return []
    longest = max(range(len(served)), key=lambda i: len(served[i].ids))
    rest = [i for i in range(len(served)) if i != longest]
    picked = [longest] + random.Random(seed).sample(rest, min(len(rest), count - 1))
    return [served[i] for i in sorted(picked)]


def gap_stats(gaps: torch.Tensor, under: torch.Tensor, prefix: str = "") -> dict:
    """Over every token read: the widest gap, its high quantiles and its
    mean, and the share (%) of tokens the reference scores under its row's
    mean logit."""
    g = gaps.double().cpu()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)).tolist()
    return {
        f"{prefix}max_logit_gap": float(g.max()), f"{prefix}p99_logit_gap": q[2], f"{prefix}p90_logit_gap": q[1],
        f"{prefix}p50_logit_gap": q[0], f"{prefix}mean_logit_gap": float(g.mean()),
        f"{prefix}below_mean_share": 100.0 * float(under.double().mean()),
    }


def check_outputs(
    s: Shapes, weights: dict, contexts: list[Context], device, precisions=("f32",), margins: bool = False,
    raw_gaps: dict | None = None,
) -> dict:
    """The reference over each context at the positions its outputs were
    served from: the gaps of the served tokens below the reference's best
    and the share under the reference's mean logit (``gap_stats``), and
    with further ``precisions`` (a control) the same of the token each puts
    first at the same positions. With ``margins``
    (an MoE configuration), the reference's narrowest router margin at the
    rows of the ten widest gaps, beside the share of all rows under 0.01."""
    if not contexts:
        return {"served_tokens": 0, "max_logit_gap": None}
    rows = [[p - 1 for p in c.positions] for c in contexts]
    ids = [c.ids for c in contexts]
    reference = Reference(s, weights, track_margins=margins and s.is_moe)
    ref = reference.logits(ids, rows, device)
    out = {"served_tokens": sum(len(c.tokens) for c in contexts)}
    per_context = [served_gaps(r, c.tokens) for r, c in zip(ref, contexts)]
    gaps = torch.cat(per_context)
    out.update(gap_stats(gaps, torch.cat([below_mean(r, c.tokens) for r, c in zip(ref, contexts)])))
    if raw_gaps is not None:
        raw_gaps["program"] = gaps.tolist()
    out["contexts_detail"] = [
        {"tokens": len(c.ids), "served": len(c.tokens), "first_served_at": c.positions[0],
         "turns": 1 + sum(1 for a, b in zip(c.positions, c.positions[1:]) if b != a + 1),
         "max_gap": float(g.max()), "p50_gap": float(g.median()),
         "first_over_1": next((c.positions[i] for i, x in enumerate(g.tolist()) if x > 1.0), None)}
        for c, g in zip(contexts, per_context)
    ]
    if reference.margins is not None:
        at_rows = torch.cat([m[torch.tensor(r, device=m.device)] for m, r in zip(reference.margins, rows)])
        widest = torch.topk(gaps, min(10, gaps.numel())).indices
        out["widest_gaps_router_margin"] = [[float(gaps[i]), float(at_rows[i])] for i in widest]
        out["rows_router_margin_under_0.01"] = float((at_rows < 0.01).double().mean())
    for p in precisions:
        if p == "f32":
            continue
        ctl = Reference(s, weights, precision=p).logits(ids, rows, device)
        ctl_gaps = torch.cat([control_gaps(r, k) for r, k in zip(ref, ctl)])
        under = torch.cat([below_mean(r, k.argmax(-1).tolist()) for r, k in zip(ref, ctl)])
        out.update(gap_stats(ctl_gaps, under, f"control_{p}_"))
        if raw_gaps is not None:
            raw_gaps[p] = ctl_gaps.tolist()
    return out


def card_info() -> dict:
    """The card's name, power limit and SM clock as ``nvidia-smi`` reads them."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
        name, power, clock = (x.strip() for x in line.split(","))
        return {"card": name, "power_limit": power, "sm_clock": clock}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {}


def load_reader(name: str, root: str = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end(name: str, record: dict, setup_s: float) -> float | None:
    """The end-to-end metrics, on the client's side of ``generate``: the
    time to first token over the requests sent in the window, the time per
    output token over the requests completed in it, the rate over every
    token that reached a client in it."""
    w0, w1 = record["w0"], record["w1"]
    reqs = [r for r in record["requests"] if r["in_window"]]
    if name == "setup_s":
        return setup_s
    tail = re.fullmatch(r"(ttft|tpot)_p(\d+)_ms", name)
    if tail and tail[1] == "ttft":
        values = [window.ttft_ms(r) if r["error"] is None else float("inf") for r in reqs]
        q = window.percentile([float("inf") if v is None else v for v in values], int(tail[2]))
        return None if q is None or q == float("inf") else q
    if tail:
        done = [r for r in record["requests"] if window.completed(r) and w0 <= window.token_times(r)[-1] <= w1]
        return window.percentile([v for v in map(window.tpot_ms, done) if v is not None], int(tail[2]))
    if name == "output_tokens_per_s":
        tokens = sum(1 for r in record["requests"] for t in window.token_times(r) if w0 <= t <= w1)
        return tokens / (w1 - w0)
    raise KeyError(f"no end-to-end metric {name!r}")


def run_cell(
    *, s: Shapes, raw: dict, mix_params: dict, cell: dict, seed: int, seconds: float, trace: bool,
    device, t_start: float, prog: Program | None = None, dtype=torch.bfloat16,
) -> dict:
    """One run of a cell. Returns the window's record, the run's numbers and
    the check's."""
    prog = prog or load_program()
    weights = fill_weights(make_weights(s, device, dtype), seed, device)
    engine = build_engine(prog, s, raw, cell, program_params(prog, weights), device)
    gen = make_traffic(mix_params, cell, seed)
    traffic = Traffic(engine)
    try:
        async def go() -> dict:
            await gen.fill(traffic.send)
            return await _window(engine, traffic, gen, float(mix_params.get("ramp_s", 0.0)), seconds, trace)

        out = asyncio.run(go())
        memory_peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    finally:
        engine.shutdown()
    setup_s = out["t_traffic"] - t_start
    on_card = torch.device(device).type == "cuda"
    record = {
        # the CPU tests' placeholder peaks: no share from a CPU run is reported
        "shapes": s, "peaks": peaks_for(torch.cuda.get_device_name(device)) if on_card
        else {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e11},
        "max_batch": int(cell["engine"]["max_batch"]), "w0": out["w0"], "w1": out["w1"],
        "requests": traffic.requests, "counters": (out["m0"], out.get("m1") or engine.metrics()), "trace": None,
    }
    breakdown = None
    if "profile" in out:
        from .trace import profiler_events, reduce_events

        prof, before, after, (wall_ns, perf) = out.pop("profile")
        events, a, b = profiler_events(prof)
        del prof
        reduced = reduce_events(events, a, b)
        breakdown = reduced.pop("breakdown")
        record["trace"] = {
            **reduced, "t0": perf + (a - wall_ns) / 1e9, "t1": perf + (b - wall_ns) / 1e9, "counters": (before, after),
        }
    # the program's state goes before the reference runs
    traffic.engine = None
    del engine, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sample = pick_contexts(traffic.contexts, int(cell["check"]["contexts"]), seed)
    check = check_outputs(s, weights, sample, device)
    short = sum(1 for r in traffic.requests if r["error"] is None and not r["cut"] and not window.completed(r))
    return {
        "record": record, "setup_s": setup_s, "memory_peak": memory_peak, "breakdown": breakdown,
        "check": check, "short_replies": short, "contexts": traffic.contexts, "weights": weights,
    }


def metric_entries(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those that
    list it, or (no ``workloads`` key) every cell; a per-layer metric
    without the key goes with the end-to-end metric it moves."""
    e2e = [m["name"] for m in metric_entries(bench, workload, "end_to_end")] if kind == "per_layer" else []
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def verdict(run: dict, cell: dict) -> tuple[bool, dict]:
    """``correct``, and each number compared beside its limit: the cell's
    statistic of the served tokens' logit gaps (``check.number``, the
    widest by default) against its limit, and that every request of the
    window came back whole."""
    reqs = run["record"]["requests"]
    failed = sum(1 for r in reqs if r["error"] is not None)
    window_reqs = sum(1 for r in reqs if r["in_window"])
    number = cell["check"].get("number", "max_logit_gap")
    limit = cell["check"].get("limit")
    gap = run["check"].get(number)
    checks = {
        number: {"value": gap, "limit": limit},
        "served_tokens_checked": {"value": run["check"]["served_tokens"], "limit": 1},
        "failed_requests": {"value": failed, "limit": 0},
        "short_replies": {"value": run["short_replies"], "limit": 0},
    }
    correct = (
        window_reqs > 0 and failed == 0 and run["short_replies"] == 0 and gap is not None and limit is not None
        and gap <= limit and run["check"]["served_tokens"] >= 1
    )
    return correct, checks


def result_line(bench: dict, workload: str, run: dict, trace: bool, cell: dict, chips: int, device) -> tuple[dict, list[str]]:
    """The result's JSON object and the check's lines for standard error."""
    record = run["record"]
    metrics = {}
    if trace:
        for m in metric_entries(bench, workload, "per_layer"):
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metric_entries(bench, workload, "end_to_end"):
            value = end_to_end(m["name"], record, run["setup_s"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(1 for r in record["requests"] if r["in_window"])
    failed = sum(1 for r in record["requests"] if r["error"] is not None)
    correct, checks = verdict(run, cell)
    dev = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
        "memory_peak_bytes": run["memory_peak"], **card_info(),
    }
    if trace and record["trace"]:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and run["breakdown"]:
        line["breakdown"] = run["breakdown"]
    line["checks"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return line, lines


def dump(path: str, run: dict, line: dict) -> None:
    """Write a run's requests and result beside it (for analysis)."""
    record = run["record"]
    with open(path, "w") as f:
        json.dump({
            "line": line, "setup_s": run["setup_s"], "w0": record["w0"], "w1": record["w1"],
            "requests": record["requests"], "counters": record["counters"], "check": run["check"],
            "trace": {k: v for k, v in (record["trace"] or {}).items() if k != "counters"},
        }, f, default=str)
