"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, always all five, in order (any failure raises; the script then
exits non-zero):

1. build       — compile the kernels of ``agentainer_tpu_torch/csrc`` with
                 nvcc and load them; print the card's name and power limit
                 as nvidia-smi reports them.
2. kernels     — each hand-written kernel against its plain PyTorch version
                 at the llama3-8b attention shapes of the serving path (H 32,
                 KV 8, head_dim 128; the paged ones on the served pool
                 [264, 64, 8, 128] through a scrambled block table with a
                 shared page and a parked lane): in bf16 within one bf16
                 rounding of the plain output, and on the same inputs in f32
                 within 2e-5; kernel / plain / library times in bf16 (CUDA
                 events; for the paged kernels, which no single library call
                 computes, gather + SDPA as a yardstick), and the least time
                 the card could take.
3. serve       — the port's standard-library ``llm_serve`` on a local port
                 with ``llama3-8b`` at full width and depth, bf16, random
                 weights from a seeded generator; /chat requests over three
                 sessions (one with two turns, two requests in flight at
                 once). The dense kernels' launch counts are set to 0 just
                 before and read just after: each must be > 0.
4. serve paged — the same server and weights with ``paged_kv`` (page size
                 64), after the dense one has stopped: the same four
                 requests must give the dense phase's greedy text; then 12
                 more short sessions (more than max_batch) and a third turn.
                 Every request 200, >= 13 resident sessions, no eviction, no
                 pool exhaustion, no worker error; both paged kernels
                 launched, neither dense kernel.
5. model       — ``forward`` logits with the kernels against ``forward``
                 with the plain attention path, and the paged ``forward``
                 (kernels, scrambled block table) against the dense one,
                 llama3-8b width at 2 layers, in bf16 and in f32 (TF32 off).

Stdout ends with four lines: the served paths' and the model check's numbers
(JSON), the card's name and power limit, a JSON object listing every kernel,
and ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is visible or the port's package is missing.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet)
PEAK_HBM_BPS = 3.35e12
# Kernel against plain: both accumulate in f32 and round once to q's dtype,
# so in bf16 they may differ by one rounding (<= 2**-7 * |plain|) and in f32
# by summation order only (the repo's f32 kernel tolerance,
# tests/test_pallas_attention.py). Products run with TF32 off (set in main).
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-4
F32_TOL = 2e-5
# Logits of the model with the kernels against the plain attention path. f32:
# the repo's tolerance for one model's f32 logits through two attention paths
# (tests/test_models.py, cached prefill against the full forward), since the
# kernels' summation order reaches the logits through every layer and the
# vocab projection. bf16 carries the bf16 rounding of every layer: the repo's
# bf16 tolerance, relative to the largest logit. The f32 pass is the tight one.
F32_LOGIT_TOL = 2e-4
BF16_LOGIT_TOL = 3e-2
H, KV, HD = 32, 8, 128  # llama3-8b attention
S = 2048  # the engine's default max_seq
B = 8  # the engine's default max_batch
PS = 64  # the paged phase's page size
YARDSTICK = "gather_pages + scaled_dot_product_attention"
# the four requests both serve phases send: (session, message)
REQUESTS = (
    ("a", "Hello! Summarize the plot of a heist movie in one line."),
    ("a", "Now tell it as a haiku."),
    ("b", "List three prime numbers and explain why they are prime."),
    ("c", "List three prime numbers and explain why they are prime."),
)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> str:
    from agentainer_tpu_torch.ops import cuda_attention as ca

    t0 = time.monotonic()
    ca._lib()
    log(f"built and loaded csrc/flash_attention.cu in {time.monotonic() - t0:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def _bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_HBM_BPS, flops / PEAK_BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _compare(fn, plain, floats, rest) -> tuple[float, float]:
    """``fn`` against ``plain`` on the bf16 tensors ``floats`` (q, k, v) and
    on the same values in f32, with the int tensors ``rest`` as they are;
    raises if either is out of tolerance, else returns both max abs errors."""
    import torch

    errs = []
    for dtype, rtol, atol in ((torch.bfloat16, BF16_RTOL, BF16_ATOL), (torch.float32, F32_TOL, F32_TOL)):
        args = (*(x.to(dtype) for x in floats), *rest)
        got, want = fn(*args).float(), plain(*args).float()
        torch.testing.assert_close(
            got, want, rtol=rtol, atol=atol,
            msg=lambda m, d=dtype: f"{fn.__name__} ({d}) disagrees with its plain version: {m}",
        )
        errs.append((got - want).abs().max().item())
    return errs[0], errs[1]


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from agentainer_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(bf)

    out = []

    # prefill: one 256-token chunk of one slot (B = 1) at a ragged offset
    b, t, off = 1, 256, 300
    q, k, v = randn(b, t, H, HD), randn(b, S, KV, HD), randn(b, S, KV, HD)
    pos = (off + torch.arange(t, device=dev, dtype=torch.int32))[None]
    err, err32 = _compare(ca.flash_prefill, ca.flash_prefill_plain, (q, k, v), (pos,))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[0, :, None])[None, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    visible = (pos.clamp(max=S - 1) + 1).sum().item()  # visible slots summed over rows
    live = pos.max().item() + 1
    bytes_moved = 2 * (2 * q.numel() + 2 * b * live * KV * HD)  # q, out, live K and V
    bound_ms, bound_by = _bound(bytes_moved, 4.0 * H * HD * visible)
    out.append({
        "name": "flash_prefill", "route": "cuda",
        "source": "agentainer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "agentainer_tpu/ops/pallas_attention.py:157",
        "max_abs_err": err, "tolerance": f"|d| <= {BF16_ATOL} + {BF16_RTOL} * |plain|",
        "max_abs_err_f32": err32, "tolerance_f32": F32_TOL,
        "ms": time_ms(lambda: ca.flash_prefill(q, k, v, pos)),
        "plain_ms": time_ms(lambda: ca.flash_prefill_plain(q, k, v, pos)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "library": "scaled_dot_product_attention",
        "shape": f"q[{b},{t},{H},{HD}] kv[{b},{S},{KV},{HD}] bf16, positions {off}..{off + t - 1}",
    })

    # decode: the engine's 8 lanes, mixed positions, one parked at S - 1
    b = 8
    q, k, v = randn(b, H, HD), randn(b, S, KV, HD), randn(b, S, KV, HD)
    pos = torch.tensor([0, 17, 130, 511, 777, 1024, 1500, S - 1], device=dev, dtype=torch.int32)
    err, err32 = _compare(ca.flash_decode, ca.flash_decode_plain, (q, k, v), (pos,))
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    live = (pos.clamp(max=S - 1) + 1).sum().item()
    bytes_moved = 2 * (2 * q.numel() + 2 * live * KV * HD)
    bound_ms, bound_by = _bound(bytes_moved, 4.0 * H * HD * live)
    out.append({
        "name": "flash_decode", "route": "cuda",
        "source": "agentainer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "agentainer_tpu/ops/pallas_attention.py:268",
        "max_abs_err": err, "tolerance": f"|d| <= {BF16_ATOL} + {BF16_RTOL} * |plain|",
        "max_abs_err_f32": err32, "tolerance_f32": F32_TOL,
        "ms": time_ms(lambda: ca.flash_decode(q, k, v, pos)),
        "plain_ms": time_ms(lambda: ca.flash_decode_plain(q, k, v, pos)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "library": "scaled_dot_product_attention",
        "shape": f"q[{b},{H},{HD}] kv[{b},{S},{KV},{HD}] bf16, positions {pos.tolist()}",
    })
    out += _paged_kernel_rows(randn, g)
    for row in out:
        ref = "library" if row["library_ms"] is not None else "yardstick"
        log(f"{row['name']}: max_abs_err bf16 {row['max_abs_err']:.3g} f32 {row['max_abs_err_f32']:.3g} "
            f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} {ref} {row[ref + '_ms']:.4f} "
            f"bound {row['bound_ms']:.4f}")
    return out


def _paged_table(g, dev):
    """The served paged arena's block table: 8 * 32 data pages plus one
    scratch page per lane; scrambled page ids, lanes 0 and 1 share a page,
    and lane 7 is parked (its row is all its own scratch page)."""
    import torch

    data = B * (S // PS)
    table = torch.randperm(data, generator=g, device=dev).reshape(B, S // PS).int()
    table[1, 0] = table[0, 0]
    table[B - 1] = data + B - 1
    return table


def _live_slots(table, pos) -> int:
    """Distinct pool rows the lanes' visible slots cover: a page shared by
    two lanes, or a parked lane's scratch page seen through every block, is
    read once."""
    import torch

    rows = [
        (table[i].long()[torch.arange(p + 1, device=table.device) // PS]) * PS
        + torch.arange(p + 1, device=table.device) % PS
        for i, p in enumerate(pos.tolist())
    ]
    return torch.unique(torch.cat(rows)).numel()


def _paged_kernel_rows(randn, g) -> list[dict]:
    """The two paged kernels on the served pool [264, 64, 8, 128]. No single
    PyTorch call computes paged attention, so ``library_ms`` is null and the
    rows carry ``yardstick_ms``: gather_pages, then
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from agentainer_tpu_torch.ops import cuda_attention as ca
    from agentainer_tpu_torch.ops.attention import gather_pages

    dev = torch.device("cuda")
    pool_k, pool_v = randn(B * S // PS + B, PS, KV, HD), randn(B * S // PS + B, PS, KV, HD)
    pool = f"pool[{pool_k.shape[0]},{PS},{KV},{HD}] bf16"
    rows = []
    tables = _paged_table(g, dev)

    # prefill: one 256-token chunk of one lane (B = 1, lane 0's row) at a
    # ragged offset
    t, off = 256, 300
    table = tables[:1]
    q = randn(1, t, H, HD)
    pos = (off + torch.arange(t, device=dev, dtype=torch.int32))[None]
    err, err32 = _compare(
        ca.fused_paged_flash_prefill, ca.paged_flash_prefill_plain, (q, pool_k, pool_v), (table, pos)
    )
    mask = (torch.arange(S, device=dev)[None, :] <= pos[0, :, None])[None, None]

    def gather_sdpa():
        k, v = gather_pages(pool_k, pool_v, table)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    visible = (pos.clamp(max=S - 1) + 1).sum().item()
    bytes_moved = 2 * 2 * q.numel() + 2 * 2 * _live_slots(table, pos[:, -1]) * KV * HD + 4 * table.numel()
    bound_ms, bound_by = _bound(bytes_moved, 4.0 * H * HD * visible)
    rows.append({
        "name": "fused_paged_flash_prefill", "route": "cuda",
        "source": "agentainer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "agentainer_tpu/ops/pallas_attention.py:454",
        "max_abs_err": err, "tolerance": f"|d| <= {BF16_ATOL} + {BF16_RTOL} * |plain|",
        "max_abs_err_f32": err32, "tolerance_f32": F32_TOL,
        "ms": time_ms(lambda: ca.fused_paged_flash_prefill(q, pool_k, pool_v, table, pos)),
        "plain_ms": time_ms(lambda: ca.paged_flash_prefill_plain(q, pool_k, pool_v, table, pos)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "yardstick_ms": time_ms(gather_sdpa), "yardstick": YARDSTICK,
        "shape": f"q[1,{t},{H},{HD}] {pool} table[1,{S // PS}], positions {off}..{off + t - 1}",
    })

    # decode: the engine's 8 lanes, mixed positions; lane 7 parked at S - 1
    table = tables
    q = randn(B, H, HD)
    pos = torch.tensor([0, 17, 130, 511, 777, 1024, 1500, S - 1], device=dev, dtype=torch.int32)
    err, err32 = _compare(
        ca.fused_paged_flash_decode, ca.paged_flash_decode_plain, (q, pool_k, pool_v), (table, pos)
    )
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None, None]

    def gather_sdpa_decode():
        k, v = gather_pages(pool_k, pool_v, table)
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    visible = (pos.clamp(max=S - 1) + 1).sum().item()
    bytes_moved = 2 * 2 * q.numel() + 2 * 2 * _live_slots(table, pos) * KV * HD + 4 * table.numel()
    bound_ms, bound_by = _bound(bytes_moved, 4.0 * H * HD * visible)
    rows.append({
        "name": "fused_paged_flash_decode", "route": "cuda",
        "source": "agentainer_tpu_torch/csrc/flash_attention.cu",
        "replaces": "agentainer_tpu/ops/pallas_attention.py:577",
        "max_abs_err": err, "tolerance": f"|d| <= {BF16_ATOL} + {BF16_RTOL} * |plain|",
        "max_abs_err_f32": err32, "tolerance_f32": F32_TOL,
        "ms": time_ms(lambda: ca.fused_paged_flash_decode(q, pool_k, pool_v, table, pos)),
        "plain_ms": time_ms(lambda: ca.paged_flash_decode_plain(q, pool_k, pool_v, table, pos)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "yardstick_ms": time_ms(gather_sdpa_decode), "yardstick": YARDSTICK,
        "shape": f"q[{B},{H},{HD}] {pool} table[{B},{S // PS}], positions {pos.tolist()}",
    })
    return rows


def _http(port: int, method: str, path: str, body: dict | None = None, timeout: float = 600):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


@contextlib.contextmanager
def _serving(options: dict):
    """The port's ``llm_serve`` app for llama3-8b on a local port, loaded;
    yields (app, load seconds) and stops it on the way out."""
    from agentainer_tpu_torch.engine.llm_serve import LLMServeApp

    app = LLMServeApp(env={
        "AGENTAINER_AGENT_ID": "chip-smoke",
        "AGENTAINER_MODEL_CONFIG": "llama3-8b",
        "AGENTAINER_MODEL_OPTIONS": json.dumps(options),
    })
    th = threading.Thread(target=lambda: asyncio.run(app.run("127.0.0.1", 0)), name="serve")
    th.start()
    try:
        t0 = time.monotonic()
        while app.port is None:
            if not th.is_alive():
                raise RuntimeError("server thread died before binding")
            time.sleep(0.05)
        while True:
            _, health = _http(app.port, "GET", "/health")
            if health["model_loaded"] or app.engine_error:
                break
            if time.monotonic() - t0 > 480:
                raise TimeoutError("model did not load within 480 s")
            time.sleep(1.0)
        if app.engine_error:
            raise RuntimeError(f"engine failed to load: {app.engine_error}")
        yield app, time.monotonic() - t0
    finally:
        app.stop()
        th.join(timeout=120)
        if th.is_alive():
            raise RuntimeError("server thread did not stop")


def _chat(port: int, replies: list, session: str, message: str, max_tokens: int = 16) -> dict:
    status, doc = _http(port, "POST", "/chat", {
        "session": session, "message": message, "max_tokens": max_tokens, "ignore_eos": True,
    })
    if status != 200 or doc["usage"]["completion_tokens"] <= 0:
        raise AssertionError(f"/chat {session}: {status} {doc}")
    replies.append((session, doc))
    return doc


def _four_requests(port: int, replies: list) -> list[str]:
    """Session a's two turns, then b and c in flight at once with the same
    prompt; returns the four responses' text in that order."""
    a1 = _chat(port, replies, *REQUESTS[0])
    a2 = _chat(port, replies, *REQUESTS[1])
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        b, c = pool.map(lambda r: _chat(port, replies, *r), REQUESTS[2:])
    if b["response"] != c["response"]:
        raise AssertionError(f"same prompt, fresh sessions, different greedy text: {b} {c}")
    return [d["response"] for d in (a1, a2, b, c)]


METRIC_KEYS = (
    "tokens_generated", "prefills", "decode_steps", "decode_chunk_hist",
    "itl_ms_p50", "ttft_ms_p50", "param_hbm_bytes", "kv_arena_bytes", "chip_kind",
)
PAGED_KEYS = (
    "resident_sessions", "session_evictions_total", "kv_pages_total", "kv_pages_used",
    "kv_pages_free", "session_pages_p50", "session_pages_max", "kv_fragmentation_pct",
    "page_exhausted_total", "pages_truncated_total", "worker_errors",
)


def phase_serve() -> dict:
    """The dense arena: the four requests through both dense kernels."""
    from agentainer_tpu_torch.ops import cuda_attention as ca

    options = {"device": "cuda", "seed": 0, "max_batch": B, "max_seq": S}
    with _serving(options) as (app, load_s):
        log(f"llama3-8b engine loaded (init + warmup) in {load_s:.1f}s")
        kernels = (ca.flash_prefill, ca.flash_decode)
        for fn in kernels:
            fn.launches = 0
        t1 = time.monotonic()
        replies = []
        texts = _four_requests(app.port, replies)
        serve_s = time.monotonic() - t1
        launches = {fn.__name__: fn.launches for fn in kernels}
        _, metrics = _http(app.port, "GET", "/metrics")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the served path")
    log(f"served {len(replies)} /chat requests in {serve_s:.2f}s; launches {launches}")
    return {
        "launches": launches,
        "requests": len(replies),
        "load_s": load_s,
        "serve_s": serve_s,
        "ttft_ms": [doc["ttft_ms"] for _, doc in replies],
        "completion_tokens": [doc["usage"]["completion_tokens"] for _, doc in replies],
        "metrics": {k: metrics.get(k) for k in METRIC_KEYS},
        "texts": texts,
    }


def phase_serve_paged(dense_texts: list[str]) -> dict:
    """The paged arena (page size 64), after the dense server has stopped:
    the four requests must give the dense phase's greedy text, then 12 more
    short sessions (more than max_batch) and a third turn on session a must
    stay resident without eviction, through both paged kernels and neither
    dense kernel."""
    import torch

    from agentainer_tpu_torch.ops import cuda_attention as ca

    gc.collect()
    torch.cuda.empty_cache()  # the dense engine's weights and arena
    options = {
        "device": "cuda", "seed": 0, "max_batch": B, "max_seq": S, "paged_kv": True,
        "page_size": PS,
    }
    with _serving(options) as (app, load_s):
        log(f"llama3-8b paged engine loaded (init + warmup) in {load_s:.1f}s")
        kernels = (
            ca.flash_prefill, ca.flash_decode, ca.fused_paged_flash_prefill,
            ca.fused_paged_flash_decode,
        )
        for fn in kernels:
            fn.launches = 0
        t1 = time.monotonic()
        replies = []
        texts = _four_requests(app.port, replies)
        # the dense phase's traffic so far: its ITL is comparable with that
        # phase's; the burst below queues prefills between decode chunks
        _, after_four = _http(app.port, "GET", "/metrics")
        with concurrent.futures.ThreadPoolExecutor(12) as pool:
            list(pool.map(
                lambda i: _chat(app.port, replies, f"short{i}", f"Short question number {i}?", 8),
                range(12),
            ))
        _chat(app.port, replies, "a", "And now as a limerick.")
        serve_s = time.monotonic() - t1
        launches = {fn.__name__: fn.launches for fn in kernels}
        _, metrics = _http(app.port, "GET", "/metrics")
    if texts != dense_texts:
        raise AssertionError(f"paged greedy text differs from the dense phase's: {texts} {dense_texts}")
    gauges = {k: metrics.get(k) for k in PAGED_KEYS}
    if gauges["resident_sessions"] < 13 or gauges["session_evictions_total"] != 0:
        raise AssertionError(f"paged residency: {gauges}")
    if gauges["kv_pages_used"] <= 0 or gauges["page_exhausted_total"] != 0 or gauges["worker_errors"] != 0:
        raise AssertionError(f"paged pool: {gauges}")
    for name in ("fused_paged_flash_prefill", "fused_paged_flash_decode"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the paged served path")
    for name in ("flash_prefill", "flash_decode"):
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times on the paged served path")
    log(f"paged: served {len(replies)} /chat requests in {serve_s:.2f}s; launches {launches}; {gauges}")
    return {
        "launches": launches,
        "requests": len(replies),
        "load_s": load_s,
        "serve_s": serve_s,
        "ttft_ms": [doc["ttft_ms"] for _, doc in replies],
        "completion_tokens": [doc["usage"]["completion_tokens"] for _, doc in replies],
        "metrics": {k: metrics.get(k) for k in METRIC_KEYS},
        "pages": gauges,
        "after_four_requests": {k: after_four.get(k) for k in ("itl_ms_p50", "ttft_ms_p50", "decode_chunk_hist")},
        "same_text_as_dense": True,
    }


def phase_model() -> dict:
    """Logits of a prefill chunk then one decode step: with the kernels
    against the plain attention path (dense arena), and the paged forward
    with the kernels (scrambled block table) against the dense one with
    the kernels. The paged kernels share the dense kernels' body, so the
    paged pair is expected to agree exactly; f32 is held to 2e-5."""
    import dataclasses

    import torch

    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import KVCache, PagedKVCache, forward, init_params

    cfg = dataclasses.replace(get_config("llama3-8b"), name="llama3-8b-2l", n_layers=2)
    dev = torch.device("cuda")
    b, t, s = 2, 128, 512
    out = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev)
            g.manual_seed(1)
            params = init_params(cfg, g, dtype=dtype, device=dev)
            tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)
            offs = torch.tensor([0, 200], device=dev)
            pos = (offs[:, None] + torch.arange(t, device=dev)[None]).to(torch.int32)
            logits = {}
            for use_flash in (True, False):  # a prefill chunk, then one decode step
                cache = KVCache.create(cfg, b, s, dtype=dtype, device=dev)
                pre = forward(params, cfg, tokens, pos, cache, use_flash=use_flash)
                dec = forward(params, cfg, tokens[:, -1:], pos[:, -1:] + 1, cache, use_flash=use_flash)
                logits[use_flash] = torch.cat([pre, dec], dim=1)
            table = torch.randperm(b * s // PS, generator=g, device=dev).reshape(b, s // PS).int()
            cache = PagedKVCache.create(cfg, b * s // PS, PS, dtype=dtype, device=dev)
            pre = forward(params, cfg, tokens, pos, cache, block_table=table)
            dec = forward(params, cfg, tokens[:, -1:], pos[:, -1:] + 1, cache, block_table=table)
            paged = torch.cat([pre, dec], dim=1)
            got, want = logits[True], logits[False]
            if not torch.isfinite(got).all():
                raise AssertionError(f"forward with kernels ({dtype}) gave non-finite logits")
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            name = str(dtype).removeprefix("torch.")
            log(f"2-layer llama3-8b forward {name}, kernels vs plain: max abs err {err:.3g}, "
                f"max |logit| {scale:.3g}")
            if dtype == torch.float32:
                torch.testing.assert_close(
                    got, want, rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL,
                    msg=lambda m: f"f32 forward with kernels disagrees with the plain path: {m}",
                )
            elif err / scale > BF16_LOGIT_TOL:
                raise AssertionError(f"bf16 forward with kernels disagrees with the plain path: {err}")
            paged_err = (paged - got).abs().max().item()
            log(f"2-layer llama3-8b forward {name}, paged vs dense (kernels): max abs err {paged_err:.3g}")
            if not torch.isfinite(paged).all():
                raise AssertionError(f"paged forward ({dtype}) gave non-finite logits")
            if dtype == torch.float32:
                torch.testing.assert_close(
                    paged, got, rtol=F32_TOL, atol=F32_TOL,
                    msg=lambda m: f"f32 paged forward disagrees with the dense forward: {m}",
                )
            elif paged_err / scale > BF16_LOGIT_TOL:
                raise AssertionError(f"bf16 paged forward disagrees with the dense forward: {paged_err}")
            out[name] = {"max_abs_err": err, "max_abs_logit": scale, "paged_vs_dense_max_abs_err": paged_err}
            del params, logits, got, want, cache, paged
    out["tolerance"] = {
        "bfloat16": f"{BF16_LOGIT_TOL} * max(1, |logit|)", "float32": F32_LOGIT_TOL,
        "paged_vs_dense_float32": F32_TOL,
    }
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device visible: nothing to check")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import agentainer_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the port's package is not beside this script: {e}")
        return 2
    # full-precision f32 products on the card for every comparison here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_build()
    kernels = phase_kernels()
    report = {"serve": phase_serve()}
    report["serve_paged"] = phase_serve_paged(report["serve"].pop("texts"))
    for row in kernels:
        path = "serve_paged" if "paged" in row["name"] else "serve"
        row["launches"] = report[path]["launches"][row["name"]]
    report["model"] = phase_model()
    print(json.dumps(report))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
