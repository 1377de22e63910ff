"""Continuous-batching inference engine in PyTorch — on one device or over
a mesh (tp × ep × sp, or a pp pipeline), over the dense KV arena or the
paged one.

Reference: ``agentainer_tpu/engine/llm.py`` with its defaults —
``prefix_cache``, ``speculative`` and ``deadlines`` on, ``adaptive_decode``
on, ``paged_kv``, ``streaming``, ``approx_topk``, ``fused_decode`` and
``kv_tiering`` off, ``inloop_spec`` on (it acts with ``fused_decode``) and
``tier_quantize`` 1. The design carries over:

- a fixed slot batch ``[max_batch]`` decodes every active sequence each step
  at its own arena position; idle lanes decode at the scratch position
  ``max_seq - 1`` so requests come and go without reshaping anything;
- bucketed, chunked prefill: a prompt is fed ``prefill_chunk`` tokens at a
  time, each chunk padded up to a power-of-two bucket, interleaved with
  decode chunks so one long prompt cannot stall every generation;
- TTFT = prefill: the first token is sampled from the prefill logits;
- sessions own KV: a chat session keeps its slot between turns and idle
  sessions are evicted LRU when slots run out;
- ``paged_kv``: the arena is a pool of fixed-size pages with a block table
  per lane. A session keeps its pages, not a lane, between turns, so
  resident sessions outnumber ``max_batch``; idle residents are evicted LRU
  when the pool runs dry, and a pool that cannot cover an in-flight request
  fails that request with ``PagePoolExhausted`` (429) and rolls its session
  back;
- ``prefix_cache``: bucket-length token prefixes of fresh contexts are
  registered at their final prefill chunk and forked into a fresh session
  at admission (dense: plain tensor copies out of and into the arena row;
  paged: refcounted pages mapped read-only, a partial tail page copied);
- ``speculative``: prompt-lookup drafting on the host and one batched
  verify ``forward`` at ``[max_batch, K+1]`` per round, which runs through
  the prefill kernels; greedy lanes accept on argmax agreement, sampled
  lanes by rejection sampling with a point-mass proposal;
- ``deadlines``: wall-clock deadlines checked before prefill and on every
  worker iteration, ``cancel(request_id)``, a submit-side shed watermark,
  and ``begin_drain``/``drain``;
- ``streaming``: ``generate``/``chat(emit=)`` hand a request's tokens to
  ``emit(start, ids)`` as the worker processes their readbacks (the first
  token, a decode chunk's used tokens, a verify round's accepted ones), with
  no extra device sync; the serve layer frames them as SSE;
- ``approx_topk``: sampled lanes filter over the ``APPROX_SEG`` largest
  logits (``engine/sampling.py``), a static choice of every sampled step;
- ``fused_decode``: decode runs as an on-device loop of up to
  ``_fused_cap`` iterations (a bound in device memory) with per-lane EOS
  masking and budget freezing, a whole-batch early exit decided on the
  device and one packed readback per loop (``_fused_dispatch``,
  ``_process_fused``; the host rescan has the last word on budget). With
  ``inloop_spec`` (and ``speculative``) each iteration drafts from a
  ``FUSED_HIST_W``-token history carry and verifies up to ``FUSED_SPEC_K``
  drafts as a branch of the same loop body; without it, host-side
  speculation composes between loops. A lane prefilled while a loop is in
  flight is staged into a shadow carry that the next loop absorbs at entry
  (``_stage_lane``);
- ``kv_tiering``: idle sessions demote from the device into a host tier of
  pinned memory (``park_session``, and under paged pool pressure before
  any destructive eviction) and promote back at their next turn or on a
  ``prewarm_session`` hint; ``tier_quantize`` 1 keeps int8 pages with
  per-page scales there. ``park_session`` returns the exact SNAP_VERSION 3
  blob, packed before any quantization;
- failpoints (``faults``) at the reference's engine seams;
- MoE configs (Mixtral): each layer's MLP is the dense-einsum
  ``_moe_mlp``, the reference's single-device default, or with ``routed``
  the token-dispatch ``_moe_mlp_routed`` at capacity factor ``moe_cf``
  (2.0 by default; decode-shaped steps always dropless); both run inside
  the same step graphs, prefill graphs and fused loop; with ``quant:
  int8`` every expert product runs the grouped int8 kernel
  (``ops/cuda_quant.w8a16_grouped_matmul``);
- idempotent by request id: completed results are memoized.

What differs from the reference, and why:

- there is no ``jit`` and no donation: the KV arena and the decode carry
  are updated IN PLACE where the reference returned donated buffers. The
  carry, the verify inputs and the block table are device buffers
  allocated once and written with ``copy_``, so their addresses never
  change;
- the reference's compiled steps are CUDA graphs on the card: every
  prefill chunk (one graph per reachable bucket; the reference's jitted
  prefill, compiled per bucket shape), every decode chunk (one graph per
  ladder rung, greedy or sampled; the reference's ``lax.scan`` in
  ``decode_n``) and every verify round (one per draft bucket, greedy or
  sampled; ``_verify_fn``) is one graph replay, captured by ``warmup`` from
  the same step functions that run eagerly on the CPU
  (``engine/graphs.py``). A capture that fails makes warmup raise. A
  prefill step reads its chunk, start, last real index and dense arena row
  from one static buffer (``_pinput``) and, paged, the lane's block-table
  row from ``_pbt``; the prefill kernel and the KV write take the arena row
  from device memory (``KVCache.at_rows``), so one graph per bucket serves
  every slot; only the last real token's hidden state goes through
  ``lm_head``, on the CPU as on the card;
- token readbacks are pipelined as the reference's are
  (``_PIPELINE_DEPTH`` = 1): a chunk's tokens and a prefill's first token
  are copied ``non_blocking`` into pinned host buffers with a CUDA event
  recorded after each copy; the worker processes landed entries in FIFO
  order and blocks on the oldest only when the FIFO is deeper than the
  depth or nothing else is dispatchable, admitting newcomers while it
  waits. EOS and ``max_tokens`` are seen up to one chunk late, a finished
  lane decodes on (parked garbage) until its park lands, and entries of a
  request that finished earlier are skipped. A verify round reads its
  tokens back synchronously, as the reference's does; it first drains the
  pipeline;
- the paged allocator frees pages straight to the free list, with no
  quarantine, although a chunk dispatched before the free may still write
  through the old block table: every device write goes on the engine's one
  CUDA stream, so that write lands before any later owner's first write to
  the page (see ``_free_page_ids``). A demotion's pages wait in a
  quarantine until their staging copy has landed (``_page_quarantine``);
- a lane drafts only after its first token's readback has been processed,
  as in the reference (``_try_speculate``);
- KV snapshots (``snapshot_session``/``restore_session``, the reference's
  blob format, ``engine/checkpoint.py``) on both arenas: staging copies the
  live prefix (dense: the row's ``[:position]``, with no power-of-two
  bucket, which bounded XLA compiles; paged: only the session's live
  pages) into pinned host memory on the engine's stream with an event, and
  the wait and the npz pack run in ``asyncio.to_thread``; a restore writes
  into the existing arena tensors in place on that stream, from a pinned
  copy kept until its event lands, so the step graphs replay over the
  restored KV without being captured again;
- ``create(checkpoint=)`` loads a HuggingFace directory (with its own
  ``config.json``) onto the engine's device; ``options["chips"]`` places
  the engine on ``cuda:{chip}`` (one chip; an id past the visible devices
  falls back to the first, as in the reference) or spans a mesh;
- ``quant: int8`` (``create``) serves int8 weights as the reference does:
  from a checkpoint quantized as it streams, on the device from a seeded
  synthetic draw (``synthetic: true``), or quantized from the seeded random
  init; every weight product runs the fused int8 kernel
  (``ops/cuda_quant.w8a16_matmul``);
- the fused loop is one executable CUDA graph on the card: one iteration's
  segments are captured as graphs and assembled around a CUDA WHILE node
  (and, with ``inloop_spec``, two IF nodes for the verify and plain
  branches) by ``engine/graphs.py::LoopGraph``; the loop's random draws
  are made before it starts (one row of uniforms per iteration, the
  reference's one key per iteration), so a sampled stream advances the
  generator by the same amount whatever iteration the loop exits at. The
  host's record of a lane's start position in a loop dispatched while
  another was in flight is corrected when the earlier loop's readback is
  processed (the reference keeps the upper bound it dispatched with);
- the host tier holds pinned torch tensors (exact) or numpy int8 pages
  (``tier_quantize``, the reference's numpy quantizer); a promotion copies
  from pinned memory without waiting and keeps its source alive until the
  copy's event has landed;
- serve-time model parallelism (``mesh=``; ``create`` places it as the
  reference does: a ``chips`` budget an assignment narrows and never
  spills, sp's chips reserved first, EP-first for MoE, a dense agent's
  chips spanned by tp; pp on its own) runs in this one process: the params
  are cut per shard at build (``parallel/sharding.shard_params``), each
  shard's dense arena or paged pool holds its kv heads, its slots (sp) or
  its layers (pp) (``models/llama.MeshCache``; one page id and one block
  table for every shard), and ``forward`` runs each layer per shard with
  the shards meeting in ``parallel/collectives`` (sp: the shards'
  attention rows joined by their log-sum-exp, ``parallel/flash_mesh.py``;
  pp: each layer on its stage's shard, the stages in turn,
  ``parallel/pipeline.py``). Routed MoE is the
  default under ep > 1 (``parallel/expert.make_routed_moe``);
  ``inloop_spec`` is off on a mesh, ``paged_kv`` under sp or pp and
  ``fused_decode`` under pp, as in the reference. Snapshots and tier parks
  stage each tp slice and keep the unsharded layout, so a blob crosses
  between meshes and one device. On one card every shard's work goes on
  the engine's stream and the step graphs capture the whole mesh; a mesh
  over several cards serves its steps eagerly (no capture across
  devices).

The engine runs its device work on a dedicated worker thread, on one CUDA
stream of its own; the serve layer talks to it through a thread-safe queue
and asyncio futures resolved with ``loop.call_soon_threadsafe``.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import functools
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import faults
from ..models.configs import ModelConfig, get_config
from ..models.llama import KVCache, MeshCache, PagedKVCache, _moe_mlp_routed, forward, init_params
from ..ops import cuda_quant
from ..parallel.expert import make_routed_moe, moe_expert_parallel
from ..parallel.flash_mesh import supported
from ..parallel.mesh import make_mesh, pick_ep, pick_tp
from ..parallel.pipeline import check_stages
from ..parallel.sharding import shard_params, unshard_kv, unsharded_bytes
from ..utils.hw import chip_spec
from .checkpoint import deserialize_kv_slot, load_params, pack_kv_snapshot
from .graphs import KERNEL_WRAPPERS, LANDED, HostTransfers, StepGraphs, run_loop_eager
from .hf_convert import config_from_hf, is_hf_checkpoint
from .quant import (
    QUANT_SCHEMES,
    dequantize_kv_pages,
    param_bytes_actual,
    quantize_kv_pages,
    quantize_params,
    synthetic_quantized_params,
)
from .sampling import NEG_INF, sample_step
from .tokenizer import load_tokenizer

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024)
PAGE_SIZE_DEFAULT = 64

# Self-speculative decoding (the reference's constants): verify buckets K
# (one verify shape [max_batch, K+1] each, run once at warmup); the
# acceptance-rate EMA that collapses a lane's draft length on rejecting
# traffic; lookup-miss backoff and the probe cadence of collapsed lanes; how
# far back the drafter's n-gram scan looks.
SPEC_VERIFY_BUCKETS = (2, 4, 8)
SPEC_EMA_ALPHA = 0.4
SPEC_EMA_FLOOR = 0.125
SPEC_MISS_BACKOFF = 4
SPEC_PROBE_EVERY = 32
SPEC_LOOKUP_WINDOW = 1024

# The fused decode loop (the reference's constants): the in-loop drafter's
# token-history window and draft length, and the loop bound's multiple of
# decode_chunk at steady state (``_fused_cap``).
FUSED_HIST_W = 64
FUSED_SPEC_K = 4
FUSED_RUNG_MULT = 4

class SnapshotDeferred(Exception):
    """KV snapshot postponed: the engine is busy (or the global limiter is
    saturated) and durability is not yet overdue. Retry on a later turn."""


class EngineShutdown(RuntimeError):
    """The engine worker is gone; queued work can never complete. Raised
    into every abandoned future instead of letting callers hang forever."""


class RequestAborted(RuntimeError):
    """Base for per-request terminations that are policy, not faults: nobody
    is waiting for the tokens any more. Passed to callers typed, so the
    serve layer maps each to its HTTP status."""


class RequestExpired(RequestAborted):
    """Deadline passed before (or while) the request was served."""


class RequestCancelled(RequestAborted):
    """Explicit cancel(request_id): the client went away, or an operator
    aborted the request."""


class EngineDraining(RuntimeError):
    """Drain in progress: no new admissions while in-flight work finishes."""


class EngineOverloaded(RuntimeError):
    """Overload backpressure, not a fault: the submit-side shed watermark or
    a full KV page pool. Carries a retry hint for the 429 Retry-After
    header."""

    def __init__(self, depth: int, watermark: int, retry_after_s: float = 1.0):
        super().__init__(f"engine overloaded: depth {depth} >= watermark {watermark}")
        self.depth = depth
        self.watermark = watermark
        self.retry_after_s = retry_after_s


class PagePoolExhausted(EngineOverloaded):
    """Paged-arena allocation failed even after evicting idle residents:
    the pool is full of in-flight pages. A policy signal that the serve
    layer maps to 429 + Retry-After."""

    def __init__(self, need: int, free: int):
        super().__init__(depth=need, watermark=free)
        self.args = (f"KV page pool exhausted: need {need} page(s), {free} free",)


class TierPromoteFailed(EngineOverloaded):
    """Host-tier promotion failed (an injected ``engine.kv_promote`` fault,
    or no room in the pool even after pressure demotion): the session stays
    parked, its context preserved, and the turn answers 429 + Retry-After,
    so a retry finds it still promotable."""

    def __init__(self, session: str):
        super().__init__(depth=0, watermark=0)
        self.args = (f"KV tier promotion failed for session {session!r}",)


class PrefillFailed(RuntimeError):
    """Prefill broke for ONE request while the engine survived (per-request
    isolation); the serve layer marks the 500 as a poisoned input."""


def _as_prefill_failure(e: Exception) -> Exception:
    """Policy terminations pass through typed (they map to their own HTTP
    statuses); anything else becomes PrefillFailed."""
    if isinstance(e, (RequestAborted, EngineOverloaded, EngineShutdown)):
        return e
    return PrefillFailed(f"{type(e).__name__}: {e}")


def _engine_device(device, cfg: ModelConfig, chips=(), quant: str = "", tp: int = 1) -> torch.device:
    """The engine's device (a mesh's first shard's): the card unless the
    caller asks for the CPU. Asking for CUDA where there is no card, or for
    a model whose attention head the kernels do not take (or, with
    ``quant``, whose weight shapes the int8 kernel does not take) on a tp
    shard, raises instead of carrying on on the CPU or in plain attention.
    On the card ``chips`` places a one-device engine: one chip ``i`` is
    ``cuda:i`` when that device is visible and the first device otherwise
    (the reference's fallback); more than one raises here, since a single
    device is asked for (``LLMEngine.create`` spans several with a mesh).
    The CPU ignores them."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (options['device'] = 'cpu') "
            "to run on the CPU"
        )
    if device.type == "cuda" and chips:
        if len(chips) > 1:
            raise ValueError(
                f"chips={list(chips)}: a single device is asked for here "
                "(LLMEngine.create spans several with a mesh)"
            )
        chip = int(chips[0])
        device = torch.device("cuda", chip if 0 <= chip < torch.cuda.device_count() else 0)
    if device.type == "cuda" and not supported(cfg, tp):
        raise ValueError(
            f"{cfg.name}: no attention kernel for {cfg.n_heads // tp} heads over "
            f"{cfg.n_kv_heads // tp} kv heads of head_dim {cfg.head_dim}"
            + (f" (tp={tp})" if tp > 1 else "") + "; pass device='cpu'"
        )
    if device.type == "cuda" and quant:
        bad = [kn for kn in _weight_shapes(cfg, tp) if not cuda_quant.supported(*kn)]
        if bad:
            raise ValueError(
                f"{cfg.name}: no int8 kernel for weights (K, N) {bad} "
                f"(K % {cuda_quant.BK} == 0, N % 16 == 0); pass device='cpu'"
            )
    return device


def _placement(cfg: ModelConfig, options: dict, chips: list[int]) -> tuple[int, int, int, int, list]:
    """``(tp, ep, sp, pp, devices)`` as the reference's ``create`` places an
    agent: the chip budget is the assignment (``chips``), which the mesh may
    narrow and never spill past, or what the options ask for. A pipeline
    (``pp`` > 1) takes ``pp`` of it alone; otherwise ``sp`` reserves its
    chips first, an MoE model splits the rest EP-first (explicit
    ``tp``/``ep`` override), a dense one spans an assignment with tp, and
    ``sp`` takes what tp × ep leaves; tp and ep are divisors of the model's
    head or expert count (``pick_tp``/``pick_ep``). On the card the budget
    is clamped to the visible devices and the mesh takes the assigned ones
    (the first ones when an id is not visible); on the CPU every shard is
    ``cpu``."""
    on_card = torch.device(options.get("device", "cuda")).type == "cuda"
    visible = torch.cuda.device_count() if on_card and torch.cuda.is_available() else None
    tp_asked = int(options.get("tp", 0) or 0)
    ep_asked = int(options.get("ep", 0) or 0)
    sp_asked = int(options.get("sp", 0) or 0)
    pp_asked = int(options.get("pp", 0) or 0)
    if chips:
        budget = len(chips)
    else:
        budget = max(1, tp_asked) * max(1, ep_asked) * max(1, sp_asked) * max(1, pp_asked)
    if visible is not None:
        budget = max(1, min(budget, visible))
    tp = ep = sp = pp = 1
    if pp_asked > 1:
        pp = min(pp_asked, budget)
        check_stages(cfg, pp)
    else:
        # sequence parallelism reserves its chips before the tp/ep split
        model_budget = max(1, budget // max(1, sp_asked))
        if cfg.is_moe:
            # EP-first: experts dominate a MoE model's memory
            if ep_asked:
                ep = pick_ep(cfg, min(ep_asked, model_budget))
                tp = pick_tp(cfg, min(max(1, tp_asked), model_budget // ep))
            elif tp_asked:
                tp = pick_tp(cfg, min(tp_asked, model_budget))
                ep = pick_ep(cfg, model_budget // tp)
            else:
                ep = pick_ep(cfg, model_budget)
                tp = pick_tp(cfg, model_budget // ep)
        else:
            # a dense agent spans its whole assignment unless tp is asked
            dense_tp = tp_asked if tp_asked else (model_budget if chips else 1)
            tp = pick_tp(cfg, min(max(1, dense_tp), model_budget))
        sp = max(1, min(sp_asked, budget // (tp * ep))) if sp_asked else 1
        asked = max(1, tp_asked) * max(1, ep_asked) * max(1, sp_asked)
        if tp * ep * sp < min(asked, budget) or (chips and tp * ep * sp < len(chips)):
            print(
                f"[llm-engine] parallelism narrowed to tp={tp} ep={ep} sp={sp} (asked "
                f"tp={tp_asked or 'auto'} ep={ep_asked or 'auto'} sp={sp_asked or 'auto'}, "
                f"assigned chips={len(chips) or 'none'}, visible devices="
                f"{visible if visible is not None else 'cpu'}, model kv_heads={cfg.n_kv_heads}, "
                f"heads={cfg.n_heads}, experts={cfg.n_experts}); extra chips idle",
                flush=True,
            )
    n_use = tp * ep * sp * pp
    if not on_card:
        return tp, ep, sp, pp, [torch.device("cpu")] * n_use
    if visible is None:
        return tp, ep, sp, pp, [torch.device("cuda")] * n_use  # _engine_device raises: no card
    if chips and len(chips) >= n_use and all(0 <= c < visible for c in chips):
        return tp, ep, sp, pp, [torch.device("cuda", c) for c in chips[:n_use]]
    return tp, ep, sp, pp, [torch.device("cuda", i) for i in range(n_use)]


def _weight_shapes(cfg: ModelConfig, tp: int = 1) -> list[tuple[int, int]]:
    """(K, N) of every weight product of a forward that goes through the
    int8 kernels, on one tp shard: an MoE config's expert stacks have the
    dense FFN's (K, N) per expert; its router goes its own route
    (``models/llama._router_logits``) and is not listed."""
    d, q, kv = cfg.dim, cfg.n_heads * cfg.head_dim // tp, cfg.n_kv_heads * cfg.head_dim // tp
    f, v = cfg.ffn_dim // tp, cfg.vocab_size // tp
    return [(d, q), (d, kv), (q, d), (d, f), (f, d), (d, v)]


@dataclass
class GenRequest:
    id: str
    session: str
    prompt_ids: list[int]
    max_tokens: int
    temperature: float
    loop: asyncio.AbstractEventLoop
    future: asyncio.Future
    # absolute wall-clock give-up instant (time.time(); None = no deadline):
    # checked at admission and on every worker iteration while in flight
    deadline_at: float | None = None
    submitted_at: float = field(default_factory=time.monotonic)
    prefill_started_at: float | None = None
    # final prefill chunk + first-token injection dispatched
    prefill_done_at: float | None = None
    ttft_ms: float | None = None
    # keep generating through EOS until max_tokens (fixed-length streams)
    ignore_eos: bool = False
    top_k: int = 0
    top_p: float = 1.0
    generated: list[int] = field(default_factory=list)
    # tokens sampled on the device so far (first token + dispatched decode
    # steps): the remaining budget bounds how large a chunk is worth running
    dispatched: int = 0
    # SSE streaming: called on the worker thread as ``emit(start, ids)``
    # right after tokens land in ``generated`` (start = offset of ids[0]),
    # from the readbacks the worker processes anyway; batches arrive in
    # order and contiguous. None for a buffered request.
    emit: object = None

    def emit_appended(self, n_new: int) -> None:
        """Report the last ``n_new`` tokens of ``generated`` to ``emit``
        (nothing without one). Never raises into the worker: a consumer
        that went away must not fail the generation."""
        if self.emit is None or n_new <= 0:
            return
        try:
            self.emit(len(self.generated) - n_new, self.generated[-n_new:])
        except Exception:
            pass


@dataclass
class SnapshotCmd:
    """Worker-queue command: stage a session's live KV prefix into pinned
    host memory for the caller to pack. Resolves with a ``StagedKV``,
    ``None`` (no such session, or nothing to save) or ``"rate-limited"``."""

    session: str
    loop: asyncio.AbstractEventLoop
    future: asyncio.Future


@dataclass
class StagedKV:
    """A staged snapshot: host ``k``/``v`` ``[L, n >= position, KV, hd]``
    that hold the session's KV once ``event`` has landed (staged per tp
    slice, ``k_parts``/``v_parts``, and read whole); when the staging began
    and how long its pinned allocation took."""

    k_parts: list
    v_parts: list
    event: object
    position: int
    pending_token: int | None
    staged_at: float
    alloc_ms: float

    @property
    def k(self) -> torch.Tensor:
        return unshard_kv(self.k_parts)

    @property
    def v(self) -> torch.Tensor:
        return unshard_kv(self.v_parts)


@dataclass
class ProfileCmd:
    """Worker-queue command: record a ``torch.profiler`` trace for
    ``duration_s``. The worker starts and stops the profiler itself,
    between dispatches: it is the thread that launches the engine's device
    work, and the profiler's start and stop must not race those launches.
    Resolves with the stopped profiler, for the caller to export."""

    duration_s: float
    loop: asyncio.AbstractEventLoop
    future: asyncio.Future


@dataclass
class RestoreCmd:
    """Worker-queue command: write a KV snapshot (host tensors ``[L,
    position, KV, hd]`` in the arena's dtype, pinned on the card) into the
    arena for ``session``. Resolves with True, or False when it does not
    fit or the session is busy."""

    session: str
    k: torch.Tensor
    v: torch.Tensor
    position: int
    pending_token: int | None
    loop: asyncio.AbstractEventLoop
    future: asyncio.Future


@dataclass
class ParkCmd:
    """Worker-queue command: demote an idle session's KV into the host tier
    (``kv_tiering``). Resolves with the exact staged ``StagedKV`` for the
    caller's blob, or None (tiering off, session unknown or busy, or the
    demote failpoint fired)."""

    session: str
    loop: asyncio.AbstractEventLoop
    future: asyncio.Future


@dataclass
class PrewarmCmd:
    """Worker-queue command: promote a host-tier session onto the device
    ahead of its next turn. Resolves True when the session is
    device-resident afterwards."""

    session: str
    loop: asyncio.AbstractEventLoop
    future: asyncio.Future


@dataclass
class TieredEntry:
    """One parked session in the host tier: the position-trimmed KV prefix
    ``[L, position, KV, hd]`` as pinned tensors in the cache's dtype, or,
    ``quantized``, as numpy int8 pages with per-page scales
    (``quantize_kv_pages``). Speculation state parks with the KV."""

    k: object
    v: object
    position: int
    pending_token: int | None
    nbytes: int
    parked_at: float
    quantized: bool = False
    k_scale: object = None
    v_scale: object = None
    pages: int = 0
    spec_hist: list[int] = field(default_factory=list)
    spec_ema: float = 1.0
    spec_miss: int = 0


@dataclass
class FusedState:
    """The fused loop's device state, allocated once (the loop's segments
    are separate graphs, so everything that crosses a segment lives here):
    the loop counters and flags, the per-lane emission record, the in-loop
    drafts and a branch's candidates, and the loop's uniforms."""

    it: torch.Tensor  # [1] iterations run
    nverify: torch.Tensor  # [1] of them on the verify branch
    cont: torch.Tensor  # [1] bool: run another iteration
    spec: torch.Tensor  # [1] bool: this iteration verifies drafts
    done: torch.Tensor  # [B] bool: EOS (or not live)
    full: torch.Tensor  # [B] bool: hit its budget (frozen, not finished)
    emitted: torch.Tensor  # [cap + 2, B]: emitted tokens, -1 past a count; last row drops
    nemit: torch.Tensor  # [B]
    reason: torch.Tensor  # [B] 0 running / 1 EOS
    nacc: torch.Tensor  # [B] accepted drafts
    ndr: torch.Tensor  # [B] drafted tokens
    rec: torch.Tensor  # [B] bool: active this iteration
    room: torch.Tensor  # [B] budget left this iteration
    drafts: torch.Tensor  # [B, K]
    dlen: torch.Tensor  # [B]
    cand: torch.Tensor  # [B, K + 1] the branch's candidate tokens
    navail: torch.Tensor  # [B]
    acc: torch.Tensor  # [B]
    dln: torch.Tensor  # [B]
    noise: torch.Tensor  # [cap, B, V] uniforms, one row per iteration


@dataclass
class PrefixEntry:
    """One cached token prefix: the KV a prefill wrote for ``tokens`` (exact
    bucket length). Dense: private copies ``kv`` of k/v [L, bucket, KV, hd]
    (each shard's heads on a mesh) in the cache dtype (bit-exact, no
    cast). Paged: the entry pins the owner's
    full ``pages`` by refcount, plus one copied ``tail_page`` holding the
    partial last page (``tail_len`` tokens) of a level that is not
    page-aligned. ``tokens`` is kept so a hash collision degrades to a
    miss."""

    kv: object  # dense: the arena's clone_prefix copies (per shard on a mesh)
    tokens: tuple
    nbytes: int
    created: float
    last_used: float
    hits: int = 0
    pages: list[int] | None = None
    tail_page: int | None = None
    tail_len: int = 0


@dataclass
class PagedSession:
    """A resident session in the paged arena: its KV lives in ``pages``
    (physical page ids, logical order), not in a lane, so between turns it
    holds only its pages and no compute lane. ``pages[:shared]`` are prefix
    pages mapped read-only from the prefix cache (refcount-shared; the
    session never writes below its fork point)."""

    name: str
    pages: list[int] = field(default_factory=list)
    shared: int = 0
    position: int = 0
    pending_token: int | None = None
    # bound compute lane while a request is in flight; None between turns
    lane: int | None = None
    last_used: float = 0.0
    # admission-time pending token, position and drafting corpus: a
    # pool-exhaustion failure rolls the session back to them instead of
    # dropping it
    admit_pending: int | None = None
    admit_position: int = 0
    admit_spec_hist: list[int] = field(default_factory=list)
    # self-speculation state persists across turns with the session (the
    # bound lane mirrors it and syncs it back at finish)
    spec_hist: list[int] = field(default_factory=list)
    spec_ema: float = 1.0
    spec_miss: int = 0


@dataclass
class Slot:
    idx: int
    session: str = ""
    position: int = 0  # next cache position to write
    # a fresh context's prompt (prefill from position 0), kept until its
    # final prefill chunk registers its bucket prefixes; None otherwise
    prefix_ctx: list[int] | None = None
    request: GenRequest | None = None
    # prompt tokens not yet prefilled (chunked prefill)
    pending_prompt: list[int] = field(default_factory=list)
    last_used: float = 0.0
    # the final sampled token of the previous reply was never fed through the
    # model; it is prepended to the session's next prompt
    pending_token: int | None = None
    # host mirror of the device-side decode position of this slot's lane
    dev_position: int = 0
    # this slot's lane in the decode carry is live
    decoding: bool = False
    # self-speculation: the token stream fed through this slot's KV (the
    # drafter's corpus), the acceptance EMA setting the draft length, and
    # lookup-miss / probe bookkeeping
    spec_hist: list[int] = field(default_factory=list)
    spec_ema: float = 1.0
    spec_miss: int = 0
    spec_probe_at: int = -(10**9)
    # paged arena: the session bound to this lane while a request is in
    # flight (None in dense mode and between turns)
    psess: PagedSession | None = None


@dataclass
class Readback:
    """One token readback in flight: ``host`` is a pinned host copy of the
    device tokens that holds them once ``event`` has landed. ``first``: the
    prefill-sampled first token [1] of ``req`` on ``slot``; ``chunk``: a
    decode chunk's tokens [chunk, B] for the lanes of ``snapshot``
    ((slot, request, start position) as dispatched); ``fused``: a fused
    loop's packed readback [cap + 7, B] for the lanes of ``snapshot``
    ([slot, request, start position, budget] as dispatched; the start is
    corrected once an earlier loop's readback is processed)."""

    kind: str
    host: torch.Tensor
    event: object
    slot: Slot | None = None
    req: GenRequest | None = None
    snapshot: list | None = None
    # a fused loop: its bound, its step key, and whether it ran as a graph
    # (its kernel calls are then counted from the readback)
    chunk: int = 0
    key: tuple | None = None
    graphed: bool = False


class LLMEngine:
    # dispatch-ahead depth (the reference's): the worker runs at most one
    # readback ahead of the one it processes, so the device-to-host copy and
    # the host's bookkeeping ride under the next chunk's compute
    _PIPELINE_DEPTH = 1

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        tokenizer,
        max_batch: int,
        max_seq: int,
        decode_chunk: int = 8,
        prefill_chunk: int = 256,
        adaptive_decode: bool = True,
        prefix_cache: bool = True,
        prefix_cache_bytes: int = 0,
        deadlines: bool = True,
        shed_watermark: int = 0,
        speculative: bool = True,
        spec_gamma_max: int = 8,
        paged_kv: bool = False,
        page_size: int = PAGE_SIZE_DEFAULT,
        kv_pages: int = 0,
        inloop_spec: bool = True,
        streaming: bool = False,
        approx_topk: bool = False,
        fused_decode: bool = False,
        kv_tiering: bool = False,
        tier_quantize: int = 1,
        routed_moe: bool | None = None,
        moe_capacity_factor: float = 2.0,
        device="cuda",
        mesh=None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        # serve-time model parallelism: a mesh of shards (module docstring);
        # its first shard's device is the engine's
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.tp, self.ep, self.sp, self.pp = (
            self.mesh.shape[a] if self.mesh else 1 for a in ("tp", "ep", "sp", "pp")
        )
        if self.mesh is not None:
            if self.mesh.shape["dp"] > 1:
                raise ValueError(f"{self.mesh}: dp is the control plane's replicas, not an engine axis")
            if self.pp > 1:
                if self.mesh.size != self.pp:
                    raise ValueError("serve-time pp does not compose with tp/ep/sp yet")
                check_stages(cfg, self.pp)
            device = self.mesh.device_list[0]
        self.device = _engine_device(device, cfg, tp=self.tp)
        # the sequence axis splits evenly over sp
        max_seq = -(-max_seq // self.sp) * self.sp
        # Paged KV arena: sessions hold lists of fixed-size pages from one
        # pool instead of dense [max_seq] rows. paged_kv=False keeps the
        # dense arena. sp splits the slots and pp the layers of the dense
        # arena: neither composes with the page pool (the reference's rule)
        self.paged = bool(paged_kv) and self.sp == 1 and self.pp == 1
        if bool(paged_kv) and not self.paged:
            print(
                "[llm-engine] paged_kv disabled: not composable with "
                f"sp={self.sp}/pp={self.pp} yet (dense arena retained)",
                flush=True,
            )
        self.page_size = max(8, int(page_size or PAGE_SIZE_DEFAULT))
        if self.paged:
            # the logical arena tiles exactly into pages
            max_seq = -(-max_seq // self.page_size) * self.page_size
        self.max_seq = max_seq
        # pages per full logical sequence (the block-table width)
        self._n_blocks = max(1, max_seq // self.page_size)
        # pool: by default the dense arena's KV (max_batch x max_seq tokens),
        # plus one scratch page per lane that absorbs parked-lane and
        # padding writes without touching a session's pages
        self._data_pages = max(1, int(kv_pages)) if kv_pages else max_batch * self._n_blocks
        self._total_pages = self._data_pages + max_batch
        if self.device.type == "cuda" and self.device.index is None:
            # pin the index: the worker thread selects this device by it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.decode_chunk = max(1, decode_chunk)
        # Adaptive decode-chunk policy: a ladder of chunk sizes; the
        # dispatcher shrinks to the smallest while anyone waits for
        # admission/prefill and runs the full chunk at steady state.
        self.adaptive_decode = bool(adaptive_decode)
        if self.adaptive_decode:
            ladder = {self.decode_chunk}
            c = 1
            while c < self.decode_chunk:
                ladder.add(c)
                c *= 2
            self._decode_ladder = sorted(ladder)
        else:
            self._decode_ladder = [self.decode_chunk]
        # snap DOWN to a bucket: a non-bucket chunk would pad every non-final
        # chunk up to the next bucket
        clamped = min(max(PREFILL_BUCKETS[0], prefill_chunk), PREFILL_BUCKETS[-1])
        self.prefill_chunk = max(b for b in PREFILL_BUCKETS if b <= clamped)
        self.scratch_pos = max_seq - 1  # idle-lane write target; never generated into
        # every bucket a prefill chunk can take: a chunk holds at most
        # prefill_chunk tokens, and an admitted prompt at most max_seq - 2
        top_bucket = self._bucket(min(self.prefill_chunk, max(1, max_seq - 2)))
        self._prefill_buckets = [b for b in PREFILL_BUCKETS if b <= top_bucket]
        # SSE token streaming: the serve layer streams a request when this is
        # on (tokens reach it through GenRequest.emit); the approximate
        # top-k sampler is a static choice of every sampled step
        self.streaming = bool(streaming)
        self.approx_topk = bool(approx_topk)
        # routed (token-dispatch) MoE is the default where experts shard
        # over ep > 1, the dense-einsum one elsewhere; ``routed_moe`` asks
        # for either (the reference's rule)
        self.routed_moe = cfg.is_moe and (self.ep > 1 if routed_moe is None else bool(routed_moe))
        self.moe_capacity_factor = float(moe_capacity_factor)
        cf = self.moe_capacity_factor
        if self.pp > 1:
            if self.routed_moe:
                raise ValueError("serve-time pp does not support routed MoE yet")
            self._moe_impl = None  # each stage runs the dense-einsum MoE of its layers
        elif self.mesh is not None and cfg.is_moe:
            self._moe_impl = (
                make_routed_moe(self.mesh, cfg, capacity_factor=cf)
                if self.routed_moe
                else functools.partial(moe_expert_parallel, cfg=cfg, mesh=self.mesh)
            )
        else:
            self._moe_impl = (
                functools.partial(_moe_mlp_routed, cfg=cfg, capacity_factor=cf)
                if self.routed_moe else None
            )
        # params: the unsharded tree, cut here on a mesh, or a mesh's shards
        # already cut (parallel/sharding.shard_params)
        if isinstance(params, list):
            if self.mesh is None or len(params) != self.mesh.size:
                raise ValueError("per-shard params need the mesh they were cut for")
            self.param_hbm_bytes = unsharded_bytes(params, self.mesh)
        else:
            self.param_hbm_bytes = param_bytes_actual(params)
            if self.mesh is not None:
                params = shard_params(params, self.mesh, cfg.is_moe)
        dtype = params[0]["final_norm"].dtype if isinstance(params, list) else params["final_norm"].dtype
        self.params = params
        kv_heads = cfg.n_kv_heads // self.tp
        if self.paged:
            def make(dev):
                return PagedKVCache.create(
                    cfg, self._total_pages, self.page_size, dtype=dtype, device=dev, n_kv_heads=kv_heads
                )
        else:
            # a shard holds its sp slice of the slots and its stage's layers
            def make(dev):
                return KVCache.create(
                    cfg, max_batch, max_seq // self.sp, dtype=dtype, device=dev, n_kv_heads=kv_heads,
                    n_layers=cfg.n_layers // self.pp,
                )
        self.cache = MeshCache.create(self.mesh, make) if self.mesh is not None else make(self.device)
        self._kv_dtype = dtype
        self.slots = [Slot(i) for i in range(max_batch)]
        # session name → owning slot index. Paged: the bound lane while a
        # request is in flight, -1 while resident between turns (the KV
        # lives in paged_sessions[name].pages)
        self.sessions: dict[str, int] = {}

        # -- paged-arena allocator (host side; _page_lock guards it) ------
        # ids [0, _data_pages) are allocatable; id _data_pages + i is lane
        # i's scratch page. The block table is host state (numpy); its
        # device copy ``_dbt`` is one static buffer, rewritten in place
        # (``_sync_table``) before a dispatch when the host table changed.
        self.paged_sessions: dict[str, PagedSession] = {}
        self._page_lock = threading.RLock()
        self._page_free: list[int] = list(range(self._data_pages - 1, -1, -1))
        self._page_refs = np.zeros(self._total_pages, dtype=np.int64)
        self._bt = np.empty((max_batch, self._n_blocks), dtype=np.int32)
        for i in range(max_batch):
            self._bt[i, :] = self._scratch_page(i)
        self._bt_sent = self._bt.copy()  # what _dbt holds (as of its last upload)
        self.page_exhausted_total = 0
        self.pages_truncated = 0
        # a demotion's freed pages, with the event of its staging copy: they
        # rejoin the free list once the copy has landed (_reap_quarantine)
        self._page_quarantine: collections.deque = collections.deque()

        # The engine's stream: every device write of the engine (graph
        # replays, staging copies, prefill, prefix copies, page copies) goes
        # on it, in order.
        dev = self.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._xfer = HostTransfers(dev)
        # Decode carry: (token, position, temperature, top_k, top_p) per lane
        # on the device. Idle lanes park at scratch_pos; a finished prompt's
        # first token is written into its lane in place. These buffers, the
        # verify inputs and the device block table are allocated once and
        # only ever written in place: the step graphs replay their addresses.
        self._dtok = torch.zeros((max_batch,), dtype=torch.long, device=dev)
        self._dpos = torch.full((max_batch,), self.scratch_pos, dtype=torch.int32, device=dev)
        self._dtemps = torch.zeros((max_batch,), dtype=torch.float32, device=dev)
        self._dtopk = torch.zeros((max_batch,), dtype=torch.long, device=dev)
        self._dtopp = torch.ones((max_batch,), dtype=torch.float32, device=dev)
        self._dbt = (
            torch.tensor(self._bt, dtype=torch.int32, device=dev) if self.paged else None
        )
        # the in-loop drafter's token-history carry (right-aligned recent
        # tokens) and its valid length; written only with in-loop spec
        self._dhist = torch.zeros((max_batch, FUSED_HIST_W), dtype=torch.long, device=dev)
        self._dhlen = torch.zeros((max_batch,), dtype=torch.long, device=dev)
        # host mirror of the lanes' temperatures: the all-greedy sampler fast
        # path is decided here, without reading the device
        self._lane_temps = [0.0] * max_batch
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(0)
        # FIFO of token readbacks (Readback); a stale entry is detected by
        # `slot.request is not req` at processing time
        self._readbacks: collections.deque[Readback] = collections.deque()
        # the entry being queued while the FIFO makes room for it
        self._pushing: Readback | None = None
        # step graphs (the card; captured by warmup) and the warmup flag
        # under which the card's steps run eagerly before capture
        # a mesh over several cards serves eagerly: no capture spans devices
        one_card = self.mesh is None or len(self.mesh.distinct_devices) == 1
        self._graphs = StepGraphs(dev) if dev.type == "cuda" and one_card else None
        self._warming = False

        self._queue: queue.Queue[GenRequest | None] = queue.Queue()
        self._waiting: list = []  # submitted-but-unadmitted requests
        self._sentinel = False
        self._completed: collections.OrderedDict[str, dict] = collections.OrderedDict()
        self._lock = threading.Lock()
        self._running = True
        self._prefilling_slot: Slot | None = None

        # counters
        self.tokens_generated = 0
        self.prefills = 0
        self.ttft_ms_recent: collections.deque[float] = collections.deque(maxlen=256)
        self.itl_ms_recent: collections.deque[float] = collections.deque(maxlen=256)
        self.admission_ms_recent: collections.deque[float] = collections.deque(maxlen=256)
        self.decode_chunk_hist: dict[int, int] = {}
        self.decode_chunks_shrunk = 0
        self.worker_errors = 0
        self.last_worker_error = ""
        self.session_evictions = 0
        self.decode_steps = 0
        # readbacks that crossed to the host (one per processed first token,
        # decode chunk and verify round), as the reference counts them
        self.host_syncs_total = 0
        self._occupancy_sum = 0.0
        self._last_decode_end: float | None = None
        self._started_at = time.monotonic()
        # FLOP / memory-traffic model for MFU and MBU, as in the reference:
        # every decode step streams the weights once plus each live lane's KV
        # prefix; prefill streams the weights once per chunk.
        self.flops_done = 0.0
        self.hbm_bytes_read = 0.0
        esize = torch.empty((), dtype=dtype).element_size()
        self._kv_bytes_per_pos = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * esize
        # the unsharded arena's (or pool's) bytes, as the reference reports
        # a sharded array's
        slots = self._total_pages * self.page_size if self.paged else max_batch * max_seq
        self.kv_arena_bytes = slots * self._kv_bytes_per_pos
        self.prefill_chunks = 0  # prefill forwards (one per chunk)

        # -- request lifecycle policy (deadlines=False: no expiry checks and
        # no shed; cancel() is an API and works either way) ---------------
        self.deadlines = bool(deadlines)
        self.shed_watermark = max(0, int(shed_watermark))  # 0 = no shed
        # request id → cancel-record time (monotonic), under self._lock; a
        # marker whose request never arrives expires after _cancel_ttl_s
        self._cancel_requested: dict[str, float] = {}
        self._cancel_ttl_s = 30.0
        self._draining = False
        self.cancelled_total = 0
        self.expired_total = 0
        self.shed_total = 0

        # -- KV snapshots (the reference's limiter): one staging per gap,
        # wider while other requests decode, and a per-session durability
        # floor that forces one through a busy engine eventually ---------
        self.snapshot_min_gap_s = 2.0
        self.snapshot_force_s = 30.0
        self.snapshot_busy_gap_s = 10.0
        # gap-free first snapshot
        self._last_snapshot_at = time.monotonic() - self.snapshot_min_gap_s
        # session → SnapshotCmd parked until the session's request settles
        self._snap_parked: dict[str, SnapshotCmd] = {}
        # per-session staging times for the durability floor
        self._snap_last_by_session: dict[str, float] = {}
        self._snap_epoch0 = time.monotonic()
        # restores and tier promotions whose host-to-device copy may be in
        # flight: (event, k, v) — the pinned sources live until their event
        # has landed
        self._restore_staging: collections.deque = collections.deque()
        # a profile in progress: (profiler, stop instant, its ProfileCmd)
        self._profile: tuple | None = None
        self.kv_snapshots_total = 0
        self.kv_restores_total = 0
        # per snapshot: position, alloc_ms (its pinned buffers), stage_ms
        # (staging began → landed on the host), pack_ms, raw_bytes,
        # blob_bytes
        self.snapshot_timings: collections.deque[dict] = collections.deque(maxlen=64)

        # -- prefix cache: bucket-length prefixes → their KV, forked into
        # fresh sessions at admission; LRU under a bytes budget ------------
        self.prefix_cache = bool(prefix_cache)
        self._prefix_active = self.prefix_cache  # warmup serves with it off
        # a hit must leave >= 1 prompt token to prefill
        self._prefix_levels = [b for b in PREFILL_BUCKETS if b <= max_seq - 2]
        self._prefix_entries: collections.OrderedDict[tuple, PrefixEntry] = (
            collections.OrderedDict()
        )
        self._prefix_bytes = 0
        # default budget: one more arena's worth (dense), or half the pool
        # (paged: prefix pages are pinned inside the pool)
        if prefix_cache_bytes:
            self._prefix_budget = int(prefix_cache_bytes)
        elif self.paged:
            self._prefix_budget = self.kv_arena_bytes // 2
        else:
            self._prefix_budget = self.kv_arena_bytes
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.prefix_evictions = 0
        self.prefix_pages_shared = 0
        self.session_eviction_idle_s_recent: collections.deque[float] = collections.deque(maxlen=64)
        self.prefix_eviction_idle_s_recent: collections.deque[float] = collections.deque(maxlen=64)

        # -- self-speculative decoding -------------------------------------
        self.speculative = bool(speculative)
        gamma_max = max(1, min(int(spec_gamma_max), SPEC_VERIFY_BUCKETS[-1]))
        self._spec_buckets = [b for b in SPEC_VERIFY_BUCKETS if b <= gamma_max] or [
            SPEC_VERIFY_BUCKETS[0]
        ]
        # snap down to the largest verify bucket
        self.spec_gamma_max = self._spec_buckets[-1]
        # -- the fused decode loop ----------------------------------------
        # pp stages the forward across devices, step by step: pp pins the
        # unfused dispatch (the reference's rule)
        self.fused_decode = bool(fused_decode) and self.pp == 1
        if bool(fused_decode) and not self.fused_decode:
            print(
                f"[llm-engine] fused_decode disabled: not composable with pp={self.pp} "
                "(per-chunk dispatch retained)",
                flush=True,
            )
        # the in-loop drafter needs the loop and speculation, and is off on
        # a mesh (reference)
        self.inloop_spec = (
            bool(inloop_spec) and self.fused_decode and self.speculative and self.mesh is None
        )
        self.inloop_spec_drafted = 0
        self.inloop_spec_accepted = 0
        # the loop's static bound: its buffers are sized by it, and a
        # dispatch runs any bound in [1, cap] (``_pick_fused_chunk``)
        self._fused_cap = max(self.decode_chunk, FUSED_RUNG_MULT * self.decode_chunk)
        self.fused_loops_total = 0
        self.fused_steps_total = 0
        # of those iterations, the ones that took the verify branch
        self.fused_verify_steps_total = 0
        self.fused_early_exits_total = 0
        self.fused_exit_reason_hist: dict[str, int] = {}
        # double-buffered injection: a lane prefilled while a loop is in
        # flight is written into the shadow carry, and the next loop absorbs
        # it at entry (``armed``); an occupied slot falls back to injecting
        # into the live carry
        self._fused_inject = self.fused_decode
        self._staged_lane: int | None = None
        self.fused_injections_total = 0
        self.fused_inject_fallbacks_total = 0
        if self.fused_decode:
            B, k_f = max_batch, FUSED_SPEC_K if self.inloop_spec else 0
            self._stok = torch.zeros_like(self._dtok)
            self._spos = torch.full_like(self._dpos, self.scratch_pos)
            self._stemps = torch.zeros_like(self._dtemps)
            self._stopk = torch.zeros_like(self._dtopk)
            self._stopp = torch.ones_like(self._dtopp)
            self._shist = torch.zeros_like(self._dhist)
            self._shlen = torch.zeros_like(self._dhlen)
            # a loop's inputs, one upload: armed, live, budgets, ignore_eos
            # [B] each, then the loop bound
            self._finput = torch.zeros((4 * B + 1,), dtype=torch.long, device=dev)

            def zeros(*shape, dtype=torch.long):
                return torch.zeros(shape, dtype=dtype, device=dev)

            self._fl = FusedState(
                it=zeros(1), nverify=zeros(1), cont=zeros(1, dtype=torch.bool),
                spec=zeros(1, dtype=torch.bool), done=zeros(B, dtype=torch.bool),
                full=zeros(B, dtype=torch.bool), emitted=zeros(self._fused_cap + 2, B),
                nemit=zeros(B), reason=zeros(B), nacc=zeros(B), ndr=zeros(B),
                rec=zeros(B, dtype=torch.bool), room=zeros(B), drafts=zeros(B, max(1, k_f)),
                dlen=zeros(B), cand=zeros(B, k_f + 1), navail=zeros(B), acc=zeros(B),
                dln=zeros(B), noise=zeros(self._fused_cap, B, cfg.vocab_size, dtype=torch.float32),
            )
        self._spec_active = self.speculative  # warmup serves with it off
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.spec_verify_hist: dict[int, int] = {}
        # verify inputs: drafts per bucket [B, K] and draft lengths [B]
        self._vdrafts = {
            k: torch.zeros((max_batch, k), dtype=torch.long, device=dev) for k in self._spec_buckets
        }
        self._vdlen = torch.zeros((max_batch,), dtype=torch.long, device=dev)
        # prefill inputs, one static buffer for every bucket: [start
        # position, index of the last real token, dense arena row] then the
        # bucket's tokens; the paged step reads the lane's block-table row
        # from ``_pbt``, copied from the table before each chunk
        self._pinput = torch.zeros(
            (3 + self._prefill_buckets[-1],), dtype=torch.long, device=dev
        )
        self._pbt = (
            torch.zeros((1, self._n_blocks), dtype=torch.int32, device=dev) if self.paged else None
        )

        # -- the tiered KV hierarchy (device -> pinned host RAM) -------------
        # _tier_lock guards the host tier and its gauges: API threads read
        # them while the worker demotes and promotes
        self.kv_tiering = bool(kv_tiering)
        self.tier_quantize = int(tier_quantize)
        self._tier_lock = threading.Lock()
        self._host_tier: collections.OrderedDict[str, TieredEntry] = collections.OrderedDict()
        # host bytes for parked KV; past it the LRU entries are dropped
        self.tier_host_budget_bytes = self.kv_arena_bytes
        self.tier_host_bytes = 0
        self.tier_quantized_pages = 0
        self.tier_demotions_total = 0
        self.tier_promotions_total = 0
        self.tier_pressure_demotions_total = 0
        self.tier_prewarm_hits_total = 0
        self.tier_demote_failures_total = 0
        self.tier_promote_failures_total = 0
        self.tier_host_evictions_total = 0
        self.tier_promote_overlap_ms_total = 0.0
        # promotion start instants by session, consumed when the session's
        # next request dispatches its first prefill chunk
        self._tier_promote_started: dict[str, float] = {}
        self.tier_promote_overlap_ms_recent: collections.deque[float] = collections.deque(maxlen=64)
        # per park and promotion: kind, session, bytes, ms (stage or copy)
        self.tier_timings: collections.deque[dict] = collections.deque(maxlen=64)

        # a checkpoint load's bytes_read and seconds (create sets it)
        self.checkpoint_load: dict = {}
        self._chip = chip_spec(self.device)
        self._peak_flops = self._chip.bf16_flops
        self._peak_hbm_bps = self._chip.hbm_gbps

        if self._stream is not None:
            # the weights (a quantization or a synthetic draw may still be
            # running) and the buffers above were written on the creator's
            # stream: the engine's stream starts after them
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        self._worker = threading.Thread(target=self._loop, daemon=True, name="llm-engine")
        self._worker.start()

    # -- construction -----------------------------------------------------
    @classmethod
    def create(
        cls,
        config_name: str,
        checkpoint: str = "",
        options: dict | None = None,
        mesh=None,
    ) -> "LLMEngine":
        """Build an engine with the weights of ``checkpoint`` (a HuggingFace
        directory, whose ``config.json`` gives the model config), or with
        random weights from ``options["seed"]``.

        ``options["device"]`` defaults to ``"cuda"``; with no card this
        raises rather than carrying on on the CPU — pass ``"cpu"`` to ask
        for it. ``options["chips"]``, ``"tp"``, ``"ep"``, ``"sp"`` and
        ``"pp"`` place the engine on one device or over a mesh
        (``_placement``); pp with another axis, with int8 weights or with
        routed MoE raises, as in the reference. ``mesh``
        (``parallel/mesh.make_mesh``) serves on that mesh instead of placing
        one, e.g. a logical mesh whose shards share one card. dtype follows the reference: bf16 on the card, f32 on the
        CPU."""
        options = options or {}
        quant = str(options.get("quant", "") or "").lower()
        if quant and quant not in QUANT_SCHEMES:
            raise ValueError(f"unknown quant scheme {quant!r} (supported: {', '.join(QUANT_SCHEMES)})")
        pp_asked = mesh.shape["pp"] if mesh is not None else int(options.get("pp", 0) or 0)
        if pp_asked > 1:
            # serve-time pp composes with nothing else yet (the reference's
            # refusals, in its order)
            others = (mesh.size > mesh.shape["pp"]) if mesh is not None else any(
                int(options.get(a, 0) or 0) for a in ("tp", "ep", "sp")
            )
            if others:
                raise ValueError("serve-time pp does not compose with tp/ep/sp yet")
            if quant:
                raise ValueError("serve-time pp does not support quantized weights yet")
            if options.get("routed"):
                raise ValueError("serve-time pp does not support routed MoE yet")
        if checkpoint and is_hf_checkpoint(checkpoint):
            # the checkpoint's own config.json; an explicit config name
            # stands in for a missing or unusable one
            try:
                cfg = config_from_hf(checkpoint)
            except (OSError, KeyError, ValueError) as e:
                if not config_name:
                    raise ValueError(
                        f"checkpoint {checkpoint!r} has no usable config.json ({e!r}); "
                        "pass model.config explicitly"
                    ) from e
                cfg = get_config(config_name)
        else:
            cfg = get_config(config_name or "tiny")
        chips = [int(c) for c in options.get("chips", []) or []]
        if mesh is None:
            tp, ep, sp, pp, devices = _placement(cfg, options, chips)
            if len(devices) > 1:
                mesh = make_mesh(len(devices), tp=tp, ep=ep, sp=sp, pp=pp, devices=devices)
        sp = mesh.shape["sp"] if mesh is not None else 1
        if mesh is not None:
            device = _engine_device(mesh.device_list[0], cfg, quant=quant, tp=mesh.shape["tp"])
        else:
            device = _engine_device(options.get("device", "cuda"), cfg, chips[:1], quant)
        tokenizer = load_tokenizer(cfg.vocab_size, checkpoint)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        load_stats: dict = {}
        if checkpoint:
            # int8: quantized slice by slice as it streams
            params = load_params(
                cfg, checkpoint, dtype=dtype, device=device, stats=load_stats, quant=quant
            )
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(options.get("seed", 0)))
            if quant and options.get("synthetic"):
                # benchmark-grade int8 weights drawn in device memory
                params = synthetic_quantized_params(cfg, dtype, device, gen, mesh=mesh)
            else:
                # ``synthetic`` without ``quant`` is a plain random init, as
                # in the reference
                params = init_params(cfg, gen, dtype=dtype, device=device)
                if quant:
                    params = quantize_params(params, dtype, mesh=mesh)
        engine = cls(
            cfg,
            params,
            tokenizer,
            max_batch=int(options.get("max_batch", 8)),
            # the sequence-sharded arena holds sp x one device's context
            # budget by default (the reference's)
            max_seq=int(options.get("max_seq", min(cfg.max_seq_len, 2048 * sp))),
            decode_chunk=int(options.get("decode_chunk", 8)),
            prefill_chunk=int(options.get("prefill_chunk", 256)),
            adaptive_decode=bool(options.get("adaptive_decode", True)),
            prefix_cache=bool(options.get("prefix_cache", True)),
            prefix_cache_bytes=int(options.get("prefix_cache_bytes", 0) or 0),
            deadlines=bool(options.get("deadlines", True)),
            shed_watermark=int(options.get("shed_watermark", 0) or 0),
            speculative=bool(options.get("speculative", True)),
            spec_gamma_max=int(options.get("spec_gamma_max", 8) or 8),
            paged_kv=bool(options.get("paged_kv", False)),
            page_size=int(options.get("page_size", PAGE_SIZE_DEFAULT) or PAGE_SIZE_DEFAULT),
            kv_pages=int(options.get("kv_pages", 0) or 0),
            inloop_spec=bool(options.get("inloop_spec", True)),
            streaming=bool(options.get("streaming", False)),
            approx_topk=bool(options.get("approx_topk", False)),
            fused_decode=bool(options.get("fused_decode", False)),
            kv_tiering=bool(options.get("kv_tiering", False)),
            tier_quantize=int(options.get("tier_quantize", 1)),
            routed_moe=options.get("routed"),
            moe_capacity_factor=float(options.get("moe_cf", 2.0)),
            device=device,
            mesh=mesh,
        )
        engine.checkpoint_load = load_stats
        if not options.get("skip_warmup"):
            engine.warmup()
        elif device.type == "cuda":
            # the card serves through the step graphs only
            engine.capture_step_graphs()
        return engine

    def warmup(self) -> None:
        """Serve one synthetic request per reachable prefill bucket and one
        per decode-ladder rung through the real worker machinery, so every
        first-use cost (kernel build and load, library handles, allocator
        growth) is paid here instead of by the first user request; on the
        card the steps run eagerly while warmup serves, and then every step
        graph — prefill buckets, decode rungs, verify buckets — is captured
        (``capture_step_graphs``; a capture that fails raises here). Serving
        telemetry from warmup is dropped at the end.

        Warmup serves once: after the captures (which empty the
        allocator's cache) only a chunk's first-token sample (a few bytes)
        and a prefix registration's copies allocate outside the graphs'
        pool, so there is no eager step left for a second pass to warm."""
        filler = min(5, self.cfg.vocab_size - 1)

        async def _one(n_prompt: int, mt: int) -> None:
            loop = asyncio.get_running_loop()
            req = GenRequest(
                id="",
                session="",
                prompt_ids=[self.tokenizer.bos_id] + [filler] * (n_prompt - 1),
                max_tokens=mt,
                temperature=0.0,
                loop=loop,
                future=loop.create_future(),
            )
            self._submit(req)
            await req.future

        async def _serve_all() -> None:
            for b in self._prefill_buckets:
                n = max(1, min(b, self.max_seq - 2))
                mt = max(1, min(self.decode_chunk, self.max_seq - 1 - n))
                await _one(n, mt)
            for c in self._decode_ladder:
                await _one(1, min(c + 1, max(2, self.max_seq - 2)))

        def serve_pass() -> None:
            box: list[BaseException] = []

            def _runner() -> None:
                try:
                    asyncio.run(_serve_all())
                except BaseException as e:  # surface warmup faults to create()
                    box.append(e)

            t = threading.Thread(target=_runner, name="llm-warmup")
            t.start()
            t.join()
            if box:
                raise box[0]

        # prefix cache and speculation stay off while warmup serves: the
        # filler prompts share a prefix (a hit would shrink a pass below its
        # bucket) and are maximally repetitive (a verify round would replace
        # the decode chunks warmup exists to run). Their shapes run below.
        self._prefix_active = False
        self._spec_active = False
        try:
            self._warming = True
            try:
                serve_pass()
            finally:
                self._warming = False
            # the worker idles on its queue now: run the prefix copies here,
            # then capture every step, with every lane parked at scratch
            # (verify writes land in scratch slots, as parked decode's do)
            with torch.no_grad(), self._on_stream():
                if self.prefix_cache and self.paged:
                    scr = self._scratch_page(0)
                    self._copy_page(scr, scr)
                elif self.prefix_cache:
                    for b in self._prefix_levels:
                        self.cache.fork_prefix(0, self.cache.clone_prefix(0, b))
            self.capture_step_graphs()
        finally:
            self._prefix_active = self.prefix_cache
            self._spec_active = self.speculative
        self.clear_sessions()
        self._prefix_entries.clear()
        self._prefix_bytes = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.prefix_evictions = 0
        self.prefix_pages_shared = 0
        self.session_eviction_idle_s_recent.clear()
        self.prefix_eviction_idle_s_recent.clear()
        self.prefill_chunks = 0
        self.ttft_ms_recent.clear()
        self.itl_ms_recent.clear()
        self.admission_ms_recent.clear()
        self.decode_chunk_hist = {}
        self.decode_chunks_shrunk = 0
        self.fused_loops_total = 0
        self.fused_steps_total = 0
        self.fused_verify_steps_total = 0
        self.fused_early_exits_total = 0
        self.fused_exit_reason_hist = {}
        self.fused_injections_total = 0
        self.fused_inject_fallbacks_total = 0
        self.inloop_spec_drafted = 0
        self.inloop_spec_accepted = 0
        self.session_evictions = 0
        self.page_exhausted_total = 0
        self.pages_truncated = 0
        self.tokens_generated = 0
        self.prefills = 0
        self.decode_steps = 0
        self.host_syncs_total = 0
        if self._graphs is not None:
            self._graphs.reset_replays()
        self._occupancy_sum = 0.0
        self.flops_done = 0.0
        self.hbm_bytes_read = 0.0
        self._last_decode_end = None
        self._started_at = time.monotonic()

    def _step_keys(self) -> list[tuple]:
        """Every step the worker dispatches: ("prefill", bucket, True) for
        each reachable prefill bucket (the first token is sampled after the
        step, so it draws nothing), ("decode", rung, all_greedy) for each
        decode-ladder rung, or with ``fused_decode`` ("fused", cap,
        all_greedy) for the fused loop, and ("verify", K, all_greedy) for
        each verify bucket (with host-side speculation)."""
        keys = [("prefill", b, True) for b in self._prefill_buckets]
        if self.fused_decode:
            keys += [("fused", self._fused_cap, g) for g in (True, False)]
        else:
            keys += [("decode", c, g) for c in self._decode_ladder for g in (True, False)]
        if self.speculative and not self.inloop_spec:
            keys += [("verify", k, g) for k in self._spec_buckets for g in (True, False)]
        return keys

    def _step_fn(self, key: tuple):
        """The eager step function of ``key``: what the CPU runs and what a
        graph captures (a fused loop's graph is assembled from the segments
        its eager loop runs, ``_fused_parts``)."""
        kind, n, all_greedy = key
        if kind == "prefill":
            return functools.partial(self._prefill_step, n)
        if kind == "fused":
            return functools.partial(self._fused_steps, all_greedy)
        fn = self._decode_steps if kind == "decode" else self._verify_step
        return functools.partial(fn, n, all_greedy)

    def _park_prefill_inputs(self) -> None:
        """Point the prefill inputs where a step writes nothing live: from
        the scratch position of arena row 0 (dense; the positions past it
        land in the spare slot) or through lane 0's scratch page (paged)."""
        meta = np.zeros(self._pinput.shape, dtype=np.int64)
        meta[0] = self.scratch_pos
        self._xfer.upload(self._pinput, meta)
        if self.paged:
            self._pbt.fill_(self._scratch_page(0))

    def capture_step_graphs(self) -> None:
        """Capture every step (``_step_keys``) into a CUDA graph, with every
        lane parked and the prefill inputs at scratch, and park them again
        after. On the CPU there is nothing to capture: the steps run
        eagerly. Raises if a capture fails; the engine then does not come
        up."""
        if self._graphs is None:
            return
        keys = self._step_keys()
        steps = {k: self._step_fn(k) for k in keys if k[0] != "fused"}
        sampled = {k for k in steps if not k[2]}
        kept = set()
        if self.fused_decode:
            # a loop's segments are kept graphs; its prologue is replayed on
            # its own, so the sampled one draws its uniforms off the
            # generator registered with it
            for g in (True, False):
                for name, (key, fn) in self._fused_parts(g).items():
                    steps[key] = fn
                    if name != "prologue":
                        kept.add(key)
                    elif not g:
                        sampled.add(key)
        with torch.no_grad(), self._on_stream():
            self._sync_table()
            self._park_prefill_inputs()
            self._graphs.capture(steps, self._gen, sampled, kept)
            if self.fused_decode:
                fl = self._fl
                for g in (True, False):
                    part = {name: key for name, (key, _) in self._fused_parts(g).items()}
                    self._graphs.build_loop(
                        ("fused", self._fused_cap, g), part["prologue"], part["plain"], fl.cont,
                        pre=part["pre"], verify=part.get("verify"), post=part["post"],
                        tail=part["tail"], spec=fl.spec,
                    )
            # a graph's first launch uploads it to the device, a host cost
            # paid here rather than in a user request's first chunk (a
            # parked fused loop runs no iteration)
            for k in keys:
                self._graphs.replay(k)
            for i in range(self.max_batch):
                self._park_lane(i)
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _on_stream(self):
        """Make the engine's device and stream current on this thread (the
        card), else nothing."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def _device_state(self) -> list[torch.Tensor]:
        """Every device tensor a step reads or writes: the carry, the verify
        and prefill inputs, the block tables and the KV arena or pools."""
        state = [self._dtok, self._dpos, self._dtemps, self._dtopk, self._dtopp, self._vdlen]
        state += [*self._vdrafts.values(), self._pinput, self._dhist, self._dhlen]
        if self.fused_decode:
            state += [self._stok, self._spos, self._stemps, self._stopk, self._stopp]
            state += [self._shist, self._shlen, self._finput]
            state += [getattr(self._fl, f) for f in self._fl.__dataclass_fields__]
        if self.paged:
            state += [self._dbt, self._pbt]
        return state + self.cache.tensors()

    # -- public API (called from the serve layer's event loop) -------------
    def load_depth(self) -> int:
        """Queued + drained-but-unadmitted + in-flight requests: what the
        shed watermark is compared with (approximate by design)."""
        with self._queue.mutex:
            queued = sum(1 for it in self._queue.queue if isinstance(it, GenRequest))
        return (
            queued
            + sum(1 for it in self._waiting if isinstance(it, GenRequest))
            + sum(1 for s in self.slots if s.request is not None)
        )

    async def generate(
        self,
        prompt: str,
        max_tokens: int = 64,
        temperature: float = 0.0,
        request_id: str = "",
        session: str = "",
        deadline_at: float | None = None,
        ignore_eos: bool = False,
        top_k: int = 0,
        top_p: float = 1.0,
        emit=None,
    ) -> dict:
        """``deadline_at`` is a wall-clock instant (``time.time()``), honoured
        with ``deadlines`` on and ignored with it off. ``emit(start, ids)``
        receives the tokens as they reach the host (``GenRequest.emit``); a
        memoized replay returns its result without calling it. Raises
        ``EngineDraining`` while draining and ``EngineOverloaded`` past the
        shed watermark, before anything is queued."""
        if request_id:
            with self._lock:
                hit = self._completed.get(request_id)
            if hit is not None:
                return dict(hit, replayed=True)
        # failpoint: a submit-side fault surfaces like any submit error
        await faults.fire_async("engine.submit")
        if not self._running:
            raise EngineShutdown("engine shut down")
        if self._draining:
            raise EngineDraining("engine draining for shutdown")
        if self.deadlines and self.shed_watermark:
            depth = self.load_depth()
            if depth >= self.shed_watermark:
                self.shed_total += 1
                raise EngineOverloaded(depth, self.shed_watermark)
        loop = asyncio.get_running_loop()
        req = GenRequest(
            id=request_id or f"gen-{time.monotonic_ns()}",
            session=session,
            prompt_ids=self.tokenizer.encode(prompt),
            max_tokens=max(1, max_tokens),
            temperature=temperature,
            loop=loop,
            future=loop.create_future(),
            deadline_at=deadline_at if self.deadlines else None,
            ignore_eos=ignore_eos,
            top_k=max(0, int(top_k)),
            top_p=min(1.0, max(0.0, float(top_p))) if top_p is not None else 1.0,
            emit=emit,
        )
        self._submit(req)
        result = await req.future
        if request_id:
            with self._lock:
                self._completed[request_id] = result
                while len(self._completed) > 512:
                    self._completed.popitem(last=False)
        return result

    async def chat(
        self,
        session: str,
        message: str,
        max_tokens: int = 64,
        request_id: str = "",
        deadline_at: float | None = None,
        ignore_eos: bool = False,
        emit=None,
    ) -> dict:
        return await self.generate(
            prompt=message,
            max_tokens=max_tokens,
            temperature=0.0,
            request_id=request_id,
            session=session or "default",
            deadline_at=deadline_at,
            ignore_eos=ignore_eos,
            emit=emit,
        )

    def cancel(self, request_id: str) -> bool:
        """Abort a request by id: a queued or waiting one fails before
        prefill, an in-flight lane is parked on the worker's next iteration
        and its slot freed. False for an id already completed (its memoized
        result stands); True means the worker will act on it."""
        if not request_id:
            return False
        with self._lock:
            if request_id in self._completed:
                return False
            self._cancel_requested[request_id] = time.monotonic()
        return True

    def begin_drain(self) -> None:
        """Stop admitting (generate() raises EngineDraining); queued and
        in-flight work keeps running."""
        self._draining = True

    def drain(self, budget_s: float = 10.0) -> bool:
        """Block until every queued, waiting and in-flight request settles,
        up to ``budget_s``; True on a clean drain. Called off the worker
        thread; whatever is left is failed by the shutdown() after it."""
        self.begin_drain()

        def busy() -> bool:
            return bool(
                any(s.request is not None for s in self.slots)
                or self._waiting
                or not self._queue.empty()
                or self._readbacks
            )

        deadline = time.monotonic() + max(0.0, budget_s)
        while time.monotonic() < deadline:
            if not busy():
                return True
            time.sleep(0.05)
        return not busy()

    def has_session(self, session: str) -> bool:
        """Whether the engine holds ``session``'s KV: in a slot (dense), in
        pages (paged; ``sessions`` maps a resident session to -1) or parked
        in the host tier. The serve layer asks this, never ``sessions``
        itself, so a parked session is never taken for an unknown one."""
        if session in self.sessions:
            return True
        with self._tier_lock:
            return session in self._host_tier

    async def park_session(self, session: str) -> bytes | None:
        """Demote an idle session's KV off the device into the host tier
        and return its exact SNAP_VERSION 3 blob (packed from the staged
        bytes, before any quantization), for a store to keep. None: tiering
        off, the session unknown or busy, or the ``engine.kv_demote``
        failpoint fired; the session is then left as it was."""
        if not self.kv_tiering:
            return None
        loop = asyncio.get_running_loop()
        cmd = ParkCmd(session=session, loop=loop, future=loop.create_future())
        self._submit(cmd)
        staged = await cmd.future
        if staged is None:
            return None
        meta = {"session": session, "pending_token": staged.pending_token}
        if self.paged:
            meta["page_size"] = self.page_size
        return await asyncio.to_thread(
            pack_kv_snapshot, staged.k, staged.v, staged.position, meta
        )

    async def prewarm_session(self, session: str) -> bool:
        """Promote a host-tier session onto the device ahead of its next
        turn. True when the session is device-resident afterwards (also when
        it already was)."""
        if not self.kv_tiering:
            return False
        loop = asyncio.get_running_loop()
        cmd = PrewarmCmd(session=session, loop=loop, future=loop.create_future())
        self._submit(cmd)
        return bool(await cmd.future)

    async def snapshot_session(self, session: str) -> bytes | None:
        """Serialize a session's live KV prefix (the reference's blob,
        ``engine/checkpoint.py``). The worker stages the prefix into pinned
        host memory on the engine's stream between dispatches; the wait for
        that copy and the npz pack run in a thread, so neither the worker
        nor the event loop blocks on the transfer. A session mid-generation
        parks the command until its request finishes; the staging limiter
        may bounce it, and after five bounces this raises
        ``SnapshotDeferred``. None: no such session, or nothing to save."""
        loop = asyncio.get_running_loop()
        # failpoint: a snapshot fault surfaces to the caller, never into
        # the decode path
        await faults.fire_async("engine.snapshot")
        staged = None
        for _ in range(5):
            cmd = SnapshotCmd(session=session, loop=loop, future=loop.create_future())
            self._submit(cmd)
            staged = await cmd.future
            if staged != "rate-limited":
                break
            await asyncio.sleep(self.snapshot_min_gap_s)
        if staged == "rate-limited":
            raise SnapshotDeferred(session)
        if staged is None:
            return None
        meta = {"session": session, "pending_token": staged.pending_token}
        if self.paged:
            # staged from the live pages only; the payload is the dense
            # staging's, so blobs restore across both arenas
            meta["page_size"] = self.page_size
        return await asyncio.to_thread(self._pack_staged, staged, meta)

    def _pack_staged(self, staged: StagedKV, meta: dict) -> bytes:
        """The thread half of a snapshot: wait for the staging copy, then
        pack the npz blob."""
        staged.event.synchronize()
        landed = time.monotonic()
        k, position = staged.k, staged.position
        blob = pack_kv_snapshot(k, staged.v, position, meta)
        self.snapshot_timings.append({
            "position": position,
            "alloc_ms": staged.alloc_ms,
            "stage_ms": 1000 * (landed - staged.staged_at),
            "pack_ms": 1000 * (time.monotonic() - landed),
            "raw_bytes": 2 * k[:, :position].numel() * k.element_size(),
            "blob_bytes": len(blob),
        })
        return blob

    async def profile(self, duration_s: float):
        """Record a ``torch.profiler`` trace of the engine's work for
        ``duration_s`` seconds (the card's kernels and the CPU's operators;
        the CPU's only on the CPU); returns the stopped profiler (export it
        with ``export_chrome_trace``). The worker starts and stops it
        between dispatches (``ProfileCmd``); one capture at a time."""
        loop = asyncio.get_running_loop()
        cmd = ProfileCmd(duration_s=float(duration_s), loop=loop, future=loop.create_future())
        self._submit(cmd)
        return await cmd.future

    async def restore_session(self, session: str, blob: bytes) -> bool:
        """Load a snapshot blob into the arena for ``session``, through the
        worker. False when it does not fit (at or past ``max_seq - 1``, a
        model of other shapes, no free pages) or the session is busy;
        raises ``ValueError`` for a malformed blob."""
        dtype = self._kv_dtype
        pin = self.device.type == "cuda"

        def host_copy():
            # decompress, cast to the arena's dtype and pin, off the loop
            k, v, header = deserialize_kv_slot(blob)
            k, v = k.to(dtype), v.to(dtype)
            if pin:
                k, v = k.pin_memory(), v.pin_memory()
            return k, v, header

        k, v, header = await asyncio.to_thread(host_copy)
        loop = asyncio.get_running_loop()
        cmd = RestoreCmd(
            session=session,
            k=k,
            v=v,
            position=int(header["position"]),
            pending_token=header.get("pending_token"),
            loop=loop,
            future=loop.create_future(),
        )
        self._submit(cmd)
        return await cmd.future

    def clear_sessions(self, prefix: str = "") -> None:
        """Drop idle sessions (all, or those whose name starts with
        ``prefix``), host-tier entries included."""
        with self._tier_lock:
            for name in [s for s in self._host_tier if s.startswith(prefix)]:
                self._tier_drop_locked(name)
        if self.paged:
            with self._page_lock:
                for name in [s for s in self.paged_sessions if s.startswith(prefix)]:
                    sess = self.paged_sessions[name]
                    if sess.lane is not None:
                        continue  # request in flight; same skip as dense
                    self._flush_parked_snapshot(name)
                    self._free_session_pages(sess)
                    self.paged_sessions.pop(name, None)
                    self.sessions.pop(name, None)
            return
        with self._lock:
            for name in [s for s in self.sessions if s.startswith(prefix)]:
                idx = self.sessions.pop(name)
                self._flush_parked_snapshot(name)
                slot = self.slots[idx]
                if slot.request is None:
                    slot.session = ""
                    slot.position = 0

    def metrics(self) -> dict:
        elapsed = max(1e-6, time.monotonic() - self._started_at)
        ttft = sorted(self.ttft_ms_recent)
        itl = sorted(self.itl_ms_recent)
        adm = sorted(self.admission_ms_recent)
        return {
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": round(self.tokens_generated / elapsed, 2),
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "batch_occupancy": round(self._occupancy_sum / max(1, self.decode_steps), 3),
            "ttft_ms_p50": round(ttft[len(ttft) // 2], 2) if ttft else None,
            "itl_ms_p50": round(itl[len(itl) // 2], 2) if itl else None,
            "admission_ms_p50": round(adm[len(adm) // 2], 2) if adm else None,
            "decode_chunk": self.decode_chunk,
            "adaptive_decode": self.adaptive_decode,
            "decode_chunk_hist": {
                str(k): v for k, v in sorted(self.decode_chunk_hist.copy().items())
            },
            "decode_chunks_shrunk": self.decode_chunks_shrunk,
            "prefill_chunks": self.prefill_chunks,
            # the dispatch-ahead pipeline and the step graphs (the card)
            "host_syncs_total": self.host_syncs_total,
            "host_syncs_per_token": (
                round(self.host_syncs_total / self.tokens_generated, 4)
                if self.tokens_generated
                else None
            ),
            "graphs_captured": len(self._graphs) if self._graphs is not None else 0,
            "graph_replays": self._graphs.replays if self._graphs is not None else 0,
            "graph_capture_s": self._graphs.capture_s if self._graphs is not None else None,
            "graph_pool_bytes": self._graphs.pool_bytes if self._graphs is not None else None,
            # the prefill graphs' share of the two above
            "prefill_graph_replays": (
                self._graphs.replays_by_kind["prefill"] if self._graphs is not None else 0
            ),
            "prefill_graph_capture_s": (
                self._graphs.capture_s_by_kind.get("prefill") if self._graphs is not None else None
            ),
            "streaming": self.streaming,
            "approx_topk": self.approx_topk,
            # the fused decode loop (the reference's keys): loops dispatched,
            # iterations run, early exits and their reasons, staged lanes
            # absorbed and fallbacks, and the in-loop drafter's counts, read
            # back in the loop's one packed transfer
            "fused_decode": self.fused_decode,
            "fused_loops_total": self.fused_loops_total,
            "fused_steps_total": self.fused_steps_total,
            "fused_verify_steps_total": self.fused_verify_steps_total,
            "fused_early_exits_total": self.fused_early_exits_total,
            "fused_exit_reason_hist": dict(sorted(self.fused_exit_reason_hist.copy().items())),
            "fused_injections_total": self.fused_injections_total,
            "fused_inject_fallbacks_total": self.fused_inject_fallbacks_total,
            "inloop_spec_drafted": self.inloop_spec_drafted,
            "inloop_spec_accepted": self.inloop_spec_accepted,
            "inloop_spec_acceptance_rate": (
                round(self.inloop_spec_accepted / self.inloop_spec_drafted, 4)
                if self.inloop_spec_drafted
                else None
            ),
            # self-speculative decoding (the reference's keys)
            "speculative": self.speculative,
            "inloop_spec": self.inloop_spec,
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_rejected,
            "spec_acceptance_rate": (
                round(self.spec_accepted / self.spec_drafted, 4) if self.spec_drafted else None
            ),
            "spec_verify_hist": {
                str(k): v for k, v in sorted(self.spec_verify_hist.copy().items())
            },
            "spec_slot_acceptance": [round(s.spec_ema, 3) for s in self.slots],
            # request lifecycle policy
            "deadlines": self.deadlines,
            "cancelled_total": self.cancelled_total,
            "expired_total": self.expired_total,
            "shed_total": self.shed_total,
            "shed_watermark": self.shed_watermark or None,
            "draining": self._draining,
            # KV snapshots staged and restores written
            "kv_snapshots_total": self.kv_snapshots_total,
            "kv_restores_total": self.kv_restores_total,
            # prefix cache
            "prefix_cache": self.prefix_cache,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "prefix_arena_entries": len(self._prefix_entries),
            "prefix_arena_bytes": self._prefix_bytes,
            "prefix_arena_capacity_bytes": self._prefix_budget,
            "prefix_evictions_total": self.prefix_evictions,
            "session_eviction_idle_s_p50": _p50(self.session_eviction_idle_s_recent),
            "prefix_eviction_idle_s_p50": _p50(self.prefix_eviction_idle_s_recent),
            **self._paged_metrics(),
            **self._tier_metrics(),
            "worker_errors": self.worker_errors,
            "last_worker_error": self.last_worker_error or None,
            "queue_depth": self._queue.qsize(),
            "waiting_depth": len(self._waiting),
            "active_requests": sum(1 for s in self.slots if s.request is not None),
            "active_sessions": len(self.sessions),
            "session_evictions_total": self.session_evictions,
            "ttft_samples": [round(x, 2) for x in self.ttft_ms_recent],
            "itl_samples": [round(x, 2) for x in self.itl_ms_recent],
            "max_batch": self.max_batch,
            "max_seq": self.max_seq,
            "device": str(self.device),
            # launches of the hand-written kernels in this process
            "kernel_launches": {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS},
            "flops_done": self.flops_done,
            "mfu_lifetime": round(self.flops_done / elapsed / self._peak_flops, 5),
            "hbm_bytes_read": self.hbm_bytes_read,
            "mbu_lifetime": round(self.hbm_bytes_read / elapsed / self._peak_hbm_bps, 5),
            "hbm_gbps_peak": round(self._peak_hbm_bps / 1e9, 1),
            "peak_tflops": round(self._peak_flops / 1e12, 1),
            "chip_kind": self._chip.kind,
            "n_chips": len(self.mesh.distinct_devices) if self.mesh is not None else 1,
            "tp": self.tp,
            "ep": self.ep,
            "sp": self.sp,
            "pp": self.pp,
            "param_hbm_bytes": self.param_hbm_bytes,
            "moe_routed": self.routed_moe,
            # decode-shaped routed calls (t == 1) run dropless whatever
            # max_batch is (models/llama._moe_mlp_routed); only prefill can
            # drop, bounded by the capacity factor
            "moe_decode_dropless": self.routed_moe or None,
            "moe_capacity_factor": self.moe_capacity_factor if self.routed_moe else None,
            "kv_arena_bytes": self.kv_arena_bytes,
            "checkpoint_bytes_read": self.checkpoint_load.get("bytes_read"),
            "checkpoint_load_s": self.checkpoint_load.get("seconds"),
        }

    def _paged_metrics(self) -> dict:
        """The reference's paged gauges, under its key names."""
        if not self.paged:
            return {"paged_kv": False}
        with self._page_lock:
            free = len(self._page_free)
            per_sess = sorted(len(s.pages) for s in self.paged_sessions.values())
            live_tokens = sum(s.position for s in self.paged_sessions.values())
            pinned = len(self._prefix_pinned_page_ids())
            quarantined = sum(len(ids) for _, ids in self._page_quarantine)
        allocated = sum(per_sess)
        # internal fragmentation: allocated page capacity that the resident
        # sessions' live tokens do not fill
        frag = (
            round(100.0 * (1.0 - live_tokens / (allocated * self.page_size)), 2)
            if allocated
            else 0.0
        )
        return {
            "paged_kv": True,
            "page_size": self.page_size,
            "kv_pages_total": self._data_pages,
            "kv_pages_free": free,
            "kv_pages_used": self._data_pages - free,
            # only a demotion's pages wait in quarantine, until its staging
            # copy has landed; other frees go straight back to the free list
            # (stream order protects them, _free_page_ids)
            "kv_pages_quarantined": quarantined,
            "kv_pages_prefix_pinned": pinned,
            "resident_sessions": len(self.paged_sessions),
            "session_pages_p50": per_sess[len(per_sess) // 2] if per_sess else None,
            "session_pages_max": per_sess[-1] if per_sess else None,
            "kv_fragmentation_pct": frag,
            "page_exhausted_total": self.page_exhausted_total,
            "pages_truncated_total": self.pages_truncated,
            "prefix_pages_shared_total": self.prefix_pages_shared,
        }

    def shutdown(self) -> None:
        self._running = False
        self._queue.put(None)
        self._worker.join(timeout=30)
        # items enqueued after the worker's own exit drain must fail too
        self._fail_pending(EngineShutdown("engine shut down"))
        for session in list(self._snap_parked):
            self._flush_parked_snapshot(session)

    # -- worker thread ----------------------------------------------------
    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad(), self._on_stream():
                self._serve()
        except Exception as e:  # recorded and reported: /metrics last_worker_error
            self._note_error(e)
        finally:
            self._profile_tick(stop=True)
            # nothing may hang on a dead worker: fail queued, waiting and
            # in-flight work whether the loop ended or crashed
            self._running = False
            self._fail_pending(EngineShutdown("engine worker exited"))

    def _serve(self) -> None:
        """The worker loop body (runs under no_grad on the engine's stream).

        Pipelined as the reference's: the device carry chains decode chunks
        with no host round trip between them, each chunk's tokens are copied
        to the host asynchronously at dispatch and processed one pipeline
        slot later, so the copy and the host's bookkeeping ride under the
        next chunk's compute."""
        while self._running and not self._sentinel:
            self._profile_tick()
            busy = any(s.request is not None for s in self.slots) or bool(self._readbacks)
            self._pump_queue(0.0 if (busy or self._waiting) else 0.2)
            if self._sentinel:
                break
            self._admit_waiting()
            # cancelled or expired in-flight lanes go before any more device
            # work is dispatched for them; their slots admit next iteration
            self._reap_aborted()
            # ONE prefill chunk, then a decode chunk; when nothing is
            # decoding, prefill ticks back to back instead. Prefill faults
            # fail the culprit request only.
            try:
                self._prefill_tick()
                while self.adaptive_decode and not any(
                    s.decoding for s in self.slots
                ) and any(s.request is not None and s.pending_prompt for s in self.slots):
                    self._pump_queue(0.0)
                    if self._sentinel:
                        break
                    self._admit_waiting()
                    self._prefill_tick()
            except Exception as e:
                self._note_error(e)
                slot = self._prefilling_slot
                if slot is not None and slot.request is not None:
                    self._fail_item(slot.request, _as_prefill_failure(e))
                    self._reset_slot(slot)
            finally:
                self._prefilling_slot = None
            try:
                if any(s.decoding for s in self.slots):
                    # a verify round when lanes have drafts; otherwise (or
                    # under contention) the plain decode ladder or a fused
                    # loop. With in-loop spec the loop drafts and verifies
                    # itself, and host-side speculation is bypassed
                    if self.inloop_spec or not self._try_speculate():
                        if self.fused_decode:
                            self._fused_dispatch()
                        else:
                            self._decode_dispatch()
                else:
                    self._last_decode_end = None  # an idle gap isn't ITL
                # process landed readbacks; block on the oldest when the
                # pipeline is full (the backpressure bounding how far
                # dispatch runs ahead of the device) or when nothing else is
                # worth dispatching
                self._drain_readbacks(
                    block=len(self._readbacks) > self._PIPELINE_DEPTH
                    or not self._has_dispatchable()
                )
            except Exception as e:
                # a decode fault is batch-wide (one call covers every lane)
                self._note_error(e)
                for slot in self.slots:
                    if slot.request is not None:
                        self._fail_item(slot.request, e)
                        self._reset_slot(slot)
                self._readbacks.clear()
            if not any(s.request is not None for s in self.slots) and self._waiting:
                time.sleep(0.002)  # all slots busy-by-session; brief backoff

    def _has_dispatchable(self) -> bool:
        """Device work left to dispatch: a pending prompt chunk, or a
        decoding lane whose token budget is not all in flight yet."""
        for s in self.slots:
            if s.request is None:
                continue
            if s.pending_prompt:
                return True
            if s.decoding and s.request.dispatched < s.request.max_tokens:
                return True
        return False

    def _pump_queue(self, block_s: float) -> None:
        """Drain the submit queue into the waiting list (a burst admits
        together). The shutdown sentinel sets ``_sentinel``."""
        try:
            item = self._queue.get(timeout=block_s) if block_s > 0 else self._queue.get_nowait()
            while True:
                if item is None:
                    self._sentinel = True
                    return
                self._waiting.append(item)
                item = self._queue.get_nowait()
        except queue.Empty:
            pass

    def _admit_waiting(self) -> None:
        still = []
        for item in self._waiting:
            try:
                if isinstance(item, RestoreCmd):
                    self._do_restore(item)
                elif isinstance(item, SnapshotCmd):
                    self._do_snapshot(item)
                elif isinstance(item, ProfileCmd):
                    self._start_profile(item)
                elif isinstance(item, ParkCmd):
                    staged = self._tier_demote(item.session) if self.kv_tiering else None
                    item.loop.call_soon_threadsafe(_resolve, item.future, staged)
                elif isinstance(item, PrewarmCmd):
                    ok = self._tier_promote(item.session, prewarm=True) if self.kv_tiering else False
                    item.loop.call_soon_threadsafe(_resolve, item.future, ok)
                elif self._pre_reject(item):
                    pass  # cancelled or expired before prefill: already failed
                elif self._tier_needs_promote(item) and not self._tier_promote(item.session):
                    # a parked session whose swap-in failed: typed 429, and
                    # the entry stays parked for the retry
                    raise TierPromoteFailed(item.session)
                elif not self._try_admit(item):
                    still.append(item)
            except EngineOverloaded as e:
                # pool backpressure at admission (the prefix tail copy's
                # page): a 429, not a worker fault
                self._fail_item(item, e)
            except Exception as e:  # a poisoned request must not kill the worker
                self._note_error(e)
                self._fail_item(item, e)
        self._waiting = still

    def _start_profile(self, cmd: ProfileCmd) -> None:
        """Start the profiler on the worker thread (between dispatches)."""
        if self._profile is not None:
            self._fail_item(cmd, RuntimeError("profile already running"))
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self._profile = (prof, time.monotonic() + cmd.duration_s, cmd)

    def _profile_tick(self, stop: bool = False) -> None:
        """Stop a profile whose time is up (or any, with ``stop``) and hand
        the profiler to its caller."""
        if self._profile is None:
            return
        prof, until, cmd = self._profile
        if not stop and time.monotonic() < until:
            return
        self._profile = None
        try:
            prof.stop()
        except Exception as e:
            self._fail_item(cmd, e)
            return
        cmd.loop.call_soon_threadsafe(_resolve, cmd.future, prof)

    def _take_cancel(self, request_id: str) -> bool:
        with self._lock:
            return self._cancel_requested.pop(request_id, None) is not None

    def _purge_stale_cancels(self) -> None:
        """Drop cancel markers whose request never showed up (TTL)."""
        if not self._cancel_requested:
            return
        cutoff = time.monotonic() - self._cancel_ttl_s
        with self._lock:
            for rid in [r for r, t in self._cancel_requested.items() if t < cutoff]:
                del self._cancel_requested[rid]

    def _pre_reject(self, req: GenRequest) -> bool:
        """Fail a not-yet-admitted request whose caller is gone (cancelled,
        or past its deadline): it costs no device work."""
        if self._take_cancel(req.id):
            self.cancelled_total += 1
            self._fail_item(req, RequestCancelled(f"request {req.id} cancelled"))
            return True
        if self.deadlines and req.deadline_at is not None and time.time() > req.deadline_at:
            self.expired_total += 1
            self._fail_item(
                req, RequestExpired(f"request {req.id} deadline exceeded before prefill")
            )
            return True
        return False

    def _reap_aborted(self) -> None:
        """Per-iteration sweep of in-flight lanes: a cancelled request, or
        one whose deadline passed mid-generation, is failed, its lane parked
        and its slot freed (its session's KV holds a partial reply no
        history will contain, so the session is dropped)."""
        self._purge_stale_cancels()
        if not self._cancel_requested and not (
            self.deadlines
            and any(s.request is not None and s.request.deadline_at is not None for s in self.slots)
        ):
            return
        now = time.time()
        for slot in self.slots:
            req = slot.request
            if req is None:
                continue
            if self._take_cancel(req.id):
                self.cancelled_total += 1
                err: Exception = RequestCancelled(f"request {req.id} cancelled mid-flight")
            elif self.deadlines and req.deadline_at is not None and now > req.deadline_at:
                self.expired_total += 1
                err = RequestExpired(f"request {req.id} deadline exceeded mid-flight")
            else:
                continue
            self._reset_slot(slot)
            self._fail_item(req, err)

    def _submit(self, req: GenRequest) -> None:
        """Queue ``req`` for the worker. The worker clears ``_running`` before
        its final drain, so work queued after that drain is failed here
        instead of waiting forever on a dead worker."""
        self._queue.put(req)
        if not self._running:
            self._fail_queued(EngineShutdown("engine worker exited"))

    def _fail_pending(self, error: Exception) -> None:
        for item in self._waiting:
            self._fail_item(item, error)
        self._waiting = []
        self._fail_queued(error)
        for slot in self.slots:
            if slot.request is not None:
                self._fail_item(slot.request, error)
                slot.request = None
                slot.pending_prompt = []
                slot.decoding = False

    def _fail_queued(self, error: Exception) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail_item(item, error)

    def _note_error(self, e: Exception) -> None:
        self.worker_errors += 1
        self.last_worker_error = f"{type(e).__name__}: {e}"
        print(f"[llm-engine] worker error: {self.last_worker_error}", flush=True)

    def _fail_item(self, item, error: Exception) -> None:
        try:
            item.loop.call_soon_threadsafe(_reject, item.future, error)
        except RuntimeError:
            pass  # caller's loop already closed; nobody left to notify

    def _reset_slot(self, slot: Slot, rollback: bool = False) -> None:
        """Return a slot to cold idle after its request failed or was
        aborted (the reference's ``_reset_slot`` and ``_abandon_slot`` in
        one): park its lane; its KV prefix is no longer trusted. With
        ``rollback`` (a policy failure: pool exhaustion, raised before any
        dispatch) the paged session's pre-request KV is trusted and kept
        instead."""
        if self.paged:
            if rollback:
                self._rollback_lane_session(slot)
            else:
                self._drop_lane_session(slot)
        if slot.decoding:
            slot.dev_position = self.scratch_pos
            self._park_lane(slot.idx)
        if self._staged_lane == slot.idx:
            # a staged lane not absorbed yet must not arm into the next loop
            self._staged_lane = None
        slot.request = None
        slot.pending_prompt = []
        slot.decoding = False
        slot.position = 0
        slot.pending_token = None
        slot.prefix_ctx = None
        slot.spec_hist = []
        slot.spec_ema = 1.0
        slot.spec_miss = 0
        if slot.session:
            if self.sessions.get(slot.session) == slot.idx:
                self.sessions.pop(slot.session, None)
                self._flush_parked_snapshot(slot.session)
            slot.session = ""

    def _inject_lane(
        self, idx: int, first, position: int, temp: float, top_k: int, top_p: float,
        hist_row: np.ndarray | None = None, hist_n: int = 0, staged: bool = False,
    ) -> None:
        """Point lane ``idx`` of the decode carry (the shadow carry with
        ``staged``) at (token ``first`` — a device scalar or int —,
        ``position``) with its sampling parameters; in place (the
        reference's jitted donated scatter). Python numbers go in by
        ``fill_`` (a kernel argument): ``t[idx] = number`` on a CUDA tensor
        is a synchronous host-to-device copy, which would wait for the chunk
        in flight. With in-loop spec, ``hist_row`` (the prompt tail,
        right-aligned, [FUSED_HIST_W]) seeds the drafter's history shifted
        left one slot, ``first`` lands in the newest slot and the valid
        length is ``hist_n``; None empties it."""
        tok, pos, temps, topk, topp, hist, hlen = (
            (self._stok, self._spos, self._stemps, self._stopk, self._stopp, self._shist, self._shlen)
            if staged
            else (self._dtok, self._dpos, self._dtemps, self._dtopk, self._dtopp, self._dhist, self._dhlen)
        )
        lane = slice(idx, idx + 1)
        if isinstance(first, torch.Tensor):
            tok[lane].copy_(first.reshape(1))
        else:
            tok[lane].fill_(first)
        pos[lane].fill_(position)
        temps[lane].fill_(temp)
        topk[lane].fill_(top_k)
        topp[lane].fill_(top_p)
        self._lane_temps[idx] = temp
        if self.inloop_spec:
            if hist_row is None:
                hist[idx].fill_(0)
            else:
                self._xfer.upload(hist[idx, :-1], hist_row[1:])
            hist[idx, -1:].copy_(tok[lane])
            hlen[lane].fill_(hist_n)

    def _park_lane(self, idx: int) -> None:
        """Idle/finished lanes decode at the scratch position with neutral
        sampling state."""
        self._inject_lane(idx, 0, self.scratch_pos, 0.0, 0, 1.0)
        if self._staged_lane == idx:
            # a staged lane parked before a loop absorbed it must not arm
            self._staged_lane = None

    def _admit_prologue(
        self, position: int, pending_token: int | None, req: GenRequest
    ) -> tuple[list[int], bool]:
        """Splice the held-out pending token into the prompt, reset the
        context when the continuation does not fit the budget (dropping the
        pending token with the discarded context), and trim an over-long
        prompt to its tail. Returns (prompt, reset)."""
        prompt = list(req.prompt_ids)
        pend = pending_token
        if pend is not None:
            prompt = [pend] + prompt
        budget = self.max_seq - 1 - req.max_tokens
        reset = position + len(prompt) > budget
        if reset and pend is not None:
            prompt = prompt[1:]
        if len(prompt) > budget:
            prompt = prompt[-budget:]  # keep the tail
        return prompt, reset

    def _try_admit(self, req: GenRequest) -> bool:
        if self.paged:
            return self._try_admit_paged(req)
        slot = self._find_slot(req.session)
        if slot is None:
            return False
        prompt, reset = self._admit_prologue(slot.position, slot.pending_token, req)
        slot.pending_token = None
        if reset:
            slot.position = 0
        fresh = slot.position == 0
        # the drafting corpus mirrors the slot's fed stream: a fresh context
        # replaces it, a continuing turn appends (the pending token rides in
        # with the prompt)
        if fresh:
            slot.spec_hist = list(prompt)
        else:
            slot.spec_hist.extend(prompt)
            del slot.spec_hist[: -self.max_seq]
        forked = 0
        if self._prefix_active and fresh:
            # fork the longest cached prefix into the row instead of
            # prefilling it again; register the rest at the final chunk
            hit = self._prefix_lookup(prompt)
            if hit is not None:
                key, entry = hit
                forked = key[0]
                self.cache.fork_prefix(slot.idx, entry.kv)
                slot.position = forked
                self._record_prefix_hit(key, entry)
                # the fork streams the entry's KV once (a copy, no FLOPs)
                self.hbm_bytes_read += forked * self._kv_bytes_per_pos
            slot.prefix_ctx = list(prompt)
        else:
            slot.prefix_ctx = None
        slot.request = req
        slot.pending_prompt = prompt[forked:]
        slot.last_used = time.monotonic()
        return True

    def _try_admit_paged(self, req: GenRequest) -> bool:
        """Paged admission: bind the session (resident or new) to ANY free
        lane — lanes carry no KV, the pages do. Runs under _page_lock: an
        API-thread clear_sessions checks ``lane is None`` and frees pages,
        so it must never interleave with a bind."""
        with self._page_lock:
            name = req.session
            sess = self.paged_sessions.get(name) if name else None
            if sess is not None and sess.lane is not None:
                return False  # session busy: one request per session at a time
            lane = next((s for s in self.slots if s.request is None), None)
            if lane is None:
                return False
            fresh_session = sess is None
            if fresh_session:
                sess = PagedSession(name=name)
            pend = sess.pending_token
            prompt, reset = self._admit_prologue(sess.position, pend, req)
            sess.pending_token = None
            if reset:
                # continuation didn't fit: reset the session's KV, pages too
                self._free_session_pages(sess)
                sess.position = 0
            # pre-request state for a pool-exhaustion rollback (the prefix
            # map and speculative accepts advance position mid-request, and
            # spec_hist is extended in place); after a context reset there
            # is none worth keeping
            sess.admit_pending = pend if sess.position > 0 else None
            sess.admit_position = sess.position
            sess.admit_spec_hist = list(sess.spec_hist) if sess.position > 0 else []
            fresh = sess.position == 0
            if fresh:
                sess.spec_hist = list(prompt)
            else:
                sess.spec_hist.extend(prompt)
                del sess.spec_hist[: -self.max_seq]
            forked = 0
            try:
                if self._prefix_active and fresh:
                    hit = self._prefix_lookup(prompt)
                    if hit is not None:
                        forked = self._map_prefix_pages(sess, *hit)
                    lane.prefix_ctx = list(prompt)
                else:
                    lane.prefix_ctx = None
            except Exception:
                # a half-built mapping must not stay resident: free what was
                # mapped, then let _admit_waiting fail the request
                self._free_session_pages(sess)
                if not fresh_session and name:
                    self.paged_sessions.pop(name, None)
                    self.sessions.pop(name, None)
                raise
            if fresh_session and name:
                self.paged_sessions[name] = sess
            sess.lane = lane.idx
            sess.last_used = time.monotonic()
            if name:
                self.sessions[name] = lane.idx
            lane.psess = sess
            lane.session = name
            lane.position = sess.position
            lane.pending_token = None
            # the lane mirrors the session's speculation state (the corpus
            # is the same list object, extended in place)
            lane.spec_hist = sess.spec_hist
            lane.spec_ema = sess.spec_ema
            lane.spec_miss = sess.spec_miss
            lane.request = req
            lane.pending_prompt = prompt[forked:]
            lane.last_used = time.monotonic()
            self._bind_lane_bt(lane, sess)
            return True

    def _map_prefix_pages(self, sess: PagedSession, key: tuple, entry: PrefixEntry) -> int:
        """Zero-copy prefix fork: the session maps the entry's full pages
        read-only (one refcount each, no device traffic); only a partial
        tail page is copied, because the session writes the rest of that
        page. Returns the forked token count."""
        b = key[0]
        # take this session's references FIRST: the tail copy's allocation
        # may reclaim, and reclaim may evict THIS entry; with the refs held,
        # an eviction drops only the arena's pin
        pages = list(entry.pages)
        tail_src = entry.tail_page
        with self._page_lock:
            for pid in pages:
                self._page_refs[pid] += 1
            if tail_src is not None:
                self._page_refs[tail_src] += 1
        tail_copy = None
        try:
            if tail_src is not None:
                tail_copy = self._alloc_pages(1)[0]
                self._copy_page(tail_src, tail_copy)
        except BaseException:
            with self._page_lock:
                for pid in pages:
                    self._decref_page(pid)
                if tail_copy is not None:
                    self._decref_page(tail_copy)
            raise
        finally:
            if tail_src is not None:
                self._decref_page(tail_src)
        sess.pages = pages
        sess.shared = len(pages)
        if tail_copy is not None:
            sess.pages.append(tail_copy)
        sess.position = b
        self._record_prefix_hit(key, entry)
        self.prefix_pages_shared += len(pages)
        if tail_copy is not None:  # only the tail copy moves bytes
            self.hbm_bytes_read += self.page_size * self._kv_bytes_per_pos
        return b

    def _find_slot(self, session: str) -> Slot | None:
        with self._lock:
            if session and session in self.sessions:
                slot = self.slots[self.sessions[session]]
                if slot.request is None:
                    return slot
                return None  # session busy: one request per session at a time
            # fresh slot: prefer never-used, else the LRU idle session
            idle = [s for s in self.slots if s.request is None]
            if not idle:
                return None
            fresh = [s for s in idle if not s.session]
            slot = fresh[0] if fresh else min(idle, key=lambda s: s.last_used)
            if slot.session and self.sessions.get(slot.session) == slot.idx:
                self.sessions.pop(slot.session, None)  # evict the LRU session's KV
                self._count_eviction("session", time.monotonic() - slot.last_used)
                self._flush_parked_snapshot(slot.session)
            slot.session = session
            slot.position = 0
            slot.pending_token = None
            slot.pending_prompt = []
            slot.spec_hist = []
            slot.spec_ema = 1.0  # new occupant: optimistic until measured
            slot.spec_miss = 0
            if session:
                self.sessions[session] = slot.idx
            return slot

    def _bucket(self, n: int) -> int:
        for b in PREFILL_BUCKETS:
            if n <= b:
                return b
        return PREFILL_BUCKETS[-1]

    def _prefill_tick(self) -> None:
        """Feed ONE chunk of one pending prompt through the model. Non-final
        chunks only populate the slot's KV; the final chunk samples the first
        token and points the slot's decode lane at the continuation."""
        slots = [s for s in self.slots if s.request is not None and s.pending_prompt]
        if not slots:
            return
        # admission-first: a prompt that has not started prefilling beats an
        # in-progress prompt's next chunk; ties stay FIFO
        slot = min(
            slots,
            key=lambda s: (s.request.prefill_started_at is not None, s.request.submitted_at),
        )
        self._prefilling_slot = slot
        req = slot.request
        # failpoint: a poisoned prefill fails THIS request only; warmup's
        # requests (no id) are exempt
        if req.id:
            faults.fire("engine.prefill")
        if req.prefill_started_at is None:
            req.prefill_started_at = time.monotonic()
            self.admission_ms_recent.append(1000 * (req.prefill_started_at - req.submitted_at))
            # a tier promotion's start to this first chunk: restore time
            # hidden behind the request's queue wait
            t0 = self._tier_promote_started.pop(req.session, None) if req.session else None
            if t0 is not None:
                hidden = 1000 * (req.prefill_started_at - t0)
                self.tier_promote_overlap_ms_total += hidden
                self.tier_promote_overlap_ms_recent.append(hidden)
        chunk = slot.pending_prompt[: self.prefill_chunk]
        slot.pending_prompt = slot.pending_prompt[self.prefill_chunk :]
        final = not slot.pending_prompt
        n = len(chunk)
        bucket = self._bucket(n)
        padded = chunk + [0] * (bucket - n)
        # padding positions continue past the real tokens and may run past
        # the arena end (dropped by KVCache.write, clamped to the scratch
        # slot by scatter_paged_kv); every in-arena padding slot is rewritten
        # by a real token before any query can attend to it
        if self.paged:
            # pages cover the REAL tokens only; padding writes past them land
            # in the lane's scratch page through the table's default
            try:
                self._ensure_lane_pages(slot, slot.position + n - 1)
            except EngineOverloaded as e:
                # backpressure, not a fault: fail THIS request with the typed
                # 429 and roll its session back (the worker loop's prefill
                # handler would count a worker error and drop the session).
                # Roll back before resolving, so the caller that sees the
                # 429 finds its session as it was
                self._reset_slot(slot, rollback=True)
                self._fail_item(req, e)
                return
        last_logits = self._prefill(slot.idx, padded, slot.position, n)
        self.flops_done += n * self.cfg.flops_per_token(slot.position + n // 2)
        self.hbm_bytes_read += self.param_hbm_bytes + (
            (slot.position + n // 2) * self._kv_bytes_per_pos
        )
        slot.position += n
        slot.last_used = time.monotonic()
        if not final:
            return
        # the whole fresh context is in KV: register its bucket prefixes
        # (positions [0, b) hold exactly ctx[:b]; padding lands above)
        self._prefix_register(slot)
        dev = self.device
        first = sample_step(
            last_logits[None],
            self._gen,
            torch.full((1,), req.temperature, dtype=torch.float32, device=dev),
            torch.full((1,), req.top_k, dtype=torch.long, device=dev),
            torch.full((1,), req.top_p, dtype=torch.float32, device=dev),
            all_greedy=req.temperature <= 0.0,
            approx_topk=self.approx_topk,
        )
        hist_row, hist_n = None, 0
        if self.inloop_spec:
            # seed the in-loop drafter with the prompt tail, right-aligned
            ctx = req.prompt_ids[-(FUSED_HIST_W - 1) :]
            hist_row = np.zeros((FUSED_HIST_W,), dtype=np.int64)
            if ctx:
                hist_row[FUSED_HIST_W - len(ctx) :] = ctx
            hist_n = min(len(ctx) + 1, FUSED_HIST_W)
        # the lane continues from the sampled token WITHOUT waiting for it to
        # reach the host; the value lands through the readback FIFO. With a
        # fused loop in flight and the staging slot free, the lane goes into
        # the shadow carry, which the next loop absorbs at entry (host-side
        # speculation reads the live carry, so only with in-loop spec or
        # none)
        loop_in_flight = self._fused_inject and any(e.kind == "fused" for e in self._readbacks)
        stage = (
            loop_in_flight
            and self._staged_lane is None
            and (self.inloop_spec or not self._spec_active)
        )
        if loop_in_flight and not stage:
            self.fused_inject_fallbacks_total += 1
        self._inject_lane(
            slot.idx, first[0], slot.position, req.temperature, req.top_k, req.top_p,
            hist_row, hist_n, staged=stage,
        )
        if stage:
            self._staged_lane = slot.idx
        slot.dev_position = slot.position
        slot.decoding = True
        req.prefill_done_at = time.monotonic()
        req.dispatched = 1  # the prefill-sampled first token
        self.prefills += 1
        host, event = self._xfer.download(first)
        self._push_readback(Readback("first", host, event, slot=slot, req=req))

    def _prefill(self, slot_idx: int, padded: list[int], start: int, n_real: int) -> torch.Tensor:
        """Dispatch one bucket-padded prompt chunk at positions
        ``start...``: its bucket's graph replay on the card, the step
        function on the CPU (the reference's jitted prefill, one compile per
        bucket). The chunk, its start, its last real index and the slot's
        arena row go into the static prefill inputs in one upload; paged,
        the lane's block-table row is copied into ``_pbt`` on the device.
        Returns the last real token's logits [V]."""
        bucket = len(padded)
        meta = np.empty((3 + bucket,), dtype=np.int64)
        meta[:3] = (start, n_real - 1, slot_idx)
        meta[3:] = padded
        self._xfer.upload(self._pinput[: 3 + bucket], meta)
        if self.paged:
            self._sync_table()
            self._pbt.copy_(self._dbt[slot_idx : slot_idx + 1])
        logits = self._run_step(("prefill", bucket, True))
        self.prefill_chunks += 1
        return logits

    def _prefill_step(self, bucket: int) -> torch.Tensor:
        """The prefill step function of one bucket, over the static prefill
        inputs: the chunk's tokens at positions ``start + arange(bucket)``
        through the model, K/V written IN PLACE into the arena row the
        inputs name (the kernel and the KV write read the row from device
        memory) or into the pool through ``_pbt``. Only the last real
        token's hidden state goes through ``lm_head``. Returns its logits
        [V] (the reference slices them out of the full chunk's)."""
        meta = self._pinput
        tokens = meta[3 : 3 + bucket][None]
        pos = meta[0:1, None].to(torch.int32) + torch.arange(
            bucket, dtype=torch.int32, device=self.device
        )[None]
        if self.paged:
            cache, table = self.cache, self._pbt
        else:
            cache, table = self.cache.at_rows(meta[2:3].to(torch.int32)), None
        logits = forward(
            self.params, self.cfg, tokens, pos, cache, block_table=table, last_index=meta[1:2],
            moe_impl=self._moe_impl, mesh=self.mesh,
        )
        return logits[0, 0]

    def _sync_table(self) -> None:
        """Bring the device block table up to the host's, in place, if the
        host's changed since the last upload. The copy goes on the engine's
        stream after every dispatch made so far, so a chunk already in
        flight keeps reading the table it was dispatched with."""
        if not self.paged:
            return
        with self._page_lock:
            if np.array_equal(self._bt, self._bt_sent):
                return
            self._bt_sent[...] = self._bt
            self._xfer.upload(self._dbt, self._bt)

    def _run_step(self, key: tuple) -> torch.Tensor:
        """Dispatch step ``key``: its graph's replay on the card, the step
        function eagerly on the CPU (and on the card only while warmup
        serves, before the graphs are captured)."""
        if self._graphs is not None and not self._warming:
            return self._graphs.replay(key)
        return self._step_fn(key)()

    def _decode_n(self, chunk: int) -> torch.Tensor:
        """Dispatch one decode chunk of ``chunk`` steps over every lane;
        returns the sampled tokens [chunk, B] on the device."""
        return self._run_step(("decode", chunk, all(t <= 0.0 for t in self._lane_temps)))

    def _decode_steps(self, chunk: int, all_greedy: bool) -> torch.Tensor:
        """The decode step function: ``chunk`` autoregressive steps over
        every lane, chained on the device carry in place (the reference's
        ``lax.scan`` in ``decode_n``); returns the sampled tokens [chunk,
        B]. Pages were allocated for the whole chunk before dispatch, so one
        block table serves it."""
        toks = []
        for _ in range(chunk):
            logits = forward(
                self.params, self.cfg, self._dtok[:, None], self._dpos[:, None], self.cache,
                block_table=self._dbt, moe_impl=self._moe_impl, mesh=self.mesh,
            )
            nxt = sample_step(
                logits[:, 0], self._gen, self._dtemps, self._dtopk, self._dtopp,
                all_greedy=all_greedy, approx_topk=self.approx_topk,
            )
            self._dtok.copy_(nxt)
            # clamp: parked lanes decode forever at the scratch position; real
            # lanes never reach it (admission budgets position + max_tokens)
            self._dpos.copy_(torch.clamp(self._dpos + 1, max=self.scratch_pos))
            toks.append(nxt)
        return torch.stack(toks)

    def _finish(self, slot: Slot, pending_last: bool) -> None:
        """``pending_last``: the final generated token was sampled but not
        yet fed through the model; carry it into the session's next prompt."""
        req = slot.request
        slot.request = None
        slot.last_used = time.monotonic()
        slot.pending_token = (
            (req.generated[-1] if req.generated else None) if pending_last else None
        )
        # fold the reply into the drafting corpus; a held-out pending token
        # arrives again with the next turn's prompt
        slot.spec_hist.extend(
            req.generated[:-1] if slot.pending_token is not None else req.generated
        )
        del slot.spec_hist[: -self.max_seq]
        if slot.decoding:
            slot.decoding = False
            slot.dev_position = self.scratch_pos
            self._park_lane(slot.idx)
        breakdown = None
        if req.ttft_ms and req.prefill_started_at and req.prefill_done_at:
            breakdown = {
                "queue_ms": round(1000 * (req.prefill_started_at - req.submitted_at), 2),
                "prefill_ms": round(1000 * (req.prefill_done_at - req.prefill_started_at), 2),
                "first_readback_ms": round(
                    req.ttft_ms - 1000 * (req.prefill_done_at - req.submitted_at), 2
                ),
            }
        result = {
            "text": self.tokenizer.decode(req.generated),
            "tokens": req.generated,
            "prompt_tokens": len(req.prompt_ids),
            "completion_tokens": len(req.generated),
            "ttft_ms": round(req.ttft_ms, 2) if req.ttft_ms else None,
            "ttft_breakdown": breakdown,
        }
        # Paged: settle the session before resolving the caller — sync the
        # lane's final state back, stage any snapshot parked on it (the
        # staging reads the synced session), then release the lane (the
        # session stays resident in pages). "await chat() returned" then
        # implies the session is settled.
        if self.paged:
            if slot.psess is not None:
                slot.psess.position = slot.position
                slot.psess.pending_token = slot.pending_token
            self._service_parked_snapshot(slot)
            self._detach_lane(slot)
        req.loop.call_soon_threadsafe(_resolve, req.future, result)
        # a cancel that raced the natural finish loses: drop its marker
        with self._lock:
            self._cancel_requested.pop(req.id, None)
        if not self.paged:
            # the slot is idle right now: stage a snapshot parked while the
            # request generated
            self._service_parked_snapshot(slot)

    def _decode_dispatch(self) -> None:
        """Run one decode chunk on the device carry and queue its token
        readback. Chunk size is policy (_pick_chunk)."""
        snapshot = [
            (s, s.request, s.dev_position) for s in self.slots if s.decoding and s.request is not None
        ]
        if not snapshot:
            return
        needed = max(r.max_tokens - r.dispatched for _, r, _ in snapshot)
        if needed <= 0:
            return  # every live lane's whole budget is already in flight
        # failpoint: a decode fault is batch-wide (one call covers every
        # lane); warmup's requests (no id) are exempt
        if any(r.id for _, r, _ in snapshot):
            faults.fire("engine.decode_step")
        chunk = self._pick_chunk(needed)
        if self.paged:
            # pre-allocate pages covering every step of the chunk so the
            # block table is constant across it; a lane the pool can't cover
            # fails with 429 backpressure — the others keep decoding
            kept = []
            for s, r, p in snapshot:
                try:
                    self._ensure_lane_pages(s, p + chunk - 1)
                    kept.append((s, r, p))
                except EngineOverloaded as e:
                    self._reset_slot(s, rollback=True)
                    self._fail_item(r, e)
            snapshot = kept
            if not snapshot:
                return
            self._sync_table()
        toks = self._decode_n(chunk)
        for s, r, _ in snapshot:
            s.dev_position += chunk
            r.dispatched += chunk
        self.decode_chunk_hist[chunk] = self.decode_chunk_hist.get(chunk, 0) + 1
        self.decode_steps += 1
        self._occupancy_sum += len(snapshot) / self.max_batch
        self.hbm_bytes_read += chunk * self.param_hbm_bytes + sum(
            chunk * (p + chunk // 2) * self._kv_bytes_per_pos for _, _, p in snapshot
        )
        host, event = self._xfer.download(toks)
        self._push_readback(Readback("chunk", host, event, snapshot=snapshot))

    def _pick_chunk(self, needed: int) -> int:
        """Adaptive decode-chunk policy: contention — a mid-prefill prompt, or
        a queued request with a free slot to take — shrinks to the smallest
        rung so the worker returns to admission/prefill after ~one token;
        otherwise the smallest rung covering the remaining budget, up to the
        full chunk."""
        if not self.adaptive_decode:
            return self.decode_chunk
        contended = any(s.request is not None and s.pending_prompt for s in self.slots)
        if not contended and (self._waiting or not self._queue.empty()):
            contended = any(s.request is None for s in self.slots)
        if contended and self._decode_ladder[0] < self.decode_chunk:
            self.decode_chunks_shrunk += 1
            return self._decode_ladder[0]
        target = max(1, min(needed, self.decode_chunk))
        for c in self._decode_ladder:
            if c >= target:
                return c
        return self.decode_chunk

    # -- the fused decode loop (worker thread) ----------------------------
    #
    # One dispatch runs up to ``nsteps`` decode iterations on the device
    # (the reference's ``lax.while_loop`` in ``_fused_fn``) and reads its
    # tokens back once, packed. An iteration is four segments over the
    # ``FusedState`` buffers — ``_fused_pre`` (the active set and, with
    # in-loop spec, the drafts), ``_fused_plain`` or ``_fused_verify`` (one
    # forward), ``_fused_post`` (EOS, budgets, emission rows, the carry and
    # the history, the next ``cont``) — between ``_fused_prologue`` (absorb
    # the staged lane, reset the loop state, draw the loop's uniforms) and
    # ``_fused_tail`` (pack the readback). On the card they are graphs
    # assembled into one loop graph; on the CPU ``run_loop_eager`` drives
    # the same functions.

    def _fused_parts(self, all_greedy: bool) -> dict:
        """The fused loop's segments: name -> (graph key, step function).
        The segments that draw nothing and read no sampling choice are
        shared by both variants."""
        cap = self._fused_cap
        parts = {
            "prologue": (("fused_pro", cap, all_greedy), functools.partial(self._fused_prologue, all_greedy)),
            "pre": (("fused_pre", cap, True), self._fused_pre),
            "plain": (("fused_plain", cap, all_greedy), functools.partial(self._fused_plain, all_greedy)),
            "post": (("fused_post", cap, True), self._fused_post),
            "tail": (("fused_tail", cap, True), self._fused_tail),
        }
        if self.inloop_spec:
            parts["verify"] = (
                ("fused_verify", cap, all_greedy), functools.partial(self._fused_verify, all_greedy),
            )
        return parts

    def _fused_steps(self, all_greedy: bool) -> torch.Tensor:
        """The fused loop run eagerly (the CPU's runner): the prologue, the
        iterations while ``cont`` holds, the packed readback."""
        fn = {name: f for name, (_, f) in self._fused_parts(all_greedy).items()}
        fn["prologue"]()
        fl = self._fl
        run_loop_eager(
            fl.cont, fn["plain"], pre=fn["pre"], verify=fn.get("verify"), post=fn["post"], spec=fl.spec
        )
        return fn["tail"]()

    def _fused_inputs(self):
        """Views of the loop's uploaded inputs: armed, live, budgets,
        ignore_eos [B] and the bound [1]."""
        b, f = self.max_batch, self._finput
        return f[:b] != 0, f[b : 2 * b] != 0, f[2 * b : 3 * b], f[3 * b : 4 * b] != 0, f[4 * b :]

    def _fused_prologue(self, all_greedy: bool) -> None:
        """Absorb the staged lane into the carry (``armed``), reset the loop
        state and decide whether a first iteration runs. A sampled loop
        draws one row of uniforms per iteration up front, so every replay
        advances the generator by the same amount."""
        fl = self._fl
        armed, live, budgets, _, nsteps = self._fused_inputs()
        for live_t, staged_t in (
            (self._dtok, self._stok), (self._dpos, self._spos), (self._dtemps, self._stemps),
            (self._dtopk, self._stopk), (self._dtopp, self._stopp), (self._dhlen, self._shlen),
        ):
            live_t.copy_(torch.where(armed, staged_t, live_t))
        self._dhist.copy_(torch.where(armed[:, None], self._shist, self._dhist))
        fl.done.copy_(~live | (budgets <= 0))
        fl.full.zero_()
        fl.emitted.fill_(-1)
        for t in (fl.nemit, fl.reason, fl.nacc, fl.ndr, fl.it, fl.nverify):
            t.zero_()
        fl.cont.copy_((nsteps > 0) & (~fl.done).any())
        if not all_greedy:
            fl.noise.uniform_(0.0, 1.0, generator=self._gen)

    def _fused_sample(self, logits: torch.Tensor, all_greedy: bool) -> torch.Tensor:
        """An iteration's sampler over the carry's parameters, from the
        iteration's row of uniforms."""
        fl = self._fl
        noise = None if all_greedy else fl.noise.index_select(0, fl.it)[0]
        return sample_step(
            logits, None, self._dtemps, self._dtopk, self._dtopp, all_greedy=all_greedy,
            approx_topk=self.approx_topk, noise=noise,
        )

    def _fused_pre(self) -> None:
        """An iteration's active set and budget room; with in-loop spec the
        drafts (greedy active lanes with room, each up to its match
        distance) and whether any lane drafted."""
        fl = self._fl
        _, _, budgets, _, _ = self._fused_inputs()
        fl.rec.copy_(~(fl.done | fl.full))
        fl.room.copy_(budgets - fl.nemit)
        if not self.inloop_spec:
            return
        exists, dstar, drafts = draft_from_hist(self._dhist, self._dhlen, FUSED_SPEC_K)
        dlen = torch.where(
            exists & (self._dtemps <= 0.0) & fl.rec,
            torch.minimum(torch.clamp(dstar, max=FUSED_SPEC_K), torch.clamp(fl.room - 1, min=0)),
            0,
        )
        fl.drafts.copy_(drafts)
        fl.dlen.copy_(dlen)
        fl.spec.copy_((dlen > 0).any().reshape(1))

    def _fused_plain(self, all_greedy: bool) -> None:
        """The plain branch: one [B, 1] decode step; an active lane's one
        candidate is the sampled token."""
        fl = self._fl
        logits = forward(
            self.params, self.cfg, self._dtok[:, None], self._dpos[:, None], self.cache,
            block_table=self._dbt, moe_impl=self._moe_impl, mesh=self.mesh,
        )
        nxt = self._fused_sample(logits[:, 0], all_greedy)
        fl.cand.zero_()
        fl.cand[:, 0].copy_(nxt)
        fl.navail.copy_(fl.rec.long())
        fl.acc.zero_()
        fl.dln.zero_()

    def _fused_verify(self, all_greedy: bool) -> None:
        """The verify branch: the carry token and the K drafts as one
        [B, K+1] forward; greedy lanes accept the drafts that agree with the
        argmax, and row j > 0's candidate is the verifier's argmax (an
        accepted draft or the correction)."""
        fl = self._fl
        k = FUSED_SPEC_K
        dev = self.device
        toks = torch.cat([self._dtok[:, None], fl.drafts], dim=1)
        offs = torch.arange(k + 1, dtype=torch.int32, device=dev)[None]
        positions = torch.clamp(self._dpos[:, None] + offs, max=self.scratch_pos)
        logits = forward(
            self.params, self.cfg, toks, positions, self.cache, block_table=self._dbt,
            moe_impl=self._moe_impl, mesh=self.mesh,
        )
        greedy = logits.argmax(dim=-1)
        valid = torch.arange(k, device=dev)[None] < fl.dlen[:, None]
        ok = (fl.drafts == greedy[:, :k]) & valid
        a = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        nxt0 = self._fused_sample(logits[:, 0], all_greedy)
        fl.cand.copy_(torch.cat([nxt0[:, None], greedy[:, 1:]], dim=1))
        fl.navail.copy_(torch.where(fl.rec, a + 1, 0))
        fl.acc.copy_(torch.where(fl.rec, a, 0))
        fl.dln.copy_(torch.where(fl.rec, fl.dlen, 0))
        fl.nverify.add_(1)

    def _fused_post(self) -> None:
        """Emit an iteration's candidates: cap them by budget room, stop at
        the first EOS (the lane is done and parks at scratch; its EOS token
        is recorded, never fed), freeze a lane that reached its budget
        (``full``: it keeps its real token and position, and only the host
        decides it finished), append the emitted tokens to the lane's rows,
        advance the carry and the history, and decide ``cont``."""
        fl = self._fl
        dev = self.device
        _, _, budgets, ign, nsteps = self._fused_inputs()
        width = fl.cand.shape[1]
        cap_rows = self._fused_cap + 1
        navail = torch.minimum(fl.navail, torch.clamp(fl.room, min=0))
        cols = torch.arange(width, device=dev)[None]
        is_emit = cols < navail[:, None]
        is_eos = is_emit & (fl.cand == self.tokenizer.eos_id) & ~ign[:, None]
        has_eos = is_eos.any(dim=1)
        cnt = torch.where(has_eos, is_eos.long().argmax(dim=1) + 1, navail)
        fl.nemit.add_(cnt)
        fl.reason.copy_(torch.where((fl.reason == 0) & has_eos, 1, fl.reason))
        fl.done.logical_or_(has_eos)
        fl.full.logical_or_(fl.rec & ~has_eos & (fl.nemit >= budgets))
        last = fl.cand.gather(1, torch.clamp(cnt - 1, min=0)[:, None])[:, 0]
        self._dtok.copy_(torch.where(cnt > 0, last, self._dtok))
        self._dpos.copy_(
            torch.where(
                fl.done, self.scratch_pos, torch.clamp(self._dpos + cnt, max=self.scratch_pos)
            ).to(torch.int32)
        )
        lanes = torch.arange(self.max_batch, device=dev)
        for j in range(width):
            rows = torch.where(j < cnt, fl.nemit - cnt + j, cap_rows)
            fl.emitted.index_put_((rows, lanes), fl.cand[:, j])
        if self.inloop_spec:
            ext = torch.cat([self._dhist, fl.cand], dim=1)
            shift = torch.arange(FUSED_HIST_W, device=dev)[None] + cnt[:, None]
            self._dhist.copy_(ext.gather(1, shift))
            self._dhlen.copy_(torch.clamp(self._dhlen + cnt, max=FUSED_HIST_W))
        fl.nacc.add_(fl.acc)
        fl.ndr.add_(fl.dln)
        fl.it.add_(1)
        fl.cont.copy_((nsteps > fl.it) & (~(fl.done | fl.full)).any())

    def _fused_tail(self) -> torch.Tensor:
        """The loop's one readback, [cap + 7, B] int32: rows [0, cap + 1)
        the emitted tokens (-1 past a lane's count), then the counts, the
        finish reasons (0 running, 1 EOS), the iterations run (broadcast),
        the accepted and drafted counts (the reference's [cap + 6, B]), and
        the iterations that took the verify branch (broadcast), from which
        the host counts the loop's kernel calls."""
        fl = self._fl
        b = self.max_batch
        return torch.cat(
            [
                fl.emitted[: self._fused_cap + 1], fl.nemit[None], fl.reason[None],
                fl.it.expand(1, b), fl.nacc[None], fl.ndr[None], fl.nverify.expand(1, b),
            ]
        ).to(torch.int32)

    def _fused_dispatch(self) -> None:
        """Dispatch one fused loop over every decoding lane (the
        ``fused_decode`` replacement of ``_decode_dispatch``) and queue its
        packed readback. Paged lanes get pages ``FUSED_SPEC_K`` positions
        past the loop's reach, since the verify branch writes draft rows
        there. A lane's emission budget is ``min(remaining, chunk + 1)``:
        the host counts iterations, not emissions, so it only ever
        overestimates what is left, and the device freezes a lane at its
        budget without finishing it."""
        base = [(s, s.request, s.dev_position) for s in self.slots if s.decoding and s.request is not None]
        if not base:
            return
        needed = max(r.max_tokens - r.dispatched for _, r, _ in base)
        if needed <= 0:
            return
        # failpoint: the batch-wide seam of the fused path; warmup's
        # requests (no id) are exempt
        if any(r.id for _, r, _ in base):
            faults.fire("engine.fused_decode")
        chunk = self._pick_fused_chunk()
        if self.paged:
            kept = []
            for s, r, p in base:
                try:
                    self._ensure_lane_pages(s, p + chunk + FUSED_SPEC_K)
                    kept.append((s, r, p))
                except EngineOverloaded as e:
                    self._reset_slot(s, rollback=True)
                    self._fail_item(r, e)
            base = kept
            if not base:
                return
            self._sync_table()
        b = self.max_batch
        meta = np.zeros((4 * b + 1,), dtype=np.int64)
        for s, r, _ in base:
            meta[b + s.idx] = 1
            meta[2 * b + s.idx] = min(r.max_tokens - r.dispatched, chunk + 1)
            meta[3 * b + s.idx] = int(r.ignore_eos)
        if self._staged_lane is not None:
            meta[self._staged_lane] = 1
        meta[4 * b] = chunk
        self._xfer.upload(self._finput, meta)
        key = ("fused", self._fused_cap, all(t <= 0.0 for t in self._lane_temps))
        graphed = self._graphs is not None and not self._warming
        packed = self._run_step(key)
        if self._staged_lane is not None:
            # the loop just dispatched absorbs the staged lane at entry
            self._staged_lane = None
            self.fused_injections_total += 1
        snapshot = [[s, r, p, int(meta[2 * b + s.idx])] for s, r, p in base]
        for s, r, _, adv in snapshot:
            # an upper bound, settled when the readback is processed
            s.dev_position += adv
            r.dispatched += chunk
        self.fused_loops_total += 1
        self.decode_chunk_hist[chunk] = self.decode_chunk_hist.get(chunk, 0) + 1
        self.decode_steps += 1
        self._occupancy_sum += len(snapshot) / self.max_batch
        host, event = self._xfer.download(packed)
        self._push_readback(
            Readback("fused", host, event, snapshot=snapshot, chunk=chunk, key=key, graphed=graphed)
        )

    def _pick_fused_chunk(self) -> int:
        """The fused loop's bound: the smallest ladder rung under contention
        (a prompt mid-prefill, or a waiting request with a free lane), as
        ``_pick_chunk``; otherwise the cap (per-lane budgets freeze finished
        lanes, and the loop exits when no lane is active)."""
        if not self.adaptive_decode:
            return self.decode_chunk
        contended = any(s.request is not None and s.pending_prompt for s in self.slots)
        if not contended and (self._waiting or not self._queue.empty()):
            contended = any(s.request is None for s in self.slots)
        if contended and self._decode_ladder[0] < self._fused_cap:
            self.decode_chunks_shrunk += 1
            return self._decode_ladder[0]
        return self._fused_cap

    def _process_fused(self, entry: Readback) -> None:
        """Process a fused loop's packed readback, its one host sync. The
        host rescans the emitted tokens against its own budget and EOS
        policy, as ``_process_chunk`` does, and decides every finish: an EOS
        lane parked on the device without feeding its token, and a budget
        lane froze before feeding past its cap, so both finish with
        ``pending_last`` at ``start + used``. A live lane's device position
        is ``start + count``: later loops of the lane in flight start there,
        and its ``dev_position`` is that plus their budgets."""
        packed = entry.host.numpy()
        cap_rows = self._fused_cap + 1
        self.host_syncs_total += 1
        steps = int(packed[cap_rows + 2, 0])
        verify_steps = int(packed[cap_rows + 5, 0])
        if entry.graphed:
            self._graphs.add_loop_launches(entry.key, steps - verify_steps, verify_steps)
        self.fused_steps_total += steps
        self.fused_verify_steps_total += verify_steps
        reason = "early_all_finished" if steps < entry.chunk else "limit"
        if steps < entry.chunk:
            self.fused_early_exits_total += 1
        self.fused_exit_reason_hist[reason] = self.fused_exit_reason_hist.get(reason, 0) + 1
        end = time.monotonic()
        # ITL per token: the deepest live lane's emissions are the loop's
        # token depth (in-loop spec emits several per iteration)
        depth = max(
            (int(packed[cap_rows, s.idx]) for s, r, _, _ in entry.snapshot if s.request is r),
            default=0,
        ) or steps
        if self._last_decode_end is not None and depth:
            self.itl_ms_recent.append(1000 * (end - self._last_decode_end) / depth)
        self._last_decode_end = end
        # the weights stream once per iteration run, plus each lane's prefix
        self.hbm_bytes_read += steps * self.param_hbm_bytes + sum(
            steps * (p + steps // 2) * self._kv_bytes_per_pos for _, _, p, _ in entry.snapshot
        )
        eos = self.tokenizer.eos_id
        for slot, req, start, _ in entry.snapshot:
            if slot.request is not req or not req.generated:
                continue  # finished or aborted earlier; the first token comes first
            cnt = int(packed[cap_rows, slot.idx])
            self.inloop_spec_accepted += int(packed[cap_rows + 3, slot.idx])
            self.inloop_spec_drafted += int(packed[cap_rows + 4, slot.idx])
            outs = packed[:cnt, slot.idx]
            remaining = req.max_tokens - len(req.generated)
            used = 0
            hit_eos = False
            for j in range(min(cnt, remaining)):
                used += 1
                if not req.ignore_eos and int(outs[j]) == eos:
                    hit_eos = True
                    break
            req.generated.extend(int(t) for t in outs[:used])
            req.emit_appended(used)
            self.tokens_generated += used
            self.flops_done += used * self.cfg.flops_per_token(start + used // 2)
            if hit_eos or len(req.generated) >= req.max_tokens:
                slot.position = start + used
                self._finish(slot, pending_last=True)
                continue
            slot.position = start + used
            if int(packed[cap_rows + 1, slot.idx]) != 0:
                # the device parked a lane the host keeps (its EOS policy
                # disagreed): point the lane at its last token again
                slot.dev_position = slot.position
                self._inject_lane(
                    slot.idx, int(outs[used - 1]), slot.position, req.temperature, req.top_k,
                    req.top_p,
                )
                continue
            # the next loop of this lane in flight started where this one
            # ended; the lane's device position is that plus the budgets
            # of the loops in flight
            at = pending = start + cnt
            for later in (*self._readbacks, *((self._pushing,) if self._pushing else ())):
                for item in later.snapshot if later.kind == "fused" else ():
                    if item[0] is slot and item[1] is req:
                        if pending == at:
                            item[2] = at
                        pending += item[3]
            slot.dev_position = pending

    # -- self-speculative decoding (worker thread) ------------------------
    #
    # Prompt-lookup drafting: a lane's own token stream is the draft model.
    # Per round the host drafts up to gamma tokens per lane, one verify
    # forward at [max_batch, K+1] scores every lane's drafts, the longest
    # agreeing prefix is accepted plus the model's own token at the first
    # unverified row, and the lane's position is rewound past rejected
    # drafts (their KV sits above the live length, where no query looks
    # until the stream overwrites it; paged: whole pages of it go back to
    # the pool).

    def _verify(self, drafts: np.ndarray, dlen: np.ndarray) -> torch.Tensor:
        """Dispatch one verify round for draft bucket K = ``drafts.shape[1]``
        (drafts [B, K], lengths [B], written into the static verify inputs);
        returns ``_verify_step``'s output on the device."""
        k = drafts.shape[1]
        self._xfer.upload(self._vdrafts[k], drafts)
        self._xfer.upload(self._vdlen, dlen)
        return self._run_step(("verify", k, all(t <= 0.0 for t in self._lane_temps)))

    def _verify_step(self, k: int, all_greedy: bool) -> torch.Tensor:
        """The verify step function over the decode carry for bucket K:
        feed each lane [carry token, draft_0..K-1] at positions
        ``min(pos + arange(K+1), scratch)``, accept, and advance the carry in
        place. Returns [B, K+2]: lane b's next ``out[b, K+1]`` (count)
        tokens are ``out[b, :count]`` (accepted drafts, then the bonus or
        correction token)."""
        dev = self.device
        dl = self._vdlen
        # rows past a lane's drafts repeat its carry token (the reference
        # feeds 0 there; those rows are never accepted either way): the rows
        # of a parked lane, all at the scratch position, then feed one token
        # and write the same bytes to the one scratch slot they share, so the
        # step is deterministic and a graph replay equals the eager step
        d = torch.where(
            torch.arange(k, device=dev)[None] < dl[:, None], self._vdrafts[k], self._dtok[:, None]
        )
        toks = torch.cat([self._dtok[:, None], d], dim=1)
        offs = torch.arange(k + 1, dtype=torch.int32, device=dev)[None]
        # parked lanes, and rows past a lane's draft, clamp at scratch
        positions = torch.clamp(self._dpos[:, None] + offs, max=self.scratch_pos)
        logits = forward(
            self.params, self.cfg, toks, positions, self.cache, block_table=self._dbt,
            moe_impl=self._moe_impl, mesh=self.mesh,
        )
        greedy = logits.argmax(dim=-1)
        # draft_j (= toks[:, j+1]) is scored by logits row j: greedy lanes
        # accept on argmax agreement, sampled lanes with probability
        # p_j(draft_j) (rejection sampling with a point-mass proposal)
        ok = d == greedy[:, :k]
        if not all_greedy:
            u = torch.rand(d.shape, generator=self._gen, device=dev)
            temps = torch.clamp(self._dtemps, min=1e-6)[:, None, None]
            probs = torch.softmax(logits[:, :k] / temps, dim=-1)
            p_draft = probs.gather(2, d[:, :, None])[:, :, 0]
            ok = torch.where(self._dtemps[:, None] <= 0.0, ok, u < p_draft)
        ok = ok & (torch.arange(k, device=dev)[None] < dl[:, None])
        a = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # accepted drafts [B]
        # the bonus (all accepted) or correction token comes from row a; on
        # a rejection the rejected draft is masked out of it
        row_a = logits.gather(1, a[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
        draft_a = toks.gather(1, torch.clamp(a + 1, max=k)[:, None])[:, 0]
        vocab = torch.arange(row_a.shape[-1], device=dev)[None]
        row_a = torch.where(
            (vocab == draft_a[:, None]) & (a < dl)[:, None], torch.full_like(row_a, NEG_INF), row_a
        )
        bonus = sample_step(
            row_a, self._gen, self._dtemps, self._dtopk, self._dtopp, all_greedy=all_greedy,
            approx_topk=self.approx_topk,
        )
        m = torch.arange(k + 1, device=dev)[None]
        shifted = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], dim=1)
        emitted = torch.where(m < a[:, None], shifted, 0) + torch.where(m == a[:, None], bonus[:, None], 0)
        count = a + 1
        self._dtok.copy_(bonus)
        self._dpos.copy_(torch.clamp(self._dpos + count.to(torch.int32), max=self.scratch_pos))
        return torch.cat([emitted, count[:, None]], dim=1)

    def _spec_gamma(self, slot: Slot) -> int:
        """Draft length for one lane: the EMA times gamma_max, capped by the
        request's remaining budget and the arena's headroom. Collapsed or
        lookup-missing lanes draft 0, but for a 2-token probe every
        SPEC_PROBE_EVERY decode steps."""
        req = slot.request
        if req is None or not req.generated:
            return 0
        if req.temperature > 0.0 and (req.top_k > 0 or req.top_p < 1.0):
            # acceptance is against the unfiltered target: a filtered
            # sampled lane rides verify rounds draft-free
            return 0
        cap = min(
            self.spec_gamma_max,
            req.max_tokens - len(req.generated) - 1,
            self.max_seq - 2 - slot.position,
        )
        if cap <= 0:
            return 0
        if slot.spec_ema < SPEC_EMA_FLOOR or slot.spec_miss >= SPEC_MISS_BACKOFF:
            probe_due = self.decode_steps - slot.spec_probe_at >= SPEC_PROBE_EVERY
            return min(2, cap) if probe_due else 0
        return min(max(1, int(round(slot.spec_ema * self.spec_gamma_max))), cap)

    def _spec_draft(self, slot: Slot, gamma: int) -> list[int]:
        """Prompt-lookup draft: what followed the latest earlier occurrence
        of the stream's trailing 3-gram (else 2-gram), iterated on the
        extended stream until ``gamma`` tokens or no match."""
        seq = slot.spec_hist + slot.request.generated
        base = len(seq)
        while len(seq) - base < gamma:
            got = self._spec_lookup(seq, gamma - (len(seq) - base))
            if not got:
                break
            seq.extend(got)
        return [int(t) for t in seq[base:]]

    @staticmethod
    def _spec_lookup(seq: list, want: int) -> list:
        n_seq = len(seq)
        for n in (3, 2):
            if n_seq < n + 1:
                continue
            pat = seq[n_seq - n :]
            floor = max(0, n_seq - n - 1 - SPEC_LOOKUP_WINDOW)
            for i in range(n_seq - n - 1, floor - 1, -1):
                if seq[i : i + n] == pat:
                    return seq[i + n : i + n + want]
        return []

    def _try_speculate(self) -> bool:
        """Run one verify round if the batch has draftable lanes; True when
        one ran (the caller then skips the plain decode dispatch).

        A steady-state optimization: under admission or prefill contention
        the plain ladder keeps newcomers fast. A lane drafts once its first
        token's readback has been processed (``_spec_gamma`` needs a
        generated token). Drafting needs the host's view of every lane's
        stream to be current, so the round first drains the readback
        pipeline (admitting while it waits), then checks contention again.
        The round itself drafts for every decoding lane."""
        if not self._spec_active:
            return False
        if self._waiting or not self._queue.empty():
            return False
        if any(s.request is not None and s.pending_prompt for s in self.slots):
            return False
        if not any(
            s.decoding and s.request is not None and self._spec_gamma(s) > 0
            for s in self.slots
        ):
            return False
        while self._readbacks:
            self._drain_readbacks(block=True)
            if self._sentinel:
                return True  # unwind; the worker loop re-checks the sentinel
        if self._waiting or any(s.request is not None and s.pending_prompt for s in self.slots):
            return False
        plan = []
        any_draft = False
        for s in self.slots:
            if not s.decoding or s.request is None:
                continue
            g = self._spec_gamma(s)
            d = self._spec_draft(s, g) if g > 0 else []
            if g > 0:
                s.spec_probe_at = self.decode_steps
                s.spec_miss = 0 if d else s.spec_miss + 1
            any_draft = any_draft or bool(d)
            plan.append((s, s.request, s.position, d))
        if not any_draft:
            return False
        self._spec_round(plan)
        return True

    def _spec_round(self, plan: list) -> None:
        """One verify forward for the whole batch, read back at once (the
        next round's drafts depend on it). Every live lane advances at least
        one token; lanes without a draft ride along as a decode step."""
        gmax = max(len(d) for _, _, _, d in plan)
        k = next(b for b in self._spec_buckets if b >= gmax)
        if self.paged:
            # pages must cover the verify write span [p, p + K]
            kept = []
            for s, r, p, d in plan:
                try:
                    self._ensure_lane_pages(s, p + k)
                    kept.append((s, r, p, d))
                except EngineOverloaded as e:
                    self._reset_slot(s, rollback=True)
                    self._fail_item(r, e)
            plan = kept
            if not plan:
                return
        drafts = np.zeros((self.max_batch, k), dtype=np.int64)
        dlen = np.zeros((self.max_batch,), dtype=np.int64)
        for s, _, _, d in plan:
            if d:
                drafts[s.idx, : len(d)] = d
                dlen[s.idx] = len(d)
        if self.paged:
            self._sync_table()
        # read back at once (the next round's drafts depend on it), as the
        # reference's verify round is
        host, event = self._xfer.download(self._verify(drafts, dlen))
        event.synchronize()
        out = host.numpy().copy()
        self._xfer.give(host)
        self.host_syncs_total += 1
        emitted, count = out[:, :-1], out[:, -1]
        end = time.monotonic()
        self.spec_rounds += 1
        self.spec_verify_hist[k] = self.spec_verify_hist.get(k, 0) + 1
        self.decode_steps += 1
        self._occupancy_sum += len(plan) / self.max_batch
        # the weights stream ONCE for all K+1 rows, plus each lane's prefix
        self.hbm_bytes_read += self.param_hbm_bytes + sum(
            (p + k // 2) * self._kv_bytes_per_pos for _, _, p, _ in plan
        )
        eos = self.tokenizer.eos_id
        total_used = 0
        for slot, req, p, _ in plan:
            if slot.request is not req:
                continue
            c = int(count[slot.idx])
            n_draft = int(dlen[slot.idx])
            self.spec_drafted += n_draft
            self.spec_accepted += c - 1
            self.spec_rejected += n_draft - (c - 1)
            if n_draft:
                slot.spec_ema = (1 - SPEC_EMA_ALPHA) * slot.spec_ema + SPEC_EMA_ALPHA * (
                    (c - 1) / n_draft
                )
            outs = emitted[slot.idx]
            remaining = req.max_tokens - len(req.generated)
            used = 0
            hit_eos = False
            for j in range(min(c, remaining)):
                used += 1
                if not req.ignore_eos and int(outs[j]) == eos:
                    hit_eos = True
                    break
            req.generated.extend(int(t) for t in outs[:used])
            req.emit_appended(used)
            req.dispatched += c
            self.tokens_generated += used
            total_used += used
            self.flops_done += used * self.cfg.flops_per_token(p + used // 2)
            finished = hit_eos or len(req.generated) >= req.max_tokens
            if finished and used < c:
                # the used-th token was an accepted draft: already fed
                slot.position = p + used + 1
                slot.dev_position = slot.position
                self._finish(slot, pending_last=False)
            elif finished:
                slot.position = p + c
                slot.dev_position = slot.position
                self._finish(slot, pending_last=True)
            else:
                # KV rewind: rows >= p + c hold rejected drafts
                slot.position = p + c
                slot.dev_position = slot.position
                slot.last_used = end
                if self.paged and slot.psess is not None:
                    # paged rewind = page-tail truncation
                    slot.psess.position = slot.position
                    self._truncate_session_pages(slot.psess)
        if self._last_decode_end is not None and total_used:
            self.itl_ms_recent.append(1000 * (end - self._last_decode_end) / total_used)
        self._last_decode_end = end

    def _push_readback(self, entry: Readback) -> None:
        """Queue a readback. The FIFO never holds more than
        ``_PIPELINE_DEPTH + 1`` entries: when it is full the oldest is
        waited for and processed first (the new entry's work is already on
        the device behind it, and ``_pushing`` shows it to that
        processing)."""
        self._pushing = entry
        try:
            while len(self._readbacks) > self._PIPELINE_DEPTH:
                self._process_oldest()
        finally:
            self._pushing = None
        self._readbacks.append(entry)

    def _landed(self, event) -> bool:
        """Has a readback's copy landed, without waiting for it."""
        return event.query()

    def _drain_readbacks(self, block: bool) -> None:
        """Process landed readbacks in FIFO order. An entry is forced to
        completion when ``block`` asks for one (nothing else to dispatch)
        or while the FIFO is deeper than the pipeline depth; a forced wait
        keeps admitting (``_wait_admitting``), except with
        ``adaptive_decode`` off, the reference's fixed-cadence baseline,
        which blocks in processing."""
        while self._readbacks:
            entry = self._readbacks[0]
            if not (block or len(self._readbacks) > self._PIPELINE_DEPTH):
                if not self._landed(entry.event):
                    return
            elif self.adaptive_decode:
                self._wait_admitting(entry.event)
                if self._sentinel:
                    return
                if not self._readbacks or self._readbacks[0] is not entry:
                    # a prefill dispatched while waiting pushed past the
                    # bound, and the push processed this entry
                    block = False
                    continue
            self._process_oldest()
            block = False

    def _wait_admitting(self, event) -> None:
        """Forced-drain wait that keeps admitting: poll the submit queue
        while the readback's copy lands, and dispatch a fresh arrival's
        FIRST prefill chunk at once (later chunks ride the normal
        interleave); the device runs it behind the chunk in flight. The
        wait is on the queue (a 1 ms get), so an enqueue wakes the worker
        at once."""
        while not self._sentinel:
            self._pump_queue(0.0)
            if self._sentinel:
                return
            if self._waiting:
                self._admit_waiting()
            while any(
                s.request is not None and s.pending_prompt and s.request.prefill_started_at is None
                for s in self.slots
            ):
                try:
                    self._prefill_tick()
                except Exception as e:
                    # the same per-request isolation as the worker loop's tick
                    self._note_error(e)
                    slot = self._prefilling_slot
                    if slot is not None and slot.request is not None:
                        self._fail_item(slot.request, _as_prefill_failure(e))
                        self._reset_slot(slot)
                finally:
                    self._prefilling_slot = None
            if event.query():
                return
            try:
                item = self._queue.get(timeout=0.001)
            except queue.Empty:
                continue
            if item is None:
                self._sentinel = True
                return
            self._waiting.append(item)

    def _process_oldest(self) -> None:
        """Pop the oldest readback, wait for its copy if it has not landed,
        and process it."""
        entry = self._readbacks.popleft()
        entry.event.synchronize()
        try:
            if entry.kind == "first":
                self._process_first(entry)
            elif entry.kind == "fused":
                self._process_fused(entry)
            else:
                self._process_chunk(entry)
        finally:
            self._xfer.give(entry.host)

    def _process_first(self, entry: Readback) -> None:
        slot, req = entry.slot, entry.req
        if slot.request is not req:
            return  # request failed/superseded while the copy was in flight
        first_id = int(entry.host[0])
        self.host_syncs_total += 1
        now = time.monotonic()
        req.ttft_ms = 1000 * (now - req.submitted_at)
        self.ttft_ms_recent.append(req.ttft_ms)
        req.generated.append(first_id)
        req.emit_appended(1)
        self.tokens_generated += 1
        if len(req.generated) >= req.max_tokens or (
            not req.ignore_eos and first_id == self.tokenizer.eos_id
        ):
            # first token not yet in KV: carried into the next turn's prompt
            self._finish(slot, pending_last=True)

    def _process_chunk(self, entry: Readback) -> None:
        toks = entry.host.numpy()  # [chunk, B]
        self.host_syncs_total += 1
        chunk = toks.shape[0]
        # ITL = wall time between consecutive chunk completions (including
        # any interleaved prefill chunk) per generated token
        end = time.monotonic()
        if self._last_decode_end is not None:
            self.itl_ms_recent.append(1000 * (end - self._last_decode_end) / chunk)
        self._last_decode_end = end
        eos = self.tokenizer.eos_id
        for slot, req, start in entry.snapshot:
            if slot.request is not req or not req.generated:
                continue  # finished in an earlier (lagged) entry
            outs = toks[:, slot.idx]
            remaining = req.max_tokens - len(req.generated)
            used = 0
            hit_eos = False
            for j in range(min(chunk, remaining)):
                used += 1
                if not req.ignore_eos and int(outs[j]) == eos:
                    hit_eos = True
                    break
            req.generated.extend(int(t) for t in outs[:used])
            req.emit_appended(used)
            self.tokens_generated += used
            self.flops_done += used * self.cfg.flops_per_token(start + used // 2)
            finished = hit_eos or len(req.generated) >= req.max_tokens
            if finished and used < chunk:
                # chunk overshot: the used-th token was already fed at
                # position start+used; later writes overwrite the overshoot
                slot.position = start + used + 1
                self._finish(slot, pending_last=False)
            elif finished:
                slot.position = start + chunk
                self._finish(slot, pending_last=True)
            else:
                slot.position = start + chunk

    # -- KV snapshots and restores (worker thread) --------------------------
    #
    # Both arenas give one payload: the session's live prefix [L, position,
    # KV, hd] in the arena's dtype. Every device operation goes on the
    # engine's stream between dispatches, so a staging copy reads what the
    # dispatches before it wrote, and a restore's writes land before any
    # later dispatch reads them.

    def _do_snapshot(self, cmd: SnapshotCmd) -> None:
        """Stage a settled session's prefix now; a session mid-generation
        parks the command until its request finishes (one parked command
        per session; another bounces as rate-limited)."""
        if self.paged:
            sess = self.paged_sessions.get(cmd.session)
            busy = sess is not None and sess.lane is not None
        else:
            idx = self.sessions.get(cmd.session)
            sess = self.slots[idx] if idx is not None else None
            busy = sess is not None and sess.request is not None
        if sess is None:
            cmd.loop.call_soon_threadsafe(_resolve, cmd.future, None)
            return
        # the durability clock of a session starts at its first snapshot
        self._snap_last_by_session.setdefault(cmd.session, time.monotonic())
        if busy:
            if cmd.session in self._snap_parked:
                cmd.loop.call_soon_threadsafe(_resolve, cmd.future, "rate-limited")
            else:
                self._snap_parked[cmd.session] = cmd
            return
        if self.paged:
            self._stage_snapshot_paged(cmd, sess)
        else:
            self._stage_snapshot(cmd, sess)

    def _snap_gate(self, session: str) -> bool:
        """The staging limiter (dense and paged alike): True = rate-limited
        this time. Stagings are spaced by ``snapshot_min_gap_s``, by
        ``snapshot_busy_gap_s`` while other requests decode, and a busy
        engine stages a session only once its last staging is
        ``snapshot_force_s`` old (the durability floor)."""
        now = time.monotonic()
        busy = any(s.decoding or s.pending_prompt for s in self.slots)
        session_last = self._snap_last_by_session.get(session, self._snap_epoch0)
        overdue = now - session_last >= self.snapshot_force_s
        gap = self.snapshot_busy_gap_s if busy else self.snapshot_min_gap_s
        gap_ok = now - self._last_snapshot_at >= gap
        return (not gap_ok) or (busy and not overdue)

    def _stage_snapshot(self, cmd: SnapshotCmd, slot: Slot) -> None:
        """Stage a settled dense slot's ``[:position]`` (limiter-gated)."""
        staged = None
        if self._snap_gate(cmd.session):
            staged = "rate-limited"
        elif slot.position > 0:
            staged = self._stage_kv(
                cmd.session,
                self.cache.read_prefix(slot.idx, slot.position),
                slot.position,
                slot.pending_token,
            )
        cmd.loop.call_soon_threadsafe(_resolve, cmd.future, staged)

    def _stage_snapshot_paged(self, cmd: SnapshotCmd, sess: PagedSession) -> None:
        """Stage a resident session's live pages only (ceil(position /
        page_size) of them), gathered into one contiguous ``[L, count *
        page_size, KV, hd]`` buffer (limiter-gated)."""
        staged = None
        if self._snap_gate(cmd.session):
            staged = "rate-limited"
        elif sess.position > 0 and sess.pages:
            count = min(len(sess.pages), (sess.position - 1) // self.page_size + 1)
            staged = self._stage_kv(
                cmd.session,
                self.cache.read_pages(self._page_ids(sess.pages[:count])),
                sess.position,
                sess.pending_token,
            )
        cmd.loop.call_soon_threadsafe(_resolve, cmd.future, staged)

    def _stage_kv(
        self, session: str, parts: list, position: int, pending: int | None,
        count_snapshot: bool = True,
    ) -> StagedKV:
        """Copy the device (k, v) ``parts`` (one pair per tp slice) to the
        host without waiting: into pinned memory with an event recorded
        after the copies (the card; the host allocator caches pinned
        blocks, so only a new size class allocates), or a plain copy (the
        CPU). A snapshot counts for the limiter (``count_snapshot``); a
        tier demotion does not."""
        now = time.monotonic()
        if count_snapshot:
            self._last_snapshot_at = now
            self._snap_last_by_session[session] = now
            self.kv_snapshots_total += 1
        if self._stream is None:
            return StagedKV(
                [k.clone() for k, _ in parts], [v.clone() for _, v in parts],
                LANDED, position, pending, now, 0.0,
            )
        host = [
            [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in pair] for pair in parts
        ]
        alloc_ms = 1000 * (time.monotonic() - now)
        for (hk, hv), (k, v) in zip(host, parts):
            hk.copy_(k, non_blocking=True)
            hv.copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return StagedKV(
            [hk for hk, _ in host], [hv for _, hv in host], event, position, pending, now, alloc_ms
        )

    def _service_parked_snapshot(self, slot: Slot) -> None:
        """At a request's finish: stage a snapshot parked on its session
        while the slot is provably idle."""
        cmd = self._snap_parked.pop(slot.session, None) if slot.session else None
        if cmd is None:
            return
        if self.paged:
            if slot.psess is not None:
                self._stage_snapshot_paged(cmd, slot.psess)
            else:
                cmd.loop.call_soon_threadsafe(_resolve, cmd.future, None)
        else:
            self._stage_snapshot(cmd, slot)

    def _flush_parked_snapshot(self, session: str) -> None:
        """The session is going away (eviction, reset, clear, shutdown): a
        parked snapshot resolves with None instead of hanging its caller."""
        self._snap_last_by_session.pop(session, None)
        cmd = self._snap_parked.pop(session, None)
        if cmd is not None:
            cmd.loop.call_soon_threadsafe(_resolve, cmd.future, None)

    def _do_restore(self, cmd: RestoreCmd) -> None:
        """Write a snapshot into the arena: dense into the session's slot
        (``_find_slot``, a fresh one evicting the LRU idle session), paged
        into freshly allocated pages with no lane bound. Resolves False when
        it does not fit or the session is busy, and resolves even when the
        write raises."""
        ok = False
        try:
            cfg = self.cfg
            fits = (
                bool(cmd.session)
                and 0 < cmd.position < self.max_seq - 1
                and cmd.k.shape[0] == cfg.n_layers
                and tuple(cmd.k.shape[2:]) == (cfg.n_kv_heads, cfg.head_dim)
            )
            if not fits:
                return
            if self.paged:
                ok = self._do_restore_paged(cmd)
                return
            slot = self._find_slot(cmd.session)
            if slot is None:
                return  # the session is busy
            self.cache.write_prefix(slot.idx, cmd.k, cmd.v)
            self._hold_host_source(cmd.k, cmd.v)
            slot.position = cmd.position
            slot.pending_token = cmd.pending_token
            # the drafting corpus of the replaced context is gone
            slot.spec_hist, slot.spec_ema, slot.spec_miss = [], 1.0, 0
            # live now: without the stamp it would be the next LRU victim
            slot.last_used = time.monotonic()
            ok = True
        finally:
            self.kv_restores_total += ok
            cmd.loop.call_soon_threadsafe(_resolve, cmd.future, ok)

    def _do_restore_paged(self, cmd: RestoreCmd) -> bool:
        """Restore into pages, not a lane: the session becomes resident
        without a compute lane. A live session is never clobbered; pool
        exhaustion returns False (the caller prefills instead)."""
        with self._page_lock:
            existing = self.paged_sessions.get(cmd.session)
            if existing is not None:
                if existing.lane is not None:
                    return False  # mid-generation
                self._free_session_pages(existing)
                self.paged_sessions.pop(cmd.session, None)
                self.sessions.pop(cmd.session, None)
        count = (cmd.position - 1) // self.page_size + 1
        try:
            pages = self._alloc_pages(count)
        except EngineOverloaded:
            return False
        self._write_pages(pages, cmd.k, cmd.v, cmd.position)
        self._hold_host_source(cmd.k, cmd.v)
        sess = PagedSession(
            name=cmd.session,
            pages=pages,
            position=cmd.position,
            pending_token=cmd.pending_token,
            last_used=time.monotonic(),
        )
        with self._page_lock:
            self.paged_sessions[cmd.session] = sess
            self.sessions[cmd.session] = -1
        return True

    def _page_ids(self, pages: list[int]) -> torch.Tensor:
        """Page ids as a device long tensor (one upload)."""
        ids = torch.empty((len(pages),), dtype=torch.long, device=self.device)
        self._xfer.upload(ids, np.asarray(pages, dtype=np.int64))
        return ids

    def _write_pages(self, pages: list[int], k, v, position: int) -> None:
        """Write a host prefix ``[L, position, KV, hd]`` (the cache's dtype;
        pinned on the card, copied without waiting) into ``pages`` (every
        shard's pool, each its kv heads)."""
        self.cache.write_pages(self._page_ids(pages), k, v, position)

    def _hold_host_source(self, k, v) -> None:
        """Keep pinned host tensors (a restore's, a promotion's) alive until
        the copies queued out of them so far have landed (the card): a
        host-tier entry dropped right after its promotion must not free or
        reuse its buffers before the stream passes the copy. Sources of
        landed copies go."""
        if self._stream is None:
            return
        while self._restore_staging and self._restore_staging[0][0].query():
            self._restore_staging.popleft()
        event = torch.cuda.Event()
        event.record()
        self._restore_staging.append((event, k, v))

    # -- the tiered KV hierarchy: device -> pinned host RAM (worker thread)
    #
    # A demotion stages the session's live prefix into pinned host memory
    # (the snapshot plane's staging), waits for it, frees the device
    # residency (pages through the quarantine) and keeps the bytes in the
    # host tier, exact or as int8 pages (``tier_quantize``); a promotion
    # writes them back without waiting, as a restore does.

    def _tier_needs_promote(self, item) -> bool:
        """This request's session is parked in the host tier and must swap
        in before it can be admitted."""
        if not (self.kv_tiering and isinstance(item, GenRequest) and item.session):
            return False
        if item.session in self.sessions:
            return False
        with self._tier_lock:
            return item.session in self._host_tier

    def _tier_demote(self, session: str, pressure: bool = False) -> StagedKV | None:
        """Stage an idle session's exact KV prefix to the host, free its
        device residency and insert its host-tier entry. Returns the exact
        staged prefix (the park's blob is packed from it, before any
        quantization), or None with the session untouched."""
        try:
            # failpoint: a failed demote leaves the session resident
            faults.fire("engine.kv_demote")
        except Exception:
            self.tier_demote_failures_total += 1
            return None
        t0 = time.monotonic()
        if self.paged:
            sess = self.paged_sessions.get(session)
            if sess is None or sess.lane is not None or not sess.pages or sess.position <= 0:
                return None
            count = min(len(sess.pages), (sess.position - 1) // self.page_size + 1)
            parts = self.cache.read_pages(self._page_ids(sess.pages[:count]))
            position, pending = sess.position, sess.pending_token
            spec = (list(sess.spec_hist), sess.spec_ema, sess.spec_miss)
        else:
            idx = self.sessions.get(session)
            if idx is None or idx < 0:
                return None
            slot = self.slots[idx]
            if slot.request is not None or slot.position <= 0:
                return None
            position, pending = slot.position, slot.pending_token
            parts = self.cache.read_prefix(idx, position)
            spec = (list(slot.spec_hist), slot.spec_ema, slot.spec_miss)
        staged = self._stage_kv(session, parts, position, pending, count_snapshot=False)
        # the device residency goes now: later writes to its pages or row
        # are ordered after the staging copy on the engine's stream, and
        # freed pages wait in quarantine until the copy has landed
        self._flush_parked_snapshot(session)
        if self.paged:
            with self._page_lock:
                self._free_session_pages(sess, quarantine=staged.event)
                self.paged_sessions.pop(session, None)
                self.sessions.pop(session, None)
        else:
            self.sessions.pop(session, None)
            slot.session = ""
            slot.position = 0
            slot.pending_token = None
            slot.prefix_ctx = None
            slot.spec_hist, slot.spec_ema, slot.spec_miss = [], 1.0, 0
        staged.event.synchronize()
        self._reap_quarantine(0)  # the copy has landed: its pages are free
        k, v = staged.k[:, :position], staged.v[:, :position]
        if self.tier_quantize:
            qk, sk = quantize_kv_pages(k.float().numpy(), self.page_size)
            qv, sv = quantize_kv_pages(v.float().numpy(), self.page_size)
            entry = TieredEntry(
                k=qk, v=qv, k_scale=sk, v_scale=sv, quantized=True, pages=int(qk.shape[1]),
                position=position, pending_token=pending,
                nbytes=qk.nbytes + qv.nbytes + sk.nbytes + sv.nbytes, parked_at=time.monotonic(),
                spec_hist=spec[0], spec_ema=spec[1], spec_miss=spec[2],
            )
        else:
            entry = TieredEntry(
                k=k, v=v, position=position, pending_token=pending,
                nbytes=2 * k.numel() * k.element_size(), parked_at=time.monotonic(),
                spec_hist=spec[0], spec_ema=spec[1], spec_miss=spec[2],
            )
        self._tier_insert_host(session, entry, pressure=pressure)
        self.tier_timings.append({
            "kind": "park", "session": session, "position": position,
            "bytes": 2 * k.numel() * k.element_size(), "host_bytes": entry.nbytes,
            "ms": 1000 * (time.monotonic() - t0),
        })
        return staged

    def _tier_drop_locked(self, session: str) -> TieredEntry | None:
        """Remove a host-tier entry and its share of the gauges (caller
        holds _tier_lock)."""
        entry = self._host_tier.pop(session, None)
        if entry is not None:
            self.tier_host_bytes -= entry.nbytes
            if entry.quantized:
                self.tier_quantized_pages -= entry.pages
        return entry

    def _tier_insert_host(self, session: str, entry: TieredEntry, pressure: bool = False) -> None:
        """Insert (or replace) a host-tier entry; past the host budget the
        least recently parked entries are dropped (a store would keep their
        blobs; here their context is gone)."""
        with self._tier_lock:
            self._tier_drop_locked(session)
            self._host_tier[session] = entry
            self.tier_host_bytes += entry.nbytes
            if entry.quantized:
                self.tier_quantized_pages += entry.pages
            self.tier_demotions_total += 1
            if pressure:
                self.tier_pressure_demotions_total += 1
            while self.tier_host_bytes > self.tier_host_budget_bytes and len(self._host_tier) > 1:
                self._tier_drop_locked(next(iter(self._host_tier)))
                self.tier_host_evictions_total += 1

    def _tier_promote(self, session: str, prewarm: bool = False) -> bool:
        """Swap a host-tier session back onto the device, without waiting for
        the copy (from the admission path it overlaps the turn's queue
        wait). On failure the entry stays parked and False returns."""
        with self._tier_lock:
            entry = self._host_tier.get(session)
        if entry is None:
            return session in self.sessions
        t0 = time.monotonic()
        try:
            faults.fire("engine.kv_promote")
        except Exception:
            self.tier_promote_failures_total += 1
            return False
        dtype = self._kv_dtype
        if entry.quantized:
            k = torch.from_numpy(dequantize_kv_pages(entry.k, entry.k_scale, entry.position)).to(dtype)
            v = torch.from_numpy(dequantize_kv_pages(entry.v, entry.v_scale, entry.position)).to(dtype)
            if self._stream is not None:
                k, v = k.pin_memory(), v.pin_memory()
        else:
            k, v = entry.k, entry.v
        ok = (
            self._tier_promote_paged(session, entry, k, v)
            if self.paged
            else self._tier_promote_dense(session, entry, k, v)
        )
        if not ok:
            self.tier_promote_failures_total += 1
            return False
        self._hold_host_source(k, v)
        with self._tier_lock:
            self._tier_drop_locked(session)
        self.tier_promotions_total += 1
        if prewarm:
            self.tier_prewarm_hits_total += 1
        if len(self._tier_promote_started) > 256:
            for name in [n for n, t in self._tier_promote_started.items() if t < t0 - 300.0]:
                self._tier_promote_started.pop(name, None)
        self._tier_promote_started[session] = t0
        self.tier_timings.append({
            "kind": "promote", "session": session, "position": entry.position,
            "bytes": 2 * k.numel() * k.element_size(), "ms": 1000 * (time.monotonic() - t0),
        })
        return True

    def _tier_promote_paged(self, session: str, entry: TieredEntry, k, v) -> bool:
        if not 0 < entry.position < self.max_seq - 1:
            return False
        if session in self.paged_sessions:
            return True  # already resident: the host entry is stale
        count = (entry.position - 1) // self.page_size + 1
        try:
            pages = self._alloc_pages(count, serving=False)
        except EngineOverloaded:
            return False
        self._write_pages(pages, k, v, entry.position)
        sess = PagedSession(
            name=session, pages=pages, position=entry.position,
            pending_token=entry.pending_token, last_used=time.monotonic(),
            spec_hist=list(entry.spec_hist), spec_ema=entry.spec_ema, spec_miss=entry.spec_miss,
        )
        with self._page_lock:
            self.paged_sessions[session] = sess
            self.sessions[session] = -1
        return True

    def _tier_promote_dense(self, session: str, entry: TieredEntry, k, v) -> bool:
        if not 0 < entry.position < self.max_seq - 1:
            return False
        slot = self._find_slot(session)
        if slot is None:
            return False
        self.cache.write_prefix(slot.idx, k, v)
        slot.position = entry.position
        slot.pending_token = entry.pending_token
        slot.last_used = time.monotonic()
        slot.spec_hist = list(entry.spec_hist)
        slot.spec_ema = entry.spec_ema
        slot.spec_miss = entry.spec_miss
        return True

    def _tier_pressure_demote(self, need: int) -> None:
        """Paged pool pressure: demote idle resident sessions, least
        recently used first, into the host tier until ``need`` pages are
        free or in quarantine. Where ``_reclaim_pages`` destroys a victim's
        context, a demotion keeps it for the victim's next turn."""
        if not (self.kv_tiering and self.paged):
            return

        def short() -> bool:
            with self._page_lock:
                quarantined = sum(len(ids) for _, ids in self._page_quarantine)
                return len(self._page_free) + quarantined < need

        while short():
            with self._page_lock:
                idle = [
                    s for s in self.paged_sessions.values()
                    if s.lane is None and s.pages and s.position > 0 and s.name
                ]
            if not idle:
                return
            victim = min(idle, key=lambda s: s.last_used)
            if self._tier_demote(victim.name, pressure=True) is None:
                return  # the demote failpoint fired: stop, do not spin

    def _tier_metrics(self) -> dict:
        """The reference's tier gauges and counters."""
        with self._tier_lock:
            host_sessions = len(self._host_tier)
            host_bytes = self.tier_host_bytes
            quantized_pages = self.tier_quantized_pages
        return {
            "kv_tiering": self.kv_tiering,
            "tier_quantize": self.tier_quantize,
            "tier_host_sessions": host_sessions,
            "tier_host_bytes": host_bytes,
            "tier_host_budget_bytes": self.tier_host_budget_bytes,
            "tier_quantized_pages": quantized_pages,
            "tier_demotions_total": self.tier_demotions_total,
            "tier_promotions_total": self.tier_promotions_total,
            "tier_pressure_demotions_total": self.tier_pressure_demotions_total,
            "tier_prewarm_hits_total": self.tier_prewarm_hits_total,
            "tier_demote_failures_total": self.tier_demote_failures_total,
            "tier_promote_failures_total": self.tier_promote_failures_total,
            "tier_host_evictions_total": self.tier_host_evictions_total,
            "tier_promote_overlap_ms_total": round(self.tier_promote_overlap_ms_total, 2),
            "tier_promote_overlap_ms_p50": _p50(self.tier_promote_overlap_ms_recent),
        }

    # -- paged arena: page allocator + block tables -------------------------
    #
    # Host-side bookkeeping for the device page pool: the free list, the
    # refcounts and the block table live in numpy under _page_lock (the
    # worker allocates; API threads clear sessions).

    def _scratch_page(self, lane: int) -> int:
        """Lane ``lane``'s own scratch page: every block-table entry not
        covered by the bound session's pages points here, so parked decode
        steps and bucket-padding writes land where no live query looks."""
        return self._data_pages + lane

    def _alloc_pages(self, n: int, pin: bool = False, serving: bool = True) -> list[int]:
        """Take ``n`` pages off the free list; when it runs dry, with
        ``kv_tiering`` demote idle resident sessions into the host tier
        first, then evict idle resident sessions (then prefix pins)
        LRU-first. Raises PagePoolExhausted (429 backpressure) when that
        cannot cover the need. A ``pin`` (a best-effort prefix-cache page)
        takes only free pages, and its failure is no exhaustion event. A
        ``serving`` allocation (a request's own pages) passes the
        ``engine.page_alloc`` failpoint, whose fault is the same 429."""
        if n <= 0:
            return []
        if serving and not pin:
            try:
                faults.fire("engine.page_alloc")
            except Exception as e:
                self.page_exhausted_total += 1
                with self._page_lock:
                    free = len(self._page_free)
                raise PagePoolExhausted(n, free) from e
        self._reap_quarantine(n)
        if not pin and self.kv_tiering:
            with self._page_lock:
                short = len(self._page_free) < n
            if short:
                self._tier_pressure_demote(n)
                self._reap_quarantine(n)
        with self._page_lock:
            if len(self._page_free) < n and not pin:
                self._reclaim_pages(n)
            if len(self._page_free) < n:
                if not pin:
                    self.page_exhausted_total += 1
                raise PagePoolExhausted(n, len(self._page_free))
            ids = [self._page_free.pop() for _ in range(n)]
            self._page_refs[ids] = 1
            return ids

    def _reclaim_pages(self, need: int) -> None:
        """Evict until ``need`` pages are free or nothing evictable is left:
        idle resident sessions least recently used first (they can prefill
        again), then prefix-cache pins (they cost only a later cold
        prefill). Sessions with a request in flight are never touched.
        Caller holds _page_lock."""
        while len(self._page_free) < need:
            idle = [s for s in self.paged_sessions.values() if s.lane is None and s.pages]
            if not idle:
                break
            victim = min(idle, key=lambda s: s.last_used)
            self._count_eviction("session", time.monotonic() - victim.last_used)
            self._free_session_pages(victim)
            self.paged_sessions.pop(victim.name, None)
            self.sessions.pop(victim.name, None)
            self._flush_parked_snapshot(victim.name)
        now = time.monotonic()
        while len(self._page_free) < need and any(
            e.pages is not None for e in self._prefix_entries.values()
        ):
            self._prefix_evict_lru(now)

    def _free_page_ids(self, ids: list[int]) -> None:
        """Return zero-ref pages straight to the free list, with no
        quarantine. The reference parks them in one while readbacks are in
        flight, because a chunk dispatched before the free may still write
        through the old block table; here too a chunk may be in flight at a
        free (the readback pipeline). Stream order makes it safe: every
        device write of the engine goes on its one CUDA stream — graph
        replays, staging copies (the block table's too), prefill, prefix
        copies and page copies — so a write through the stale table lands
        before any later owner's first write to the page, and a later owner
        never attends above its own live length, which it writes before it
        reads."""
        with self._page_lock:
            self._page_free.extend(ids)

    def _decref_page(self, pid: int, freed: list | None = None) -> None:
        """Drop one reference; a page whose last reference goes returns to
        the free list, or into ``freed`` when the caller quarantines it."""
        with self._page_lock:
            self._page_refs[pid] -= 1
            if self._page_refs[pid] <= 0:
                self._page_refs[pid] = 0
                if freed is None:
                    self._free_page_ids([pid])
                else:
                    freed.append(pid)

    def _free_session_pages(self, sess: PagedSession, quarantine=None) -> None:
        """Release a session's page references. With ``quarantine`` (the
        event of a demotion's staging copy) the freed pages wait until the
        copy has landed before they can be allocated again."""
        pages, sess.pages, sess.shared = sess.pages, [], 0
        freed = [] if quarantine is not None else None
        for pid in pages:
            self._decref_page(pid, freed)
        if freed:
            with self._page_lock:
                self._page_quarantine.append((quarantine, freed))

    def _reap_quarantine(self, need: int) -> None:
        """Return quarantined pages whose staging copy has landed; when the
        free list still cannot cover ``need``, wait for the copies. The wait
        runs outside ``_page_lock``, which API threads take too (the
        reference's ``_reap_quarantine_if_short``). Only the worker reaps,
        so the entry it took is its own until its pages are freed."""
        while True:
            with self._page_lock:
                if not self._page_quarantine:
                    return
                event, ids = self._page_quarantine[0]
                if not (event.query() or len(self._page_free) < need):
                    return
                self._page_quarantine.popleft()
            event.synchronize()
            with self._page_lock:
                self._page_free.extend(ids)

    def _bind_lane_bt(self, slot: Slot, sess: PagedSession) -> None:
        """Point the lane's block-table row at the session's pages; every
        uncovered block falls back to the lane's scratch page."""
        self._bt[slot.idx, :] = self._scratch_page(slot.idx)
        if sess.pages:
            self._bt[slot.idx, : len(sess.pages)] = sess.pages

    def _ensure_lane_pages(self, slot: Slot, upto_pos: int) -> None:
        """Grow the bound session's pages (and the lane's table row) to cover
        writes through logical position ``upto_pos`` (at most the last
        position a request may reach, max_seq - 2). Called before every
        prefill and decode dispatch; a failure surfaces as
        PagePoolExhausted for THIS request only."""
        sess = slot.psess
        if sess is None:
            return
        blocks = min(max(0, upto_pos), self.max_seq - 2) // self.page_size + 1
        have = len(sess.pages)
        if have >= blocks:
            return
        serving = slot.request is not None and bool(slot.request.id)
        new = self._alloc_pages(blocks - have, serving=serving)
        with self._page_lock:
            sess.pages.extend(new)
            self._bt[slot.idx, have:blocks] = new

    def _truncate_session_pages(self, sess: PagedSession) -> None:
        """Page-tail truncation: free whole pages beyond the live context
        (what a decode chunk's overshoot or rejected drafts left behind).
        Mapped prefix pages are never dropped."""
        with self._page_lock:
            keep = 0 if sess.position <= 0 else (sess.position - 1) // self.page_size + 1
            keep = max(keep, sess.shared)
            if len(sess.pages) <= keep:
                return
            tail = sess.pages[keep:]
            del sess.pages[keep:]
            if sess.lane is not None:
                # un-map the freed blocks from the live lane: a stale entry
                # is read-masked but must never be written through
                self._bt[sess.lane, keep:] = self._scratch_page(sess.lane)
            self.pages_truncated += len(tail)
            for pid in tail:
                self._decref_page(pid)

    def _rollback_lane_session(self, slot: Slot) -> None:
        """Paged lane reset for a POLICY failure (pool exhaustion, 429): no
        dispatch died mid-write, so the session's KV below its admission-time
        position is intact. Truncate back to it, restore the admission-time
        pending token, and keep the session resident: the client's retry
        continues the conversation instead of finding it gone."""
        sess = slot.psess
        if sess is None or not sess.name or sess.admit_position <= 0:
            # fresh or anonymous context: nothing from before the request
            self._drop_lane_session(slot)
            return
        with self._page_lock:
            slot.psess = None
            self._bt[slot.idx, :] = self._scratch_page(slot.idx)
            sess.position = sess.admit_position
            sess.pending_token = sess.admit_pending
            # the corpus was extended in place at admission and by accepts
            sess.spec_hist = list(sess.admit_spec_hist)
            sess.last_used = time.monotonic()
            sess.lane = None
            self.sessions[sess.name] = -1
            self._truncate_session_pages(sess)
        slot.session = ""
        # the session is idle now: stage a snapshot parked while the failed
        # request was in flight, or its caller would wait forever
        cmd = self._snap_parked.pop(sess.name, None)
        if cmd is not None:
            self._stage_snapshot_paged(cmd, sess)

    def _drop_lane_session(self, slot: Slot) -> None:
        """Paged lane reset after a FAULT: the bound session's KV is no
        longer trusted (the failed call may have died mid-write), so its
        pages go back to the pool and the session leaves residency."""
        with self._page_lock:
            sess, slot.psess = slot.psess, None
            self._bt[slot.idx, :] = self._scratch_page(slot.idx)
            if sess is None:
                return
            self._free_session_pages(sess)
            if sess.name:
                self.paged_sessions.pop(sess.name, None)
                self.sessions.pop(sess.name, None)
                self._flush_parked_snapshot(sess.name)
            slot.session = ""

    def _detach_lane(self, slot: Slot) -> None:
        """A finished request releases its compute lane while the session
        stays resident in pages — what lets resident sessions outnumber
        max_batch. Sessionless generations free their pages at once."""
        with self._page_lock:
            sess, slot.psess = slot.psess, None
            self._bt[slot.idx, :] = self._scratch_page(slot.idx)
            if sess is None:
                return
            sess.spec_ema = slot.spec_ema
            sess.spec_miss = slot.spec_miss
            sess.last_used = time.monotonic()
            sess.lane = None
            if sess.name:
                self.sessions[sess.name] = -1
                self._truncate_session_pages(sess)
            else:
                self._free_session_pages(sess)
        slot.session = ""
        slot.position = 0
        slot.pending_token = None
        slot.spec_hist = []

    def _copy_page(self, src: int, dst: int) -> None:
        """One pool page copied, every layer (the partial-tail
        copy-on-write of a prefix level that is not page-aligned). Full
        pages are never copied: they are mapped."""
        self.cache.copy_page(src, dst)

    # -- prefix cache (cross-session KV reuse; worker thread) -------------

    @staticmethod
    def _rolling_hashes(tokens: list[int]) -> dict[int, int]:
        """FNV-1a rolling hash of the token ids, sampled at every prefill
        bucket boundary: hashes[b] keys the exact prefix tokens[:b]."""
        h = 1469598103934665603
        out: dict[int, int] = {}
        bi = 0
        for i, t in enumerate(tokens):
            h = ((h ^ (int(t) + 1)) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
            if bi < len(PREFILL_BUCKETS) and i + 1 == PREFILL_BUCKETS[bi]:
                out[PREFILL_BUCKETS[bi]] = h
                bi += 1
        return out

    def _prefix_lookup(self, prompt: list[int]):
        """The longest cached prefix at bucket granularity, as (key, entry),
        or None (a miss is counted when the prompt is long enough to hit).
        A hit leaves at least one prompt token to prefill; the hash match is
        verified by exact token equality."""
        if not self._prefix_levels or len(prompt) <= self._prefix_levels[0]:
            return None
        hashes = self._rolling_hashes(prompt)
        for b in reversed(self._prefix_levels):
            if b > len(prompt) - 1:
                continue
            key = (b, hashes.get(b))
            entry = self._prefix_entries.get(key)
            if entry is not None and entry.tokens == tuple(prompt[:b]):
                return key, entry
        self.prefix_misses += 1
        return None

    def _record_prefix_hit(self, key: tuple, entry: PrefixEntry) -> None:
        entry.hits += 1
        entry.last_used = time.monotonic()
        if key in self._prefix_entries:  # a reclaim may have evicted it
            self._prefix_entries.move_to_end(key)
        self.prefix_hits += 1
        self.prefix_tokens_saved += key[0]

    def _prefix_register(self, slot: Slot) -> None:
        """Final-prefill-chunk hook: cache every bucket-level prefix of a
        fresh context that is not cached yet. Best effort: a failure here
        never fails the generation."""
        ctx = slot.prefix_ctx
        slot.prefix_ctx = None
        if ctx is None or not self._prefix_active:
            return
        n = min(len(ctx), slot.position)
        try:
            hashes = self._rolling_hashes(ctx)
            now = time.monotonic()
            for b in self._prefix_levels:
                if b > n:
                    break
                key = (b, hashes[b])
                if key in self._prefix_entries:
                    continue
                if self.paged:
                    if not self._prefix_register_paged(slot, ctx, b, key, now):
                        break
                    continue
                nbytes = b * self._kv_bytes_per_pos
                if nbytes > self._prefix_budget:
                    break  # larger levels only grow
                while self._prefix_bytes + nbytes > self._prefix_budget and self._prefix_entries:
                    self._prefix_evict_lru(now)
                self._prefix_entries[key] = PrefixEntry(
                    kv=self.cache.clone_prefix(slot.idx, b), tokens=tuple(ctx[:b]), nbytes=nbytes,
                    created=now, last_used=now,
                )
                self._prefix_bytes += nbytes
        except Exception as e:  # recorded: /metrics last_worker_error
            self._note_error(e)

    def _prefix_register_paged(
        self, slot: Slot, ctx: list[int], b: int, key: tuple, now: float
    ) -> bool:
        """Zero-copy paged registration: pin the owner's full pages below
        ``b`` by refcount; a level that is not page-aligned also copies its
        partial tail page once (the owner keeps writing that page). The
        budget counts DISTINCT pinned pages, since levels of one context
        share their full pages. False stops the level walk."""
        sess = slot.psess
        if sess is None:
            return False
        full, tail_len = divmod(b, self.page_size)
        span = full + (1 if tail_len else 0)
        page_bytes = self._page_nbytes()
        nbytes = span * page_bytes
        if nbytes > self._prefix_budget or len(sess.pages) < span:
            return False
        full_pages = sess.pages[:full]

        def projected() -> int:
            pinned = self._prefix_pinned_page_ids()
            extra = sum(1 for p in full_pages if p not in pinned)
            return (len(pinned) + extra + (1 if tail_len else 0)) * page_bytes

        while projected() > self._prefix_budget and self._prefix_entries:
            self._prefix_evict_lru(now)
        tail_page = None
        if tail_len:
            # best effort without reclaim: pinning a prefix never evicts a
            # resident session
            try:
                tail_page = self._alloc_pages(1, pin=True)[0]
            except EngineOverloaded:
                return False
            self._copy_page(sess.pages[full], tail_page)
        pages = list(full_pages)
        with self._page_lock:
            for pid in pages:
                self._page_refs[pid] += 1
        self._prefix_entries[key] = PrefixEntry(
            kv=None, tokens=tuple(ctx[:b]), nbytes=nbytes, created=now, last_used=now,
            pages=pages, tail_page=tail_page, tail_len=tail_len,
        )
        self._recount_prefix_pinned()
        return True

    def _page_nbytes(self) -> int:
        return self.kv_arena_bytes // self._total_pages

    def _prefix_pinned_page_ids(self) -> set[int]:
        """Distinct pool pages the paged prefix cache pins."""
        pinned: set[int] = set()
        for e in self._prefix_entries.values():
            if e.pages is not None:
                pinned.update(e.pages)
                if e.tail_page is not None:
                    pinned.add(e.tail_page)
        return pinned

    def _recount_prefix_pinned(self) -> None:
        self._prefix_bytes = len(self._prefix_pinned_page_ids()) * self._page_nbytes()

    def _prefix_evict_lru(self, now: float | None = None) -> None:
        _, entry = self._prefix_entries.popitem(last=False)
        self._prefix_bytes -= entry.nbytes
        if entry.pages is not None:
            # unpin: sessions mapping these pages keep their own references
            for pid in entry.pages:
                self._decref_page(pid)
            if entry.tail_page is not None:
                self._decref_page(entry.tail_page)
            self._recount_prefix_pinned()
        self._count_eviction("prefix", (now or time.monotonic()) - entry.last_used)

    def _count_eviction(self, kind: str, idle_s: float) -> None:
        """One counter path for session and prefix-cache evictions, with
        the evictee's idle age."""
        if kind == "session":
            self.session_evictions += 1
            self.session_eviction_idle_s_recent.append(idle_s)
        else:
            self.prefix_evictions += 1
            self.prefix_eviction_idle_s_recent.append(idle_s)


def draft_from_hist(hist: torch.Tensor, hlen: torch.Tensor, k: int):
    """The in-loop drafter (the reference's ``draft_from_hist`` in
    ``_fused_fn``): match each lane's trailing 3-gram (else 2-gram) of its
    right-aligned history ``hist`` [B, W] (``hlen`` valid tokens) at the
    smallest distance d back, and draft the ``k`` tokens that followed the
    match (clamped at the newest). Returns (a match exists [B], d [B],
    drafts [B, k])."""
    w = hist.shape[1]
    dev = hist.device

    def match(n: int):
        d = torch.arange(1, w - n + 1, device=dev)
        idx = (w - n - d)[:, None] + torch.arange(n, device=dev)[None]
        m = (hist[:, idx] == hist[:, w - n :][:, None, :]).all(dim=-1) & (hlen[:, None] >= d[None] + n)
        return m.any(dim=1), d[m.long().argmax(dim=1)]

    any3, d3 = match(3)
    any2, d2 = match(2)
    dstar = torch.where(any3, d3, d2)
    gidx = torch.clamp((w - dstar)[:, None] + torch.arange(k, device=dev)[None], max=w - 1)
    return any3 | any2, dstar, hist.gather(1, gidx)


def _p50(xs) -> float | None:
    s = sorted(xs)
    return round(s[len(s) // 2], 2) if s else None


def _resolve(future: asyncio.Future, result: dict) -> None:
    if not future.done():
        future.set_result(result)


def _reject(future: asyncio.Future, error: Exception) -> None:
    if not future.done():
        if isinstance(
            error, (EngineShutdown, EngineOverloaded, PrefillFailed, RequestAborted, EngineDraining)
        ):
            future.set_exception(error)  # callers can catch the type
        else:
            future.set_exception(RuntimeError(f"engine worker error: {error}"))
