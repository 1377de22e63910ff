"""The engine's dispatch-ahead plumbing on the card: CUDA graphs of its step
functions, and pinned host transfers ordered by CUDA events.

Reference: ``agentainer_tpu/engine/llm.py`` — the jitted prefill, compiled
once per bucket shape (``self._prefill``), the compiled decode ladder
(``decode_n``, one jitted ``lax.scan`` per rung), the compiled verify step
per draft bucket (``_verify_fn``), all compiled at warmup, and the
asynchronous token readbacks of its worker loop (``_PIPELINE_DEPTH``). JAX
compiles a step once and dispatches it without Python; here a step is
captured once into a ``torch.cuda.CUDAGraph`` and replayed, which launches
its few thousand kernels without the host walking the model again. A
readback is a ``non_blocking`` copy into pinned host memory plus an event
recorded after it; the worker polls the event (``query``) instead of
blocking on the value.

- ``StepGraphs`` captures the engine's step functions into graphs that
  share one memory pool, after a warm eager call of each, and replays them.
  A kernel wrapper called under capture counts in ``.captured``
  (``ops/cuda_attention.py``); each graph keeps what its capture recorded
  and adds it to the wrappers' ``.launches`` at every replay. Replays and
  capture seconds are also kept per kind of step (a key's first field:
  ``prefill``, ``decode``, ``verify``).
- ``HostTransfers`` moves small arrays between the host and the engine's
  stream through pinned buffers: uploads stage into a buffer that is not
  rewritten until the event of its copy has landed, downloads land in a
  buffer the caller hands back once it has read it.
- ``LoopGraph`` is the fused decode loop on the card (the reference's
  ``lax.while_loop`` in ``_fused_fn``): one iteration's segments are
  captured as graphs of their own (``capture(kept=...)``) and assembled
  around CUDA conditional nodes by ``csrc/graph_loop.cu`` into one
  executable graph that loops while a device flag holds, up to a bound in
  device memory, with no host sync inside (PyTorch 2.11 exposes no
  conditional node to Python, so the assembly is a small C helper).
  ``run_loop_eager`` runs the same segments in a Python loop: the CPU's
  runner, and the card's while warmup serves and in ``compare_replay``.
- On the CPU (the caller asked for it) there are no graphs and no events:
  the engine runs the same step functions eagerly and ``LANDED`` stands in
  for an event, reporting every transfer as landed.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import gc
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.cuda_attention import (
    flash_decode,
    flash_prefill,
    fused_paged_flash_decode,
    fused_paged_flash_prefill,
)
from ..ops.cuda_quant import w8a16_grouped_matmul, w8a16_matmul

KERNEL_WRAPPERS = (
    flash_prefill, flash_decode, fused_paged_flash_prefill, fused_paged_flash_decode, w8a16_matmul,
    w8a16_grouped_matmul,
)


class _Landed:
    """The CPU's stand-in for a CUDA event: a CPU copy has landed when it
    returns."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


LANDED = _Landed()


class HostTransfers:
    """Pinned host buffers for the copies between the host and the engine's
    stream (the current stream of the calling thread), kept in free lists
    per (shape, dtype)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._free: dict[tuple, list[torch.Tensor]] = collections.defaultdict(list)
        # uploads whose copy may still be in flight: (buffer, event), oldest
        # first; a buffer goes back to its free list once its event landed
        self._staged: collections.deque = collections.deque()

    def _take(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        free = self._free[(shape, dtype)]
        return free.pop() if free else torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def give(self, buf: torch.Tensor) -> None:
        """Hand back a download's buffer (its event has landed and it has
        been read)."""
        self._free[(tuple(buf.shape), buf.dtype)].append(buf)

    def upload(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """Copy ``src`` into the device tensor ``dst`` in place, without
        waiting for the stream: through a pinned buffer that is not reused
        before the copy's event has landed."""
        if not self.cuda:
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
            return
        while self._staged and self._staged[0][1].query():
            self.give(self._staged.popleft()[0])
        buf = self._take(tuple(src.shape), dst.dtype)
        buf.numpy()[...] = src
        dst.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._staged.append((buf, event))

    def download(self, src: torch.Tensor):
        """Start copying the device tensor ``src`` to the host; returns (host
        buffer, event). The buffer holds ``src``'s values once the event has
        landed; ``give`` it back after reading it."""
        buf = self._take(tuple(src.shape), src.dtype)
        if not self.cuda:
            buf.copy_(src)
            return buf, LANDED
        buf.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event


class StepGraphs:
    """CUDA graphs of an engine's step functions, keyed by the engine's step
    keys, sharing one memory pool. ``capture`` raises if any step cannot be
    captured; ``replay`` raises for a key that was not captured. A loop
    (``build_loop``) is replayed under its own key, like a step."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self._capture_stream = torch.cuda.Stream(device)
        self._graphs: dict = {}
        self._loops: dict = {}
        self._loop_args: dict = {}
        self.replays = 0
        self.replays_by_kind: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        self.capture_s_by_kind: dict = {}
        self.pool_bytes = 0
        self.pool_bytes_by_kind: dict = {}

    def __len__(self) -> int:
        return len(self._graphs) + len(self._loops)

    def reset_replays(self) -> None:
        self.replays = 0
        self.replays_by_kind.clear()

    def capture(
        self, steps: dict, generator: torch.Generator, sampled: set, kept=frozenset()
    ) -> None:
        """Capture every ``steps[key]()`` into its graph. Each step runs once
        eagerly first (kernel builds, library handles, shared-memory limits
        and allocator growth happen outside capture); the steps in
        ``sampled`` draw from ``generator``, which is registered with their
        graphs so that every replay draws fresh numbers from its stream. The
        graphs of ``kept`` keys are segments of a loop (``build_loop``): they
        keep their CUDA graph for the loop to copy and are never replayed on
        their own. Records the capture's wall time and the pool's bytes, in all
        and per kind of step.

        The garbage collector is held off while capturing: a collection
        under capture may free CUDA objects of a dead engine, and a graph's
        teardown is refused while a stream captures, which invalidates the
        capture."""
        for fn in steps.values():
            fn()
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        by_kind: dict = collections.defaultdict(float)
        bytes_by_kind: dict = collections.defaultdict(int)
        try:
            for key, fn in steps.items():
                t_key = time.perf_counter()
                held = torch.cuda.memory_reserved(self.device)
                graph = torch.cuda.CUDAGraph(keep_graph=True) if key in kept else torch.cuda.CUDAGraph()
                if key in sampled:
                    graph.register_generator_state(generator)
                before = [w.captured for w in KERNEL_WRAPPERS]
                with torch.cuda.graph(
                    graph, pool=self.pool, stream=self._capture_stream,
                    capture_error_mode="thread_local",
                ):
                    out = fn()
                counts = [
                    (w, w.captured - n) for w, n in zip(KERNEL_WRAPPERS, before) if w.captured > n
                ]
                self._graphs[key] = (graph, out, counts)
                by_kind[key[0]] += time.perf_counter() - t_key
                bytes_by_kind[key[0]] += torch.cuda.memory_reserved(self.device) - held
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.capture_s_by_kind = dict(by_kind)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        # the pool's growth while each kind of step was captured (a later
        # capture reuses what an earlier one freed, so this is where the
        # bytes were first needed, not what each graph alone would take)
        self.pool_bytes_by_kind = dict(bytes_by_kind)

    def build_loop(
        self, key, prologue, plain, cont: torch.Tensor, pre=None, verify=None, post=None,
        tail=None, spec: torch.Tensor | None = None,
    ) -> None:
        """Assemble the loop ``key`` from captured segments (keys): each
        replay runs ``prologue`` (a plain graph: it may draw from the
        generator), then, while the device bool ``cont`` holds, ``pre``,
        ``verify`` if the device bool ``spec`` holds else ``plain``, then
        ``post`` (which rewrites ``cont``), and finally ``tail``, whose
        output is the replay's. Raises if the assembly fails. Its seconds
        count as capture seconds of the loop's kind."""
        t0 = time.perf_counter()
        self._assemble(key, prologue, plain, cont, pre, verify, post, tail, spec)
        self.capture_s += time.perf_counter() - t0
        self.capture_s_by_kind[key[0]] = (
            self.capture_s_by_kind.get(key[0], 0.0) + time.perf_counter() - t0
        )

    def _assemble(self, key, prologue, plain, cont, pre, verify, post, tail, spec) -> None:
        part = {
            name: self._graphs[k][0] if k is not None else None
            for name, k in (
                ("pre", pre), ("verify", verify), ("plain", plain), ("post", post), ("tail", tail)
            )
        }
        loop = LoopGraph(part, cont, spec)
        counts = {name: self._graphs[k][2] for name, k in (("plain", plain), ("verify", verify)) if k}
        self._loops[key] = (loop, prologue, self._graphs[tail][1], counts)
        self._loop_args[key] = (prologue, plain, cont, pre, verify, post, tail, spec)

    def rebuild_loop(self, key) -> None:
        """Assemble loop ``key`` again from its segments (a new executable
        graph). A profiler's device trace records the kernels of every
        loop iteration only for a loop graph instantiated after the
        profiler first came up in the process; one built before shows the
        first iteration's alone."""
        self._assemble(key, *self._loop_args[key])

    def add_loop_launches(self, key, plain_steps: int, verify_steps: int) -> None:
        """Add what one replay of loop ``key`` launched, read back from the
        device: its iterations of each branch times the branch's captured
        kernel calls."""
        counts = self._loops[key][3]
        for name, n in (("plain", plain_steps), ("verify", verify_steps)):
            for wrapper, c in counts.get(name, ()):
                wrapper.launches += c * n

    def replay(self, key):
        """Launch step ``key``'s graph (or loop) on the current stream;
        returns its output tensor, which the next replay of the same key
        overwrites. A loop's kernel calls depend on its data: the caller
        adds them once it has read the iterations back
        (``add_loop_launches``)."""
        if key in self._loops:
            loop, prologue, out, _ = self._loops[key]
            graph = self._graphs[prologue][0]
            graph.replay()
            loop.launch()
        else:
            try:
                graph, out, counts = self._graphs[key]
            except KeyError:
                raise RuntimeError(
                    f"no CUDA graph captured for step {key}: the engine was not warmed up"
                ) from None
            graph.replay()
            for wrapper, n in counts:
                wrapper.launches += n
        self.replays += 1
        self.replays_by_kind[key[0]] += 1
        return out


@functools.cache
def _loop_lib() -> ctypes.CDLL:
    """``csrc/graph_loop.cu``'s library, built on first use."""
    lib = _build.library("graph_loop")
    vp = ctypes.c_void_p
    lib.atpu_loop_build.argtypes = [vp] * 7 + [ctypes.POINTER(vp), ctypes.POINTER(vp)]
    lib.atpu_loop_build.restype = ctypes.c_int
    lib.atpu_loop_launch.argtypes = [vp, vp]
    lib.atpu_loop_launch.restype = ctypes.c_int
    lib.atpu_loop_destroy.argtypes = [vp, vp]
    lib.atpu_loop_destroy.restype = ctypes.c_int
    lib.atpu_loop_error_string.argtypes = [ctypes.c_int]
    lib.atpu_loop_error_string.restype = ctypes.c_char_p
    return lib


class LoopGraph:
    """An executable CUDA graph that runs one iteration's captured segments
    while a device flag holds (``csrc/graph_loop.cu``): ``set(cont) ->
    WHILE { pre -> IF(spec) verify | IF(!spec) plain -> post -> set(cont) }
    -> tail``. The segments enter as copies of their graphs; the captured
    graphs are kept alive with the loop, since their pool blocks are the
    loop's memory."""

    def __init__(self, parts: dict, cont: torch.Tensor, spec: torch.Tensor | None):
        lib = _loop_lib()
        vp = ctypes.c_void_p

        def raw(name):
            g = parts.get(name)
            return vp(g.raw_cuda_graph()) if g is not None else None

        exec_, graph = vp(), vp()
        err = lib.atpu_loop_build(
            raw("pre"), raw("verify"), raw("plain"), raw("post"), raw("tail"),
            vp(cont.data_ptr()), vp(spec.data_ptr()) if spec is not None else None,
            ctypes.byref(exec_), ctypes.byref(graph),
        )
        if err:
            raise RuntimeError(f"loop graph assembly failed: {lib.atpu_loop_error_string(err).decode()}")
        self._lib, self._exec, self._graph = lib, exec_, graph
        self._parts = parts
        self._flags = (cont, spec)
        self.device = cont.device

    def launch(self) -> None:
        err = self._lib.atpu_loop_launch(
            self._exec, ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream)
        )
        if err:
            raise RuntimeError(f"loop graph launch failed: {self._lib.atpu_loop_error_string(err).decode()}")

    def __del__(self):
        try:
            self._lib.atpu_loop_destroy(self._exec, self._graph)
        except Exception:
            pass


def run_loop_eager(cont, plain, pre=None, verify=None, post=None, spec=None) -> None:
    """A ``LoopGraph``'s iterations run eagerly, from the same segment
    functions: while ``cont`` holds, ``pre``, then ``verify`` if ``spec``
    holds else ``plain``, then ``post``. Reading the flags is a host sync on
    the card; the CPU's engine and the card's eager runs (warmup,
    ``compare_replay``) use it."""
    while bool(cont):
        if pre is not None:
            pre()
        if verify is not None and bool(spec):
            verify()
        else:
            plain()
        if post is not None:
            post()


def compare_replay(graphs: StepGraphs, key, step, state: list, generator: torch.Generator) -> dict:
    """Step ``key`` as its graph replay against ``step()`` run eagerly, from
    one saved state: ``state`` lists every device tensor the step reads or
    writes (carry, static inputs, KV arena or pools), all restored after.
    Returns whether the outputs and every state tensor came out equal bit for
    bit, and whether a second replay from the same state and generator state
    repeats the first (the sampled steps' reproducibility)."""
    saved = [t.clone() for t in state]
    rng = generator.get_state()

    def restore():
        for t, s in zip(state, saved):
            t.copy_(s)
        generator.set_state(rng)

    eager = step().clone()
    eager_state = [t.clone() for t in state]
    restore()
    first = graphs.replay(key).clone()
    same_state = all(torch.equal(a, b) for a, b in zip(state, eager_state))
    del eager_state
    restore()
    second = graphs.replay(key).clone()
    restore()
    torch.cuda.synchronize(graphs.device)
    return {
        "tokens_equal": torch.equal(first, eager),
        "state_equal": same_state,
        "replay_repeats": torch.equal(first, second),
    }


def live_lanes(
    engine, positions: list[int], temperature: float, seed: int, prefill_lane: int = 1
) -> None:
    """Give an idle engine a live state to hold a step graph against its
    eager step (``compare_replay``): lanes 0.. decode from ``positions``
    with random tokens at ``temperature``, every verify bucket holds random
    drafts of mixed lengths, the prefill inputs hold random tokens for lane
    ``prefill_lane`` from its position with a final chunk shorter than the
    smallest bucket, and, paged, each live lane's blocks up to what a verify
    round or a prefill chunk from its position writes map distinct free
    pages. ``park_lanes`` undoes it."""
    g = np.random.default_rng(seed)
    vocab = engine.cfg.vocab_size
    with torch.no_grad(), engine._on_stream():
        for i, p in enumerate(positions):
            engine._inject_lane(i, int(g.integers(vocab)), p, temperature, 0, 1.0)
        # parked lanes draft nothing, as in the engine's rounds
        lengths = np.array([
            (i * 3) % (engine.spec_gamma_max + 1) if i < len(positions) else 0
            for i in range(engine.max_batch)
        ])
        for k, drafts in engine._vdrafts.items():
            engine._xfer.upload(drafts, g.integers(vocab, size=(engine.max_batch, k)))
        engine._xfer.upload(engine._vdlen, lengths)
        meta = g.integers(vocab, size=engine._pinput.shape)
        meta[:3] = (positions[prefill_lane], engine._prefill_buckets[0] - 5, prefill_lane)
        engine._xfer.upload(engine._pinput, meta)
        if engine.paged:
            span = max(engine._prefill_buckets[-1], engine.spec_gamma_max + 1)
            with engine._page_lock:
                free = list(engine._page_free)
                for i, p in enumerate(positions):
                    # the blocks a verify round or a prefill chunk from p
                    # may write
                    n = min((p + span) // engine.page_size + 1, engine._n_blocks)
                    engine._bt[i, :n], free = free[:n], free[n:]
            engine._sync_table()
            engine._pbt.copy_(engine._dbt[prefill_lane : prefill_lane + 1])


def park_lanes(engine) -> None:
    """Park every lane and the prefill inputs, and point every block-table
    row at its lane's scratch page again."""
    with torch.no_grad(), engine._on_stream():
        for i in range(engine.max_batch):
            engine._park_lane(i)
            if engine.fused_decode:
                engine._inject_lane(i, 0, engine.scratch_pos, 0.0, 0, 1.0, staged=True)
        if engine.fused_decode:
            engine._finput.zero_()
            if engine.paged:
                with engine._page_lock:
                    engine._bt[i, :] = engine._scratch_page(i)
        engine._sync_table()
        engine._park_prefill_inputs()


def live_fused(
    engine, positions: list[int], temperature: float, seed: int, nsteps: int,
    budgets: list[int] | None = None, armed_lane: int | None = None,
) -> None:
    """Give an idle fused engine a live loop state (after ``live_lanes``
    with the same positions, temperature and seed): histories that repeat
    with period 8, each live lane's carry token their newest, so the
    in-loop drafter matches at the first iteration, the loop inputs (lanes 0.. live
    with ``budgets``, default the loop's most, bound ``nsteps``) and, with
    ``armed_lane``, that lane armed from a shadow carry at position
    ``positions[0] + 7``. ``park_lanes`` undoes the carry; the next
    dispatch rewrites the inputs."""
    g = np.random.default_rng(seed)
    b, w = engine.max_batch, engine._dhist.shape[1]
    vocab = engine.cfg.vocab_size
    cap = engine._fused_cap
    pattern = g.integers(vocab, size=8)
    hist = np.tile(pattern, (b, w // 8 + 1))[:, :w]
    hlen = np.array([w if i % 2 == 0 else 20 for i in range(b)])
    meta = np.zeros((4 * b + 1,), dtype=np.int64)
    for i in range(len(positions)):
        meta[b + i] = 1
        meta[2 * b + i] = budgets[i] if budgets is not None else cap + 1
    meta[4 * b] = nsteps
    with torch.no_grad(), engine._on_stream():
        engine._xfer.upload(engine._dhist, hist)
        engine._xfer.upload(engine._dhlen, hlen)
        # each live lane's carry token is its history's newest token
        engine._xfer.upload(engine._dtok[: len(positions)], hist[: len(positions), -1])
        if armed_lane is not None:
            meta[armed_lane] = 1
            engine._inject_lane(
                armed_lane, int(g.integers(vocab)), positions[0] + 7, temperature, 0, 1.0,
                hist[armed_lane], w, staged=True,
            )
        engine._xfer.upload(engine._finput, meta)
