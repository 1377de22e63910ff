"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, all of them on every run, in order (any failure raises; the script then
exits non-zero):

1. build       — compile the kernels of ``agentainer_tpu_torch/csrc`` with
                 nvcc and load them, and build the native store and data
                 plane (``native/*.cc``, g++) into ``_build/``, all at once;
                 print the card's name and power limit as nvidia-smi
                 reports them.
1c. tokenizer  — the Llama-3-style fixture
                 (``tests/fixtures/llama3_style_tokenizer.json``) through
                 the port's ``load_tokenizer`` on this machine's Python, in
                 a fresh interpreter where ``tokenizers`` and ``regex``
                 cannot be imported: its ids on
                 the committed strings equal those ``tokenizers`` 0.22.2
                 gave (committed beside it), and decode ∘ encode gives each
                 string back (less the specials and a lone "!", pad id 0,
                 which the reference's decode drops); prints this Python's
                 ``unicodedata`` version.
2. kernels     — each hand-written kernel against its plain PyTorch version
                 at the llama3-8b attention shapes of the serving path (H 32,
                 KV 8, head_dim 128; the paged ones on the served pool
                 [264, 64, 8, 128] through a scrambled block table with a
                 shared page and a parked lane): in bf16 within one bf16
                 rounding of the plain output (plus the stated P rounding
                 for the tensor-core prefill), and on the same inputs in f32
                 within 2e-5 (the dense prefill also as the engine's
                 prefill graphs call it: the whole [8, 2048] arena with the
                 slot's row in device memory, bit-equal to the call on the
                 row's view); kernel / plain / library times in bf16 (device
                 span of single calls in a torch.profiler trace, with a cold
                 L2, in turns, median and spread; for the paged kernels,
                 which no single library call computes, gather + SDPA as a
                 yardstick), the decode rows also at the served mix of 2
                 live and 6 parked lanes, the prefill rows also at the verify
                 rounds of speculative decoding (q [8, K+1] for K = 8, 2, 4,
                 the same mix), the least time the card could take, each
                 kernel's device launches per call counted in the trace, and
                 the card's SM clock and power draw sampled while each row
                 runs.
2b. int8 kernel — ``w8a16_matmul`` (``csrc/w8a16_gemm.cu``) against its
                 plain PyTorch version at every (K, N) of llama3-8b's and
                 bench-1b's weights for M = 1, 8, 9, 24, 40, 72, 255, 256
                 and 300 (decode, the verify rounds, a prefill chunk, ragged
                 counts on both sides of the token tiles), random int8
                 weights and scales from a seeded generator, within one bf16
                 rounding, two calls bit-equal; timed at M = 8, 72 and 256 at
                 every llama3-8b (K, N) beside its bound, the plain version,
                 the bf16 cuBLAS product of the dense weight (the product
                 int8 replaces), ``x @ dequant(w)`` (what the port would run
                 without the kernel) and, where this torch build has it for
                 CUDA, ``torch._weight_int8pack_mm``, with one device launch
                 per call; then the wrapper's host cost per call at M = 8
                 beside the bf16 product's (``host_cost``: host clock with
                 the device held, and CUDA events back to back; no
                 profiler).
3. serve       — the port's standard-library ``llm_serve`` on a local port
                 with ``llama3-8b`` at full width and depth, bf16, random
                 weights from a seeded generator, with prefix cache,
                 speculation and deadlines off; /chat requests over three
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
5. features    — the reference's defaults (prefix cache, speculation,
   (dense,       deadlines) with a persona, dense and then paged: a
   then paged)   sequential script (fresh sessions fork the persona; a JSON
                 tool-call loop and two one-byte runs, which the random
                 model repeats, speculate), a deadline passing while all 8
                 lanes are busy (504, no prefill), ``POST /cancel`` of an
                 in-flight request (499, its lane free for a newcomer), a
                 burst past the shed watermark (429s, the rest 200). The
                 prefill kernel's launches equal 32 layers × (prefill chunks
                 + verify rounds); the dense and paged scripts give the same
                 text.
   stream      — inside each feature phase (the engines run with the
                 ``streaming`` option): one streamed /chat whose ids run
                 0..n-1 and whose joined deltas and ``done`` equal the
                 buffered /chat of the same prompt in another session,
                 with the buffered request's host syncs.
   graphs      — inside each feature phase, after its served gates, on
                 the same engine (llama3-8b, full width and depth, bf16):
                 from one saved state with lanes 0-3 live at 40 / 300 / 777
                 / 1500 and lanes 4-7 parked and the prefill inputs set for
                 lane 1 from 300, every captured step graph (prefill
                 buckets 32/64/128/256, decode rungs 1/2/4/8 and verify
                 buckets K 2/4/8) against its eager step function: greedy
                 tokens or logits, carry, verify and prefill inputs, block
                 tables and KV arena or pool bytes equal bit for bit;
                 sampled, two replays from one generator state give the
                 same tokens.
   contracts   — inside the two bf16 feature phases, after ``graphs``, on
                 the same engine: the script's second pass (fresh sessions)
                 under ``capture_budget(engine, 0)``, ``buffers_in_place``
                 and ``no_implicit_sync`` (``analysis/contracts.py``); then
                 every captured step's device launches in one traced
                 replay (``launches_per_replay``): the arena's attention
                 wrapper 32 layers × its launches per call (decode 2,
                 prefill 1) × the step's forwards (a decode rung's steps; 1
                 for a prefill bucket or a verify round), no other kernel
                 of the table; printed per step key.
   main extras — on the dense bf16 feature engine only: it samples through
                 ``approx_topk`` (three sampled /generate requests), serves
                 ``/profile`` while a long /chat decodes (the trace names
                 the port's kernels), and an ``assistant``-flavor app
                 attached to it (no second load) serves two turns.
   int8        — the feature phases again with ``quant: int8, synthetic:
   (dense,       true`` (int8 weights drawn on the card), dense then paged,
   then paged)   at 8 of llama3-8b's 32 layers: the same gates, plus
                 ``param_hbm_bytes`` = 2,796,595,712 (8,033,544,704 at 32),
                 ``w8a16_matmul`` launched 7 per layer + 1 per forward (57
                 at 8 layers) through the graph replays and no other weight
                 product, the same greedy text for one prompt in two fresh
                 sessions; peak device memory beside the bf16 phases'.
6. checkpoint  — the dense phase's weights (seed 0, bf16) transposed back
                 to HF's [out, in] and written as a llama3-8b HuggingFace
                 checkpoint into a temporary directory (4 safetensors
                 shards written with the standard library, an index, the
                 published config.json; 16.06 GB; the phase fails naming
                 the free bytes when the disk lacks the room), then served
                 through ``AGENTAINER_CHECKPOINT`` with the features off:
                 the four requests must give the dense phase's greedy text;
                 load seconds, bytes read and GB/s printed beside the card.
                 Then the first request once more on the same engine, in a
                 fresh session, through the fixture's tokenizer (swapped in
                 for that turn): the ids 7e's agent must give.
   int8 ckpt   — that checkpoint served with ``quant: int8`` (quantized as
                 it streams) and, after it, a ``quant: int8`` engine from the
                 seed-0 random init: the two int8 trees bit-equal leaf by
                 leaf, and the four requests' greedy text equal.
7. resume      — crash-resume across arenas from that checkpoint, with the
                 reference's default features: a dense engine serves turn
                 one of session s, snapshots it and shuts down; a paged
                 engine serves turns one and two of session u (a snapshot
                 of u after turn one), restores s and serves its turn two.
                 Gates: s's turn two equals u's (on a difference the logit
                 gap at the diverging token is printed), the two blobs'
                 payloads are bit-equal, the restore binds no lane, all four
                 kernels launch. Blob bytes, stage, pack and restore ms
                 printed. The directory stays until 7e has deployed it.
7b. daemon     — the control plane on the card: the port's daemon
                 (``python -m agentainer_tpu_torch.daemon``, standard
                 library only) as a child process with ``mem://`` (so the
                 Python front door); a deploy
                 asking for more GPUs than the card's count fails with the
                 scheduler's 409; two ``llm:llama3-8b`` agents with
                 different personas (full width and depth, random bf16
                 weights from seed 0, the reference's default features)
                 become tenants of one engine host on GPU 0 (the daemon's
                 only child with a CUDA context; the daemon has none;
                 nvidia-smi's compute apps agree where they show this pid
                 namespace); the host's card memory under twice the 16.06
                 GB of weights. Through the journaled proxy, sessions A and
                 B of the first agent run the same two greedy turns
                 (max_tokens 32) and A its third; once B's snapshot has
                 landed in the store, one-token /generate probes time the
                 proxy against the tenant's own port; the host is SIGKILLed; B's
                 third turn answers 202; resume; the replay drains. Gates:
                 B's replayed turn equal to A's undisturbed one,
                 ``kv_restores`` >= 1, no 5xx, no request run twice (no
                 retry, pending 0, three user turns in B's history), the
                 dense kernels launched in the respawned host and the
                 paged ones not. Printed beside the card: start → ready
                 seconds (first boot and respawn), crash → replayed
                 seconds, the proxy's overhead, the snapshot's bytes and
                 ms, store writes per journaled request (counted in this
                 process), the host's card memory.
7c. fleet      — the replica fleet on the card, after 7b's daemon and host
                 are gone: the daemon (``mem://``) with ``ATPU_STREAMING=1``, one
                 ``llm:llama3-8b`` agent deployed with ``"replicas": 2``
                 (full width and depth, random bf16 weights from seed 0,
                 the reference's default features): two engine hosts on GPU
                 0, one per replica, the daemon with no CUDA context, each
                 host under twice the weights (nvidia-smi per pid where it
                 sees this pid namespace, else the card's new memory less
                 one host's weights). At least 8 fresh sessions reach both
                 replicas (power of two choices); both hosts launched the
                 dense kernels and no paged one; a session's second turn
                 stays on its replica. Sessions T and S run the same first
                 turn (under 64 tokens, as 7b), T its 96-token second turn;
                 once S's snapshot has landed, S's second turn streams and
                 its replica's host is SIGKILLed after 8 token frames. On
                 its one connection the client sees ids 0..n-1, one done,
                 and T's token ids (on a difference the logit gap is
                 printed); ``stream_failovers_total`` >= 1, the survivor's
                 ``kv_restores`` >= 1, S's entry completed at offset n-1 on
                 the survivor with no retry, no 5xx; a buffered /chat right
                 after the kill on a session pinned to the dead replica
                 answers 200 from the survivor; the monitor counts the
                 death and the fleet is back at two loaded replicas.
                 Printed beside the card: boot seconds, host memory, the
                 failover gap, frame gaps and the engines' ITL p50 before
                 and after the splice, the survivor's restore ms, kill →
                 SUSPECT and kill → DEAD seconds, respawn seconds.
7d. native     — the daemon's default deployment, after 7c's are gone:
                 ``store_url`` auto in a fresh data directory, so the C++
                 store with its append-only file and the C++ front door on
                 the public port (the start line must say ``store
                 native://…/store.aof; data plane native``), one
                 ``llm:llama3-8b`` agent (full width and depth, random bf16
                 weights from seed 0, the reference's default features,
                 ``ATPU_STREAMING=1``, one replica) whose host reaches the
                 store over the unix socket. Through the C++, A's three and
                 B's two greedy turns (7b's, as ``stream: true`` bodies the
                 C++ answers buffered: whole, with a length and the
                 journal's request id); the journal's completed count equals
                 the calls sent and the C++ counters count them; a streamed
                 turn (C) arrives whole with A's first ids and a ``done``
                 equal to a buffered /chat's (D); /generate probes time the
                 front door. The host SIGKILLed, B's third turn journaled by
                 the C++ (202), resume, the replay equal to A's third turn
                 (``kv_restores`` ≥ 1, no retry). A's fourth turn; the
                 daemon SIGKILLed (its host too, if it outlives it); a new
                 daemon on the same directory lists the agent, with the
                 journal's stats as before; after resume B's history holds
                 three user turns and B's fourth turn, restored from the
                 AOF's snapshot, equals A's; the host launched the dense
                 kernels and no paged one; no 5xx. Printed beside the card:
                 boot seconds (first, respawn, after the restart), crash →
                 replayed seconds, the front door's overhead beside 7b's
                 through Python in the same run, the snapshot's bytes and
                 store ms over the socket beside 7b's over HTTP, the AOF's
                 bytes, restart → listed seconds.
7e. operator   — the operator's tooling, after 7d's daemon is gone, in
                 the same native deployment (``ATPU_STREAMING=1``), driven
                 through the port's CLI as a subprocess: ``deploy
                 --model-dir`` of a sibling of phase 6's checkpoint
                 directory (symlinks to its files plus the fixture's
                 ``tokenizer.json``; features off) prints the build log and
                 ``built artifact 'op'``, ``models`` lists it as ``hf`` with
                 its parameters, and after ``start`` (the host reads the
                 tokenizer.json with the port's reader) the first of phase
                 6's requests through the C++ gives the ids phase 6's engine
                 gave through the same tokenizer, its prompt tokens the
                 reader's count plus bos. A session of two 48-token turns
                 past 700 positions (turn one sized in the fixture's tokens,
                 its prompt tokens the reader's count plus bos): its
                 snapshot, above the store socket's 64 MiB
                 frame cap, lands over HTTP with no snapshot error. ``backup
                 create`` after it, ``backup list``, a third turn T3 on the
                 original, ``backup export -o`` (the tar.gz holds the
                 manifest), ``stop``, ``backup restore``, ``start
                 op-restored``: T3 on the restored agent equals the
                 original's token for token, restored from the copied KV
                 (``kv_restores`` ≥ 1, the snapshot's bytes, the same
                 prompt tokens). ``deploy -f`` of a JSON deployment (no
                 PyYAML on the card) with a ``${VAR}`` starts two echo agents
                 in dependency order, both answering 200; ``audit`` shows
                 ``artifact-build``, ``backup-create`` and
                 ``backup-restore``; ``faults``, ``slice``, ``health``,
                 ``metrics`` and ``logs`` exit 0. No 5xx, no CUDA context in
                 the daemon, the dense kernels launched in both hosts and no
                 paged one. Printed beside the card: the artifact build ms
                 (``POST /artifacts``, headers only), deploy → ready seconds,
                 the snapshot's bytes, path and store ms, backup create /
                 export / restore seconds, the manifest's bytes, restore →
                 first restored token ms (store read + restore + TTFT), the
                 CLI's overhead per call beside the API's. Phase 6's
                 directory is removed after it.
8. model       — ``forward`` logits with the kernels against ``forward``
                 with the plain attention path, and the paged ``forward``
                 (kernels, scrambled block table) against the dense one,
                 llama3-8b width at 2 layers, in bf16 and in f32 (TF32 off);
                 a verify forward at [8, 9] against 9 one-token decode
                 steps, and a tail prefill after a prefix fork against the
                 full prefill, at the same tolerances; in bf16 the first
                 index where greedy decoding through verify rounds leaves
                 the plain stream (reported, not gated). Then the same
                 2-layer model in int8: logits with ``w8a16_matmul`` against
                 the kernel's plain version (``qmatmul`` forced to it), bf16,
                 within 3e-2 of the largest logit.

9. fused      — the fused on-device decode loop, at full width and depth:
   dense         the serve phase's options plus ``fused_decode`` (no
                 speculation, so every iteration is the ladder's [8, 1]
                 decode step): the four requests give the serve phase's
                 greedy text token for token; one host readback per loop
                 (``host_syncs_total`` = first tokens + loops) and
                 ``host_syncs_per_token`` beside the serve phase's; an
                 early exit in the served counters (a 4-token request) and
                 on the device (a replay whose one lane freezes at 3 of 32
                 iterations launches the decode kernel and its combine
                 32 × 3 times in a profiler trace).
   paged         the feature phase's options (paged) plus ``fused_decode``
                 with in-loop spec: the feature gates, in-loop drafts
                 accepted on the one-byte runs, a lane absorbed into a loop
                 in flight (``fused_injections_total``), the prefill kernel
                 at 32 × (chunks + verify iterations); the first index where
                 the script's text leaves the unfused paged phase's is
                 reported, not gated.
   graphs        inside both, and on the 2-layer int8 model as a fused
                 engine (``w8a16_matmul`` inside the conditional bodies):
                 each loop graph (greedy, sampled) against the eager loop
                 over the same segments from one saved state — lanes 0-2
                 live (lane 1 with a budget of 9), lane 3 armed from the
                 shadow carry, repeating histories: packed readback, carry,
                 history, loop state and KV bytes equal bit for bit
                 (greedy), two replays equal (sampled); capture seconds and
                 pool bytes printed.
10. tiering    — the reference's defaults plus ``kv_tiering``, llama3-8b
                 at 8 of 32 layers:
   paged         ``tier_quantize`` 0, a 64-page pool (128 MiB): a control
                 session's two turns; another session parked (``/park``:
                 its own pages leave the pool, it stays known), prewarmed
                 (``/prewarm``) and its turn two equal to the control's;
                 16 sessions of ~300 tokens in sequence: no 429, no
                 destructive eviction, ≥ 4 pressure demotions, and the first
                 of them served turn two through a promotion, equal to the
                 control's.
   dense         ``tier_quantize`` 1: a parked and prewarmed session's KV
                 within half a quantization step of each page's scale (plus
                 the bf16 rounding) of the parked exact bytes; the numpy
                 quantizer's ms on a 2,048-token session. Every park's and
                 promotion's bytes, ms and GB/s beside the card.

11. moe        — Mixtral-8x7B (E 8, top-2, D 4096, F 14336):
   (a) grouped   ``w8a16_grouped_matmul`` (``csrc/w8a16_gemm.cu``, every
                 expert of a stack in one launch) against its plain version
                 at E = 8 and Mixtral's (K, N) — (4096, 14336) with one x
                 shared by the experts, (14336, 4096) with one x per expert
                 — for M = 1, 8, 9, 24, 72, 128, 255, 256, 300, within one
                 bf16 rounding, two calls bit-equal; timed at M = 8, 72 and
                 256 beside its bound, the plain version, the bf16 cuBLAS
                 batched product over the dense expert stack (the product
                 int8 replaces) and ``x @ dequant(w)`` over the stack, with
                 one device launch per call.
   (b) block     ``_moe_mlp`` and ``_moe_mlp_routed`` (dropless ``cf`` 4.0)
                 of one Mixtral layer on the same ``h`` (a 256-token chunk
                 and an 8-lane decode step): int8 weights, the grouped
                 kernel against its plain version, bf16, within 3e-2 of the
                 largest output; dense f32 weights on the card against the
                 same function on the CPU, within 2e-4 (TF32 off), tokens
                 routed differently by the two left out and counted.
   (c) model     a 2-layer Mixtral-width model: logits with the attention
                 kernels against the plain attention path in bf16 and f32
                 (``F32_LOGIT_TOL`` / ``BF16_LOGIT_TOL``), then in int8 with
                 the grouped kernel and ``w8a16_matmul`` against their plain
                 versions; a token the two paths route to other experts in
                 any layer is counted and printed, and its sequence is
                 compared up to it (later tokens attend to its K/V).
   (d) served    Mixtral-8x7B at full width and 8 of 32 layers, int8,
                 synthetic, seed 0, with the reference's defaults, after
                 every earlier engine is gone: the feature phase's script
                 and gates on the dense arena with the dense-einsum MoE,
                 then on the paged arena (page size 64) with ``routed:
                 true, moe_cf: 4.0``; per forward 33 ``w8a16_matmul`` calls
                 (4 per layer + lm_head) and 24 ``w8a16_grouped_matmul``
                 calls (gate, up, down per layer); ``param_hbm_bytes``
                 11,876,809,344 (46,720,564,224 at 32 layers);
                 ``moe_routed`` as asked; every step and prefill graph equal
                 to its eager step. The first index where the routed paged
                 engine's text leaves the dense one's is printed, not gated.
   (e) fused     the 2-layer Mixtral-width model in int8 as a fused engine:
                 each loop graph bit-equal to its eager loop, the grouped
                 kernel inside the conditional bodies.

12. train      — the port's one-device training step (``train.py``), after
                 every engine is gone; f32, AdamW at lr 3e-4, wd 0.01:
   (a) seam      ``trainable_causal_attention`` at q [2, 2048, 32, 128], k/v
                 [2, 2048, 8, 128], f32 and bf16: the forward (one prefill
                 launch) against ``flash_prefill_plain`` at the kernel
                 phase's tolerances (bf16: with the P-rounding bound 2**-9
                 max|v| in place of ``BF16_P_ATOL``, since rows from
                 position 0 see few slots), dq/dk/dv (no launch) against autograd
                 through ``attention_reference`` (f32 within 1e-6); the f32
                 kernel timed beside its bound (over the f32 peak: the
                 CUDA-core body), its plain version and SDPA, in turns, by
                 CUDA events (the profiler's trace of this row loses
                 records).
   (b) paths     a 2-layer llama3-8b-width model, one set of params: one
                 ``step_fn`` step (the kernel forward) against the same
                 AdamW step through ``attn_impl=None``: losses within 2e-4,
                 gradients within 2e-4 of each leaf's largest, updated
                 leaves within 1% of a step where the gradient is clear of
                 zero and 2 lr where it is not.
   (c) run       llama3-8b at full width, 8 of 32 layers (f32 AdamW keeps
                 16 B a param: 128.5 GB at full depth), B 2 x T 2048, one
                 repeated batch of random tokens (seed 0), 10 steps through
                 ``make_train_step``: every loss finite, the last below the
                 first, the prefill kernel launched exactly 8 x 10 times and
                 no other kernel; step ms p50 (CUDA events), forward /
                 backward / optimizer ms from 2 more steps built from the
                 same pieces, tokens/s, peak memory beside the AdamW state.
   (d) moe       Mixtral-8x7B at full width, 1 layer, B 1 x T 2048, 3 steps:
                 losses finite and falling, 3 batched ``torch.matmul`` expert
                 products per layer per step over the f32 stacks, no int8
                 kernel; step ms and peak memory.

The int8 feature phases (5's int8 pair), the tiering phases (10) and
Mixtral's served phases (11d) are off the native slice's path and run at
``CUT_LAYERS`` (8) of 32 layers, widths kept; their gates count per layer
(launches, and ``param_hbm_bytes`` from ``CUT_PARAM_BYTES``) or in pages. Each phase's seconds are
in ``report["phase_s"]``.

Every served phase runs on the engine's CUDA graphs with pipelined
readbacks, and must replay graphs (``graph_replays`` > 0); every prefill
chunk is one prefill graph replay (``prefill_graph_replays`` =
``prefill_chunks``), and each phase reports its prefill graphs' replays and
capture seconds and its engine-up seconds.

Stdout ends with five lines: each served phase's pipeline numbers (graph
replays, ``host_syncs_per_token``, ITL and TTFT p50, graph capture seconds
and pool bytes; JSON), the served paths', the checkpoint plane's and the
model check's numbers (JSON), the card's name and power limit, a JSON object listing every kernel,
and ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is visible or the port's package is missing.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import contextlib
import faulthandler
import gc
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet)
PEAK_HBM_BPS = 3.35e12
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (the f32 prefill body's)
# Kernel against plain: both accumulate in f32 and round once to q's dtype,
# so in bf16 they may differ by one rounding (<= 2**-7 * |plain|) and in f32
# by summation order only (the repo's f32 kernel tolerance,
# tests/test_pallas_attention.py). Products run with TF32 off (set in main).
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-4
# The bf16 prefill kernels run P·V on the tensor cores with P rounded to bf16
# (the plain version keeps P in f32): at the served chunk that adds up to
# ~8e-4 before the output's rounding, as measured on the CPU by
# tests/test_torch_attention.py::test_bf16_p_rounding_error_at_the_served_prefill_shape.
# The prefill rows add this to their bf16 atol; decode rounds nothing.
BF16_P_ATOL = 1e-3
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
# the timed decode positions: 8 lanes spread over the arena with one parked,
# and the served step's mix of 2 live lanes near 300 and 6 parked at S - 1
MIXED_POS = (0, 17, 130, 511, 777, 1024, 1500, S - 1)
SERVED_MIX_POS = (299, 312, *(S - 1,) * 6)
# verify rounds of self-speculative decoding: the prefill kernels at
# [B, K + 1] for the verify buckets K, lanes 0-1 live from 299 / 312, lanes
# 2-7 parked with every row at S - 1
VERIFY_KS = (8, 2, 4)
YARDSTICK = "gather_pages + scaled_dot_product_attention"
# the four requests both serve phases send: (session, message)
REQUESTS = (
    ("a", "Hello! Summarize the plot of a heist movie in one line."),
    ("a", "Now tell it as a haiku."),
    ("b", "List three prime numbers and explain why they are prime."),
    ("c", "List three prime numbers and explain why they are prime."),
)


# the int8-weight GEMM: llama3-8b's weights and their (K, N); bench-1b's
# (K, N); the rows a product takes (decode, verify K = 2 / 4 / 8, a prefill
# chunk, and ragged counts on both sides of the token tiles), and the rows
# timed (decode, the largest verify round, a prefill chunk)
W8_WEIGHTS = {
    "wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
    "w_gate": (4096, 14336), "w_up": (4096, 14336), "w_down": (14336, 4096),
    "lm_head": (4096, 128256),
}
BENCH_1B_KN = ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048), (2048, 32000))
W8_MS = (1, 8, 9, 24, 32, 40, 64, 72, 255, 256, 300)
W8_TIMED_MS = (8, 72, 256)
HOST_CALLS = 200  # calls per host-cost loop
# kernel against plain: both sum in f32 and round once to bf16, so they may
# differ by one bf16 rounding plus the f32 sum-order error (<< 1e-4 here)
W8_RTOL, W8_ATOL = 2.0**-7, 1e-4
W8_SOURCE = "agentainer_tpu_torch/csrc/w8a16_gemm.cu"
# not a pallas_call: XLA's fused convert + dot of x @ dequant(w)
W8_REPLACES = "agentainer_tpu/ops/quant.py:40"
INT8 = {"quant": "int8", "synthetic": True}
INT8_PARAM_BYTES = 8_033_544_704  # llama3-8b's int8 tree (the reference's, jax.eval_shape)
W8_PER_LAYER = 7  # wq, wk, wv, wo, w_gate, w_up, w_down; + lm_head per forward

# the MoE phase: Mixtral-8x7B; its expert stacks (K, N, one x per expert),
# the rows the grouped kernel is checked and timed at, and what it replaces
# (not a pallas_call: XLA's int8 convert fused into the expert einsums,
# agentainer_tpu/models/llama.py:143-145 and :229-231)
MIXTRAL = "mixtral-8x7b"
MOE_E = 8
MOE_STACKS = {"w_gate/w_up": (4096, 14336, False), "w_down": (14336, 4096, True)}
MOE_MS = (1, 8, 9, 24, 32, 40, 64, 72, 128, 255, 256, 300)
MOE_TIMED_MS = (8, 72, 256)
MOE_REPLACES = "agentainer_tpu/models/llama.py:143"
MOE_PARAM_BYTES = 46_720_564_224  # Mixtral-8x7B's int8 tree (the reference's, jax.eval_shape)
# The int8 served phases, off the native slice's path, run at 8 of 32 layers
# (widths kept): the port's synthetic int8 tree at 8 layers, by
# param_bytes_actual(synthetic_quantized_params(cfg, device="meta")) on the
# CPU, which gives the two full-depth numbers above at 32
CUT_LAYERS = 8
CUT_PARAM_BYTES = {"llama3-8b": 2_796_595_712, "mixtral-8x7b": 11_876_809_344}
W8_PER_LAYER_MOE = 4  # wq, wk, wv, wo; + lm_head per forward
GROUPED_PER_LAYER = 3  # the w_gate, w_up and w_down stacks
MOE_ROUTED = {"routed": True, "moe_cf": 4.0}  # cap = n for top-2 of 8: dropless
MOE_BLOCK_SHAPES = ((1, 128), (8, 1))  # a prefill chunk and an 8-lane decode step


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


ROUNDS = 10  # timing rounds; each times every function of a row twice, in turns
FLUSH_BYTES = 256 << 20  # rewritten before each timed call: 5x the H100's 50 MB L2
SPIN_CYCLES = 2_000_000  # ~1 ms of device spin before each call: the host runs ahead
MARK_CYCLES = 1_000  # the spin that parts a flush from the call after it
TAIL_CYCLES = 400_000_000  # ~0.2 s of spin after a row: the last clock sample reads a busy card
TRACE_ATTEMPTS = 3  # traces of a row taken before a lost device record fails it
HANG_DUMP_S = 1150  # past this the script dumps its threads' stacks and exits
SOURCE = "agentainer_tpu_torch/csrc/flash_attention.cu"
TIMING = (
    "device span of one call (first start to last end of its device activities in a "
    f"torch.profiler trace) with a cold L2 ({FLUSH_BYTES >> 20} MB rewritten before each), "
    f"in turns with the row's other functions (a, b, c, c, b, a); median of {2 * ROUNDS}"
)
# Device launches one call of each wrapper is written to make (a decode call:
# the split kernel, then the combine). The kernel phase counts them in the
# trace of every timed call and fails on a difference.
LAUNCHES_PER_CALL = {
    "flash_prefill": 1, "flash_decode": 2,
    "fused_paged_flash_prefill": 1, "fused_paged_flash_decode": 2,
}


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _kernel_name(name: str) -> str:
    """'void (anonymous namespace)::decode_kernel<...>(...)' -> 'decode_kernel'."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


def time_in_turns(fns: dict, rounds: int = ROUNDS) -> tuple[dict[str, dict], dict]:
    """Device time and device launches of single calls of each function,
    cold and in turns.

    Each round calls the functions in order and then in reverse, so drift
    in clocks or neighbours reaches all of them alike. Before each call a
    256 MB buffer is rewritten, which evicts the L2 (on the served path the
    K/V is cold), and a spin kernel holds the stream, so the host runs ahead
    of the device. Spins part the stream into flushes and calls: the whole
    row runs under torch.profiler, and a call's time is the span of its
    device activities in the trace, first start to last end, which host
    stalls do not reach. nvidia-smi samples the SM clock and power while the
    row runs. The profiler now and then loses device records; a trace that
    does not part into exactly the flushes and calls issued, or whose calls
    of one function differ in launches, is taken again, up to
    ``TRACE_ATTEMPTS`` times. Returns, per function, the median, min and max
    in ms, the device launches of one call and the names of their kernels;
    and the row's clock samples."""
    import statistics

    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for fn in fns.values():  # first launches, allocator
        fn()
    torch.cuda.synchronize()
    order = [name for _ in range(rounds) for name in (*fns, *reversed(fns))]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        samples: list[str] = []
        try:
            per_fn = _traced_calls(fns, order, flush, samples)
            break
        except TraceIncomplete as e:
            if attempt == TRACE_ATTEMPTS:
                raise
            log(f"trace attempt {attempt} of {TRACE_ATTEMPTS} incomplete ({e}); tracing the row again")
    out = {}
    for name, runs in per_fn.items():
        ms = [
            (max(e.time_range.end for e in acts) - min(e.time_range.start for e in acts)) / 1e3
            for acts in runs
        ]
        out[name] = {
            "median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "launches": len(runs[0]), "kernels": [_kernel_name(e.name) for e in runs[0]],
        }
    return out, _clock_summary(samples)


class TraceIncomplete(RuntimeError):
    """A profiler trace that lost device records."""


def _traced_calls(fns: dict, order: list[str], flush, samples: list) -> dict[str, list[list]]:
    """One traced pass over ``order``: per function, the device activities
    of each of its calls. Raises ``TraceIncomplete`` unless the trace parts
    into exactly what was issued (one flush activity, then a non-empty call,
    per entry of ``order``) and every call of a function made as many device
    launches as the others."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with _sampling(samples):
            # a lead-in spin: the first kernel after the profiler comes up
            # can lose its record (seen on an H100: a row's first spin
            # missing in three traces running); if kept, it parts off an
            # empty group, dropped below
            torch.cuda._sleep(MARK_CYCLES)
            for name in order:
                torch.cuda._sleep(MARK_CYCLES)
                flush.zero_()
                torch.cuda._sleep(SPIN_CYCLES)
                fns[name]()
            torch.cuda._sleep(MARK_CYCLES)
            done = torch.cuda.Event()
            done.record()
            torch.cuda._sleep(TAIL_CYCLES)
            done.synchronize()
        torch.cuda.synchronize()
    events = sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    # the activities after each spin: a flush, a call, ..., then the two
    # empty tail groups
    groups: list[list] = []
    for e in events:
        if "spin_kernel" in e.name:
            groups.append([])
        elif groups:
            groups[-1].append(e)
    if len(groups) == 2 * len(order) + 3 and not groups[0]:
        groups = groups[1:]  # the lead-in spin's record was kept
    flushes, calls = groups[0:2 * len(order):2], groups[1:2 * len(order):2]
    if len(groups) != 2 * len(order) + 2 or any(len(f) != 1 for f in flushes) or not all(calls):
        raise TraceIncomplete(f"{len(groups)} spin-parted groups for {len(order)} calls")
    per_fn = {name: [] for name in fns}
    for name, acts in zip(order, calls):
        per_fn[name].append(acts)
    for name, runs in per_fn.items():
        launches = {len(acts) for acts in runs}
        if len(launches) != 1:
            raise TraceIncomplete(f"{name}: device launches per call differ between calls: {launches}")
    return per_fn


@contextlib.contextmanager
def _sampling(samples: list):
    """nvidia-smi's SM clock, power draw and power limit, sampled one after
    another in a thread while the block runs."""
    stop = threading.Event()

    def run():
        while not stop.is_set():
            samples.append(smi("clocks.sm,power.draw,power.limit"))

    th = threading.Thread(target=run, name="smi", daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join(timeout=60)


def _clock_summary(samples: list[str]) -> dict:
    """Ranges of '<MHz> MHz, <W> W, <W> W' samples (a field nvidia-smi gives
    as [N/A] is left out)."""
    out = {"samples": len(samples)}
    for i, name in enumerate(("sm_mhz", "power_w", "limit_w")):
        vals = []
        for line in samples:
            with contextlib.suppress(ValueError, IndexError):
                vals.append(float(line.split(",")[i].split()[0]))
        out[f"{name}_min"], out[f"{name}_max"] = min(vals, default=None), max(vals, default=None)
    return out


def _timed(name: str, fns: dict, want_launches: int | None = None) -> dict:
    """``time_in_turns`` of a row's functions, as the row's keys: ``ms``
    with its spread, ``launches_per_call`` and ``device_kernels`` for the
    kernel ``name`` (raises unless it launched ``LAUNCHES_PER_CALL[name]``
    per call), ``<fn>_ms`` with its spread for the others, and ``card``,
    the clock samples."""
    times, card = time_in_turns(fns)
    out = {}
    for fn, t in times.items():
        key = "ms" if fn == "kernel" else f"{fn}_ms"
        out.update({key: t["median"], f"{key}_min": t["min"], f"{key}_max": t["max"]})
    kernel = times["kernel"]
    want = LAUNCHES_PER_CALL[name] if want_launches is None else want_launches
    if kernel["launches"] != want:
        raise AssertionError(
            f"{name}: {kernel['launches']} device launches per call ({kernel['kernels']}), "
            f"written to make {want}"
        )
    return {**out, "launches_per_call": kernel["launches"], "device_kernels": kernel["kernels"], "card": card}


def phase_build() -> str:
    import torch

    from agentainer_tpu_torch.ops import cuda_attention as ca
    from agentainer_tpu_torch.ops import cuda_quant as cq

    from agentainer_tpu_torch import native

    t0 = time.monotonic()
    # one nvcc per source and the native store's g++, together
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda build: build(), (ca._lib, cq._lib, native.build)))
    log(f"built and loaded csrc/flash_attention.cu and csrc/w8a16_gemm.cu, and built native/ "
        f"({os.path.basename(native.library_path())}), in {time.monotonic() - t0:.1f}s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    return smi("name,power.limit")


# the Llama-3-style tokenizer.json the tests hold against tokenizers, and
# the ids tokenizers gave on its strings (scripts/make_tokenizer_fixture.py)
TOKENIZER_FIXTURE = os.path.join("tests", "fixtures", "llama3_style_tokenizer.json")
TOKENIZER_EXPECTED = os.path.join("tests", "fixtures", "llama3_style_tokenizer.expected.json")


def _fixture_dir(prefix: str) -> str:
    """A fresh directory holding the fixture as ``tokenizer.json``."""
    d = tempfile.mkdtemp(prefix=prefix)
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)), TOKENIZER_FIXTURE),
                os.path.join(d, "tokenizer.json"))
    return d


# 1c's check, in a fresh interpreter where ``tokenizers`` and ``regex``
# cannot be imported: the reader must need neither
_TOKENIZER_PROBE = """
import json, sys, time, unicodedata
sys.modules["tokenizers"] = None
sys.modules["regex"] = None
from agentainer_tpu_torch.engine.tokenizer import HFTokenizer, load_tokenizer
directory, expected = sys.argv[1:3]
doc = json.load(open(expected, encoding="utf-8"))
t0 = time.perf_counter()
tok = load_tokenizer(128256, directory)
load_ms = 1e3 * (time.perf_counter() - t0)
t0 = time.perf_counter()
cases = [(tok.encode(c["text"], add_bos=False), tok.decode(tok.encode(c["text"]))) for c in doc["cases"]]
ms = 1e3 * (time.perf_counter() - t0)
print(json.dumps({
    "reader": type(tok).__name__, "vocab_size": tok.vocab_size,
    "specials": {"<|begin_of_text|>": tok.bos_id, "<|end_of_text|>": tok.eos_id},
    "cases": cases, "load_ms": load_ms, "encode_decode_ms": ms,
    "unidata_version": unicodedata.unidata_version,
}))
"""


def phase_tokenizer(card: str) -> dict:
    """1c: the fixture's ``tokenizer.json`` through the port's
    ``load_tokenizer`` on this machine's Python, in a fresh interpreter
    where ``tokenizers`` and ``regex`` cannot be imported: on each
    committed string its ids equal the ids ``tokenizers`` gave (committed
    beside the fixture), and ``decode ∘ encode`` gives the committed text:
    the string back, less what the reference's decode drops (the specials,
    and pad id 0, a lone "!" in a byte-level vocabulary). Prints this
    Python's ``unicodedata`` version and whether the two packages are
    installed here."""
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    expected = os.path.join(root, TOKENIZER_EXPECTED)
    with open(expected, encoding="utf-8") as f:
        doc = json.load(f)
    d = _fixture_dir("atpu-tok-")
    try:
        res = subprocess.run(
            [sys.executable, "-c", _TOKENIZER_PROBE, d, expected], cwd=root, capture_output=True, text=True,
            timeout=120, env={**os.environ, "PYTHONPATH": root},
        )
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if res.returncode != 0:
        raise AssertionError(f"tokenizer probe: exit {res.returncode}: {res.stderr[-2000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    if got["reader"] != "HFTokenizer" or (got["vocab_size"], got["specials"]) != (doc["vocab_size"], doc["specials"]):
        raise AssertionError(f"tokenizer: {got['reader']}, vocab {got['vocab_size']}, specials {got['specials']}; "
                             f"want {doc['vocab_size']} {doc['specials']}")
    chars = 0
    for case, (ids, back) in zip(doc["cases"], got["cases"]):
        chars += len(case["text"])
        if ids != case["ids"]:
            raise AssertionError(f"tokenizer ids for {case['text']!r}: {ids}, tokenizers gave {case['ids']}")
        want = case["text"]
        for special in doc["specials"]:
            want = want.replace(special, "")
        if back != case["decoded"] or (0 not in ids and back != want):
            raise AssertionError(f"tokenizer decode of {case['text']!r}: {back!r}, want {case['decoded']!r}")
    installed = {m: importlib.util.find_spec(m) is not None for m in ("tokenizers", "regex")}
    out = {
        "cases": len(doc["cases"]), "vocab_size": got["vocab_size"], "specials": got["specials"],
        "unidata_version": got["unidata_version"], "fixture_unidata_version": doc["unidata_version"],
        "fixture_tokenizers": doc["tokenizers"], "installed_here": installed,
        "load_ms": got["load_ms"], "encode_decode_ms": got["encode_decode_ms"], "chars": chars, "card": card,
    }
    log(f"tokenizer: with tokenizers and regex unimportable, the fixture's ids equal tokenizers "
        f"{doc['tokenizers']}'s on {len(doc['cases'])} strings; unicodedata {got['unidata_version']} (fixture "
        f"made under {doc['unidata_version']}); installed on this machine: {installed}; load "
        f"{got['load_ms']:.1f} ms, encode+decode {got['encode_decode_ms']:.1f} ms for {chars} chars (host)")
    return out


def _bound(bytes_moved: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_bytes, t_ops = bytes_moved / PEAK_HBM_BPS, flops / peak_flops
    return {"bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _compare(fn, plain, floats, rest, bf16_atol=BF16_ATOL) -> dict:
    """``fn`` against ``plain`` on the bf16 tensors ``floats`` (q, k, v) and
    on the same values in f32, with the int tensors ``rest`` as they are;
    raises if either is out of tolerance, else returns both max abs errors
    and their tolerances as the row's keys."""
    import torch

    errs = []
    for dtype, rtol, atol in ((torch.bfloat16, BF16_RTOL, bf16_atol), (torch.float32, F32_TOL, F32_TOL)):
        args = (*(x.to(dtype) for x in floats), *rest)
        got, want = fn(*args).float(), plain(*args).float()
        torch.testing.assert_close(
            got, want, rtol=rtol, atol=atol,
            msg=lambda m, d=dtype: f"{fn.__name__} ({d}) disagrees with its plain version: {m}",
        )
        errs.append((got - want).abs().max().item())
    return {
        "max_abs_err": errs[0], "tolerance": f"|d| <= {bf16_atol} + {BF16_RTOL} * |plain|",
        "max_abs_err_f32": errs[1], "tolerance_f32": F32_TOL,
    }


def _row(name: str, replaces: int, **fields) -> dict:
    return {
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": f"agentainer_tpu/ops/pallas_attention.py:{replaces}", "timing": TIMING,
        **fields,
    }


def _decode_mask(pos):
    import torch

    return (torch.arange(S, device=pos.device)[None, :] <= pos[:, None])[:, None, None]


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
    errs = _compare(ca.flash_prefill, ca.flash_prefill_plain, (q, k, v), (pos,), BF16_ATOL + BF16_P_ATOL)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[0, :, None])[None, None]
    visible = (pos.clamp(max=S - 1) + 1).sum().item()  # visible slots summed over rows
    live = pos.max().item() + 1
    bytes_moved = 2 * (2 * q.numel() + 2 * b * live * KV * HD)  # q, out, live K and V
    # the served call: the engine's prefill graphs pass the whole arena
    # [B, S] and the slot's row in device memory
    ka, va = randn(B, S, KV, HD), randn(B, S, KV, HD)
    rows = torch.tensor([5], device=dev, dtype=torch.int32)
    slot_row = _compare(
        ca.flash_prefill, ca.flash_prefill_plain, (q, ka, va), (pos, rows), BF16_ATOL + BF16_P_ATOL
    )
    if not torch.equal(ca.flash_prefill(q, ka, va, pos, rows), ca.flash_prefill(q, ka[5:6], va[5:6], pos)):
        raise AssertionError("flash_prefill through a row map differs from the same call on the row's view")
    slot_row.update(equal_to_row_view=True, shape=f"q[{b},{t},{H},{HD}] kv[{B},{S},{KV},{HD}] bf16, rows [5]")
    del ka, va
    out.append(_row(
        "flash_prefill", 157, **errs, slot_row=slot_row,
        **_timed("flash_prefill", {
            "kernel": lambda: ca.flash_prefill(q, k, v, pos),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True),
            "plain": lambda: ca.flash_prefill_plain(q, k, v, pos),
        }),
        **_bound(bytes_moved, 4.0 * H * HD * visible), library="scaled_dot_product_attention",
        shape=f"q[{b},{t},{H},{HD}] kv[{b},{S},{KV},{HD}] bf16, positions {off}..{off + t - 1}",
    ))

    # verify rounds: B = 8, T = K + 1, at the served mix
    k, v = randn(B, S, KV, HD), randn(B, S, KV, HD)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    verify = {}
    for kk in VERIFY_KS:
        q = randn(B, kk + 1, H, HD)
        pos = _verify_pos(kk, dev)
        mask = (torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None])[:, None]
        live = (pos.max(dim=1).values.clamp(max=S - 1) + 1).sum().item()
        visible = (pos.clamp(max=S - 1) + 1).sum().item()
        verify[f"K={kk}"] = {
            **_compare(ca.flash_prefill, ca.flash_prefill_plain, (q, k, v), (pos,), BF16_ATOL + BF16_P_ATOL),
            **_timed("flash_prefill", {
                "kernel": lambda q=q, pos=pos: ca.flash_prefill(q, k, v, pos),
                "library": lambda q=q, mask=mask: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kt, vt, attn_mask=mask, enable_gqa=True),
            }),
            **_bound(2 * (2 * q.numel() + 2 * live * KV * HD), 4.0 * H * HD * visible),
            "shape": f"q[{B},{kk + 1},{H},{HD}] kv[{B},{S},{KV},{HD}] bf16, {_VERIFY_MIX}",
        }
    out[-1]["verify"] = verify
    del k, v, kt, vt

    # decode: the engine's 8 lanes at mixed positions, one parked at S - 1;
    # then the served mix: 2 live lanes near 300, 6 parked at S - 1
    b = B
    q, k, v = randn(b, H, HD), randn(b, S, KV, HD), randn(b, S, KV, HD)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    shapes = {}
    for key, pos in (("mixed", MIXED_POS), ("served_mix", SERVED_MIX_POS)):
        pos = torch.tensor(pos, device=dev, dtype=torch.int32)
        mask = _decode_mask(pos)
        live = (pos.clamp(max=S - 1) + 1).sum().item()
        fns = {
            "kernel": lambda pos=pos: ca.flash_decode(q, k, v, pos),
            "library": lambda mask=mask: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True),
        }
        if key == "mixed":
            fns["plain"] = lambda pos=pos: ca.flash_decode_plain(q, k, v, pos)
        shapes[key] = {
            **_timed("flash_decode", fns), **_bound(2 * (2 * q.numel() + 2 * live * KV * HD), 4.0 * H * HD * live),
            "shape": f"q[{b},{H},{HD}] kv[{b},{S},{KV},{HD}] bf16, positions {pos.tolist()}",
        }
        if key == "mixed":
            errs = _compare(ca.flash_decode, ca.flash_decode_plain, (q, k, v), (pos,))
    out.append(_row(
        "flash_decode", 268, **errs, **shapes.pop("mixed"), library="scaled_dot_product_attention",
        served_mix=shapes["served_mix"],
    ))
    out += _paged_kernel_rows(randn, g)
    for row in out:
        ref = "library" if row["library_ms"] is not None else "yardstick"
        log(f"{row['name']}: max_abs_err bf16 {row['max_abs_err']:.3g} f32 {row['max_abs_err_f32']:.3g} "
            f"ms {row['ms']:.4f} [{row['ms_min']:.4f}, {row['ms_max']:.4f}] plain {row['plain_ms']:.4f} "
            f"{ref} {row[ref + '_ms']:.4f} bound {row['bound_ms']:.4f} "
            f"launches/call {row['launches_per_call']} {row['device_kernels']} card {row['card']}")
        if "served_mix" in row:
            mix = row["served_mix"]
            log(f"{row['name']} served mix: ms {mix['ms']:.4f} [{mix['ms_min']:.4f}, {mix['ms_max']:.4f}] "
                f"{ref} {mix[ref + '_ms']:.4f} bound {mix['bound_ms']:.4f} card {mix['card']}")
        for key, ver in row.get("verify", {}).items():
            log(f"{row['name']} verify {key}: max_abs_err bf16 {ver['max_abs_err']:.3g} f32 "
                f"{ver['max_abs_err_f32']:.3g} ms {ver['ms']:.4f} [{ver['ms_min']:.4f}, {ver['ms_max']:.4f}] "
                f"{ref} {ver[ref + '_ms']:.4f} bound {ver['bound_ms']:.4f} launches/call "
                f"{ver['launches_per_call']} card {ver['card']}")
    return out


def _int8pack_library(x, q, scale):
    """``torch._weight_int8pack_mm`` on the card, as a library yardstick
    of the int8 product (timed only; the port never calls it): a function
    of x, or None where this torch build lacks it for CUDA or computes
    something else on these inputs."""
    import torch

    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    qt, sc = q.t().contiguous(), scale.reshape(-1).contiguous()
    try:
        got = fn(x, qt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"torch._weight_int8pack_mm is not available on this card: {str(e).splitlines()[0]}")
        return None
    from agentainer_tpu_torch.ops.cuda_quant import w8a16_matmul_plain

    want = w8a16_matmul_plain(x, q, scale).float()
    if (got.float() - want).abs().max().item() > BF16_LOGIT_TOL * max(1.0, want.abs().max().item()):
        log("torch._weight_int8pack_mm computes another function here; no library time")
        return None
    return lambda: fn(x, qt, sc)


def host_cost(fn, calls: int = HOST_CALLS) -> dict:
    """What one call of ``fn`` costs the host, without a profiler:
    ``host_us``, the host clock around ``calls`` calls while a spin kernel
    holds the device (the loop only enqueues: the wrapper's Python, its
    checks and allocation, the launch); ``loop_us``, CUDA events around
    ``calls`` calls back to back on an idle device (per call, the larger of
    the host's and the device's time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(TAIL_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return {"host_us": 1e6 * host_s / calls, "loop_us": 1e3 * start.elapsed_time(end) / calls}


def phase_w8a16() -> dict:
    """``w8a16_matmul`` against its plain version at every (K, N, M), then
    timed at llama3-8b's (K, N) for M = 8, 72 and 256, and its host cost
    per call beside the bf16 product's (see the docstring)."""
    import torch

    from agentainer_tpu_torch.ops import cuda_quant as cq
    from agentainer_tpu_torch.ops.quant import dequant, QTensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    bf = torch.bfloat16

    def inputs(m, k, n):
        x = torch.randn((m, k), generator=g, device=dev).to(bf)
        q = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g, device=dev)
        scale = ((0.5 + torch.rand((1, n), generator=g, device=dev)) * (0.02 / 127.0)).to(bf)
        return x, q, scale

    shapes = sorted(set(W8_WEIGHTS.values()) | set(BENCH_1B_KN))
    worst, checked = 0.0, 0
    t0 = time.monotonic()
    for k, n in shapes:
        for m in W8_MS:
            x, q, scale = inputs(m, k, n)
            got, want = cq.w8a16_matmul(x, q, scale).float(), cq.w8a16_matmul_plain(x, q, scale).float()
            torch.testing.assert_close(
                got, want, rtol=W8_RTOL, atol=W8_ATOL,
                msg=lambda msg, m=m, k=k, n=n: f"w8a16_matmul M={m} K={k} N={n} {cq.plan(m, n, k)} disagrees "
                f"with plain: {msg}",
            )
            if not torch.equal(cq.w8a16_matmul(x, q, scale), cq.w8a16_matmul(x, q, scale)):
                raise AssertionError(f"w8a16_matmul M={m} K={k} N={n}: two calls differ")
            worst = max(worst, (got - want).abs().max().item())
            checked += 1
    log(f"w8a16_matmul held its plain version at {checked} (K, N, M), two calls bit-equal, in "
        f"{time.monotonic() - t0:.1f}s; max abs err {worst:.3g}")

    timed = []
    names = {}
    for weight, kn in W8_WEIGHTS.items():
        names.setdefault(kn, []).append(weight)
    for (k, n), weights in names.items():
        for m in W8_TIMED_MS:
            x, q, scale = inputs(m, k, n)
            dense = dequant(QTensor(q, scale))
            bm, splits = cq.plan(m, n, k)
            fns = {
                "kernel": lambda x=x, q=q, scale=scale: cq.w8a16_matmul(x, q, scale),
                "plain": lambda x=x, q=q, scale=scale: cq.w8a16_matmul_plain(x, q, scale),
                "cublas_bf16": lambda x=x, dense=dense: x @ dense,
                "dequant_matmul": lambda x=x, q=q, scale=scale: x @ dequant(QTensor(q, scale)),
            }
            library = _int8pack_library(x, q, scale)
            if library is not None:
                fns["library"] = library
            row = _timed("w8a16_matmul", fns, want_launches=1)
            if library is None:
                row["library_ms"] = None
            timed.append({
                "weights": weights, "shape": f"x[{m},{k}] bf16, q[{k},{n}] int8, scale[1,{n}] bf16",
                "M": m, "K": k, "N": n, "block_m": bm, "splits": splits,
                **row, **_bound(k * n + 2 * n + 2 * m * k + 2 * m * n, 2.0 * m * k * n),
            })
            r = timed[-1]
            log(f"w8a16_matmul {'/'.join(weights)} M={m}: ms {r['ms']:.4f} [{r['ms_min']:.4f}, "
                f"{r['ms_max']:.4f}] bound {r['bound_ms']:.4f} ({r['bound_by']}) plain {r['plain_ms']:.4f} "
                f"cublas bf16 {r['cublas_bf16_ms']:.4f} x@dequant(w) {r['dequant_matmul_ms']:.4f} "
                f"library {r['library_ms']} tile {bm} splits {splits} launches/call {r['launches_per_call']} "
                f"card {r['card']}")
            del x, q, scale, dense, fns, library
    # the wrapper's host cost at decode, beside the bf16 product's
    host = {}
    for (k, n), weights in names.items():
        x, q, scale = inputs(8, k, n)
        dense = dequant(QTensor(q, scale))
        host["/".join(weights)] = {
            "w8a16_matmul": host_cost(lambda x=x, q=q, scale=scale: cq.w8a16_matmul(x, q, scale)),
            "bf16_matmul": host_cost(lambda x=x, dense=dense: x @ dense),
        }
        del x, q, scale, dense
    log("host us per call at M = 8 (host clock, device held; and CUDA events back to back): " + "; ".join(
        f"{w}: w8a16_matmul {h['w8a16_matmul']['host_us']:.2f} / {h['w8a16_matmul']['loop_us']:.2f}, "
        f"bf16 {h['bf16_matmul']['host_us']:.2f} / {h['bf16_matmul']['loop_us']:.2f}" for w, h in host.items()
    ))
    main = next(r for r in timed if "w_gate" in r["weights"] and r["M"] == 8)
    return {
        "name": "w8a16_matmul", "route": "cuda", "source": W8_SOURCE, "replaces": W8_REPLACES,
        "timing": TIMING, "max_abs_err": worst,
        "tolerance": f"|d| <= {W8_ATOL} + {W8_RTOL} * |plain|", "checked": checked,
        "library": "torch._weight_int8pack_mm" if main["library_ms"] is not None else None,
        **{key: main[key] for key in (
            "shape", "ms", "ms_min", "ms_max", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "cublas_bf16_ms", "dequant_matmul_ms", "launches_per_call", "device_kernels", "card",
        )},
        "timed": timed, "host_us": host,
    }


_VERIFY_MIX = "lanes 0-1 at 299/312 + arange(K + 1), lanes 2-7 at S - 1"


def _verify_pos(kk: int, dev):
    """Positions of a verify round at bucket K: [B, K + 1] int32."""
    import torch

    live = torch.tensor([299, 312], device=dev)[:, None] + torch.arange(kk + 1, device=dev)
    return torch.cat([live, torch.full((B - 2, kk + 1), S - 1, device=dev)]).int()


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
    errs = _compare(
        ca.fused_paged_flash_prefill, ca.paged_flash_prefill_plain, (q, pool_k, pool_v), (table, pos),
        BF16_ATOL + BF16_P_ATOL,
    )
    mask = (torch.arange(S, device=dev)[None, :] <= pos[0, :, None])[None, None]

    def gather_sdpa():
        k, v = gather_pages(pool_k, pool_v, table)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
        )

    visible = (pos.clamp(max=S - 1) + 1).sum().item()
    bytes_moved = 2 * 2 * q.numel() + 2 * 2 * _live_slots(table, pos[:, -1]) * KV * HD + 4 * table.numel()
    rows.append(_row(
        "fused_paged_flash_prefill", 454, **errs,
        **_timed("fused_paged_flash_prefill", {
            "kernel": lambda: ca.fused_paged_flash_prefill(q, pool_k, pool_v, table, pos),
            "yardstick": gather_sdpa,
            "plain": lambda: ca.paged_flash_prefill_plain(q, pool_k, pool_v, table, pos),
        }),
        **_bound(bytes_moved, 4.0 * H * HD * visible), library_ms=None, yardstick=YARDSTICK,
        shape=f"q[1,{t},{H},{HD}] {pool} table[1,{S // PS}], positions {off}..{off + t - 1}",
    ))

    # decode: the engine's 8 lanes at mixed positions, lane 7 parked at S - 1;
    # then the served mix: lanes 0 and 1 live near 300, lanes 2-7 parked, each
    # on its own scratch page as the engine parks them
    q = randn(B, H, HD)
    parked = tables.clone()
    parked[2:] = (B * (S // PS) + torch.arange(2, B, device=dev, dtype=torch.int32))[:, None]
    shapes = {}
    for key, table, pos in (("mixed", tables, MIXED_POS), ("served_mix", parked, SERVED_MIX_POS)):
        pos = torch.tensor(pos, device=dev, dtype=torch.int32)
        mask = _decode_mask(pos)

        def gather_sdpa_decode(table=table, mask=mask):
            k, v = gather_pages(pool_k, pool_v, table)
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
            )

        fns = {
            "kernel": lambda table=table, pos=pos: ca.fused_paged_flash_decode(q, pool_k, pool_v, table, pos),
            "yardstick": gather_sdpa_decode,
        }
        if key == "mixed":
            fns["plain"] = lambda: ca.paged_flash_decode_plain(q, pool_k, pool_v, tables, pos)
            errs = _compare(
                ca.fused_paged_flash_decode, ca.paged_flash_decode_plain, (q, pool_k, pool_v), (table, pos)
            )
        visible = (pos.clamp(max=S - 1) + 1).sum().item()
        bytes_moved = 2 * 2 * q.numel() + 2 * 2 * _live_slots(table, pos) * KV * HD + 4 * table.numel()
        shapes[key] = {
            **_timed("fused_paged_flash_decode", fns), **_bound(bytes_moved, 4.0 * H * HD * visible),
            "shape": f"q[{B},{H},{HD}] {pool} table[{B},{S // PS}], positions {pos.tolist()}",
        }
    rows.append(_row(
        "fused_paged_flash_decode", 577, **errs, **shapes.pop("mixed"), library_ms=None,
        yardstick=YARDSTICK, served_mix=shapes["served_mix"],
    ))

    # verify rounds through the served table (lanes 2-7 parked on their
    # scratch pages), B = 8, T = K + 1
    verify = {}
    for kk in VERIFY_KS:
        q = randn(B, kk + 1, H, HD)
        pos = _verify_pos(kk, dev)
        mask = (torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None])[:, None]

        def gather_sdpa_verify(q=q, mask=mask):
            k, v = gather_pages(pool_k, pool_v, parked)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
            )

        visible = (pos.clamp(max=S - 1) + 1).sum().item()
        bytes_moved = 2 * 2 * q.numel() + 2 * 2 * _live_slots(parked, pos[:, -1]) * KV * HD + 4 * parked.numel()
        verify[f"K={kk}"] = {
            **_compare(
                ca.fused_paged_flash_prefill, ca.paged_flash_prefill_plain, (q, pool_k, pool_v),
                (parked, pos), BF16_ATOL + BF16_P_ATOL,
            ),
            **_timed("fused_paged_flash_prefill", {
                "kernel": lambda q=q, pos=pos: ca.fused_paged_flash_prefill(q, pool_k, pool_v, parked, pos),
                "yardstick": gather_sdpa_verify,
            }),
            **_bound(bytes_moved, 4.0 * H * HD * visible),
            "shape": f"q[{B},{kk + 1},{H},{HD}] {pool} table[{B},{S // PS}], {_VERIFY_MIX}",
        }
    rows[0]["verify"] = verify
    return rows


def _http(port: int, method: str, path: str, body: dict | None = None, timeout: float = 600):
    status, _, doc = _http_any(port, method, path, body, timeout=timeout)
    if status >= 400:
        raise AssertionError(f"{method} {path}: {status} {doc}")
    return status, doc


def _http_any(port: int, method: str, path: str, body: dict | None = None,
              headers: dict | None = None, timeout: float = 600):
    """(status, headers, JSON body) of one request, error statuses included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


@contextlib.contextmanager
def _serving(options: dict, checkpoint: str = "", env: dict | None = None, config: str = "llama3-8b"):
    """The port's ``llm_serve`` app for ``config`` on a local port (from a
    checkpoint directory when one is named), loaded; yields (app, load
    seconds) and stops it on the way out."""
    from agentainer_tpu_torch.engine.llm_serve import LLMServeApp

    app = LLMServeApp(env={
        "AGENTAINER_AGENT_ID": "chip-smoke",
        "AGENTAINER_MODEL_CONFIG": config,
        "AGENTAINER_CHECKPOINT": checkpoint,
        "AGENTAINER_MODEL_OPTIONS": json.dumps(options),
        **(env or {}),
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


def _parse_sse(raw: bytes) -> list[dict]:
    """SSE frames: {"event", "id", "data"} or {"comment"}."""
    frames = []
    for block in raw.decode().split("\n\n"):
        if not block.strip():
            continue
        frame: dict = {}
        for line in block.split("\n"):
            if line.startswith(":"):
                frame["comment"] = line[1:].strip()
            else:
                key, _, value = line.partition(": ")
                frame[key] = json.loads(value) if key == "data" else value
        frames.append(frame)
    return frames


STREAM_PROMPT = "Explain in two sentences why the sky is blue."
STREAM_TOKENS = 24


def _stream_check(port: int, name: str, tokenizer) -> dict:
    """One streamed /chat against the buffered /chat of the same prompt in
    another fresh session: ids 0..n-1, the streamed tokens decode to the
    buffered greedy text, ``done`` carries the buffered body, and the
    stream made the buffered request's host syncs. Whether the joined text
    deltas equal it is reported: as in the reference, a delta is the
    decoded prefix's new tail, and a byte-level token that ends inside a
    UTF-8 character decodes to a replacement character that a later token
    rewrites, which the deltas already sent keep."""
    _, m0 = _http(port, "GET", "/metrics")
    buffered = _chat(port, [], "stream-b", STREAM_PROMPT, STREAM_TOKENS)
    _, m1 = _http(port, "GET", "/metrics")
    body = {"session": "stream-s", "message": STREAM_PROMPT, "max_tokens": STREAM_TOKENS,
            "ignore_eos": True, "stream": True}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/chat", data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as resp:
        ctype = resp.headers.get("Content-Type")
        first_frame_s = None
        raw = b""
        while chunk := resp.read1(65536):
            if first_frame_s is None and b"event: token" in raw + chunk:
                first_frame_s = time.monotonic() - t0
            raw += chunk
    _, m2 = _http(port, "GET", "/metrics")
    frames = _parse_sse(raw)
    tokens = [f for f in frames if f.get("event") == "token"]
    done = frames[-1] if frames else {}
    text = tokenizer.decode([f["data"]["token"] for f in tokens])
    syncs = [m1["host_syncs_total"] - m0["host_syncs_total"], m2["host_syncs_total"] - m1["host_syncs_total"]]
    steps = [m1["decode_steps"] - m0["decode_steps"], m2["decode_steps"] - m1["decode_steps"]]
    out = {
        "content_type": ctype, "events": len(tokens), "text_equal": text == buffered["response"],
        "joined_deltas_equal": "".join(f["data"]["text"] for f in tokens) == buffered["response"],
        "host_syncs": {"buffered": syncs[0], "streamed": syncs[1]},
        "dispatches": {"buffered": steps[0], "streamed": steps[1]},
        "first_frame_ms": None if first_frame_s is None else 1e3 * first_frame_s,
        "buffered_ttft_ms": buffered["ttft_ms"],
    }
    if ctype != "text/event-stream" or [int(f["id"]) for f in tokens] != list(range(STREAM_TOKENS)):
        raise AssertionError(f"{name}: streamed /chat ids {[f.get('id') for f in tokens]} ({ctype})")
    if not out["text_equal"] or done.get("event") != "done" or done["data"]["response"] != buffered["response"]:
        raise AssertionError(f"{name}: streamed text {text!r} != buffered {buffered['response']!r}")
    # emission adds no device sync: with the same dispatches, the same syncs
    if steps[0] == steps[1] and syncs[0] != syncs[1]:
        raise AssertionError(f"{name}: streamed host syncs {syncs[1]} != buffered {syncs[0]} ({steps})")
    if syncs[1] - steps[1] != syncs[0] - steps[0]:
        raise AssertionError(f"{name}: host syncs beyond the dispatches differ: {syncs} {steps}")
    log(f"{name} stream: {out}")
    return out


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
# the dispatch-ahead pipeline and the step graphs, per served phase
PIPELINE_KEYS = (
    "graph_replays", "host_syncs_total", "host_syncs_per_token", "itl_ms_p50", "ttft_ms_p50",
    "graphs_captured", "graph_capture_s", "graph_pool_bytes", "prefill_graph_replays",
    "prefill_graph_capture_s", "prefill_chunks",
)


def _pipeline(name: str, before: dict, after: dict, load_s: float | None = None) -> dict:
    """A served phase's pipeline numbers; raises unless the phase replayed
    step graphs and every prefill chunk was one prefill graph replay."""
    out = {k: after.get(k) for k in PIPELINE_KEYS}
    for key in ("graph_replays", "prefill_graph_replays", "prefill_chunks"):
        out[key] = after[key] - before[key]
    out["engine_up_s"] = load_s
    if out["graph_replays"] <= 0 or not out["graphs_captured"]:
        raise AssertionError(f"{name}: the served path replayed no step graph: {out}")
    if out["prefill_chunks"] <= 0 or out["prefill_graph_replays"] != out["prefill_chunks"]:
        raise AssertionError(f"{name}: prefill graph replays != prefill chunks: {out}")
    log(f"{name} pipeline: {out}")
    return out
PAGED_KEYS = (
    "resident_sessions", "session_evictions_total", "kv_pages_total", "kv_pages_used",
    "kv_pages_free", "session_pages_p50", "session_pages_max", "kv_fragmentation_pct",
    "page_exhausted_total", "pages_truncated_total", "worker_errors",
)


# the features-off phases pin the reference's defaults off, so their gates
# and numbers stay comparable with the runs before the features were ported
FEATURES_OFF = {"prefix_cache": False, "speculative": False, "deadlines": False}


def phase_serve() -> dict:
    """The dense arena: the four requests through both dense kernels."""
    from agentainer_tpu_torch.ops import cuda_attention as ca

    options = {"device": "cuda", "seed": 0, "max_batch": B, "max_seq": S, **FEATURES_OFF}
    with _serving(options) as (app, load_s):
        log(f"llama3-8b engine loaded (init + warmup) in {load_s:.1f}s")
        _, m0 = _http(app.port, "GET", "/metrics")
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
        "pipeline": _pipeline("dense", m0, metrics, load_s),
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
        "page_size": PS, **FEATURES_OFF,
    }
    with _serving(options) as (app, load_s):
        log(f"llama3-8b paged engine loaded (init + warmup) in {load_s:.1f}s")
        _, m0 = _http(app.port, "GET", "/metrics")
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
        "pipeline": _pipeline("paged", m0, metrics, load_s),
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


# the feature phases' persona (>= 64 tokens with the byte tokenizer, so the
# persona's prefix reaches bucket 64 and 128) and their sequential script
PERSONA = (
    "You are Atlas, a careful assistant for a team of on-call engineers. Answer in short, "
    "plain sentences, cite the runbook step you used, and say so when you are unsure."
)
JSON_LOOP = '{"tool": "search", "args": {"q": "w", "n": 5}}\n' * 4
# (session, message, max_tokens); a session of None is a /generate prompt.
# Random weights do not continue the JSON loop's text, so prompt lookup
# finds no n-gram to draft from there. A prompt of one repeated byte is the
# prompt-lookup-friendly request for a random model: every position of its
# context feeds the same value vectors, so the hidden state at each new
# position stays close to the prompt's and the model repeats its own token,
# which the drafter then proposes and the verify round accepts.
RUNS = ("a" * 512, "=" * 512)
SCRIPT = (
    ("f1", "Hello! Summarize the plot of a heist movie in one line.", 32),
    ("f2", JSON_LOOP, 64),
    ("f1", "Now tell it as a haiku.", 32),
    ("f3", "List three prime numbers and explain why they are prime.", 32),
    *((None, run, 96) for run in RUNS),
)
SPEC_COUNTS = ("spec_rounds", "spec_drafted", "spec_accepted", "prefix_hits", "prefix_tokens_saved")
FUSED_COUNTS = ("inloop_spec_drafted", "inloop_spec_accepted", "fused_loops_total", "fused_steps_total")
FUSED_KEYS = (
    "fused_loops_total", "fused_steps_total", "fused_verify_steps_total", "fused_early_exits_total",
    "fused_exit_reason_hist", "fused_injections_total", "fused_inject_fallbacks_total",
    "inloop_spec_drafted", "inloop_spec_accepted", "host_syncs_total", "prefills",
)
SHED_WATERMARK = 12  # the burst below sends 16 at once over 8 lanes
FEATURE_KEYS = (
    "prefix_hits", "prefix_misses", "prefix_tokens_saved", "prefix_arena_entries",
    "spec_rounds", "spec_drafted", "spec_accepted", "spec_acceptance_rate", "spec_verify_hist",
    "prefill_chunks", "expired_total", "cancelled_total", "shed_total", "prefills",
    "itl_ms_p50", "ttft_ms_p50", "decode_chunk_hist", "worker_errors",
)


def _wait_metric(port: int, key: str, at_least: int, timeout: float = 120) -> dict:
    t0 = time.monotonic()
    while True:
        _, m = _http(port, "GET", "/metrics")
        if m[key] >= at_least:
            return m
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"/metrics {key} stayed below {at_least}: {m[key]}")
        time.sleep(0.05)


def _forwards(before: dict, after: dict) -> int:
    """Model forwards between two /metrics readings: prefill chunks, decode
    steps (chunk length × chunks, per rung) and verify rounds."""
    h0, h1 = before["decode_chunk_hist"], after["decode_chunk_hist"]
    steps = sum(int(c) * (n - h0.get(c, 0)) for c, n in h1.items())
    return (after["prefill_chunks"] - before["prefill_chunks"]) + steps + (
        after["spec_rounds"] - before["spec_rounds"]
    )


def _cut_config(model: str) -> str:
    """``model`` at ``CUT_LAYERS`` layers, its widths kept, registered in the
    port's config registry (the served phases run in this process); its
    name."""
    import dataclasses

    from agentainer_tpu_torch.models import configs

    name = f"{model}-{CUT_LAYERS}l"
    configs.register(dataclasses.replace(configs.get_config(model), name=name, n_layers=CUT_LAYERS))
    return name


def phase_serve_features(paged: bool, n_layers: int, script_texts: list[str] | None,
                         quant: bool = False, fused: bool = False, moe: dict | None = None,
                         contracts: bool = False) -> dict:
    """The reference's default serving features (prefix cache, speculation,
    deadlines) with a persona: the sequential script (fresh sessions fork
    the persona, the one-byte runs speculate), then a deadline that passes
    while all 8 lanes are busy (504, no prefill), a cancel of an in-flight
    request (499, its lane taken at once by a newcomer), and a burst past
    the shed watermark (429s, the rest 200). The prefill kernel's launches
    must equal n_layers × (prefill chunks + verify rounds). With ``quant``
    the weights are int8 (``quant: int8, synthetic: true``): the int8
    footprint, ``w8a16_matmul`` launched for every weight product of every
    forward, and one prompt's greedy text equal in two fresh sessions; in
    bf16 the int8 kernel must not launch. With ``fused`` decode runs as
    fused loops with in-loop speculation: the one-byte runs must accept
    in-loop drafts, a request arriving while a loop is in flight must be
    absorbed from the shadow carry (``fused_injections_total``), the
    prefill kernel's launches count the loops' verify iterations too, the
    loop graphs are held against their eager loop (``phase_fused_graphs``)
    and the script's text is compared with ``script_texts`` (the first index
    where it differs is reported, not gated: a bf16 verify may pick another
    argmax on a near tie). With ``moe`` (the MoE engine options, ``{}`` for
    the dense-einsum default) the model is Mixtral-8x7B in int8: per
    forward ``W8_PER_LAYER_MOE`` ``w8a16_matmul`` calls per layer + 1 and
    ``GROUPED_PER_LAYER`` ``w8a16_grouped_matmul`` calls per layer,
    ``moe_routed`` as asked, and the script's text against
    ``script_texts`` reported, not gated (a bf16 near tie may route a token
    to other experts). With ``contracts`` the runtime contracts run on the
    engine after its graphs check (``phase_contracts``)."""
    import torch

    from agentainer_tpu_torch.ops import cuda_attention as ca
    from agentainer_tpu_torch.ops import cuda_quant as cq

    # the engines of earlier phases are gone: release their memory first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = MIXTRAL if moe is not None else "llama3-8b"
    if n_layers != 32:
        model = _cut_config(model)
    options = {
        "device": "cuda", "seed": 0, "max_batch": B, "max_seq": S,
        "shed_watermark": SHED_WATERMARK, "system_prompt": PERSONA, "streaming": True,
    }
    if paged:
        options.update(paged_kv=True, page_size=PS)
    if quant:
        options.update(INT8)
    if fused:
        options["fused_decode"] = True
    if moe is not None:
        options.update(moe)
    # the dense bf16 engine also samples through approx_topk, and serves
    # /profile and an assistant-flavor app attached to it
    main = not paged and not quant and not fused and moe is None
    if main:
        options["approx_topk"] = True
    profile_dir = tempfile.mkdtemp(prefix="atpu-profile-") if main else ""
    prefill, decode = (
        (ca.fused_paged_flash_prefill, ca.fused_paged_flash_decode) if paged
        else (ca.flash_prefill, ca.flash_decode)
    )
    others = [fn for fn in (ca.flash_prefill, ca.flash_decode, ca.fused_paged_flash_prefill,
                            ca.fused_paged_flash_decode) if fn not in (prefill, decode)]
    name = (
        ("mixtral " + ("routed " if (moe or {}).get("routed") else "") if moe is not None else "")
        + ("int8 " if quant else "") + ("fused " if fused else "") + ("paged" if paged else "dense")
    )
    counts = SPEC_COUNTS + (FUSED_COUNTS if fused else ())
    products = (cq.w8a16_matmul, cq.w8a16_grouped_matmul)
    extra: dict = {}
    with _serving(options, env={"AGENTAINER_PROFILE_DIR": profile_dir}, config=model) as (app, load_s):
        port = app.port
        log(f"{model} {name} engine with the default features loaded in {load_s:.1f}s")
        _, m0 = _http(port, "GET", "/metrics")
        for fn in (prefill, decode, *others, *products):
            fn.launches = 0
        t1 = time.monotonic()
        replies, texts, per_request = [], [], []
        for s, msg, n in SCRIPT:
            _, mb = _http(port, "GET", "/metrics")
            if s is None:
                _, doc = _http(port, "POST", "/generate", {"prompt": msg, "max_tokens": n})
                replies.append((s, doc))
                texts.append(doc["text"])
            else:
                texts.append(_chat(port, replies, s, msg, n)["response"])
            _, ma = _http(port, "GET", "/metrics")
            per_request.append({k: ma[k] - mb[k] for k in counts})
        script_s = time.monotonic() - t1
        if quant:  # one prompt, two fresh sessions: the same greedy text
            twins = [_chat(port, replies, s, REQUESTS[2][1], 16)["response"] for s in ("i8a", "i8b")]
            if twins[0] != twins[1]:
                raise AssertionError(f"{name}: same prompt, fresh sessions, different greedy text: {twins}")
        stream = _stream_check(port, name, app.engine.tokenizer)
        if main:
            extra["approx_topk"] = _approx_sampled(port, name)
        _, m1 = _http(port, "GET", "/metrics")

        # 8 long requests hold every lane
        results: dict = {}

        def occupy(i):
            results[i] = _http_any(port, "POST", "/chat", {
                "session": f"occ{i}", "message": f"Occupant {i}: write a very long story.",
                "max_tokens": 1500, "ignore_eos": True,
            }, {"X-Agentainer-Request-ID": f"occ-{i}"})

        threads = [threading.Thread(target=occupy, args=(i,)) for i in range(B)]
        for th in threads:
            th.start()
        before = _wait_metric(port, "prefills", m1["prefills"] + B)
        # 504: the deadline passes while the request waits for a lane
        status, headers, doc = _http_any(
            port, "POST", "/chat", {"session": "late", "message": "too late", "max_tokens": 4},
            {"X-Agentainer-Deadline-Ms": "200"},
        )
        _, after = _http(port, "GET", "/metrics")
        if status != 504 or headers.get("X-Agentainer-Expired") != "true":
            raise AssertionError(f"deadline while every lane is busy: {status} {doc}")
        if after["prefills"] != before["prefills"]:
            raise AssertionError(f"the expired request was prefilled: {before['prefills']} -> {after['prefills']}")
        # 499: cancel an in-flight occupant; a newcomer then takes its lane
        _, cancel = _http(port, "POST", "/cancel", {"request_id": "occ-0"})
        threads[0].join(timeout=120)
        status, headers, doc = results[0]
        if cancel != {"cancelled": True} or status != 499:
            raise AssertionError(f"cancel of an in-flight request: {cancel} {status} {doc}")
        newcomer = _chat(port, replies, "newcomer", "A short question after a cancel?", 4)
        _, during = _http(port, "GET", "/metrics")
        if during["active_requests"] != B - 1:
            raise AssertionError(f"occupants while the newcomer ran: {during['active_requests']}")
        for i in range(1, B):
            _http(port, "POST", "/cancel", {"request_id": f"occ-{i}"})
        for th in threads:
            th.join(timeout=120)
        statuses = sorted(results[i][0] for i in range(B))
        if statuses != [499] * B:
            raise AssertionError(f"cancelled occupants answered {statuses}")
        # 429: a burst past the shed watermark
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            burst = list(pool.map(lambda i: _http_any(port, "POST", "/chat", {
                "session": f"burst{i}", "message": f"Burst question {i}?", "max_tokens": 8,
                "ignore_eos": True,
            }), range(16)))
        codes = sorted(r[0] for r in burst)
        if codes.count(429) < 1 or codes.count(200) + codes.count(429) != 16:
            raise AssertionError(f"burst past the shed watermark answered {codes}")
        serve_s = time.monotonic() - t1
        launches = {fn.__name__: fn.launches for fn in (prefill, decode, *others, *products)}
        _, m2 = _http(port, "GET", "/metrics")
        pipeline = _pipeline(f"{name} features", m0, m2, load_s)
        graphs = phase_fused_graphs(app.engine, name) if fused else phase_graphs(app.engine, name)
        if contracts:
            extra["contracts"] = phase_contracts(app, name)
        if moe is not None:
            extra["decode_step"] = _decode_step_ms(app.engine)
            log(f"{name}: one decode step of the 8-step graph {extra['decode_step']}")
        if main:
            extra["profile"] = _profile_during_a_request(port, profile_dir)
            extra["assistant"] = _assistant_turns(app)
    if profile_dir:
        shutil.rmtree(profile_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    forwards = _forwards(m0, m2)
    per_layer, per_layer_grouped = (W8_PER_LAYER_MOE, GROUPED_PER_LAYER) if moe is not None else (W8_PER_LAYER, 0)
    want_products = {
        "w8a16_matmul": (per_layer * n_layers + 1) * forwards if quant else 0,
        "w8a16_grouped_matmul": per_layer_grouped * n_layers * forwards if quant else 0,
    }
    if {k: launches[k] for k in want_products} != want_products:
        raise AssertionError(f"{name}: weight-product kernels launched {launches}, want {want_products} "
                             f"({forwards} forwards)")
    want_bytes = MOE_PARAM_BYTES if moe is not None else INT8_PARAM_BYTES
    if n_layers != 32:
        want_bytes = CUT_PARAM_BYTES[MIXTRAL if moe is not None else "llama3-8b"]
    if quant and m2["param_hbm_bytes"] != want_bytes:
        raise AssertionError(f"{name}: param_hbm_bytes {m2['param_hbm_bytes']}, want {want_bytes}")
    if m2.get("moe_routed", False) != bool((moe or {}).get("routed")):
        raise AssertionError(f"{name}: /metrics moe_routed {m2.get('moe_routed')} for options {moe}")

    if m0["prefix_prewarms"] < 1 or m1["prefix_hits"] - m0["prefix_hits"] < 2:
        raise AssertionError(f"prefix cache: prewarms {m0['prefix_prewarms']}, hits {m1['prefix_hits']}")
    if fused:
        runs = per_request[-len(RUNS):]
        if sum(r["inloop_spec_accepted"] for r in runs) <= 0 or m1["spec_rounds"] != 0:
            raise AssertionError(f"{name}: no in-loop draft accepted on the one-byte runs: {per_request}")
        if m2["fused_injections_total"] <= 0 or m2["fused_loops_total"] <= 0:
            raise AssertionError(f"{name}: no lane absorbed into a loop in flight: "
                                 f"{({k: m2[k] for k in FUSED_KEYS})}")
    elif m1["spec_rounds"] <= 0 or m1["spec_accepted"] <= 0:
        raise AssertionError(f"no speculation in the script: {per_request}")
    verify_steps = m2.get("fused_verify_steps_total", 0) - m0.get("fused_verify_steps_total", 0)
    want = n_layers * (m2["prefill_chunks"] - m0["prefill_chunks"] + m2["spec_rounds"] - m0["spec_rounds"]
                       + verify_steps)
    if launches[prefill.__name__] != want:
        raise AssertionError(f"{prefill.__name__}: {launches[prefill.__name__]} launches, "
                             f"{n_layers} x (prefill chunks + verify rounds + loop verify iterations) "
                             f"= {want}")
    if launches[decode.__name__] <= 0 or any(launches[fn.__name__] for fn in others):
        raise AssertionError(f"{name} feature phase launches: {launches}")
    if m2["worker_errors"] or m2["expired_total"] < 1 or m2["cancelled_total"] < B or m2["shed_total"] < 1:
        raise AssertionError(f"{name} feature phase counters: {({k: m2[k] for k in FEATURE_KEYS})}")
    if moe is not None and script_texts is not None:
        extra["first_divergence"] = _first_divergence(texts, script_texts)
        log(f"{name}: first divergence from the dense-einsum dense phase's script text: "
            f"{extra['first_divergence']}")
    elif fused and script_texts is not None:
        extra["first_divergence"] = _first_divergence(texts, script_texts)
        extra["fused"] = {k: m2[k] - m0[k] if isinstance(m2[k], int) else m2[k] for k in FUSED_KEYS}
        log(f"{name}: first divergence from the unfused phase's script text: {extra['first_divergence']}; "
            f"fused counters {extra['fused']}")
    elif script_texts is not None and texts != script_texts:
        raise AssertionError(f"paged feature text differs from the dense feature phase's: {texts} {script_texts}")
    log(f"{name} features: script in {script_s:.2f}s, served {serve_s:.2f}s; launches {launches}; "
        f"after the script {({k: m1[k] for k in FEATURE_KEYS})}; per request {per_request}; burst {codes}")
    return {
        "pipeline": pipeline,
        "graphs": graphs,
        "stream": stream,
        **extra,
        "launches": launches,
        "forwards": forwards,
        "param_hbm_bytes": m2["param_hbm_bytes"],
        "moe": {k: m2.get(k) for k in ("moe_routed", "moe_decode_dropless", "moe_capacity_factor")},
        "peak_memory_bytes": peak,
        "load_s": load_s,
        "script_s": script_s,
        "serve_s": serve_s,
        "prefix_prewarms": m0["prefix_prewarms"],
        "after_script": {k: m1[k] for k in FEATURE_KEYS},
        "script_per_request": per_request,
        "end": {k: m2[k] for k in FEATURE_KEYS},
        "script_ttft_ms": [doc["ttft_ms"] for _, doc in replies[: len(SCRIPT)]],
        "newcomer_ttft_ms": newcomer["ttft_ms"],
        "burst_codes": codes,
        "texts": texts,
    }


# sampled /generate requests on the approx_topk engine: (top_k, top_p)
APPROX_SAMPLED = ((50, 0.9), (200, 1.0), (0, 0.5))


def _approx_sampled(port: int, name: str) -> dict:
    """Sampled /generate requests on an engine that samples through
    ``approx_topk`` (its sampled decode and verify graphs were captured
    with it); each answers 200 with tokens."""
    _, m0 = _http(port, "GET", "/metrics")
    if m0["approx_topk"] is not True:
        raise AssertionError(f"{name}: approx_topk is off: {m0['approx_topk']}")
    out = []
    for top_k, top_p in APPROX_SAMPLED:
        _, doc = _http(port, "POST", "/generate", {
            "prompt": f"Sampled request, top_k {top_k}, top_p {top_p}:", "max_tokens": 16,
            "temperature": 1.0, "top_k": top_k, "top_p": top_p,
        })
        if doc["completion_tokens"] <= 0:
            raise AssertionError(f"{name}: approx_topk sampled request: {doc}")
        out.append({"top_k": top_k, "top_p": top_p, "completion_tokens": doc["completion_tokens"]})
    _, m1 = _http(port, "GET", "/metrics")
    log(f"{name} approx_topk sampled: {out}")
    return {"requests": out, "graph_replays": m1["graph_replays"] - m0["graph_replays"]}


# the port's kernels by their device names in a profiler trace
KERNEL_NAMES = {"prefill_kernel", "decode_kernel", "decode_combine_kernel", "w8a16_grouped_kernel"}


def _profile_during_a_request(port: int, trace_dir: str) -> dict:
    """``/profile`` while a long /chat decodes: 200 with the trace
    directory, and its Chrome trace names the port's kernels."""
    box: dict = {}
    th = threading.Thread(target=lambda: box.update(doc=_http(port, "POST", "/chat", {
        "session": "profiled", "message": "A long answer, please.", "max_tokens": 400,
        "ignore_eos": True,
    })[1]))
    th.start()
    time.sleep(0.3)
    _, doc = _http(port, "POST", "/profile", {"duration_s": 0.5})
    th.join(timeout=300)
    if doc["trace_dir"] != trace_dir or box.get("doc", {}).get("usage", {}).get("completion_tokens") != 400:
        raise AssertionError(f"/profile during a request: {doc} {box}")
    names: set = set()
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    for f in files:
        with open(os.path.join(trace_dir, f)) as fh:
            events = json.load(fh).get("traceEvents", [])
        names |= {_kernel_name(e.get("name", "")) for e in events if e.get("cat") == "kernel"}
    found = sorted(names & KERNEL_NAMES)
    if "decode_kernel" not in found:
        raise AssertionError(f"/profile trace holds none of the port's kernels: {sorted(names)[:20]}")
    log(f"/profile: {doc}; {len(files)} trace file(s); port kernels in it: {found}")
    return {"reply": doc, "files": len(files), "port_kernels": found}


ASSISTANT_TURNS = ("Who are you?", "Say that again, in fewer words.")


def _assistant_turns(app) -> dict:
    """An assistant-flavor app attached to a loaded engine (no second load):
    two turns of one session, each generated statelessly from the flattened
    prompt; each reply beside the llm flavor's /generate of that prompt
    (reported: a prefix fork of the second call may move a bf16 near-tie)."""
    from agentainer_tpu_torch.engine.llm_serve import ASSISTANT_PERSONA, LLMServeApp, Request

    asst = LLMServeApp(env={
        "AGENTAINER_AGENT_ID": "chip-smoke-assistant", "AGENTAINER_MODEL_CONFIG": "llama3-8b",
        "AGENTAINER_ENGINE": "assistant",
    })
    asst.engine = app.engine
    turns = []
    for msg in ASSISTANT_TURNS:
        prompt = asyncio.run(asst._flattened_prompt("asst", msg))
        body = json.dumps({"session": "asst", "message": msg, "max_tokens": 16}).encode()
        resp = asyncio.run(asst.h_chat(Request("POST", "/chat", {}, body)))
        if (resp.status != 200 or resp.doc["persona"] != ASSISTANT_PERSONA
                or resp.doc["usage"]["completion_tokens"] != 16):
            raise AssertionError(f"assistant /chat: {resp.status} {resp.doc}")
        _, gen = _http(app.port, "POST", "/generate", {"prompt": prompt, "max_tokens": 16})
        # (random weights: most of llama3-8b's ids decode to no byte, so a
        # reply's text may be empty)
        turns.append({"prompt_chars": len(prompt), "response": resp.doc["response"],
                      "equal_to_generate": resp.doc["response"] == gen["text"]})
    if f"Assistant: {turns[0]['response']}" not in asyncio.run(asst._flattened_prompt("asst", "x")):
        raise AssertionError("assistant: the second turn's prompt lacks the first reply")
    log(f"assistant flavor on the dense engine: {turns}")
    return {"turns": turns}


# lanes 0-3 live in the graph phase (a 64-slot tile and a page crossed by
# the verify rows), lanes 4-7 parked
GRAPH_LIVE_POS = (40, 300, 777, 1500)


def _decode_step_ms(engine, replays: int = 5) -> dict:
    """Device ms of one decode step of the idle engine's 8-step greedy
    graph, lanes 0-1 live at 300 / 312 and 2-7 parked: the median of
    ``replays`` replays, each between two CUDA events, over its 8 steps."""
    import statistics

    import torch

    from agentainer_tpu_torch.engine.graphs import live_lanes, park_lanes

    key, device = ("decode", 8, True), []
    try:
        with torch.no_grad(), engine._on_stream():
            for _ in range(replays):
                live_lanes(engine, [300, 312], 0.0, seed=0)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                engine._graphs.replay(key)
                end.record()
                end.synchronize()
                device.append(start.elapsed_time(end))
    finally:
        park_lanes(engine)
    return {"device_ms": statistics.median(device) / key[1], "replay_ms": device,
            "lanes": "0-1 live at 300 / 312, 2-7 parked"}


def phase_contracts(app, name: str) -> dict:
    """The runtime contracts (``analysis/contracts.py``) on a served feature
    engine, after its graphs check: the feature script's second pass (fresh
    sessions) through the serve layer under ``capture_budget(engine, 0)``
    (no step key outside the warmed set, no capture, every dispatch a
    replay), ``buffers_in_place(engine)`` and ``no_implicit_sync()`` (a
    process-wide mode: the worker too); then one replay of every captured
    step key traced (``launches_per_replay``), gated on
    ``AttentionLaunches``: the arena's attention wrapper launches n_layers ×
    its device launches per call × the step's forwards, and no other kernel
    of the table. A trace that lost device records is taken again, up to
    TRACE_ATTEMPTS times."""
    import torch

    from agentainer_tpu_torch.analysis.contracts import (
        AttentionLaunches,
        buffers_in_place,
        capture_budget,
        check,
        launches_per_replay,
        no_implicit_sync,
    )
    from agentainer_tpu_torch.engine.graphs import park_lanes

    engine, port = app.engine, app.port
    t0 = time.monotonic()
    replies: list = []
    with capture_budget(engine, 0) as seen, buffers_in_place(engine) as kinds, no_implicit_sync():
        for s, msg, n in SCRIPT:
            if s is None:
                status, doc = _http(port, "POST", "/generate", {"prompt": msg, "max_tokens": n})
                if status != 200:
                    raise AssertionError(f"{name} contracts: /generate {status} {doc}")
            else:
                _chat(port, replies, f"{s}-c", msg, n)
    script_s = time.monotonic() - t0
    if not {"prefill", "decode", "verify"} <= set(kinds):
        raise AssertionError(f"{name} contracts: the second pass dispatched {dict(seen)}")
    park_lanes(engine)
    want = AttentionLaunches(n_layers=engine.cfg.n_layers, paged=engine.paged)
    per_key = {}
    t1 = time.monotonic()
    for key in engine._step_keys():
        for attempt in range(TRACE_ATTEMPTS):
            with torch.no_grad(), engine._on_stream():
                got = launches_per_replay(engine._graphs, key)
            if not want.failures(got):
                break
        check(got, want)
        per_key[f"{key[0]}{key[1]}_{'greedy' if key[2] else 'sampled'}"] = {
            "all": got["all"], "attempts": attempt + 1,
            "wrappers": {w: v["device"] for w, v in got["wrappers"].items() if v["device"]},
        }
    out = {
        "dispatched": {f"{k[0]}{k[1]}_{'greedy' if k[2] else 'sampled'}": n for k, n in sorted(seen.items())},
        "steps_by_kind": dict(kinds), "script_s": script_s, "trace_s": time.monotonic() - t1,
        "launches_per_replay": per_key,
    }
    log(f"{name} contracts: the script's second pass in {script_s:.1f}s under capture_budget(0), "
        f"buffers_in_place and no_implicit_sync; steps {dict(kinds)}; launches per replay {per_key}")
    return out


def phase_graphs(engine, name: str) -> dict:
    """Every captured step graph of a served engine against its eager step
    function, from one saved state (``compare_replay``): greedy steps must
    give equal tokens, carry, verify inputs, block table and KV bytes, bit
    for bit; sampled steps must repeat their tokens when replayed twice from
    one generator state (whether a sampled replay equals the eager sampled
    step is reported, not gated). The engine is idle; its lanes are parked
    again after."""
    import torch

    from agentainer_tpu_torch.engine.graphs import compare_replay, live_lanes, park_lanes

    keys = engine._step_keys()
    want = (
        {("prefill", b) for b in (32, 64, 128, 256)} | {("decode", c) for c in (1, 2, 4, 8)}
        | {("verify", k) for k in (2, 4, 8)}
    )
    if {(kind, n) for kind, n, _ in keys} != want or len(engine._graphs) != len(keys):
        raise AssertionError(f"{name}: captured {len(engine._graphs)} graphs for steps {keys}")
    out = {}
    t0 = time.monotonic()
    for temperature, greedy in ((0.0, True), (1.0, False)):
        live_lanes(engine, list(GRAPH_LIVE_POS), temperature, seed=int(greedy))
        try:
            for key in (k for k in keys if k[2] == greedy):
                with torch.no_grad(), engine._on_stream():
                    got = compare_replay(
                        engine._graphs, key, engine._step_fn(key), engine._device_state(), engine._gen
                    )
                tag = f"{key[0]}{key[1]}_{'greedy' if greedy else 'sampled'}"
                ok = got["replay_repeats"] and (not greedy or (got["tokens_equal"] and got["state_equal"]))
                if not ok:
                    raise AssertionError(f"{name} graph {tag} against its eager step: {got}")
                out[tag] = got
        finally:
            park_lanes(engine)
    log(f"{name} graphs: {len(out)} steps held against eager in {time.monotonic() - t0:.1f}s: {out}")
    return out


# -- the checkpoint plane -----------------------------------------------------

# llama3-8b's published config.json fields, as a HF checkpoint carries them
LLAMA3_8B_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128256,
    "hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "intermediate_size": 14336, "max_position_embeddings": 8192,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-05, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
CKPT_SHARDS = 4
CKPT_MARGIN = 1 << 30  # free bytes kept beside the checkpoint


def _hf_named(params: dict, n_layers: int) -> dict:
    """The port's parameter tree under HF's names, each projection
    transposed back to HF's [out, in] (views; copied one at a time by the
    writer)."""
    lay = params["layers"]
    named = {"model.embed_tokens.weight": params["embed"]}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        named[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        for leaf, proj in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                           ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")):
            named[f"{p}{proj}.weight"] = lay[leaf][i].t()
        named[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        for leaf, proj in (("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                           ("w_down", "mlp.down_proj")):
            named[f"{p}{proj}.weight"] = lay[leaf][i].t()
    named["model.norm.weight"] = params["final_norm"]
    named["lm_head.weight"] = params["lm_head"].t()
    return named


def _write_safetensors(path: str, tensors: dict) -> int:
    """One bf16 safetensors file, written with the standard library: the
    8-byte little-endian header length, the JSON header (dtype, shape,
    data_offsets per tensor), then each tensor's bytes, copied to the host
    one tensor at a time. Returns the bytes written."""
    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().cpu().view(torch.int16).numpy()))
    return 8 + len(raw) + offset


def phase_write_checkpoint(root: str) -> dict:
    """The dense serve phase's weights (llama3-8b, bf16, seed 0, as
    ``create`` makes them) written as a HF checkpoint: ``CKPT_SHARDS``
    safetensors files with an index and llama3-8b's config.json. Fails,
    naming the free bytes, if the disk lacks the room."""
    import shutil

    import torch

    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import init_params

    cfg = get_config("llama3-8b")
    need = cfg.param_bytes() + CKPT_MARGIN
    free = shutil.disk_usage(root).free
    if free < need:
        raise RuntimeError(f"{root}: {free} bytes free, the checkpoint needs {need}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=torch.device("cuda", 0))
    named = _hf_named(params, cfg.n_layers)
    names = list(named)
    per = -(-len(names) // CKPT_SHARDS)
    weight_map, written = {}, 0
    for i in range(CKPT_SHARDS):
        shard = f"model-{i + 1:05d}-of-{CKPT_SHARDS:05d}.safetensors"
        part = names[i * per : (i + 1) * per]
        written += _write_safetensors(os.path.join(root, shard), {n: named[n] for n in part})
        weight_map.update({n: shard for n in part})
    with open(os.path.join(root, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": cfg.param_bytes()}, "weight_map": weight_map}, f)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(LLAMA3_8B_HF_CONFIG, f)
    del params, named
    gc.collect()
    torch.cuda.empty_cache()
    write_s = time.monotonic() - t0
    log(f"wrote a {written}-byte llama3-8b HF checkpoint ({CKPT_SHARDS} shards) in {write_s:.1f}s")
    return {"bytes": written, "write_s": write_s, "free_before": free, "shards": CKPT_SHARDS}


def _bpe_turn(engine) -> dict:
    """Phase 6's first request through the fixture's tokenizer on phase 6's
    engine (the tokenizer swapped in for one greedy turn of a fresh
    session, then put back): what 7e's agent, served from the same weights
    with the fixture's ``tokenizer.json``, must answer."""
    from agentainer_tpu_torch.engine.tokenizer import load_tokenizer

    d = _fixture_dir("atpu-tok-")
    try:
        tok = load_tokenizer(engine.cfg.vocab_size, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    byte_tok, engine.tokenizer = engine.tokenizer, tok
    try:
        res = asyncio.run(engine.chat("bpe", REQUESTS[0][1], max_tokens=16, ignore_eos=True))
    finally:
        engine.tokenizer = byte_tok
    if res["prompt_tokens"] != len(tok.encode(REQUESTS[0][1], add_bos=False)) + 1:
        raise AssertionError(f"the BPE turn's prompt tokens {res['prompt_tokens']} are not the reader's + bos")
    return {"tokens": res["tokens"], "prompt_tokens": res["prompt_tokens"], "text": res["text"]}


def phase_checkpoint(root: str, dense_texts: list[str], card: str) -> dict:
    """``/chat`` served from the checkpoint through ``AGENTAINER_CHECKPOINT``
    (its config.json gives the model), the features off as in the dense
    phase: the four requests must give the dense phase's greedy text, since
    the bf16 weights and their transposes went to disk and back exactly."""
    import torch

    from agentainer_tpu_torch.ops import cuda_attention as ca

    gc.collect()
    torch.cuda.empty_cache()
    options = {"device": "cuda", "max_batch": B, "max_seq": S, **FEATURES_OFF}
    with _serving(options, checkpoint=root) as (app, load_s):
        _, m0 = _http(app.port, "GET", "/metrics")
        kernels = (ca.flash_prefill, ca.flash_decode)
        for fn in kernels:
            fn.launches = 0
        replies = []
        texts = _four_requests(app.port, replies)
        launches = {fn.__name__: fn.launches for fn in kernels}
        _, metrics = _http(app.port, "GET", "/metrics")
        bpe_turn = _bpe_turn(app.engine)
    if texts != dense_texts:
        raise AssertionError(f"greedy text served from the checkpoint differs from the dense phase's: "
                             f"{texts} {dense_texts}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched serving from the checkpoint")
    read, secs = metrics["checkpoint_bytes_read"], metrics["checkpoint_load_s"]
    log(f"checkpoint: loaded {read} bytes in {secs:.2f}s ({read / secs / 1e9:.2f} GB/s) on {card}; "
        f"engine up in {load_s:.1f}s; the four requests' text equals the dense phase's; launches {launches}")
    return {
        "pipeline": _pipeline("checkpoint", m0, metrics),
        "bytes_read": read, "load_s": secs, "gb_per_s": read / secs / 1e9, "engine_up_s": load_s,
        "launches": launches, "same_text_as_dense": True, "card": card,
        "metrics": {k: metrics.get(k) for k in METRIC_KEYS}, "bpe_turn": bpe_turn,
    }


def _int8_leaves(params: dict, prefix: str = ""):
    from agentainer_tpu_torch.ops.quant import QTensor

    for key, val in params.items():
        if isinstance(val, dict):
            yield from _int8_leaves(val, f"{prefix}{key}.")
        elif isinstance(val, QTensor):
            yield f"{prefix}{key}.q", val.q
            yield f"{prefix}{key}.scale", val.scale
        else:
            yield f"{prefix}{key}", val


def phase_checkpoint_int8(root: str, card: str) -> dict:
    """The checkpoint served with ``quant: int8`` (each weight quantized on
    the card as it streams), then a ``quant: int8`` engine from the seed-0
    random init (the checkpoint's weights, quantized a layer slice at a
    time): the two int8 trees bit-equal leaf by leaf, the four requests'
    greedy text equal, every weight product through ``w8a16_matmul``."""
    import torch

    from agentainer_tpu_torch.ops import cuda_quant as cq

    out, texts, trees = {}, {}, {}
    for source in ("checkpoint", "random init"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        options = {"device": "cuda", "seed": 0, "max_batch": B, "max_seq": S, "quant": "int8", **FEATURES_OFF}
        with _serving(options, checkpoint=root if source == "checkpoint" else "") as (app, load_s):
            _, m0 = _http(app.port, "GET", "/metrics")
            cq.w8a16_matmul.launches = 0
            replies = []
            texts[source] = _four_requests(app.port, replies)
            w8 = cq.w8a16_matmul.launches
            _, metrics = _http(app.port, "GET", "/metrics")
            trees[source] = dict(_int8_leaves(app.engine.params))
        forwards = _forwards(m0, metrics)
        if w8 != (W8_PER_LAYER * 32 + 1) * forwards or metrics["param_hbm_bytes"] != INT8_PARAM_BYTES:
            raise AssertionError(f"int8 from the {source}: w8a16_matmul {w8} launches for {forwards} "
                                 f"forwards; param_hbm_bytes {metrics['param_hbm_bytes']}")
        out[source] = {
            "pipeline": _pipeline(f"int8 from the {source}", m0, metrics), "engine_up_s": load_s,
            "checkpoint_load_s": metrics["checkpoint_load_s"], "bytes_read": metrics["checkpoint_bytes_read"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "w8a16_launches": w8,
            "forwards": forwards,
        }
        log(f"int8 from the {source}: engine up in {load_s:.1f}s, {out[source]}")
    a, b = trees["checkpoint"], trees["random init"]
    differ = [k for k in a if k not in b or a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    if sorted(a) != sorted(b) or differ:
        raise AssertionError(f"int8 tree from the checkpoint differs from the random init's: {differ}")
    if texts["checkpoint"] != texts["random init"]:
        raise AssertionError(f"int8 greedy text differs: {texts}")
    read, secs = out["checkpoint"]["bytes_read"], out["checkpoint"]["checkpoint_load_s"]
    log(f"int8 checkpoint: {len(a)} leaves bit-equal to the random init's; the same greedy text; "
        f"loaded and quantized {read} bytes in {secs:.2f}s ({read / secs / 1e9:.2f} GB/s) on {card}")
    del trees, a, b
    return {**out, "leaves_equal": True, "same_text": True, "gb_per_s": read / secs / 1e9, "card": card}


# crash-resume: turn one, a snapshot, the crash, turn two on another engine
RESUME_TURNS = (
    ("Tell me the story of a lighthouse keeper who finds an old map in the lamp room.", 192),
    ("What did the map show, and where did it lead?", 48),
)


def _logit_gap(engine, stream: list[int], a: int, b: int) -> float:
    """The last position's logit of token ``a`` minus token ``b`` after
    feeding ``stream`` through the engine's model (a fresh one-row cache)."""
    import torch

    from agentainer_tpu_torch.models.llama import KVCache, forward

    dev = engine.device
    with torch.no_grad():
        cache = KVCache.create(engine.cfg, 1, len(stream) + 1, dtype=engine.cache.k.dtype, device=dev)
        toks = torch.tensor([stream], device=dev)
        pos = torch.arange(len(stream), device=dev, dtype=torch.int32)[None]
        logits = forward(engine.params, engine.cfg, toks, pos, cache)[0, -1]
    return float(logits[a] - logits[b])


def phase_resume(root: str, card: str) -> dict:
    """Crash-resume across arenas, llama3-8b from the checkpoint with the
    reference's default features: a dense engine serves turn one of session
    s, snapshots it and shuts down; a paged engine serves turns one and two
    of session u with the same messages (a snapshot of u after turn one),
    then restores s and serves its turn two. Gates: s's turn two equals
    u's, the two blobs' payloads are bit-equal, the restore bound no lane,
    and all four kernels launched."""
    import torch

    from agentainer_tpu_torch.engine.checkpoint import deserialize_kv_slot
    from agentainer_tpu_torch.engine.llm import LLMEngine
    from agentainer_tpu_torch.ops import cuda_attention as ca

    (m1, n1), (m2, n2) = RESUME_TURNS
    opts = {"device": "cuda", "max_batch": B, "max_seq": S}
    kernels = (ca.flash_prefill, ca.flash_decode, ca.fused_paged_flash_prefill, ca.fused_paged_flash_decode)
    gc.collect()
    torch.cuda.empty_cache()
    for fn in kernels:
        fn.launches = 0

    async def chat(eng, session, message, n):
        return (await eng.chat(session, message, max_tokens=n, ignore_eos=True))["tokens"]

    t0 = time.monotonic()
    dense = LLMEngine.create("", checkpoint=root, options=opts)
    try:
        s1 = asyncio.run(chat(dense, "s", m1, n1))
        t1 = time.monotonic()
        blob = asyncio.run(dense.snapshot_session("s"))
        snap_wall_ms = 1000 * (time.monotonic() - t1)
        snap = dict(dense.snapshot_timings[-1])
        # the same snapshot again, its pinned size class now cached (the
        # limiter's 2 s gap opened for it)
        dense.snapshot_min_gap_s = 0.0
        again = asyncio.run(dense.snapshot_session("s"))
        warm = dict(dense.snapshot_timings[-1])
    finally:
        dense.shutdown()  # the crash
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    paged = LLMEngine.create("", checkpoint=root, options={**opts, "paged_kv": True, "page_size": PS})
    try:
        u1 = asyncio.run(chat(paged, "u", m1, n1))
        pblob = asyncio.run(paged.snapshot_session("u"))
        paged_snap = dict(paged.snapshot_timings[-1])
        u2 = asyncio.run(chat(paged, "u", m2, n2))
        t1 = time.monotonic()
        restored = asyncio.run(paged.restore_session("s", blob))
        torch.cuda.synchronize()
        restore_ms = 1000 * (time.monotonic() - t1)
        lane = paged.paged_sessions["s"].lane if restored else "not restored"
        s2 = asyncio.run(chat(paged, "s", m2, n2))
        gap = None
        if s2 != u2:
            j = next(i for i, (x, y) in enumerate(zip(s2, u2)) if x != y)
            enc = paged.tokenizer.encode
            stream = enc(m1) + u1 + enc(m2) + u2[:j]
            gap = _logit_gap(paged, stream, u2[j], s2[j])
            log(f"resume: turn two diverges at token {j}: {u2[j]} (uninterrupted) vs {s2[j]} "
                f"(restored); logit gap {gap:.4g} after the uninterrupted stream")
        m = paged.metrics()
    finally:
        paged.shutdown()
    total_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    (dk, dv, dh), (pk, pv, ph) = deserialize_kv_slot(blob), deserialize_kv_slot(pblob)
    same_payload = dh["position"] == ph["position"] and torch.equal(dk, pk) and torch.equal(dv, pv)
    out = {
        "position": dh["position"], "blob_raw_bytes": snap["raw_bytes"], "blob_bytes": len(blob),
        "alloc_ms": snap["alloc_ms"], "stage_ms": snap["stage_ms"], "pack_ms": snap["pack_ms"],
        "snapshot_wall_ms": snap_wall_ms, "warm_alloc_ms": warm["alloc_ms"],
        "warm_stage_ms": warm["stage_ms"], "warm_pack_ms": warm["pack_ms"],
        "same_blob_again": deserialize_kv_slot(again)[0].equal(dk),
        "paged_alloc_ms": paged_snap["alloc_ms"], "paged_stage_ms": paged_snap["stage_ms"],
        "paged_pack_ms": paged_snap["pack_ms"],
        "restore_ms": restore_ms, "restored_lane": lane, "same_turn_one": s1 == u1,
        "same_payload": same_payload, "same_turn_two": s2 == u2, "logit_gap": gap,
        "launches": launches, "spec_rounds": m["spec_rounds"], "worker_errors": m["worker_errors"],
        "phase_s": total_s, "card": card,
    }
    log(f"resume: {out}")
    if not restored or lane is not None:
        raise AssertionError(f"the dense snapshot did not restore into pages without a lane: {restored} {lane}")
    if not same_payload:
        raise AssertionError(f"the paged snapshot of u differs from the dense snapshot of s: {dh} {ph}")
    if s2 != u2:
        raise AssertionError(f"restored turn two {s2} differs from the uninterrupted {u2}")
    for fn in kernels:
        if launches[fn.__name__] <= 0:
            raise AssertionError(f"{fn.__name__} was never launched in the resume phase: {launches}")
    if m["worker_errors"]:
        raise AssertionError(f"resume phase worker errors: {m['worker_errors']}")
    return out


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
            out[name] = {
                "max_abs_err": err, "max_abs_logit": scale, "paged_vs_dense_max_abs_err": paged_err,
                **_model_feature_checks(params, cfg, dtype, dev, scale),
            }
            del params, logits, got, want, cache, paged
    out["tolerance"] = {
        "bfloat16": f"{BF16_LOGIT_TOL} * max(1, |logit|)", "float32": F32_LOGIT_TOL,
        "paged_vs_dense_float32": F32_TOL,
        "verify_vs_decode_and_fork_vs_full": "as kernels vs plain",
    }
    return out


def phase_model_int8() -> dict:
    """The 2-layer llama3-8b-width model in int8 (bf16 init from seed 1,
    quantized on the card): a prefill chunk then one decode step, logits
    with ``w8a16_matmul`` against the kernel's plain version (``qmatmul``
    forced to it), both with the attention kernels, within
    ``BF16_LOGIT_TOL`` of the largest logit; the kernel launches 7 per
    layer + 1 per forward."""
    import dataclasses

    import torch

    from agentainer_tpu_torch.engine.quant import quantize_params
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import KVCache, forward, init_params
    from agentainer_tpu_torch.ops import cuda_quant as cq

    cfg = dataclasses.replace(get_config("llama3-8b"), name="llama3-8b-2l", n_layers=2)
    dev = torch.device("cuda")
    b, t, s = 2, 128, 512
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    with torch.no_grad():
        params = quantize_params(init_params(cfg, g, dtype=torch.bfloat16, device=dev), torch.bfloat16)
        tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)
        pos = (torch.tensor([0, 200], device=dev)[:, None] + torch.arange(t, device=dev)[None]).to(torch.int32)
        logits = {}
        for kernel in (True, False):
            before = cq.w8a16_matmul.launches
            with contextlib.nullcontext() if kernel else _plain_products():
                cache = KVCache.create(cfg, b, s, dtype=torch.bfloat16, device=dev)
                pre = forward(params, cfg, tokens, pos, cache)
                dec = forward(params, cfg, tokens[:, -1:], pos[:, -1:] + 1, cache)
            launched = cq.w8a16_matmul.launches - before
            want = (W8_PER_LAYER * cfg.n_layers + 1) * 2 if kernel else 0
            if launched != want:
                raise AssertionError(f"int8 forward (kernel={kernel}): {launched} launches, want {want}")
            logits[kernel] = torch.cat([pre, dec], dim=1)
    got, want = logits[True], logits[False]
    if not torch.isfinite(got).all():
        raise AssertionError("int8 forward with the kernel gave non-finite logits")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    log(f"2-layer llama3-8b int8 forward, w8a16_matmul vs plain: max abs err {err:.3g}, max |logit| {scale:.3g}")
    if err / scale > BF16_LOGIT_TOL:
        raise AssertionError(f"int8 forward with the kernel disagrees with the plain path: {err}")
    return {"max_abs_err": err, "max_abs_logit": scale, "tolerance": f"{BF16_LOGIT_TOL} * max(1, |logit|)"}


def _model_feature_checks(params, cfg, dtype, dev, scale: float) -> dict:
    """(a) a verify forward at [8, K + 1] (lanes 6-7 parked) against K + 1
    one-token decode steps on a copy of the same arena, live lanes row by
    row; (b) a tail prefill after a prefix fork (the first 64 positions
    copied from another arena row) against the full prefill. f32 within
    F32_LOGIT_TOL, bf16 within BF16_LOGIT_TOL of the largest logit. In bf16
    also the first index where greedy decoding through verify rounds (each
    drafting the plain stream's next K tokens) leaves the plain stream;
    reported, not gated."""
    import torch

    from agentainer_tpu_torch.models.llama import KVCache, forward

    name = str(dtype).removeprefix("torch.")
    b, s, n_ctx, kk = B, 512, 128, 8
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    ar = lambda n, lo=0: torch.arange(lo, lo + n, device=dev, dtype=torch.int32)  # noqa: E731

    def clone(c):
        return KVCache(c.k_store.clone(), c.v_store.clone())

    def check(what, got, want):
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what} ({name}): non-finite logits")
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL,
                                       msg=lambda m: f"{what} (f32): {m}")
        elif err / scale > BF16_LOGIT_TOL:
            raise AssertionError(f"{what} (bf16): max abs err {err}")
        log(f"2-layer llama3-8b {name}, {what}: max abs err {err:.3g}")
        return err

    ctx = torch.randint(0, cfg.vocab_size, (b, n_ctx), generator=g, device=dev)
    cache = KVCache.create(cfg, b, s, dtype=dtype, device=dev)
    pre = forward(params, cfg, ctx, ar(n_ctx).expand(b, n_ctx), cache)
    base = clone(cache)
    # (a) live lanes start at ragged positions, two crossing a 64-slot tile
    start = torch.tensor([128, 100, 63, 120, 61, 125, s - 1, s - 1], device=dev, dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (b, kk + 1), generator=g, device=dev)
    positions = torch.clamp(start[:, None] + ar(kk + 1), max=s - 1)
    ver = forward(params, cfg, toks, positions, cache)
    seq_cache = clone(base)
    seq = torch.cat([
        forward(params, cfg, toks[:, j : j + 1], positions[:, j : j + 1], seq_cache) for j in range(kk + 1)
    ], dim=1)
    out = {"verify_vs_decode_max_abs_err": check("verify [8, 9] vs 9 decode steps", ver[:6], seq[:6])}
    # (b) prefix fork + tail prefill against the full prefill (lane 0)
    full = forward(params, cfg, ctx[:1, :96], ar(96)[None], KVCache.create(cfg, 1, s, dtype=dtype, device=dev))
    forked = KVCache.create(cfg, 1, s, dtype=dtype, device=dev)
    forked.k_store[:, 0, :64].copy_(base.k_store[:, 0, :64])
    forked.v_store[:, 0, :64].copy_(base.v_store[:, 0, :64])
    tail = forward(params, cfg, ctx[:1, 64:96], ar(32, 64)[None], forked)
    out["fork_vs_full_max_abs_err"] = check("tail prefill after a fork vs full prefill", tail, full[:, 64:])
    if dtype == torch.bfloat16:
        out["greedy_spec_first_divergence"] = _greedy_divergence(params, cfg, base, pre, ar, s)
        log(f"2-layer llama3-8b bf16: greedy through verify rounds leaves the plain stream at index "
            f"{out['greedy_spec_first_divergence']} (None: never, in 48 tokens)")
    return out


def _greedy_divergence(params, cfg, base, pre, ar, s, n: int = 48, kk: int = 8):
    """Lane 0 from the same prefilled arena: plain greedy decode for n
    tokens, then greedy decode through verify rounds at [8, K + 1] whose
    drafts are the plain stream's next K tokens (lanes 1-7 parked); the
    first index where the two streams differ, or None."""
    import torch

    from agentainer_tpu_torch.models.llama import KVCache, forward

    b, dev = B, pre.device
    first = int(pre[0, -1].argmax())
    plain, cache = [first], KVCache(base.k_store.clone(), base.v_store.clone())
    tok = torch.zeros((b, 1), dtype=torch.long, device=dev)
    pos = torch.full((b, 1), s - 1, dtype=torch.int32, device=dev)
    for i in range(n):
        tok[0, 0], pos[0, 0] = plain[-1], 128 + i
        plain.append(int(forward(params, cfg, tok, pos, cache)[0, 0].argmax()))
    spec, cache, p = [first], KVCache(base.k_store.clone(), base.v_store.clone()), 128
    while len(spec) <= n:
        drafts = (plain[len(spec) : len(spec) + kk] + [0] * kk)[:kk]
        toks = torch.zeros((b, kk + 1), dtype=torch.long, device=dev)
        toks[0] = torch.tensor([spec[-1], *drafts], device=dev)
        positions = torch.full((b, kk + 1), s - 1, dtype=torch.int32, device=dev)
        positions[0] = ar(kk + 1, p)
        greedy = forward(params, cfg, toks, positions, cache)[0].argmax(dim=-1).tolist()
        a = 0
        while a < kk and drafts[a] == greedy[a]:
            a += 1
        spec += drafts[:a] + [greedy[a]]
        p += a + 1
    return next((i for i, (x, y) in enumerate(zip(plain, spec[: n + 1])) if x != y), None)


# -- the fused decode loop ---------------------------------------------------


def _first_divergence(got: list[str], want: list[str]) -> dict:
    """Per text pair, the first character index where ``got`` leaves
    ``want`` (None when equal)."""
    out = []
    for a, b in zip(got, want):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None and len(a) != len(b):
            i = min(len(a), len(b))
        out.append(i)
    return {"first_index": out, "equal": sum(i is None for i in out), "of": len(out)}


def phase_fused_graphs(engine, name: str) -> dict:
    """Each captured fused loop of a served engine against the eager loop
    over the same segment functions, from one saved state
    (``compare_replay``): lanes 0-2 live at 40 / 300 / 777 (lane 1 with a
    budget of 9), lane 3 armed from the shadow carry, histories that repeat
    (with in-loop spec the verify branch runs), a bound of cap - 3. Greedy:
    packed readback, carry, history, shadow carry, loop state and KV bytes
    equal bit for bit; sampled: two replays from one generator state give
    the same tokens. Prints the loop graphs' capture seconds (their
    segments' and the assembly's) and the engine's pool bytes."""
    import torch

    from agentainer_tpu_torch.engine.graphs import compare_replay, live_fused, live_lanes, park_lanes

    cap = engine._fused_cap
    keys = engine._step_keys()
    if {k for k in keys if k[0] == "fused"} != {("fused", cap, True), ("fused", cap, False)}:
        raise AssertionError(f"{name}: fused loop keys {keys}")
    out = {}
    t0 = time.monotonic()
    for temperature, greedy in ((0.0, True), (1.0, False)):
        key = ("fused", cap, greedy)
        live_lanes(engine, list(GRAPH_LIVE_POS), temperature, seed=int(greedy))
        live_fused(engine, list(GRAPH_LIVE_POS[:3]), temperature, seed=int(greedy), nsteps=cap - 3,
                   budgets=[cap + 1, 9, cap + 1], armed_lane=3)
        try:
            with torch.no_grad(), engine._on_stream():
                got = compare_replay(engine._graphs, key, engine._step_fn(key), engine._device_state(),
                                     engine._gen)
                packed = engine._graphs.replay(key).cpu()
        finally:
            park_lanes(engine)
        rows = cap + 1
        got.update(iterations=int(packed[rows + 2, 0]), verify_iterations=int(packed[rows + 5, 0]),
                   emitted=[int(x) for x in packed[rows, :4]])
        ok = got["replay_repeats"] and (not greedy or (got["tokens_equal"] and got["state_equal"]))
        if not ok or got["emitted"][1] != 9:
            raise AssertionError(f"{name} fused loop {'greedy' if greedy else 'sampled'} against its "
                                 f"eager loop: {got}")
        if greedy and engine.inloop_spec and got["verify_iterations"] <= 0:
            raise AssertionError(f"{name}: the verify branch never ran in the held loop: {got}")
        out["greedy" if greedy else "sampled"] = got
    by_kind = engine._graphs.capture_s_by_kind
    out["capture_s"] = {k: round(v, 4) for k, v in by_kind.items() if k.startswith("fused")}
    out["graph_capture_s"] = engine._graphs.capture_s
    out["graph_pool_bytes"] = engine._graphs.pool_bytes
    out["pool_bytes_by_kind"] = engine._graphs.pool_bytes_by_kind
    out["inloop_spec"] = engine.inloop_spec
    out["torch_if_node_api"] = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    log(f"{name} fused graphs held against the eager loop in {time.monotonic() - t0:.1f}s: {out}")
    return out


def _fused_early_exit(engine, name: str) -> dict:
    """One loop replay with the bound at the cap whose one live lane (lane
    0 at 300) freezes at its budget of 3, under torch.profiler: the dense
    decode kernel and its combine must launch n_layers x (the iterations
    the readback reports) times on the device, and the iterations must be
    fewer than the bound. The loop graph is assembled again once the
    profiler has come up (``StepGraphs.rebuild_loop``); a trace that lost
    device records is taken again, up to TRACE_ATTEMPTS times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from agentainer_tpu_torch.engine.graphs import live_fused, live_lanes, park_lanes

    cap = engine._fused_cap
    key = ("fused", cap, True)
    n_layers = engine.cfg.n_layers
    # the profiler traces every iteration only of a loop graph instantiated
    # after it first came up (StepGraphs.rebuild_loop)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    engine._graphs.rebuild_loop(key)
    for attempt in range(TRACE_ATTEMPTS):
        live_lanes(engine, [300, 312], 0.0, seed=0)
        live_fused(engine, [300], 0.0, seed=0, nsteps=cap, budgets=[3])
        try:
            with torch.no_grad(), engine._on_stream():
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    packed = engine._graphs.replay(key).clone()
                    torch.cuda.synchronize()
        finally:
            park_lanes(engine)
        steps = int(packed[cap + 3, 0])
        names = [_kernel_name(e.name) for e in prof.events() if e.device_type.name == "CUDA"]
        decode, combine = names.count("decode_kernel"), names.count("decode_combine_kernel")
        if decode == combine == n_layers * steps:
            break
    out = {"bound": cap, "iterations": steps, "decode_kernel": decode, "decode_combine_kernel": combine,
           "device_launches_want": 2 * n_layers * steps, "attempts": attempt + 1}
    if not (0 < steps < cap and decode == combine == n_layers * steps):
        raise AssertionError(f"{name}: the loop's early exit is not shown on the device: {out}")
    log(f"{name} early exit on the device: {out}")
    return out


def phase_fused_dense(dense_texts: list[str], serve: dict) -> dict:
    """llama3-8b at full width and depth, bf16, seed 0, the serve phase's
    options (features off) plus ``fused_decode``: the four requests must
    give the serve phase's greedy text token for token (a loop iteration is
    the ladder's [8, 1] decode step), one host readback per loop
    (``host_syncs_total`` = first tokens + loops), ``host_syncs_per_token``
    beside the serve phase's, an early exit proven on the device
    (``_fused_early_exit``) and in the served counters (a 4-token request:
    its loop freezes at 3 of 32 iterations), and the loop graphs held
    against their eager loop (``phase_fused_graphs``)."""
    import torch

    from agentainer_tpu_torch.ops import cuda_attention as ca

    gc.collect()
    torch.cuda.empty_cache()
    options = {"device": "cuda", "seed": 0, "max_batch": B, "max_seq": S, **FEATURES_OFF,
               "fused_decode": True}
    kernels = (ca.flash_prefill, ca.flash_decode)
    with _serving(options) as (app, load_s):
        log(f"llama3-8b fused dense engine loaded (init + warmup) in {load_s:.1f}s")
        _, m0 = _http(app.port, "GET", "/metrics")
        for fn in kernels:
            fn.launches = 0
        replies = []
        t1 = time.monotonic()
        texts = _four_requests(app.port, replies)
        serve_s = time.monotonic() - t1
        launches = {fn.__name__: fn.launches for fn in kernels}
        _, m1 = _http(app.port, "GET", "/metrics")
        _http(app.port, "POST", "/generate", {"prompt": "Four tokens, please.", "max_tokens": 4})
        _, m2 = _http(app.port, "GET", "/metrics")
        early = _fused_early_exit(app.engine, "fused dense")
        graphs = phase_fused_graphs(app.engine, "fused dense")
    loops = m1["fused_loops_total"] - m0["fused_loops_total"]
    syncs = m1["host_syncs_total"] - m0["host_syncs_total"]
    prefills = m1["prefills"] - m0["prefills"]
    exits = (m2["fused_exit_reason_hist"].get("early_all_finished", 0)
             - m1["fused_exit_reason_hist"].get("early_all_finished", 0))
    if texts != dense_texts:
        raise AssertionError(f"fused dense text differs from the serve phase's: {texts} {dense_texts}")
    if loops <= 0 or syncs != prefills + loops or exits < 1:
        raise AssertionError(f"fused dense: loops {loops}, host syncs {syncs}, prefills {prefills}, "
                             f"early exits {exits}")
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"fused dense launches: {launches}")
    out = {
        "pipeline": _pipeline("fused dense", m0, m1, load_s),
        "launches": launches,
        "serve_s": serve_s,
        "loops": loops,
        "loop_iterations": m1["fused_steps_total"] - m0["fused_steps_total"],
        "host_syncs": syncs,
        "host_syncs_per_token": m1["host_syncs_per_token"],
        "serve_phase_host_syncs_per_token": serve["pipeline"]["host_syncs_per_token"],
        "itl_ms_p50": m1["itl_ms_p50"],
        "serve_phase_itl_ms_p50": serve["pipeline"]["itl_ms_p50"],
        "early_exit": early,
        "graphs": graphs,
        "same_text_as_serve": True,
    }
    log(f"fused dense: {({k: v for k, v in out.items() if k not in ('graphs', 'pipeline')})}")
    return out


def phase_fused_int8_graphs(model: str = "llama3-8b") -> dict:
    """The 2-layer ``model``-width model in int8 (bf16 init from seed 1,
    quantized on the card) as a fused engine with in-loop spec: its loop
    graphs against their eager loop (``phase_fused_graphs``), with
    ``w8a16_matmul`` (and for Mixtral ``w8a16_grouped_matmul``) launched
    inside the loop's conditional bodies."""
    import dataclasses

    import torch

    from agentainer_tpu_torch.engine.llm import LLMEngine
    from agentainer_tpu_torch.engine.quant import quantize_params
    from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import init_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(model), name=f"{model}-2l", n_layers=2)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    with torch.no_grad():
        params = quantize_params(init_params(cfg, g, dtype=torch.bfloat16, device="cuda"), torch.bfloat16)
    eng = LLMEngine(cfg, params, ByteTokenizer(cfg.vocab_size), max_batch=B, max_seq=S,
                    fused_decode=True, device="cuda")
    try:
        eng.warmup()
        out = phase_fused_graphs(eng, f"int8 2-layer {model} fused")
        # the weight-product kernels each conditional body launches per iteration
        branches = eng._graphs._loops[("fused", eng._fused_cap, True)][3]
        out["body_launches"] = {
            branch: {w.__name__: c for w, c in branches.get(branch, ())} for branch in ("plain", "verify")
        }
        want = {"w8a16_matmul": (W8_PER_LAYER_MOE if cfg.is_moe else W8_PER_LAYER) * cfg.n_layers + 1}
        if cfg.is_moe:
            want["w8a16_grouped_matmul"] = GROUPED_PER_LAYER * cfg.n_layers
        for branch, got in out["body_launches"].items():
            if any(got.get(name) != n for name, n in want.items()):
                raise AssertionError(f"{model} fused loop: the {branch} body launches {got}, want {want}")
        log(f"int8 2-layer {model} fused loop bodies launch {out['body_launches']}")
        return out
    finally:
        eng.shutdown()


# -- the tiered KV hierarchy -------------------------------------------------

TIER_PARAGRAPH = (
    "The on-call rotation hands over at nine. Check the dashboards for the ingest queue, the "
    "replication lag and the error budget, note anything unusual in the handover document, and "
    "page the secondary if a metric stays red for more than ten minutes. Close with a summary. "
)


def _tier_prompt(i: int) -> str:
    """A ~280-byte turn-one prompt (about 300 tokens of context with its
    reply: 5 pages of 64), distinct per session from its first byte."""
    return f"[{i:02d}] " + TIER_PARAGRAPH[: 275 - 5]


def _tier_timings(engine, card: str) -> list[dict]:
    out = []
    for t in engine.tier_timings:
        row = dict(t)
        row["gb_per_s"] = round(t["bytes"] / (t["ms"] / 1e3) / 1e9, 3) if t["ms"] > 0 else None
        row["card"] = card
        out.append(row)
    return out


def phase_tiering_paged(card: str) -> dict:
    """The reference's defaults plus ``kv_tiering`` with ``tier_quantize``
    0 on a 64-page pool, llama3-8b at ``CUT_LAYERS`` (8) of 32 layers (a
    page is 64 x 8 x 128 x 2 B x 2 x 8 = 2,097,152 B: 128 MiB; 512 MiB at
    32 layers). A control session c serves turns one and two;
    session s serves turn one, is parked (``kv_pages_used`` falls by its
    pages, ``has_session`` holds), prewarmed, and its turn two must equal
    c's token for token. Then 16 sessions serve turn one in sequence (about
    80 pages against 64; the first with c's prompt): no 429, no
    destructive eviction, at least 4 pressure demotions; the first of them,
    demoted, serves turn two through a promotion, equal to c's."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    options = {"device": "cuda", "seed": 0, "max_batch": B, "max_seq": S, "paged_kv": True,
               "page_size": PS, "kv_pages": 64, "kv_tiering": True, "tier_quantize": 0}
    turn2 = "Now list the three checks as bullet points."
    with _serving(options, config=_cut_config("llama3-8b")) as (app, load_s):
        port, eng = app.port, app.engine
        log(f"llama3-8b ({CUT_LAYERS} layers) tiering (paged) engine loaded in {load_s:.1f}s")
        replies: list = []
        c1 = _chat(port, replies, "c", _tier_prompt(0), 16)
        c2 = _chat(port, replies, "c", turn2, 16)
        _chat(port, replies, "s", _tier_prompt(0), 16)
        _, m0 = _http(port, "GET", "/metrics")
        # s forked c's cached prefix: its shared pages stay pinned by the
        # prefix cache, its own pages go back to the pool
        sess = eng.paged_sessions["chip-smoke::s"]
        pages_s = len(sess.pages)
        own_s = sum(1 for p in sess.pages if eng._page_refs[p] == 1)
        _, park = _http(port, "POST", "/park", {"session": "s"})
        _, m1 = _http(port, "GET", "/metrics")
        if not park.get("parked") or m0["kv_pages_used"] - m1["kv_pages_used"] != own_s:
            raise AssertionError(f"/park of s: {park}, pages used {m0['kv_pages_used']} -> "
                                 f"{m1['kv_pages_used']}, s held {pages_s} ({own_s} its own)")
        if not eng.has_session("chip-smoke::s") or "chip-smoke::s" in eng.sessions:
            raise AssertionError("a parked session must stay known and leave the device")
        _, pre = _http(port, "POST", "/prewarm", {"session": "s"})
        s2 = _chat(port, replies, "s", turn2, 16)
        if pre != {"prewarmed": True} or s2["response"] != c2["response"]:
            raise AssertionError(f"s after park and prewarm: {pre}, {s2['response']!r} != {c2['response']!r}")
        _, m2 = _http(port, "GET", "/metrics")
        codes = []
        for i in range(16):
            status, _, doc = _http_any(port, "POST", "/chat", {
                "session": f"x{i}", "message": _tier_prompt(0 if i == 0 else i + 1),
                "max_tokens": 16, "ignore_eos": True,
            })
            codes.append(status)
        _, m3 = _http(port, "GET", "/metrics")
        x0 = "chip-smoke::x0"
        demoted_first = eng.has_session(x0) and x0 not in eng.sessions
        x0_2 = _chat(port, replies, "x0", turn2, 16)
        _, m4 = _http(port, "GET", "/metrics")
        timings = _tier_timings(eng, card)
    pressure = m3["tier_pressure_demotions_total"] - m2["tier_pressure_demotions_total"]
    evictions = m3["session_evictions_total"] - m2["session_evictions_total"]
    promoted = m4["tier_promotions_total"] - m3["tier_promotions_total"]
    out = {
        "load_s": load_s, "pages_of_s": pages_s, "own_pages_of_s": own_s, "park": park,
        "pages_used": [m0["kv_pages_used"], m1["kv_pages_used"]],
        "codes": codes, "pressure_demotions": pressure, "destructive_evictions": evictions,
        "x0_demoted": demoted_first, "x0_promotions": promoted,
        "tier": {k: m4[k] for k in m4 if k.startswith("tier_")},
        "timings": timings, "card": card,
    }
    if codes != [200] * 16 or evictions != 0 or pressure < 4:
        raise AssertionError(f"tiering under pool pressure: {out}")
    if not demoted_first or promoted < 1 or x0_2["response"] != c2["response"]:
        raise AssertionError(f"the first demoted session's turn two: {x0_2['response']!r} != "
                             f"{c2['response']!r}; {out}")
    log(f"tiering paged ({card}): {out}")
    out["c_turn_one_tokens"] = c1["usage"]["completion_tokens"]
    return out


def _quantizer_cost(card: str) -> dict:
    """The host tier's numpy quantizer (``quantize_kv_pages``) on one
    llama3-8b session's KV at 2,048 tokens: 32 x 2048 x 8 x 128 x 2 B =
    134,217,728 B per tensor (k and v: 268,435,456 B), from a pinned bf16
    copy, timed on the host."""
    import numpy as np
    import torch

    from agentainer_tpu_torch.engine.quant import quantize_kv_pages

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    k = torch.randn((32, S, 8, 128), generator=g, device="cuda").to(torch.bfloat16).cpu()
    t0 = time.perf_counter()
    q, scale = quantize_kv_pages(k.float().numpy(), PS)
    dt = time.perf_counter() - t0
    out = {"tokens": S, "bytes_per_tensor": k.numel() * 2, "ms_per_tensor": 1e3 * dt,
           "ms_k_and_v": 2e3 * dt, "int8_bytes": int(q.nbytes + scale.nbytes), "card_host": card}
    if q.dtype != np.int8:
        raise AssertionError(f"quantize_kv_pages gave {q.dtype}")
    return out


def phase_tiering_dense(card: str) -> dict:
    """The reference's defaults plus ``kv_tiering`` with ``tier_quantize``
    1 (its default), llama3-8b at ``CUT_LAYERS`` (8) of 32 layers: a
    control session c serves two turns; session s serves
    turn one, is parked (``tier_quantized_pages`` > 0) and promoted by
    ``/prewarm``; the promoted KV in s's arena row must lie within half a
    quantization step of each page's scale (plus the bf16 rounding of the
    dequantized value) of the parked exact bytes (the park's blob). Turn
    two's first divergence from c's is reported, not gated. Also the numpy
    quantizer's time on a 2,048-token session (``_quantizer_cost``)."""
    import torch

    from agentainer_tpu_torch.engine.checkpoint import deserialize_kv_slot
    from agentainer_tpu_torch.engine.quant import quantize_kv_pages

    gc.collect()
    torch.cuda.empty_cache()
    options = {"device": "cuda", "seed": 0, "max_batch": B, "max_seq": S, "kv_tiering": True,
               "tier_quantize": 1}
    turn2 = "Now list the three checks as bullet points."
    with _serving(options, config=_cut_config("llama3-8b")) as (app, load_s):
        port, eng = app.port, app.engine
        replies: list = []
        _chat(port, replies, "c", _tier_prompt(0), 16)
        c2 = _chat(port, replies, "c", turn2, 16)
        _chat(port, replies, "s", _tier_prompt(0), 16)
        name = "chip-smoke::s"
        blob = asyncio.run(eng.park_session(name))
        _, m1 = _http(port, "GET", "/metrics")
        _, pre = _http(port, "POST", "/prewarm", {"session": "s"})
        k_exact, v_exact, header = deserialize_kv_slot(blob)
        pos = header["position"]
        with torch.no_grad():
            row = eng.sessions[name]
            got = [eng.cache.k_store[:, row, :pos].float().cpu(), eng.cache.v_store[:, row, :pos].float().cpu()]
        worst = 0.0
        for promoted, exact in zip(got, (k_exact, v_exact)):
            _, scale = quantize_kv_pages(exact.float().numpy(), eng.page_size)
            step = torch.from_numpy(scale).expand(-1, -1, eng.page_size, -1, exact.shape[-1])
            step = step.reshape(scale.shape[0], -1, *exact.shape[2:])[:, :pos]
            exact_f = exact.float()
            bound = 0.5 * step + exact_f.abs() * 2.0**-8 + 1e-30
            worst = max(worst, ((promoted - exact_f).abs() / bound).max().item())
        s2 = _chat(port, replies, "s", turn2, 16)
        _, m2 = _http(port, "GET", "/metrics")
        timings = _tier_timings(eng, card)
    out = {
        "load_s": load_s, "position": pos, "blob_bytes": len(blob), "prewarm": pre,
        "tier_quantized_pages_parked": m1["tier_quantized_pages"],
        "tier_host_bytes_parked": m1["tier_host_bytes"],
        "worst_error_over_bound": worst,
        "bound": "0.5 * page scale + |value| * 2^-8 (bf16 rounding)",
        "turn_two_divergence": _first_divergence([s2["response"]], [c2["response"]]),
        "promotions": m2["tier_promotions_total"], "timings": timings,
        "quantizer": _quantizer_cost(card), "card": card,
    }
    if pre != {"prewarmed": True} or m1["tier_quantized_pages"] <= 0 or worst > 1.0:
        raise AssertionError(f"tiering dense (int8 host tier): {out}")
    log(f"tiering dense ({card}): {out}")
    return out


# -- Mixture-of-Experts: Mixtral-8x7B ----------------------------------------


def phase_grouped() -> dict:
    """``w8a16_grouped_matmul`` against its plain version at E = 8 and
    Mixtral's expert stacks for every M of ``MOE_MS``, then timed at
    ``MOE_TIMED_MS`` beside its bound, the plain version, the bf16 cuBLAS
    batched product over the dense stack and ``x @ dequant(w)`` over the
    stack (see the docstring)."""
    import torch

    from agentainer_tpu_torch.ops import cuda_quant as cq
    from agentainer_tpu_torch.ops.quant import QTensor, dequant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bf, e = torch.bfloat16, MOE_E

    def stack(k, n):
        q = torch.randint(-127, 128, (e, k, n), dtype=torch.int8, generator=g, device=dev)
        scale = ((0.5 + torch.rand((e, 1, n), generator=g, device=dev)) * (0.02 / 127.0)).to(bf)
        return q, scale

    def x_for(m, k, per_expert):
        return torch.randn((e, m, k) if per_expert else (m, k), generator=g, device=dev).to(bf)

    worst, checked = 0.0, 0
    t0 = time.monotonic()
    for name, (k, n, per_expert) in MOE_STACKS.items():
        q, scale = stack(k, n)
        for m in MOE_MS:
            x = x_for(m, k, per_expert)
            got = cq.w8a16_grouped_matmul(x, q, scale)
            want = cq.w8a16_matmul_plain(x, q, scale).float()
            torch.testing.assert_close(
                got.float(), want, rtol=W8_RTOL, atol=W8_ATOL,
                msg=lambda msg, m=m, k=k, n=n: f"w8a16_grouped_matmul E={e} M={m} K={k} N={n} "
                f"{cq.plan(m, n, k, e)} disagrees with plain: {msg}",
            )
            if not torch.equal(got, cq.w8a16_grouped_matmul(x, q, scale)):
                raise AssertionError(f"w8a16_grouped_matmul M={m} K={k} N={n}: two calls differ")
            worst = max(worst, (got.float() - want).abs().max().item())
            checked += 1
        del q, scale
    log(f"w8a16_grouped_matmul held its plain version at {checked} (stack, M), E = {e}, two calls "
        f"bit-equal, in {time.monotonic() - t0:.1f}s; max abs err {worst:.3g}")

    timed = []
    for name, (k, n, per_expert) in MOE_STACKS.items():
        q, scale = stack(k, n)
        dense = dequant(QTensor(q, scale))  # [E, K, N] bf16, what int8 replaces
        for m in MOE_TIMED_MS:
            x = x_for(m, k, per_expert)
            bm, splits = cq.plan(m, n, k, e)
            fns = {
                "kernel": lambda x=x: cq.w8a16_grouped_matmul(x, q, scale),
                "plain": lambda x=x: cq.w8a16_matmul_plain(x, q, scale),
                "cublas_bmm_bf16": lambda x=x: torch.matmul(x, dense),
                "dequant_matmul": lambda x=x: torch.matmul(x, dequant(QTensor(q, scale))),
            }
            row = _timed("w8a16_grouped_matmul", fns, want_launches=1)
            x_shape = f"[{e},{m},{k}]" if per_expert else f"[{m},{k}]"
            timed.append({
                "weights": name, "shape": f"x{x_shape} bf16, q[{e},{k},{n}] int8, scale[{e},1,{n}] bf16",
                "M": m, "K": k, "N": n, "E": e, "x_per_expert": per_expert, "block_m": bm, "splits": splits,
                **row, **_bound(e * k * n + 2 * e * n + 2 * m * k * (e if per_expert else 1) + 2 * e * m * n,
                                2.0 * e * m * k * n),
            })
            r = timed[-1]
            log(f"w8a16_grouped_matmul {name} M={m}: ms {r['ms']:.4f} [{r['ms_min']:.4f}, {r['ms_max']:.4f}] "
                f"bound {r['bound_ms']:.4f} ({r['bound_by']}) plain {r['plain_ms']:.4f} cublas bmm bf16 "
                f"{r['cublas_bmm_bf16_ms']:.4f} x@dequant(w) {r['dequant_matmul_ms']:.4f} tile {bm} splits "
                f"{splits} launches/call {r['launches_per_call']} card {r['card']}")
            del x, fns
        del q, scale, dense
    main = next(r for r in timed if r["weights"] == "w_gate/w_up" and r["M"] == 8)
    return {
        "name": "w8a16_grouped_matmul", "route": "cuda", "source": W8_SOURCE, "replaces": MOE_REPLACES,
        "timing": TIMING, "max_abs_err": worst,
        "tolerance": f"|d| <= {W8_ATOL} + {W8_RTOL} * |plain|", "checked": checked,
        # no single PyTorch call takes int8 expert stacks; the bf16 cuBLAS
        # product over the dense stack is timed beside it
        "library": None, "library_ms": None,
        **{key: main[key] for key in (
            "shape", "ms", "ms_min", "ms_max", "plain_ms", "bound_ms", "bound_by", "cublas_bmm_bf16_ms",
            "dequant_matmul_ms", "launches_per_call", "device_kernels", "card",
        )},
        "timed": timed,
    }


@contextlib.contextmanager
def _routes():
    """Record the experts every MoE layer chooses while the block runs: a
    list of ``[..., k]`` index tensors, one per layer call, in call order."""
    from agentainer_tpu_torch.models import llama as tl

    chosen: list = []
    top_k = tl._top_k

    def recording(logits, k):
        vals, idx = top_k(logits, k)
        chosen.append(idx.detach().cpu())
        return vals, idx

    tl._top_k = recording
    try:
        yield chosen
    finally:
        tl._top_k = top_k


@contextlib.contextmanager
def _plain_products():
    """Every int8 weight product through its kernel's plain version."""
    from agentainer_tpu_torch.ops import cuda_quant as cq
    from agentainer_tpu_torch.ops import quant as tq

    tq.w8a16_matmul = tq.w8a16_grouped_matmul = cq.w8a16_matmul_plain
    try:
        yield
    finally:
        tq.w8a16_matmul, tq.w8a16_grouped_matmul = cq.w8a16_matmul, cq.w8a16_grouped_matmul


def _same_route(a: list, b: list):
    """Per token (flattened [B * T]), whether two runs' recorded routes agree
    in every layer."""
    import torch

    ok = None
    for x, y in zip(a, b, strict=True):
        eq = (x == y).all(dim=-1).reshape(-1)
        ok = eq if ok is None else ok & eq
    return ok if ok is not None else torch.ones(0, dtype=torch.bool)


def phase_moe_block() -> dict:
    """One Mixtral-8x7B layer's MoE block, ``_moe_mlp`` and
    ``_moe_mlp_routed`` (``cf`` 4.0, dropless), on the same ``h`` for each of
    ``MOE_BLOCK_SHAPES``: in bf16 with int8 weights, the grouped kernel
    against its plain version (3 launches a call); in f32 with dense
    weights, the card against the CPU (TF32 off), tokens routed
    differently by the two left out and counted."""
    import dataclasses

    import torch

    from agentainer_tpu_torch.engine.quant import quantize_params
    from agentainer_tpu_torch.models import llama as tl
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.ops import cuda_quant as cq
    from agentainer_tpu_torch.ops.quant import layer_slice

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MIXTRAL), name=f"{MIXTRAL}-1l", n_layers=1)
    dev = torch.device("cuda")
    impls = {
        "dense_moe": lambda h, lp: tl._moe_mlp(h, lp, cfg),
        "routed": lambda h, lp: tl._moe_mlp_routed(h, lp, cfg, capacity_factor=MOE_ROUTED["moe_cf"]),
    }
    keys = ("router", "w_gate", "w_up", "w_down")
    out: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev)
        g.manual_seed(2)
        with torch.no_grad():
            params = tl.init_params(cfg, g, dtype=dtype, device=dev)
            if dtype == torch.bfloat16:
                params = quantize_params(params, torch.bfloat16)
            lp = {k: layer_slice(params["layers"][k], 0) for k in keys}
            del params
            host = {k: v.cpu() for k, v in lp.items()} if dtype == torch.float32 else None
            for shape in MOE_BLOCK_SHAPES:
                h = torch.randn((*shape, cfg.dim), generator=g, device=dev).to(dtype)
                for impl, fn in impls.items():
                    tag = f"{impl} {str(dtype).removeprefix('torch.')} h[{shape[0]},{shape[1]},{cfg.dim}]"
                    if dtype == torch.bfloat16:  # the grouped kernel against its plain version
                        before = cq.w8a16_grouped_matmul.launches
                        with _routes() as r_kernel:
                            got = fn(h, lp).float()
                        launched = cq.w8a16_grouped_matmul.launches - before
                        with _routes() as r_plain, _plain_products():
                            want = fn(h, lp).float()
                        if launched != GROUPED_PER_LAYER:
                            raise AssertionError(f"MoE block {tag}: {launched} grouped launches")
                        tol = BF16_LOGIT_TOL
                    else:  # the card against the CPU
                        with _routes() as r_kernel:
                            got = fn(h, lp).float()
                        with _routes() as r_plain:
                            want = fn(h.cpu(), host).to(dev)
                        tol = F32_LOGIT_TOL
                    same = _same_route(r_kernel, r_plain).to(dev)
                    flat_got, flat_want = got.reshape(-1, cfg.dim), want.reshape(-1, cfg.dim)
                    if not torch.isfinite(flat_got).all() or tuple(got.shape) != (*shape, cfg.dim):
                        raise AssertionError(f"MoE block {tag}: output {tuple(got.shape)} not finite")
                    err = (flat_got[same] - flat_want[same]).abs().max().item()
                    scale = max(1.0, flat_want.abs().max().item())
                    if dtype == torch.bfloat16:
                        limit = f"{tol} * max(1, |out|) = {tol * scale}"
                        if err > tol * scale:
                            raise AssertionError(f"MoE block {tag}: max abs err {err}, over {limit}")
                    else:
                        limit = f"rtol = atol = {tol}"
                        torch.testing.assert_close(flat_got[same], flat_want[same], rtol=tol, atol=tol,
                                                   msg=lambda m, tag=tag: f"MoE block {tag}: {m}")
                    out[tag] = {"max_abs_err": err, "max_abs_out": scale, "tolerance": limit,
                                "tokens": int(same.numel()), "routing_disagreements": int((~same).sum())}
                    log(f"MoE block {tag}: {'kernel vs plain' if dtype == torch.bfloat16 else 'card vs cpu'} "
                        f"{out[tag]}")
            del lp, host
    return out


def phase_moe_model() -> dict:
    """A 2-layer Mixtral-width model, a prefill chunk of 2 x 128 tokens then
    one decode step: bf16 and f32 logits with the attention kernels against
    the plain attention path, then the int8 model with the grouped kernel
    and ``w8a16_matmul`` against their plain versions. A token the two runs
    route to other experts in any layer is counted, and its sequence's
    logits are compared up to it (later tokens attend to its K/V)."""
    import dataclasses

    import torch

    from agentainer_tpu_torch.engine.quant import quantize_params
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import KVCache, forward, init_params
    from agentainer_tpu_torch.ops import cuda_quant as cq

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MIXTRAL), name=f"{MIXTRAL}-2l", n_layers=2)
    dev = torch.device("cuda")
    b, t, s = 2, 128, 512
    out: dict = {}

    def run(params, dtype, tokens, pos, use_flash=True):
        """Logits [b, t + 1, V] of the prefill then the decode step, and the
        routes each forward recorded."""
        cache = KVCache.create(cfg, b, s, dtype=dtype, device=dev)
        with _routes() as pre_r:
            pre = forward(params, cfg, tokens, pos, cache, use_flash=use_flash)
        with _routes() as dec_r:
            dec = forward(params, cfg, tokens[:, -1:], pos[:, -1:] + 1, cache, use_flash=use_flash)
        return torch.cat([pre, dec], dim=1), (pre_r, dec_r)

    def compare(tag, got, want, routes_a, routes_b, tol, relative):
        # per token [b, t + 1] (the prefill's t, then the decode step's):
        # whether both runs routed it alike in every layer; a later token
        # of its sequence attends to its K/V, so the comparison keeps each
        # sequence's tokens up to its first disagreement
        own = torch.cat([
            _same_route(routes_a[0], routes_b[0]).reshape(b, t),
            _same_route(routes_a[1], routes_b[1]).reshape(b, 1),
        ], dim=1)
        same = own.int().cumprod(dim=1).bool().to(dev)
        if not torch.isfinite(got).all():
            raise AssertionError(f"2-layer Mixtral {tag}: non-finite logits")
        if not same.any():
            raise AssertionError(f"2-layer Mixtral {tag}: every sequence routed its first token apart")
        err = (got[same] - want[same]).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        limit = tol * scale if relative else tol
        res = {"max_abs_err": err, "max_abs_err_every_token": (got - want).abs().max().item(),
               "max_abs_logit": scale, "tolerance": limit, "tokens": int(same.numel()),
               "tokens_compared": int(same.sum()), "routing_disagreements": int((~own).sum())}
        log(f"2-layer Mixtral {tag}: {res}")
        if relative and err > limit:
            raise AssertionError(f"2-layer Mixtral {tag}: max abs err {err} over {limit}")
        if not relative:
            torch.testing.assert_close(got[same], want[same], rtol=tol, atol=tol,
                                       msg=lambda m: f"2-layer Mixtral {tag}: {m}")
        return res

    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev)
            g.manual_seed(1)
            params = init_params(cfg, g, dtype=dtype, device=dev)
            tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)
            pos = (torch.tensor([0, 200], device=dev)[:, None] + torch.arange(t, device=dev)[None]).to(torch.int32)
            got, ra = run(params, dtype, tokens, pos, use_flash=True)
            want, rb = run(params, dtype, tokens, pos, use_flash=False)
            name = str(dtype).removeprefix("torch.")
            if dtype == torch.float32:
                out[name] = compare(f"{name} kernels vs plain attention", got, want, ra, rb, F32_LOGIT_TOL, False)
            else:
                out[name] = compare(f"{name} kernels vs plain attention", got, want, ra, rb, BF16_LOGIT_TOL, True)
                qparams = quantize_params(params, torch.bfloat16)
                del params
                before = (cq.w8a16_matmul.launches, cq.w8a16_grouped_matmul.launches)
                got, ra = run(qparams, dtype, tokens, pos)
                launched = (cq.w8a16_matmul.launches - before[0], cq.w8a16_grouped_matmul.launches - before[1])
                want_launches = ((W8_PER_LAYER_MOE * cfg.n_layers + 1) * 2, GROUPED_PER_LAYER * cfg.n_layers * 2)
                if launched != want_launches:
                    raise AssertionError(f"2-layer Mixtral int8: launches {launched}, want {want_launches}")
                with _plain_products():
                    want, rb = run(qparams, dtype, tokens, pos)
                out["int8"] = compare("int8 kernels vs plain products", got, want, ra, rb, BF16_LOGIT_TOL, True)
                params = qparams
            del params, got, want
    out["tolerance"] = {"bfloat16": f"{BF16_LOGIT_TOL} * max(1, |logit|)", "float32": F32_LOGIT_TOL,
                        "int8": f"{BF16_LOGIT_TOL} * max(1, |logit|)"}
    return out


# -- training (phase 12) -------------------------------------------------------

# the training batch (T + 1 tokens a sequence: T inputs, T targets); llama3-8b
# cut to 8 of 32 layers, since f32 AdamW keeps 16 B a param (param, grad and
# two moments: 128.5 GB at full depth, 44.7 GB at 8 layers); the reference's
# defaults
TRAIN_B, TRAIN_T, TRAIN_LAYERS, TRAIN_STEPS = 2, 2048, 8, 10
TRAIN_LR, TRAIN_WD = 3e-4, 0.01
TRAIN_SPLIT_STEPS = 2  # steps after the counted run, timed forward / backward / optimizer
MOE_TRAIN_T, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2048, 1, 3
# the f32 gradients of the training attention against autograd through the
# plain attention: the backward is the same recomputation on the same inputs
TRAIN_GRAD_F32_TOL = 1e-6
# (b) one step through the kernel path against one through the plain path:
# a gradient element at least ``TRAIN_G_FLOOR`` (100 eps) and 1e-4 of its
# leaf's largest gradient moves by lr x a ratio both paths agree on to the
# gradients' error, so it is held to 1% of one step's update; an element
# nearer zero moves by up to the update itself either way (AdamW's first
# step is ~sign(g) lr), held to 2 lr
TRAIN_G_FLOOR, TRAIN_G_REL = 1e-6, 1e-4
TRAIN_PARAM_TOL = 0.01 * TRAIN_LR
TRAIN_PARAM_TOL_NEAR_ZERO = 2 * TRAIN_LR
TRAIN_REPLACES = "agentainer_tpu/parallel/flash_mesh.py:81"  # make_trainable_causal_attention


def _train_tokens(cfg, b: int, t: int, seed: int = 0):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, t + 1), generator=g, device="cuda")


def _free_cuda() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


EVENT_TIMING = (
    "CUDA events around single calls, each after a 256 MB rewrite (cold L2) and a spin that lets "
    f"the host run ahead, in turns (a, b, c, c, b, a); median of {2 * ROUNDS}"
)


def _event_timed(fns: dict, rounds: int = ROUNDS) -> dict:
    """``_timed``'s keys for a row of millisecond calls, by CUDA events:
    the training shape's plain version makes the profiler's trace of the
    row lose records on every attempt, and at these lengths an event pair
    around a call, recorded while the device still spins, times it to a
    microsecond."""
    import statistics

    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    order = [name for _ in range(rounds) for name in (*fns, *reversed(fns))]
    events = {name: [] for name in fns}
    samples: list[str] = []
    with _sampling(samples):
        for name in order:
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            events[name].append((start, end))
        torch.cuda._sleep(TAIL_CYCLES)
        torch.cuda.synchronize()
    out = {}
    for name, pairs in events.items():
        ms = [a.elapsed_time(b) for a, b in pairs]
        key = "ms" if name == "kernel" else f"{name}_ms"
        out.update({key: statistics.median(ms), f"{key}_min": min(ms), f"{key}_max": max(ms)})
    return {**out, "card": _clock_summary(samples)}


def phase_train_attention() -> dict:
    """(a) ``trainable_causal_attention`` at the training shape, f32 and
    bf16: its forward (one prefill launch) against ``flash_prefill_plain``
    at the kernel phase's tolerances, its dq/dk/dv (no launch) against
    autograd through ``attention_reference``; then the f32 kernel forward
    timed beside its bound (f32 FLOPs over the CUDA cores' peak: the f32
    body), its plain version and SDPA (causal, GQA, f32), in turns."""
    import torch
    import torch.nn.functional as F

    from agentainer_tpu_torch.ops import cuda_attention as ca
    from agentainer_tpu_torch.ops.attention import attention_reference, causal_mask, trainable_causal_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    b, t = TRAIN_B, TRAIN_T
    base = [torch.randn(shape, generator=g, device=dev) for shape in
            ((b, t, H, HD), (b, t, KV, HD), (b, t, KV, HD), (b, t, H, HD))]
    pos = torch.arange(t, device=dev, dtype=torch.int32).expand(b, t)
    mask = causal_mask(t, device=dev).expand(b, t, t)
    out: dict = {"shape": f"q[{b},{t},{H},{HD}] kv[{b},{t},{KV},{HD}], positions 0..{t - 1}"}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        q, k, v, go = (x.to(dtype) for x in base)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        before = ca.flash_prefill.launches
        got = trainable_causal_attention(*leaves)
        fwd_launches = ca.flash_prefill.launches - before
        grads = torch.autograd.grad(got, leaves, go)
        torch.cuda.synchronize()
        bwd_launches = ca.flash_prefill.launches - before - fwd_launches
        if (fwd_launches, bwd_launches) != (1, 0):
            raise AssertionError(f"training attention {name}: launches forward {fwd_launches}, backward {bwd_launches}")
        plain = ca.flash_prefill_plain(q, k, v, pos)
        # bf16: P is rounded to bf16 (relative error <= 2**-9) before P.V,
        # so a row's output moves by at most 2**-9 * max|v| (its weights sum
        # to 1). BF16_P_ATOL is that error measured at the served chunk,
        # whose rows see 300+ slots; here the first rows see a few, each
        # with a large weight, and come near the bound
        # (tests/test_torch_attention.py::test_bf16_p_rounding_error_from_position_zero)
        p_atol = 2.0**-9 * v.float().abs().max().item()
        rtol, atol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (BF16_RTOL, BF16_ATOL + p_atol)
        torch.testing.assert_close(got.detach().float(), plain.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"training attention forward {name}: {m}")
        fwd_err = (got.detach().float() - plain.float()).abs().max().item()
        del plain, got
        ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(attention_reference(*ref_leaves, mask=mask), ref_leaves, go)
        grad_errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(grads, want)]
        for key, a, w in zip("qkv", grads, want):
            if dtype == torch.float32:
                torch.testing.assert_close(a, w, rtol=0.0, atol=TRAIN_GRAD_F32_TOL,
                                           msg=lambda m, key=key: f"training attention d{key} f32: {m}")
            else:  # both round the same f32 gradient once to bf16
                torch.testing.assert_close(a.float(), w.float(), rtol=BF16_RTOL, atol=TRAIN_GRAD_F32_TOL,
                                           msg=lambda m, key=key: f"training attention d{key} bf16: {m}")
        out[name] = {"forward_max_abs_err": fwd_err, "forward_tolerance": f"rtol {rtol}, atol {atol}",
                     "dq_dk_dv_max_abs_err": grad_errs,
                     "grad_tolerance": TRAIN_GRAD_F32_TOL if dtype == torch.float32
                     else f"rtol {BF16_RTOL}, atol {TRAIN_GRAD_F32_TOL}"}
        log(f"training attention {name}: forward vs plain {fwd_err:.3g}, dq/dk/dv vs reference autograd {grad_errs}")
        del q, k, v, go, leaves, ref_leaves, grads, want
        _free_cuda()
    q, k, v = (x.contiguous() for x in base[:3])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    visible = b * t * (t + 1) // 2
    before = ca.flash_prefill.launches
    out.update(
        **_event_timed({
            "kernel": lambda: ca.flash_prefill(q, k, v, pos),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            "plain": lambda: ca.flash_prefill_plain(q, k, v, pos),
        }),
        **_bound(4 * (2 * q.numel() + 2 * k.numel()), 4.0 * H * HD * visible, PEAK_F32_FLOPS),
        library="scaled_dot_product_attention", timed="float32", timing=EVENT_TIMING,
    )
    if ca.flash_prefill.launches - before != 1 + 2 * ROUNDS:  # a first call, then the timed ones
        raise AssertionError(f"training attention: {ca.flash_prefill.launches - before} kernel calls timed")
    log(f"training attention f32 kernel: ms {out['ms']:.4f} [{out['ms_min']:.4f}, {out['ms_max']:.4f}] "
        f"plain {out['plain_ms']:.4f} library {out['library_ms']:.4f} bound {out['bound_ms']:.4f} "
        f"({out['bound_by']}, f32 peak) card {out['card']}")
    del base, q, k, v, qt, kt, vt
    _free_cuda()
    return out


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """The paths of a param tree's leaves, in ``train.leaves``' order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _updated_leaves_close(got: list, want: list, grads: list, names: list) -> dict:
    """(b): every updated leaf of the kernel path against the plain path's,
    at ``TRAIN_PARAM_TOL`` where the plain gradient is clear of zero and
    ``TRAIN_PARAM_TOL_NEAR_ZERO`` elsewhere; the gradients within the
    two-path tolerance ``F32_LOGIT_TOL`` of each leaf's largest."""
    out = {"near_zero_elements": 0, "elements": 0, "max_abs_err": 0.0, "max_abs_err_near_zero": 0.0,
           "grad_max_rel_err": 0.0}
    for name, a, w, (gk, gp) in zip(names, got, want, grads):
        scale = gp.abs().max().item()
        g_err = (gk - gp).abs().max().item() / max(scale, 1e-30)
        if g_err > F32_LOGIT_TOL:
            raise AssertionError(f"train paths: {name} gradient differs by {g_err:.3g} of its largest")
        # a gradient of exactly zero on both paths (an embedding row no
        # token reads) moves by the decay alone: held to the tight bound
        near = (gp.abs() < max(TRAIN_G_FLOOR, TRAIN_G_REL * scale)) & ((gp != 0) | (gk != 0))
        diff = (a - w).abs()
        far_err = diff[~near].max().item() if (~near).any() else 0.0
        near_err = diff[near].max().item() if near.any() else 0.0
        if far_err > TRAIN_PARAM_TOL or near_err > TRAIN_PARAM_TOL_NEAR_ZERO:
            raise AssertionError(f"train paths: {name} updated leaf differs by {far_err:.3g} "
                                 f"(near-zero gradients: {near_err:.3g})")
        out["near_zero_elements"] += int(near.sum())
        out["elements"] += near.numel()
        out["max_abs_err"] = max(out["max_abs_err"], far_err)
        out["max_abs_err_near_zero"] = max(out["max_abs_err_near_zero"], near_err)
        out["grad_max_rel_err"] = max(out["grad_max_rel_err"], g_err)
    return out


def phase_train_paths() -> dict:
    """(b) a 2-layer llama3-8b-width model, f32, one set of params: one
    ``step_fn`` step (``trainable_causal_attention``: the kernel forward)
    and one step of the same update through ``attn_impl=None`` (the plain
    attention on both passes): losses within ``F32_LOGIT_TOL``, every
    updated leaf as ``_updated_leaves_close`` says."""
    import dataclasses

    import torch

    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import init_params
    from agentainer_tpu_torch.train import leaves, loss_fn, make_train_step

    cfg = dataclasses.replace(get_config("llama3-8b"), name="llama3-8b-2l", n_layers=2)
    init_fn, step_fn, shard_batch = make_train_step(cfg, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    params0 = init_params(cfg, g, dtype=torch.float32, device="cuda")
    tokens = shard_batch(_train_tokens(cfg, TRAIN_B, TRAIN_T, seed=2))
    names = _leaf_names(params0)
    state = init_fn(params=params0)
    state, loss_k = step_fn(state, tokens)
    kernel = [(p.detach(), p.grad) for p in leaves(state.params)]
    del state
    _free_cuda()
    state = init_fn(params=params0)  # the same update, by hand, through the plain attention
    del params0
    opt = state.opt_state
    opt.zero_grad(set_to_none=True)
    loss_p = loss_fn(state.params, cfg, tokens, None)
    loss_p.backward()
    opt.step()
    plain = [(p.detach(), p.grad) for p in leaves(state.params)]
    loss_k, loss_p = loss_k.item(), loss_p.item()
    if not abs(loss_k - loss_p) <= F32_LOGIT_TOL:
        raise AssertionError(f"train paths: loss {loss_k} through the kernel, {loss_p} through plain attention")
    out = {"loss_kernel_path": loss_k, "loss_plain_path": loss_p, "loss_tolerance": F32_LOGIT_TOL,
           "param_tolerance": TRAIN_PARAM_TOL, "param_tolerance_near_zero_gradient": TRAIN_PARAM_TOL_NEAR_ZERO,
           **_updated_leaves_close([a for a, _ in kernel], [a for a, _ in plain],
                                   [(gk, gp) for (_, gk), (_, gp) in zip(kernel, plain)], names)}
    log(f"2-layer llama3-8b one step, kernel path vs plain path: {out}")
    del state, opt, kernel, plain
    _free_cuda()
    return out


def _counted(kernels, fn):
    """Runs ``fn()`` with every wrapper's count set to 0 just before; the
    result and the counts read just after."""
    for k in kernels:
        k.launches = 0
    res = fn()
    return res, {k.__name__: k.launches for k in kernels}


def phase_train(card: str) -> dict:
    """(c) llama3-8b at full width, 8 of 32 layers, f32, ``TRAIN_STEPS``
    AdamW steps through ``make_train_step`` on one repeated batch of random
    tokens: every loss finite, the last below the first, the prefill kernel
    launched n_layers x steps and no other kernel; step ms by CUDA events
    (p50), then ``TRAIN_SPLIT_STEPS`` more steps from the same pieces timed
    forward / backward / optimizer; tokens/s; peak memory beside the plan."""
    import dataclasses
    import statistics

    import torch

    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.ops import cuda_attention as ca
    from agentainer_tpu_torch.ops import cuda_quant as cq
    from agentainer_tpu_torch.ops.attention import trainable_causal_attention
    from agentainer_tpu_torch.train import leaves, loss_fn, make_train_step

    cfg = dataclasses.replace(get_config("llama3-8b"), name="llama3-8b-8l", n_layers=TRAIN_LAYERS)
    kernels = (ca.flash_prefill, ca.flash_decode, ca.fused_paged_flash_prefill, ca.fused_paged_flash_decode,
               cq.w8a16_matmul, cq.w8a16_grouped_matmul)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    init_fn, step_fn, shard_batch = make_train_step(cfg, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    state = init_fn(g)
    tokens = shard_batch(_train_tokens(cfg, TRAIN_B, TRAIN_T, seed=0))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in leaves(state.params))
    plan = {"params": n_params, "adamw_state_bytes": 16 * n_params}

    def run():
        nonlocal state
        losses, events = [], []
        for _ in range(TRAIN_STEPS):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, loss = step_fn(state, tokens)
            ev[1].record()
            losses.append(loss)
            events.append(ev)
        torch.cuda.synchronize()
        return [x.item() for x in losses], [a.elapsed_time(b) for a, b in events]

    (losses, step_ms), launches = _counted(kernels, run)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss after step {TRAIN_STEPS} is not below step 1's: {losses}")
    want = {k.__name__: 0 for k in kernels} | {"flash_prefill": TRAIN_LAYERS * TRAIN_STEPS}
    if launches != want or state.step != TRAIN_STEPS:
        raise AssertionError(f"train: launches {launches}, want {want}; step {state.step}")
    split = {"forward": [], "backward": [], "optimizer": []}
    opt = state.opt_state
    for _ in range(TRAIN_SPLIT_STEPS):  # the body of step_fn, with events between its parts
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, cfg, tokens, trainable_causal_attention)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, key in enumerate(split):
            split[key].append(ev[i].elapsed_time(ev[i + 1]))
    p50 = statistics.median(step_ms)
    out = {
        "config": f"llama3-8b width (D {cfg.dim}, H {cfg.n_heads}, KV {cfg.n_kv_heads}, F {cfg.ffn_dim}, "
                  f"vocab {cfg.vocab_size}), {TRAIN_LAYERS} of 32 layers, f32, AdamW lr {TRAIN_LR} wd {TRAIN_WD}",
        "batch": f"B {TRAIN_B} x T {TRAIN_T}, one repeated batch of random tokens (seed 0)",
        "losses": losses, "launches": launches, "step_ms": step_ms, "step_ms_p50": p50,
        "split_ms_p50": {k: statistics.median(v) for k, v in split.items()}, "split_ms": split,
        "tokens_per_s": TRAIN_B * TRAIN_T / (p50 / 1e3), "init_s": init_s,
        "peak_memory_bytes": peak, "plan": plan, "card": card,
    }
    log(f"train llama3-8b x{TRAIN_LAYERS} layers f32: losses {[round(x, 4) for x in losses]}; step p50 "
        f"{p50:.1f} ms (forward {out['split_ms_p50']['forward']:.1f}, backward "
        f"{out['split_ms_p50']['backward']:.1f}, optimizer {out['split_ms_p50']['optimizer']:.1f}); "
        f"{out['tokens_per_s']:.0f} tokens/s; peak {peak} B against {plan['adamw_state_bytes']} B of "
        f"AdamW state; launches {launches}; {card}")
    del state, opt, loss, tokens
    _free_cuda()
    return out


def _expert_matmuls(n_experts: int):
    """A function mode that records every ``torch.matmul`` whose right
    operand is an expert stack ``[E, K, N]`` (the dense-einsum MoE's
    products) in its ``.calls`` while it is active."""
    import torch
    from torch.overrides import TorchFunctionMode

    class ExpertMatmuls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.matmul and len(args) == 2 and args[1].dim() == 3 and args[1].shape[0] == n_experts:
                self.calls.append((tuple(args[0].shape), tuple(args[1].shape), str(args[1].dtype)))
            return func(*args, **(kwargs or {}))

    return ExpertMatmuls()


def phase_train_moe(card: str) -> dict:
    """(d) Mixtral-8x7B at full width, depth 1, f32, B 1 x T 2048,
    ``MOE_TRAIN_STEPS`` steps: losses finite and falling, the expert
    products 3 batched ``torch.matmul`` calls per layer per step over the
    f32 stacks (as the reference's XLA einsums), no int8 kernel launched,
    the prefill kernel once per layer per step; step ms and peak memory."""
    import dataclasses
    import statistics

    import torch

    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.ops import cuda_attention as ca
    from agentainer_tpu_torch.ops import cuda_quant as cq
    from agentainer_tpu_torch.train import leaves, make_train_step

    cfg = dataclasses.replace(get_config(MIXTRAL), name=f"{MIXTRAL}-1l", n_layers=MOE_TRAIN_LAYERS)
    kernels = (ca.flash_prefill, ca.flash_decode, cq.w8a16_matmul, cq.w8a16_grouped_matmul)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, shard_batch = make_train_step(cfg, learning_rate=TRAIN_LR, weight_decay=TRAIN_WD)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    state = init_fn(g)
    tokens = shard_batch(_train_tokens(cfg, 1, MOE_TRAIN_T, seed=0))
    n_params = sum(p.numel() for p in leaves(state.params))
    stacks = {k: state.params["layers"][k] for k in ("w_gate", "w_up", "w_down")}
    if any(not isinstance(w, torch.Tensor) or w.dtype != torch.float32 or w.shape[1] != cfg.n_experts
           for w in stacks.values()):
        raise AssertionError(f"train MoE: expert stacks {[(type(w).__name__, w.shape) for w in stacks.values()]}")
    probe = _expert_matmuls(cfg.n_experts)

    def run():
        nonlocal state
        losses, ms = [], []
        with probe:
            for _ in range(MOE_TRAIN_STEPS):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                state, loss = step_fn(state, tokens)
                ev[1].record()
                torch.cuda.synchronize()
                losses.append(loss.item())
                ms.append(ev[0].elapsed_time(ev[1]))
        return losses, ms

    (losses, step_ms), launches = _counted(kernels, run)
    peak = torch.cuda.max_memory_allocated()
    want_calls = 3 * MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train MoE: losses {losses}")
    want = {k.__name__: 0 for k in kernels} | {"flash_prefill": MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"train MoE: launches {launches}, want {want}")
    if len(probe.calls) != want_calls or any(dt != "torch.float32" for *_, dt in probe.calls):
        raise AssertionError(f"train MoE: expert matmuls {probe.calls}, want {want_calls} in f32")
    out = {"config": f"{MIXTRAL} width, {MOE_TRAIN_LAYERS} layer, f32, dense-einsum MoE",
           "batch": f"B 1 x T {MOE_TRAIN_T}", "params": n_params, "adamw_state_bytes": 16 * n_params,
           "losses": losses, "launches": launches, "expert_matmuls": len(probe.calls),
           "expert_matmul_shapes": sorted(set(probe.calls)), "step_ms": step_ms,
           "step_ms_p50": statistics.median(step_ms), "peak_memory_bytes": peak, "card": card}
    log(f"train Mixtral-8x7B x{MOE_TRAIN_LAYERS} layer f32: losses {[round(x, 4) for x in losses]}; "
        f"step p50 {out['step_ms_p50']:.1f} ms; {len(probe.calls)} expert matmuls; peak {peak} B; "
        f"launches {launches}; {card}")
    del state, tokens, stacks
    _free_cuda()
    return out


# the control-plane phase: the port's daemon as a child process, two
# llama3-8b agents as tenants of one engine host, a journaled crash replay
DAEMON_TOKEN = "chip-smoke-daemon"
DAEMON_PERSONAS = ("You are Ada, a terse lighthouse keeper.", "You are Bob, a cheerful baker.")
# the first turn keeps persona + message under 64 tokens (bos + 39 + 2 +
# 19 = 61): the prefix cache then holds only the persona's 32-token level,
# so session B's first turn forks the same prefix A's did and takes the
# same bf16 path, instead of forking A's 64-token level (with random
# weights near-tied logits make any other path another token stream)
DAEMON_TURNS = (
    "Hello! Who are you?",
    "Tell me about the sea at night.",
    "And what do you eat for breakfast?",
)
DAEMON_MAX_TOKENS = 32
PROXY_PROBES = 10  # /generate probes through the proxy and straight to the host, in turns
WEIGHT_BYTES_8B = 16_060_522_496  # llama3-8b's bf16 weights


def _daemon_call(port: int, method: str, path: str, body: dict | None = None,
                 auth: bool = False, timeout: float = 300) -> tuple[int, dict]:
    headers = {"Authorization": f"Bearer {DAEMON_TOKEN}"} if auth else None
    status, _, doc = _http_any(port, method, path, body, headers=headers, timeout=timeout)
    return status, doc


class _Daemon:
    """The port's daemon as a child process (``mem://`` unless ``env`` says
    otherwise, a data directory — its own, or ``data`` kept across daemons —
    and a port of its own), and the calls a phase makes through it: every
    status answered is kept, for the no-5xx gates."""

    def __init__(self, env: dict | None = None, data: str | None = None):
        root = os.path.dirname(os.path.abspath(__file__))
        self.keep_data = data is not None
        self.data = data or tempfile.mkdtemp(prefix="atpu-daemon-")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            self.port = sock.getsockname()[1]
        full = {**os.environ, "ATPU_SERVER_HOST": "127.0.0.1", "ATPU_SERVER_PORT": str(self.port),
                "ATPU_AUTH_TOKEN": DAEMON_TOKEN, "ATPU_DATA_DIR": self.data, "ATPU_STORE_URL": "mem://",
                "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH", "")) if p),
                **(env or {})}
        self.log_path = os.path.join(self.data, f"daemon-{self.port}.log")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "agentainer_tpu_torch.daemon"], cwd=root, env=full,
            stdout=open(self.log_path, "wb"), stderr=subprocess.STDOUT, start_new_session=True,
        )
        self.statuses: list[int] = []

    def call(self, method, path, body=None, auth=False, timeout=300):
        status, doc = _daemon_call(self.port, method, path, body, auth, timeout)
        self.statuses.append(status)
        return status, doc

    def wait(self, pred, what: str, timeout: float):
        t0 = time.monotonic()
        while True:
            try:
                got = pred()
            except OSError:  # not listening yet
                got = None
            if got:
                return got
            if self.proc.poll() is not None:
                raise RuntimeError(f"daemon exited while waiting for {what}: {_tail(self.log_path)}")
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{what} not within {timeout} s: {_tail(self.log_path)}")
            time.sleep(0.1)

    def close(self) -> None:
        # the engine hosts run in process groups of their own: note them
        # before the daemon goes, since its children are reparented then
        hosts = _children(self.proc.pid)
        if self.proc.poll() is None:
            self.proc.terminate()  # SIGTERM: the daemon stops its engines
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
                self.proc.wait(timeout=30)
        for pid in hosts:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(pid, signal.SIGKILL)
        if not self.keep_data:
            shutil.rmtree(self.data, ignore_errors=True)


def _gpu_used_mib() -> int:
    return int(smi("memory.used").split()[0])


def _compute_apps() -> dict[int, int]:
    """pid → used MiB of the card's compute processes, as nvidia-smi lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    apps = {}
    for line in out.stdout.strip().splitlines():
        pid, mem = (x.strip() for x in line.split(","))
        apps[int(pid)] = int(mem)
    return apps


def _maps_cuda(pid: int) -> bool:
    """Whether the process has libcuda.so mapped (a CUDA context)."""
    with open(f"/proc/{pid}/maps") as f:
        return "libcuda.so" in f.read()


def _children(pid: int) -> list[int]:
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(") ", 1)[1].split()[1]) == pid:
                        kids.append(int(entry))
            except (OSError, IndexError, ValueError):
                continue
    return kids


def _journal_writes_per_request(requests: int = 20) -> dict:
    """Store mutations the proxy makes for one journaled /chat, counted on
    the port's control plane in this process (an in-process engine: the
    count is the journal's, whatever the engine)."""
    from agentainer_tpu_torch.config import Config
    from agentainer_tpu_torch.daemon import build_services
    from agentainer_tpu_torch.runtime.backend import FakeBackend
    from agentainer_tpu_torch.store import MemoryStore
    from agentainer_tpu_torch.utils.http import Request

    writes = {"n": 0}

    class Counting(MemoryStore):
        pass

    for op in ("set", "delete", "expire", "rpush", "lpush", "lrem", "ltrim", "sadd", "srem",
               "zadd", "zremrangebyscore", "hset", "hincrby", "cas", "publish"):
        def counted(self, *a, _op=getattr(MemoryStore, op), **kw):
            writes["n"] += 1
            return _op(self, *a, **kw)
        setattr(Counting, op, counted)

    cfg = Config()
    cfg.auth_token = DAEMON_TOKEN
    cfg.slice.total_chips = 1
    s = build_services(config=cfg, store=Counting(), backend=FakeBackend(), console_logs=False,
                       data_dir=tempfile.mkdtemp(prefix="atpu-journal-"))
    agent = s.manager.deploy(name="count", model="echo")
    s.manager.start(agent.id)

    async def go():
        before = writes["n"]
        for i in range(requests):
            resp = await s.app.handle(Request("POST", f"/agent/{agent.id}/chat", {},
                                              json.dumps({"message": f"m{i}"}).encode()))
            assert resp.status == 200, resp
        return (writes["n"] - before) / requests

    per = asyncio.run(go())
    s.backend.close()
    return {"store_writes_per_request": per, "requests": requests}


def phase_daemon(card: str) -> dict:
    """The control plane on the card: the port's daemon as a child process
    (standard library only: it must create no CUDA context), two llama3-8b
    agents with different personas (full width and depth, random bf16
    weights from seed 0, the reference's default features) as tenants of
    one engine host on GPU 0. Sessions A and B of the first agent run the
    same two greedy turns through the journaled proxy, A its third too; B's
    snapshot lands in the store; the host is SIGKILLed; B's third turn
    answers 202; resume; the replay drains. Gates: one host on the card and
    none in the daemon, the host's memory under twice the weights, B's
    replayed turn equal to A's undisturbed one, ``kv_restores`` >= 1, no 5xx,
    no request run twice, the dense kernels launched in the host and the
    paged ones not; a deploy asking for more GPUs than the card's count
    fails with the scheduler's 409."""
    _free_cuda()
    used0 = _gpu_used_mib()
    d = _Daemon()
    daemon, port, data, log_path = d.proc, d.port, d.data, d.log_path
    statuses, call, wait = d.statuses, d.call, d.wait

    def loaded(aid):
        status, doc = call("GET", f"/agent/{aid}/health")
        return status == 200 and doc.get("model_loaded")

    def chat(aid, session, msg) -> list[int]:
        """One turn through the proxy; its token ids, off the engine's SSE
        frames (random weights: most of llama3-8b's ids decode to no text)."""
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/agent/{aid}/chat", method="POST",
            data=json.dumps(_daemon_body(session, msg)).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            statuses.append(resp.status)
            return _sse_token_ids(resp.read())

    out: dict = {"card": card}
    try:
        wait(lambda: _daemon_call(port, "GET", "/health")[0] == 200, "the daemon", 60)
        if _maps_cuda(daemon.pid):
            raise AssertionError("the daemon created a CUDA context")
        # the scheduler refuses more GPUs than the card's count
        status, doc = call("POST", "/agents", {"name": "too-big", "model": "echo",
                                               "resources": {"chips": 2}}, auth=True)
        status, doc = call("POST", f"/agents/{doc['data']['id']}/start", auth=True)
        statuses.pop()  # the expected 409 is not a 5xx
        if status != 409 or "GPUs" not in doc["message"]:
            raise AssertionError(f"2-GPU deploy: {status} {doc}")
        out["resource_exhausted"] = doc["message"]
        ids = []
        for name, persona in zip(("ada", "bob"), DAEMON_PERSONAS):
            # streaming only changes a body that asks for a stream: the
            # turns' token ids then come back in the engine's SSE frames
            model = {"engine": "llm", "config": "llama3-8b",
                     "options": {"system_prompt": persona, "streaming": True}}
            status, doc = call("POST", "/agents", {"name": name, "model": model}, auth=True)
            assert status == 200, doc
            ids.append(doc["data"]["id"])
        t0 = time.monotonic()
        for aid in ids:
            status, doc = call("POST", f"/agents/{aid}/start", auth=True)
            assert status == 200, doc
        a, b = ids
        wait(lambda: loaded(a) and loaded(b), "the model", 480)
        out["boot_s"] = time.monotonic() - t0
        hosts = [p for p in _children(daemon.pid) if _maps_cuda(p)]
        if len(hosts) != 1:
            raise AssertionError(f"CUDA processes under the daemon: {hosts}")
        host = hosts[0]
        apps = _compute_apps()
        out["compute_apps"] = apps
        if os.getpid() in apps:  # nvidia-smi sees this pid namespace
            if host not in apps or daemon.pid in apps:
                raise AssertionError(f"compute apps {apps}: host {host}, daemon {daemon.pid}")
        out["host_gpu_mib"] = _gpu_used_mib() - used0
        if out["host_gpu_mib"] * 2**20 >= 2 * WEIGHT_BYTES_8B:
            raise AssertionError(f"host memory {out['host_gpu_mib']} MiB >= twice the weights")
        _, m = call("GET", f"/agent/{a}/metrics")
        if not (m.get("weights_shared") and m.get("tenants") == 2):
            raise AssertionError(f"one host for both agents: {m.get('weights_shared')} {m.get('tenants')}")
        bob = chat(b, "bob", DAEMON_TURNS[0])

        def settled():
            doc = call("GET", f"/agent/{a}/metrics")[1]
            return doc if doc["kv_snapshots_in_flight"] == 0 else None

        # A's undisturbed conversation, then B's two turns. Each turn's
        # snapshot task is scheduled before the turn answers (a session's
        # second one is a trailing capture kv_snapshot_interval_s after
        # its first); the script lets each settle before the next turn, so
        # no two snapshots compete for the engine's staging limiter and
        # B's second one, settled with no bounce-out, holds its two turns
        want = [chat(a, "A", msg) for msg in DAEMON_TURNS]
        wait(settled, "A's snapshots", 90)
        got = []
        for msg in DAEMON_TURNS[:2]:
            before = call("GET", f"/agent/{a}/metrics")[1]
            got.append(chat(a, "B", msg))
            m = wait(settled, "B's snapshot", 90)
        if got != want[:2]:
            raise AssertionError(f"sessions A and B differ before the crash: {got} {want[:2]}")
        if ((m["last_kv_snapshot"] or {}).get("session") != "B" or m["kv_snapshot_errors"]
                or m["kv_snapshots"] != before["kv_snapshots"] + 1
                or m["kv_snapshots_deferred"] != before["kv_snapshots_deferred"]):
            raise AssertionError(f"B's second snapshot did not land: {m['last_kv_snapshot']}, "
                                 f"errors {m['kv_snapshot_errors']}, deferred {m['kv_snapshots_deferred']}")
        out["snapshot"] = m["last_kv_snapshot"]
        out["kv_snapshots_deferred"] = m["kv_snapshots_deferred"]
        out["proxy_overhead"] = _proxy_overhead(port, a, data)
        # the crash
        os.kill(host, signal.SIGKILL)
        t_kill = time.monotonic()
        wait(lambda: call("GET", f"/agents/{a}", auth=True)[1]["data"]["status"] != "running",
             "the reconciler", 30)
        status, doc = call("POST", f"/agent/{a}/chat", _daemon_body("B", DAEMON_TURNS[2]))
        if status != 202:
            raise AssertionError(f"turn 3 while down: {status} {doc}")
        rid = doc["data"]["request_id"]
        t_resume = time.monotonic()
        status, doc = call("POST", f"/agents/{a}/resume", auth=True)
        assert status == 200, doc
        wait(lambda: loaded(a), "the respawned model", 480)
        out["respawn_boot_s"] = time.monotonic() - t_resume

        def replayed():
            _, doc = call("GET", f"/agents/{a}/requests?status=completed", auth=True)
            return next((r for r in doc["data"]["requests"] if r["id"] == rid), None)

        entry = wait(replayed, "the replay", 120)
        out["crash_to_replayed_s"] = time.monotonic() - t_kill
        _, stats = call("GET", f"/agents/{a}/requests", auth=True)
        stats = stats["data"]["stats"]
        third = _sse_token_ids(base64.b64decode(entry["response"]["body_b64"]))
        _, m = call("GET", f"/agent/{a}/metrics")
        _, hist = call("GET", f"/agent/{a}/history")
        b_turns = [t for t in hist["history"] if t.get("session") == "B" and t["role"] == "user"]
        launches = m["kernel_launches"]
        out.update({
            "replayed_equal": third == want[2],
            "turn3_tokens": len(third),
            "kv_restores": m["kv_restores"],
            "journal": stats,
            "retry_count": entry["retry_count"],
            "b_user_turns": len(b_turns),
            "launches": launches,
            "bob_tokens": len(bob),
            "journal_writes": _journal_writes_per_request(),
        })
        five = [s for s in statuses if s >= 500]
        if five:
            raise AssertionError(f"5xx answers: {five}")
        if not out["replayed_equal"]:
            raise AssertionError(f"B's replayed turn 3 {third} != A's {want[2]} "
                                 f"(kv_restores {m['kv_restores']}, snapshot {out['snapshot']})")
        if m["kv_restores"] < 1:
            raise AssertionError(f"kv_restores {m['kv_restores']}: the restore did not come from the store")
        if stats["pending"] or stats["failed"] or entry["retry_count"] or len(b_turns) != 3:
            raise AssertionError(f"a request ran twice or failed: {stats}, retries "
                                 f"{entry['retry_count']}, B's user turns {len(b_turns)}")
        if not (launches["flash_prefill"] > 0 and launches["flash_decode"] > 0
                and launches["fused_paged_flash_prefill"] == 0
                and launches["fused_paged_flash_decode"] == 0):
            raise AssertionError(f"kernel launches in the host: {launches}")
        log(f"daemon: boot {out['boot_s']:.1f} s, respawn {out['respawn_boot_s']:.1f} s, "
            f"crash->replayed {out['crash_to_replayed_s']:.1f} s, snapshot {out['snapshot']}, "
            f"proxy {out['proxy_overhead']}, host {out['host_gpu_mib']} MiB, "
            f"journal writes/request {out['journal_writes']['store_writes_per_request']}; {card}")
        return out
    finally:
        d.close()


def _daemon_body(session: str, msg: str) -> dict:
    return {"message": msg, "session": session, "max_tokens": DAEMON_MAX_TOKENS,
            "ignore_eos": True, "stream": True}


def _sse_token_ids(raw: bytes) -> list[int]:
    """The token ids of a streamed /chat answer, in offset order; raises
    unless it ends with its ``done`` frame."""
    frames = _parse_sse(raw)
    if not frames or frames[-1].get("event") != "done":
        raise AssertionError(f"a stream without its done frame: {raw[-200:]!r}")
    return [f["data"]["token"] for f in frames if f.get("event") == "token"]


def _tail(path: str, n: int = 20) -> str:
    try:
        with open(path, "rb") as f:
            return b"".join(f.readlines()[-n:]).decode("utf-8", "replace")
    except OSError:
        return ""


def _proxy_overhead(port: int, agent_id: str, data: str) -> dict:
    """The same one-token ``/generate`` (no session, so no snapshot traffic
    beside it) through the journaled proxy and straight to the tenant's
    port on the host, in turns: wall ms medians and their difference,
    beside the engine's own TTFT of each."""
    import glob
    import statistics

    tenant_port = None
    for path in glob.glob(os.path.join(data, "runtime", "engines", "host-*.log")):
        with open(path, errors="replace") as f:
            for line in f:
                if f"tenant {agent_id} attached on :" in line:
                    tenant_port = int(line.rsplit(":", 1)[1])
    if tenant_port is None:
        raise AssertionError("the tenant's port is not in the host log")
    walls = {"proxy": [], "direct": []}
    ttft = {"proxy": [], "direct": []}
    body = {"prompt": DAEMON_PERSONAS[0] + "\n\n" + DAEMON_TURNS[0], "max_tokens": 1}
    for i in range(PROXY_PROBES):
        for kind in ("proxy", "direct") if i % 2 == 0 else ("direct", "proxy"):
            target, path = (port, f"/agent/{agent_id}/generate") if kind == "proxy" else (tenant_port, "/generate")
            t0 = time.perf_counter()
            _, doc = _http(target, "POST", path, body)
            walls[kind].append(1000 * (time.perf_counter() - t0))
            ttft[kind].append(doc["ttft_ms"])
    med = {k: statistics.median(v) for k, v in walls.items()}
    return {"proxy_ms": med["proxy"], "direct_ms": med["direct"],
            "overhead_ms": med["proxy"] - med["direct"],
            "engine_ttft_ms": {k: statistics.median(v) for k, v in ttft.items()},
            "probes": PROXY_PROBES}


# the native phase: the daemon's default deployment (``store_url`` auto →
# the C++ store with its AOF, the C++ front door, the engines' store socket)
NATIVE_TURN4 = "What will you do tomorrow?"
NATIVE_MODEL = {"engine": "llm", "config": "llama3-8b",
                "options": {"system_prompt": DAEMON_PERSONAS[0], "streaming": True}}


def _wait_pid_gone(pid: int, timeout: float = 30) -> None:
    """Until ``pid`` has exited (a zombie no one reaps counts as gone)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(") ", 1)[1].split()[0] in ("Z", "X"):
                    return
        except (OSError, IndexError):
            return
        time.sleep(0.05)
    raise TimeoutError(f"pid {pid} still alive after {timeout} s")


def phase_native(card: str, python_door: dict) -> dict:
    """The daemon's default deployment on the card: ``store_url`` auto in a
    fresh data directory gives the C++ store with AOF durability and the
    C++ front door on the public port (its start line must say so; a
    fallback to ``mem://`` or the Python data plane fails the phase); one
    ``llm:llama3-8b`` agent (full width and depth, random bf16 weights from
    seed 0, the reference's default features, ``ATPU_STREAMING=1``, one
    replica) in a host on GPU 0, whose store calls go over the unix socket.
    Through the C++: sessions A and B run the same greedy turns as 7b, as
    ``stream: true`` bodies that the C++ answers buffered (whole, with a
    length and a request id); the journal's completed count equals the
    calls sent and the C++ counters count them; a streamed turn in session
    C arrives whole with A's first ids, its ``done`` payload equal to a
    buffered /chat's in session D; one-token /generate probes time the
    front door against the tenant's port. B's snapshot over the socket; the
    host SIGKILLed; B's third turn journaled by the C++ (202); resume; the
    replay equal to A's third turn. A's fourth turn; the daemon SIGKILLed
    (and its host, if it outlives it); a new daemon on the same directory:
    the agent listed, the journal's stats as before, B's history three
    user turns, and after resume B's fourth turn restored from the AOF's
    snapshot equal to A's; dense kernels only; no 5xx. ``python_door`` is
    phase 7b's result in this run: its proxy overhead and snapshot store ms
    (the Python front door, the store over HTTP) are printed beside these."""
    _free_cuda()
    data = tempfile.mkdtemp(prefix="atpu-7d-")
    env = {"ATPU_STORE_URL": "auto", "ATPU_STREAMING": "1"}
    d = _Daemon(env, data=data)
    daemons = [d]
    out: dict = {"card": card}
    agent_calls = 0  # requests sent to /agent/{a}/*: each is journaled by the C++

    def agent_call(method, path, body=None, headers=None, daemon=None):
        """(status, headers, raw body) of one /agent/{a}/* request."""
        nonlocal agent_calls
        agent_calls += 1
        daemon = daemon or d
        req = urllib.request.Request(
            f"http://127.0.0.1:{daemon.port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                got = resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as e:
            got = e.code, e.headers, e.read()
        daemon.statuses.append(got[0])
        return got

    def loaded(aid, daemon=None):
        status, _, raw = agent_call("GET", f"/agent/{aid}/health", daemon=daemon)
        return status == 200 and json.loads(raw).get("model_loaded")

    def metrics(aid, daemon=None):
        return json.loads(agent_call("GET", f"/agent/{aid}/metrics", daemon=daemon)[2])

    def turn(aid, session, msg, daemon=None) -> list[int]:
        """One turn through the C++ front door as a ``stream: true`` body:
        the C++ reads the engine's chunked stream whole and answers it with
        a length and the journal's request id; its token ids."""
        status, headers, raw = agent_call("POST", f"/agent/{aid}/chat", _daemon_body(session, msg), daemon=daemon)
        if status != 200 or not headers.get("X-Agentainer-Request-ID"):
            raise AssertionError(f"turn {session}: {status} {dict(headers)} {raw[:200]!r}")
        if int(headers.get("Content-Length", -1)) != len(raw) or "chunked" in headers.get("Transfer-Encoding", ""):
            raise AssertionError(f"turn {session}: not answered buffered: {dict(headers)}")
        return _sse_token_ids(raw)

    def settled(aid, daemon=None):
        m = metrics(aid, daemon)
        return m if m["kv_snapshots_in_flight"] == 0 else None

    try:
        d.wait(lambda: _daemon_call(d.port, "GET", "/health")[0] == 200, "the daemon", 60)
        start_line = next((ln for ln in open(d.log_path, errors="replace") if "control plane listening" in ln), "")
        out["start_line"] = start_line.strip()
        if not ("store native://" in start_line and "/store.aof" in start_line
                and "data plane native" in start_line):
            raise AssertionError(f"the daemon did not start on the native store and data plane: {start_line!r}")
        if _maps_cuda(d.proc.pid):
            raise AssertionError("the daemon created a CUDA context")
        status, doc = d.call("POST", "/agents", {"name": "ada", "model": NATIVE_MODEL}, auth=True)
        assert status == 200, doc
        a = doc["data"]["id"]
        t0 = time.monotonic()
        status, doc = d.call("POST", f"/agents/{a}/start", auth=True)
        assert status == 200, doc
        d.wait(lambda: loaded(a), "the model", 480)
        out["boot_s"] = time.monotonic() - t0
        host = next(p for p in _children(d.proc.pid) if _maps_cuda(p))
        with open(f"/proc/{host}/environ", "rb") as f:
            host_env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        sock = host_env.get(b"AGENTAINER_STORE_SOCK", b"").decode()
        if sock != os.path.join(data, "store.sock") or not os.path.exists(sock):
            raise AssertionError(f"the host's store socket: {sock!r}")
        # buffered turns: A's three (undisturbed), B's two
        want = [turn(a, "A", msg) for msg in DAEMON_TURNS]
        d.wait(lambda: settled(a), "A's snapshots", 90)
        got = []
        for msg in DAEMON_TURNS[:2]:
            before = metrics(a)
            got.append(turn(a, "B", msg))
            m = d.wait(lambda: settled(a), "B's snapshot", 90)
        if got != want[:2]:
            raise AssertionError(f"sessions A and B differ: {got} {want[:2]}")
        if (m["last_kv_snapshot"] or {}).get("session") != "B" or m["kv_snapshots"] != before["kv_snapshots"] + 1:
            raise AssertionError(f"B's second snapshot did not land: {m['last_kv_snapshot']}")
        out["snapshot"] = m["last_kv_snapshot"]  # over the socket: bytes, engine ms, store ms
        # a streamed turn (C) and a buffered one (D) of A's first prompt
        status, headers, raw = agent_call("POST", f"/agent/{a}/chat", _daemon_body("C", DAEMON_TURNS[0]))
        frames = _parse_sse(raw) if status == 200 else []
        ids = [f["id"] for f in frames if f.get("event") == "token"]
        done = [f for f in frames if f.get("event") == "done"]
        out["stream"] = {"status": status, "bytes": len(raw), "content_length": headers.get("Content-Length"),
                         "content_type": headers.get("Content-Type"), "tokens": len(ids)}
        if (status != 200 or not headers.get("Content-Type", "").startswith("text/event-stream")
                or ids != [str(i) for i in range(DAEMON_MAX_TOKENS)] or len(done) != 1):
            raise AssertionError(f"the streamed turn through the C++: {out['stream']} {raw[-200:]!r}")
        if _sse_token_ids(raw) != want[0]:
            raise AssertionError(f"C's streamed ids differ from A's first turn: {_sse_token_ids(raw)} {want[0]}")
        status, _, raw_d = agent_call("POST", f"/agent/{a}/chat", {**_daemon_body("D", DAEMON_TURNS[0]), "stream": False})
        buffered = json.loads(raw_d)
        out["stream"]["done_equal_buffered"] = all(done[0]["data"][k] == buffered[k]
                                                   for k in ("response", "usage", "agent", "model"))
        if status != 200 or not out["stream"]["done_equal_buffered"]:
            raise AssertionError(f"C's done {done[0]['data']} != D's buffered {buffered}")
        d.wait(lambda: settled(a), "C's and D's snapshots", 90)
        out["proxy_overhead"] = _proxy_overhead(d.port, a, data)
        agent_calls += PROXY_PROBES  # the probes through the front door
        # the journal and the C++ counters against the calls sent so far
        sent = agent_calls

        def journal_caught_up():
            _, doc = d.call("GET", f"/agents/{a}/requests", auth=True)
            stats = doc["data"]["stats"]
            return stats if stats["completed"] >= sent else None

        stats = d.wait(journal_caught_up, "the journal's settles", 30)

        def counted():
            _, doc = d.call("GET", f"/agents/{a}/metrics/history", auth=True)
            n = sum((smp.get("proxy") or {}).get("requests", 0) for smp in doc["data"])
            return n if n >= sent else None

        out["journal_before_crash"] = stats
        out["cxx_counted"] = d.wait(counted, "the C++ counters in the metrics", 30)
        out["agent_calls_before_crash"] = sent
        if stats["completed"] != sent or stats["pending"] or stats["failed"]:
            raise AssertionError(f"journal {stats} against {sent} calls through the C++")
        # the crash: B's third turn journaled by the C++ while the host is down
        os.kill(host, signal.SIGKILL)
        t_kill = time.monotonic()
        d.wait(lambda: d.call("GET", f"/agents/{a}", auth=True)[1]["data"]["status"] != "running",
               "the reconciler", 30)
        status, headers, raw = agent_call("POST", f"/agent/{a}/chat", _daemon_body("B", DAEMON_TURNS[2]))
        if status != 202:
            raise AssertionError(f"turn 3 while down: {status} {raw[:300]!r}")
        rid = json.loads(raw)["data"]["request_id"]
        t_resume = time.monotonic()
        status, doc = d.call("POST", f"/agents/{a}/resume", auth=True)
        assert status == 200, doc
        d.wait(lambda: loaded(a), "the respawned model", 480)
        out["respawn_boot_s"] = time.monotonic() - t_resume

        def replayed(daemon=d):
            _, doc = daemon.call("GET", f"/agents/{a}/requests?status=completed", auth=True)
            return next((r for r in doc["data"]["requests"] if r["id"] == rid), None)

        entry = d.wait(replayed, "the replay", 120)
        out["crash_to_replayed_s"] = time.monotonic() - t_kill
        third = _sse_token_ids(base64.b64decode(entry["response"]["body_b64"]))
        m = d.wait(lambda: settled(a), "B's third snapshot", 90)
        if (m["last_kv_snapshot"] or {}).get("session") != "B":
            raise AssertionError(f"B's snapshot after the replay did not land: {m['last_kv_snapshot']}")
        out["replay"] = {"equal": third == want[2], "retry_count": entry["retry_count"],
                         "kv_restores": m["kv_restores"]}
        if third != want[2] or entry["retry_count"] or m["kv_restores"] < 1:
            raise AssertionError(f"B's replayed turn 3: {out['replay']} {third} {want[2]}")
        # A's fourth turn, then the daemon's SIGKILL
        want4 = turn(a, "A", NATIVE_TURN4)
        m = d.wait(lambda: settled(a), "A's fourth snapshot", 90)
        snaps = m["kv_snapshots"]
        _, doc = d.call("GET", f"/agents/{a}/requests", auth=True)
        stats_before = doc["data"]["stats"]
        host = next(p for p in _children(d.proc.pid) if _maps_cuda(p))
        os.kill(d.proc.pid, signal.SIGKILL)
        d.proc.wait(timeout=30)
        t_dead = time.monotonic()
        try:
            os.kill(host, 0)
            out["host_outlived_daemon"] = True
            os.killpg(host, signal.SIGKILL)
        except ProcessLookupError:
            out["host_outlived_daemon"] = False
        _wait_pid_gone(host)
        out["aof_bytes"] = os.path.getsize(os.path.join(data, "store.aof"))
        five_before = [s for s in d.statuses if s >= 500]
        # a new daemon on the same data directory
        d2 = _Daemon(env, data=data)
        daemons.append(d2)
        listed = d2.wait(lambda: next((x for x in _daemon_call(d2.port, "GET", "/agents", auth=True)[1]["data"]
                                       if x["id"] == a), None), "the agent after the restart", 60)
        out["restart_to_listed_s"] = time.monotonic() - t_dead
        _, doc = d2.call("GET", f"/agents/{a}/requests", auth=True)
        out["journal_after_restart"] = doc["data"]["stats"]
        start_line = next((ln for ln in open(d2.log_path, errors="replace") if "control plane listening" in ln), "")
        if "data plane native" not in start_line or "store native://" not in start_line:
            raise AssertionError(f"the restarted daemon's start line: {start_line!r}")
        if out["journal_after_restart"] != stats_before:
            raise AssertionError(f"journal stats {stats_before} before the kill, "
                                 f"{out['journal_after_restart']} after the restart")
        t_resume = time.monotonic()
        status, doc = d2.call("POST", f"/agents/{a}/resume", auth=True)
        assert status == 200, doc
        d2.wait(lambda: loaded(a, d2), "the model after the restart", 480)
        out["restart_boot_s"] = time.monotonic() - t_resume
        out["status_after_restart"] = listed["status"]
        _, _, raw = agent_call("GET", f"/agent/{a}/history", daemon=d2)
        b_turns = [t for t in json.loads(raw)["history"] if t.get("session") == "B" and t["role"] == "user"]
        fourth = turn(a, "B", NATIVE_TURN4, daemon=d2)
        m = metrics(a, d2)
        launches = m["kernel_launches"]
        out.update({
            "b_user_turns_after_restart": len(b_turns),
            "restored_equal": fourth == want4,
            "kv_restores_after_restart": m["kv_restores"],
            "kv_snapshots_before_kill": snaps,
            "launches": launches,
        })
        five = five_before + [s for s in d2.statuses if s >= 500]
        if five:
            raise AssertionError(f"5xx answers: {five}")
        if len(b_turns) != 3:
            raise AssertionError(f"B's user turns after the restart: {len(b_turns)}")
        if fourth != want4 or m["kv_restores"] < 1:
            raise AssertionError(f"B's fourth turn after the restart: {fourth} vs A's {want4}, "
                                 f"kv_restores {m['kv_restores']}")
        if not (launches["flash_prefill"] > 0 and launches["flash_decode"] > 0
                and launches["fused_paged_flash_prefill"] == 0 and launches["fused_paged_flash_decode"] == 0):
            raise AssertionError(f"kernel launches in the restarted host: {launches}")
        out["python_door"] = {"overhead_ms": python_door["proxy_overhead"]["overhead_ms"],
                              "snapshot_store_ms": python_door["snapshot"]["store_ms"],
                              "snapshot_bytes": python_door["snapshot"]["bytes"]}
        log(f"native: {out['start_line']}; boot {out['boot_s']:.1f} s, respawn {out['respawn_boot_s']:.1f} s, "
            f"after the restart {out['restart_boot_s']:.1f} s; crash->replayed {out['crash_to_replayed_s']:.1f} s; "
            f"front door {out['proxy_overhead']}; snapshot over the socket {out['snapshot']}; beside 7b's "
            f"Python front door and store over HTTP in this run {out['python_door']}; AOF {out['aof_bytes']} B; "
            f"restart->listed {out['restart_to_listed_s']:.2f} s; host outlived the daemon: "
            f"{out['host_outlived_daemon']}; C++ counted {out['cxx_counted']} of {sent} calls; "
            f"launches {launches}; {card}")
        return out
    finally:
        for daemon in daemons:
            daemon.close()
        shutil.rmtree(data, ignore_errors=True)


# the fleet phase: one llama3-8b agent with two replicas (two engine hosts
# on GPU 0), routed through the proxy; the replica serving a stream is
# SIGKILLed mid-stream and the stream is spliced onto the survivor
FLEET_SESSIONS = 8  # fresh one-turn sessions for the spread gate (at least)
FLEET_SESSIONS_MAX = 24  # sent before the spread gate gives up
FLEET_SPREAD_TOKENS = 8
FLEET_TURN2_TOKENS = 96
FLEET_KILL_AFTER = 8  # token frames the client has read before the kill
FLEET_PERSONA = DAEMON_PERSONAS[0]
FLEET_MODEL = {"engine": "llm", "config": "llama3-8b",
               "options": {"system_prompt": FLEET_PERSONA, "streaming": True}}


def _fleet_tenants(data: str, agent_id: str) -> dict[int, dict]:
    """replica ordinal → the latest tenant port of ``agent_id`` in each
    engine host's log and that tenant's /metrics (a respawned host logs a
    new port under the same file)."""
    import glob

    out = {}
    for path in glob.glob(os.path.join(data, "runtime", "engines", "host-*.log")):
        port = None
        with open(path, errors="replace") as f:
            for line in f:
                if f"tenant {agent_id} attached on :" in line:
                    port = int(line.rsplit(":", 1)[1])
        if port is None:
            continue
        try:
            _, m = _http(port, "GET", "/metrics", timeout=10)
        except (OSError, AssertionError):
            continue  # a host that died since its last attach
        out[m["replica"]] = {"port": port, "metrics": m}
    return out


def _host_pids(daemon_pid: int) -> dict[int, int]:
    """replica ordinal → pid of each engine host under the daemon (its
    children with a CUDA context; the ordinal from their environment)."""
    out = {}
    for pid in _children(daemon_pid):
        if not _maps_cuda(pid):
            continue
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        out[int(env.get(b"AGENTAINER_REPLICA", b"0"))] = pid
    return out


def _stream_frames(port: int, path: str, body: dict, on_token=None) -> tuple[int, dict, list]:
    """One streamed request read frame by frame: (status, headers, [(arrival
    s, frame)]); ``on_token(n)`` runs after the n-th token frame arrives."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(body), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        headers = dict(resp.getheaders())
        if resp.status != 200:
            return resp.status, headers, [(time.monotonic(), {"body": resp.read().decode()})]
        frames, block, tokens = [], b"", 0
        while True:
            line = resp.readline()
            if not line:
                break
            if line.strip():
                block += line
                continue
            if block:
                frame = _parse_sse(block)[0]
                frames.append((time.monotonic(), frame))
                block = b""
                if frame.get("event") == "token":
                    tokens += 1
                    if on_token is not None:
                        on_token(tokens)
        return resp.status, headers, frames
    finally:
        conn.close()


def _gaps_ms(times: list[float]) -> dict:
    import statistics

    gaps = [1000 * (b - a) for a, b in zip(times, times[1:])]
    return {"p50": statistics.median(gaps) if gaps else None,
            "mean": (1000 * (times[-1] - times[0]) / (len(times) - 1)) if len(times) > 1 else None,
            "tokens": len(times)}


def phase_fleet(card: str) -> dict:
    """The replica fleet on the card: the port's daemon as a child process
    with ``features.streaming`` on, one llama3-8b agent deployed with
    ``replicas: 2`` (full width and depth, random bf16 weights from seed 0,
    the reference's default features): two engine hosts on GPU 0. Gates:
    both replicas loaded, each in its own process, two CUDA processes under
    the daemon and none in it, each host under twice the weights; at least
    8 fresh sessions reach both replicas (power of two choices), both
    hosts launched the dense kernels and no paged one, a session's second
    turn goes to its first turn's replica; sessions T and S run the same
    first turn, T its 96-token second turn undisturbed; once S's snapshot
    has landed, S's second turn streams and its replica's host is
    SIGKILLed after 8 token frames: on its one connection the client sees
    ids 0..n-1 and one done, with T's token ids; ``stream_failovers_total``
    >= 1, the survivor's ``kv_restores`` >= 1, S's entry completed at
    offset n-1 with no retry, no 5xx; a buffered /chat sent right after the
    stream answers 200 from the survivor; the monitor counts the death and
    the fleet is back at two loaded replicas."""
    _free_cuda()
    used0 = _gpu_used_mib()
    d = _Daemon({"ATPU_STREAMING": "1", "ATPU_JITTER_SEED": "0"})
    call, wait, port = d.call, d.wait, d.port
    out: dict = {"card": card}

    def stream(session: str, msg: str, max_tokens: int, on_token=None):
        body = {"message": msg, "session": session, "max_tokens": max_tokens, "ignore_eos": True,
                "stream": True}
        status, headers, frames = _stream_frames(port, f"/agent/{aid}/chat", body, on_token)
        d.statuses.append(status)
        if status != 200:
            raise AssertionError(f"streamed turn of {session}: {status} {frames}")
        return headers.get("X-Agentainer-Request-ID", ""), frames

    def tokens_of(frames) -> list[int]:
        evs = [f for _, f in frames if f.get("event") in ("token", "done", "error")]
        if not evs or evs[-1]["event"] != "done" or any(f["event"] == "error" for f in evs):
            raise AssertionError(f"a stream without its done frame: {evs[-3:]}")
        return [f["data"]["token"] for f in evs if f["event"] == "token"]

    def entry(rid: str) -> dict:
        _, doc = call("GET", f"/agents/{aid}/requests?status=completed", auth=True)
        found = next((r for r in doc["data"]["requests"] if r["id"] == rid), None)
        if found is None:
            raise AssertionError(f"request {rid} is not completed")
        return found

    def both_loaded() -> bool:
        t = _fleet_tenants(d.data, aid)
        return len(t) == 2 and all(v["metrics"]["model_loaded"] for v in t.values())

    def settle() -> None:
        """Every host's snapshots landed: none competes with the next
        turn's for an engine's staging limiter."""
        wait(lambda: all(t["metrics"]["kv_snapshots_in_flight"] == 0
                         for t in _fleet_tenants(d.data, aid).values()), "the hosts' snapshots", 120)

    try:
        wait(lambda: _daemon_call(port, "GET", "/health")[0] == 200, "the daemon", 60)
        if _maps_cuda(d.proc.pid):
            raise AssertionError("the daemon created a CUDA context")
        status, doc = call("POST", "/agents", {"name": "fleet", "model": FLEET_MODEL, "replicas": 2},
                           auth=True)
        assert status == 200, doc
        aid = doc["data"]["id"]
        t0 = time.monotonic()
        status, doc = call("POST", f"/agents/{aid}/start", auth=True)
        assert status == 200, doc
        replica_ids = doc["data"]["replica_ids"]
        ordinal = {eid: i for i, eid in enumerate(replica_ids)}
        wait(both_loaded, "both replicas' models", 480)
        out["boot_s"] = time.monotonic() - t0
        pids = _host_pids(d.proc.pid)
        if sorted(pids) != [0, 1] or len(set(pids.values())) != 2:
            raise AssertionError(f"engine hosts under the daemon: {pids}")
        apps = _compute_apps()
        used = _gpu_used_mib() - used0
        if set(pids.values()) <= set(apps):
            host_mib = {i: apps[pid] for i, pid in pids.items()}
            source = "nvidia-smi compute apps by pid"
        else:
            # nvidia-smi sees another pid namespace: each host holds at
            # most the card's new memory less the other's weights
            host_mib = {i: used - WEIGHT_BYTES_8B / 2**20 for i in pids}
            source = f"bound: {used} MiB used less one host's weights"
        out.update(host_mib=host_mib, host_mib_source=source, card_used_mib=used, compute_apps=apps)
        if any(v * 2**20 >= 2 * WEIGHT_BYTES_8B for v in host_mib.values()):
            raise AssertionError(f"host memory {host_mib} MiB ({source}): a host at or above twice the weights")

        # spread: fresh one-turn sessions until both replicas served one
        served: dict[int, list[str]] = {0: [], 1: []}
        first_rid = {}
        n = 0
        while n < FLEET_SESSIONS or not all(served.values()):
            if n >= FLEET_SESSIONS_MAX:
                raise AssertionError(f"{n} fresh sessions all went to one replica: {served}")
            session = f"f{n}"
            rid, frames = stream(session, DAEMON_TURNS[0], FLEET_SPREAD_TOKENS)
            tokens_of(frames)
            first_rid[session] = rid
            served[ordinal[entry(rid)["replica_id"]]].append(session)
            n += 1
        out["spread"] = {i: len(v) for i, v in served.items()}
        _, doc = call("GET", f"/agents/{aid}/metrics", auth=True)
        out["router"] = {k: v for k, v in doc["data"]["fleet"].items() if k != "replicas"}
        # affinity: a session's second turn goes where its first went
        sticky = served[0][0]
        rid, frames = stream(sticky, DAEMON_TURNS[1], FLEET_SPREAD_TOKENS)
        tokens_of(frames)
        if entry(rid)["replica_id"] != entry(first_rid[sticky])["replica_id"]:
            raise AssertionError(f"session {sticky}'s second turn left its replica")
        tenants = _fleet_tenants(d.data, aid)
        launches0 = {i: t["metrics"]["kernel_launches"] for i, t in tenants.items()}
        for i, launches in launches0.items():
            if not (launches["flash_prefill"] > 0 and launches["flash_decode"] > 0
                    and launches["fused_paged_flash_prefill"] == 0
                    and launches["fused_paged_flash_decode"] == 0):
                raise AssertionError(f"replica {i}'s kernel launches: {launches}")
        settle()

        # T undisturbed; S's first turn and its snapshot
        _, t1 = stream("T", DAEMON_TURNS[0], DAEMON_MAX_TOKENS)
        settle()
        _, t2 = stream("T", DAEMON_TURNS[1], FLEET_TURN2_TOKENS)
        settle()
        want1, want2 = tokens_of(t1), tokens_of(t2)
        rid, s1 = stream("S", DAEMON_TURNS[0], DAEMON_MAX_TOKENS)
        if tokens_of(s1) != want1:
            raise AssertionError(f"sessions T and S differ on turn one: {tokens_of(s1)} {want1}")
        victim_id = entry(rid)["replica_id"]
        victim = ordinal[victim_id]
        survivor = 1 - victim
        settle()
        m = _fleet_tenants(d.data, aid)[victim]["metrics"]
        if (m["last_kv_snapshot"] or {}).get("session") != "S" or m["kv_snapshot_errors"]:
            raise AssertionError(f"S's snapshot did not land: {m['last_kv_snapshot']}, errors "
                                 f"{m['kv_snapshot_errors']}, deferred {m['kv_snapshots_deferred']}")
        out["snapshot"] = m["last_kv_snapshot"]
        pre_kill = _fleet_tenants(d.data, aid)
        restores0 = pre_kill[survivor]["metrics"]["kv_restores"]
        out["engine_itl_p50_ms"] = {"victim_before": pre_kill[victim]["metrics"]["itl_ms_p50"]}
        victim_pid = _host_pids(d.proc.pid)[victim]

        # S's second turn: its host is SIGKILLed after FLEET_KILL_AFTER frames
        kill: dict = {}
        health: dict = {}

        def watch_health():
            t_end = time.monotonic() + 120
            while time.monotonic() < t_end and "alive_again" not in health:
                try:
                    _, doc = _daemon_call(port, "GET", f"/agents/{aid}/metrics", auth=True, timeout=10)
                    state = doc["data"]["fleet"]["replicas"][victim_id]["health"]
                except (OSError, ValueError, KeyError, TypeError):
                    state = None
                now = time.monotonic()
                if state in ("suspect", "dead") and state not in health:
                    health[state] = now
                if state == "alive" and "dead" in health:
                    health["alive_again"] = now
                time.sleep(0.1)

        watcher = threading.Thread(target=watch_health, name="fleet-health", daemon=True)

        def on_token(count: int):
            if count == FLEET_KILL_AFTER and not kill:
                os.kill(victim_pid, signal.SIGKILL)
                kill["t"] = time.monotonic()
                kill["after_tokens"] = count
                watcher.start()

        s_rid, s2 = stream("S", DAEMON_TURNS[1], FLEET_TURN2_TOKENS, on_token)
        if not kill:
            raise AssertionError("S's stream ended before the kill")
        out["kill_to_done_s"] = time.monotonic() - kill["t"]
        log(f"fleet: S's stream done {out['kill_to_done_s']:.2f} s after the kill")
        surv_m = _fleet_tenants(d.data, aid)[survivor]["metrics"]
        out["engine_itl_p50_ms"]["survivor_after"] = surv_m["itl_ms_p50"]
        # a buffered turn right after the kill, on a session pinned to the
        # dead replica: the bounded next-replica retry answers it
        pinned = served[victim][0] if served[victim][0] != sticky else served[victim][-1]
        t_buf = time.monotonic()
        status, doc = call("POST", f"/agent/{aid}/chat", {
            "message": DAEMON_TURNS[1], "session": pinned, "max_tokens": FLEET_SPREAD_TOKENS,
            "ignore_eos": True})
        out["buffered"] = {"status": status, "s_after_kill": t_buf - kill["t"], "session": pinned}
        if status != 200:
            raise AssertionError(f"buffered /chat after the kill: {status} {doc}")
        _, rq = call("GET", f"/agents/{aid}/requests?status=completed", auth=True)
        buf_entry = max((r for r in rq["data"]["requests"] if r["replica_id"]), key=lambda r: r["created_at"])
        out["buffered"]["replica"] = ordinal.get(buf_entry["replica_id"])

        evs = [(t, f) for t, f in s2 if f.get("event") in ("token", "done", "error")]
        ids = [f["id"] for _, f in evs if f["event"] == "token"]
        got2 = tokens_of(s2)
        times = [t for t, f in evs if f["event"] == "token"]
        k_before = sum(1 for t in times if t < kill["t"])
        # frames the dead host sent may still sit in the client's buffer at
        # the kill: the splice is the longest gap from the kill on
        gaps = [b - a for a, b in zip(times, times[1:])]
        g = max(range(k_before - 1, len(gaps)), key=gaps.__getitem__) if k_before < len(times) else None
        _, faults_doc = call("GET", "/internal/faults", auth=True)
        fd = faults_doc["data"]
        s_entry = entry(s_rid)
        out.update({
            "ids_contiguous": ids == [str(i) for i in range(len(ids))],
            "tokens": len(got2),
            "equal_to_T": got2 == want2,
            "kill_after_tokens": k_before,
            "failover_gap_ms": None if g is None else 1000 * gaps[g],
            "splice_at_offset": None if g is None else g + 1,
            "itl_before_ms": _gaps_ms(times[:k_before] if g is None else times[:g + 1]),
            "itl_after_ms": _gaps_ms([] if g is None else times[g + 1:]),
            "stream_failovers_total": fd["stream_failovers_total"],
            "survivor_kv_restores": surv_m["kv_restores"] - restores0,
            "restore": surv_m.get("last_kv_restore"),
            "s_entry": {k: s_entry[k] for k in ("status", "stream_offset", "retry_count")},
            "s_entry_replica": ordinal.get(s_entry["replica_id"]),
        })
        if not out["equal_to_T"]:
            j = next((i for i, (x, y) in enumerate(zip(got2, want2)) if x != y), min(len(got2), len(want2)))
            out["divergence"] = {"at": j, "T": want2[j:j + 4], "S": got2[j:j + 4]}
        # repair: the monitor's death, then the fleet back at two replicas
        wait(lambda: "dead" in health, "the monitor's DEAD", 60)
        wait(both_loaded, "the respawned replica", 480)
        out["respawn_s"] = time.monotonic() - kill["t"]
        watcher.join(timeout=130)
        _, faults_doc = call("GET", "/internal/faults", auth=True)
        out["monitor"] = faults_doc["data"]["replica_monitor"]
        out["repair"] = faults_doc["data"]["fleet_repair"]
        out["kill_to_suspect_s"] = health["suspect"] - kill["t"] if "suspect" in health else None
        out["kill_to_dead_s"] = health["dead"] - kill["t"]
        out["alive_again_s"] = health["alive_again"] - kill["t"] if "alive_again" in health else None
        _, doc = call("GET", f"/agents/{aid}", auth=True)
        out["agent"] = {"status": doc["data"]["status"], "replicas": len(doc["data"]["replica_ids"])}
        end = _fleet_tenants(d.data, aid)
        names = ("flash_prefill", "flash_decode", "fused_paged_flash_prefill", "fused_paged_flash_decode")
        # both hosts' calls: each one's count before the kill, the
        # survivor's since, and the respawned host's
        out["launches"] = {
            fn: launches0[victim][fn] + end[survivor]["metrics"]["kernel_launches"][fn]
            + end[victim]["metrics"]["kernel_launches"][fn] for fn in names
        }
        out["launches_by_host"] = {"before_kill": launches0,
                                   "end": {i: end[i]["metrics"]["kernel_launches"] for i in end}}
        five = [s for s in d.statuses if s >= 500]
        if five:
            raise AssertionError(f"5xx answers: {five}")
        if not out["ids_contiguous"] or out["tokens"] != FLEET_TURN2_TOKENS:
            raise AssertionError(f"S's spliced ids: {ids}")
        if out["kill_after_tokens"] >= len(times):
            raise AssertionError("the kill did not land mid-stream")
        if out["stream_failovers_total"] < 1 or out["survivor_kv_restores"] < 1:
            raise AssertionError(f"failovers {out['stream_failovers_total']}, "
                                 f"survivor restores {out['survivor_kv_restores']}")
        if (out["s_entry"] != {"status": "completed", "stream_offset": len(ids) - 1, "retry_count": 0}
                or out["s_entry_replica"] != survivor):
            raise AssertionError(f"S's journal entry: {s_entry}")
        if health.get("alive_again", t_buf) < t_buf:
            raise AssertionError(f"the buffered turn left after the respawn: the retry went untested "
                                 f"{out['buffered']}")
        if out["buffered"]["replica"] != survivor:
            raise AssertionError(f"the buffered turn after the kill: {out['buffered']}")
        if out["monitor"]["deaths_total"] < 1 or out["agent"] != {"status": "running", "replicas": 2}:
            raise AssertionError(f"repair: monitor {out['monitor']}, agent {out['agent']}")
        log(f"fleet: boot {out['boot_s']:.1f} s, hosts {host_mib} MiB ({source}), spread {out['spread']}, "
            f"failover gap {out['failover_gap_ms']:.1f} ms, frame gaps before {out['itl_before_ms']} after "
            f"{out['itl_after_ms']}, engine ITL p50 {out['engine_itl_p50_ms']}, restore {out['restore']}, "
            f"kill->suspect {out['kill_to_suspect_s']} s, "
            f"kill->dead {out['kill_to_dead_s']:.2f} s, respawn {out['respawn_s']:.1f} s, "
            f"buffered {out['buffered']}, launches {out['launches']}; {card}")
    finally:
        d.close()
    if not out["equal_to_T"]:
        out["logit_gap"] = _fleet_logit_gap(want1, want2, out["divergence"]["at"], got2)
        raise AssertionError(f"S's spliced turn two differs from T's: {out['divergence']}, "
                             f"logit gap {out['logit_gap']}")
    return out


def _fleet_logit_gap(turn1: list[int], turn2: list[int], j: int, got: list[int]) -> float | None:
    """After a failed splice (the daemon gone): the logit of T's token minus
    S's at the first differing position, after T's stream, through a
    llama3-8b engine with the hosts' weights (seed 0)."""
    if j >= min(len(turn2), len(got)):
        return None
    with _serving({"streaming": True}) as (app, _):
        enc = app.engine.tokenizer.encode
        stream = enc(f"{FLEET_PERSONA}\n\n{DAEMON_TURNS[0]}") + turn1 + enc(DAEMON_TURNS[1]) + turn2[:j]
        gap = _logit_gap(app.engine, stream, turn2[j], got[j])
    log(f"fleet: S diverges from T at token {j}: {turn2[j]} vs {got[j]}; logit gap {gap:.4g}")
    return gap


# -- phase 7e: the operator's tooling ----------------------------------------

# a session whose snapshot passes the store socket's 64 MiB frame cap:
# llama3-8b keeps 131,072 B of bf16 KV a token, and the snapshot's npz packs
# random weights' KV to ~96 kB a position (63,967,227 B for 665 positions on
# the card), so past ~700 positions. The agent reads the fixture's
# tokenizer.json (BPE: about a third of a token a character), so turn one's
# message is the log repeated until the reader counts OP_LONG_TOKENS tokens
# (``_op_turns``): two bos + 720 + 48 + ~20 + 48 positions after turn two.
OP_LOG = ("The lighthouse log, night watch: wind from the north-east, sea state rough, one ship "
          "passing at a safe distance, the lamp trimmed twice, the fog horn silent, the keeper "
          "awake and writing by the stove. ")
OP_ASK = " Read the log back to me and add one line to it."
OP_LONG_TOKENS = 720
OP_TURNS = ("Now add the next hour of the watch, with the weather and the ships you can see.",
            "And what does the keeper eat at dawn?")
OP_MAX_TOKENS = 48
OP_SOCKET_CAP = 64 << 20  # the C++'s frame cap on the store socket
CLI_PROBES = 5  # `health` through the CLI and straight to the API, in turns
OP_DEPLOY_FILE = {
    "apiVersion": "agentainer/v1",
    "kind": "AgentDeployment",
    "metadata": {"name": "op-fleet"},
    "spec": {"agents": [
        {"name": "op-front", "model": "echo", "dependsOn": ["op-back"], "env": {"ROLE": "${OP_ROLE}"}},
        {"name": "op-back", "model": "echo"},
    ]},
}


def _op_turns(tok) -> tuple[str, str, str]:
    """The long session's three turns: turn one's log cut to the shortest
    prefix of whole words the reader counts OP_LONG_TOKENS tokens in, then
    OP_TURNS."""
    words = (OP_LOG * 40).split(" ")
    lo, hi = 1, len(words)
    while lo < hi:  # the fewest words that reach the count
        mid = (lo + hi) // 2
        if len(tok.encode(" ".join(words[:mid]) + OP_ASK, add_bos=False)) >= OP_LONG_TOKENS:
            hi = mid
        else:
            lo = mid + 1
    return (" ".join(words[:lo]) + OP_ASK, *OP_TURNS)


def _tokenizer_sibling(root: str) -> str:
    """A sibling of phase 6's checkpoint directory: symlinks to its files
    (config.json, the index, the shards) and the fixture as
    ``tokenizer.json``."""
    sib = root.rstrip("/") + "-bpe"
    os.makedirs(sib)
    for name in os.listdir(root):
        os.symlink(os.path.join(root, name), os.path.join(sib, name))
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)), TOKENIZER_FIXTURE),
                os.path.join(sib, "tokenizer.json"))
    return sib


def phase_operator(root: str, bpe_turn: dict, card: str) -> dict:
    """The operator's tooling on the card, in the daemon's default native
    deployment (``store_url`` auto: the C++ store and front door; with
    ``ATPU_STREAMING=1``), driven through the port's CLI as a subprocess
    (``python -m agentainer_tpu_torch.cli --server … --token …``):

    ``deploy --model-dir`` of a sibling of phase 6's llama3-8b checkpoint
    directory (``root``: full width and depth, seed-0 bf16 weights),
    symlinks to its files plus the fixture's ``tokenizer.json``, with the
    features off, prints the build log and ``built artifact 'op'``;
    ``models`` lists it as ``hf`` with its parameters; ``start``: the agent
    reads the tokenizer.json with the port's reader. The first of phase 6's
    requests through the C++ gives the token ids phase 6's engine gave
    through the same tokenizer (``bpe_turn``), and its prompt tokens are
    the reader's count plus bos. A session of two turns past 700
    positions (turn one's prompt the reader's count plus bos): its
    snapshot above 64 MiB lands over HTTP (``kv_snapshot_errors`` 0). ``backup create`` once that snapshot has
    landed, ``backup list``, a third turn T3 recorded, ``backup export``
    (the tar.gz holds the manifest), ``stop``, ``backup restore``, ``start
    op-restored``: the restored agent's T3 equals the original's token for
    token, restored from the copied KV (``kv_restores`` >= 1, the same
    prompt tokens). ``deploy -f`` of a JSON deployment (the card has no
    PyYAML) starts two echo agents in dependency order with a ``${VAR}``
    expanded, both answering 200. ``audit`` shows the artifact build, the
    backup and the restore; ``faults``, ``slice``, ``health``, ``metrics``
    and ``logs`` exit 0. Gates throughout: no 5xx, no CUDA context in the
    daemon, the dense kernels launched in both hosts and no paged one.
    Printed beside the card: artifact build ms, deploy → ready seconds,
    the snapshot's bytes, path and store ms, backup create / export /
    restore seconds, the manifest's bytes, restore → first restored token
    ms, the CLI's overhead per call."""
    import statistics
    import tarfile

    from agentainer_tpu_torch.engine.tokenizer import load_tokenizer

    _free_cuda()
    data = tempfile.mkdtemp(prefix="atpu-7e-")
    model_dir = _tokenizer_sibling(root)
    reader = load_tokenizer(128256, model_dir)
    turns = _op_turns(reader)
    out: dict = {"card": card, "model_dir_files": sorted(os.listdir(model_dir))}
    d = _Daemon({"ATPU_STORE_URL": "auto", "ATPU_STREAMING": "1"}, data=data)
    cli_root = os.path.dirname(os.path.abspath(__file__))

    def cli(*argv, env: dict | None = None) -> tuple[str, float]:
        """One CLI call: its stdout and wall seconds; fails unless it exits 0."""
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "agentainer_tpu_torch.cli", "--server", f"http://127.0.0.1:{d.port}",
             "--token", DAEMON_TOKEN, *argv],
            cwd=cli_root, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": cli_root, **(env or {})},
        )
        if res.returncode != 0:
            raise AssertionError(f"cli {' '.join(argv)}: exit {res.returncode}: {res.stderr[-2000:]}")
        return res.stdout, time.monotonic() - t0

    def agent_call(method, path, body=None):
        """(status, headers, raw body) through the C++ front door."""
        req = urllib.request.Request(
            f"http://127.0.0.1:{d.port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                got = resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as e:
            got = e.code, e.headers, e.read()
        d.statuses.append(got[0])
        return got

    def metrics(aid) -> dict:
        return json.loads(agent_call("GET", f"/agent/{aid}/metrics")[2])

    def loaded(aid) -> bool:
        status, _, raw = agent_call("GET", f"/agent/{aid}/health")
        return status == 200 and bool(json.loads(raw).get("model_loaded"))

    def turn(aid, msg, session="long", max_tokens=OP_MAX_TOKENS) -> tuple[list[int], dict]:
        """A turn of ``session`` as a ``stream: true`` body, answered
        buffered by the C++: its token ids and its ``done`` payload."""
        body = {"message": msg, "session": session, "max_tokens": max_tokens, "ignore_eos": True, "stream": True}
        status, _, raw = agent_call("POST", f"/agent/{aid}/chat", body)
        if status != 200:
            raise AssertionError(f"turn on {aid}: {status} {raw[:300]!r}")
        frames = _parse_sse(raw)
        return _sse_token_ids(raw), frames[-1]["data"]

    def settled(aid):
        m = metrics(aid)
        return m if m["kv_snapshots_in_flight"] == 0 else None

    def listed(name: str) -> dict:
        rows = json.loads(cli("list", "--json")[0])
        return next(r for r in rows if r["name"] == name)

    try:
        d.wait(lambda: _daemon_call(d.port, "GET", "/health")[0] == 200, "the daemon", 60)
        start_line = next((ln for ln in open(d.log_path, errors="replace") if "control plane listening" in ln), "")
        if "store native://" not in start_line or "data plane native" not in start_line:
            raise AssertionError(f"the daemon did not start on the native store and data plane: {start_line!r}")
        if _maps_cuda(d.proc.pid):
            raise AssertionError("the daemon created a CUDA context")
        # deploy from the directory: the build log, then the agent
        t_deploy = time.monotonic()
        text, out["cli_deploy_s"] = cli("deploy", "--name", "op", "--model-dir", model_dir,
                                        "--no-speculative", "--no-prefix-cache", "--no-deadlines")
        if "built artifact 'op'" not in text or "validated" not in text:
            raise AssertionError(f"deploy --model-dir printed: {text}")
        out["build_log"] = [ln.strip() for ln in text.splitlines() if ln.startswith("  ")]
        a = next(ln.split(": ")[1] for ln in text.splitlines() if ln.startswith("deployed op: "))
        models, _ = cli("models")
        row = next((ln.split() for ln in models.splitlines() if ln.startswith("op ")), None)
        if row is None or row[1] != "hf" or not row[2].endswith("M"):
            raise AssertionError(f"models: {models}")
        out["models_row"] = " ".join(row[:3])
        # the same directory registered again, timed through the API alone
        # (headers only: no weight byte read), then removed
        t0 = time.perf_counter()
        status, doc = d.call("POST", "/artifacts", {"path": model_dir, "name": "op-probe"}, auth=True)
        out["artifact_build_ms"] = 1e3 * (time.perf_counter() - t0)
        if status != 200 or doc["data"]["n_params"] != WEIGHT_BYTES_8B // 2:
            raise AssertionError(f"POST /artifacts: {status} {doc}")
        assert d.call("DELETE", "/artifacts/op-probe", auth=True)[0] == 200
        cli("start", a)
        d.wait(lambda: loaded(a), "the artifact's model", 480)
        out["deploy_to_ready_s"] = time.monotonic() - t_deploy
        # phase 6's first request through the C++ and the fixture's
        # tokenizer: phase 6's engine's ids through the same tokenizer
        session, message = REQUESTS[0]
        first, first_done = turn(a, message, session=session, max_tokens=16)
        reader_count = len(reader.encode(message, add_bos=False))
        out["bpe_first"] = {"tokens": len(first), "prompt_tokens": first_done["usage"]["prompt_tokens"],
                            "reader_tokens": reader_count, "chars": len(message)}
        if first != bpe_turn["tokens"] or first_done["usage"]["prompt_tokens"] != reader_count + 1:
            raise AssertionError(f"the artifact agent's first reply through tokenizer.json: {first} "
                                 f"{first_done['usage']}; phase 6's engine gave {bpe_turn}, the reader counts "
                                 f"{reader_count} + bos")
        d.wait(lambda: settled(a), "the first session's snapshot", 120)
        # a session past the socket's frame cap
        before = metrics(a)
        want = [turn(a, msg) for msg in turns[:2]]
        out["long_turn1"] = {"prompt_tokens": want[0][1]["usage"]["prompt_tokens"], "chars": len(turns[0]),
                             "reader_tokens": len(reader.encode(turns[0], add_bos=False))}
        if out["long_turn1"]["prompt_tokens"] != out["long_turn1"]["reader_tokens"] + 1:
            raise AssertionError(f"the long turn's prompt tokens are not the reader's + bos: {out['long_turn1']}")
        m = d.wait(lambda: settled(a), "the long session's snapshots", 180)
        snap = m["last_kv_snapshot"] or {}
        out["snapshot"] = snap
        out["kv_snapshots"] = m["kv_snapshots"] - before["kv_snapshots"]
        if (snap.get("session") != "long" or snap["bytes"] <= OP_SOCKET_CAP or snap["path"] != "http"
                or m["kv_snapshot_errors"] or out["kv_snapshots"] < 1):
            raise AssertionError(f"the long session's snapshot: {snap}, {out['kv_snapshots']} landed, "
                                 f"errors {m['kv_snapshot_errors']} ({m.get('last_kv_snapshot_error')})")
        # the backup, then T3 on the original
        text, out["backup_create_s"] = cli("backup", "create", "--name", "before-t3")
        bid = text.split()[1]
        t3, t3_done = turn(a, turns[2])
        backups = json.loads(cli("backup", "list")[0])
        if [b["id"] for b in backups] != [bid] or backups[0]["agents"] != 1:
            raise AssertionError(f"backup list: {backups}")
        tar_path = os.path.join(data, "op-backup.tar.gz")
        _, out["backup_export_s"] = cli("backup", "export", bid, "-o", tar_path)
        with tarfile.open(tar_path) as tar:
            members = {mb.name: mb.size for mb in tar.getmembers()}
        if list(members) != [f"{bid}.json"]:
            raise AssertionError(f"the export holds {members}")
        out["manifest_bytes"] = members[f"{bid}.json"]
        out["export_bytes"] = os.path.getsize(tar_path)
        launches = metrics(a)["kernel_launches"]
        cli("stop", a)
        t_restore = time.monotonic()
        text, out["backup_restore_s"] = cli("backup", "restore", bid)
        if text.strip() != "restored 1 agents":
            raise AssertionError(f"backup restore: {text}")
        r = listed("op-restored")["id"]
        cli("start", r)
        d.wait(lambda: loaded(r), "the restored agent's model", 480)
        out["restored_ready_s"] = time.monotonic() - t_restore
        got3, got3_done = turn(r, turns[2])
        out["restore_to_t3_s"] = time.monotonic() - t_restore
        m = metrics(r)
        restore = m["last_kv_restore"] or {}
        out.update({
            "t3_equal": got3 == t3, "t3_tokens": len(t3), "kv_restores": m["kv_restores"],
            "restore": restore, "t3_usage": got3_done["usage"], "original_t3_usage": t3_done["usage"],
            # the restored turn's first token: the store read and the
            # engine's restore before the turn, then its TTFT
            "restore_to_first_token_ms": restore.get("store_ms", 0) + restore.get("restore_ms", 0)
            + (got3_done.get("ttft_ms") or 0),
        })
        if got3 != t3 or m["kv_restores"] < 1 or restore.get("session") != "long":
            raise AssertionError(f"the restored T3 {got3} vs {t3}, kv_restores {m['kv_restores']}, {restore}")
        if got3_done["usage"] != t3_done["usage"] or restore.get("bytes") != snap["bytes"]:
            raise AssertionError(f"the restored T3 prefilled otherwise: {got3_done['usage']} vs "
                                 f"{t3_done['usage']}; restored {restore.get('bytes')} B of {snap['bytes']}")
        launches2 = m["kernel_launches"]
        for name, counts in (("original", launches), ("restored", launches2)):
            if not (counts["flash_prefill"] > 0 and counts["flash_decode"] > 0
                    and counts["fused_paged_flash_prefill"] == 0 and counts["fused_paged_flash_decode"] == 0):
                raise AssertionError(f"kernel launches in the {name} host: {counts}")
        out["launches"] = {k: launches[k] + launches2[k] for k in launches}
        # a deployment file in JSON: two echo agents, one after the other
        spec = os.path.join(data, "op-fleet.json")
        with open(spec, "w") as f:
            json.dump(OP_DEPLOY_FILE, f)
        text, out["deploy_file_s"] = cli("deploy", "-f", spec, "--start", env={"OP_ROLE": "relay"})
        order = [ln.split(":")[0].split()[1] for ln in text.splitlines() if ln.startswith("deployed ")]
        if order != ["op-back", "op-front"] or text.count("started ") != 2:
            raise AssertionError(f"deploy -f: {text}")
        for name in order:
            row = listed(name)
            status, _, raw = agent_call("POST", f"/agent/{row['id']}/chat", {"message": f"hi {name}"})
            if status != 200 or row["status"] != "running":
                raise AssertionError(f"{name}: {row['status']}, chat {status} {raw[:200]!r}")
        _, doc = d.call("GET", f"/agents/{listed('op-front')['id']}", auth=True)
        if doc["data"]["env"] != {"ROLE": "relay"}:
            raise AssertionError(f"op-front's env: {doc['data']['env']}")
        # the other verbs
        audit, _ = cli("audit", "--limit", "200")
        for action in ("artifact-build", "backup-create", "backup-restore"):
            if action not in audit:
                raise AssertionError(f"audit lacks {action}: {audit}")
        for argv in (("faults",), ("slice",), ("health",), ("metrics",), ("logs", r, "--tail", "20")):
            cli(*argv)
        walls: dict[str, list[float]] = {"cli": [], "api": []}
        for i in range(CLI_PROBES):
            for kind in ("cli", "api") if i % 2 == 0 else ("api", "cli"):
                if kind == "cli":
                    walls["cli"].append(1e3 * cli("health")[1])
                else:
                    t0 = time.perf_counter()
                    assert d.call("GET", "/health", auth=True)[0] == 200
                    walls["api"].append(1e3 * (time.perf_counter() - t0))
        med = {k: statistics.median(v) for k, v in walls.items()}
        out["cli_overhead_ms"] = {"cli_ms": med["cli"], "api_ms": med["api"],
                                  "overhead_ms": med["cli"] - med["api"], "probes": CLI_PROBES}
        five = [s for s in d.statuses if s >= 500]
        if five:
            raise AssertionError(f"5xx answers: {five}")
        if _maps_cuda(d.proc.pid):
            raise AssertionError("the daemon created a CUDA context")
        log(f"operator: artifact build {out['artifact_build_ms']:.1f} ms ({out['models_row']}), deploy -> ready "
            f"{out['deploy_to_ready_s']:.1f} s; snapshot {snap['bytes']} B over {snap['path']} in "
            f"{snap['store_ms']:.1f} ms; backup create {out['backup_create_s']:.2f} s, export "
            f"{out['backup_export_s']:.2f} s ({out['export_bytes']} B, manifest {out['manifest_bytes']} B), restore "
            f"{out['backup_restore_s']:.2f} s; restored ready {out['restored_ready_s']:.1f} s, restore -> first "
            f"token {out['restore_to_first_token_ms']:.1f} ms ({restore}); T3 equal over {len(t3)} tokens; "
            f"deploy -f {out['deploy_file_s']:.2f} s; CLI {out['cli_overhead_ms']}; launches {out['launches']}; {card}")
        return out
    finally:
        d.close()
        shutil.rmtree(data, ignore_errors=True)
        shutil.rmtree(model_dir, ignore_errors=True)


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

    # a hang prints every thread's stack before the caller's time limit
    faulthandler.dump_traceback_later(HANG_DUMP_S, exit=True)
    t_start = time.monotonic()
    phase_s: dict[str, float] = {}

    def run(name: str, fn, *args, **kw):
        """One phase, its seconds kept in ``report["phase_s"]``."""
        t0 = time.monotonic()
        try:
            return fn(*args, **kw)
        finally:
            phase_s[name] = round(time.monotonic() - t0, 1)
            log(f"phase {name}: {phase_s[name]} s")

    card = run("build", phase_build)
    report_tokenizer = run("tokenizer", phase_tokenizer, card)
    kernels = run("kernels", phase_kernels)
    w8_row = run("w8a16", phase_w8a16)
    grouped_row = run("grouped", phase_grouped)
    report = {"tokenizer": report_tokenizer, "serve": run("serve", phase_serve), "phase_s": phase_s}
    dense_texts = report["serve"].pop("texts")
    report["serve_paged"] = run("serve_paged", phase_serve_paged, dense_texts)
    report["fused"] = run("fused", phase_fused_dense, dense_texts, report["serve"])
    n_layers = 32  # llama3-8b at full depth in the bf16 feature phases
    report["features"] = run("features", phase_serve_features, False, n_layers, None, contracts=True)
    report["features_paged"] = run("features_paged", phase_serve_features, True, n_layers,
                                   report["features"].pop("texts"), contracts=True)
    paged_texts = report["features_paged"].pop("texts")
    report["fused_paged"] = run("fused_paged", phase_serve_features, True, n_layers, paged_texts, fused=True)
    report["fused_paged"].pop("texts")
    report["tiering_paged"] = run("tiering_paged", phase_tiering_paged, card)
    report["tiering_dense"] = run("tiering_dense", phase_tiering_dense, card)
    # the int8 feature phases are off this slice's path: CUT_LAYERS deep
    report["int8"] = run("int8", phase_serve_features, False, CUT_LAYERS, None, quant=True)
    report["int8_paged"] = run("int8_paged", phase_serve_features, True, CUT_LAYERS,
                               report["int8"].pop("texts"), quant=True)
    report["int8_paged"].pop("texts")
    root = tempfile.mkdtemp(prefix="atpu-hf-llama3-8b-")
    try:
        report["checkpoint_write"] = run("checkpoint_write", phase_write_checkpoint, root)
        report["checkpoint"] = run("checkpoint", phase_checkpoint, root, dense_texts, card)
        report["checkpoint_int8"] = run("checkpoint_int8", phase_checkpoint_int8, root, card)
        report["resume"] = run("resume", phase_resume, root, card)
        # the control plane: the daemon spawns its own engine host on the card
        report["daemon"] = run("daemon", phase_daemon, card)
        # the replica fleet: two engine hosts, one killed mid-stream
        report["fleet"] = run("fleet", phase_fleet, card)
        # the daemon's default deployment: native store + AOF, the C++ front door
        report["native"] = run("native", phase_native, card, report["daemon"])
        # the operator's tooling through the CLI: phase 6's checkpoint
        # deployed, backed up, exported and restored
        report["operator"] = run("operator", phase_operator, root, report["checkpoint"]["bpe_turn"], card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for row in kernels:
        paged = "paged" in row["name"]
        # the main path is the reference's default: the feature phases
        row["launches"] = report["features_paged" if paged else "features"]["launches"][row["name"]]
        row["launches_features_off"] = report["serve_paged" if paged else "serve"]["launches"][row["name"]]
        # the daemon's engine host (the respawned one, after the replay)
        row["launches_daemon"] = report["daemon"]["launches"][row["name"]]
        # the fleet's two engine hosts (the killed one's calls before the
        # kill, the survivor's, the respawned one's)
        row["launches_fleet"] = report["fleet"]["launches"][row["name"]]
        # the native deployment's host after the daemon's restart
        row["launches_native"] = report["native"]["launches"][row["name"]]
        # the artifact agent's host and the restored agent's host
        row["launches_operator"] = report["operator"]["launches"][row["name"]]
        # the fused path: the fused dense phase (features off) and the fused
        # paged feature phase (in-loop spec)
        row["launches_fused"] = (
            report["fused_paged"]["launches"][row["name"]] if paged
            else report["fused"]["launches"].get(row["name"])
        )
    # the int8 kernel's main path: the int8 feature phases (dense; paged beside)
    w8_row["launches"] = report["int8"]["launches"]["w8a16_matmul"]
    w8_row["launches_paged"] = report["int8_paged"]["launches"]["w8a16_matmul"]
    kernels.append(w8_row)
    report["model"] = run("model", phase_model)
    report["model_int8"] = run("model_int8", phase_model_int8)
    report["fused_int8_graphs"] = run("fused_int8_graphs", phase_fused_int8_graphs)
    # Mixture-of-Experts: Mixtral-8x7B, each engine after the last is gone;
    # the served phases are off this slice's path: CUT_LAYERS deep
    report["moe_block"] = run("moe_block", phase_moe_block)
    report["moe_model"] = run("moe_model", phase_moe_model)
    report["moe"] = run("moe", phase_serve_features, False, CUT_LAYERS, None, quant=True, moe={})
    report["moe_paged"] = run("moe_paged", phase_serve_features, True, CUT_LAYERS, report["moe"].pop("texts"),
                              quant=True, moe=MOE_ROUTED)
    report["moe_paged"].pop("texts")
    report["moe_fused_graphs"] = run("moe_fused_graphs", phase_fused_int8_graphs, MIXTRAL)
    # the grouped kernel's main path: the Mixtral dense-einsum phase (the
    # routed paged one beside)
    grouped_row["launches"] = report["moe"]["launches"]["w8a16_grouped_matmul"]
    grouped_row["launches_paged"] = report["moe_paged"]["launches"]["w8a16_grouped_matmul"]
    kernels.append(grouped_row)
    # training, after every engine is gone: the prefill kernel's train path
    prefill_row = next(row for row in kernels if row["name"] == "flash_prefill")
    prefill_row["train"] = run("train_attention", phase_train_attention)
    report["train_paths"] = run("train_paths", phase_train_paths)
    report["train"] = run("train", phase_train, card)
    report["train_moe"] = run("train_moe", phase_train_moe, card)
    prefill_row["launches_train"] = report["train"]["launches"]["flash_prefill"]
    prefill_row["train"]["replaces"] = TRAIN_REPLACES
    report["elapsed_s"] = time.monotonic() - t_start
    log(f"all phases passed in {report['elapsed_s']:.0f}s")
    print(json.dumps({"pipeline": {
        phase: report[phase]["pipeline"]
        for phase in ("serve", "serve_paged", "fused", "features", "features_paged", "fused_paged", "int8",
                      "int8_paged", "checkpoint", "moe", "moe_paged")
    }}))
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
