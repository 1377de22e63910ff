"""Repo-specific invariant rules (ATP001..ATP006), in the port's terms.

Reference: ``agentainer_tpu/analysis/rules.py`` (catalog and war stories
in ``docs/ANALYSIS.md``). Each rule keeps its ID, title and message wording
so a violation reads the same in both packages; what changes is what the
rules look for on this side:

- ATP002's host syncs are torch's (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``torch.cuda.synchronize``, an event's or stream's
  ``.synchronize()``), plus ``time.sleep`` and ``np.asarray``/``np.array``,
  and its hot paths are ``agentainer_tpu_torch/engine/llm.py``'s worker.
- ATP003 counts the engine's device waits (``synchronize``, a ``.cpu()``
  copy) as blocking, and guards ``_tier_lock`` too.
- ATP005 is a capture discipline: the port dispatches steps as CUDA graphs
  captured at warmup by ``engine/graphs.py``'s builders, where the
  reference jits warmed compile keys.
- ATP004 reads the port's ``faults.CATALOG`` and fire sites against the
  reference's ``docs/RESILIENCE.md`` table (the catalog is the
  reference's, name for name); ATP006 reads the port's engine, CLI, serve
  shim and config.

Rules are *syntactic*: they see direct calls and literal names, not
interprocedural data flow — the baseline ratchet absorbs the judgment
calls.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from .framework import ModuleSource, Rule, Violation

# ---------------------------------------------------------------------------
# shared AST helpers


def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``jax.block_until_ready`` → that
    string; ``x.item`` → ``x.item``; bare names → the name."""
    parts: list[str] = []
    cur: ast.AST = node.func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call):
        parts.append("()")
    return ".".join(reversed(parts))


def _walk_shallow(body: list[ast.stmt]) -> Iterable[ast.AST]:
    """Walk statements without descending into nested function/class
    definitions (a closure defined under a lock does not RUN under it)."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _functions(tree: ast.AST) -> Iterable[ast.FunctionDef | ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ---------------------------------------------------------------------------
# ATP001 — exception discipline


_BLANKET = {"Exception", "BaseException"}
# a handler that does any of these is *observing* the error, not eating it
_OBSERVE_CALL = re.compile(
    r"(^|\.)_?(print|log\w*|warn\w*|error|exception|debug|info|critical|"
    r"fire|record\w*|note\w*|count\w*|incr\w*|add_note|append|put\w*|"
    # breaker.fail() / _fail_item(...) are failure accounting/propagation
    r"format_exc|print_exc|fail\w*)$"
)
_OBSERVE_TARGET = re.compile(r"(_total|_errors?|_count|_skipped|_deferred|_failures?|last_\w*error)\b")


def _handler_observes(handler: ast.ExceptHandler) -> bool:
    for node in _walk_shallow(handler.body):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
            # `return self._fallback(...)` — delegating is handling
            return True
        if isinstance(node, ast.Call) and _OBSERVE_CALL.search(_call_name(node)):
            return True
        if isinstance(node, ast.AugAssign):
            tgt = ast.unparse(node.target)
            if _OBSERVE_TARGET.search(tgt):
                return True
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if _OBSERVE_TARGET.search(ast.unparse(tgt)):
                    return True
    return False


def _is_blanket(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names: list[str] = []
    for node in [t] if not isinstance(t, ast.Tuple) else list(t.elts):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    return any(n in _BLANKET for n in names)


class ExceptDiscipline(Rule):
    """ATP001: no bare/blanket except that swallows non-transport errors.

    A ``except:`` / ``except Exception`` / ``except BaseException`` handler
    must re-raise, return a handling call, log/print the error, or count it
    into a metrics counter. Silent swallowing turns every future bug class
    into a heisenbug — PR 5's store-outage work started by narrowing two of
    these that were masking transport bugs.
    """

    rule_id = "ATP001"
    title = "no silent blanket except"

    def check_module(self, mod: ModuleSource) -> Iterable[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_blanket(node):
                continue
            if _handler_observes(node):
                continue
            what = "bare except:" if node.type is None else f"except {ast.unparse(node.type)}"
            yield self.violation(
                mod,
                mod.path,
                node.lineno,
                f"{what} swallows the error silently — re-raise, log, or "
                "count it (or baseline with a justification)",
            )


# ---------------------------------------------------------------------------
# ATP002 — no host sync in decode/worker hot paths


# Functions forming the engine worker loop's steady state: one extra host
# sync here is an ITL regression on EVERY decoded token. Extend by naming
# the function here or tagging its def line with `# atp: hot`. The
# reference's names (the port has no `_try_admit_paged_locked`: its paged
# admission runs under `_page_lock` inside `_try_admit_paged`), plus the
# port's worker body `_serve` (the reference's `_loop` body; the port's
# `_loop` only wraps it), the readback drain's wait (`_process_oldest`,
# where the reference waits inline in `_process_first`/`_process_chunk`)
# and its admitting wait (`_wait_admitting`), and the fused loop's segment
# drivers, whose eager runs are the CPU's loop and whose captures are the
# card's.
HOT_PATHS: dict[str, re.Pattern] = {
    "agentainer_tpu_torch/engine/llm.py": re.compile(
        r"^(_loop|_serve|_pump_queue|_admit_waiting|_has_dispatchable|_prefill_tick"
        r"|_decode_dispatch|_pick_chunk|_try_speculate|_spec_round|_spec_gamma"
        r"|_spec_draft|_drain_readbacks|_process_oldest|_wait_admitting"
        r"|_process_first|_process_chunk|_finish"
        r"|_fused_dispatch|_process_fused|_fused_steps|_fused_prologue|_fused_pre"
        r"|_fused_plain|_fused_verify|_fused_post|_fused_tail"
        r"|_try_admit|_try_admit_paged|_bucket)$"
    ),
}

_HOT_MARK = re.compile(r"#\s*atp:\s*hot\b")

_HOST_SYNC = re.compile(
    r"(^|\.)(item|tolist|cpu|numpy|synchronize|sleep)$|^(np|numpy)\.(asarray|array)$"
)


def _is_hot(mod: ModuleSource, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    pat = HOT_PATHS.get(mod.path)
    if pat is not None and pat.match(fn.name):
        return True
    def_line = mod.snippet(fn.lineno)
    return bool(_HOT_MARK.search(def_line))


class HotPathHostSync(Rule):
    """ATP002: no host synchronization inside decode/worker hot paths.

    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` on
    device tensors, ``torch.cuda.synchronize``, an event's or a stream's
    ``.synchronize()`` and ``time.sleep`` all stall the dispatch
    pipeline (PAPERS.md *Kernel Looping*: the sync boundary is the enemy).
    The worker's DESIGNATED sync points (readback drain, admission
    backoff) are frozen in the baseline with justifications; anything new
    must argue its case the same way.
    """

    rule_id = "ATP002"
    title = "no host sync on the hot path"

    def check_module(self, mod: ModuleSource) -> Iterable[Violation]:
        if mod.path not in HOT_PATHS and "# atp: hot" not in mod.text:
            return
        for fn in _functions(mod.tree):
            if not _is_hot(mod, fn):
                continue
            for node in _walk_shallow(fn.body):
                if isinstance(node, ast.Call) and _HOST_SYNC.search(_call_name(node)):
                    yield self.violation(
                        mod,
                        mod.path,
                        node.lineno,
                        f"host sync `{_call_name(node)}` inside hot-path "
                        f"function `{fn.name}` — move it to a designated "
                        "sync point or baseline with a justification",
                    )


# ---------------------------------------------------------------------------
# ATP003 — nothing blocking while holding engine locks


# `_tier_lock` is shared with API threads as `_page_lock` is: `has_session`
# (the serve layer), `/metrics` and `clear_sessions` take it
_LOCK_EXPR = re.compile(r"(_page_lock|_slot_lock|_engine_lock|_cas_lock|_tier_lock)\b")
_BLOCKING = re.compile(
    r"(^|\.)(sleep|block_until_ready|result|join|acquire|roundtrip|_post|dispatch"
    r"|synchronize|cpu)$"
    r"|(^|\.)store\.(get|set|cas|delete|rpush|lrange|keys)$"
)
# under the store's CAS bracket specifically, plain self.get/self.set ARE
# the blocking ops (native-lib IO, armable store.get/store.set failpoints)
_CAS_IO = re.compile(r"(^|\.)(get|set)$")


class LockHoldDiscipline(Rule):
    """ATP003: no store RPC, engine dispatch, or blocking wait while
    holding ``_page_lock``-class locks.

    The page allocator's lock is shared with API threads (stats,
    clear_sessions); a device wait under it (``synchronize``, an event's
    ``.synchronize()``, a ``.cpu()`` copy) stalls every one of them — the
    tier demotion waits for its staging copy OUTSIDE the lock for exactly
    this reason (engine/llm.py ``_tier_demote``).
    Syntactic scope: direct calls inside a ``with <lock>:`` block;
    helper-call indirection is the baseline's problem.
    """

    rule_id = "ATP003"
    title = "no blocking work under engine locks"

    def check_module(self, mod: ModuleSource) -> Iterable[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_texts = [ast.unparse(item.context_expr) for item in node.items]
            held = any(_LOCK_EXPR.search(t) for t in lock_texts)
            if not held:
                continue
            cas_held = any("_cas_lock" in t for t in lock_texts)
            for inner in _walk_shallow(node.body):
                if isinstance(inner, ast.Await):
                    yield self.violation(
                        mod, mod.path, inner.lineno,
                        "await while holding an engine lock",
                    )
                elif isinstance(inner, ast.Call):
                    name = _call_name(inner)
                    if _BLOCKING.search(name) or (cas_held and _CAS_IO.search(name)):
                        yield self.violation(
                            mod,
                            mod.path,
                            inner.lineno,
                            f"blocking call `{name}` while holding "
                            "an engine lock — hoist it outside the with block",
                        )


# ---------------------------------------------------------------------------
# ATP004 — failpoint catalog parity


_FIRE_CALL = re.compile(r"(^|\.)fire(_async)?$")
_CATALOG_NAME = re.compile(r"`([a-z_][a-z0-9_]*\.[a-z_][a-z0-9_]*)`")


class FailpointParity(Rule):
    """ATP004: every layer seam keeps its registered failpoint, and code,
    registry (``faults.CATALOG``) and docs (RESILIENCE.md) agree.

    The chaos soak (PR 5) is only as deterministic as the failpoint set is
    complete: a seam that loses its ``faults.fire`` cut silently drops out
    of every fault schedule. Three-way parity: the literal names at
    ``fire()``/``fire_async()`` call sites == ``faults.CATALOG`` == the
    RESILIENCE.md catalog table, and every seam category (store, journal,
    replay, proxy, health, engine, watcher, store_client) keeps >= 1
    failpoint.
    """

    rule_id = "ATP004"
    title = "failpoint catalog parity"
    scope = "project"

    SEAM_CATEGORIES = (
        "store", "store_client", "journal", "replay",
        "proxy", "health", "engine", "watcher",
    )

    def check_project(self, mods: list[ModuleSource]) -> Iterable[Violation]:
        from pathlib import Path

        from .framework import REPO_ROOT

        repo_root = Path(getattr(self, "repo_root", REPO_ROOT))
        fired: dict[str, tuple[ModuleSource, int]] = {}
        faults_mod: ModuleSource | None = None
        for mod in mods:
            if mod.path.endswith("faults.py"):
                faults_mod = mod
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.Call)
                    and _FIRE_CALL.search(_call_name(node))
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and "faults" in ast.unparse(node.func)
                ):
                    fired.setdefault(node.args[0].value, (mod, node.lineno))

        # the in-code registry: faults.CATALOG
        catalog: set[str] = set()
        if faults_mod is not None:
            for node in ast.walk(faults_mod.tree):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets = [node.target]
                else:
                    continue
                if any(isinstance(t, ast.Name) and t.id == "CATALOG" for t in targets):
                    for c in ast.walk(node.value):
                        if isinstance(c, ast.Constant) and isinstance(c.value, str):
                            catalog.add(c.value)
        anchor = faults_mod.path if faults_mod is not None else "agentainer_tpu_torch/faults.py"
        if not catalog:
            yield Violation(
                self.rule_id, anchor, 1,
                "faults.py has no CATALOG frozenset naming every failpoint",
            )
            return

        # the documented catalog: RESILIENCE.md table rows
        doc_path = repo_root / "docs" / "RESILIENCE.md"
        documented: set[str] = set()
        if doc_path.exists():
            in_catalog = False
            for line in doc_path.read_text().splitlines():
                if line.startswith("### Failpoint catalog"):
                    in_catalog = True
                elif line.startswith("#") and in_catalog:
                    break
                elif in_catalog and line.startswith("|"):
                    documented.update(_CATALOG_NAME.findall(line.split("|")[1]))

        for name in sorted(set(fired) - catalog):
            mod, line = fired[name]
            yield Violation(
                self.rule_id, mod.path, line,
                f"failpoint `{name}` fired here but missing from faults.CATALOG",
            )
        for name in sorted(catalog - set(fired)):
            yield Violation(
                self.rule_id, anchor, 1,
                f"faults.CATALOG names `{name}` but no fire()/fire_async() site exists",
            )
        for name in sorted(catalog - documented):
            yield Violation(
                self.rule_id, "docs/RESILIENCE.md", 1,
                f"failpoint `{name}` missing from the RESILIENCE.md catalog table",
            )
        for name in sorted(documented - catalog):
            yield Violation(
                self.rule_id, "docs/RESILIENCE.md", 1,
                f"RESILIENCE.md documents `{name}` but faults.CATALOG does not have it",
            )
        for cat in self.SEAM_CATEGORIES:
            if not any(n.split(".", 1)[0] == cat for n in catalog):
                yield Violation(
                    self.rule_id, anchor, 1,
                    f"seam category `{cat}` has no registered failpoint",
                )


# ---------------------------------------------------------------------------
# ATP005 — graph capture only in the warmed step-graph builders


# Where a capture may be built: `engine/graphs.py`'s builders, which capture
# the engine's warmed step keys once into one pool (`StepGraphs`) and
# assemble the fused loop from captured segments (`LoopGraph`).
CAPTURE_BUILDERS: dict[str, re.Pattern] = {
    "agentainer_tpu_torch/engine/graphs.py": re.compile(
        r"^(StepGraphs\.(__init__|capture|build_loop|_assemble|rebuild_loop)|LoopGraph\.\w+)$"
    ),
}

_CAPTURE_CALL = re.compile(
    r"^torch\.cuda\.(graph|CUDAGraph|graph_pool_handle|make_graphed_callables)$"
    r"|(^|\.)capture_begin$"
)


def _scoped_calls(tree: ast.AST) -> Iterable[tuple[str, ast.Call]]:
    """Every call with the dotted name of the function or class it is in
    (``Class.method``, ``function``, or ``""`` at module level)."""
    stack: list[tuple[ast.AST, str]] = [(tree, "")]
    while stack:
        node, scope = stack.pop()
        if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = f"{scope}.{node.name}" if scope else node.name
        elif isinstance(node, ast.Call):
            yield scope, node
        stack.extend((child, scope) for child in ast.iter_child_nodes(node))


class JitDispatchDiscipline(Rule):
    """ATP005: graph capture only in the builders that key and warm it.

    The engine's latency story rests on every serving-path step being a
    WARMED, keyed CUDA graph (decode ladder, verify buckets, prefill
    buckets, the fused loop's segments), captured once at warmup by
    ``engine/graphs.py``'s builders into one memory pool and replayed. A
    ``torch.cuda.graph``/``CUDAGraph``/``capture_begin``/
    ``graph_pool_handle`` anywhere else captures outside that key space and
    pool, and one inside a loop body captures afresh per iteration —
    exactly the regression the capture-budget contract guards at runtime;
    this rule catches it at review time. ``torch.compile`` and
    ``torch.jit`` are flagged anywhere: the port has no compiled path.
    """

    rule_id = "ATP005"
    title = "jit via warmed ladders only"

    def check_module(self, mod: ModuleSource) -> Iterable[Violation]:
        builders = CAPTURE_BUILDERS.get(mod.path)
        loop_spans = [
            (node.lineno, getattr(node, "end_lineno", node.lineno))
            for node in ast.walk(mod.tree)
            if isinstance(node, (ast.For, ast.While, ast.AsyncFor))
        ]
        for scope, node in sorted(_scoped_calls(mod.tree), key=lambda sc: sc[1].lineno):
            name = _call_name(node)
            if name == "torch.compile" or name.startswith("torch.jit."):
                yield self.violation(
                    mod, mod.path, node.lineno,
                    f"`{name}` builds a compiled path the port does not have "
                    "— capture the step through engine/graphs.py's StepGraphs",
                )
            elif _CAPTURE_CALL.search(name):
                if builders is not None and builders.match(scope):
                    continue
                if any(lo < node.lineno <= hi for lo, hi in loop_spans):
                    yield self.violation(
                        mod, mod.path, node.lineno,
                        f"`{name}` inside a loop body builds a fresh "
                        "capture per iteration — hoist and key it",
                    )
                else:
                    yield self.violation(
                        mod, mod.path, node.lineno,
                        f"`{name}` outside engine/graphs.py's builders captures "
                        "outside the warmed step keys — capture through StepGraphs",
                    )


# ---------------------------------------------------------------------------
# ATP006 — feature-flag quad parity


class FeatureFlagQuad(Rule):
    """ATP006: every engine feature option ships its full quad.

    A boolean engine option (an A/B-gated serving feature) must be
    reachable all four ways, following the ``paged_kv``/``speculative``
    pattern: (1) ``LLMEngine.__init__`` kwarg plumbed via
    ``options.get(...)`` in ``create``, (2) a ``deploy`` CLI flag,
    (3) the deployment-YAML ``options`` channel (same key as 1), and
    (4) a fleet-default ``ATPU_*`` env read by both ``config.py``
    (features) and the serving shim. Half-plumbed flags are how A/B
    baselines silently stop being deployable.
    """

    rule_id = "ATP006"
    title = "feature-flag quad parity"
    scope = "project"

    def check_project(self, mods: list[ModuleSource]) -> Iterable[Violation]:
        by_path = {m.path: m for m in mods}
        llm = by_path.get("agentainer_tpu_torch/engine/llm.py")
        cli = by_path.get("agentainer_tpu_torch/cli.py")
        serve = by_path.get("agentainer_tpu_torch/engine/llm_serve.py")
        config = by_path.get("agentainer_tpu_torch/config.py")
        if llm is None:
            return

        # discover: bool-defaulted LLMEngine.__init__ kwargs that are also
        # options.get-plumbed — the definition of "engine feature option"
        flags: list[str] = []
        for node in ast.walk(llm.tree):
            if not (isinstance(node, ast.ClassDef) and node.name == "LLMEngine"):
                continue
            for fn in node.body:
                if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and fn.name == "__init__"):
                    continue
                defaults = fn.args.defaults
                names = [a.arg for a in fn.args.args][-len(defaults):] if defaults else []
                pairs = list(zip(names, defaults)) + [
                    (a.arg, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
                ]
                for arg_name, default in pairs:
                    if isinstance(default, ast.Constant) and isinstance(default.value, bool):
                        flags.append(arg_name)
            break
        plumbed = set(re.findall(r"options\.get\(\s*[\"'](\w+)[\"']", llm.text))
        flags = [f for f in flags if f in plumbed]

        for flag in flags:
            kebab = flag.replace("_", "-")
            env = f"ATPU_{flag.upper()}"
            if cli is not None and f"--{kebab}" not in cli.text and f"--no-{kebab}" not in cli.text:
                yield Violation(
                    self.rule_id, cli.path, 1,
                    f"engine option `{flag}` has no deploy CLI flag "
                    f"(--{kebab} / --no-{kebab})",
                )
            if serve is not None and env not in serve.text:
                yield Violation(
                    self.rule_id, serve.path, 1,
                    f"engine option `{flag}` has no fleet-default env read "
                    f"({env} in _engine_options)",
                )
            if config is not None and env not in config.text:
                yield Violation(
                    self.rule_id, config.path, 1,
                    f"engine option `{flag}` has no config/env bind ({env})",
                )


ALL_RULES: tuple[Rule, ...] = (
    ExceptDiscipline(),
    HotPathHostSync(),
    LockHoldDiscipline(),
    FailpointParity(),
    JitDispatchDiscipline(),
    FeatureFlagQuad(),
)
