"""AST-rule framework with a baseline ratchet.

Reference: ``agentainer_tpu/analysis/framework.py`` — an own copy, run over
``agentainer_tpu_torch/`` with the port's own ``baseline.json``. The
fingerprint formula is the reference's, so the same (rule, path, snippet,
occurrence) has the same fingerprint in both packages.

A :class:`Rule` inspects parsed source and yields :class:`Violation`\\ s.
Violations are identified by a *fingerprint* — a hash of (rule id, file,
stripped source line, occurrence index) — so they survive unrelated line
drift. The checked-in ``analysis/baseline.json`` freezes pre-existing
violations with per-site justification strings: a fingerprint in the
baseline is reported but never fails the run; a fingerprint NOT in the
baseline fails it. Fixing a baselined violation leaves a *stale* baseline
entry, reported so the ratchet only ever tightens (``--prune`` drops
stale entries; ``--update-baseline`` re-freezes, preserving existing
justifications).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

REPO_ROOT = Path(__file__).resolve().parents[2]
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"
DEFAULT_ROOTS = ("agentainer_tpu_torch",)
# build outputs and bytecode caches under a scanned root are not sources
_SKIP_DIRS = frozenset({"__pycache__", "_build"})
PENDING_JUSTIFICATION = "pre-existing; frozen by the ratchet pending audit"


class AnalysisError(Exception):
    """Analyzer misconfiguration (bad baseline file, unreadable source)."""


@dataclass
class Violation:
    rule_id: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    snippet: str = ""
    fingerprint: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule_id} {self.message}"


@dataclass
class ModuleSource:
    """One parsed source file handed to every rule."""

    path: str  # repo-relative
    text: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class Rule:
    """Base rule. Subclasses set ``rule_id``/``title`` and override one of
    :meth:`check_module` (runs per file) or :meth:`check_project` (runs
    once over the whole file set, for cross-file invariants)."""

    rule_id = "ATP000"
    title = ""
    scope = "file"  # or "project"

    def check_module(self, mod: ModuleSource) -> Iterable[Violation]:
        return ()

    def check_project(self, mods: list[ModuleSource]) -> Iterable[Violation]:
        return ()

    # -- shared helpers ---------------------------------------------------
    def violation(self, mod: ModuleSource | None, path: str, line: int, message: str) -> Violation:
        snip = mod.snippet(line) if mod is not None else ""
        return Violation(self.rule_id, path, line, message, snippet=snip)


def _fingerprint(rule_id: str, path: str, snippet: str, occurrence: int) -> str:
    basis = f"{rule_id}\x00{path}\x00{snippet}\x00{occurrence}"
    return hashlib.sha1(basis.encode("utf-8", "replace")).hexdigest()[:16]


def assign_fingerprints(violations: list[Violation]) -> None:
    """Stable IDs: identical (rule, path, snippet) triples are numbered in
    file order so two textually-identical sites don't collide."""
    seen: dict[tuple[str, str, str], int] = {}
    for v in sorted(violations, key=lambda v: (v.path, v.line, v.rule_id)):
        key = (v.rule_id, v.path, v.snippet)
        n = seen.get(key, 0)
        seen[key] = n + 1
        v.fingerprint = _fingerprint(v.rule_id, v.path, v.snippet, n)


@dataclass
class Baseline:
    entries: dict[str, dict]  # fingerprint -> {rule, path, line, snippet, justification}

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self.entries

    def justification(self, fingerprint: str) -> str:
        return self.entries.get(fingerprint, {}).get("justification", "")


def load_baseline(path: Path | str = BASELINE_PATH) -> Baseline:
    p = Path(path)
    if not p.exists():
        return Baseline(entries={})
    try:
        doc = json.loads(p.read_text())
    except (OSError, ValueError) as e:
        raise AnalysisError(f"unreadable baseline {p}: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), dict):
        raise AnalysisError(f"baseline {p} must be {{'entries': {{fingerprint: ...}}}}")
    return Baseline(entries=doc["entries"])


def save_baseline(
    violations: list[Violation],
    previous: Baseline,
    path: Path | str = BASELINE_PATH,
) -> Baseline:
    """Freeze the CURRENT violation set, carrying forward any justification
    already written for a surviving fingerprint."""
    entries: dict[str, dict] = {}
    for v in sorted(violations, key=lambda v: (v.path, v.line, v.rule_id)):
        entries[v.fingerprint] = {
            "rule": v.rule_id,
            "path": v.path,
            "line": v.line,
            "snippet": v.snippet,
            "justification": previous.justification(v.fingerprint) or PENDING_JUSTIFICATION,
        }
    doc = {"version": 1, "entries": entries}
    Path(path).write_text(json.dumps(doc, indent=2, sort_keys=False) + "\n")
    return Baseline(entries=entries)


def collect_sources(
    roots: Iterable[str] = DEFAULT_ROOTS, repo_root: Path | str = REPO_ROOT
) -> list[ModuleSource]:
    repo = Path(repo_root)
    mods: list[ModuleSource] = []
    for root in roots:
        base = repo / root
        paths = sorted(base.rglob("*.py")) if base.is_dir() else [base]
        for p in paths:
            if _SKIP_DIRS.intersection(p.relative_to(repo).parts[:-1]):
                continue
            rel = p.relative_to(repo).as_posix()
            try:
                text = p.read_text()
                tree = ast.parse(text, filename=rel)
            except (OSError, SyntaxError) as e:
                raise AnalysisError(f"cannot parse {rel}: {e}") from e
            mods.append(ModuleSource(path=rel, text=text, tree=tree, lines=text.splitlines()))
    return mods


@dataclass
class Report:
    new: list[Violation]
    baselined: list[Violation]
    stale: list[dict]  # baseline entries whose violation no longer exists

    @property
    def ok(self) -> bool:
        return not self.new

    def format(self, verbose: bool = False) -> str:
        out: list[str] = []
        for v in self.new:
            out.append(f"NEW  {v.format()}  [{v.fingerprint}]")
            if v.snippet:
                out.append(f"         {v.snippet}")
        if verbose:
            for v in self.baselined:
                out.append(f"base {v.format()}")
        for e in self.stale:
            out.append(
                f"stale baseline entry {e.get('rule')} {e.get('path')}:{e.get('line')}"
                " — violation fixed; prune it (python -m agentainer_tpu_torch.analysis --prune)"
            )
        out.append(
            f"analysis: {len(self.new)} new, {len(self.baselined)} baselined, "
            f"{len(self.stale)} stale baseline entries"
        )
        return "\n".join(out)


def run_rules(
    rules: Iterable[Rule],
    roots: Iterable[str] = DEFAULT_ROOTS,
    repo_root: Path | str = REPO_ROOT,
    baseline: Baseline | None = None,
) -> tuple[list[Violation], Report]:
    """Run every rule over the file set; classify against the baseline."""
    mods = collect_sources(roots, repo_root)
    violations: list[Violation] = []
    for rule in rules:
        # project rules may need non-Python project files (docs tables);
        # hand them the root the sources came from so fixture repos work
        rule.repo_root = Path(repo_root)
        if rule.scope == "project":
            violations.extend(rule.check_project(mods))
        else:
            for mod in mods:
                violations.extend(rule.check_module(mod))
    assign_fingerprints(violations)
    base = baseline if baseline is not None else load_baseline()
    new = [v for v in violations if v.fingerprint not in base]
    old = [v for v in violations if v.fingerprint in base]
    live = {v.fingerprint for v in violations}
    stale = [e for fp, e in base.entries.items() if fp not in live]
    return violations, Report(new=new, baselined=old, stale=stale)


def prune_baseline(
    violations: list[Violation], baseline: Baseline, path: Path | str = BASELINE_PATH
) -> int:
    """Drop baseline entries whose violation no longer fires (the ratchet
    tightening); returns how many were removed."""
    live = {v.fingerprint for v in violations}
    stale = [fp for fp in baseline.entries if fp not in live]
    for fp in stale:
        del baseline.entries[fp]
    doc = {"version": 1, "entries": baseline.entries}
    Path(path).write_text(json.dumps(doc, indent=2, sort_keys=False) + "\n")
    return len(stale)
