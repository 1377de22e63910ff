"""The port's analysis plane (``agentainer_tpu_torch/analysis``) against the
reference's (``agentainer_tpu/analysis``): every case of
``tests/test_analysis.py`` in the port's terms.

- ATP001, ATP003, ATP004, ATP006 and the framework (ratchet, fingerprints,
  ``collect_sources``, the CLI's exit codes) run one fixture repo through
  both packages' rules and assert equal violations (rule, path, line,
  message) and equal fingerprints. ATP006's rule reads fixed paths in each
  package, so its fixture holds the same files under both package names
  and the violations are compared with the package prefix mapped.
- ATP002 (torch's host syncs) and ATP005 (the capture discipline) check
  other calls than the reference's: each gets torch fixtures it must flag
  and ones it must not.
- The real port is clean under its checked-in baseline, the baseline has no
  stale entry and every entry is justified, and ATP004 and ATP006 hold
  with no baseline at all.
"""

import json
import textwrap
import threading

import pytest

from agentainer_tpu.analysis import __main__ as ref_main
from agentainer_tpu.analysis import framework as ref_fw
from agentainer_tpu.analysis import rules as ref_rules
from agentainer_tpu_torch.analysis import __main__ as port_main
from agentainer_tpu_torch.analysis import framework as port_fw
from agentainer_tpu_torch.analysis import rules as port_rules
from agentainer_tpu_torch.analysis.framework import (
    PENDING_JUSTIFICATION,
    Baseline,
    Violation,
    assign_fingerprints,
    collect_sources,
    load_baseline,
    prune_baseline,
    run_rules,
    save_baseline,
)
from agentainer_tpu_torch.analysis.rules import (
    ALL_RULES,
    ExceptDiscipline,
    FailpointParity,
    FeatureFlagQuad,
    HotPathHostSync,
    JitDispatchDiscipline,
)


def _repo(tmp_path, files: dict[str, str]):
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
    return tmp_path


def _run(rule, tmp_path, roots=("pkg",)):
    violations, _ = run_rules([rule], roots=roots, repo_root=tmp_path, baseline=Baseline(entries={}))
    return violations


def _rows(violations, strip: str = ""):
    return [
        (v.rule_id, v.path.replace(strip, "", 1) if strip else v.path, v.line, v.message, v.fingerprint)
        for v in violations
    ]


def _both(name: str, root, roots=("pkg",)):
    """Run rule class ``name`` of each package over the same fixture; the
    port's violations, after asserting they equal the reference's."""
    ref_v, _ = ref_fw.run_rules(
        [getattr(ref_rules, name)()], roots=roots, repo_root=root, baseline=ref_fw.Baseline(entries={})
    )
    port_v = _run(getattr(port_rules, name)(), root, roots)
    assert _rows(port_v) == _rows(ref_v)
    return port_v


# ---------------------------------------------------------------------------
# ATP001 (shared fixtures)


def test_atp001_flags_silent_blanket_except(tmp_path):
    root = _repo(tmp_path, {"pkg/m.py": """
        try:
            x = 1
        except Exception:
            pass
    """})
    v = _both("ExceptDiscipline", root)
    assert len(v) == 1 and v[0].rule_id == "ATP001"


def test_atp001_accepts_reraise_log_and_count(tmp_path):
    root = _repo(tmp_path, {"pkg/m.py": """
        class C:
            def f(self):
                try:
                    x = 1
                except Exception:
                    raise
                try:
                    x = 2
                except Exception as e:
                    print("boom", e)
                try:
                    x = 3
                except Exception:
                    self.errors_total += 1
                try:
                    x = 4
                except ValueError:
                    pass  # narrowed: not a blanket except
    """})
    assert _both("ExceptDiscipline", root) == []


# ---------------------------------------------------------------------------
# ATP002 (torch fixtures)


def test_atp002_flags_host_sync_in_hot_function(tmp_path):
    root = _repo(tmp_path, {"agentainer_tpu_torch/engine/llm.py": """
        import torch

        class LLMEngine:
            def _decode_dispatch(self):
                n = self.count.item()

            def _cold_helper(self):
                torch.cuda.synchronize()  # not a hot-path function: allowed
    """})
    v = _run(HotPathHostSync(), root, roots=("agentainer_tpu_torch",))
    assert len(v) == 1
    assert "self.count.item" in v[0].message and "_decode_dispatch" in v[0].message


@pytest.mark.parametrize(
    "call",
    [
        "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "torch.cuda.synchronize()",
        "self.event.synchronize()", "torch.cuda.current_stream().synchronize()",
        "time.sleep(0.5)", "np.asarray(x)", "np.array(x)",
    ],
)
def test_atp002_flags_each_torch_host_sync(tmp_path, call):
    root = _repo(tmp_path, {"agentainer_tpu_torch/engine/llm.py": f"""
        class LLMEngine:
            def _serve(self, x):
                {call}

            def _process_oldest(self, x):
                {call}
    """})
    v = _run(HotPathHostSync(), root, roots=("agentainer_tpu_torch",))
    assert [x.line for x in v] == [4, 7]


def test_atp002_leaves_device_side_and_polling_calls(tmp_path):
    root = _repo(tmp_path, {"agentainer_tpu_torch/engine/llm.py": """
        class LLMEngine:
            def _decode_dispatch(self, x):
                y = x.to(self.device, non_blocking=True)
                ready = self.event.query()
                self._xfer.download(y)
                return torch.argmax(y, dim=-1)
    """})
    assert _run(HotPathHostSync(), root, roots=("agentainer_tpu_torch",)) == []


def test_atp002_honors_atp_hot_marker(tmp_path):
    root = _repo(tmp_path, {"pkg/worker.py": """
        def tight_loop(xs):  # atp: hot
            return xs.cpu()

        def setup(xs):
            return xs.cpu()  # cold: allowed
    """})
    v = _run(HotPathHostSync(), root)
    assert len(v) == 1 and "tight_loop" in v[0].message


# ---------------------------------------------------------------------------
# ATP003 (shared fixtures, then the port's device waits)


def test_atp003_flags_blocking_call_under_page_lock(tmp_path):
    root = _repo(tmp_path, {"pkg/engine.py": """
        import time, jax

        class E:
            def bad(self):
                with self._page_lock:
                    jax.block_until_ready(self.cache)

            def also_bad(self):
                with self._page_lock:
                    time.sleep(1)

            def good(self):
                with self._page_lock:
                    self.free.extend(self.quarantine)
                jax.block_until_ready(self.cache)

            def closure_is_fine(self):
                with self._page_lock:
                    def later():
                        time.sleep(1)  # defined, not run, under the lock
                    self.cb = later
    """})
    v = _both("LockHoldDiscipline", root)
    assert len(v) == 2
    assert all(x.rule_id == "ATP003" for x in v)


def test_atp003_flags_await_under_lock(tmp_path):
    root = _repo(tmp_path, {"pkg/engine.py": """
        class E:
            async def bad(self):
                with self._page_lock:
                    await self.store.get("k")
    """})
    v = _both("LockHoldDiscipline", root)
    assert any("await" in x.message for x in v)


def test_atp003_flags_device_waits_under_page_and_tier_locks(tmp_path):
    root = _repo(tmp_path, {"pkg/engine.py": """
        import torch

        class E:
            def bad(self, event):
                with self._page_lock:
                    event.synchronize()

            def also_bad(self, k):
                with self._tier_lock:
                    host = k.cpu()
                    torch.cuda.synchronize()

            def good(self, event):
                with self._page_lock:
                    event, ids = self.quarantine.popleft()
                event.synchronize()
                with self._tier_lock:
                    self.free.extend(ids)
    """})
    v = _run(port_rules.LockHoldDiscipline(), root)
    assert sorted(x.line for x in v) == [7, 11, 12]
    assert all("blocking call" in x.message for x in v)


def test_quarantine_wait_runs_outside_the_page_lock():
    """The repair ATP003 found: the worker waits for a demotion's staging
    copy with ``_page_lock`` free, so an API thread (``clear_sessions``,
    ``/metrics``) is never held behind a device copy."""
    import collections

    from agentainer_tpu_torch.engine.llm import LLMEngine

    class Engine:
        _reap_quarantine = LLMEngine._reap_quarantine

    eng = Engine()
    eng._page_lock = threading.RLock()
    eng._page_free = []
    seen = []

    class Copy:
        def query(self):
            return False

        def synchronize(self):
            got = []

            def api_thread():
                got.append(eng._page_lock.acquire(blocking=False))
                if got[0]:
                    eng._page_lock.release()

            t = threading.Thread(target=api_thread)
            t.start()
            t.join(5)
            assert not t.is_alive()
            seen.append(got == [True])

    eng._page_quarantine = collections.deque([(Copy(), [3, 4]), (Copy(), [5])])
    eng._reap_quarantine(1)
    assert seen == [True] and eng._page_free == [3, 4]
    assert [ids for _, ids in eng._page_quarantine] == [[5]]
    eng._reap_quarantine(0)  # not landed, and the free list covers 0
    assert eng._page_free == [3, 4]


# ---------------------------------------------------------------------------
# ATP004 (shared fixture, then the real port)


def test_atp004_three_way_parity(tmp_path):
    root = _repo(tmp_path, {
        "pkg/faults.py": """
            CATALOG = frozenset({"store.get", "engine.prefill", "ghost.seam"})
        """,
        "pkg/store.py": """
            from . import faults
            def get(self):
                faults.fire("store.get")
            def rogue(self):
                faults.fire("store.unlisted")
        """,
        "docs/RESILIENCE.md": """
            ### Failpoint catalog

            | name | seam | armed effect |
            |------|------|--------------|
            | `store.get` | store | blip |
            | `engine.prefill` | engine | poisoned prefill |

            ### Arming
        """,
    })
    msgs = [v.message for v in _both("FailpointParity", root)]
    assert any("store.unlisted" in m and "missing from faults.CATALOG" in m for m in msgs)
    assert any("ghost.seam" in m and "no fire()" in m for m in msgs)
    assert any("engine.prefill" in m and "no fire()" in m for m in msgs)
    assert any("ghost.seam" in m and "RESILIENCE.md" in m for m in msgs)
    assert any("seam category" in m for m in msgs)


def test_atp004_real_repo_is_in_parity():
    violations, _ = run_rules([FailpointParity()], baseline=Baseline(entries={}))
    assert violations == [], [v.format() for v in violations]


# ---------------------------------------------------------------------------
# ATP005 (torch fixtures: the capture discipline)


def test_atp005_flags_compile_and_captures_outside_the_builders(tmp_path):
    root = _repo(tmp_path, {"agentainer_tpu_torch/engine/llm.py": """
        import torch

        def bad_compile(f):
            return torch.compile(f)

        def bad_script(f):
            return torch.jit.script(f)

        def bad_capture(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return g

        def bad_loop(fns):
            out = []
            for f in fns:
                g = torch.cuda.CUDAGraph()
                g.capture_begin()
                f()
                out.append(g)
            return out
    """})
    v = _run(JitDispatchDiscipline(), root, roots=("agentainer_tpu_torch",))
    got = [(x.line, x.message.split("`")[1]) for x in v]
    assert got == [
        (5, "torch.compile"), (8, "torch.jit.script"), (11, "torch.cuda.CUDAGraph"),
        (12, "torch.cuda.graph"), (19, "torch.cuda.CUDAGraph"), (20, "g.capture_begin"),
    ], got
    assert all("loop body" in x.message for x in v if x.line >= 19)
    assert all("outside engine/graphs.py's builders" in x.message for x in v if x.line in (11, 12))
    assert all("compiled path" in x.message for x in v if x.line < 10)


def test_atp005_accepts_captures_inside_the_graph_builders(tmp_path):
    root = _repo(tmp_path, {"agentainer_tpu_torch/engine/graphs.py": """
        import torch

        class StepGraphs:
            def __init__(self, device):
                self.pool = torch.cuda.graph_pool_handle()

            def capture(self, steps):
                for key, fn in steps.items():
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=self.pool):
                        fn()

            def replay(self, key):
                self._graphs[key].replay()
    """})
    assert _run(JitDispatchDiscipline(), root, roots=("agentainer_tpu_torch",)) == []
    # the same builder in another file is outside the builders
    (root / "agentainer_tpu_torch/engine/graphs.py").rename(root / "agentainer_tpu_torch/engine/other.py")
    v = _run(JitDispatchDiscipline(), root, roots=("agentainer_tpu_torch",))
    assert [x.line for x in v] == [6, 10, 11]


def test_atp005_real_port_captures_only_in_the_builders():
    violations, _ = run_rules([JitDispatchDiscipline()], baseline=Baseline(entries={}))
    assert violations == [], [v.format() for v in violations]


# ---------------------------------------------------------------------------
# ATP006 (one fixture under both package names, then the real port)


_HALF_PLUMBED = {
    "engine/llm.py": """
        class LLMEngine:
            def __init__(self, cfg, shiny_mode: bool = True):
                self.shiny_mode = shiny_mode

            @classmethod
            def create(cls, options):
                return cls(None, shiny_mode=bool(options.get("shiny_mode", True)))
    """,
    "cli.py": "pass\n",
    "engine/llm_serve.py": "pass\n",
    "config.py": "pass\n",
}


def test_atp006_flags_half_plumbed_flag(tmp_path):
    files = {f"{pkg}/{rel}": body for pkg in ("agentainer_tpu", "agentainer_tpu_torch")
             for rel, body in _HALF_PLUMBED.items()}
    root = _repo(tmp_path, files)
    ref_v, _ = ref_fw.run_rules(
        [ref_rules.FeatureFlagQuad()], roots=("agentainer_tpu",), repo_root=root,
        baseline=ref_fw.Baseline(entries={}),
    )
    port_v = _run(FeatureFlagQuad(), root, roots=("agentainer_tpu_torch",))
    rows = lambda vs, pkg: [r[:4] for r in _rows(vs, strip=pkg)]  # noqa: E731
    assert rows(port_v, "agentainer_tpu_torch/") == rows(ref_v, "agentainer_tpu/")
    # the fingerprint is the reference's formula over the port's path
    assert [v.fingerprint for v in port_v] == [
        ref_fw._fingerprint(v.rule_id, v.path, v.snippet, 0) for v in port_v
    ]
    msgs = [v.message for v in port_v]
    assert any("no deploy CLI flag" in m for m in msgs)
    assert any("ATPU_SHINY_MODE" in m and "fleet-default" in m for m in msgs)
    assert any("config/env bind" in m for m in msgs)


def test_atp006_finds_keyword_only_bool_options(tmp_path):
    root = _repo(tmp_path, {
        "agentainer_tpu_torch/engine/llm.py": """
            class LLMEngine:
                def __init__(self, cfg, *, shiny_mode: bool = False, width: int = 4):
                    pass

                @classmethod
                def create(cls, options):
                    return cls(None, shiny_mode=bool(options.get("shiny_mode", False)),
                               width=int(options.get("width", 4)))
        """,
        "agentainer_tpu_torch/cli.py": "FLAGS = ('--shiny-mode', '--no-shiny-mode')\n",
        "agentainer_tpu_torch/engine/llm_serve.py": "pass\n",
        "agentainer_tpu_torch/config.py": "ENV = 'ATPU_SHINY_MODE'\n",
    })
    v = _run(FeatureFlagQuad(), root, roots=("agentainer_tpu_torch",))
    assert [(x.path, x.message) for x in v] == [(
        "agentainer_tpu_torch/engine/llm_serve.py",
        "engine option `shiny_mode` has no fleet-default env read (ATPU_SHINY_MODE in _engine_options)",
    )]


def test_atp006_real_repo_quads_complete():
    violations, _ = run_rules([FeatureFlagQuad()], baseline=Baseline(entries={}))
    assert violations == [], [v.format() for v in violations]


def test_atp006_finds_every_plumbed_bool_option_of_the_port():
    """The rule's discovery sees each bool option of the port's
    ``LLMEngine.__init__`` that ``create`` reads through ``options.get``."""
    from agentainer_tpu_torch.engine.llm import LLMEngine
    import inspect
    import re

    src = inspect.getsource(LLMEngine.create)
    plumbed = set(re.findall(r"options\.get\(\s*[\"'](\w+)[\"']", src))
    want = sorted(
        n for n, p in inspect.signature(LLMEngine.__init__).parameters.items()
        if isinstance(p.default, bool) and n in plumbed
    )
    assert want == [
        "adaptive_decode", "approx_topk", "deadlines", "fused_decode", "inloop_spec",
        "kv_tiering", "paged_kv", "prefix_cache", "speculative", "streaming",
    ]
    # drop one flag's CLI pair from a copy of the real files: the rule names it
    mods = port_fw.collect_sources()
    for m in mods:
        if m.path == "agentainer_tpu_torch/cli.py":
            m.text = m.text.replace('"--kv-tiering", "--no-kv-tiering"', '"--kvt", "--no-kvt"')
    msgs = [v.message for v in FeatureFlagQuad().check_project(mods)]
    assert msgs == ["engine option `kv_tiering` has no deploy CLI flag (--kv-tiering / --no-kv-tiering)"]


# ---------------------------------------------------------------------------
# baseline ratchet and fingerprints (shared fixtures)


RATCHET_SRC = """
try:
    x = 1
except Exception:
    pass
"""

RATCHET_SRC_TWO = """
try:
    x = 1
except Exception:
    pass

try:
    y = 2
except BaseException:
    pass
"""


def test_ratchet_freezes_then_fails_new_then_prunes(tmp_path):
    root = _repo(tmp_path, {"pkg/m.py": RATCHET_SRC})
    bpath = tmp_path / "baseline.json"
    rule = ExceptDiscipline()

    violations, report = run_rules([rule], roots=("pkg",), repo_root=root, baseline=Baseline(entries={}))
    assert len(report.new) == 1
    baseline = save_baseline(violations, Baseline(entries={}), path=bpath)
    entry = next(iter(baseline.entries.values()))
    assert entry["justification"]
    # the reference freezes the same file byte for byte
    ref_path = tmp_path / "ref_baseline.json"
    ref_v, _ = ref_fw.run_rules(
        [ref_rules.ExceptDiscipline()], roots=("pkg",), repo_root=root, baseline=ref_fw.Baseline(entries={})
    )
    ref_fw.save_baseline(ref_v, ref_fw.Baseline(entries={}), path=ref_path)
    assert bpath.read_text() == ref_path.read_text()

    _, report = run_rules([rule], roots=("pkg",), repo_root=root, baseline=baseline)
    assert report.ok and len(report.baselined) == 1

    (root / "pkg" / "m.py").write_text(RATCHET_SRC_TWO)
    _, report = run_rules([rule], roots=("pkg",), repo_root=root, baseline=baseline)
    assert not report.ok
    assert len(report.new) == 1 and "BaseException" in report.new[0].snippet
    assert len(report.baselined) == 1

    (root / "pkg" / "m.py").write_text("x = 1\n")
    violations, report = run_rules([rule], roots=("pkg",), repo_root=root, baseline=baseline)
    assert report.ok and len(report.stale) == 1
    assert "agentainer_tpu_torch.analysis --prune" in report.format()
    dropped = prune_baseline(violations, baseline, path=bpath)
    assert dropped == 1
    assert json.loads(bpath.read_text())["entries"] == {}


def test_fingerprints_stable_across_line_drift(tmp_path):
    root = _repo(tmp_path, {"pkg/m.py": RATCHET_SRC})
    v1 = _both("ExceptDiscipline", root)
    (root / "pkg" / "m.py").write_text("# pad\n" * 40 + RATCHET_SRC)
    v2 = _both("ExceptDiscipline", root)
    assert v1[0].fingerprint == v2[0].fingerprint
    assert v1[0].line != v2[0].line


def test_identical_sites_get_distinct_fingerprints(tmp_path):
    root = _repo(tmp_path, {"pkg/m.py": RATCHET_SRC + RATCHET_SRC})
    v = _both("ExceptDiscipline", root)
    assert len(v) == 2
    assert v[0].fingerprint != v[1].fingerprint


def test_assign_fingerprints_orders_by_position():
    a = Violation("ATP001", "p.py", 10, "m", snippet="except Exception:")
    b = Violation("ATP001", "p.py", 50, "m", snippet="except Exception:")
    assign_fingerprints([b, a])
    fa, fb = a.fingerprint, b.fingerprint
    assign_fingerprints([a, b])
    assert (a.fingerprint, b.fingerprint) == (fa, fb)
    assert fa != fb
    ra = ref_fw.Violation("ATP001", "p.py", 10, "m", snippet="except Exception:")
    rb = ref_fw.Violation("ATP001", "p.py", 50, "m", snippet="except Exception:")
    ref_fw.assign_fingerprints([rb, ra])
    assert (ra.fingerprint, rb.fingerprint) == (fa, fb)


def test_collect_sources_skips_pycache_and_build_outputs(tmp_path):
    root = _repo(tmp_path, {
        "pkg/m.py": "x = 1\n",
        "pkg/__pycache__/m.py": "syntax error here (\n",
        "pkg/_build/gen.py": "syntax error here (\n",
    })
    mods = collect_sources(("pkg",), root)
    assert [m.path for m in mods] == ["pkg/m.py"]
    assert port_fw.DEFAULT_ROOTS == ("agentainer_tpu_torch",)
    assert port_fw.BASELINE_PATH.parent.name == "analysis"
    assert port_fw.BASELINE_PATH.parent.parent.name == "agentainer_tpu_torch"


def test_collect_sources_matches_the_reference_on_a_shared_tree(tmp_path):
    root = _repo(tmp_path, {
        "pkg/a.py": "x = 1\n",
        "pkg/sub/b.py": "y = 2\n",
        "pkg/__pycache__/m.py": "syntax error here (\n",
    })
    assert [m.path for m in collect_sources(("pkg",), root)] == [
        m.path for m in ref_fw.collect_sources(("pkg",), root)
    ] == ["pkg/a.py", "pkg/sub/b.py"]


# ---------------------------------------------------------------------------
# the CLI's exit codes, in both packages, on one fixture


@pytest.mark.parametrize(
    "src, argv, code",
    [
        ("x = 1\n", ["pkg", "--rule", "ATP001"], 0),
        (RATCHET_SRC, ["pkg", "--rule", "ATP001"], 1),
        (RATCHET_SRC, ["pkg", "--rule", "ATP001", "--verbose"], 1),
        (RATCHET_SRC, ["pkg", "--rule", "ATP003"], 0),
        (RATCHET_SRC, ["pkg", "--rule", "ATP999"], 2),
        (RATCHET_SRC, ["--update-baseline", "--rule", "ATP001"], 2),
        (RATCHET_SRC, ["pkg", "--prune"], 2),
    ],
)
def test_main_exit_codes_match_the_reference(tmp_path, monkeypatch, capsys, src, argv, code):
    import functools

    root = _repo(tmp_path, {"pkg/m.py": src})
    for mod, fw in ((port_main, port_fw), (ref_main, ref_fw)):
        monkeypatch.setattr(mod, "run_rules", functools.partial(fw.run_rules, repo_root=root))
        monkeypatch.setattr(mod, "load_baseline", lambda fw=fw: fw.Baseline(entries={}))
    assert port_main.main(argv) == code
    port_out = capsys.readouterr()
    assert ref_main.main(argv) == code
    ref_out = capsys.readouterr()
    assert port_out.out == ref_out.out


def test_main_exits_2_on_an_unreadable_baseline(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "baseline.json"
    bad.write_text("{not json")
    monkeypatch.setattr(port_main, "load_baseline", lambda: load_baseline(bad))
    assert port_main.main([]) == 2
    assert "unreadable baseline" in capsys.readouterr().err


def test_main_is_clean_on_the_real_port(capsys):
    assert port_main.main([]) == 0
    assert "0 new" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the real port: the checked-in baseline covers the current violation set


def test_repo_is_clean_under_checked_in_baseline():
    violations, report = run_rules(ALL_RULES, baseline=load_baseline())
    assert report.ok, "\n" + report.format()
    assert not report.stale, "\n" + report.format()


def test_every_baseline_entry_is_justified():
    base = load_baseline()
    assert base.entries
    pending = [
        f"{e['path']}:{e['line']}"
        for e in base.entries.values()
        if not e.get("justification") or e["justification"] == PENDING_JUSTIFICATION
    ]
    assert not pending, f"baseline entries without a real justification: {pending}"
    assert all(e["path"].startswith("agentainer_tpu_torch/") for e in base.entries.values())
