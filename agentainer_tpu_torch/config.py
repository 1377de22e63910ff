"""Layered daemon configuration.

Reference: ``agentainer_tpu/config.py`` — the same layers (a YAML file
searched in ``.``, ``~/.agentainer_tpu_torch``, ``/etc/agentainer_tpu_torch``;
``ATPU_*`` environment overrides; the reference's defaults: server on
:8081, static bearer token, request persistence on). What differs:

- the slice is the machine's GPUs, not a v5e: ``SliceConfig`` defaults to
  the count and per-card memory that ``nvidia-smi --query-gpu=index,
  memory.total`` reports (the daemon imports no torch, so it never creates
  a CUDA context). With no ``nvidia-smi`` the count is 0 unless
  ``ATPU_SLICE_CHIPS`` or the config file sets it; both still override;
- ``yaml`` is imported only when a config file is found (the machine with
  the card may lack it);
- ``store_url`` ``auto`` resolves in the daemon as the reference's does:
  ``native://<data_dir>/store.aof`` (the C++ store, append-only-file
  durability) when the native library builds, ``mem://`` otherwise; with
  the native store, ``features.native_dataplane`` (``ATPU_NATIVE_DATAPLANE``)
  puts the C++ front door on the public port.
"""

from __future__ import annotations

import functools
import os
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

# an H100's 80 GB (nvidia-smi's 81559 MiB), the per-card memory assumed
# when no nvidia-smi answers and the count comes from the environment
DEFAULT_GPU_MEMORY = 81559 * 1024**2


@functools.lru_cache(maxsize=1)
def detect_gpus() -> tuple[int, int, str]:
    """(count, memory per card in bytes, card name) from ``nvidia-smi``;
    (0, DEFAULT_GPU_MEMORY, "") when it is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,memory.total,name", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return 0, DEFAULT_GPU_MEMORY, ""
    rows = [r.split(",") for r in out.stdout.strip().splitlines() if r.strip()]
    if out.returncode != 0 or not rows:
        return 0, DEFAULT_GPU_MEMORY, ""
    try:
        mem = min(int(float(r[1])) for r in rows) * 1024**2
    except (IndexError, ValueError):
        mem = DEFAULT_GPU_MEMORY
    name = rows[0][2].strip() if len(rows[0]) > 2 else ""
    return len(rows), mem, name


def _slice_name(count: int, card: str = "") -> str:
    return f"{count}x {card}" if card else f"gpu-{count}"


DEFAULT_TOKEN = "agentainer-default-token"  # config.go:66 parity


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8081


@dataclass
class SliceConfig:
    """The GPUs the scheduler places agents on (one "chip" is one card):
    by default the machine's, from ``nvidia-smi``."""

    total_chips: int = field(default_factory=lambda: detect_gpus()[0])
    hbm_per_chip: int = field(default_factory=lambda: detect_gpus()[1])
    name: str = field(default_factory=lambda: _slice_name(detect_gpus()[0], detect_gpus()[2]))
    hosts: int = 1  # one host: every card of the machine


@dataclass
class FeatureFlags:
    request_persistence: bool = True  # config.go:70
    # Serve /agent/* + the engine store socket from the C++ data plane when
    # the store is native (falls back to the standard-library proxy).
    native_dataplane: bool = True
    # Default for engines' self-speculative decoding (prompt-lookup drafts
    # + batched verify). Per-deployment model options override; false here
    # pins the whole fleet to the plain decode path (the A/B baseline).
    speculative: bool = True
    # Default for engines' paged KV arena (block tables: pool-bounded
    # resident sessions, zero-copy prefix sharing, page-tail speculative
    # rewind). Off by default while the dense arena remains the
    # hardware-burned-in baseline; per-deployment model options override
    # (same plumbing pattern as ``speculative``).
    paged_kv: bool = False
    # Fleet defaults for the remaining engine A/B options, completing the
    # feature-flag quad (engine kwarg <-> deploy CLI flag <-> YAML options
    # <-> ATPU_* env — machine-checked by analysis rule ATP006):
    # admission-aware decode chunking and the cross-session prefix arena.
    adaptive_decode: bool = True
    prefix_cache: bool = True
    # Default for engines' fused on-device decode loop (multi-step
    # lax.while_loop with in-loop sampling, per-lane early exit, and one
    # readback per loop). Off by default while the per-chunk dispatch
    # remains the A/B baseline; per-deployment model options override.
    fused_decode: bool = False
    # Default for engines' in-loop device speculation: the fused loop's
    # n-gram drafter + batched verify branch, replacing the host-side
    # prompt-lookup round-trip while a lane stays loop-resident. On by
    # default — it only engages when the engine is fused+speculative and
    # unmeshed, and greedy lanes are bit-exact with the host drafter.
    inloop_spec: bool = True
    # Default for engines' segmented approx top-k sampler
    # (jax.lax.approx_max_k over a fixed-width segment instead of the
    # full-vocab sort). Off by default: the exact shared-sort sampler is
    # the baseline; approx is opt-in and NOT bit-exact for sampled lanes.
    approx_topk: bool = False
    # Default for the tiered KV hierarchy (device → pinned host RAM →
    # store): idle sessions park off-device and promote back at their
    # next turn, with pool-pressure demotion converting 429s into
    # slower-but-served admissions. Off by default — tiering is the
    # opt-in density lever; the resident-only arena is the A/B baseline.
    kv_tiering: bool = False
    # Proxy-side park linger: seconds an idle session must stay silent
    # after its response settles before the proxy parks it off-device.
    # Sized to agentic tool-call gaps — a tool round-trip inside the
    # linger cancels the park; anything longer pays one prewarm instead.
    tier_park_linger_s: float = 1.0
    # Default for SSE token streaming (stream=true on /chat): the proxy
    # forwards the engine's event stream with every offset journaled as a
    # streaming checkpoint, so a mid-stream crash fails over gaplessly.
    # Off by default — the buffered response path is the A/B baseline and
    # stays byte-identical while this is off.
    streaming: bool = False


@dataclass
class DeadlineConfig:
    """End-to-end request deadlines + overload shedding.

    ``enabled: false`` preserves the pre-deadline behavior everywhere
    (no default deadline, no shedding, no disconnect propagation) — the
    A/B baseline. Watermarks are depth thresholds at which the proxy
    answers ``429 + Retry-After`` instead of journaling more work that
    will expire unserved."""

    enabled: bool = True
    # default per-request budget when the caller sends no
    # X-Agentainer-Deadline-Ms header; 0 = no default deadline
    default_ms: float = 30000.0
    # per-agent pending-journal depth that starts shedding (0 = off)
    shed_pending_per_agent: int = 64
    # global pending ceiling across every agent (0 = off)
    shed_pending_global: int = 512
    # engine queue+waiting depth (from the latest metrics sample) that
    # starts shedding for that agent (0 = don't consult engine depth)
    engine_queue_watermark: int = 0
    # Retry-After seconds on shed responses
    retry_after_s: float = 1.0


@dataclass
class FleetConfig:
    """Replica fleet: N engine replicas per agent behind the routing tier.

    ``replicas: 1`` (the default) is the single-engine behavior exactly —
    one engine per agent, no routing tier, no lease monitor traffic. With
    N > 1 each replica is its own failure domain (own engine host process,
    own port, own crash-loop watcher); sessions are routed with KV-residency
    affinity, fresh sessions by power-of-two-choices on the engine-reported
    load, and a dead replica's sessions fail over to a survivor via the
    store-durable KV snapshot (token-identical resume). Per-deploy
    ``replicas`` in the agent body overrides the fleet default."""

    replicas: int = 1
    # replica heartbeat lease: the monitor probes each replica every
    # lease_interval_s and refreshes a store lease with lease_ttl_s; a
    # replica whose lease is older than suspect_after_s is SUSPECT
    # (excluded from routing), older than dead_after_s is DEAD (repaired)
    lease_ttl_s: float = 6.0
    lease_interval_s: float = 1.0
    suspect_after_s: float = 3.0
    dead_after_s: float = 6.0
    # bounded cross-replica retry for connection-level dispatch failures
    # (nothing executed on the dead replica, and the journal CAS admits
    # exactly one dispatcher, so the retry cannot double-execute)
    retry_next_replica: int = 2
    # per-replica circuit breaker (one bad replica must not open a breaker
    # for the whole agent)
    breaker_failures: int = 3
    breaker_cooldown_s: float = 2.0


@dataclass
class ResilienceConfig:
    """Crash-loop backoff, store-outage degradation, and fault injection.

    The backoff knobs govern the local backend's restart watcher: a
    crashed engine respawns immediately once, then with exponential delay
    (``restart_backoff_base_s`` doubling up to ``restart_backoff_max_s``);
    an incarnation that dies within ``restart_window_s`` of its spawn
    counts as a *rapid* death, and after ``restart_max_rapid`` of those in
    a row the agent lands FAILED with a recorded reason instead of
    hot-looping forever. The breaker knobs govern the proxy's store
    circuit breaker (503 + Retry-After instead of hanging on a dead
    store); the store_retry knobs govern the engine store client's bounded
    retry. ``faults`` is a failpoint arming spec (agentainer_tpu_torch/faults.py
    grammar) applied at daemon startup — empty (the default) means the
    fault plane is entirely disarmed and zero-overhead."""

    restart_backoff_base_s: float = 0.5
    restart_backoff_max_s: float = 30.0
    restart_window_s: float = 30.0
    restart_max_rapid: int = 5
    store_retries: int = 3
    store_retry_base_s: float = 0.05
    breaker_failures: int = 5
    breaker_cooldown_s: float = 2.0
    faults: str = ""


@dataclass
class Cadences:
    """Background-loop intervals, reference values (BASELINE.md)."""

    state_sync_s: float = 10.0  # main.go:325
    replay_scan_s: float = 5.0  # replay_worker.go:37
    metrics_interval_s: float = 10.0  # collector.go:205


@dataclass
class Config:
    server: ServerConfig = field(default_factory=ServerConfig)
    slice: SliceConfig = field(default_factory=SliceConfig)
    features: FeatureFlags = field(default_factory=FeatureFlags)
    cadences: Cadences = field(default_factory=Cadences)
    deadlines: DeadlineConfig = field(default_factory=DeadlineConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    auth_token: str = DEFAULT_TOKEN
    # "auto": native C++ store with AOF durability when the library builds,
    # in-memory store otherwise. Explicit: mem:// | native://[aof-path]
    store_url: str = "auto"
    data_dir: str = "~/.agentainer_tpu_torch"

    @property
    def data_path(self) -> Path:
        return Path(os.path.expanduser(self.data_dir))


_SEARCH_PATHS = [".", "~/.agentainer_tpu_torch", "/etc/agentainer_tpu_torch"]


def load_config(path: str | None = None) -> Config:
    cfg = Config()
    doc: dict = {}
    candidates = [path] if path else [os.path.join(os.path.expanduser(p), "config.yaml") for p in _SEARCH_PATHS]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            import yaml  # only with a config file: the card's machine may lack it

            with open(cand) as f:
                doc = yaml.safe_load(f) or {}
            break

    server = doc.get("server", {})
    cfg.server.host = server.get("host", cfg.server.host)
    cfg.server.port = int(server.get("port", cfg.server.port))
    sl = doc.get("slice", {})
    cfg.slice.total_chips = int(sl.get("total_chips", cfg.slice.total_chips))
    cfg.slice.hbm_per_chip = int(sl.get("hbm_per_chip", cfg.slice.hbm_per_chip))
    cfg.slice.name = sl.get("name", cfg.slice.name)
    cfg.slice.hosts = int(sl.get("hosts", cfg.slice.hosts))
    feats = doc.get("features", {})
    cfg.features.request_persistence = bool(
        feats.get("request_persistence", cfg.features.request_persistence)
    )
    dl = doc.get("deadlines", {})
    cfg.deadlines.enabled = bool(dl.get("enabled", cfg.deadlines.enabled))
    cfg.deadlines.default_ms = float(dl.get("default_ms", cfg.deadlines.default_ms))
    cfg.deadlines.shed_pending_per_agent = int(
        dl.get("shed_pending_per_agent", cfg.deadlines.shed_pending_per_agent)
    )
    cfg.deadlines.shed_pending_global = int(
        dl.get("shed_pending_global", cfg.deadlines.shed_pending_global)
    )
    cfg.deadlines.engine_queue_watermark = int(
        dl.get("engine_queue_watermark", cfg.deadlines.engine_queue_watermark)
    )
    cfg.deadlines.retry_after_s = float(
        dl.get("retry_after_s", cfg.deadlines.retry_after_s)
    )
    res = doc.get("resilience", {})
    cfg.resilience.restart_backoff_base_s = float(
        res.get("restart_backoff_base_s", cfg.resilience.restart_backoff_base_s)
    )
    cfg.resilience.restart_backoff_max_s = float(
        res.get("restart_backoff_max_s", cfg.resilience.restart_backoff_max_s)
    )
    cfg.resilience.restart_window_s = float(
        res.get("restart_window_s", cfg.resilience.restart_window_s)
    )
    cfg.resilience.restart_max_rapid = int(
        res.get("restart_max_rapid", cfg.resilience.restart_max_rapid)
    )
    cfg.resilience.store_retries = int(
        res.get("store_retries", cfg.resilience.store_retries)
    )
    cfg.resilience.store_retry_base_s = float(
        res.get("store_retry_base_s", cfg.resilience.store_retry_base_s)
    )
    cfg.resilience.breaker_failures = int(
        res.get("breaker_failures", cfg.resilience.breaker_failures)
    )
    cfg.resilience.breaker_cooldown_s = float(
        res.get("breaker_cooldown_s", cfg.resilience.breaker_cooldown_s)
    )
    cfg.resilience.faults = str(res.get("faults", cfg.resilience.faults))
    fl = doc.get("fleet", {})
    cfg.fleet.replicas = int(fl.get("replicas", cfg.fleet.replicas))
    for knob in ("lease_ttl_s", "lease_interval_s", "suspect_after_s", "dead_after_s",
                 "breaker_cooldown_s"):
        setattr(cfg.fleet, knob, float(fl.get(knob, getattr(cfg.fleet, knob))))
    for knob in ("retry_next_replica", "breaker_failures"):
        setattr(cfg.fleet, knob, int(fl.get(knob, getattr(cfg.fleet, knob))))
    sec = doc.get("security", {})
    cfg.auth_token = sec.get("auth_token", cfg.auth_token)
    cfg.store_url = doc.get("store", {}).get("url", cfg.store_url)
    cfg.data_dir = doc.get("data_dir", cfg.data_dir)

    # Env overrides, explicit binds like the reference's AGENTAINER_* set
    # (config.go:72-81).
    env = os.environ
    cfg.server.host = env.get("ATPU_SERVER_HOST", cfg.server.host)
    cfg.server.port = int(env.get("ATPU_SERVER_PORT", cfg.server.port))
    cfg.auth_token = env.get("ATPU_AUTH_TOKEN", cfg.auth_token)
    cfg.store_url = env.get("ATPU_STORE_URL", cfg.store_url)
    cfg.data_dir = env.get("ATPU_DATA_DIR", cfg.data_dir)
    if "ATPU_SLICE_CHIPS" in env:
        cfg.slice.total_chips = int(env["ATPU_SLICE_CHIPS"])
    if "name" not in sl and cfg.slice.total_chips != detect_gpus()[0]:
        cfg.slice.name = _slice_name(cfg.slice.total_chips)
    if "ATPU_SLICE_HOSTS" in env:
        cfg.slice.hosts = int(env["ATPU_SLICE_HOSTS"])
    if "ATPU_DEADLINES" in env:
        cfg.deadlines.enabled = env["ATPU_DEADLINES"].lower() in ("1", "true", "yes")
    if "ATPU_DEADLINE_DEFAULT_MS" in env:
        cfg.deadlines.default_ms = float(env["ATPU_DEADLINE_DEFAULT_MS"])
    if "ATPU_SHED_PER_AGENT" in env:
        cfg.deadlines.shed_pending_per_agent = int(env["ATPU_SHED_PER_AGENT"])
    if "ATPU_SHED_GLOBAL" in env:
        cfg.deadlines.shed_pending_global = int(env["ATPU_SHED_GLOBAL"])
    if "ATPU_REQUEST_PERSISTENCE" in env:
        cfg.features.request_persistence = env["ATPU_REQUEST_PERSISTENCE"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.native_dataplane = bool(
        feats.get("native_dataplane", cfg.features.native_dataplane)
    )
    if "ATPU_NATIVE_DATAPLANE" in env:
        cfg.features.native_dataplane = env["ATPU_NATIVE_DATAPLANE"].lower() in (
            "1",
            "true",
            "yes",
        )
    if "ATPU_FLEET_REPLICAS" in env:
        # the env bind completes the fleet flag's operator surface
        # (config.yaml `fleet.replicas` / per-deploy `replicas` / env):
        # malformed values fall back like the other numeric binds
        try:
            cfg.fleet.replicas = int(env["ATPU_FLEET_REPLICAS"])
        except ValueError:
            pass
    if "ATPU_FAULTS" in env:
        # the env spec REPLACES a config-file spec rather than merging:
        # an operator arming from the shell must get exactly that schedule
        cfg.resilience.faults = env["ATPU_FAULTS"]

    def _env_num(name: str, cast, current):
        # malformed resilience numbers fall back to the config value
        # instead of refusing to boot (LocalBackend reads the same vars
        # with the same tolerance — behavior must not depend on which
        # reader hits them first)
        raw = env.get(name)
        if raw is None:
            return current
        try:
            return cast(raw)
        except ValueError:
            return current

    res_cfg = cfg.resilience
    res_cfg.restart_max_rapid = _env_num(
        "ATPU_RESTART_MAX_RAPID", int, res_cfg.restart_max_rapid
    )
    res_cfg.restart_backoff_base_s = _env_num(
        "ATPU_RESTART_BACKOFF_BASE_S", float, res_cfg.restart_backoff_base_s
    )
    res_cfg.restart_backoff_max_s = _env_num(
        "ATPU_RESTART_BACKOFF_MAX_S", float, res_cfg.restart_backoff_max_s
    )
    res_cfg.restart_window_s = _env_num(
        "ATPU_RESTART_WINDOW_S", float, res_cfg.restart_window_s
    )
    res_cfg.store_retries = _env_num("ATPU_STORE_RETRIES", int, res_cfg.store_retries)
    res_cfg.store_retry_base_s = _env_num(
        "ATPU_STORE_RETRY_BASE_S", float, res_cfg.store_retry_base_s
    )
    cfg.features.speculative = bool(
        feats.get("speculative", cfg.features.speculative)
    )
    if "ATPU_SPECULATIVE" in env:
        cfg.features.speculative = env["ATPU_SPECULATIVE"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.paged_kv = bool(feats.get("paged_kv", cfg.features.paged_kv))
    if "ATPU_PAGED_KV" in env:
        cfg.features.paged_kv = env["ATPU_PAGED_KV"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.adaptive_decode = bool(
        feats.get("adaptive_decode", cfg.features.adaptive_decode)
    )
    if "ATPU_ADAPTIVE_DECODE" in env:
        cfg.features.adaptive_decode = env["ATPU_ADAPTIVE_DECODE"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.prefix_cache = bool(
        feats.get("prefix_cache", cfg.features.prefix_cache)
    )
    if "ATPU_PREFIX_CACHE" in env:
        cfg.features.prefix_cache = env["ATPU_PREFIX_CACHE"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.fused_decode = bool(
        feats.get("fused_decode", cfg.features.fused_decode)
    )
    if "ATPU_FUSED_DECODE" in env:
        cfg.features.fused_decode = env["ATPU_FUSED_DECODE"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.inloop_spec = bool(
        feats.get("inloop_spec", cfg.features.inloop_spec)
    )
    if "ATPU_INLOOP_SPEC" in env:
        cfg.features.inloop_spec = env["ATPU_INLOOP_SPEC"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.approx_topk = bool(
        feats.get("approx_topk", cfg.features.approx_topk)
    )
    if "ATPU_APPROX_TOPK" in env:
        cfg.features.approx_topk = env["ATPU_APPROX_TOPK"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.kv_tiering = bool(
        feats.get("kv_tiering", cfg.features.kv_tiering)
    )
    if "ATPU_KV_TIERING" in env:
        cfg.features.kv_tiering = env["ATPU_KV_TIERING"].lower() in (
            "1",
            "true",
            "yes",
        )
    cfg.features.streaming = bool(
        feats.get("streaming", cfg.features.streaming)
    )
    if "ATPU_STREAMING" in env:
        cfg.features.streaming = env["ATPU_STREAMING"].lower() in (
            "1",
            "true",
            "yes",
        )
    try:
        cfg.features.tier_park_linger_s = float(
            feats.get("tier_park_linger_s", cfg.features.tier_park_linger_s)
        )
    except (TypeError, ValueError):
        pass  # malformed linger keeps the default; tiering still works
    return cfg
