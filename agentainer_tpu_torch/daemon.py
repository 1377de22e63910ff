"""Daemon wiring — the composition root.

Reference: ``agentainer_tpu/daemon.py`` (the reference's ``runServer``):
construct the store, backend and scheduler, the services (manager,
journal, health, metrics, reconciler, log plane, the fleet's router,
replica monitor and repair), the API server and the background loops
(state sync at 10 s, replay at 5 s, metrics at 10 s, health per agent,
replica leases at ``fleet.lease_interval_s``), then serve until stopped.
As in the reference:

- ``store_url`` ``auto`` resolves to ``native://<data_dir>/store.aof``
  (the C++ store; every mutation in an append-only file replayed on the
  next start) when the native library builds (``native.py``), else
  ``mem://``;
- with a native store and ``features.native_dataplane``, the C++ listener
  (``runtime/dataplane.py``) takes the public port: ``/agent/{id}/*`` is
  journaled, dispatched and settled on native threads, the engines reach
  the store over its unix socket (``<data_dir>/store.sock``), and
  everything else — a replica fleet's ``/agent/*`` included, whose route
  the hook leaves to Python so the routing tier keeps its dispatch — is
  forwarded to the port's standard-library server (``server/app.py`` over
  ``utils/http``) on a loopback port; otherwise that server is the front
  door. The start line names the store and the data plane that run; the
  data plane stops before the store can be freed.

What differs: the reference's artifacts and backups come with later
slices (their routes answer 501); nothing here imports torch, so the
daemon never creates a CUDA context — only the llm engine processes it
spawns touch the card.

Run: ``python -m agentainer_tpu_torch.daemon`` (``ATPU_SERVER_PORT``,
``ATPU_AUTH_TOKEN``, ``ATPU_DATA_DIR`` and the rest of ``config.py``'s
environment), until SIGTERM/SIGINT.
"""

from __future__ import annotations

import asyncio
import functools
import os
import signal
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from .config import Config, load_config
from .manager.agents import AgentManager
from .manager.audit import LogPlane
from .manager.health import HealthMonitor
from .manager.journal import RequestJournal
from .manager.metrics import MetricsPlane
from .manager.reconcile import QuickSync, StateSynchronizer
from .manager.replay import ReplayWorker
from .runtime.backend import Backend
from .runtime.scheduler import SliceScheduler, SliceTopology
from .store import Store, open_store


@dataclass
class Services:
    config: Config
    store: Store
    backend: Backend
    scheduler: SliceScheduler
    manager: AgentManager
    journal: RequestJournal
    logs: LogPlane
    metrics: MetricsPlane
    data_dir: str = ""
    store_url: str = ""  # the store the daemon opened (auto resolved)
    dataplane: object = None  # NativeDataPlane when the C++ listener is up
    health: HealthMonitor = None  # type: ignore[assignment]
    quick_sync: QuickSync = None  # type: ignore[assignment]
    state_sync: StateSynchronizer = None  # type: ignore[assignment]
    replay: ReplayWorker = None  # type: ignore[assignment]
    app: object = None  # the ControlPlaneApp
    # fleet plane (multi-replica agents): the proxy's routing tier, the
    # lease-driven replica monitor, and the dead-replica repair path
    router: object = None
    replica_monitor: object = None
    fleet_repair: object = None
    dispatch: Callable[..., Awaitable[tuple[int, dict, bytes]]] = None  # type: ignore[assignment]
    public_port: int = 0  # actual bound public port once run_daemon is up
    _background_started: bool = field(default=False, repr=False)


def _export_fleet_defaults(config: Config) -> None:
    """Engines inherit the daemon's environment: write back the resolved
    engine-option defaults (``features.*`` → ``ATPU_*``), so a config that
    turns a feature off pins every spawned engine without touching each
    deployment's options — both ways, so a second ``build_services`` does
    not inherit a stale latch. Same for the fault plane and the store
    client's retry policy."""
    f = config.features
    for flag, env_name in (
        (f.speculative, "ATPU_SPECULATIVE"),
        (f.paged_kv, "ATPU_PAGED_KV"),
        (f.adaptive_decode, "ATPU_ADAPTIVE_DECODE"),
        (f.prefix_cache, "ATPU_PREFIX_CACHE"),
        (f.fused_decode, "ATPU_FUSED_DECODE"),
        (f.inloop_spec, "ATPU_INLOOP_SPEC"),
        (f.approx_topk, "ATPU_APPROX_TOPK"),
        (f.kv_tiering, "ATPU_KV_TIERING"),
        (f.streaming, "ATPU_STREAMING"),
        (config.deadlines.enabled, "ATPU_DEADLINES"),
    ):
        os.environ[env_name] = "1" if flag else "0"
    from . import faults

    faults.disarm_all()
    if config.resilience.faults:
        faults.arm_spec(config.resilience.faults)
    os.environ["ATPU_FAULTS"] = config.resilience.faults
    os.environ["ATPU_STORE_RETRIES"] = str(config.resilience.store_retries)
    os.environ["ATPU_STORE_RETRY_BASE_S"] = str(config.resilience.store_retry_base_s)


def build_services(
    config: Config | None = None,
    store: Store | None = None,
    backend: Backend | None = None,
    console_logs: bool = True,
    data_dir: str | None = None,
) -> Services:
    config = config or load_config()
    _export_fleet_defaults(config)
    ddir = data_dir if data_dir is not None else config.data_path
    store_url = "(given)"
    if store is None:
        store_url = config.store_url
        if store_url == "auto":
            # native store + AOF durability when the library builds — the
            # Redis-persistence role; the memory store otherwise
            from .native import available as native_available

            if native_available():
                os.makedirs(str(ddir), exist_ok=True)
                store_url = f"native://{ddir}/store.aof"
            else:
                store_url = "mem://"
        store = open_store(store_url)
    if backend is None:
        from .runtime.local import LocalBackend

        backend = LocalBackend(
            store=store,
            data_dir=os.path.join(str(ddir), "runtime"),
            restart_backoff_base_s=config.resilience.restart_backoff_base_s,
            restart_backoff_max_s=config.resilience.restart_backoff_max_s,
            restart_window_s=config.resilience.restart_window_s,
            restart_max_rapid=config.resilience.restart_max_rapid,
        )
    elif getattr(backend, "store", "absent") is None:
        backend.store = store  # LocalBackend built without a store: inject ours
    topo = SliceTopology(
        total_chips=config.slice.total_chips,
        hbm_per_chip=config.slice.hbm_per_chip,
        name=config.slice.name,
        hosts=config.slice.hosts,
    )
    scheduler = SliceScheduler(store, topo)
    manager = AgentManager(store, backend, scheduler)
    journal = RequestJournal(store)
    logs = LogPlane(store, data_dir=ddir, console=console_logs)
    metrics = MetricsPlane(
        manager, store, interval_s=config.cadences.metrics_interval_s, logs=logs
    )
    services = Services(
        config=config,
        store=store,
        backend=backend,
        scheduler=scheduler,
        manager=manager,
        journal=journal,
        logs=logs,
        metrics=metrics,
        data_dir=str(ddir),
        store_url=store_url,
    )
    quick_sync = QuickSync(manager, backend)
    manager.set_quick_sync(quick_sync)
    services.quick_sync = quick_sync
    services.state_sync = StateSynchronizer(
        quick_sync, backend, interval_s=config.cadences.state_sync_s
    )
    # the app's dispatch is the single choke point for traffic into
    # engines; replay and health reuse it
    from .server.app import ControlPlaneApp

    app_obj = ControlPlaneApp(services)
    services.app = app_obj
    services.dispatch = app_obj.dispatch_to_agent
    services.health = HealthMonitor(manager, store, services.dispatch, logs=logs)
    services.replay = ReplayWorker(
        journal,
        manager,
        services.dispatch,
        interval_s=config.cadences.replay_scan_s,
        backend=backend,
    )

    # fleet plane: replica leases + fleet-wide repair. The monitor only
    # probes agents with >1 replica, so a fleet.replicas=1 deployment runs
    # zero extra traffic.
    from .manager.health import ReplicaMonitor
    from .manager.reconcile import FleetRepair

    manager.set_fleet(config.fleet.replicas, config.fleet.lease_ttl_s)
    services.router = app_obj.router
    services.fleet_repair = FleetRepair(
        manager, journal, router=app_obj.router, replay=services.replay, logs=logs
    )
    services.replica_monitor = ReplicaMonitor(
        manager,
        store,
        router=app_obj.router,
        repair=services.fleet_repair,
        lease_ttl_s=config.fleet.lease_ttl_s,
        lease_interval_s=config.fleet.lease_interval_s,
        suspect_after_s=config.fleet.suspect_after_s,
        dead_after_s=config.fleet.dead_after_s,
        logs=logs,
    )
    return services


async def start_background(services: Services) -> None:
    """Start the reconciler, replay worker, metrics collector and health
    monitor."""
    if services._background_started:
        return
    services._background_started = True
    await services.state_sync.start()
    if services.config.features.request_persistence:
        await services.replay.start()
    await services.metrics.start()
    await services.health.start()
    if services.replica_monitor is not None:
        await services.replica_monitor.start()


async def stop_background(services: Services) -> None:
    if not services._background_started:
        return
    services._background_started = False
    await services.replay.stop()
    await services.state_sync.stop()
    await services.metrics.stop()
    await services.health.stop()
    if services.replica_monitor is not None:
        await services.replica_monitor.stop()


def _try_start_dataplane(services: Services, host: str, port: int, mgmt_port: int):
    """Start the C++ front door on ``host:port``: /agent/* and the engine
    store socket served natively, the rest forwarded to the standard-library
    server on ``mgmt_port``. Returns the NativeDataPlane, or None (the
    Python server is the front door)."""
    uds_path = os.path.join(os.path.abspath(services.data_dir), "store.sock")
    try:
        from .runtime.dataplane import NativeDataPlane

        os.makedirs(services.data_dir, exist_ok=True)
        dp = NativeDataPlane(services.store, host, port, "127.0.0.1", mgmt_port, uds_path)
    except Exception as e:
        services.logs.warn("daemon", f"native data plane unavailable: {e}")
        return None
    persist = services.config.features.request_persistence

    def route_hook(agent, agent_id: str) -> None:
        if agent is None:
            dp.route_del(agent_id)
            return
        endpoint = services.manager.endpoint(agent)
        if len(agent.all_engine_ids()) > 1:
            # replica fleet: no single endpoint is right — a Python-owned
            # route (port 0 on a running agent) sends its /agent/* to the
            # standard-library proxy, whose routing tier owns the dispatch
            endpoint = None
        dp.route_set(agent_id, endpoint, agent.status.value, persist)

    services.manager.set_route_hook(route_hook)
    services.metrics.set_native_drain(dp.counters_drain)
    if hasattr(services.backend, "set_store_sock"):
        services.backend.set_store_sock(uds_path)
    services.dataplane = dp
    return dp


async def start_daemon(services: Services, host: str | None = None, port: int | None = None):
    """Bind the front door (port 0 = any free port) and point the backend's
    engines at it; returns the standard-library server. With the C++ data
    plane that server listens on a loopback port behind it. The background
    loops start apart (``start_background``), so a caller may drive the
    reconciler and the replay worker itself, as the tests do."""
    from .utils import http

    cfg = services.config
    host = cfg.server.host if host is None else host
    port = cfg.server.port if port is None else port
    serve = functools.partial(http.start_server, services.app.handle, max_body=services.app.max_body)
    dp = None
    from .store.native import NativeStore

    if cfg.features.native_dataplane and isinstance(services.store, NativeStore):
        server = await serve("127.0.0.1", 0)
        dp = _try_start_dataplane(services, host, port, server.sockets[0].getsockname()[1])
        if dp is None:
            server.close()
    if dp is None:
        server = await serve(host, port)
        services.public_port = server.sockets[0].getsockname()[1]
    else:
        services.public_port = dp.port
    if hasattr(services.backend, "set_control"):
        services.backend.set_control(f"http://127.0.0.1:{services.public_port}", cfg.auth_token)
    services.logs.info(
        "daemon",
        f"control plane listening on {host}:{services.public_port} "
        f"(slice {services.scheduler.topology.name}, {services.scheduler.topology.total_chips} GPUs; "
        f"store {services.store_url}; data plane {'native' if dp else 'python'})",
    )
    return server


async def stop_daemon(services: Services, server) -> None:
    try:
        await stop_background(services)
    except asyncio.CancelledError:
        pass
    finally:
        # the data plane's threads use the store: stop them before anyone
        # may free it, even when a cancellation lands in the awaits above
        if services.dataplane is not None:
            services.dataplane.stop()
            services.dataplane = None
    await asyncio.to_thread(services.backend.close)
    server.close()


async def run_daemon(services: Services) -> None:
    """Serve until cancelled."""
    server = await start_daemon(services)
    await start_background(services)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await stop_daemon(services, server)


def main() -> None:
    services = build_services()

    async def go() -> None:
        task = asyncio.current_task()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, task.cancel)
        try:
            await run_daemon(services)
        except asyncio.CancelledError:
            pass

    try:
        asyncio.run(go())
    finally:
        services.store.close()  # after the data plane stopped


if __name__ == "__main__":
    main()
