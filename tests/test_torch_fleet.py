"""The port's replica fleet against the reference's, on the CPU.

- **Counterparts of tests/test_fleet.py** on the port's ``FakeBackend``:
  multi-replica lifecycle, health-aware routing, session affinity and
  handoff, the bounded cross-replica retry, per-replica breakers, leases
  and replica states, fleet repair, the quick sync's fleet mapping, the
  per-replica metrics and the Retry-After jitter. The HTTP cases go through
  the port's app in process (``ControlPlaneApp.handle``).
- **Held against the reference** where the behaviour is deterministic: one
  seeded script of sessions, loads, health changes and breaker results
  (with the ``router.pick`` and ``replica.handoff`` failpoints armed on a
  seed) through both ``ReplicaRouter``s gives the same picks and the same
  ``stats()``; ``ReplicaMonitor`` on a fake clock gives the same state
  sequence and counters; ``FleetRepair`` the same reassign counts.
- **The stream cursor** (tests/test_streaming.py's journal cases) and **the
  proxy's stream legs** (its proxy cases): the same stub upstream legs
  (emit-then-die, resume-to-done, a wrong floor, a gap, a hang-up, a
  poisoned prefill, a reconnect) go through the reference's daemon and the
  port's; the client's events and the journal entry (status,
  ``stream_offset``, the archived done) are equal up to ids and times.

Engine ids are random on both sides, so every comparison maps each to its
replica ordinal first.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import random
import re
import threading
import time
from types import SimpleNamespace

import pytest
from aiohttp import ClientSession, web
from aiohttp.test_utils import TestServer

from agentainer_tpu import faults as jfaults
from agentainer_tpu.config import Config as JConfig
from agentainer_tpu.daemon import build_services as jbuild_services
from agentainer_tpu.manager import health as jhealth
from agentainer_tpu.manager.reconcile import FleetRepair as JFleetRepair
from agentainer_tpu.runtime.backend import FakeBackend as JFakeBackend
from agentainer_tpu.server.router import ReplicaRouter as JReplicaRouter
from agentainer_tpu.store import MemoryStore as JMemoryStore
from agentainer_tpu_torch import faults
from agentainer_tpu_torch.config import Config
from agentainer_tpu_torch.core.protocol import (
    LAST_EVENT_ID_HEADER,
    PREFILL_POISON_HEADER,
    REQUEST_ID_HEADER,
    STREAM_CONTENT_TYPE,
)
from agentainer_tpu_torch.core.resilience import KeyedBreakers, retry_after_jitter
from agentainer_tpu_torch.core.spec import AgentStatus
from agentainer_tpu_torch.daemon import build_services, start_daemon, stop_daemon
from agentainer_tpu_torch.manager import health
from agentainer_tpu_torch.manager.health import (
    REPLICA_ALIVE,
    REPLICA_DEAD,
    REPLICA_SUSPECT,
    ReplicaMonitor,
)
from agentainer_tpu_torch.manager.journal import RequestJournal, RequestStatus, StreamGapError
from agentainer_tpu_torch.manager.reconcile import FleetRepair
from agentainer_tpu_torch.runtime.backend import EngineState, FakeBackend
from agentainer_tpu_torch.server.router import ReplicaRouter
from agentainer_tpu_torch.store import Keys, MemoryStore
from agentainer_tpu_torch.utils.http import Request

TOKEN = "fleet-token"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
SLICE = {"total_chips": 8, "hbm_per_chip": 16 * 1024**3, "name": "test-slice-8"}


def run(coro):
    return asyncio.run(coro)


def _config(cfg, fleet_replicas=1, streaming=False):
    cfg.auth_token = TOKEN
    cfg.fleet.replicas = fleet_replicas
    cfg.features.streaming = streaming
    for k, v in SLICE.items():
        setattr(cfg.slice, k, v)
    return cfg


def make_services(tmp_path, fleet_replicas=1, streaming=False):
    return build_services(
        config=_config(Config(), fleet_replicas, streaming), store=MemoryStore(),
        backend=FakeBackend(), console_logs=False, data_dir=str(tmp_path),
    )


def make_reference(tmp_path, fleet_replicas=1, streaming=False):
    return jbuild_services(
        config=_config(JConfig(), fleet_replicas, streaming), store=JMemoryStore(),
        backend=JFakeBackend(), console_logs=False, data_dir=str(tmp_path),
    )


async def call(services, method: str, path: str, body=None, headers=None):
    """One request through the port's app, in process: (status, headers,
    JSON document or raw bytes)."""
    raw = b"" if body is None else json.dumps(body).encode()
    resp = await services.app.handle(Request(method, path, dict(headers or {}), raw))
    if resp.body is None:
        return resp.status, resp.headers or {}, resp.doc
    try:
        return resp.status, resp.headers or {}, json.loads(resp.body)
    except ValueError:
        return resp.status, resp.headers or {}, resp.body


async def deploy_and_start(services, name="a", model="echo", replicas=0) -> dict:
    body = {"name": name, "model": model}
    if replicas:
        body["replicas"] = replicas
    status, _, doc = await call(services, "POST", "/agents", body, AUTH)
    assert status == 200, doc
    agent = doc["data"]
    status, _, doc = await call(services, "POST", f"/agents/{agent['id']}/start", headers=AUTH)
    assert status == 200, doc
    return agent


# -- lifecycle ------------------------------------------------------------------


def test_single_replica_record_keeps_its_shape(tmp_path):
    """fleet.replicas = 1 (default): one engine, replica_ids stays empty."""

    async def body():
        s = make_services(tmp_path)
        agent = await deploy_and_start(s)
        rec = s.manager.get_agent(agent["id"])
        assert rec.engine_id and rec.replica_ids == []
        assert rec.all_engine_ids() == [rec.engine_id]
        assert len(s.backend.list_engines()) == 1

    run(body())


def test_multi_replica_start_spawns_n_engines(tmp_path):
    async def body():
        s = make_services(tmp_path)
        agent = await deploy_and_start(s, replicas=3)
        rec = s.manager.get_agent(agent["id"])
        assert len(rec.replica_ids) == 3 and rec.engine_id == rec.replica_ids[0]
        infos = [s.backend.engine_info(e) for e in rec.replica_ids]
        assert all(i is not None and i.state == EngineState.RUNNING for i in infos)
        for eid in rec.replica_ids:  # each replica registered an initial lease
            assert s.store.get_json(Keys.replica_lease(rec.id, eid))

    run(body())


def test_fleet_default_applies_when_deploy_does_not_pin(tmp_path):
    async def body():
        s = make_services(tmp_path, fleet_replicas=2)
        agent = await deploy_and_start(s)
        assert len(s.manager.get_agent(agent["id"]).all_engine_ids()) == 2

    run(body())


def test_stop_and_remove_cover_every_replica(tmp_path):
    async def body():
        s = make_services(tmp_path)
        agent = await deploy_and_start(s, replicas=2)
        rec = s.manager.get_agent(agent["id"])
        ids = rec.all_engine_ids()
        assert (await call(s, "POST", f"/agents/{rec.id}/stop", headers=AUTH))[0] == 200
        for eid in ids:
            assert s.backend.engine_info(eid).state == EngineState.EXITED
        assert (await call(s, "DELETE", f"/agents/{rec.id}", headers=AUTH))[0] == 200
        assert s.backend.list_engines() == []
        assert s.store.keys(Keys.replica_lease_pattern(rec.id)) == []

    run(body())


def test_scale_down_stops_surplus_replicas(tmp_path):
    """An operator who lowers the record's count gets the surplus replicas
    stopped and removed at the next start."""
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="sd", model="echo", replicas=3)
    s.manager.start(agent.id)
    first, *surplus = s.manager.get_agent(agent.id).all_engine_ids()
    s.manager.stop(agent.id)
    rec = s.manager.get_agent(agent.id)
    rec.replicas = 1
    s.manager.save_agent(rec)
    s.manager.start(agent.id)
    rec = s.manager.get_agent(agent.id)
    assert rec.replica_ids == [] and rec.engine_id == first
    assert len(surplus) == 2 and all(s.backend.engine_info(e) is None for e in surplus)
    assert s.manager.replica_scaledown_errors_total == 0


# -- routing --------------------------------------------------------------------


def _mk_router(tmp_path, n=3, seed=7):
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="r", model="echo", replicas=n)
    s.manager.start(agent.id)
    agent = s.manager.get_agent(agent.id)
    return s, agent, ReplicaRouter(s.manager, s.config.fleet, seed=seed)


def test_router_session_affinity_sticks(tmp_path):
    _, agent, router = _mk_router(tmp_path)
    first = router.pick(agent, session="s1")
    for _ in range(5):
        assert router.pick(agent, session="s1").engine_id == first.engine_id


def test_router_power_of_two_prefers_less_loaded(tmp_path):
    _, agent, router = _mk_router(tmp_path, n=2)
    a, b = agent.all_engine_ids()
    for _ in range(8):
        router.begin(a)
    assert {router.pick(agent).engine_id for _ in range(10)} == {b}


def test_router_p2c_uses_engine_reported_load(tmp_path):
    _, agent, router = _mk_router(tmp_path, n=2)
    a, b = agent.all_engine_ids()
    for _ in range(8):
        router.begin(a)  # the proxy's picture: a is drowning...
    router.set_load(a, 0)  # ...the engines report the opposite
    router.set_load(b, 12)
    assert {router.pick(agent).engine_id for _ in range(10)} == {a}
    stats = router.stats(agent)
    assert stats["replicas"][a]["load"] == 0 and stats["replicas"][b]["load"] == 12


def test_router_load_falls_back_to_inflight_and_forgets(tmp_path):
    _, agent, router = _mk_router(tmp_path, n=2)
    a, _b = agent.all_engine_ids()
    assert router._occupancy(a) == 0
    router.begin(a)
    assert router._occupancy(a) == 1
    router.set_load(a, 7)
    assert router._occupancy(a) == 7
    router.set_load(a, -3)
    assert router._occupancy(a) == 0
    router.forget(a)
    assert router.stats(agent)["replicas"][a]["load"] is None


def test_router_excludes_suspect_and_dead(tmp_path):
    _, agent, router = _mk_router(tmp_path, n=3)
    a, b, c = agent.all_engine_ids()
    router.set_health(a, "suspect")
    router.set_health(b, "dead")
    assert {router.pick(agent).engine_id for _ in range(10)} == {c}


def test_router_handoff_on_dead_affinity(tmp_path):
    _, agent, router = _mk_router(tmp_path, n=3)
    first = router.pick(agent, session="vic")
    router.on_replica_dead(agent.id, first.engine_id)
    second = router.pick(agent, session="vic")
    assert second.engine_id != first.engine_id
    assert router.handoffs_total == 0  # affinity dropped: a fresh pick
    router.set_health(second.engine_id, "suspect")
    third = router.pick(agent, session="vic")
    assert third.engine_id != second.engine_id and router.handoffs_total == 1


def test_router_per_replica_breaker_isolates(tmp_path):
    _, agent, router = _mk_router(tmp_path, n=2)
    a, b = agent.all_engine_ids()
    for _ in range(router.breakers.failure_threshold):
        router.end(a, ok=False)
    assert router.breakers.get(a).state == "open"
    assert {router.pick(agent).engine_id for _ in range(10)} == {b}
    stats = router.stats(agent)
    assert stats["replicas"][a]["breaker"]["state"] == "open"
    assert stats["replicas"][b]["breaker"]["state"] == "closed"


def test_router_all_excluded_falls_back_to_probe(tmp_path):
    _, agent, router = _mk_router(tmp_path, n=2)
    for eid in agent.all_engine_ids():
        router.set_health(eid, "suspect")
    assert router.pick(agent) is not None
    assert router.pick(agent, exclude=frozenset(agent.all_engine_ids())) is None


# -- the same script through both routers ----------------------------------------

_ROUTER_FAULTS = "router.pick:probability=0.15,seed=11;replica.handoff:probability=0.5,seed=12"


def _router_script(services, router_cls, fault_mod, seed: int) -> list:
    """A seeded script of dispatch accounting, loads, health changes and
    picks; returns each pick (by replica ordinal) and the normalized
    stats after every step."""
    agent = services.manager.deploy(name="r", model="echo", replicas=3)
    services.manager.start(agent.id)
    agent = services.manager.get_agent(agent.id)
    ids = agent.all_engine_ids()
    ordinal = {eid: f"r{i}" for i, eid in enumerate(ids)}
    router = router_cls(services.manager, services.config.fleet, seed=seed)
    rng = random.Random(seed)
    out = []

    def stats():
        doc = router.stats(agent)
        return {**doc, "replicas": {ordinal[e]: v for e, v in sorted(
            doc["replicas"].items(), key=lambda kv: ordinal[kv[0]])}}

    fault_mod.disarm_all()
    fault_mod.arm_spec(_ROUTER_FAULTS)
    try:
        for _ in range(240):
            op = rng.choice(["pick", "pick", "pick", "pick_excl", "begin", "end", "health",
                             "load", "dead", "forget"])
            eid = ids[rng.randrange(3)]
            session = rng.choice(["", "s0", "s1", "s2", "s3", "s4"])
            if op == "pick":
                c = router.pick(agent, session=session)
                out.append(("pick", session, c and ordinal[c.engine_id]))
            elif op == "pick_excl":
                excl = frozenset(e for e in ids if rng.random() < 0.4)
                c = router.pick(agent, session=session, exclude=excl)
                out.append(("pick_excl", session, sorted(ordinal[e] for e in excl),
                            c and ordinal[c.engine_id]))
            elif op == "begin":
                router.begin(eid)
            elif op == "end":
                router.end(eid, ok=rng.random() < 0.4)
            elif op == "health":
                router.set_health(eid, rng.choice([REPLICA_ALIVE, REPLICA_ALIVE, REPLICA_SUSPECT,
                                                   REPLICA_DEAD]))
            elif op == "load":
                router.set_load(eid, rng.randrange(-2, 9))
            elif op == "dead":
                router.on_replica_dead(agent.id, eid)
            else:
                router.forget(eid)
            out.append(stats())
    finally:
        fault_mod.disarm_all()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_script_matches_reference(tmp_path, seed):
    want = _router_script(make_reference(tmp_path / "ref"), JReplicaRouter, jfaults, seed)
    got = _router_script(make_services(tmp_path / "port"), ReplicaRouter, faults, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {i}"
    picks = [x for x in got if isinstance(x, tuple)]
    assert {p[-1] for p in picks} >= {"r0", "r1", "r2"}
    assert got[-1]["stale_picks_total"] > 0 and got[-1]["handoffs_total"] > 0


# -- dispatch: cross-replica retry -------------------------------------------------


def test_dispatch_retries_on_next_replica_after_crash(tmp_path):
    async def body():
        s = make_services(tmp_path)
        agent = await deploy_and_start(s, replicas=2)
        rec = s.manager.get_agent(agent["id"])
        s.backend.crash_engine(rec.engine_id)
        status, headers, doc = await call(s, "POST", f"/agent/{rec.id}/chat",
                                          {"message": "hi", "session": "s"})
        assert status == 200, doc
        req = s.journal.get(rec.id, headers[REQUEST_ID_HEADER])
        assert req is not None and req.status == "completed"
        # the claim moved to the replica that served it
        assert req.replica_id and req.replica_id != rec.engine_id

    run(body())


def test_dispatch_all_replicas_down_leaves_pending(tmp_path):
    async def body():
        s = make_services(tmp_path)
        agent = await deploy_and_start(s, replicas=2)
        rec = s.manager.get_agent(agent["id"])
        for eid in rec.all_engine_ids():
            s.backend.crash_engine(eid)
        rec.status = AgentStatus.RUNNING  # not reconciled yet: the proxy dispatches
        s.manager.save_agent(rec)
        status, _, _ = await call(s, "POST", f"/agent/{rec.id}/chat", {"message": "hi"})
        assert status == 502
        assert s.journal.stats(rec.id)["pending"] == 1

    run(body())


# -- replica monitor + fleet repair ----------------------------------------------


def _mk_monitor(tmp_path, n=2, suspect=0.05, dead=0.5):
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="m", model="echo", replicas=n)
    s.manager.start(agent.id)
    agent = s.manager.get_agent(agent.id)
    router = ReplicaRouter(s.manager, s.config.fleet, seed=3)
    repair = FleetRepair(s.manager, s.journal, router=router, replay=None)
    mon = ReplicaMonitor(s.manager, s.store, router=router, repair=repair, lease_ttl_s=5.0,
                         lease_interval_s=0.01, suspect_after_s=suspect, dead_after_s=dead)
    return s, agent, router, repair, mon


def test_monitor_leases_and_states(tmp_path):
    s, agent, _, _, mon = _mk_monitor(tmp_path)
    mon.tick()
    assert set(mon.states(agent.id).values()) == {REPLICA_ALIVE}
    for eid in agent.all_engine_ids():
        assert s.store.get_json(Keys.replica_lease(agent.id, eid))


def test_monitor_suspects_then_kills_then_repairs(tmp_path):
    s, agent, router, repair, mon = _mk_monitor(tmp_path)
    victim = agent.all_engine_ids()[1]
    mon.tick()
    s.backend.crash_engine(victim)
    time.sleep(0.1)
    mon.tick()
    assert mon.states(agent.id)[victim] == REPLICA_SUSPECT
    assert router.health_of(victim) == REPLICA_SUSPECT
    time.sleep(0.45)
    mon.tick()
    assert repair.repairs_total == 1
    assert s.backend.engine_info(victim).state == EngineState.RUNNING
    mon.tick()
    assert mon.states(agent.id)[victim] == REPLICA_ALIVE
    assert router.health_of(victim) == REPLICA_ALIVE


def test_monitor_skips_single_replica_agents(tmp_path):
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="solo", model="echo")
    s.manager.start(agent.id)
    mon = ReplicaMonitor(s.manager, s.store)
    mon.tick()
    assert s.store.keys(Keys.replica_lease_pattern(agent.id)) == []
    assert mon.lease_refreshes_total == 0


def test_monitor_feeds_engine_load_to_router(tmp_path):
    s, agent, router, _, mon = _mk_monitor(tmp_path)
    a, b = agent.all_engine_ids()
    depths = {a: {"queue_depth": 2, "waiting_depth": 1, "active_requests": 3},
              b: {"queue_depth": 0}}
    s.backend.stats = lambda eid: depths.get(eid)
    mon.tick()
    replicas = router.stats(agent)["replicas"]
    assert replicas[a]["load"] == 6 and replicas[b]["load"] == 0


def _monitor_script(services, monitor_mod, router_cls, repair_cls, seed: int, monkeypatch) -> list:
    """A seeded script of crashes and clock steps, one tick per step, on a
    fake clock: each tick's replica states (by ordinal), the monitor's
    counters, the repairs and the engines' states."""
    clock = [1000.0]
    monkeypatch.setattr(monitor_mod, "time", SimpleNamespace(time=lambda: clock[0]))
    agent = services.manager.deploy(name="m", model="echo", replicas=3)
    services.manager.start(agent.id)
    agent = services.manager.get_agent(agent.id)
    ids = agent.all_engine_ids()
    router = router_cls(services.manager, services.config.fleet, seed=seed)
    repair = repair_cls(services.manager, services.journal, router=router, replay=None)
    mon = monitor_mod.ReplicaMonitor(
        services.manager, services.store, router=router, repair=repair, lease_ttl_s=3600.0,
        lease_interval_s=1.0, suspect_after_s=1.0, dead_after_s=3.0,
    )
    rng = random.Random(seed)
    out = []
    for _ in range(60):
        if rng.random() < 0.2:
            eid = ids[rng.randrange(3)]
            if services.backend.engine_info(eid).state == EngineState.RUNNING:
                services.backend.crash_engine(eid)
        clock[0] += rng.choice([0.2, 0.5, 0.9, 1.3])
        mon.tick()
        st = mon.stats()
        out.append((
            [mon.states(agent.id)[e] for e in ids],
            [router.health_of(e) for e in ids],
            {k: st[k] for k in ("lease_refreshes_total", "suspects_total", "deaths_total")},
            repair.repairs_total,
            [services.backend.engine_info(e).state.value for e in ids],
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_states_on_a_fake_clock_match_reference(tmp_path, monkeypatch, seed):
    want = _monitor_script(make_reference(tmp_path / "ref"), jhealth, JReplicaRouter,
                           JFleetRepair, seed, monkeypatch)
    got = _monitor_script(make_services(tmp_path / "port"), health, ReplicaRouter,
                          FleetRepair, seed, monkeypatch)
    assert got == want
    seen = {s for step in got for s in step[0]}
    assert seen == {REPLICA_ALIVE, REPLICA_SUSPECT, REPLICA_DEAD}
    assert got[-1][3] > 0  # repairs ran


def test_repair_reassigns_in_flight_journal_work(tmp_path):
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="j", model="echo", replicas=2)
    s.manager.start(agent.id)
    agent = s.manager.get_agent(agent.id)
    dead, alive = agent.all_engine_ids()
    j = s.journal
    r1 = j.store_request(agent.id, "POST", "/chat")
    r2 = j.store_request(agent.id, "POST", "/chat")
    assert j.acquire_processing(agent.id, r1.id, replica_id=dead)
    assert j.acquire_processing(agent.id, r2.id, replica_id=alive)
    out = FleetRepair(s.manager, j, router=None, replay=None).repair_replica(agent.id, dead)
    assert out["reassigned"] == 1
    assert j.get(agent.id, r1.id).status == "pending"
    assert j.get(agent.id, r2.id).status == "processing"


def _repair_script(services, repair_cls, seed: int) -> list:
    """Seeded journal traffic over three replicas, then repairs (one twice,
    one after the agent stopped): each repair's result and every entry's
    status, by ordinal."""
    agent = services.manager.deploy(name="j", model="echo", replicas=3)
    services.manager.start(agent.id)
    agent = services.manager.get_agent(agent.id)
    ids = agent.all_engine_ids()
    j = services.journal
    rng = random.Random(seed)
    reqs = []
    for _ in range(16):
        r = j.store_request(agent.id, "POST", "/chat", {}, b"{}")
        reqs.append(r.id)
        fate = rng.random()
        if fate < 0.7:
            assert j.acquire_processing(agent.id, r.id, replica_id=ids[rng.randrange(3)])
            if fate < 0.15:
                j.store_response(agent.id, r.id, 200, {}, b"ok")
            elif fate < 0.3:
                j.set_replica(agent.id, r.id, ids[rng.randrange(3)])
    repair = repair_cls(services.manager, j, router=None, replay=None)
    out = []

    def statuses():
        return [j.get(agent.id, rid).status for rid in reqs]

    for k in (rng.randrange(3), rng.randrange(3)):
        services.backend.crash_engine(ids[k])
        out.append((k, repair.repair_replica(agent.id, ids[k]), statuses()))
    out.append(("again", repair.repair_replica(agent.id, ids[k]), statuses()))
    services.manager.stop(agent.id)
    out.append(("stopped", repair.repair_replica(agent.id, ids[0]), statuses()))
    out.append((repair.repairs_total, repair.reassigned_total, repair.respawn_errors_total))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repair_reassign_counts_match_reference(tmp_path, seed):
    want = _repair_script(make_reference(tmp_path / "ref"), JFleetRepair, seed)
    got = _repair_script(make_services(tmp_path / "port"), FleetRepair, seed)
    assert got == want
    assert got[-1][1] > 0


def test_quicksync_promotes_surviving_replica(tmp_path):
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="q", model="echo", replicas=2)
    s.manager.start(agent.id)
    agent = s.manager.get_agent(agent.id)
    primary, secondary = agent.all_engine_ids()
    s.backend.crash_engine(primary)
    synced = s.quick_sync.sync_agent(agent.id)
    assert synced.status == AgentStatus.RUNNING and synced.engine_id == secondary


def test_quicksync_all_dead_stops_agent(tmp_path):
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="q2", model="echo", replicas=2)
    s.manager.start(agent.id)
    agent = s.manager.get_agent(agent.id)
    for eid in agent.all_engine_ids():
        s.backend.crash_engine(eid)
    assert s.quick_sync.sync_agent(agent.id).status == AgentStatus.STOPPED


def test_resume_repairs_a_dead_replica(tmp_path):
    """Resume of a RUNNING fleet with one dead replica restarts that one."""
    s = make_services(tmp_path)
    agent = s.manager.deploy(name="rs", model="echo", replicas=2)
    s.manager.start(agent.id)
    agent = s.manager.get_agent(agent.id)
    a, b = agent.all_engine_ids()
    s.backend.crash_engine(b)
    s.manager.resume(agent.id)
    assert s.backend.engine_info(b).state == EngineState.RUNNING
    assert s.manager.get_agent(agent.id).all_engine_ids() == [a, b]


# -- /metrics fleet surface ---------------------------------------------------------


def test_metrics_export_per_replica_breakers(tmp_path):
    async def body():
        s = make_services(tmp_path)
        agent = await deploy_and_start(s, replicas=2)
        await call(s, "POST", f"/agent/{agent['id']}/chat", {"message": "x"})
        _, _, doc = await call(s, "GET", f"/agents/{agent['id']}/metrics", headers=AUTH)
        rec = s.manager.get_agent(agent["id"])
        for eid in rec.all_engine_ids():
            assert "breaker" in doc["data"]["fleet"]["replicas"][eid]
        _, _, all_doc = await call(s, "GET", "/metrics", headers=AUTH)
        assert "fleet" in all_doc["data"][agent["id"]]
        solo = await deploy_and_start(s, name="solo2")
        _, _, doc = await call(s, "GET", f"/agents/{solo['id']}/metrics", headers=AUTH)
        assert "fleet" not in (doc["data"] or {})

    run(body())


# -- Retry-After jitter, keyed breakers, the agent-scoped store token -----------


def test_retry_after_jitter_bounds_and_determinism():
    rng = random.Random(42)
    vals = [retry_after_jitter(10.0, rng) for _ in range(200)]
    assert all(7 <= v <= 13 for v in vals) and len(set(vals)) > 1
    rng2 = random.Random(42)
    assert vals == [retry_after_jitter(10.0, rng2) for _ in range(200)]
    assert retry_after_jitter(0.01, random.Random(1)) >= 1


def test_shed_responses_carry_jittered_retry_after(tmp_path, monkeypatch):
    monkeypatch.setenv("ATPU_JITTER_SEED", "99")

    async def body():
        s = make_services(tmp_path)
        s.config.deadlines.shed_pending_per_agent = 1
        s.config.deadlines.retry_after_s = 10.0
        agent = await deploy_and_start(s)
        rid = agent["id"]
        await call(s, "POST", f"/agents/{rid}/stop", headers=AUTH)
        s.journal.store_request(rid, "POST", "/chat")
        s.journal.store_request(rid, "POST", "/chat")
        status, headers, _ = await call(s, "POST", f"/agent/{rid}/chat", {"message": "x"})
        assert status == 429
        got = int(headers["Retry-After"])
        assert got == retry_after_jitter(10.0, random.Random(99)) and 7 <= got <= 13

    run(body())


def test_keyed_breakers_independent():
    kb = KeyedBreakers(failure_threshold=2, cooldown_s=60.0)
    for _ in range(2):
        kb.get("a").fail()
    assert kb.get("a").state == "open" and kb.get("b").state == "closed"
    kb.drop("a")
    assert kb.get("a").state == "closed"


def test_local_backend_replicas_share_agent_store_token(tmp_path):
    """Replicas of one agent reuse its store credential, and each replica of
    an llm agent gets a host of its own pinned to the agent's GPU."""
    from agentainer_tpu_torch.core.spec import Agent, ModelRef
    from agentainer_tpu_torch.runtime.local import LocalBackend

    store = MemoryStore()
    backend = LocalBackend(store=store, data_dir=str(tmp_path))
    try:
        agent = Agent(id="agent-tok", name="tok", model=ModelRef(engine="echo"))
        e0 = backend.create_engine(agent, (0,), replica_index=0)
        tok0 = store.get(Keys.internal_token(agent.id))
        e1 = backend.create_engine(agent, (0,), replica_index=1)
        assert store.get(Keys.internal_token(agent.id)) == tok0
        env0 = backend._recs[e0].env["AGENTAINER_INTERNAL_TOKEN"]
        env1 = backend._recs[e1].env["AGENTAINER_INTERNAL_TOKEN"]
        assert env0 == env1 == tok0.decode()
        llm = Agent(id="agent-llm", name="l", model=ModelRef(engine="llm", config="tiny"))
        h0 = backend._recs[backend.create_engine(llm, (0,), replica_index=0)]
        h1 = backend._recs[backend.create_engine(llm, (0,), replica_index=1)]
        assert h0.share_key != h1.share_key and h0.log_path != h1.log_path
        assert h0.env["CUDA_VISIBLE_DEVICES"] == h1.env["CUDA_VISIBLE_DEVICES"] == "0"
        assert h0.env["AGENTAINER_INTERNAL_TOKEN"] == h1.env["AGENTAINER_INTERNAL_TOKEN"]
    finally:
        backend.close()


# -- the journal's stream cursor ------------------------------------------------------


def make_journal():
    return RequestJournal(MemoryStore())


def test_stream_cursor_advances_by_exactly_one():
    j = make_journal()
    req = j.store_request("a", "POST", "/chat", {}, b"{}")
    assert j.get("a", req.id).stream_offset == -1
    for off in range(3):
        assert j.advance_stream("a", req.id, off) is True
    assert j.get("a", req.id).stream_offset == 2
    assert j.advance_stream("a", req.id, 3) is True


def test_stream_cursor_rejects_duplicates():
    j = make_journal()
    req = j.store_request("a", "POST", "/chat", {}, b"{}")
    assert j.advance_stream("a", req.id, 0) is True
    assert j.advance_stream("a", req.id, 0) is False
    assert j.advance_stream("a", req.id, -5) is False
    assert j.get("a", req.id).stream_offset == 0


def test_stream_cursor_gap_is_hard_error():
    j = make_journal()
    req = j.store_request("a", "POST", "/chat", {}, b"{}")
    assert j.advance_stream("a", req.id, 0) is True
    with pytest.raises(StreamGapError):
        j.advance_stream("a", req.id, 2)
    assert j.get("a", req.id).stream_offset == 0


def test_stream_cursor_cas_contention_single_winner():
    j = make_journal()
    req = j.store_request("a", "POST", "/chat", {}, b"{}")
    barrier = threading.Barrier(2)
    wins = []

    def racer():
        barrier.wait()
        wins.append(j.advance_stream("a", req.id, 0))

    threads = [threading.Thread(target=racer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(wins) == [False, True]


def _cursor_script(journal, seed: int) -> list:
    rng = random.Random(seed)
    req = journal.store_request("a", "POST", "/chat", {}, b"{}")
    out = []
    for _ in range(80):
        cur = journal.get("a", req.id).stream_offset
        off = cur + rng.choice([-2, 0, 1, 1, 1, 2])
        try:
            out.append(journal.advance_stream("a", req.id, off))
        except Exception as e:
            out.append(type(e).__name__)
        if rng.random() < 0.1:
            journal.set_replica("a", req.id, f"eng-{rng.randrange(3)}")
        out.append(journal.get("a", req.id).stream_offset)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_cursor_script_matches_reference(seed):
    from agentainer_tpu.manager.journal import RequestJournal as JRequestJournal

    assert _cursor_script(make_journal(), seed) == _cursor_script(JRequestJournal(JMemoryStore()), seed)


# -- the proxy's stream legs, through both daemons ----------------------------------


def _frame(event: str, off: int, data: dict) -> bytes:
    return f"event: {event}\nid: {off}\ndata: {json.dumps(data)}\n\n".encode()


_DONE_PAYLOAD = {
    "response": "streamed",
    "agent": "stub",
    "model": "tiny",
    "usage": {"prompt_tokens": 1, "completion_tokens": 6},
    "ttft_ms": 1.0,
}


class StubUpstream:
    """A scripted engine: each /chat dispatch runs the next leg of the
    script; it records the splice headers each leg received and /cancel."""

    def __init__(self, legs):
        self.legs = list(legs)
        self.calls = []
        self.cancels = []

    def app(self) -> web.Application:
        a = web.Application()
        a.router.add_post("/chat", self.h_chat)
        a.router.add_post("/cancel", self.h_cancel)
        return a

    async def h_cancel(self, request):
        self.cancels.append((await request.json()).get("request_id"))
        return web.json_response({"cancelled": True})

    async def h_chat(self, request):
        idx = len(self.calls)
        self.calls.append({"floor": request.headers.get(LAST_EVENT_ID_HEADER, ""),
                           "request_id": request.headers.get(REQUEST_ID_HEADER, "")})
        return await self.legs[min(idx, len(self.legs) - 1)](request, idx)


async def _start_sse(request) -> web.StreamResponse:
    r = web.StreamResponse(status=200, headers={"Content-Type": STREAM_CONTENT_TYPE})
    await r.prepare(request)
    return r


def emit_then_die(last_off: int, first_off: int = 0):
    async def leg(request, idx):
        r = await _start_sse(request)
        for off in range(first_off, last_off + 1):
            await r.write(_frame("token", off, {"offset": off, "token": 100 + off, "text": f"t{off}"}))
        return r  # EOF with no done frame

    return leg


def resume_to_done(last_off: int, ignore_floor: int | None = None):
    async def leg(request, idx):
        if ignore_floor is not None:
            start = ignore_floor
        else:
            raw = request.headers.get(LAST_EVENT_ID_HEADER, "")
            start = (int(raw) if raw else -1) + 1
        r = await _start_sse(request)
        await r.write(b": keep-alive\n\n")
        for off in range(start, last_off + 1):
            await r.write(_frame("token", off, {"offset": off, "token": 100 + off, "text": f"t{off}"}))
        await r.write(_frame("done", last_off, _DONE_PAYLOAD))
        await r.write_eof()
        return r

    return leg


async def gap_leg(request, idx):
    r = await _start_sse(request)
    await r.write(_frame("token", 0, {"offset": 0, "token": 100, "text": "t0"}))
    await r.write(_frame("token", 2, {"offset": 2, "token": 102, "text": "t2"}))
    await r.write(_frame("done", 2, _DONE_PAYLOAD))
    await r.write_eof()
    return r


async def hang_leg(request, idx):
    r = await _start_sse(request)
    await r.write(_frame("token", 0, {"offset": 0, "token": 100, "text": "t0"}))
    await asyncio.sleep(10)
    return r


async def poisoned_leg(request, idx):
    return web.json_response({"error": "PrefillFailed: boom"}, status=500,
                             headers={PREFILL_POISON_HEADER: "true"})


_IDS = re.compile(r"agent-\d+|[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def parse_sse(raw: bytes) -> list:
    """(event, id, data) per block, with agent and request ids masked."""
    raw = _IDS.sub("ID", raw.decode()).encode()
    out = []
    for block in raw.split(b"\n\n"):
        if not block.strip():
            continue
        event, eid, data, comment = "", None, None, True
        for ln in block.split(b"\n"):
            if ln.startswith(b":"):
                continue
            comment = False
            if ln.startswith(b"event:"):
                event = ln[6:].strip().decode()
            elif ln.startswith(b"id:"):
                eid = int(ln[3:].strip())
            elif ln.startswith(b"data:"):
                data = json.loads(ln[5:].strip())
        out.append(("" if comment else event, eid, data))
    return out


def _entry(services, agent_id: str, rid: str) -> dict:
    """A journal entry up to ids, times and the servers' own headers."""
    req = services.journal.get(agent_id, rid)
    resp = req.response or {}
    body = base64.b64decode(resp["body_b64"]) if resp.get("body_b64") else None
    return {"status": req.status, "stream_offset": req.stream_offset, "retry_count": req.retry_count,
            "error": req.error, "response_status": resp.get("status_code"),
            "response": json.loads(body) if body else None}


STREAM_CASES = {
    "failover_splice": [emit_then_die(2), resume_to_done(5)],
    "duplicates": [emit_then_die(2), resume_to_done(5, ignore_floor=1)],
    "gap": [gap_leg],
    "hangup": [hang_leg],
    "resume": [emit_then_die(3), resume_to_done(5)],
    "poison": [poisoned_leg],
    "flag_off": [],
}


@contextlib.asynccontextmanager
async def _daemon(kind: str, tmp_path, streaming: bool):
    """(services, base URL) of the reference's daemon (aiohttp) or the
    port's (its own server), with one echo agent on the fake backend."""
    if kind == "ref":
        services = make_reference(tmp_path / "ref", streaming=streaming)
        server = TestServer(services.app, host="127.0.0.1")
        await server.start_server()
        try:
            yield services, f"http://127.0.0.1:{server.port}"
        finally:
            await server.close()
    else:
        services = make_services(tmp_path / "port", streaming=streaming)
        server = await start_daemon(services, "127.0.0.1", 0)
        try:
            yield services, f"http://127.0.0.1:{services.public_port}"
        finally:
            await stop_daemon(services, server)


async def _drive_stream_case(kind: str, tmp_path, case: str) -> dict:
    stub = StubUpstream(STREAM_CASES[case])
    upstream = TestServer(stub.app(), host="127.0.0.1")
    await upstream.start_server()
    out: dict = {}
    try:
        async with _daemon(kind, tmp_path, streaming=case != "flag_off") as (services, url):
            async with ClientSession() as http:
                async with http.post(url + "/agents", json={"name": "a", "model": "echo"},
                                     headers=AUTH) as r:
                    aid = (await r.json())["data"]["id"]
                async with http.post(f"{url}/agents/{aid}/start", headers=AUTH) as r:
                    assert r.status == 200
                if case != "flag_off":
                    stub_url = f"http://127.0.0.1:{upstream.port}"
                    services.manager.endpoint = lambda a: stub_url
                chat = {"message": "hi", "session": "s", "stream": case != "poison"}
                t0 = time.monotonic()
                resp = await http.post(f"{url}/agent/{aid}/chat", json=chat)
                out["status"] = resp.status
                out["sse"] = resp.headers.get("Content-Type", "").startswith(STREAM_CONTENT_TYPE)
                rid = resp.headers.get(REQUEST_ID_HEADER, "")
                if case == "hangup":
                    await resp.content.read(8)  # the stream is live
                    resp.close()  # the consumer hangs up mid-stream
                    while not stub.cancels and time.monotonic() - t0 < 5:
                        await asyncio.sleep(0.02)
                    await asyncio.sleep(0.1)
                else:
                    raw = await resp.read()
                    out["events"] = parse_sse(raw) if out["sse"] else None
                    out["keepalive"] = b": keep-alive\n\n" in raw
                if case == "resume":
                    out["pending_before"] = services.journal.stats(aid)["pending"]
                    async with http.post(f"{url}/agent/{aid}/chat", json=chat,
                                         headers={LAST_EVENT_ID_HEADER: "3", REQUEST_ID_HEADER: rid}) as r2:
                        out["resume_rid_echoed"] = r2.headers.get(REQUEST_ID_HEADER) == rid
                        out["resume_events"] = parse_sse(await r2.read())
                    out["pending_after"] = services.journal.stats(aid)["pending"]
                if case == "poison":
                    out["before_replay"] = _entry(services, aid, rid)
                    out["replayed"] = await services.replay.scan_once()
                if rid:
                    out["entry"] = _entry(services, aid, rid)
                out["floors"] = [c["floor"] for c in stub.calls]
                out["rid_forwarded"] = all(c["request_id"] == rid for c in stub.calls)
                out["cancelled"] = [c == rid for c in stub.cancels]
    finally:
        await upstream.close()
    return out


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_proxy_stream_legs_match_reference(tmp_path, case):
    want = run(_drive_stream_case("ref", tmp_path, case))
    got = run(_drive_stream_case("port", tmp_path, case))
    assert got == want
    toks = [e[1] for e in (got.get("events") or []) if e[0] == "token"]
    done = [e for e in (got.get("events") or []) if e[0] == "done"]
    if case in ("failover_splice", "duplicates"):
        # one gapless, duplicate-free sequence across the upstream's death
        assert toks == [0, 1, 2, 3, 4, 5] and len(done) == 1
        assert got["entry"]["status"] == RequestStatus.COMPLETED
        assert got["entry"]["stream_offset"] == 5 and got["entry"]["response"] == _DONE_PAYLOAD
        assert got["floors"] == ["", "2"] and got["rid_forwarded"]
    if case == "failover_splice":
        assert got["keepalive"]
    if case == "gap":
        assert toks == [0] and not done and [e[0] for e in got["events"]].count("error") == 1
        assert got["entry"]["status"] != RequestStatus.COMPLETED
        assert got["entry"]["stream_offset"] == 0
    if case == "hangup":
        assert got["cancelled"] == [True]
        assert got["entry"]["status"] == RequestStatus.EXPIRED and got["entry"]["stream_offset"] == 0
        assert "client disconnected" in got["entry"]["error"]
    if case == "resume":
        assert got["resume_rid_echoed"] and got["pending_after"] == got["pending_before"]
        assert [e[1] for e in got["resume_events"] if e[0] == "token"] == [4, 5]
        assert got["entry"]["status"] == RequestStatus.COMPLETED
    if case == "poison":
        assert got["status"] == 500 and got["before_replay"]["status"] == RequestStatus.PENDING
        assert got["before_replay"]["retry_count"] == 1 and got["replayed"] == 1
        assert got["entry"]["status"] == RequestStatus.FAILED
        assert got["entry"]["error"].startswith("poisoned prefill:")
    if case == "flag_off":
        assert got["status"] == 200 and not got["sse"]
