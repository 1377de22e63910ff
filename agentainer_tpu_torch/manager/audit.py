"""Structured logging + audit plane.

Re-implements the reference logger (internal/logging/logger.go): structured
JSON entries written to (a) files under the data dir, (b) store sorted sets
``logs:entries`` / ``audit:entries`` scored by timestamp with 7-day trim,
(c) the console; plus query APIs with level/component/agent/user/action
filters (logger.go:201-290) and a ``logs:stream`` pub/sub channel for tailing
(logger.go:459-493). File rotation is size-based (logger.go:375-452).

Reference: ``agentainer_tpu/manager/audit.py``, copied.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any

from ..store.base import Store
from ..store.schema import Keys, LOG_RETENTION_S

MAX_LOG_FILE_BYTES = 100 * 1024 * 1024  # logger.go rotation threshold

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


class LogPlane:
    def __init__(self, store: Store, data_dir: str | os.PathLike | None = None, console: bool = True):
        self.store = store
        self.console = console
        self._lock = threading.Lock()
        self._files: dict[str, Any] = {}
        self.log_dir: Path | None = None
        if data_dir is not None:
            self.log_dir = Path(data_dir).expanduser() / "logs"
            self.log_dir.mkdir(parents=True, exist_ok=True)

    # -- write paths -----------------------------------------------------
    def log(
        self,
        level: str,
        component: str,
        message: str,
        agent_id: str = "",
        **fields: Any,
    ) -> dict[str, Any]:
        entry = {
            "ts": time.time(),
            "level": level,
            "component": component,
            "message": message,
        }
        if agent_id:
            entry["agent_id"] = agent_id
        if fields:
            entry["fields"] = fields
        self._write(Keys.LOGS, "agentainer.log", entry)
        self.store.publish(Keys.LOG_STREAM, json.dumps(entry))
        if self.console:
            ts = time.strftime("%H:%M:%S", time.localtime(entry["ts"]))
            print(f"[{ts}] {level.upper():5s} {component}: {message}", file=sys.stderr)
        return entry

    def debug(self, component: str, message: str, **kw: Any) -> None:
        self.log("debug", component, message, **kw)

    def info(self, component: str, message: str, **kw: Any) -> None:
        self.log("info", component, message, **kw)

    def warn(self, component: str, message: str, **kw: Any) -> None:
        self.log("warn", component, message, **kw)

    def error(self, component: str, message: str, **kw: Any) -> None:
        self.log("error", component, message, **kw)

    def audit(
        self,
        user: str,
        action: str,
        resource: str,
        result: str,
        ip: str = "",
        user_agent: str = "",
        details: dict[str, Any] | None = None,
    ) -> dict[str, Any]:
        """Every management mutation is audited with actor/IP/UA/result
        (reference server.go:195-227)."""
        entry = {
            "ts": time.time(),
            "user": user,
            "action": action,
            "resource": resource,
            "result": result,
            "ip": ip,
            "user_agent": user_agent,
            "details": details or {},
        }
        self._write(Keys.AUDIT, "audit.log", entry)
        return entry

    def _write(self, zset_key: str, filename: str, entry: dict[str, Any]) -> None:
        raw = json.dumps(entry, separators=(",", ":"))
        now = entry["ts"]
        self.store.zadd(zset_key, now, f"{now}:{raw}")
        self.store.zremrangebyscore(zset_key, 0, now - LOG_RETENTION_S)
        if self.log_dir is not None:
            with self._lock:
                path = self.log_dir / filename
                try:
                    if path.exists() and path.stat().st_size > MAX_LOG_FILE_BYTES:
                        path.rename(path.with_suffix(f".{int(now)}.old"))
                    with open(path, "a") as f:
                        f.write(raw + "\n")
                except OSError:
                    pass

    # -- query paths (logger.go:201-290) --------------------------------
    def _query(self, zset_key: str, since: float, until: float, limit: int) -> list[dict[str, Any]]:
        out = []
        for member in self.store.zrangebyscore(zset_key, since, until):
            _, _, raw = member.decode().partition(":")
            try:
                out.append(json.loads(raw))
            except json.JSONDecodeError:
                continue
        return out[-limit:]

    def get_logs(
        self,
        level: str = "",
        component: str = "",
        agent_id: str = "",
        since: float = 0,
        until: float = 1e15,
        limit: int = 100,
    ) -> list[dict[str, Any]]:
        entries = self._query(Keys.LOGS, since, until, limit=10 * limit)
        min_level = LEVELS.get(level, 0)
        out = [
            e
            for e in entries
            if LEVELS.get(e.get("level"), 0) >= min_level
            and (not component or e.get("component") == component)
            and (not agent_id or e.get("agent_id") == agent_id)
        ]
        return out[-limit:]

    def get_audit(
        self,
        user: str = "",
        action: str = "",
        resource: str = "",
        since: float = 0,
        until: float = 1e15,
        limit: int = 100,
    ) -> list[dict[str, Any]]:
        entries = self._query(Keys.AUDIT, since, until, limit=10 * limit)
        out = [
            e
            for e in entries
            if (not user or e.get("user") == user)
            and (not action or e.get("action") == action)
            and (not resource or resource in e.get("resource", ""))
        ]
        return out[-limit:]


def warn_fallback(logs, component: str, msg: str, agent_id: str = "") -> bool:
    """Warn through the (store-backed) log plane, falling back to stdout
    when the plane itself is down or absent. Returns False only when the
    plane FAILED, so callers can count log-plane outages — the fleet
    monitor and fleet repair share this instead of each carrying its own
    copy of the try/warn/print dance."""
    if logs is not None:
        try:
            logs.warn(component, msg, agent_id=agent_id)
            return True
        except Exception:
            # the log plane rides the same store that may be mid-outage:
            # degrade to stdout, visibly, and report the failure
            print(f"[{component}] {msg} (log plane unavailable)", flush=True)
            return False
    print(f"[{component}] {msg}", flush=True)
    return True
