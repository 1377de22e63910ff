"""Backup / restore — durable snapshots of the control plane's desired state.

Reference: ``agentainer_tpu/manager/backup.py``, an own copy writing the
same manifest, so a backup written by either package restores in the
other. A backup is a JSON manifest ``backup-{ns}.json`` under
``<data_dir>/backups`` (``version`` "1") holding every agent record and
each agent's application state in the store: ``conversations``,
``conversations_by_session`` and its KV-cache snapshots as base64
(``kvcache``). Restore re-deploys each agent with a ``-restored`` name
suffix (kept under deploy's 64-character cap) and copies its histories
and KV blobs to the new agent id, each record on its own (one that fails
is reported beside the rest); export bundles one manifest into a tar.gz
under ``backups/exports/`` only.

A KV blob (``engine/checkpoint.py``'s npz, ``SNAP_VERSION`` 3) keeps in
its header the engine-side session it was taken under, the old agent's id
in it, but no restore reads that field: the serve layer finds the blob by
``agent:{id}:kvcache:{session}`` and restores it into the session it
names, so the restored agent's first turn in a session continues from the
copied KV instead of prefilling its history again.
"""

from __future__ import annotations

import base64
import json
import tarfile
import time
import uuid
from pathlib import Path

from ..core.errors import InvalidInput
from ..core.spec import Agent
from ..manager.agents import AgentManager
from ..store.base import Store
from ..store.schema import Keys


class BackupManager:
    def __init__(self, manager: AgentManager, store: Store, data_dir: str | Path):
        self.manager = manager
        self.store = store
        self.dir = Path(data_dir).expanduser() / "backups"
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, backup_id: str) -> Path:
        if "/" in backup_id or ".." in backup_id:
            raise InvalidInput(f"bad backup id: {backup_id}")
        return self.dir / f"{backup_id}.json"

    def create(self, name: str = "", description: str = "") -> dict:
        # nanosecond id: two backups in the same second must not collide
        backup_id = f"backup-{time.time_ns()}"
        agents = self.manager.list_agents(sync_first=False)
        manifest = {
            "id": backup_id,
            "name": name or backup_id,
            "description": description,
            "created_at": time.time(),
            "version": "1",
            "agents": [a.to_dict() for a in agents],
            "app_state": {a.id: self._app_state(a.id) for a in agents},
        }
        self._path(backup_id).write_text(json.dumps(manifest, indent=2))
        return {k: manifest[k] for k in ("id", "name", "description", "created_at")} | {
            "agents": len(agents)
        }

    def _app_state(self, agent_id: str) -> dict:
        state: dict = {}
        convo = self.store.lrange(Keys.conversations(agent_id), 0, -1)
        if convo:
            state["conversations"] = [c.decode("utf-8", "replace") for c in convo]
        # per-session conversation lists (the serve layer's write target)
        by_session = {}
        for key in self.store.keys(Keys.conversations_pattern(agent_id)):
            lines = self.store.lrange(key, 0, -1)
            if lines:
                session = key.split(":conversations:", 1)[-1]
                by_session[session] = [c.decode("utf-8", "replace") for c in lines]
        if by_session:
            state["conversations_by_session"] = by_session
        kv_keys = self.store.keys(Keys.kvcache_pattern(agent_id))
        if kv_keys:
            state["kvcache"] = {
                k: base64.b64encode(self.store.get(k) or b"").decode() for k in kv_keys
            }
        return state

    def list(self) -> list[dict]:
        out = []
        for path in sorted(self.dir.glob("backup-*.json")):
            try:
                m = json.loads(path.read_text())
                out.append(
                    {
                        "id": m["id"],
                        "name": m.get("name", ""),
                        "description": m.get("description", ""),
                        "created_at": m.get("created_at", 0),
                        "agents": len(m.get("agents", [])),
                    }
                )
            except (json.JSONDecodeError, KeyError):
                continue
        return out

    def restore(self, backup_id: str) -> list[dict]:
        path = self._path(backup_id)
        if not path.exists():
            raise InvalidInput(f"backup not found: {backup_id}")
        manifest = json.loads(path.read_text())
        restored = []
        errors = []
        for record in manifest.get("agents", []):
            try:
                old = Agent.from_dict(record)
                suffix = "-restored"  # manager.go:156-191 parity
                name = old.name[: 64 - len(suffix)] + suffix  # respect deploy's 64-char cap
                agent = self.manager.deploy(
                    name=name,
                    model=old.model,
                    env=old.env,
                    resources=old.resources,
                    auto_restart=old.auto_restart,
                    token=old.token,
                    health_check=old.health_check,
                )
                state = manifest.get("app_state", {}).get(old.id, {})
                for line in state.get("conversations", []):
                    self.store.rpush(Keys.conversations(agent.id), line)
                for session, lines in state.get("conversations_by_session", {}).items():
                    for line in lines:
                        self.store.rpush(
                            Keys.conversations_session(agent.id, session), line
                        )
                for key, blob_b64 in state.get("kvcache", {}).items():
                    session = key.rsplit(":", 1)[-1]
                    self.store.set(Keys.kvcache(agent.id, session), base64.b64decode(blob_b64))
                restored.append(agent.to_dict())
            except Exception as e:  # one bad record must not abort the rest
                errors.append({"agent": record.get("name", "?"), "error": str(e)})
        if errors and not restored:
            raise InvalidInput(f"restore failed for all agents: {errors}")
        for err in errors:
            restored.append({"restore_error": err})
        return restored

    def delete(self, backup_id: str) -> None:
        path = self._path(backup_id)
        if not path.exists():
            raise InvalidInput(f"backup not found: {backup_id}")
        path.unlink()

    def export(self, backup_id: str, out_path: str | Path | None = None) -> Path:
        """Bundle one backup into a tar.gz. The destination is confined to
        the daemon's ``backups/exports/`` directory — client-supplied paths
        would otherwise be an arbitrary-file-overwrite primitive for any
        bearer-token holder; the HTTP layer streams the bytes back instead."""
        path = self._path(backup_id)
        if not path.exists():
            raise InvalidInput(f"backup not found: {backup_id}")
        exports = self.dir / "exports"
        exports.mkdir(parents=True, exist_ok=True)
        # sweep artifacts abandoned by cancelled/disconnected exports (the
        # HTTP layer deletes its own after streaming; anything older than an
        # hour was orphaned) so the directory cannot grow without bound
        cutoff = time.time() - 3600
        for stale in exports.glob("*.tar.gz"):
            try:
                if stale.stat().st_mtime < cutoff:
                    stale.unlink()
            except OSError:
                pass
        name = Path(str(out_path)).name if out_path else f"{backup_id}.tar.gz"
        if not name.endswith(".tar.gz"):
            name += ".tar.gz"
        # unique artifact per export: a concurrent re-export of the same
        # backup must never rewrite a file another response is still
        # streaming; the HTTP layer deletes it after the stream ends
        out = exports / f"{uuid.uuid4().hex}-{name}"
        with tarfile.open(out, "w:gz") as tar:
            tar.add(path, arcname=path.name)
        return out
