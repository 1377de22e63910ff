"""Async store client for engine processes.

Reference: ``agentainer_tpu/runtime/store_client.py``. Engines reach the
daemon's store over HTTP (``AGENTAINER_CONTROL_URL`` + ``/internal/store``):
JSON ops namespaced to the agent's ``agent:{id}:*`` keys, authenticated
with the per-engine token, with bounded retry and jittered backoff for
transport errors and the ``store_client.rpc`` failpoint inside the retry
loop — on the standard library (``utils/http``). With no control plane
configured (standalone engine runs, unit tests) it falls back to
process-local memory, whose state dies with the process.

The reference's faster path, the native store's binary protocol over a
unix socket (``AGENTAINER_STORE_SOCK``), comes with the native-store slice
of the port: a socket named with no control URL raises, and beside one the
HTTP path is used.
"""

from __future__ import annotations

import asyncio
import base64
import fnmatch
import json
import os
import random
from typing import Any

from .. import faults
from ..core.resilience import backoff_delays
from ..utils import http

# Transport-shaped failures a retry can reasonably fix: the connection died,
# the peer vanished mid-response, or the wait timed out. Everything else —
# protocol violations, auth rejections, programming errors — surfaces
# unchanged.
TRANSIENT_ERRORS = (
    OSError,  # ConnectionError and friends are subclasses
    asyncio.TimeoutError,
    asyncio.IncompleteReadError,
    http.ServerDisconnected,
)

# a KV snapshot rides one op as base64: tens of MB at llama3-8b width
STORE_TIMEOUT_S = 60.0
STORE_SOCK_LATER = (
    "AGENTAINER_STORE_SOCK names the native store's unix socket, which is "
    "not ported yet (the native-store slice); set AGENTAINER_CONTROL_URL"
)


class StoreClient:
    def __init__(
        self,
        control_url: str = "",
        token: str = "",
        agent_id: str = "",
        store_sock: str = "",
        retries: int | None = None,
        retry_base_s: float | None = None,
    ):
        if store_sock and not control_url:
            raise ValueError(STORE_SOCK_LATER)
        self.control_url = control_url.rstrip("/")
        self.token = token
        self.agent_id = agent_id
        self._local: dict[str, Any] = {}  # fallback when no control plane
        # Bounded retry + jittered exponential backoff for TRANSIENT
        # transport errors only. An ack lost in flight can double-apply an
        # rpush on retry: at worst a duplicated conversation turn, which the
        # durability guarantee tolerates (the reference's caveat).
        if retries is None:
            try:
                retries = int(os.environ.get("ATPU_STORE_RETRIES", "3"))
            except ValueError:
                retries = 3
        if retry_base_s is None:
            try:
                retry_base_s = float(os.environ.get("ATPU_STORE_RETRY_BASE_S", "0.05"))
            except ValueError:
                retry_base_s = 0.05
        self.retries = max(0, retries)
        self.retry_base_s = retry_base_s
        self._retry_rng = random.Random(0xA70)  # deterministic jitter
        self.retries_total = 0
        self.transient_errors_total = 0

    @classmethod
    def from_env(cls) -> "StoreClient":
        return cls(
            control_url=os.environ.get("AGENTAINER_CONTROL_URL", ""),
            token=os.environ.get("AGENTAINER_INTERNAL_TOKEN", ""),
            agent_id=os.environ.get("AGENTAINER_AGENT_ID", ""),
            store_sock=os.environ.get("AGENTAINER_STORE_SOCK", ""),
        )

    @property
    def connected(self) -> bool:
        return bool(self.control_url)

    async def close(self) -> None:
        """Nothing to release: every op opens its own connection."""

    async def _post(self, payload: dict[str, Any], label: str) -> Any:
        status, _, raw = await http.request(
            "POST",
            f"{self.control_url}/internal/store",
            {
                "Authorization": f"Bearer {self.token}",
                "X-Agentainer-Agent-ID": self.agent_id,
                "Content-Type": "application/json",
            },
            json.dumps(payload).encode(),
            timeout=STORE_TIMEOUT_S,
        )
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = {"message": raw[:200].decode("utf-8", "replace")}
        if status != 200:
            raise RuntimeError(f"store {label} failed: {doc.get('message')}")
        return doc.get("data")

    async def _with_retry(self, attempt):
        """Run one transport attempt, retrying TRANSIENT_ERRORS on the
        jittered backoff schedule (built lazily on the first failure, so
        the jitter sequence is a function of failures); anything else
        surfaces immediately."""
        delays: list[float] | None = None
        n = 0
        while True:
            try:
                return await attempt()
            except TRANSIENT_ERRORS:
                self.transient_errors_total += 1
                if delays is None:
                    delays = backoff_delays(
                        self.retries, base_s=self.retry_base_s, rng=self._retry_rng
                    )
                if n >= len(delays):
                    raise
                self.retries_total += 1
                await asyncio.sleep(delays[n])
                n += 1

    async def _op(self, op: str, key: str, **kw: Any) -> Any:
        if not self.connected:
            return self._local_op(op, key, **kw)

        async def attempt():
            # failpoint cut INSIDE the retry loop: an injected transient
            # error exercises the recovery path, not just the failure path
            await faults.fire_async("store_client.rpc")
            return await self._post({"op": op, "key": key, **kw}, f"op {op}")

        return await self._with_retry(attempt)

    async def pipeline(self, ops: list[dict[str, Any]]) -> list[Any]:
        """Run a batch of ops in one round-trip (each: {op, key, ...})."""
        if not self.connected:
            return [
                self._local_op(
                    o["op"], o["key"], **{k: v for k, v in o.items() if k not in ("op", "key")}
                )
                for o in ops
            ]

        async def attempt():
            await faults.fire_async("store_client.rpc")
            return await self._post({"op": "pipeline", "ops": ops}, "pipeline") or []

        return await self._with_retry(attempt)

    def _local_op(self, op: str, key: str, **kw: Any) -> Any:
        d = self._local
        if op == "get":
            return d.get(key)
        if op == "set":
            d[key] = kw.get("value", "")
            return None
        if op == "set_b64":
            d[key] = kw.get("value_b64", "")
            return None
        if op == "get_b64":
            return d.get(key)
        if op == "delete":
            return 1 if d.pop(key, None) is not None else 0
        if op == "expire":
            # no expiry sweeper: standalone state dies with the process
            return 1 if key in d else 0
        if op == "rpush":
            d.setdefault(key, []).extend(kw.get("values", []))
            return len(d[key])
        if op == "lrange":
            lst = d.get(key, [])
            stop = kw.get("stop", -1)
            return lst[kw.get("start", 0) : (stop + 1 if stop != -1 else None)]
        if op == "ltrim":
            lst = d.get(key, [])
            stop = kw.get("stop", -1)
            d[key] = lst[kw.get("start", 0) : (stop + 1 if stop != -1 else None)]
            return None
        if op == "llen":
            return len(d.get(key, []))
        if op == "hincrby":
            h = d.setdefault(key, {})
            h[kw.get("field", "")] = int(h.get(kw.get("field", ""), 0)) + kw.get("amount", 1)
            return h[kw.get("field", "")]
        if op == "hgetall":
            return {k: str(v) for k, v in d.get(key, {}).items()}
        if op == "keys":
            return [k for k in d if fnmatch.fnmatchcase(k, kw.get("pattern", key + "*"))]
        raise ValueError(f"unknown op {op}")

    # -- typed helpers ---------------------------------------------------
    async def get(self, key: str) -> str | None:
        return await self._op("get", key)

    async def set(self, key: str, value: str, ttl: float | None = None) -> None:
        await self._op("set", key, value=value, ttl=ttl)

    async def set_bytes(self, key: str, blob: bytes, ttl: float | None = None) -> None:
        await self._op("set_b64", key, value_b64=base64.b64encode(blob).decode(), ttl=ttl)

    async def get_bytes(self, key: str) -> bytes | None:
        raw = await self._op("get_b64", key)
        return None if raw is None else base64.b64decode(raw)

    async def delete(self, key: str) -> int:
        return await self._op("delete", key)

    async def expire(self, key: str, ttl: float) -> bool:
        return bool(await self._op("expire", key, ttl=ttl))

    async def rpush(self, key: str, *values: str) -> int:
        return await self._op("rpush", key, values=list(values))

    async def lrange(self, key: str, start: int = 0, stop: int = -1) -> list[str]:
        return await self._op("lrange", key, start=start, stop=stop) or []

    async def ltrim(self, key: str, start: int, stop: int) -> None:
        await self._op("ltrim", key, start=start, stop=stop)

    async def llen(self, key: str) -> int:
        return await self._op("llen", key) or 0

    async def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        return await self._op("hincrby", key, field=field, amount=amount)

    async def hgetall(self, key: str) -> dict[str, str]:
        return await self._op("hgetall", key) or {}

    async def keys(self, pattern: str) -> list[str]:
        return await self._op("keys", pattern.split("*")[0], pattern=pattern) or []
