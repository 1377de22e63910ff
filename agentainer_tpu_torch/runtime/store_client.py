"""Async store client for engine processes.

Reference: ``agentainer_tpu/runtime/store_client.py``. Engines reach the
daemon's store two ways, the faster first:

- **unix socket, binary protocol** (``AGENTAINER_STORE_SOCK``, served by
  the C++ data plane beside the native store): frames of the native wire
  encoding (``store/native.py``'s codec, ``native/common.h``) straight into
  the C++ store, through a small pool of connections (``_UDSPool``), each
  authenticated once with the per-engine token and namespaced by the C++
  to the agent's ``agent:{id}:*`` keys, one frame in flight per
  connection; a KV snapshot travels as raw bytes. A frame above 64 MiB
  closes the connection (the reference's cap, ``native/dataplane.cc``);
- **HTTP** (``AGENTAINER_CONTROL_URL`` + ``/internal/store``): JSON ops
  (a snapshot as base64) on the standard library (``utils/http``).

Both carry single ops and pipelines with bounded retry and jittered
backoff for transport errors, and the ``store_client.rpc`` failpoint inside
the retry loop. With neither configured (standalone engine runs, unit
tests) the client falls back to process-local memory, whose state dies
with the process.
"""

from __future__ import annotations

import asyncio
import base64
import fnmatch
import json
import os
import random
import struct
from typing import Any

from .. import faults
from ..core.resilience import backoff_delays
from ..store import native as _wire
from ..utils import http
from .dataplane import socket_address

_enc = _wire.encode_request
_dec = _wire.decode_response

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

# a KV snapshot rides one op: tens of MB at llama3-8b width
STORE_TIMEOUT_S = 60.0


class _UDSPool:
    """Small pool of authenticated unix-socket connections to the native
    store; one frame in flight per connection."""

    def __init__(self, path: str, agent_id: str, token: str, size: int = 4):
        self.path = path
        self.agent_id = agent_id
        self.token = token
        self.size = size
        self._free: asyncio.Queue | None = None
        self._made = 0
        self._lock: asyncio.Lock | None = None

    async def _connect(self):
        with socket_address(self.path) as address:
            reader, writer = await asyncio.open_unix_connection(address)
        frame = _enc(_wire.OP_AUTH, [self.agent_id.encode(), self.token.encode()])
        writer.write(struct.pack("<I", len(frame)) + frame)
        await writer.drain()
        status, vals = await self._read_resp(reader)
        if status != _wire.RESP_OK:
            writer.close()
            raise RuntimeError(f"store auth failed: {vals[0].decode() if vals else 'unknown'}")
        return reader, writer

    @staticmethod
    async def _read_resp(reader) -> tuple[int, list[bytes]]:
        (n,) = struct.unpack("<I", await reader.readexactly(4))
        return _dec(await reader.readexactly(n))

    async def roundtrip(self, frame: bytes) -> tuple[int, list[bytes]]:
        if self._free is None:
            self._free, self._lock = asyncio.Queue(), asyncio.Lock()
        conn = None
        if self._free.empty() and self._made < self.size:
            async with self._lock:
                if self._made < self.size:
                    self._made += 1
                    try:
                        conn = await self._connect()
                    except BaseException:
                        # any failure gives the slot back (leaking it would
                        # shrink the pool for good); the error propagates
                        self._made -= 1
                        raise
        if conn is None:
            conn = await self._free.get()
        reader, writer = conn
        try:
            writer.write(struct.pack("<I", len(frame)) + frame)
            await writer.drain()
            resp = await self._read_resp(reader)
        except BaseException as e:
            # the connection may be dead or mid-frame: drop it (the next
            # call dials afresh); a transport error is the caller's retry's
            # to judge, anything else surfaces as what it is
            self._made -= 1
            writer.close()
            if not isinstance(e, (asyncio.CancelledError, *TRANSIENT_ERRORS)):
                print(f"[store-client] non-transport error on store socket: {type(e).__name__}: {e}", flush=True)
            raise
        self._free.put_nowait(conn)
        return resp

    def close(self) -> None:
        while self._free is not None and not self._free.empty():
            _, writer = self._free.get_nowait()
            writer.close()
        self._made = 0


# op name → opcode for the socket path ("delete" is OP_DEL; the raw-bytes
# ops carry a snapshot without base64)
_OP_NUM = {
    "get": _wire.OP_GET, "get_b64": _wire.OP_GET, "get_raw": _wire.OP_GET,
    "set": _wire.OP_SET, "set_b64": _wire.OP_SET, "set_raw": _wire.OP_SET,
    "delete": _wire.OP_DEL, "expire": _wire.OP_EXPIRE, "rpush": _wire.OP_RPUSH,
    "lrange": _wire.OP_LRANGE, "ltrim": _wire.OP_LTRIM, "llen": _wire.OP_LLEN,
    "hincrby": _wire.OP_HINCRBY, "hgetall": _wire.OP_HGETALL, "keys": _wire.OP_KEYS,
}


def _encode_sub(op: str, key: str, kw: dict) -> bytes:
    """One op of the HTTP store API's shape as a native frame."""
    if op not in _OP_NUM:
        raise ValueError(f"op {op!r} not supported over the store socket")
    k, num = key.encode(), _OP_NUM[op]

    def ttl_arg() -> bytes:
        return b"" if kw.get("ttl") is None else repr(float(kw["ttl"])).encode()

    if op == "set":
        return _enc(num, [k, str(kw.get("value", "")).encode(), ttl_arg()])
    if op == "set_b64":
        return _enc(num, [k, base64.b64decode(kw.get("value_b64", "")), ttl_arg()])
    if op == "set_raw":
        return _enc(num, [k, kw["value"], ttl_arg()])
    if op == "expire":
        return _enc(num, [k, repr(float(kw.get("ttl", 0))).encode()])
    if op == "rpush":
        return _enc(num, [k] + [str(v).encode() for v in kw.get("values", [])])
    if op in ("lrange", "ltrim"):
        return _enc(num, [k, str(kw.get("start", 0)).encode(), str(kw.get("stop", -1)).encode()])
    if op == "hincrby":
        return _enc(num, [k, str(kw.get("field", "")).encode(), str(kw.get("amount", 1)).encode()])
    if op == "keys":
        return _enc(num, [str(kw.get("pattern", key + "*")).encode()])
    return _enc(num, [k])  # get, get_b64, get_raw, delete, llen, hgetall


def _decode_result(op: str, status: int, vals: list[bytes]) -> Any:
    """A native response in the HTTP store API's result shape."""
    if status == _wire.RESP_ERR:
        raise RuntimeError(vals[0].decode("utf-8", "replace") if vals else "store error")
    if status == _wire.RESP_NIL:
        return None
    if op == "get":
        return vals[0].decode("utf-8", "replace") if vals else None
    if op == "get_b64":
        return base64.b64encode(vals[0]).decode() if vals else None
    if op == "get_raw":
        return vals[0] if vals else None
    if op in ("delete", "rpush", "llen", "hincrby", "expire"):
        return int(vals[0]) if vals else 0
    if op in ("lrange", "keys"):
        return [v.decode("utf-8", "replace") for v in vals]
    if op == "hgetall":
        return {
            vals[i].decode("utf-8", "replace"): vals[i + 1].decode("utf-8", "replace")
            for i in range(0, len(vals), 2)
        }
    return None  # set, set_b64, set_raw, ltrim


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
        self.control_url = control_url.rstrip("/")
        self.token = token
        self.agent_id = agent_id
        self.store_sock = store_sock
        self._local: dict[str, Any] = {}  # fallback when no control plane
        self._uds = _UDSPool(store_sock, agent_id, token) if store_sock and agent_id and token else None
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
        return bool(self.control_url) or self._uds is not None

    async def close(self) -> None:
        """Close the socket pool's idle connections (an HTTP op opens and
        closes its own)."""
        if self._uds is not None:
            self._uds.close()

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
            if self._uds is not None:
                return _decode_result(op, *await self._uds.roundtrip(_encode_sub(op, key, kw)))
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
            if self._uds is not None:
                subs = [
                    _encode_sub(o["op"], o["key"], {k: v for k, v in o.items() if k not in ("op", "key")})
                    for o in ops
                ]
                status, vals = await self._uds.roundtrip(_enc(_wire.OP_PIPELINE, subs))
                if status != _wire.RESP_OK:
                    raise RuntimeError(vals[0].decode("utf-8", "replace") if vals else "pipeline failed")
                return [_decode_result(o["op"], *_dec(raw)) for o, raw in zip(ops, vals)]
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
        if self._uds is not None:
            await self._op("set_raw", key, value=bytes(blob), ttl=ttl)
        else:
            await self._op("set_b64", key, value_b64=base64.b64encode(blob).decode(), ttl=ttl)

    async def get_bytes(self, key: str) -> bytes | None:
        if self._uds is not None:
            return await self._op("get_raw", key)
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
