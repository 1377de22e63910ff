"""NativeStore — ctypes binding over the C++ store (native/store.cc).

Reference: ``agentainer_tpu/store/native.py``, copied: the same ``Store``
over the native library (``agentainer_tpu_torch/native.py`` builds and
loads it), the same wire codec (``encode_request``/``decode_response``,
the ``OP_*`` numbers of ``native/common.h``'s ``Op`` enum, which are the
engines' unix-socket protocol too), subscriptions polled natively,
``on_message`` poller threads, ``cas`` under a Python lock, ``aof_flush``,
the raw ``handle`` the data plane shares, ``close`` that waits for every
thread to leave native code, and the ``store.*`` failpoints (through the
port's ``faults``).

The store gives (1) GIL-free access for the C++ data plane, whose proxy
threads journal requests into the same store object, and (2) durability
across daemon restarts through the append-only file (AOF): every mutation
is written and flushed before it is acknowledged and replayed on reopen,
TTLs as absolute deadlines — the role Redis persistence plays for the
original project.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Any, Callable

from .. import faults
from ..native import load
from .base import Store, Subscription, _to_bytes

# Opcodes — native/common.h's enum Op, number for number.
OP_SET = 1
OP_GET = 2
OP_DEL = 3
OP_EXISTS = 4
OP_KEYS = 5
OP_EXPIRE = 6
OP_TTL = 7
OP_SADD = 8
OP_SREM = 9
OP_SMEMBERS = 10
OP_RPUSH = 11
OP_LPUSH = 12
OP_LREM = 13
OP_LRANGE = 14
OP_LLEN = 15
OP_LTRIM = 16
OP_ZADD = 17
OP_ZRANGEBYSCORE = 18
OP_ZREMRANGEBYSCORE = 19
OP_ZCARD = 20
OP_HSET = 21
OP_HINCRBY = 22
OP_HGETALL = 23
OP_PUBLISH = 24
OP_FLUSH = 25
OP_PIPELINE = 26
OP_AUTH = 27
OP_SETEXAT = 28  # the AOF's replay form of SET (absolute deadline)
OP_EXPIREAT = 29  # the AOF's replay form of EXPIRE

RESP_OK = 0
RESP_ERR = 1
RESP_NIL = 2


def encode_request(op: int, args: list[bytes]) -> bytes:
    out = [struct.pack("<BI", op, len(args))]
    for a in args:
        out.append(struct.pack("<I", len(a)))
        out.append(a)
    return b"".join(out)


def decode_response(buf: bytes) -> tuple[int, list[bytes]]:
    status = buf[0]
    (count,) = struct.unpack_from("<I", buf, 1)
    vals = []
    pos = 5
    for _ in range(count):
        (alen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        vals.append(buf[pos : pos + alen])
        pos += alen
    return status, vals


class NativeSubscription(Subscription):
    """Subscription backed by the C++ store's queue; get() polls natively
    (GIL released during the ctypes call)."""

    def __init__(self, patterns: tuple[str, ...], store: "NativeStore", sub_id: int):
        super().__init__(patterns, lambda _sub: store._sub_close(sub_id))
        self._store = store
        self._sub_id = sub_id

    def get(self, timeout: float | None = None) -> tuple[str, str] | None:
        deadline = None if timeout is None else (timeout if timeout > 0 else 0)
        # bounded native waits so Ctrl-C / interpreter exit stay responsive
        remaining = deadline
        while True:
            step_ms = 200 if remaining is None else int(min(remaining, 0.2) * 1000)
            got = self._store._sub_poll(self._sub_id, step_ms)
            if got is not None:
                return got
            if remaining is not None:
                remaining -= 0.2
                if remaining <= 0:
                    return None

    def drain(self) -> list[tuple[str, str]]:
        out = []
        while True:
            got = self._store._sub_poll(self._sub_id, 0)
            if got is None:
                return out
            out.append(got)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._store._sub_close(self._sub_id)


class NativeStore(Store):
    def __init__(self, aof_path: str | None = None):
        self._lib = load()
        if self._lib is None:
            from ..native import load_error

            raise RuntimeError(f"native store unavailable: {load_error()}")
        self._handle = self._lib.atpu_store_new(
            aof_path.encode() if aof_path else None
        )
        self._cb_threads: list[tuple[threading.Event, threading.Thread]] = []
        self._closed = False
        self.callback_errors_total = 0  # subscriber-callback failures (logged)
        # CAS serialization: the C++ store has no native compare-and-set
        # opcode, so cas() brackets get+set under this lock. That is atomic
        # for every Python-side caller of cas() on this handle — the journal
        # processing transition, its only user — but NOT against raw native
        # writes from the C++ data plane (which never touches journal
        # status fields).
        self._cas_lock = threading.Lock()
        # in-flight native-call accounting: close() must not free the C++
        # store while any thread is inside a lib call on this handle
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    def _enter(self) -> bool:
        with self._inflight_cv:
            if self._closed:
                return False
            self._inflight += 1
            return True

    def _leave(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._inflight_cv.notify_all()

    # -- command plumbing -------------------------------------------------
    def _cmd(self, op: int, *args: bytes | str) -> tuple[int, list[bytes]]:
        req = encode_request(op, [_to_bytes(a) for a in args])
        resp_ptr = ctypes.POINTER(ctypes.c_uint8)()
        resp_len = ctypes.c_size_t()
        if not self._enter():
            raise RuntimeError("store is closed")
        try:
            self._lib.atpu_cmd(
                self._handle, req, len(req), ctypes.byref(resp_ptr), ctypes.byref(resp_len)
            )
        finally:
            self._leave()
        raw = ctypes.string_at(resp_ptr, resp_len.value)
        self._lib.atpu_free(resp_ptr)
        status, vals = decode_response(raw)
        if status == RESP_ERR:
            msg = vals[0].decode("utf-8", "replace") if vals else "error"
            if msg.startswith("WRONGTYPE"):
                raise TypeError(msg)
            raise ValueError(msg)
        return status, vals

    def _int(self, op: int, *args: bytes | str) -> int:
        _, vals = self._cmd(op, *args)
        return int(vals[0]) if vals else 0

    # -- strings ----------------------------------------------------------
    def set(self, key: str, value: bytes | str, ttl: float | None = None) -> None:
        faults.fire("store.set")
        self._cmd(OP_SET, key, value, "" if ttl is None else repr(float(ttl)))

    def get(self, key: str) -> bytes | None:
        faults.fire("store.get")
        status, vals = self._cmd(OP_GET, key)
        return None if status == RESP_NIL else vals[0]

    def delete(self, *keys: str) -> int:
        if not keys:
            return 0
        return self._int(OP_DEL, *keys)

    def exists(self, key: str) -> bool:
        return self._int(OP_EXISTS, key) == 1

    def keys(self, pattern: str = "*") -> list[str]:
        _, vals = self._cmd(OP_KEYS, pattern)
        return [v.decode("utf-8", "replace") for v in vals]

    def expire(self, key: str, ttl: float) -> bool:
        return self._int(OP_EXPIRE, key, repr(float(ttl))) == 1

    def ttl(self, key: str) -> float | None:
        status, vals = self._cmd(OP_TTL, key)
        return None if status == RESP_NIL else float(vals[0])

    def cas(
        self,
        key: str,
        expected: bytes | str | None,
        new: bytes | str,
        ttl: float | None = None,
    ) -> bool:
        faults.fire("store.cas")
        exp = None if expected is None else _to_bytes(expected)
        with self._cas_lock:
            if self.get(key) != exp:
                return False
            if ttl is None:
                ttl = self.ttl(key)
            self.set(key, new, ttl=ttl)
            return True

    # -- sets -------------------------------------------------------------
    def sadd(self, key: str, *members: str) -> int:
        return self._int(OP_SADD, key, *members)

    def srem(self, key: str, *members: str) -> int:
        return self._int(OP_SREM, key, *members)

    def smembers(self, key: str) -> set[str]:
        _, vals = self._cmd(OP_SMEMBERS, key)
        return {v.decode("utf-8", "replace") for v in vals}

    # -- lists ------------------------------------------------------------
    def rpush(self, key: str, *values: bytes | str) -> int:
        return self._int(OP_RPUSH, key, *values)

    def lpush(self, key: str, *values: bytes | str) -> int:
        return self._int(OP_LPUSH, key, *values)

    def lrem(self, key: str, count: int, value: bytes | str) -> int:
        return self._int(OP_LREM, key, str(count), value)

    def lrange(self, key: str, start: int, stop: int) -> list[bytes]:
        _, vals = self._cmd(OP_LRANGE, key, str(start), str(stop))
        return vals

    def llen(self, key: str) -> int:
        return self._int(OP_LLEN, key)

    def ltrim(self, key: str, start: int, stop: int) -> None:
        self._cmd(OP_LTRIM, key, str(start), str(stop))

    # -- sorted sets ------------------------------------------------------
    def zadd(self, key: str, score: float, member: bytes | str) -> None:
        self._cmd(OP_ZADD, key, repr(float(score)), member)

    def zrangebyscore(
        self, key: str, min_score: float, max_score: float, limit: int | None = None
    ) -> list[bytes]:
        _, vals = self._cmd(
            OP_ZRANGEBYSCORE,
            key,
            repr(float(min_score)),
            repr(float(max_score)),
            "" if limit is None else str(limit),
        )
        return vals

    def zremrangebyscore(self, key: str, min_score: float, max_score: float) -> int:
        return self._int(
            OP_ZREMRANGEBYSCORE, key, repr(float(min_score)), repr(float(max_score))
        )

    def zcard(self, key: str) -> int:
        return self._int(OP_ZCARD, key)

    # -- hashes -----------------------------------------------------------
    def hset(self, key: str, field: str, value: bytes | str) -> None:
        self._cmd(OP_HSET, key, field, value)

    def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        return self._int(OP_HINCRBY, key, field, str(amount))

    def hgetall(self, key: str) -> dict[str, bytes]:
        _, vals = self._cmd(OP_HGETALL, key)
        return {
            vals[i].decode("utf-8", "replace"): vals[i + 1]
            for i in range(0, len(vals), 2)
        }

    # -- pub/sub ----------------------------------------------------------
    def publish(self, channel: str, message: str) -> int:
        msg = _to_bytes(message)
        if not self._enter():
            return 0
        try:
            return self._lib.atpu_publish(self._handle, channel.encode(), msg, len(msg))
        finally:
            self._leave()

    def psubscribe(self, *patterns: str) -> Subscription:
        buf = struct.pack("<I", len(patterns))
        for p in patterns:
            pb = p.encode()
            buf += struct.pack("<I", len(pb)) + pb
        if not self._enter():
            raise RuntimeError("store is closed")
        try:
            sub_id = self._lib.atpu_subscribe(self._handle, buf, len(buf))
        finally:
            self._leave()
        return NativeSubscription(tuple(patterns), self, sub_id)

    def _sub_poll(self, sub_id: int, timeout_ms: int) -> tuple[str, str] | None:
        if not self._enter():
            return None
        try:
            resp_ptr = ctypes.POINTER(ctypes.c_uint8)()
            resp_len = ctypes.c_size_t()
            rc = self._lib.atpu_sub_poll(
                self._handle, sub_id, timeout_ms, ctypes.byref(resp_ptr), ctypes.byref(resp_len)
            )
        finally:
            self._leave()
        if rc != 1:
            return None
        raw = ctypes.string_at(resp_ptr, resp_len.value)
        self._lib.atpu_free(resp_ptr)
        (chan_len,) = struct.unpack_from("<I", raw, 0)
        channel = raw[4 : 4 + chan_len].decode("utf-8", "replace")
        message = raw[4 + chan_len :].decode("utf-8", "replace")
        return channel, message

    def _sub_close(self, sub_id: int) -> None:
        if self._enter():
            try:
                self._lib.atpu_sub_close(self._handle, sub_id)
            finally:
                self._leave()

    def on_message(self, pattern: str, callback: Callable[[str, str], None]) -> Callable[[], None]:
        sub = self.psubscribe(pattern)
        stop = threading.Event()

        def poller() -> None:
            while not stop.is_set():
                got = self._sub_poll(sub._sub_id, 200)
                if got is not None:
                    try:
                        callback(*got)
                    except Exception as e:
                        # subscriber bugs must not kill the poller — but a
                        # silently-eaten callback error once hid a broken
                        # watcher for a whole soak: count it and say so
                        self.callback_errors_total += 1
                        print(
                            f"[store] subscriber callback failed for "
                            f"{pattern!r}: {type(e).__name__}: {e}",
                            flush=True,
                        )

        t = threading.Thread(target=poller, daemon=True, name=f"store-sub-{pattern}")
        t.start()
        self._cb_threads.append((stop, t))

        def unregister() -> None:
            stop.set()
            sub.close()

        return unregister

    # -- lifecycle ---------------------------------------------------------
    def flush(self) -> None:
        self._cmd(OP_FLUSH)

    def aof_flush(self) -> None:
        faults.fire("store.aof_flush")
        if self._enter():
            try:
                self._lib.atpu_aof_flush(self._handle)
            finally:
                self._leave()

    @property
    def handle(self) -> int:
        """Raw C handle, used to hand the same store to the data plane."""
        return self._handle

    def close(self) -> None:
        with self._inflight_cv:
            if self._closed:
                return
            self._closed = True  # new native calls are refused from here on
        for stop, _t in self._cb_threads:
            stop.set()
        for _stop, t in self._cb_threads:
            t.join(timeout=2.0)
        # wait for every thread to leave native code; if any straggler
        # remains (e.g. a blocked subscriber), deliberately LEAK the C++
        # store rather than free memory another thread is using
        with self._inflight_cv:
            self._inflight_cv.wait_for(lambda: self._inflight == 0, timeout=5.0)
            if self._inflight != 0:
                return
        self._lib.atpu_aof_flush(self._handle)
        self._lib.atpu_store_free(self._handle)

    def __del__(self) -> None:  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
