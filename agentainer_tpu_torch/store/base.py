"""Store interface.

The operation surface is the union of Redis commands the reference actually
issues (GET/SET/SETEX/DEL/EXISTS/KEYS, SADD/SREM/SMEMBERS, RPUSH/LREM/LRANGE,
ZADD/ZRANGEBYSCORE/ZREMRANGEBYSCORE, HSET/HINCRBY/HGETALL, PUBLISH/SUBSCRIBE —
see reference internal/storage/storage.go:21-76 and call sites cited in
SURVEY.md §2.2), with two deliberate fixes over the reference:

- ``scan`` replaces unbounded ``KEYS`` scans on the hot replay path
  (reference replay_worker.go:60 uses KEYS every 5s);
- ``psubscribe`` gives real glob-pattern channel matching (the reference
  subscribes to ``agent:status:*`` with a non-pattern SUBSCRIBE, which never
  matches — monitor.go:301, collector.go:326).

Values are ``bytes`` (binary-safe, so KV-cache snapshots can live here too);
``*_json`` helpers cover the common JSON-record case.

Reference: ``agentainer_tpu/store/base.py``, copied.
"""

from __future__ import annotations

import json
import threading
from abc import ABC, abstractmethod
from collections import deque
from typing import Any, Callable, Iterator


def _to_bytes(v: bytes | str) -> bytes:
    return v.encode("utf-8") if isinstance(v, str) else v


class Subscription:
    """A queue-backed subscription to one or more channel patterns.

    ``get``/``drain`` are thread-safe; callers that live on an asyncio loop
    should prefer registering a callback via ``Store.on_message`` instead of
    blocking on a Subscription.
    """

    def __init__(self, patterns: tuple[str, ...], unsubscribe: Callable[["Subscription"], None]):
        self.patterns = patterns
        self._queue: deque[tuple[str, str]] = deque()
        self._cond = threading.Condition()
        self._unsubscribe = unsubscribe
        self.closed = False

    def _deliver(self, channel: str, message: str) -> None:
        with self._cond:
            self._queue.append((channel, message))
            self._cond.notify_all()

    def get(self, timeout: float | None = None) -> tuple[str, str] | None:
        """Pop one (channel, message), blocking up to ``timeout`` seconds."""
        with self._cond:
            if not self._queue:
                self._cond.wait(timeout)
            if self._queue:
                return self._queue.popleft()
            return None

    def drain(self) -> list[tuple[str, str]]:
        with self._cond:
            out = list(self._queue)
            self._queue.clear()
            return out

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._unsubscribe(self)


class Store(ABC):
    """Abstract control-plane state store (Redis-shaped)."""

    # -- strings ---------------------------------------------------------
    @abstractmethod
    def set(self, key: str, value: bytes | str, ttl: float | None = None) -> None: ...

    @abstractmethod
    def get(self, key: str) -> bytes | None: ...

    @abstractmethod
    def delete(self, *keys: str) -> int: ...

    @abstractmethod
    def exists(self, key: str) -> bool: ...

    @abstractmethod
    def keys(self, pattern: str = "*") -> list[str]: ...

    @abstractmethod
    def expire(self, key: str, ttl: float) -> bool: ...

    @abstractmethod
    def ttl(self, key: str) -> float | None:
        """Remaining TTL in seconds, None if no TTL or missing key."""

    def scan(self, pattern: str = "*", batch: int = 512) -> Iterator[str]:
        """Cursor-style iteration; default implementation chunks ``keys``."""
        ks = self.keys(pattern)
        for i in range(0, len(ks), batch):
            yield from ks[i : i + batch]

    # -- sets ------------------------------------------------------------
    @abstractmethod
    def sadd(self, key: str, *members: str) -> int: ...

    @abstractmethod
    def srem(self, key: str, *members: str) -> int: ...

    @abstractmethod
    def smembers(self, key: str) -> set[str]: ...

    # -- lists -----------------------------------------------------------
    @abstractmethod
    def rpush(self, key: str, *values: bytes | str) -> int: ...

    @abstractmethod
    def lpush(self, key: str, *values: bytes | str) -> int: ...

    @abstractmethod
    def lrem(self, key: str, count: int, value: bytes | str) -> int: ...

    @abstractmethod
    def lrange(self, key: str, start: int, stop: int) -> list[bytes]: ...

    @abstractmethod
    def llen(self, key: str) -> int: ...

    @abstractmethod
    def ltrim(self, key: str, start: int, stop: int) -> None: ...

    # -- sorted sets -----------------------------------------------------
    @abstractmethod
    def zadd(self, key: str, score: float, member: bytes | str) -> None: ...

    @abstractmethod
    def zrangebyscore(
        self, key: str, min_score: float, max_score: float, limit: int | None = None
    ) -> list[bytes]: ...

    @abstractmethod
    def zremrangebyscore(self, key: str, min_score: float, max_score: float) -> int: ...

    @abstractmethod
    def zcard(self, key: str) -> int: ...

    # -- hashes ----------------------------------------------------------
    @abstractmethod
    def hset(self, key: str, field: str, value: bytes | str) -> None: ...

    @abstractmethod
    def hincrby(self, key: str, field: str, amount: int = 1) -> int: ...

    @abstractmethod
    def hgetall(self, key: str) -> dict[str, bytes]: ...

    # -- pub/sub ---------------------------------------------------------
    @abstractmethod
    def publish(self, channel: str, message: str) -> int:
        """Publish; returns number of receivers."""

    @abstractmethod
    def psubscribe(self, *patterns: str) -> Subscription:
        """Glob-pattern subscription (the fix for reference monitor.go:301)."""

    @abstractmethod
    def on_message(self, pattern: str, callback: Callable[[str, str], None]) -> Callable[[], None]:
        """Register a callback for a pattern; returns an unregister function.

        Callbacks run on an arbitrary thread (the publisher's for the memory
        store, a poller thread for the native store) and may be delivered
        asynchronously — asyncio consumers should bounce to their loop via
        ``call_soon_threadsafe`` and must not assume delivery-before-return.
        """

    # -- compare-and-set -------------------------------------------------
    def cas(
        self,
        key: str,
        expected: bytes | str | None,
        new: bytes | str,
        ttl: float | None = None,
    ) -> bool:
        """Atomically replace ``key``'s value with ``new`` iff its current
        value equals ``expected`` (``None`` = key must be absent). Returns
        whether the swap happened. This is the primitive the request
        journal's pending→processing transition rides on: two dispatchers
        (proxy + replay tick) racing the same entry must resolve to exactly
        one winner, not two dispatches. The default implementation
        serializes through a per-store lock; subclasses whose backing store
        has a native CAS should override."""
        lock = self.__dict__.get("_cas_lock")
        if lock is None:
            lock = self.__dict__.setdefault("_cas_lock", threading.Lock())
        exp = None if expected is None else _to_bytes(expected)
        with lock:
            cur = self.get(key)
            if cur != exp:
                return False
            if ttl is None:
                # preserve the record's remaining TTL across the swap —
                # a CAS must not silently turn a 24h record permanent
                ttl = self.ttl(key)
            self.set(key, new, ttl=ttl)
            return True

    # -- lifecycle -------------------------------------------------------
    @abstractmethod
    def flush(self) -> None: ...

    def close(self) -> None:  # pragma: no cover - trivial
        pass

    # -- JSON helpers ----------------------------------------------------
    def set_json(self, key: str, obj: Any, ttl: float | None = None) -> None:
        self.set(key, json.dumps(obj, separators=(",", ":")), ttl=ttl)

    def get_json(self, key: str) -> Any | None:
        raw = self.get(key)
        return None if raw is None else json.loads(raw)

    def lrange_str(self, key: str, start: int, stop: int) -> list[str]:
        return [v.decode("utf-8") for v in self.lrange(key, start, stop)]
