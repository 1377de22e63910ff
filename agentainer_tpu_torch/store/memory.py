"""In-memory Store — the non-durable backing for a control-plane daemon.

The reference externalizes all state to a Redis 7 sidecar so the Go server can
restart without losing agent records (reference scripts/start-server.sh:12-19,
docker-compose.yml). Here the control plane and engines share one host; the
daemon's durable default is the native store with its append-only file
(``store/native.py``), and this one serves ``mem://``, the fallback where
the native library cannot be built (the reference's snapshot/backup plane
is a later slice of the port).

Semantics follow Redis where it matters: lazy TTL expiry, ``lrem`` counted
removal (reference requests.go:171 uses LREM pending 1 id), sorted-set
score-range queries for metrics/log history (reference collector.go:174-200,
logger.go:201-246), and glob-pattern pub/sub.

Reference: ``agentainer_tpu/store/memory.py``, copied (its failpoints
fire through the port's ``faults``).
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Callable

from .. import faults
from .base import Store, Subscription, _to_bytes


class _ZSet:
    __slots__ = ("scores",)

    def __init__(self) -> None:
        self.scores: dict[bytes, float] = {}


class MemoryStore(Store):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._data: dict[str, object] = {}
        self._expiry: dict[str, float] = {}
        self._subs: list[Subscription] = []
        self._callbacks: list[tuple[str, Callable[[str, str], None]]] = []
        self.callback_errors_total = 0  # subscriber-callback failures (logged)

    # -- internals -------------------------------------------------------
    def _live(self, key: str) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and time.time() >= exp:
            self._data.pop(key, None)
            self._expiry.pop(key, None)
            return False
        return key in self._data

    def _typed(self, key: str, typ: type, create: bool = False):
        if self._live(key):
            val = self._data[key]
            if not isinstance(val, typ):
                raise TypeError(f"key {key!r} holds {type(val).__name__}, wanted {typ.__name__}")
            return val
        if create:
            val = typ()
            self._data[key] = val
            self._expiry.pop(key, None)
            return val
        return None

    # -- strings ---------------------------------------------------------
    def set(self, key: str, value: bytes | str, ttl: float | None = None) -> None:
        faults.fire("store.set")  # outside the lock: a delay must not block readers
        with self._lock:
            self._data[key] = _to_bytes(value)
            if ttl is None:
                self._expiry.pop(key, None)
            else:
                self._expiry[key] = time.time() + ttl

    def get(self, key: str) -> bytes | None:
        faults.fire("store.get")
        with self._lock:
            if not self._live(key):
                return None
            val = self._data[key]
            if not isinstance(val, bytes):
                raise TypeError(f"key {key!r} holds {type(val).__name__}, wanted bytes")
            return val

    def delete(self, *keys: str) -> int:
        with self._lock:
            n = 0
            for key in keys:
                if self._live(key):
                    n += 1
                self._data.pop(key, None)
                self._expiry.pop(key, None)
            return n

    def exists(self, key: str) -> bool:
        with self._lock:
            return self._live(key)

    def keys(self, pattern: str = "*") -> list[str]:
        with self._lock:
            return [k for k in list(self._data) if self._live(k) and fnmatch.fnmatchcase(k, pattern)]

    def expire(self, key: str, ttl: float) -> bool:
        with self._lock:
            if not self._live(key):
                return False
            self._expiry[key] = time.time() + ttl
            return True

    def ttl(self, key: str) -> float | None:
        with self._lock:
            if not self._live(key):
                return None
            exp = self._expiry.get(key)
            return None if exp is None else max(0.0, exp - time.time())

    def cas(
        self,
        key: str,
        expected: bytes | str | None,
        new: bytes | str,
        ttl: float | None = None,
    ) -> bool:
        faults.fire("store.cas")
        # under the SAME lock every other mutation takes: atomic against
        # concurrent set/delete, not just against other cas callers
        with self._lock:
            cur = self.get(key)
            exp = None if expected is None else _to_bytes(expected)
            if cur != exp:
                return False
            if ttl is None:
                ttl = self.ttl(key)
            self.set(key, new, ttl=ttl)
            return True

    # -- sets ------------------------------------------------------------
    def sadd(self, key: str, *members: str) -> int:
        with self._lock:
            s = self._typed(key, set, create=True)
            before = len(s)
            s.update(members)
            return len(s) - before

    def srem(self, key: str, *members: str) -> int:
        with self._lock:
            s = self._typed(key, set)
            if s is None:
                return 0
            n = 0
            for m in members:
                if m in s:
                    s.discard(m)
                    n += 1
            if not s:
                self.delete(key)
            return n

    def smembers(self, key: str) -> set[str]:
        with self._lock:
            s = self._typed(key, set)
            return set(s) if s else set()

    # -- lists -----------------------------------------------------------
    def rpush(self, key: str, *values: bytes | str) -> int:
        with self._lock:
            lst = self._typed(key, list, create=True)
            lst.extend(_to_bytes(v) for v in values)
            return len(lst)

    def lpush(self, key: str, *values: bytes | str) -> int:
        with self._lock:
            lst = self._typed(key, list, create=True)
            for v in values:
                lst.insert(0, _to_bytes(v))
            return len(lst)

    def lrem(self, key: str, count: int, value: bytes | str) -> int:
        with self._lock:
            lst = self._typed(key, list)
            if not lst:
                return 0
            val = _to_bytes(value)
            removed = 0
            if count >= 0:
                limit = count if count > 0 else len(lst)
                out = []
                for item in lst:
                    if item == val and removed < limit:
                        removed += 1
                    else:
                        out.append(item)
            else:
                limit = -count
                out = []
                for item in reversed(lst):
                    if item == val and removed < limit:
                        removed += 1
                    else:
                        out.append(item)
                out.reverse()
            self._data[key] = out
            if not out:
                self.delete(key)
            return removed

    def lrange(self, key: str, start: int, stop: int) -> list[bytes]:
        with self._lock:
            lst = self._typed(key, list)
            if not lst:
                return []
            # Redis LRANGE: stop is inclusive; -1 means end of list.
            n = len(lst)
            if start < 0:
                start = max(0, n + start)
            if stop < 0:
                stop = n + stop
            return list(lst[start : stop + 1])

    def llen(self, key: str) -> int:
        with self._lock:
            lst = self._typed(key, list)
            return len(lst) if lst else 0

    def ltrim(self, key: str, start: int, stop: int) -> None:
        with self._lock:
            lst = self._typed(key, list)
            if not lst:
                return
            n = len(lst)
            if start < 0:
                start = max(0, n + start)
            if stop < 0:
                stop = n + stop
            kept = lst[start : stop + 1]
            if kept:
                self._data[key] = kept
            else:
                self.delete(key)

    # -- sorted sets -----------------------------------------------------
    def zadd(self, key: str, score: float, member: bytes | str) -> None:
        with self._lock:
            z = self._typed(key, _ZSet, create=True)
            z.scores[_to_bytes(member)] = float(score)

    def _zsorted(self, z: _ZSet) -> list[tuple[bytes, float]]:
        return sorted(z.scores.items(), key=lambda kv: (kv[1], kv[0]))

    def zrangebyscore(
        self, key: str, min_score: float, max_score: float, limit: int | None = None
    ) -> list[bytes]:
        with self._lock:
            z = self._typed(key, _ZSet)
            if not z:
                return []
            out = [m for m, s in self._zsorted(z) if min_score <= s <= max_score]
            return out if limit is None else out[:limit]

    def zremrangebyscore(self, key: str, min_score: float, max_score: float) -> int:
        with self._lock:
            z = self._typed(key, _ZSet)
            if not z:
                return 0
            doomed = [m for m, s in z.scores.items() if min_score <= s <= max_score]
            for m in doomed:
                del z.scores[m]
            if not z.scores:
                self.delete(key)
            return len(doomed)

    def zcard(self, key: str) -> int:
        with self._lock:
            z = self._typed(key, _ZSet)
            return len(z.scores) if z else 0

    # -- hashes ----------------------------------------------------------
    def hset(self, key: str, field: str, value: bytes | str) -> None:
        with self._lock:
            h = self._typed(key, dict, create=True)
            h[field] = _to_bytes(value)

    def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        with self._lock:
            h = self._typed(key, dict, create=True)
            cur = int(h.get(field, b"0"))
            cur += amount
            h[field] = str(cur).encode()
            return cur

    def hgetall(self, key: str) -> dict[str, bytes]:
        with self._lock:
            h = self._typed(key, dict)
            return dict(h) if h else {}

    # -- pub/sub ---------------------------------------------------------
    def publish(self, channel: str, message: str) -> int:
        with self._lock:
            subs = list(self._subs)
            cbs = list(self._callbacks)
        n = 0
        for sub in subs:
            if not sub.closed and any(fnmatch.fnmatchcase(channel, p) for p in sub.patterns):
                sub._deliver(channel, message)
                n += 1
        for pattern, cb in cbs:
            if fnmatch.fnmatchcase(channel, pattern):
                try:
                    cb(channel, message)
                    n += 1
                except Exception as e:
                    # subscriber bugs must not break publishers — but they
                    # must be visible (same log-and-count discipline as the
                    # native store's poller)
                    self.callback_errors_total += 1
                    print(
                        f"[store] subscriber callback failed for "
                        f"{pattern!r}: {type(e).__name__}: {e}",
                        flush=True,
                    )
        return n

    def psubscribe(self, *patterns: str) -> Subscription:
        sub = Subscription(tuple(patterns), self._drop_sub)
        with self._lock:
            self._subs.append(sub)
        return sub

    def _drop_sub(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def on_message(self, pattern: str, callback: Callable[[str, str], None]) -> Callable[[], None]:
        entry = (pattern, callback)
        with self._lock:
            self._callbacks.append(entry)

        def unregister() -> None:
            with self._lock:
                if entry in self._callbacks:
                    self._callbacks.remove(entry)

        return unregister

    # -- lifecycle -------------------------------------------------------
    def flush(self) -> None:
        with self._lock:
            self._data.clear()
            self._expiry.clear()
