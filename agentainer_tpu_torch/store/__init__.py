"""State store — the single source of truth for the control plane.

Reference: ``agentainer_tpu/store/__init__.py``. The same ``Store``
interface (strings+TTL, sets, lists, sorted sets, hashes, pattern pub/sub)
and key schema (``schema.py``), with the in-memory implementation and the
native C++ one (``native.py``: the repo's ``native/store.cc`` through
``ctypes``, with append-only-file durability).
"""

from .base import Store, Subscription
from .memory import MemoryStore
from .schema import Keys

__all__ = ["Store", "Subscription", "MemoryStore", "Keys", "open_store"]


def open_store(url: str | None = None) -> Store:
    """Open a store from a URL.

    ``mem://`` (and an empty URL) → in-process MemoryStore; ``native://`` →
    the C++ store; ``native:///abs/path.aof`` also writes every mutation to
    an append-only file replayed on reopen. An AOF path asks for
    durability, so when the native library is unavailable it raises
    ``RuntimeError`` rather than run on memory; ``native://`` with no path
    falls back to MemoryStore and logs why. ``redis://`` raises as in the
    reference (no redis package)."""
    if not url or url.startswith("mem://"):
        return MemoryStore()
    if url.startswith("native://"):
        aof = url[len("native://") :]
        try:
            from .native import NativeStore

            return NativeStore(aof_path=aof or None)
        except Exception as e:
            if aof:
                raise RuntimeError(
                    f"native store with AOF durability requested ({url!r}) "
                    f"but unavailable: {e!r}. Refusing to downgrade "
                    "silently — install g++ to build native/, or pass "
                    "mem:// to run without durability"
                ) from e
            import logging

            logging.getLogger("agentainer").error(
                "native store unavailable (%s); falling back to the "
                "non-durable MemoryStore (no AOF path was requested)",
                e,
            )
            return MemoryStore()
    if url.startswith("redis://"):
        raise RuntimeError(
            "redis-py is not available in this environment; use mem:// or native://"
        )
    raise ValueError(f"unknown store url: {url}")
