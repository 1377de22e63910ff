"""State store — the single source of truth for the control plane.

Reference: ``agentainer_tpu/store/__init__.py``. The same ``Store``
interface (strings+TTL, sets, lists, sorted sets, hashes, pattern pub/sub)
and key schema (``schema.py``), with the in-memory implementation. The
native C++ store (``native://``, append-only-file durability) comes with a
later slice of the port; until then ``open_store`` refuses it by name, and
the daemon's ``auto`` resolves to ``mem://`` as the reference's does when
its native library is unavailable.
"""

from .base import Store, Subscription
from .memory import MemoryStore
from .schema import Keys

__all__ = ["Store", "Subscription", "MemoryStore", "Keys", "open_store"]

NATIVE_LATER = (
    "the native store (native://) is not ported yet: it comes with the "
    "native-store and data-plane slice of the port; use mem://"
)


def open_store(url: str | None = None) -> Store:
    """Open a store from a URL: ``mem://`` (and an empty URL) → in-process
    MemoryStore. ``native://`` raises ``ValueError`` naming the slice that
    brings it; ``redis://`` raises as in the reference (no redis package)."""
    if not url or url.startswith("mem://"):
        return MemoryStore()
    if url.startswith("native://"):
        raise ValueError(NATIVE_LATER)
    if url.startswith("redis://"):
        raise RuntimeError(
            "redis-py is not available in this environment; use mem://"
        )
    raise ValueError(f"unknown store url: {url}")
