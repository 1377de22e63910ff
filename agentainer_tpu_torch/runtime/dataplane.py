"""Python handle for the native data plane (``native/dataplane.cc``).

Reference: ``agentainer_tpu/runtime/dataplane.py``, copied. The daemon
starts the C++ listener on the public port; Python keeps policy
(lifecycle, replay, health) and feeds the routing table on every agent
mutation (``route_set``/``route_del``). Agent traffic then flows entirely
on native threads: journal → engine dispatch → settle, with no Python in
the loop, and the engines reach the store over a token-checked unix
socket (``uds_path``) in the native binary protocol. Everything else —
the management API, and ``/agent/{id}/*`` of an agent whose route Python
owns (a replica fleet) — is forwarded to the port's standard-library
server on its loopback port. The C++ reads an answer whole before it
relays it (a log follow excepted), so a streamed ``/chat`` reaches its
client as one buffered response.

A unix socket's address holds 108 bytes (``sun_path``); a longer socket
path is reached through a descriptor of its directory
(``/proc/self/fd/N/store.sock``, ``socket_address``), by the listener as
by the engines' store client.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Iterator
from urllib.parse import urlparse

from ..native import load

UDS_PATH_MAX = 107  # sun_path's 108 bytes less the terminating NUL


@contextlib.contextmanager
def socket_address(path: str) -> Iterator[str]:
    """An address that reaches the unix socket ``path`` inside the block:
    ``path`` itself when it fits ``sun_path``, else the socket's name under
    an open descriptor of its directory."""
    if len(path.encode()) <= UDS_PATH_MAX:
        yield path
        return
    fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY | os.O_DIRECTORY)
    try:
        yield f"/proc/self/fd/{fd}/{os.path.basename(path)}"
    finally:
        os.close(fd)


class NativeDataPlane:
    def __init__(
        self,
        store,  # NativeStore — shares its C handle with the listener
        listen_host: str,
        listen_port: int,
        backend_host: str,
        backend_port: int,
        uds_path: str = "",
    ):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._store = store  # keep alive: dp threads use its handle
        # the listener binds (and at stop unlinks) the socket through this
        # address, so it lives as long as the listener
        self._address = contextlib.ExitStack()
        address = self._address.enter_context(socket_address(uds_path)) if uds_path else ""
        self._handle = self._lib.atpu_dp_start(
            store.handle,
            listen_host.encode(),
            listen_port,
            backend_host.encode(),
            backend_port,
            address.encode() if address else None,
        )
        if not self._handle:
            self._address.close()
            raise RuntimeError(f"data plane failed to bind port {listen_port}")
        self.uds_path = uds_path

    @property
    def port(self) -> int:
        return self._lib.atpu_dp_port(self._handle)

    def route_set(
        self, agent_id: str, endpoint: str | None, status: str, persist: bool
    ) -> None:
        """Update an agent's route. ``endpoint`` is the engine URL
        (http://127.0.0.1:PORT) or None when no engine is live, or when
        Python owns the agent's dispatch (port 0 on a running agent)."""
        host, port = "127.0.0.1", 0
        if endpoint:
            u = urlparse(endpoint)
            host, port = u.hostname or "127.0.0.1", u.port or 80
        self._lib.atpu_dp_route_set(
            self._handle,
            agent_id.encode(),
            host.encode(),
            port,
            status.encode(),
            1 if persist else 0,
        )

    def route_del(self, agent_id: str) -> None:
        self._lib.atpu_dp_route_del(self._handle, agent_id.encode())

    def counters_drain(self, agent_id: str) -> dict:
        requests = ctypes.c_uint64()
        lat_sum = ctypes.c_double()
        lat_max = ctypes.c_double()
        self._lib.atpu_dp_counters_drain(
            self._handle,
            agent_id.encode(),
            ctypes.byref(requests),
            ctypes.byref(lat_sum),
            ctypes.byref(lat_max),
        )
        return {
            "requests": requests.value,
            "latency_sum": lat_sum.value,
            "latency_max": lat_max.value,
        }

    def stop(self) -> None:
        if self._handle:
            self._lib.atpu_dp_stop(self._handle)
            self._handle = None
            self._address.close()
