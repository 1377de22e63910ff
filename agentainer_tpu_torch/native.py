"""Loader for the native layer: the C++ store and data plane.

Reference: ``agentainer_tpu/native.py``. The C++ sources are the repo's own
``native/store.cc``, ``native/dataplane.cc`` and ``native/capi.cc`` (with
their headers), compiled as they are into one shared library that the
port's ``store/native.py`` and ``runtime/dataplane.py`` reach through
``ctypes``, with the reference's C signatures (``_bind``). What differs:

- the port never runs ``make`` and never writes under ``native/``: it runs
  ``g++`` itself with the Makefile's flags into the package's gitignored
  ``_build/`` as ``libagentainer_native-<hash>.so``, the hash covering the
  sources, the headers and the flags, so an edited source rebuilds and a
  stale library is never loaded;
- the build takes an ``fcntl`` lock on ``_build/native.lock`` (several
  processes may start at once, as test workers and a daemon beside its
  engines do) and renames the finished library into place, so no process
  loads half a file;
- nothing builds at import: ``load()`` builds at first use and caches the
  library, or the reason it is unavailable (``load_error()``);
  ``ATPU_DISABLE_NATIVE=1`` makes ``available()`` false.

Standard library only: the daemon imports this module, and it never
imports torch.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
# native/Makefile's library target: $(CXX) $(CXXFLAGS) -shared -o $@ $(SRCS)
CXX = "g++"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Wno-unused-parameter", "-pthread", "-shared")
SOURCES = ("store.cc", "dataplane.cc", "capi.cc")
HEADERS = ("common.h", "store.h", "dataplane.h")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: str | None = None


def library_path() -> str:
    """Where the library for the current sources and flags lives (built or
    not); raises ``OSError`` when a source is missing."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join((CXX,) + CXXFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libagentainer_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library if it is missing and return its path. Raises
    ``RuntimeError`` with the compiler's last lines when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(so):  # another process built it while we waited
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [CXX, *CXXFLAGS, "-o", tmp, *(os.path.join(NATIVE_DIR, s) for s in SOURCES)]
        try:
            proc = subprocess.run(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=BUILD_TIMEOUT_S
            )
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native build not run: {e}") from e
        if proc.returncode != 0:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            tail = proc.stdout.decode(errors="replace").strip().splitlines()[-8:]
            raise RuntimeError(f"native build failed ({CXX} exit {proc.returncode}):\n  " + "\n  ".join(tail))
        os.replace(tmp, so)  # atomic: a reader never sees half a file
    return so


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.atpu_store_new.restype = c.c_void_p
    lib.atpu_store_new.argtypes = [c.c_char_p]
    lib.atpu_store_free.argtypes = [c.c_void_p]
    lib.atpu_free.argtypes = [c.c_void_p]
    lib.atpu_cmd.restype = c.c_int
    lib.atpu_cmd.argtypes = [
        c.c_void_p,
        c.c_char_p,
        c.c_size_t,
        c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_size_t),
    ]
    lib.atpu_subscribe.restype = c.c_uint64
    lib.atpu_subscribe.argtypes = [c.c_void_p, c.c_char_p, c.c_size_t]
    lib.atpu_sub_poll.restype = c.c_int
    lib.atpu_sub_poll.argtypes = [
        c.c_void_p,
        c.c_uint64,
        c.c_int,
        c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_size_t),
    ]
    lib.atpu_sub_close.argtypes = [c.c_void_p, c.c_uint64]
    lib.atpu_publish.restype = c.c_int
    lib.atpu_publish.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p, c.c_size_t]
    lib.atpu_aof_flush.argtypes = [c.c_void_p]
    lib.atpu_dp_start.restype = c.c_void_p
    lib.atpu_dp_start.argtypes = [
        c.c_void_p,
        c.c_char_p,
        c.c_int,
        c.c_char_p,
        c.c_int,
        c.c_char_p,
    ]
    lib.atpu_dp_port.restype = c.c_int
    lib.atpu_dp_port.argtypes = [c.c_void_p]
    lib.atpu_dp_stop.argtypes = [c.c_void_p]
    lib.atpu_dp_route_set.argtypes = [
        c.c_void_p,
        c.c_char_p,
        c.c_char_p,
        c.c_int,
        c.c_char_p,
        c.c_int,
    ]
    lib.atpu_dp_route_del.argtypes = [c.c_void_p, c.c_char_p]
    lib.atpu_dp_counters_drain.argtypes = [
        c.c_void_p,
        c.c_char_p,
        c.POINTER(c.c_uint64),
        c.POINTER(c.c_double),
        c.POINTER(c.c_double),
    ]


def load() -> ctypes.CDLL | None:
    """The native library, built first if needed; None when it is
    unavailable (``load_error()`` says why, once per process)."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            return None
        try:
            lib = ctypes.CDLL(build())
            _bind(lib)
        except (OSError, RuntimeError) as e:
            _load_error = str(e)
            print(f"[atpu-native] unavailable (the Python store and data plane stay): {e}", file=sys.stderr)
            return None
        _lib = lib
        return lib


def available() -> bool:
    if os.environ.get("ATPU_DISABLE_NATIVE", "") == "1":
        return False
    return load() is not None


def load_error() -> str | None:
    return _load_error
