"""Build and load the port's CUDA kernels (no reference counterpart: the
JAX package's Pallas kernels are compiled by XLA inside ``jit``).

``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build
happens at first use, never at import — a machine without ``nvcc`` (CPU CI)
imports every module of the port. Outputs go to ``_build/`` inside the
package (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source rebuilds and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}  # one per source: two sources build at once


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def library(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library, compiling it first if missing.
    Raises with nvcc's output if the build fails. Callers cache the result
    (with their C signatures set on it)."""
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_OUT, f"lib{name}-{digest}.so")
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if not os.path.exists(so):
            os.makedirs(_OUT, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"kernel build failed: {name}: nvcc exit {proc.returncode}\n"
                    + proc.stdout.decode(errors="replace")
                )
            os.replace(tmp, so)  # atomic: another process never loads half a file
        return ctypes.CDLL(so)
