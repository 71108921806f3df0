"""Build the port's native sources into shared libraries at first use.

Each ``ame_tpu_torch/csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``ame_tpu_torch/_build/lib<name>_<hash>.so`` — a library
with a plain C interface, which its wrapper loads with ``ctypes``. The host
C++ codec shims (``ame_tpu_torch/io/native/*.cpp``) are compiled the same
way with ``g++`` (``build_host``). The file name carries the sources' hash,
so an edited source is rebuilt and a built one is reused. A failed compiler
raises with its stderr. Nothing here runs at import time.

Concurrent first calls (a server's worker threads, several processes) are
safe: a per-library lock serializes the threads of one process, and each
compile writes a temp file named by pid and thread before it is renamed
into place, so no reader ever sees a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ame_tpu_torch.utils.telemetry import stage_timer

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the flags of ame_tpu/io/native/Makefile
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set "
                       "CUDA_HOME")


def _compile(name: str, so: Path, cmd_for, what: str) -> dict:
    """Under `name`'s lock: reuse `so` if it exists, else run
    cmd_for(tmp) and rename tmp onto `so`. Returns {"path", "seconds"
    (0.0 when reused), "log" (the compiler's stderr, empty when reused)}."""
    with _lock(name):
        if so.exists():
            return {"path": so, "seconds": 0.0, "log": ""}
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{what} failed (exit {r.returncode}):\n"
                                   f"{r.stderr}")
            os.replace(tmp, so)
        finally:
            if tmp.exists():
                tmp.unlink()
        return {"path": so, "seconds": time.perf_counter() - t0,
                "log": r.stderr}


def build(name: str) -> dict:
    """Compile csrc/<name>.cu unless a library built from the same source
    exists. Returns {"path", "seconds" (0.0 when reused), "ptxas" (the
    compiler's resource report, empty when reused)}."""
    with stage_timer("ops.build"):
        return _build_cuda(name)


def _build_cuda(name: str) -> dict:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _OUT / f"lib{name}_{digest}.so"
    if so.exists():
        return {"path": so, "seconds": 0.0, "ptxas": ""}
    nvcc = _nvcc()
    info = _compile(name, so,
                    lambda tmp: [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    f"nvcc building {src}")
    return {"path": info["path"], "seconds": info["seconds"],
            "ptxas": info["log"]}


def build_host(name: str, sources, libs=()) -> dict:
    """Compile host C++ `sources` (paths) with ``g++`` into
    ``_build/lib<name>_<hash>.so``, linked against `libs` (e.g. ``-ldl``),
    unless a library of the same sources and libraries exists. The hash
    covers the sources' bytes and the link line. Returns {"path",
    "seconds", "log"}; raises RuntimeError when g++ is missing or fails."""
    with stage_timer("ops.build"):
        return _build_host(name, sources, libs)


def _build_host(name, sources, libs) -> dict:
    sources = [Path(s) for s in sources]
    h = hashlib.sha256()
    for s in sources:
        h.update(s.read_bytes())
    h.update(" ".join(libs).encode())
    so = _OUT / f"lib{name}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return {"path": so, "seconds": 0.0, "log": ""}
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError("g++ not found: a C++ compiler is needed to "
                           f"build {name}")
    return _compile(name, so,
                    lambda tmp: [cxx, *HOST_FLAGS, "-o", str(tmp),
                                 *map(str, sources), *libs],
                    f"g++ building {name}")
