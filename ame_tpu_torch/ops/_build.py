"""Build the port's CUDA sources into shared libraries at first use.

Each ``ame_tpu_torch/csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``ame_tpu_torch/_build/lib<name>_<hash>.so`` — a library
with a plain C interface, which its wrapper loads with ``ctypes``. The file name carries the
source's hash, so an edited source is rebuilt and a built one is reused. A
failed ``nvcc`` raises with its stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def build(name: str) -> dict:
    """Compile csrc/<name>.cu unless a library built from the same source
    exists. Returns {"path", "seconds" (0.0 when reused), "ptxas" (the
    compiler's resource report, empty when reused)}."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _OUT / f"lib{name}_{digest}.so"
    if so.exists():
        return {"path": so, "seconds": 0.0, "ptxas": ""}
    nvcc = _nvcc()
    _OUT.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {r.returncode}) building "
                           f"{src}:\n{r.stderr}")
    os.replace(tmp, so)
    return {"path": so, "seconds": time.perf_counter() - t0,
            "ptxas": r.stderr}
