#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port on the card:

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It exits with another code than 0, and prints
no result, where there is no CUDA card (or fewer than the cell asks for),
where the program cannot be imported, or where a module of JAX or of the
JAX package was loaded. The last line of standard output is the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """The checkout on the import path, in place of this directory; the
    kernel caches at fixed paths inside the checkout; no Flax."""
    sys.path[0] = str(ROOT)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(ROOT / ".cudabench_cache" / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _environment()
    from cudabench import harness
    return harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                       t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
