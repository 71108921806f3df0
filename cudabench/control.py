#!/usr/bin/env python3
"""The control of the check, at a cell's own size: the reference computed
in the precision below the configuration's (``--bits`` mantissa bits
between stages; 10 is TF32, the step below float32 with TF32 off) in the
program's place, read against the reference itself on as many tracks of
each seed's pool as a run compares: the longest and others drawn from the
seed. A control that passes the check's limit would make the check
worthless. Not part of a benchmark run:

    python3 cudabench/control.py --workload <cell> --seeds 1 2 3 [--bits 10]

prints one JSON line a seed and a last line with every reading.
"""

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--bits", type=int, default=10)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parents[1])

    import numpy as np

    from cudabench import harness, traffic
    from cudabench.spec import Spec

    spec = Spec()
    cell = spec.cell(a.workload)
    config = spec.config(cell["config"])
    mix = spec.mix(cell["traffic"])
    ref = spec.reference(cell["config"])
    readings = {}
    for seed in a.seeds:
        pool = traffic.make_pool(mix, seed, a.device)
        longest = int(np.argmax(traffic.lengths(mix)))
        others = [i for i in range(len(pool)) if i != longest]
        n = int(mix.get("check", harness.CHECK_TRACKS)) - 1
        tracks = sorted([longest, *(int(i) for i in np.random.default_rng(
            seed).choice(others, size=n, replace=False))])
        worst = 0
        for i in tracks:
            tr = pool[i]
            want = ref.master(tr.pcm, float(tr.sample_rate),
                              config["settings"])
            got = ref.master(tr.pcm, float(tr.sample_rate),
                             config["settings"], mantissa_bits=a.bits)
            worst = max(worst, int(np.abs(got.astype(np.int32)
                                          - want.astype(np.int32)).max()))
        readings[seed] = worst
        print(json.dumps({"seed": seed, "tracks": tracks,
                          "control_max_lsb": worst}), flush=True)
    print(json.dumps({"workload": a.workload, "bits": a.bits,
                      "control_max_lsb": readings,
                      "limit": ref.LIMITS["max_lsb"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
