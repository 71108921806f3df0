"""Each cell end to end on the card, with a short window: the result line
keeps to the contract and the masters pass the check. Skips without a
card (run on one: ``python -m pytest -m cuda -p no:cacheprovider
cudabench/tests/test_bench_card.py``)."""

import json
import subprocess
import sys

import pytest
import torch

from cudabench.spec import BENCH_DIR, Spec

CELLS = [w["name"] for w in Spec().benchmark["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run(
        [sys.executable, "cudabench/run.py", "--workload", cell, "--seed",
         str(2**31 + 4242), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=BENCH_DIR.parent)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    spec = Spec()
    want = spec.per_layer(cell) if trace else spec.end_to_end(cell)
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert out["device"]["busy_s"] > 0
        assert 0 < out["metrics"]["kernel.cascade_roofline"]["value"] <= 105
    else:
        assert set(out["metrics"]) == {m["name"] for m in want}
