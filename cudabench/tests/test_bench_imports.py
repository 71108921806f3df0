"""Nothing the harness or its reference imports has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``ame_tpu`` (compared whole: the port's
``ame_tpu_torch`` is allowed), nor anything of ``benchmarks/`` or
``bench.py``; the reference imports nothing of the program either."""

import ast
import json
import shutil
import subprocess
import sys
import textwrap

from cudabench.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "ame_tpu", "benchmarks", "bench"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    files = [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not set(_imports(p)) & FORBIDDEN, p
    for p in (BENCH_DIR / "reference").glob("*.py"):
        assert set(_imports(p)) <= {"__future__", "math", "struct", "numpy",
                                    "scipy", "cudabench"}, p
        assert all(m.startswith("cudabench.reference")
                   for m in _modules(p) if m.startswith("cudabench")), p


def test_a_run_loads_nothing_forbidden():
    code = textwrap.dedent("""
        import json, sys, time
        from cudabench import harness
        from cudabench.spec import Spec
        spec = Spec()
        mix = spec.mix("clips30_dynamic")
        mix["lengths"] = {"kind": "fixed", "seconds": 2.0}
        mix["pool"] = 2
        for trace in (False, True):
            rc = harness.run("quality_flagship_nolufs.album_dynamic", 5,
                             0.5, trace, t_start=time.perf_counter(),
                             device="cpu", mix=mix)
            assert rc == 0
        for cell in spec.benchmark["workloads"]:
            spec.reference(cell["config"])
            for m in spec.end_to_end(cell["name"]) + spec.per_layer(
                    cell["name"]):
                spec.reader(m["name"])
        top = {m.split(".")[0] for m in sys.modules}
        print(json.dumps(sorted(top & {"jax", "jaxlib", "flax",
                                       "ame_tpu"})))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH_DIR.parent)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "cudabench/run.py", "--workload",
         "quality_flagship_nolufs.album_dynamic", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=BENCH_DIR.parent)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The look for forbidden modules comes again after the check and the
    metric readers, just before the result: a reader that loads a module
    named ``jax`` (a stub here) leaves the run without a result."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "jax.py").write_text("STUB = True\n")
    (root / "cudabench" / "metrics" / "planted.py").write_text(
        "import jax\n\n\ndef read(run):\n    return float(jax.STUB)\n")
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    bench["end_to_end"].append({
        "name": "planted", "unit": "1", "better": "higher", "bound": 0.25,
        "source": "host_clock", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(tmp_path / "stub")!r})
        from cudabench import harness
        from cudabench.spec import Spec
        spec = Spec({str(root / "cudabench")!r})
        mix = spec.mix(spec.cell({cell!r})["traffic"])
        mix["lengths"] = {{"kind": "fixed", "seconds": 2.0}}
        mix["pool"] = 2
        rc = harness.run({cell!r}, 7, 0.5, False,
                         t_start=time.perf_counter(), device="cpu",
                         spec=spec, mix=mix)
        print("rc", rc)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH_DIR.parent)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "rc 3"
    assert '"correct"' not in res.stdout
    assert "jax" in res.stderr
