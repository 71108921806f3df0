"""Every cell of BENCHMARK.json resolves to its files, the file keeps to
the contract's shape, and a mix or metric added as new files only is
picked up."""

import json
import re
import shutil

import pytest

from cudabench import traffic
from cudabench.spec import BENCH_DIR, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cudabench"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    layers = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert set(layers.values()) <= e2e
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = Spec()
    w = spec.cell(cell)
    assert w["chips"] == 1
    config = spec.config(w["config"])
    mix = spec.mix(w["traffic"])
    assert config["settings"]["mode"] == "quality"
    assert len(traffic.lengths(mix)) == mix["pool"]
    assert callable(spec.reference(w["config"]).master)
    assert spec.end_to_end(cell) and spec.per_layer(cell)
    for m in spec.end_to_end(cell) + spec.per_layer(cell):
        assert callable(spec.reader(m["name"]).read), m["name"]


def test_every_config_file_is_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"cudabench/configs/{c['name']}.json"
        assert (BENCH_DIR.parent / c["file"]).exists()


def test_added_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.loads((BENCH_DIR / "traffic" / "clips30_dynamic.json")
                     .read_text())
    mix["lengths"] = {"kind": "fixed", "seconds": 12.5}
    (root / "cudabench" / "traffic" / "clips12_dynamic.json").write_text(
        json.dumps(mix))
    (root / "cudabench" / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    bench["workloads"].append({
        "name": "quality_flagship_nolufs.clips12_dynamic",
        "config": "quality_flagship_nolufs", "traffic": "clips12_dynamic",
        "chips": 1, "why": "added as data"})
    for m in bench["per_layer"]:            # a new cell joins a metric
        if m["name"] == "io.write_ms":          # by its name in the list
            m["workloads"].append("quality_flagship_nolufs.clips12_dynamic")
    bench["per_layer"].append({
        "name": "calls_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "api",
        "moves": "audio_x_realtime",
        "workloads": ["quality_flagship_nolufs.clips12_dynamic"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root / "cudabench")
    w = spec.cell("quality_flagship_nolufs.clips12_dynamic")
    assert traffic.lengths(spec.mix(w["traffic"])) == [551250] * 12
    names = [m["name"] for m in spec.per_layer(w["name"])]
    assert set(names) == {"calls_per_s", "io.write_ms"}
    assert "calls_per_s" not in [
        m["name"] for m in spec.per_layer(
            "quality_flagship_nolufs.album_dynamic")]

    class R:
        calls, window_s = [1, 2, 3], 1.5
    assert spec.reader("calls_per_s").read(R) == 2.0
