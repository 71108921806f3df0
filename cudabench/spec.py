"""Everything a cell needs, found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its mix in
``traffic/<traffic>.json``, its plain reference in
``reference/<config>.py`` and each metric's reader in
``metrics/<name>.py``. Adding a configuration, a mix or a metric adds files
and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


class Spec:
    def __init__(self, bench_dir: Path = BENCH_DIR):
        self.dir = Path(bench_dir)
        self.benchmark = json.loads(
            (self.dir.parent / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.dir / "configs" / f"{name}.json").read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def _module(self, kind: str, name: str):
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"cudabench.{kind}.{name.replace('.', '_')}", path)
        if spec is None or not path.exists():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reference(self, config: str):
        return self._module("reference", config)

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics that ``cell`` reports."""
        return [m for m in self.benchmark["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics that ``cell`` reports: those that list it,
        and those with no list that move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.benchmark["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]
