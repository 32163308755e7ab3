"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file (the entry's ``file``), its traffic mix
(``bench/traffic/<mix>.json``), its limits (``bench/limits/<cell>.json``),
the reader of each per-layer metric
(``bench/metrics/<metric>.py``, a ``read(run)`` function) and the plain
reference a configuration names (``bench/reference/<family>.py``).

A later cell, mix, metric or configuration is a new file and a new entry:
nothing here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / BENCH.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, workload: str) -> dict:
        """The limits of the numbers that decide the cell's ``correct``."""
        return json.loads((self.bench / "limits" / f"{workload}.json")
                          .read_text())

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics that list this cell."""
        return [m for m in self.spec["per_layer"]
                if workload in m["workloads"]]

    def reader(self, metric: str):
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def reference(name: str):
    """The plain reference module ``bench/reference/<name>.py``."""
    return importlib.import_module(f"reference.{name}")


def driver(name: str):
    """The cell driver ``benchkit/drivers/<name>.py`` a mix names."""
    return importlib.import_module(f"benchkit.drivers.{name}")
