"""Where the harness finds each part of a cell, by the names in
``BENCHMARK.json``: a workload names a configuration and a traffic mix; a
configuration is ``configs/<config>.json`` with its plain reference
``configs/<config>.py``; a traffic mix is ``traffic/<traffic>.json``, whose
``kind`` names its runner ``kinds/<kind>.py``; every metric, end-to-end or
per-layer, is read by ``metrics/<metric>.py``; the limits of a cell's
comparison are ``limits/<workload>.json``. Adding a cell, a configuration,
a mix or a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the file at ``path`` as module ``name`` (file names may hold
    dots, as metric names do)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mangle(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def reference(config_name: str):
    return load_module(HERE / "configs" / f"{config_name}.py",
                       f"fpisa_bench.configs.{_mangle(config_name)}")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def kind(name: str):
    return load_module(HERE / "kinds" / f"{name}.py", f"fpisa_bench.kinds.{_mangle(name)}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"fpisa_bench.metrics.{_mangle(name)}")


def limits(workload: str) -> dict:
    """{number compared: its limit} of the workload's comparison."""
    table = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return {k: v["limit"] for k, v in table["checks"].items()}


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            names = ", ".join(w["name"] for w in bench["workloads"])
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (workloads: {names})")
        self.entry = found[0]
        self.name = name
        self.chips = self.entry["chips"]
        self.config_name = self.entry["config"]
        self.config = config(self.config_name)
        self.traffic_name = self.entry["traffic"]
        self.traffic = traffic(self.traffic_name)
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def limits(self) -> dict:
        return limits(self.name)
