"""Finds a cell's parts by name: nothing about one configuration, mix, metric
or kernel role is written in the harness's code.

* ``BENCHMARK.json`` at the root: the cells (``workloads``), the
  configurations and the metrics, each metric reported in the cells its
  ``workloads`` key lists (all cells without one);
* a configuration: the file its ``BENCHMARK.json`` entry names;
* a mix: ``bench/traffic/<mix>.json``;
* a metric: ``read(ctx)`` of ``bench/metrics/<base>.py``, where ``<base>``
  is the metric's name up to its first dot (``enqueue_ms.ward`` is read by
  ``enqueue_ms.py``); a reader that finds nothing returns None;
* kernel roles: every ``bench/layers/*.json``, merged in file-name order,
  each ``{"roles": {role: [name fragment, ...]}}``; a kernel takes the role
  of the first fragment its name contains, case aside.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any

BENCH = "bench"


class Catalog:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: dict[str, ModuleType] = {}

    def cell(self, name: str) -> dict[str, Any]:
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict[str, Any]:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict[str, Any]:
        return json.loads((self.root / BENCH / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict[str, Any]]:
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        base = metric.split(".", 1)[0]
        mod = self._readers.get(base)
        if mod is None:
            path = self.root / BENCH / "metrics" / f"{base}.py"
            spec = importlib.util.spec_from_file_location(f"bench_metric_{base}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[base] = mod
        return mod

    def roles(self) -> list[tuple[str, str]]:
        """(lower-case name fragment, role), in the order they are tried."""
        out = []
        for path in sorted((self.root / BENCH / "layers").glob("*.json")):
            for role, frags in json.loads(path.read_text())["roles"].items():
                out.extend((f.lower(), role) for f in frags)
        return out


def role_of(name: str, roles: list[tuple[str, str]]) -> str | None:
    low = name.lower()
    for frag, role in roles:
        if frag in low:
            return role
    return None
