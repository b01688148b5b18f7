"""Finds a cell's parts by name: its line in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<mix>.json``), the entry the
mix drives (``entries/<entry>.py``) and each per-layer metric's reader
(``metrics/<name>.py``, else ``metrics/<base>.py`` for ``<base>.<group>``).
Adding a configuration, a mix, an entry or a metric adds files and lines;
no file here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports

    @property
    def entry(self):
        return importlib.import_module(f"qoabench.entries.{self.traffic['entry']}")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _covers(m, workload)]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if m["moves"] in moved and _covers(m, workload)]
    return Cell(workload, int(w["chips"]),
                _load_json(os.path.join(ROOT, cfg["file"])),
                _load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                e2e, layers)


def reader(name: str):
    """The module that reads per-layer metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"qoabench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE}/metrics")
