"""Find a cell, its configuration, its traffic and its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells; each names a
configuration (whose ``file`` is given there), a traffic mix
(``bench_h100/traffic/<traffic>.json``) and its own cell file
(``bench_h100/cells/<cell>.json``: the engine's parameters, the check's
sample and limit, the traced slice).  Each metric is a reader
``bench_h100/metrics/<metric>.py`` defining ``read(run)``, which returns a
number or None when it finds nothing to read; a metric named
``<quantity>.<cells>`` (one quantity split by the end-to-end metric it
moves) without a file of its own is read by ``<quantity>.py``.  A cell, a configuration, a
traffic mix or a metric is added by adding its file and its entry.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bm: dict, name: str) -> dict:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bm['workloads']]}")


def config(bm: dict, name: str, root: Path = ROOT) -> dict:
    for c in bm["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "bench_h100" / "traffic" / f"{name}.json")


def cell(name: str, root: Path = ROOT) -> dict:
    return _json(root / "bench_h100" / "cells" / f"{name}.json")


def metrics_for(bm: dict, wname: str, trace: bool) -> list[dict]:
    """The cell's ``end_to_end`` metrics (``trace`` False) or its
    ``per_layer`` ones (``trace`` True).  A metric with a ``workloads`` key
    belongs to the cells it lists; a per-layer metric without one belongs
    to every cell that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in bm["end_to_end"] if wname in m.get("workloads", [wname])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bm["per_layer"]
            if (wname in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(name: str, root: Path = ROOT):
    """``read`` of ``bench_h100/metrics/<name>.py``, or of the file of the
    part of the name before its first dot."""
    path = root / "bench_h100" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    mod_name = "h100bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
