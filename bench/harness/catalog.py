"""Find the benchmark's pieces by name.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric sits in a file of its own, found here by the name that
``BENCHMARK.json`` gives it:

  * ``bench/configs/<config>.json``     the configuration as it is run
  * ``bench/workloads/<cell>.json``     a cell: its configuration, traffic,
                                        chips, driver and limits
  * ``bench/traffic/<traffic>.json``    a traffic mix's parameters
  * ``bench/metrics/<metric>.py``       a metric's reader: ``read(ctx)``
  * ``bench/harness/drivers/<kind>.py`` the driver of a kind of cell

Which metrics a cell reports comes from ``BENCHMARK.json`` itself: an
end-to-end or per-layer metric whose ``workloads`` lists the cell, or
that has no ``workloads`` key.  A later change adds a cell, a mix or a
metric by adding files and entries, never by editing one.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(*parts) -> dict:
    path = os.path.join(BENCH, *parts)
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str) -> dict:
    cell = _json("workloads", name + ".json")
    cell["name"] = name
    return cell


def config(name: str) -> dict:
    return _json("configs", name + ".json")


def traffic(name: str) -> dict:
    return _json("traffic", name + ".json")


def _load(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The metric's reader module (file names may hold dots)."""
    return _load(os.path.join(BENCH, "metrics", metric + ".py"),
                 "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def driver(kind: str):
    return _load(os.path.join(BENCH, "harness", "drivers", kind + ".py"),
                 "bench_driver_" + kind)


def reference(name: str):
    return _load(os.path.join(BENCH, "reference", name + ".py"),
                 "bench_reference_" + name)


def metrics_of(cell: str, table: str, bench: dict | None = None) -> list:
    """The ``table`` ("end_to_end" or "per_layer") metrics that ``cell``
    reports, as their ``BENCHMARK.json`` entries."""
    bench = bench or benchmark()
    return [m for m in bench[table]
            if "workloads" not in m or cell in m["workloads"]]
