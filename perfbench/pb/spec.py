"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (perfbench/configs/<config>.json) and a
traffic mix (perfbench/traffic/<traffic>.json); a per-layer metric is a
reader perfbench/metrics/<metric>.py and a kernel's counted work
perfbench/counts/<kernel>.py. Adding any of them is adding files and
entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_benchmark(root: str | None = None) -> dict:
    with open(os.path.join(root or ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str, bench: str | None = None) -> dict:
    with open(os.path.join(bench or BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str, bench: str | None = None) -> dict:
    return _json("configs", name, bench)


def traffic(name: str, bench: str | None = None) -> dict:
    return _json("traffic", name, bench)


def _module(kind: str, name: str, bench: str | None = None):
    path = os.path.join(bench or BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench: str | None = None):
    """The reader of a per-layer metric: LAYER, UNIT, BETTER, SOURCE, MOVES
    and read(ctx) -> float or None (None: nothing to read in this run)."""
    return _module("metrics", name, bench)


def counts(kernel: str, bench: str | None = None):
    """A kernel's counted work: KERNELS (substrings of its device kernels'
    names) and work(q, cfg) -> (bytes, operations) from the quantities q
    the estimator and the seed fix."""
    return _module("counts", kernel, bench)


def cell(bench_json: dict, workload: str) -> tuple:
    """(workload entry, configuration file, traffic file) of a cell."""
    for w in bench_json["workloads"]:
        if w["name"] == workload:
            return w, config(w["config"]), traffic(w["traffic"])
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench_json: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: with trace the
    per-layer ones, else the end-to-end ones, each kept where it has no
    `workloads` key or lists the cell."""
    group = bench_json["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]
