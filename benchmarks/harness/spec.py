"""The benchmark's specification, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics. Each name leads to files of its own beside this
package: ``configs/<config>.json`` (the configuration), ``traffic/
<traffic>.json`` (the traffic mix), ``metrics/<metric>.py`` (the
metric's reader, a ``read(run)`` function) and, where a cell has one,
``cells/<cell>.json`` (the kernels its step has to launch). Adding a
configuration, a mix, a metric or a cell is adding its files and its
entry; no code changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    config: dict             # configs/<config>.json, with its "name"
    config_path: str
    traffic: dict            # traffic/<traffic>.json, with its "name"
    chips: int
    metrics: list            # the metric entries this cell reports
    launches: list           # kernels each step launches (cells/<cell>.json)


class Spec:
    """BENCHMARK.json of the checkout at ``root``, and the benchmark's
    folder ``bench_dir`` (this package's parent by default)."""

    def __init__(self, root: str, bench_dir: str = HERE):
        self.root = root
        self.bench_dir = bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.doc = json.load(fh)

    def cell(self, name: str, trace: bool) -> Cell:
        """The cell of that name, with the metrics it reports: the
        end-to-end ones (``trace`` False) or the per-layer ones, each kept
        where its ``workloads`` list is absent or names the cell."""
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        configs = {c["name"]: c for c in self.doc["configs"]}
        cpath = os.path.join(self.root, configs[w["config"]]["file"])
        config = {**_load_json(cpath), "name": w["config"]}
        traffic = {**_load_json(os.path.join(
            self.bench_dir, "traffic", w["traffic"] + ".json")),
            "name": w["traffic"]}
        kind = "per_layer" if trace else "end_to_end"
        metrics = [m for m in self.doc[kind]
                   if "workloads" not in m or name in m["workloads"]]
        expect = os.path.join(self.bench_dir, "cells", name + ".json")
        launches = (_load_json(expect)["launches"]
                    if os.path.exists(expect) else [])
        return Cell(name, config, cpath, traffic, int(w["chips"]), metrics,
                    launches)

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        mod_name = "benchmark_metric_" + metric.replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
