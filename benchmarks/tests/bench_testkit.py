"""Tiny checkouts of the benchmark for its CPU tests: a copy of the
benchmark's folder and BENCHMARK.json in a temporary root, with tiny
configurations, mixes and cells beside the real ones."""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny worlds of each configuration, with the geometry their tables are
# placed at: the std one keeps its 66,563-taxon tree (so the std layout
# and the lifted LCA), the deep one its q8 layout.
TINY = {
    "tiny_std": ("amplicon16s_std", {"carriers": [2, 3], "n_genomes": 12,
                                     "genome_len": 3000},
                 {"indexes": [{"k": 21, "w": 1, "ways": 0, "geometry": {
                     "layout": "std", "rows": 4096, "row_bytes": 384}}]}),
    "tiny_deep": ("shotgun_deep_q8", {"genome_len": 4000},
                  {"indexes": [{"k": 21, "w": 1, "ways": 16, "geometry": {
                      "layout": "q8", "rows": 4096, "row_bytes": 512}}]}),
    "tiny_w8": ("shotgun_deep_q8", {"genome_len": 4000},
                {"indexes": [{"k": 21, "w": 8, "ways": 0, "geometry": {
                    "layout": "q8", "rows": 2048, "row_bytes": 512}}]}),
}
TINY_TRAFFIC = {"tiny_pe": "pe150_b65536", "tiny_se": "se150_b262144"}
TINY_CELLS = {"tiny_std.tiny_pe": ("tiny_std", "tiny_pe"),
              "tiny_deep.tiny_se": ("tiny_deep", "tiny_se"),
              "tiny_w8.tiny_se": ("tiny_w8", "tiny_se")}


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def save(path: str, doc: dict) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)


def tiny_checkout(root: str, batch: int = 64, pool: int = 2,
                  check_reads: int = 64) -> str:
    """A checkout at ``root`` holding BENCHMARK.json and a copy of the
    benchmark's folder, with the tiny cells added. Returns root."""
    bench = os.path.join(root, "benchmarks")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "cache", "__pycache__", "tests"))
    doc = load(os.path.join(ROOT, "BENCHMARK.json"))
    for name, (base, world, extra) in TINY.items():
        cfg = load(os.path.join(bench, "configs", base + ".json"))
        cfg["world"].update(world)
        cfg.update(extra)
        save(os.path.join(bench, "configs", name + ".json"), cfg)
        entry = dict(next(c for c in doc["configs"] if c["name"] == base))
        entry.update(name=name, file=f"benchmarks/configs/{name}.json")
        doc["configs"].append(entry)
    for name, base in TINY_TRAFFIC.items():
        tr = load(os.path.join(bench, "traffic", base + ".json"))
        tr.update(batch=batch, pool=pool, check_reads=check_reads)
        save(os.path.join(bench, "traffic", name + ".json"), tr)
    for name, (config, traffic) in TINY_CELLS.items():
        doc["workloads"].append({"name": name, "config": config,
                                 "traffic": traffic, "chips": 1,
                                 "why": "a tiny world for the CPU tests"})
    for m in doc["per_layer"]:
        m["workloads"] += list(TINY_CELLS)
    save(os.path.join(root, "BENCHMARK.json"), doc)
    return root


def run(root: str, cell: str, seed: int = 2**33 + 7, seconds: float = 0.5,
        trace: bool = False, device: str = "cpu", step_filter=None):
    """One run of a cell of the checkout at root; (result, log lines)."""
    from harness.cell import run_cell
    from harness.spec import Spec
    spec = Spec(root, os.path.join(root, "benchmarks"))
    lines: list = []
    t0 = time.perf_counter()
    result = run_cell(spec, spec.cell(cell, trace), seed, seconds, trace,
                      device, lambda: time.perf_counter() - t0,
                      lines.append, step_filter)
    return result, lines
