"""A tiny copy of the ``stool_multik`` configuration and its traffic through
the harness's ``run_cell`` on the CPU, beside the testkit's tiny cells: a
world of 12 genomes of 4 kb on the configuration's 5,785-taxon tree, both
indexes, 64 pairs a batch. The port's multi-k step against the plain
reference at the configuration's shape is in the tier-1 suite
(``tests/test_torch_stool_multik.py``)."""
from __future__ import annotations

import os

from bench_testkit import load, run, save, tiny_checkout

TINY_WORLD = {"carriers": [1, 3], "n_genomes": 12, "genome_len": 4000}


def test_tiny_stool_multik_cell_is_correct(tmp_path):
    """A tiny copy of the configuration and its traffic through the
    harness's run_cell, beside the testkit's tiny cells: correct, with
    the multi-k step's per-layer metric in a traced run."""
    root = tiny_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmarks")
    cfg = load(os.path.join(bench, "configs", "stool_multik.json"))
    cfg["world"].update(TINY_WORLD)
    # At this size the layout policy gives the k=31 index a std table (the
    # configuration's 96M k-mers take q12, which the tier-1 test requests).
    cfg["indexes"][0]["geometry"].update(rows=2048)
    cfg["indexes"][1]["geometry"] = {"layout": "std", "rows": 8192,
                                     "row_bytes": 256}
    save(os.path.join(bench, "configs", "tiny_multik.json"), cfg)
    tr = load(os.path.join(bench, "traffic", "pe150_b262144.json"))
    tr.update(batch=64, pool=2, check_reads=64)
    save(os.path.join(bench, "traffic", "tiny_pe300.json"), tr)
    doc = load(os.path.join(root, "BENCHMARK.json"))
    entry = dict(next(c for c in doc["configs"]
                      if c["name"] == "stool_multik"))
    entry.update(name="tiny_multik", file="benchmarks/configs/"
                 "tiny_multik.json")
    doc["configs"].append(entry)
    cell = "tiny_multik.tiny_pe300"
    doc["workloads"].append({"name": cell, "config": "tiny_multik",
                             "traffic": "tiny_pe300", "chips": 1,
                             "why": "a tiny world for the CPU tests"})
    for m in doc["per_layer"]:
        m["workloads"].append(cell)
    save(os.path.join(root, "BENCHMARK.json"), doc)

    # A window of a few seconds, so that batches complete in it on a
    # loaded CPU.
    result, lines = run(root, cell, seconds=4.0)
    assert result["correct"], lines
    assert result["limits"]["wrong_answers"]["value"] == 0
    assert result["limits"]["answers_judged"]["value"] > 0
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    traced, lines = run(root, cell, seconds=4.0, trace=True)
    assert traced["correct"], lines
    got = traced["metrics"]
    assert got["later_index_enqueue_ms"]["value"] > 0
    assert got["later_index_enqueue_ms"]["unit"] == "ms"


def test_index_steps_window_takes_each_windows_difference():
    from trace_index_steps import _delta
    rec = {"index": 1, "k": 31, "w": 1, "layout": "q12"}
    before = [{**rec, "calls": 4, "probes": 40, "sorted": 0, "host_s": 1.0}]
    after = [{**rec, "calls": 6, "probes": 60, "sorted": 0, "host_s": 1.5}]
    got, = _delta(before, after)
    assert (got["calls"], got["probes"], got["sorted"]) == (2, 20, 0)
    assert got["host_ms"] == 250.0 and got["probes_a_call"] == 10
    fresh, = _delta([], after)
    assert fresh["calls"] == 6 and fresh["host_s"] == 1.5
