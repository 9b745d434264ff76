"""CPU tests of what the benchmark reads of the port's own tracing: the
placement readers on synthetic records, a traced tiny run (the measured
window's readers as before, the placement recorded), and the
program-trace window of ``trace_window.py`` on a tiny cell's step."""
from __future__ import annotations

import os
import sys

import pytest

from bench_testkit import ROOT, run, tiny_checkout

import trace_window
from harness.spec import Spec
from pangea_tpu_torch import trace

READERS = ("place_layout_s", "place_copy_s")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


def _read(name: str):
    return Spec(ROOT).reader(name)(None)


def test_placement_readers_sum_the_card_placements(monkeypatch):
    recs = [{"device": "cuda", "place": 3.0, "place.layout": 2.0,
             "place.copy": 0.75, "read_bytes": 0},
            {"device": "cpu", "place": 9.0, "place.layout": 8.0,
             "place.copy": 0.5, "read_bytes": None},
            {"device": "cuda", "place": 1.5, "place.layout": 1.0,
             "place.copy": 0.25, "read_bytes": 4096}]
    monkeypatch.setattr(trace, "_placements", recs)
    assert _read("place_layout_s") == 3.0
    assert _read("place_copy_s") == 1.0
    monkeypatch.setattr(trace, "_placements", recs[1:2])
    assert [_read(n) for n in READERS] == [None, None]


def test_placement_readers_without_the_record(monkeypatch):
    """A program without the tracer (a parent checkout): None, no
    error."""
    monkeypatch.setitem(sys.modules, "pangea_tpu_torch.trace", None)
    assert [_read(n) for n in READERS] == [None, None]


def test_traced_tiny_run_records_its_placement(checkout):
    before = len(trace.placements())
    result, _ = run(checkout, "tiny_std.tiny_pe", trace=True)
    assert result["correct"]
    # The measured window's readers, tracer off: as without the tracer;
    # the placement's readers read only a card's.
    assert set(result["metrics"]) == {"batch_p95_ms", "place_s",
                                      "enqueue_ms"}
    assert not trace.ON
    rec, = trace.placements()[before:]
    assert rec["device"] == "cpu"
    assert rec["place.layout"] > 0 and rec["place.copy"] > 0
    assert rec["place.layout"] + rec["place.copy"] <= \
        result["metrics"]["place_s"]["value"]


def test_program_window_on_a_tiny_step(checkout):
    steps = []

    def keep(step):
        steps.append(step)
        return step
    run(checkout, "tiny_deep.tiny_se", step_filter=keep)
    import numpy as np
    import torch
    from harness import worlds
    from harness.cell import draw_inputs
    spec = Spec(checkout, os.path.join(checkout, "benchmarks"))
    cell = spec.cell("tiny_deep.tiny_se", True)
    tr = cell.traffic
    L = tr["max_read_len"]
    world = worlds.make_world(cell.config["world"])
    pool_codes, _ = draw_inputs(world, tr, 5)
    pool = [(torch.from_numpy(worlds.pack_wire(r1, L)), tr["batch"])
            for r1, _ in pool_codes]
    got, win, deltas = trace_window.program_window(
        steps[0], pool, L, worlds.wire_width(L), seconds=0.3)
    assert got["steps"] == len(win.batches) > 0
    assert set(got["self_ms"]) == {"step", "step.extract", "step.probe",
                                   "step.score"}
    # The plain versions launch nothing: no launch readings.
    assert got["launches"] == {} and deltas == {}
    assert got["launch_block_ms"] is None and got["probe_ms"] is None
    assert got["launch_gap_ms"] is None
    nums = trace_window.window_numbers(spec, win)
    assert set(nums) == {"reads_per_s", "enqueue_ms"}
    assert nums["reads_per_s"] > 0 and nums["enqueue_ms"] > 0
    assert np.isclose(got["step_ms"], nums["enqueue_ms"], rtol=0.2)
