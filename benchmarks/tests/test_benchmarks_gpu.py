"""The harness on the card, at tiny sizes: the traced run's per-layer
metrics and breakdown, and a broken step read as not correct. Marked
``gpu``; each test skips without a CUDA card. On the card:

    python -m pytest --noconftest -m gpu benchmarks/tests/test_benchmarks_gpu.py
"""
from __future__ import annotations

import pytest

from bench_testkit import run, tiny_checkout

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("checkout")),
                         batch=4096, pool=2, check_reads=2048)


@pytest.mark.parametrize("cell", ["tiny_std.tiny_pe", "tiny_deep.tiny_se"])
def test_traced_run_on_the_card(card, checkout, cell):
    result, lines = run(checkout, cell, seconds=1.0, trace=True,
                        device=card)
    assert result["correct"], lines
    m = result["metrics"]
    assert set(m) == {"batch_p95_ms", "place_s", "enqueue_ms", "step_ms",
                      "step_roofline_pct", "device_idle_pct"}, lines
    assert 0 < m["step_roofline_pct"]["value"] <= 100
    assert m["step_ms"]["value"] > 0
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert result["breakdown"]["device_ops"]
    assert any(ln.startswith("kernels: launches") for ln in lines)


def test_untraced_run_on_the_card(card, checkout):
    result, lines = run(checkout, "tiny_std.tiny_pe", seconds=1.0,
                        device=card)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    assert "breakdown" not in result and "busy_s" not in result["device"]


def test_altered_answers_on_the_card(card, checkout):
    def altered(step):
        def broken(bases, mates=None, packed_len=0):
            out = dict(step(bases, mates, packed_len=packed_len))
            out["best"] = out["best"] + (out["taxon"] % 7 == 3)
            return out
        return broken
    result, _ = run(checkout, "tiny_deep.tiny_se", seconds=0.5,
                    device=card, step_filter=altered)
    assert not result["correct"]
    assert result["limits"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("names, ok", [
    (["lookup_std", "lca_lift"], True), (["lookup_q8_sorted"], False)],
    ids=["launched", "not_launched"])
def test_cell_kernels_checked_on_the_card(card, tmp_path, names, ok):
    import os
    from bench_testkit import save
    root = tiny_checkout(str(tmp_path), batch=4096, pool=2,
                         check_reads=2048)
    save(os.path.join(root, "benchmarks", "cells", "tiny_std.tiny_pe.json"),
         {"launches": names})
    if ok:
        result, lines = run(root, "tiny_std.tiny_pe", seconds=0.5,
                            device=card)
        assert result["correct"], lines
    else:
        with pytest.raises(RuntimeError, match="launched"):
            run(root, "tiny_std.tiny_pe", seconds=0.5, device=card)
