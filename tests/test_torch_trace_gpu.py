"""The tracer's launch records on the card: one a call of
``kernels/_build.py`` ``launch``, agreeing with ``kernel_launches()``,
inside the step's spans, and within the step's own CUDA events.

Every test here needs a CUDA device and skips without one. This file
imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_trace_gpu.py
"""
from collections import Counter

import pytest
import torch

from pangea_tpu_torch import trace
from pangea_tpu_torch.bench import make_bench_world
from pangea_tpu_torch.classify import DeviceIndex, pad_batch
from pangea_tpu_torch.dist.mesh import Mesh, MeshConfig, MeshStep
from pangea_tpu_torch.kernels import _build, kernel_launches

pytestmark = pytest.mark.gpu

# Each launcher's calls, by the wrappers' launch counts (lca_lift counts
# the scorer launches whose tail lifts: no call of its own).
LAUNCHERS = {"pangea_extract_probes": ("extract_probes", "extract_packed"),
             "pangea_lookup_std": ("lookup_std",),
             "pangea_score": ("score_taxon", "score_tin")}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_launch_records_match_the_launches_and_the_step_events(
        cuda, monkeypatch):
    bw = make_bench_world(n_reads=512, read_len=150, genome_len=4000, k=21,
                          w=1, tree=(512, 64))
    step = MeshStep([DeviceIndex.from_index(bw.index, cuda)],
                    Mesh(MeshConfig(1, 1), cuda))
    b = torch.from_numpy(pad_batch(bw.reads.seqs, 512, 150)).to(cuda)
    m = torch.from_numpy(pad_batch(bw.reads.mates, 512, 150)).to(cuda)
    step(b, m)                                    # build and warm
    torch.cuda.synchronize()
    calls = []
    real = _build.launch

    def spy(name, device, *args):
        calls.append(name)
        return real(name, device, *args)
    monkeypatch.setattr(_build, "launch", spy)
    before = kernel_launches()
    events = []
    with trace.collect() as t:
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            step(b, m)
            e1.record()
            events.append((e0, e1))
    after = kernel_launches()
    assert len(calls) == 5 * 4
    assert Counter(r.name for r in t.launches) == Counter(calls)
    for launcher, wrappers in LAUNCHERS.items():
        assert calls.count(launcher) == sum(after[w] - before[w]
                                            for w in wrappers)
    got = t.summary()
    assert got["steps"] == 5
    assert got["launch_block_ms"] > 0 and got["probe_ms"] > 0
    assert got["launch_gap_ms"] >= 0
    step_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    by_step: dict = {}
    for r in t.launches:
        assert r.t0 <= r.t1
        by_step.setdefault(r.span.step, []).append(r)
        parent = r.span.parent
        assert parent.name in ("step.extract", "step.probe", "step.score")
        assert parent.parent.name == "step"
        assert (parent.name == "step.probe") == (r.name
                                                 == "pangea_lookup_std")
    for ms, (sid, recs) in zip(step_ms, sorted(by_step.items())):
        assert len(recs) == 4
        device_ms = sum(r.t1 - r.t0 for r in recs) * 1e-6
        assert device_ms <= ms + 1e-3
        assert (max(r.t1 for r in recs) - min(r.t0 for r in recs)) * 1e-6 \
            <= ms + 1e-3
