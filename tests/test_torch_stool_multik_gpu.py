"""Config 4's multi-k step on the card at the shape of the benchmark's
``stool_multik`` configuration, against the same step on the CPU.

Every test here needs a CUDA device and skips without one. This file
imports no jax and nothing of the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_stool_multik_gpu.py
"""
import json
import os

import numpy as np
import pytest
import torch

from pangea_tpu_torch.classify import engine
from pangea_tpu_torch.dist.mesh import Mesh, MeshConfig, MeshStep, place_index
from pangea_tpu_torch.index import build_index
from pangea_tpu_torch.kernels import kernel_launches
from pangea_tpu_torch.taxonomy import Taxonomy

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _benchmark_file(*parts):
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", *parts)


def test_stool_multik_mesh_step_on_the_card_equals_the_cpu(cuda,
                                                           monkeypatch):
    """The benchmark's stool_multik configuration at a small size (its
    5,785-taxon tree, 12 genomes of 4 kb, the benchmark's own generator):
    k=21 w=8 as q8, sorted, and k=31 as q12, unsorted, as the gate takes
    them at the configuration's size. The multi-k MeshStep on 1,024 pairs
    of 150 bp packed at 300 on the card equals the same step on the CPU
    (the plain versions) bit for bit, and it launches every kernel that
    cells/stool_multik.pe150_b262144.json names."""
    monkeypatch.syspath_prepend(_benchmark_file())
    from harness import worlds
    with open(_benchmark_file("configs", "stool_multik.json")) as fh:
        cfg = json.load(fh)
    with open(_benchmark_file("traffic", "pe150_b262144.json")) as fh:
        tr = json.load(fh)
    with open(_benchmark_file("cells",
                              "stool_multik.pe150_b262144.json")) as fh:
        names = json.load(fh)["launches"]
    world = worlds.make_world({**cfg["world"], "carriers": [1, 3],
                               "n_genomes": 12, "genome_len": 4000})
    tax = Taxonomy(parent=world.parent, rank=world.rank, names=world.names)
    thr = cfg["confidence_threshold"]
    idxs = [build_index(world.genomes, tax, k=s["k"], w=s["w"],
                        ways=s["ways"]) for s in cfg["indexes"]]
    # The deep-table gate as it falls on the configuration's tables: the
    # q8 lookup sorted, the q12 table (past 2^31 bytes there) unsorted.
    monkeypatch.setattr(engine, "takes_sorted",
                        lambda layout, n, fused: layout == "q8")
    steps = {}
    for dev in ("cpu", cuda):
        mesh = Mesh(MeshConfig(1, 1), dev)
        placed = [place_index(ix, mesh, thr, layout=lay)
                  for ix, lay in zip(idxs, ("q8", "q12"))]
        assert [p.cfg.layout for p in placed] == ["q8", "q12"]
        steps[dev] = MeshStep(placed, mesh, "broadcast")
    L = tr["max_read_len"]
    r1, r2, _ = worlds.sample_reads(world.genomes, 1024, tr,
                                    np.random.default_rng(2**32 + 5))
    b = torch.from_numpy(worlds.pack_wire(r1, L))
    m = torch.from_numpy(worlds.pack_wire(r2, L))
    before = kernel_launches()
    got = steps[cuda](b.to(cuda), m.to(cuda), packed_len=L)
    got = {k: v.cpu() for k, v in got.items()}
    after = kernel_launches()
    assert all(after[n] - before[n] >= 1 for n in names), (before, after)
    want = steps["cpu"](b, m, packed_len=L)
    for key in ("taxon", "best", "nvalid"):
        assert torch.equal(got[key], want[key]), key
    assert (got["taxon"] != 0).sum() > 512
