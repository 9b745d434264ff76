"""Config 4's multi-k step at the shape of the benchmark's ``stool_multik``
configuration, on the CPU, against the benchmark's plain NumPy reference
(``benchmarks/reference/``).

The world is the configuration's own generator (``benchmarks/harness/
worlds.py``) on its [24, 48, 4] tree (5,785 taxa, so that both scorers
lift and the second merges), cut to a few small genomes; the indexes are
k=21 w=8 laid out as q8 and k=31 w=1 with q12 requested, placed on a
one-rank mesh and driven through ``MeshStep`` as the benchmark drives
them, on 150 bp pairs as wire rows of ``packed_len`` 300, threshold 0.05.
The deep-table gate is lowered (as ``tests/test_torch_deep.py`` lowers it)
for the sorted forms, left for the unsorted ones, and set as it falls on
the configuration's own tables (the q8 table sorted, the q12 table past
2^31 bytes unsorted). Every output is an integer: the tolerance is exact
equality. A tiny copy of the configuration runs through the harness's
``run_cell`` in ``benchmarks/tests/test_benchmarks_stool.py``.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from pangea_tpu_torch import trace
from pangea_tpu_torch.classify import engine
from pangea_tpu_torch.dist.mesh import Mesh, MeshConfig, MeshStep, place_index
from pangea_tpu_torch.index import build_index
from pangea_tpu_torch.kernels import lookup as LK
from pangea_tpu_torch.taxonomy import Taxonomy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import worlds  # noqa: E402
from reference import KmerMap, Tree, classify_reads  # noqa: E402

KEYS = ("taxon", "best", "nvalid")
CONFIG = os.path.join(BENCH, "configs", "stool_multik.json")
TRAFFIC = os.path.join(BENCH, "traffic", "pe150_b262144.json")
# A few genomes of the configuration's tree: 4 phyla's first genus, 3
# species each.
TINY_WORLD = {"carriers": [1, 3], "n_genomes": 12, "genome_len": 4000}
LAYOUTS = ("q8", "q12")
PAIRS = 96


def _config() -> dict:
    with open(CONFIG) as fh:
        return json.load(fh)


def _traffic() -> dict:
    with open(TRAFFIC) as fh:
        return json.load(fh)


def _lower_gate(monkeypatch):
    """The port's deep-table gate lowered: 2,048 probes a chunk past 512
    rows, so that both small tables take the sorted lookup."""
    monkeypatch.setenv("PANGEA_DEEP_SORT", "1")
    monkeypatch.setattr(LK, "_DEEP_ROWS", 1 << 9)
    monkeypatch.setattr(
        LK, "_deep_chunk",
        lambda n, nb, rb=512, min_chunk=8192: 2048 if n > 2048 else None)


def _configured_gate(monkeypatch):
    """The gate as it falls on the configuration's tables: the q8 lookup
    sorted, the q12 lookup unsorted."""
    monkeypatch.setattr(engine, "takes_sorted",
                        lambda layout, n, fused: layout == "q8")


def test_configured_tables_take_the_gates_branches():
    """At the configuration's geometry and the traffic's batch, the port's
    deep-table gate sorts the k=21 w=8 index's q8 lookup and leaves the
    k=31 index's q12 lookup, past 2^31 table bytes, unsorted."""
    cfg, tr = _config(), _traffic()
    L, B = tr["max_read_len"], tr["batch"]
    got = []
    for ix in cfg["indexes"]:
        g = ix["geometry"]
        fused = torch.empty((g["rows"], g["row_bytes"] // 4),
                            dtype=torch.int32, device="meta")
        n = B * 2 * ((L - ix["k"] + 1) // ix["w"])
        got.append(LK.takes_sorted(g["layout"], n, fused))
    assert got == [True, False]
    q12 = cfg["indexes"][1]["geometry"]
    assert q12["rows"] * q12["row_bytes"] > 1 << 31


@pytest.mark.parametrize("path", ["unsorted", "sorted", "configured"])
@pytest.mark.parametrize("seed", [3, 2**31 + 11, 977])
def test_multik_mesh_step_equals_the_reference(monkeypatch, seed, path):
    cfg = _config()
    world = worlds.make_world({**cfg["world"], **TINY_WORLD,
                               "genome_seed": seed})
    tax = Taxonomy(parent=world.parent, rank=world.rank, names=world.names)
    assert tax.num_taxa == cfg["n_taxa"] > 4096
    specs = [{**ix, "confidence_threshold": cfg["confidence_threshold"]}
             for ix in cfg["indexes"]]
    mesh = Mesh(MeshConfig(1, 1), "cpu")
    placed = [place_index(build_index(world.genomes, tax, k=s["k"],
                                      w=s["w"], ways=s["ways"]),
                          mesh, cfg["confidence_threshold"], layout=lay)
              for s, lay in zip(specs, LAYOUTS)]
    assert [p.cfg.layout for p in placed] == list(LAYOUTS)
    if path == "sorted":
        _lower_gate(monkeypatch)
    elif path == "configured":
        _configured_gate(monkeypatch)
    monkeypatch.setattr(trace, "_index_steps", {})
    step = MeshStep(placed, mesh, "broadcast")

    tr = _traffic()
    L = tr["max_read_len"]
    r1, r2, _ = worlds.sample_reads(world.genomes, PAIRS, tr,
                                    np.random.default_rng(seed))
    out = step(torch.from_numpy(worlds.pack_wire(r1, L)),
               torch.from_numpy(worlds.pack_wire(r2, L)), packed_len=L)

    tree = Tree(world.parent)
    maps = [KmerMap.build(world.genomes, tree, s["k"], s["w"])
            for s in specs]
    want = classify_reads(maps, r1, r2, tree, specs)
    for key, w in zip(KEYS, want):
        assert out[key].dtype == torch.int32
        np.testing.assert_array_equal(out[key].numpy(), w, err_msg=key)
    assert (out["taxon"] != 0).sum() > PAIRS // 2
    # The merged calls are not the last index's alone (ties keep the
    # first index's best and nvalid).
    last = classify_reads(maps[1:], r1, r2, tree, specs[1:])
    assert (last[2] != want[2]).any()
    recs = trace.index_steps()
    assert [(r["k"], r["w"], r["layout"]) for r in recs] == [
        (21, 8, "q8"), (31, 1, "q12")]
    assert [r["probes"] for r in recs] == [PAIRS * 2 * ((L - 21 + 1) // 8),
                                           PAIRS * 2 * (L - 31 + 1)]
    assert [r["sorted"] for r in recs] == {
        "unsorted": [0, 0], "sorted": [1, 1], "configured": [1, 0]}[path]
