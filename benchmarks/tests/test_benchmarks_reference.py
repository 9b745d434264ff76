"""CPU tests of the benchmark's plain reference: against the port's
plain CPU path and its golden model on tiny worlds of each configuration,
and the control failing the check."""
from __future__ import annotations

import os

import numpy as np
import pytest

from bench_testkit import BENCH, TINY, load

from harness import worlds
from reference import (FingerprintMap, KmerMap, Tree, canonical_kmers,
                       classify_reads, merge_multik)


def _tiny(name: str):
    base, world, extra = TINY[name]
    cfg = load(os.path.join(BENCH, "configs", base + ".json"))
    cfg["world"].update(world)
    cfg.update(extra)
    return cfg, worlds.make_world(cfg["world"])


def _port(cfg, world):
    from pangea_tpu_torch.index import build_index
    from pangea_tpu_torch.taxonomy import Taxonomy
    tax = Taxonomy(parent=world.parent, rank=world.rank, names=world.names)
    return tax, [build_index(world.genomes, tax, k=ix["k"], w=ix["w"],
                             ways=ix["ways"]) for ix in cfg["indexes"]]


@pytest.mark.parametrize("name,traffic", [("tiny_std", "pe150_b65536"),
                                          ("tiny_deep", "se150_b262144"),
                                          ("tiny_w8", "se150_b262144")])
def test_reference_equals_the_ports_plain_step(name, traffic):
    import torch
    from pangea_tpu_torch.dist.mesh import (Mesh, MeshConfig, MeshStep,
                                            place_index)
    cfg, world = _tiny(name)
    tax, indexes = _port(cfg, world)
    mesh = Mesh(MeshConfig(1, 1), "cpu")
    step = MeshStep([place_index(ix, mesh, cfg["confidence_threshold"])
                     for ix in indexes], mesh, "broadcast")
    tr = load(os.path.join(BENCH, "traffic", traffic + ".json"))
    r1, r2, _ = worlds.sample_reads(world.genomes, 300, tr,
                                    np.random.default_rng(2**33 + 1))
    L = tr["max_read_len"]
    out = step(torch.from_numpy(worlds.pack_wire(r1, L)),
               None if r2 is None else
               torch.from_numpy(worlds.pack_wire(r2, L)), packed_len=L)
    got = np.stack([out[k].numpy() for k in ("taxon", "best", "nvalid")])
    tree = Tree(world.parent)
    specs = [dict(ix, confidence_threshold=cfg["confidence_threshold"])
             for ix in cfg["indexes"]]
    maps = [KmerMap.build(world.genomes, tree, ix["k"], ix["w"])
            for ix in specs]
    want = np.stack(classify_reads(maps, r1, r2, tree, specs))
    assert (got == want).all()
    assert (want[0] > 0).mean() > 0.9
    # The map is the index's relation, worked out independently.
    assert maps[0].keys.size == indexes[0].meta.n_kmers


def test_reference_equals_the_ports_golden_on_edge_reads():
    from pangea_tpu_torch.golden import (classify_reads_golden,
                                         merge_multik_golden)
    cfg, world = _tiny("tiny_w8")
    tax, (ix8,) = _port(cfg, world)
    _, (ix1,) = _port(dict(cfg, indexes=[{"k": 31, "w": 1, "ways": 0}]),
                      world)
    tr = load(os.path.join(BENCH, "traffic", "se150_b262144.json"))
    rng = np.random.default_rng(3)
    reads, _, _ = worlds.sample_reads(world.genomes, 120, tr, rng)
    reads[:20] = rng.integers(0, 4, (20, 150))       # absent k-mers
    reads[20, :] = 4                                  # no valid k-mer
    reads[21, ::7] = 4
    tree = Tree(world.parent)
    for thr in (0.0, 0.05, 0.9):
        specs = [{"k": 21, "w": 8, "confidence_threshold": thr},
                 {"k": 31, "w": 1, "confidence_threshold": thr}]
        maps = [KmerMap.build(world.genomes, tree, s["k"], s["w"])
                for s in specs]
        got = classify_reads(maps, reads, None, tree, specs)
        g8 = classify_reads_golden(list(reads), ix8, thr)
        g1 = classify_reads_golden(list(reads), ix1, thr)
        want = [merge_multik_golden(a, b, tax) for a, b in zip(g8, g1)]
        assert [(r.taxon, r.best, r.nvalid) for r in want] == \
            list(zip(*[g.tolist() for g in got]))
        one = classify_reads(maps[:1], reads, None, tree, specs[:1])
        assert [(r.taxon, r.best, r.nvalid) for r in g8] == \
            list(zip(*[g.tolist() for g in one]))


def test_tree_and_kmers_against_the_port():
    from pangea_tpu_torch.core import canonical_kmers as port_canon
    from pangea_tpu_torch.taxonomy import Taxonomy
    cfg, world = _tiny("tiny_std")
    tax = Taxonomy(parent=world.parent, rank=world.rank, names=world.names)
    tree = Tree(world.parent)
    assert (tree.tin == tax.tin).all() and (tree.tout == tax.tout).all()
    assert (tree.depth == tax.depth).all()
    rng = np.random.default_rng(0)
    a = rng.integers(1, tax.num_taxa + 1, 2000)
    b = rng.integers(0, tax.num_taxa + 1, 2000)
    assert (tree.lca(a, b) == tax.lca_pairs_np(a, b)).all()
    codes = rng.integers(0, 5, (6, 90)).astype(np.uint8)
    for k in (1, 21, 31):
        canon, valid = canonical_kmers(codes, k)
        for row in range(6):
            c, v = port_canon(codes[row], k)
            assert (canon[row] == c).all() and (valid[row] == v).all()


def test_merge_rules():
    tree = Tree(np.array([0, 1, 1, 1, 2, 2]))
    r1 = (np.array([0, 0, 4, 4, 4, 4]), np.array([0, 0, 3, 3, 3, 1]),
          np.array([5, 6, 10, 10, 10, 10]))
    r2 = (np.array([0, 3, 0, 4, 5, 3]), np.array([0, 2, 0, 6, 2, 1]),
          np.array([7, 8, 9, 10, 10, 10]))
    taxon, best, nvalid = merge_multik(r1, r2, tree)
    assert taxon.tolist() == [0, 3, 4, 4, 2, 1]
    assert best.tolist() == [0, 2, 3, 6, 2, 1]
    assert nvalid.tolist() == [12, 8, 10, 10, 10, 10]


def test_control_fails_the_check(tmp_path):
    """The control of the check, at a size a test holds: the fingerprint
    map in the program's place reads ``correct`` false on every seed."""
    import sys
    from bench_testkit import tiny_checkout
    sys.path.insert(0, BENCH)
    from control import control_run
    from harness.spec import Spec
    root = tiny_checkout(str(tmp_path), batch=4096, pool=2,
                         check_reads=8192)
    spec = Spec(root, os.path.join(root, "benchmarks"))
    for cell in ("tiny_std.tiny_pe", "tiny_deep.tiny_se"):
        for r in control_run(spec, cell, [2**31 + 1, 2**33 + 2, 5]):
            assert not r["correct"], r
            assert r["limits"]["wrong_answers"]["value"] > 0


def test_fingerprint_map_errs_only_where_fingerprints_repeat():
    cfg, world = _tiny("tiny_deep")
    tree = Tree(world.parent)
    exact = KmerMap.build(world.genomes, tree, 21, 1)
    fp = FingerprintMap(exact)
    valid = np.ones(exact.keys.shape, bool)
    same = fp.lookup(exact.keys, valid) == exact.lookup(exact.keys, valid)
    assert 0.999 < same.mean() < 1.0
