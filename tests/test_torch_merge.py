"""The multi-k merge and the multi-k step against the reference (CPU).

``merge_multik_plain`` against ``merge_multik_jnp`` and the golden
``merge_multik_golden`` (random triples on two trees, the int32 extreme
cases, a three-way fold), and the port's multi-k step against the
reference's fused multi-k step on a 1x1 mesh and golden, for config 4's
two layout pairs: k=21 q8 + k=31 q12, and k=21 q8 + k=31 std (config 4 at
bench scale). Every output is an integer: the tolerance is exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.classify.engine import DeviceIndex as RefDeviceIndex
from pangea_tpu.classify.merge import merge_multik_jnp
from pangea_tpu.dist import MeshConfig, make_mesh, place_index
from pangea_tpu.dist.mesh import (batch_sharding,
                                  make_multik_sharded_classify_fn)
from pangea_tpu.golden import (GoldenResult, classify_reads_golden,
                               merge_multik_golden)
from pangea_tpu.index import build_index
from pangea_tpu.utils import datagen as ref_datagen
from pangea_tpu_torch.classify import (DeviceIndex, MultiKClassifier,
                                       make_multik_classify_fn,
                                       merge_multik_plain, pad_batch)

from .helpers import small_world

KEYS = ("taxon", "best", "nvalid")
READ_LEN = 120


def _torch(res):
    return {k: torch.from_numpy(np.ascontiguousarray(res[k], np.int32))
            for k in KEYS}


def _tax_t(tax):
    return {k: torch.from_numpy(v) for k, v in tax.device_arrays().items()}


def _golden_rows(res):
    return [GoldenResult(*(int(res[k][i]) for k in KEYS))
            for i in range(len(res["taxon"]))]


def _assert_golden(got, want):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      [getattr(w, key) for w in want])


def _random_calls(tax, B, rng):
    """Two classifiers' calls: zeros, agreements, conflicts, ties."""
    t1 = rng.integers(1, tax.num_taxa + 1, size=B)
    t2 = np.where(rng.random(B) < 0.3, t1,
                  rng.integers(1, tax.num_taxa + 1, size=B))
    t1 = np.where(rng.random(B) < 0.25, 0, t1)
    t2 = np.where(rng.random(B) < 0.25, 0, t2)
    out = []
    for t in (t1, t2):
        nvalid = rng.integers(0, 300, size=B)
        best = np.minimum(rng.integers(0, 300, size=B), nvalid)
        out.append({"taxon": t.astype(np.int32),
                    "best": np.where(t == 0, 0, best).astype(np.int32),
                    "nvalid": nvalid.astype(np.int32)})
    # Exact confidence ties: (b, n) and (2b, 2n).
    out[1]["best"][:50] = 2 * out[0]["best"][:50]
    out[1]["nvalid"][:50] = 2 * out[0]["nvalid"][:50]
    return out


@pytest.mark.parametrize("tree", [(2, 3), (512, 64)],
                         ids=["small_tree", "wide_tree"])
def test_merge_plain_matches_jax_and_golden(tree):
    tax = ref_datagen.make_taxonomy(2, *tree, seed=0)
    r1, r2 = _random_calls(tax, 3000, np.random.default_rng(tree[0]))
    got = merge_multik_plain(_torch(r1), _torch(r2), _tax_t(tax))
    want = merge_multik_jnp({k: jnp.asarray(v) for k, v in r1.items()},
                            {k: jnp.asarray(v) for k, v in r2.items()},
                            {k: jnp.asarray(v)
                             for k, v in tax.device_arrays().items()})
    for key in KEYS:
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    _assert_golden({k: v.numpy() for k, v in got.items()},
                   [merge_multik_golden(a, b, tax) for a, b in
                    zip(_golden_rows(r1), _golden_rows(r2))])
    conflict = (r1["taxon"] != 0) & (r2["taxon"] != 0) \
        & (r1["taxon"] != r2["taxon"])
    assert conflict.sum() > 500


BIG = 2**30
# The extreme cases of tests/test_hardening.py: products beyond int32.
EXTREMES = [
    ((3, BIG, BIG + 1), (3, BIG + 1, BIG)),
    ((3, BIG + 1, BIG), (3, BIG, BIG + 1)),
    ((3, BIG, BIG), (5, BIG - 1, BIG)),
    ((5, BIG - 1, BIG), (3, BIG, BIG)),
    ((3, 70000, 70001), (3, 70000, 70001)),
    ((0, 0, 40000), (7, 123, 70000)),
    ((0, 0, 50000), (0, 0, 60000)),
    ((3, 2**31 - 1, 2**31 - 1), (5, 2**31 - 2, 2**31 - 1)),
    ((0, 0, 2**31 - 1), (0, 0, 2)),             # the n1 + n2 wrap
]


def test_merge_plain_exact_beyond_int32_products():
    tax = small_world(n_reads=1)[0]
    r1, r2 = ({k: np.array([c[j][i] for c in EXTREMES], np.int32)
               for i, k in enumerate(KEYS)} for j in (0, 1))
    got = merge_multik_plain(_torch(r1), _torch(r2), _tax_t(tax))
    want = merge_multik_jnp({k: jnp.asarray(v) for k, v in r1.items()},
                            {k: jnp.asarray(v) for k, v in r2.items()},
                            {k: jnp.asarray(v)
                             for k, v in tax.device_arrays().items()})
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    gold = [merge_multik_golden(GoldenResult(*a), GoldenResult(*b), tax)
            for a, b in EXTREMES[:-1]]
    _assert_golden({k: v.numpy()[:-1] for k, v in got.items()}, gold)
    assert int(got["nvalid"][-1]) == -(2**31) + 1       # wraps as int32


@pytest.fixture(scope="module")
def world():
    """Genomes and paired reads of the reference's q8 tests, with the k=21
    index at w=1."""
    return small_world(k=21, n_reads=120, read_len=READ_LEN, paired=True)


def _batch(rs):
    n = len(rs.seqs)
    return pad_batch(rs.seqs, n, READ_LEN), pad_batch(rs.mates, n, READ_LEN)


def test_three_way_fold_matches_golden(world):
    """Three indexes (k=21, 17, 31) fold left to right in index order."""
    tax, genomes, idx21, rs = world
    idxs = [idx21, build_index(genomes, tax, k=17),
            build_index(genomes, tax, k=31)]
    dis = [DeviceIndex.from_index(ix, "cpu", 0.0) for ix in idxs]
    b1, b2 = (torch.from_numpy(b) for b in _batch(rs))
    fn = make_multik_classify_fn([d.cfg for d in dis], paired=True)
    got = fn(tuple(d.tables for d in dis), b1, b2)
    gold = [classify_reads_golden(rs.seqs, ix, 0.0, mates=rs.mates)
            for ix in idxs]
    want = gold[0]
    for g in gold[1:]:
        want = [merge_multik_golden(a, b, tax) for a, b in zip(want, g)]
    assert all(v.dtype == torch.int32 for v in got.values())
    _assert_golden({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("pair", ["q8_q12", "q8_std"])
@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
def test_multik_step_matches_jax_and_golden(world, monkeypatch, pair,
                                            paired):
    """Config 4: the k=21 q8 index and a k=31 index, either the reference's
    forced q12 (carried over by from_numpy_tables) or the std table that
    k=31, w=8 gets at bench scale; one batch through both and the merge."""
    tax, genomes, _, rs = world
    thr = 0.05
    idx21 = build_index(genomes, tax, k=21, w=8)
    idx31 = build_index(genomes, tax, k=31, w=1 if pair == "q8_q12" else 8)
    mesh = make_mesh(MeshConfig(n_data=1, n_shard=1),
                     devices=jax.devices()[:1])
    ref21 = place_index(idx21, mesh, thr)
    if pair == "q8_q12":
        monkeypatch.setenv("PANGEA_LAYOUT", "q12")
    ref31 = place_index(idx31, mesh, thr)
    monkeypatch.delenv("PANGEA_LAYOUT", raising=False)
    layouts = ("q8", "q12" if pair == "q8_q12" else "std")
    assert (ref21.cfg.layout, ref31.cfg.layout) == layouts

    di21 = DeviceIndex.from_index(idx21, "cpu", thr)
    if pair == "q8_q12":
        host = RefDeviceIndex.from_index(idx31, confidence_threshold=thr,
                                         layout="q12", device_put=False)
        di31 = DeviceIndex.from_numpy_tables(host.tables, host.cfg, "cpu")
    else:
        di31 = DeviceIndex.from_index(idx31, "cpu", thr)
    assert (di21.cfg.layout, di31.cfg.layout) == layouts
    model = MultiKClassifier([di21, di31])
    b1, b2 = _batch(rs)
    got = model(torch.from_numpy(b1),
                torch.from_numpy(b2) if paired else None)

    fn = make_multik_sharded_classify_fn([ref21.cfg, ref31.cfg], mesh,
                                         paired=paired)
    args = [jax.device_put(b, batch_sharding(mesh))
            for b in ((b1, b2) if paired else (b1,))]
    want = fn((ref21.tables, ref31.tables), *args)
    mates = rs.mates if paired else None
    gold = [merge_multik_golden(a, b, tax) for a, b in zip(
        classify_reads_golden(rs.seqs, idx21, thr, mates=mates),
        classify_reads_golden(rs.seqs, idx31, thr, mates=mates))]
    for key in KEYS:
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    _assert_golden({k: v.numpy() for k, v in got.items()}, gold)
    assert (got["taxon"] != 0).sum() > len(rs.seqs) // 2
