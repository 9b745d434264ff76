"""The port's sharded index against the reference's (CPU).

The owner rule, the S-shard std and quotient relayouts, the sharded
container (load, tables at matching, merged and split shard counts, host
lookup), the out-of-core build through both CLIs, the streaming placements
of one shard, and the routed step's routing bin. Exact equality
throughout: every array is integer.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu import cli as ref_cli
from pangea_tpu.dist import MeshConfig, make_mesh, place_index
from pangea_tpu.index import build_index_ooc as ref_build_index_ooc
from pangea_tpu.index import shard as ref_shard
from pangea_tpu.kernels.lookup import hash32_jnp
from pangea_tpu_torch import cli
from pangea_tpu_torch.classify import DeviceIndex, pad_batch
from pangea_tpu_torch.classify.engine import _extract_probes
from pangea_tpu_torch.index import (ShardedIndex, build_index_ooc,
                                    load_index_any, owner_of, shard_tables,
                                    shard_tables_quot)
from pangea_tpu_torch.index.quot import Q8_WAYS, Q12_WAYS
from pangea_tpu_torch.kernels.lookup import record_rows
from pangea_tpu_torch.kernels.route import (route_bin_plain, route_capacity,
                                            route_restore_plain)

from .helpers import small_world

SHARDS = [2, 4, 8]


@pytest.fixture(scope="module")
def world():
    return small_world(n_reads=128)


@pytest.fixture(scope="module")
def world31():
    return small_world(k=31, seed=3, n_reads=64)


@pytest.fixture(scope="module")
def ooc(world, tmp_path_factory):
    """The same genomes through both out-of-core builders: (port's, the
    reference's) ShardedIndex of 4 shards."""
    tax, genomes, idx, _ = world
    d = tmp_path_factory.mktemp("ooc")
    port = build_index_ooc(genomes, tax, k=idx.meta.k, out=str(d / "port"),
                           n_shards=4, parts_per_shard=4)
    ref = ref_build_index_ooc(genomes, tax, k=idx.meta.k, out=str(d / "ref"),
                              n_shards=4, parts_per_shard=4)
    return port, ref


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_shards", [1, *SHARDS])
def test_owner_and_std_shards_byte_identical(world, n_shards):
    canon, _ = ref_shard.extract_pairs(world[2])
    _same(owner_of(canon, n_shards), ref_shard.owner_of(canon, n_shards))
    for a, b in zip(shard_tables(world[2], n_shards),
                    ref_shard.shard_tables(world[2], n_shards)):
        _same(a, b)


@pytest.mark.parametrize("layout", ["q8", "q12"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_quot_shards_byte_identical(world, world31, layout, n_shards):
    idx = world[2] if layout == "q8" else world31[2]
    ways = Q8_WAYS if layout == "q8" else Q12_WAYS
    got = shard_tables_quot(idx, n_shards, ways, layout=layout)
    want = ref_shard.shard_tables_quot(idx, n_shards, ways, layout=layout)
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert got[2] == want[2]


def test_sharded_index_loads_as_the_reference(ooc, world):
    port, ref = ooc
    got = load_index_any(port.path)
    assert isinstance(got, ShardedIndex)
    assert got.meta == ShardedIndex.load(ref.path).meta
    assert got.meta.n_kmers == world[2].meta.n_kmers
    assert got.nbytes == ref.nbytes
    for a, b in zip(got.shards, ref.shards):
        for x, y in zip(a, b):
            _same(x, y)


@pytest.mark.parametrize("n_mesh", [1, 2, 4, 8],
                         ids=["merge4", "merge2", "match", "split2"])
def test_sharded_tables_byte_identical(ooc, world, n_mesh):
    """The container's tables at a matching, merged and split shard count
    equal the reference container's and the monolithic index's."""
    port, ref = ooc
    got = shard_tables(port, n_mesh)
    for a, b, c in zip(got, ref.shard_tables(n_mesh),
                       ref_shard.shard_tables(world[2], n_mesh)):
        _same(a, b)
        _same(a, c)


def test_sharded_lookup_np(ooc, world):
    port, ref = ooc
    canon, _ = ref_shard.extract_pairs(world[2])
    rng = np.random.default_rng(5)
    probe = np.concatenate([canon, rng.integers(0, 1 << 42, 500,
                                                dtype=np.uint64)])
    valid = rng.random(probe.shape[0]) > 0.1
    got = port.lookup_np(probe, valid)
    _same(got, ref.lookup_np(probe, valid))
    _same(got, world[2].lookup_np(probe, valid))
    assert (got[:canon.shape[0]][valid[:canon.shape[0]]] != 0).all()


@pytest.mark.parametrize("extra", [[], ["--parts-per-shard", "2"]],
                         ids=["parts8", "parts2"])
def test_cli_build_ooc_byte_identical(tmp_path, extra):
    """``build --ooc-shards 4`` in both CLIs: every shard file and meta.json
    byte for byte, taxonomy.npz by its arrays and content hash."""
    d = tmp_path / "td"
    assert ref_cli.main(["gen-testdata", "--out", str(d), "--reads", "10",
                         "--genome-len", "4000", "--seed", "2"]) == 0
    common = ["build", "--refs", str(d / "refs.fasta"), "--taxonomy",
              str(d / "taxonomy.tsv"), "--k", "21", "--ooc-shards", "4",
              *extra]
    ref, port = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(common + ["--out", str(ref)]) == 0
    assert cli.main(common + ["--out", str(port),
                              "--spill-dir", str(tmp_path / "spill")]) == 0
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
        "meta.json", *(f"shard{s:03d}" for s in range(4)), "taxonomy.npz"]
    meta = "meta.json"
    assert (port / meta).read_bytes() == (ref / meta).read_bytes()
    for s in range(4):
        names = sorted(os.listdir(ref / f"shard{s:03d}"))
        assert names == sorted(os.listdir(port / f"shard{s:03d}"))
        for name in names:
            assert (port / f"shard{s:03d}" / name).read_bytes() == \
                (ref / f"shard{s:03d}" / name).read_bytes(), (s, name)
    with np.load(ref / "taxonomy.npz", allow_pickle=True) as a, \
            np.load(port / "taxonomy.npz", allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    assert load_index_any(str(port)).taxonomy.content_hash() == \
        load_index_any(str(ref)).taxonomy.content_hash()
    assert os.listdir(tmp_path / "spill") == []   # every part reduced


@pytest.mark.parametrize("layout", ["q8", "std"])
def test_streaming_placement_equals_the_reference(ooc, layout):
    """A 4-shard container on a mesh of 4 shards: each shard's table, laid
    out from its own files (one process reads every shard's count), equals
    the reference's streaming placement's slice of that shard (std rows in
    K4's record form)."""
    port, ref = ooc
    mesh = make_mesh(MeshConfig(2, 4))
    if layout == "std":
        os.environ["PANGEA_LAYOUT"] = "std"
    try:
        want = place_index(ref, mesh)
    finally:
        os.environ.pop("PANGEA_LAYOUT", None)
    assert want.cfg.layout == layout
    for s in range(4):
        got = DeviceIndex.from_index(port, "cpu", layout=layout, n_shards=4,
                                     shard_id=s)
        assert got.cfg.n_shards == 4 and got.cfg.ways == want.cfg.ways
        rows = np.array(want.fused[s])
        if layout == "std":
            rows = record_rows(rows, want.cfg.ways)
        np.testing.assert_array_equal(got.fused.numpy(), rows.view(np.int32))
        np.testing.assert_array_equal(
            got.stash.numpy(), np.asarray(want.stash)[s].view(np.int32))


def _reference_route(hi, lo, S, C):
    """Lines 410-430 of the reference's ``_local_classify_routed`` on these
    (valid) probes: the owners, the overflow flag and the [S, C] grids."""
    N = hi.shape[0]
    log2S = S.bit_length() - 1
    owner = (hash32_jnp(hi, lo) >> jnp.uint32(32 - log2S)).astype(jnp.int32)
    idx = jnp.arange(N, dtype=jnp.int32)
    so, sidx = jax.lax.sort((owner, idx), num_keys=1)
    run_start = jnp.searchsorted(so, jnp.arange(S, dtype=jnp.int32),
                                 side="left").astype(jnp.int32)
    rank_sorted = idx - run_start[so]
    overflow = jnp.any(rank_sorted >= jnp.int32(C))
    pos = so * jnp.int32(C) + jnp.minimum(rank_sorted, jnp.int32(C - 1))
    dump = jnp.zeros(S * C, jnp.uint32)
    hi_g = dump.at[pos].set(hi[sidx])
    lo_g = dump.at[pos].set(lo[sidx])
    ix_g = jnp.full(S * C, -1, jnp.int32).at[pos].set(sidx)
    return (np.asarray(owner), bool(overflow), np.asarray(hi_g),
            np.asarray(lo_g), np.asarray(ix_g))


@pytest.mark.parametrize("cap_frac", [1.25, 0.01], ids=["fits", "overflow"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_route_bin_plain_is_the_reference_routing(world, n_shards, cap_frac):
    """The valid probes of 128 reads: each in its owner's bin once, the bins
    and the per-owner counts and the overflow flag as the reference's
    sort and scatters give them on those probes (the reference also sends
    the invalid probes to owner 0, which here stay home with inv -1), and
    the restore puts each slot's answer back at its probe."""
    _, _, idx, rs = world
    cfg = DeviceIndex.from_index(idx, "cpu").cfg
    hi, lo, valid = (x.reshape(-1) for x in _extract_probes(
        torch.from_numpy(pad_batch(rs.seqs, 128, 120)), None, cfg, True))
    assert 0 < int(valid.sum()) < valid.numel()
    C = route_capacity(hi.numel(), n_shards, cap_frac)
    records, inv, counts = route_bin_plain(hi, lo, valid, n_shards, C)
    v = valid.numpy()
    owner, over, hi_g, lo_g, ix_g = _reference_route(
        jnp.asarray(hi.numpy()[v].view(np.uint32)),
        jnp.asarray(lo.numpy()[v].view(np.uint32)), n_shards, C)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(owner, minlength=n_shards))
    assert (int(counts.max()) > C) == over
    assert (inv.numpy()[~v] == -1).all()
    if over:
        fits = inv.numpy() >= 0
        assert int(fits.sum()) == int(np.minimum(counts.numpy(), C).sum())
        return
    rec = records.numpy()
    used = ix_g >= 0
    np.testing.assert_array_equal(rec[:, 1].view(np.uint32), hi_g)
    np.testing.assert_array_equal(rec[:, 2].view(np.uint32), lo_g)
    np.testing.assert_array_equal(rec[:, 3], used.astype(np.int32))
    np.testing.assert_array_equal(rec[used, 0], np.flatnonzero(v)[ix_g[used]])
    np.testing.assert_array_equal(inv.numpy()[v] // C, owner)
    answers = torch.from_numpy(rec[:, [1, 2, 0, 3]].copy())
    back = route_restore_plain(inv, answers)
    for got, want in zip(back, (hi, lo, torch.arange(hi.numel()))):
        np.testing.assert_array_equal(got.numpy()[v],
                                      want.numpy().astype(np.int32)[v])
        assert (got.numpy()[~v] == 0).all()
