"""The port's classify step against the JAX step and the golden model (CPU).

Exact equality throughout: every output is an integer.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.classify.engine import DeviceIndex as RefDeviceIndex
from pangea_tpu.classify.engine import make_classify_fn as ref_classify_fn
from pangea_tpu.classify.engine import pad_batch as ref_pad_batch
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu_torch.classify import (Classifier, DeviceIndex,
                                       make_classify_fn, pad_batch)
from pangea_tpu_torch.classify.engine import (TAX_KEYS, _extract_probes,
                                              classify_reads, probe_tables)

from .helpers import small_world

READ_LEN = 120


@pytest.fixture(scope="module", params=[1, 8], ids=["w1", "w8"])
def world(request):
    return small_world(k=21, seed=9, genome_len=3000, n_reads=96,
                       read_len=READ_LEN, paired=True, w=request.param)


def _batch(rs):
    n = len(rs.seqs)
    return (pad_batch(rs.seqs, n, READ_LEN), pad_batch(rs.mates, n, READ_LEN))


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("thr", [0.0, 0.05])
def test_classifier_matches_jax_and_golden(world, paired, thr):
    _, _, idx, rs = world
    b1, b2 = _batch(rs)
    model = Classifier(DeviceIndex.from_index(idx, "cpu", thr))
    got = model(torch.from_numpy(b1),
                torch.from_numpy(b2) if paired else None)

    ref = RefDeviceIndex.from_index(idx, confidence_threshold=thr,
                                    layout="q8")
    fn = ref_classify_fn(ref.cfg, paired=paired)
    args = (jnp.asarray(b1), jnp.asarray(b2)) if paired else \
        (jnp.asarray(b1),)
    want = fn(ref.tables, *args)
    gold = classify_reads_golden(rs.seqs, idx, thr,
                                 mates=rs.mates if paired else None)
    for key in ("taxon", "best", "nvalid"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
        np.testing.assert_array_equal(got[key].numpy(),
                                      [getattr(g, key) for g in gold])
    assert (got["taxon"] != 0).any()


def test_numpy_tables_carry_over(world):
    """from_numpy_tables (the reference's host tables) and from_index (the
    port's own relayout) give identical tensors and identical outputs."""
    _, _, idx, rs = world
    ref = RefDeviceIndex.from_index(idx, confidence_threshold=0.05,
                                    layout="q8", device_put=False)
    a = DeviceIndex.from_numpy_tables(ref.tables, ref.cfg, "cpu")
    b = DeviceIndex.from_index(idx, "cpu", 0.05)
    assert a.cfg == b.cfg
    for x, y in ((a.fused, b.fused), (a.stash, b.stash),
                 *((a.tax[k], b.tax[k]) for k in TAX_KEYS)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    b1, b2 = (torch.from_numpy(x) for x in _batch(rs))
    fn = make_classify_fn(a.cfg, paired=True)
    out_a, out_b = fn(a.tables, b1, b2), fn(b.tables, b1, b2)
    for key in out_a:
        assert torch.equal(out_a[key], out_b[key])


def test_pad_batch_is_the_reference_copy(world):
    rs = world[3]
    seqs = rs.seqs[:10] + [np.zeros(0, np.uint8), rs.seqs[0][:5]]
    for batch, length in ((16, READ_LEN), (8, 50)):
        np.testing.assert_array_equal(pad_batch(seqs, batch, length),
                                      ref_pad_batch(seqs, batch, length))


def test_unsupported_layouts_raise(world):
    """Sharded tables carry over, one shard a rank: the reference's tables
    on a mesh of two shards give each shard's slice as the port's own
    placement of that shard does, and the two shards' hits summed (the
    broadcast step's merge) classify as the one-table step does, for q8
    and std. Only the reference's sub-tables (n_sub > 1, not ported) still
    raise."""
    for layout in ("q8", "std"):
        _check_two_shards(world, layout)


def _check_two_shards(world, layout):
    _, _, idx, rs = world
    ref = RefDeviceIndex.from_index(idx, n_shards=2, layout=layout,
                                    device_put=False, n_sub=1)
    shards = []
    for s in range(2):
        a = DeviceIndex.from_numpy_tables(ref.tables, ref.cfg, "cpu",
                                          shard_id=s)
        b = DeviceIndex.from_index(idx, "cpu", layout=layout, n_shards=2,
                                   shard_id=s)
        assert a.cfg == b.cfg and a.cfg.n_shards == 2
        for x, y in ((a.fused, b.fused), (a.stash, b.stash)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        shards.append(a)
    b1, b2 = (torch.from_numpy(x) for x in _batch(rs))
    hi, lo, valid = _extract_probes(b1, b2, shards[1].cfg, True)
    other = probe_tables(shards[1].tables, hi, lo, valid, shards[1].cfg,
                         shard_id=1)
    got = classify_reads(shards[0].tables, b1, shards[0].cfg,
                         mate_bases=b2, shard_id=0, merge_hits=lambda h: tuple(
                             x + y for x, y in zip(h, other)))
    whole = DeviceIndex.from_index(idx, "cpu", layout=layout)
    want = classify_reads(whole.tables, b1, whole.cfg, mate_bases=b2)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    sub = dataclasses.replace(ref.cfg, n_sub=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        DeviceIndex.from_numpy_tables(ref.tables, sub, "cpu")
