"""The port's classify step against the JAX step and the golden model (CPU).

Exact equality throughout: every output is an integer.
"""
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
from pangea_tpu_torch.classify.engine import TAX_KEYS

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
    """Sharded tables (the reference's placement on a mesh of two shards)
    are not ported: they raise."""
    _, _, idx, _ = world
    ref = RefDeviceIndex.from_index(idx, n_shards=2, layout="q8",
                                    device_put=False)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        DeviceIndex.from_numpy_tables(ref.tables, ref.cfg, "cpu")
