"""The port's jax-free q8 relayout against the reference's, byte for byte."""
import numpy as np
import pytest

from pangea_tpu.index.build import pick_layout
from pangea_tpu.index.shard import shard_tables_quot
from pangea_tpu.kernels.lookup import fuse_stash as fuse_stash_ref
from pangea_tpu.kernels.lookup import q8_nb_for as q8_nb_for_ref
from pangea_tpu_torch.index import q8_gate, q8_nb_for, relayout_q8

from .helpers import small_world


@pytest.fixture(scope="module", params=[1, 8], ids=["w1", "w8"])
def world(request):
    return small_world(k=21, seed=3, genome_len=3000, w=request.param)


def _reference(idx, ways, load_factor):
    fused, stash3, nb = shard_tables_quot(idx, 1, ways, load_factor, "q8")
    tax = idx.taxonomy
    return fused, fuse_stash_ref(stash3[0], tax.tin, tax.tout)[None], nb


@pytest.mark.parametrize("ways,load_factor", [(64, 0.5), (4, 2.0)],
                         ids=["q8", "forced_stash"])
def test_relayout_byte_identical(world, ways, load_factor):
    idx = world[2]
    want = _reference(idx, ways, load_factor)
    got = relayout_q8(idx, ways, load_factor)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.uint32
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    if ways == 4:
        assert got[1].shape[2] > 0, "stash not exercised"


def test_q8_nb_for_grid():
    for n in (0, 1, 100, 5_000, 444_302, 2_000_000, 30_000_000):
        for k in (5, 15, 21, 23, 25, 27, 29, 31):
            for ways, lf in ((64, 0.5), (4, 2.0), (16, 0.5)):
                assert q8_nb_for(n, k, ways, lf) == \
                    q8_nb_for_ref(n, k, ways, lf), (n, k, ways, lf)


def test_q8_gate_agrees_with_pick_layout():
    for n in (1, 1_000, 444_302, 2_000_000, 30_000_000):
        for k in (15, 21, 23, 25, 27, 29, 31):
            for tout_max in (100, 0xFFFF, 0x10000):
                want = pick_layout(n, 1, k, tout_max)
                if want == "q8":
                    assert q8_gate(n, k, tout_max) == "q8"
                else:
                    with pytest.raises(NotImplementedError, match="ROADMAP"):
                        q8_gate(n, k, tout_max)
