"""The port's one-shard relayouts and layout policy against the
reference's, byte for byte."""
import numpy as np
import pytest

from pangea_tpu.index.build import pick_layout as ref_pick_layout
from pangea_tpu.index.shard import shard_tables, shard_tables_quot
from pangea_tpu.kernels.lookup import q8_nb_for as q8_nb_for_ref
from pangea_tpu_torch.index import (pick_layout, q8_nb_for, relayout_q8,
                                    relayout_std)

from .helpers import small_world


@pytest.fixture(scope="module", params=[1, 8], ids=["w1", "w8"])
def world(request):
    return small_world(k=21, seed=3, genome_len=3000, w=request.param)


def _equal_arrays(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("ways,load_factor", [(64, 0.5), (4, 2.0)],
                         ids=["q8", "forced_stash"])
def test_relayout_byte_identical(world, ways, load_factor):
    idx = world[2]
    want = shard_tables_quot(idx, 1, ways, load_factor, "q8")
    got = relayout_q8(idx, ways, load_factor)
    assert got[2] == want[2]
    assert got[0].dtype == np.uint32
    _equal_arrays(got[:2], want[:2])
    if ways == 4:
        assert got[1].shape[2] > 0, "stash not exercised"


@pytest.mark.parametrize("load_factor", [0.5, 4.0], ids=["std",
                                                         "forced_stash"])
def test_std_relayout_byte_identical(world, load_factor):
    idx = world[2]
    got = relayout_std(idx, load_factor)
    want = shard_tables(idx, 1, load_factor)
    _equal_arrays(got, want)
    assert got[3].shape[2] >= 1


def test_q8_nb_for_grid():
    for n in (0, 1, 100, 5_000, 444_302, 2_000_000, 30_000_000):
        for k in (5, 15, 21, 23, 25, 27, 29, 31):
            for ways, lf in ((64, 0.5), (4, 2.0), (16, 0.5)):
                assert q8_nb_for(n, k, ways, lf) == \
                    q8_nb_for_ref(n, k, ways, lf), (n, k, ways, lf)


def test_q8_gate_agrees_with_pick_layout():
    """The port's auto layout decision for one shard (which replaced the
    q8-only gate) is the reference's, over the sizes, k and stamp widths
    the port meets."""
    for n in (1, 1_000, 444_302, 2_000_000, 30_000_000):
        for k in (15, 21, 23, 25, 27, 29, 31):
            for tout_max in (100, 0xFFFF, 0x10000):
                assert pick_layout(n, 1, k, tout_max) == \
                    ref_pick_layout(n, 1, k, tout_max), (n, k, tout_max)
