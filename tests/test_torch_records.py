"""K4's row form (``kernels/lookup.py`` ``record_rows``) and where it is laid
out, on the CPU: the permutation and its inverse on packed, wide and
forced-stash tables, numpy and tensors, in one chunk and in many; every
placement of a std table (the card's relayout on CPU tensors, the host
path, ``from_numpy_tables``, a sharded and a streamed placement) holds its
rows in the record form once, and says so, while q8 and q12 rows stay the
reference's."""
import numpy as np
import pytest
import torch

from pangea_tpu_torch import trace
from pangea_tpu_torch.bench import make_bench_world
from pangea_tpu_torch.classify import Classifier, DeviceIndex
from pangea_tpu_torch.classify.engine import _host_tables
from pangea_tpu_torch.index import (build_index, build_index_ooc,
                                    extract_pairs)
from pangea_tpu_torch.index.build import layout_table
from pangea_tpu_torch.kernels import fuse_table, record_rows
from pangea_tpu_torch.kernels import lookup as LK
from pangea_tpu_torch.utils import datagen

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=[
    (None, 16, 0.5), ((512, 64), 32, 0.5), ((512, 64), 4, 4.0)],
    ids=["packed", "wide", "forced_stash"])
def table(request):
    """(fuse_table's rows, W) of a bench world laid out at W."""
    tree, ways, load_factor = request.param
    bw = make_bench_world(n_reads=1, read_len=100, genome_len=1500, k=21,
                          w=1, tree=tree)
    tax = bw.taxonomy
    canon, taxa = extract_pairs(bw.index)
    kh, kl, val, _, _ = layout_table(canon, taxa, load_factor, ways=ways)
    return fuse_table(kh, kl, val, tax.tin, tax.tout), ways


@pytest.mark.parametrize("chunk", [1 << 16, 3], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_record_rows_round_trip(table, monkeypatch, chunk, kind):
    """Slot j's payload lanes become one record at lane 2W + mj (m = 2
    packed, 4 wide), the keys stay, the shape stays; the inverse gives the
    reference's bytes back."""
    monkeypatch.setattr(LK, "_PERMUTE_ROWS", chunk)
    ref, W = table
    m = ref.shape[1] // W - 2
    assert m == (2 if ref.shape[1] == 4 * W else 4)
    rows = ref.copy() if kind == "numpy" else torch.from_numpy(
        ref.view(np.int32).copy())
    got = record_rows(rows, W)
    assert got is rows and tuple(got.shape) == ref.shape
    got = np.asarray(got).view(np.uint32)
    np.testing.assert_array_equal(got[:, :2 * W], ref[:, :2 * W])
    for j in (0, 1, W - 1):
        for f in range(m):
            np.testing.assert_array_equal(got[:, 2 * W + m * j + f],
                                          ref[:, (2 + f) * W + j])
    assert got.tobytes() != ref.tobytes()
    back = record_rows(rows, W, inverse=True)
    assert np.asarray(back).tobytes() == ref.tobytes()


def _index(tmp_path_factory=None, n_shards=0):
    """A small std-able index: whole, or built as ``n_shards`` file
    shards."""
    tax = datagen.make_taxonomy(2, 4, 3)
    genomes = datagen.make_genomes(tax, genome_len=3000, seed=2)
    if n_shards:
        d = tmp_path_factory.mktemp("ooc")
        return build_index_ooc(genomes, tax, k=21, out=str(d / "idx"),
                               n_shards=n_shards, parts_per_shard=2)
    return build_index(genomes, tax, k=21)


def _placed(path, index, layout, shards=1, shard_id=0):
    """(the index placed by ``path``, its placement record or None)."""
    before = len(trace.placements())
    if path == "card":
        with trace.Placement(CPU) as place:
            di = DeviceIndex._laid_out_on(index, CPU, place, 0.05, layout)
    elif path == "numpy":
        di = DeviceIndex.from_numpy_tables(
            *_host_tables(index, 0.05, layout, shards, shard_id, None), CPU)
    else:
        di = DeviceIndex.from_index(index, CPU, 0.05, layout=layout,
                                    n_shards=shards, shard_id=shard_id)
    recs = trace.placements()[before:]
    assert len(recs) == (0 if path == "numpy" else 1)
    return di, (recs[0] if recs else None)


def _check(di, rec, index, layout, shards=1, shard_id=0):
    """The placed rows are the host's reference rows, permuted once for
    std; the index and its record name the form."""
    tables, cfg = _host_tables(index, 0.05, layout, shards, shard_id, None)
    want = np.ascontiguousarray(tables["fused"])
    assert di.cfg == cfg
    if layout == "std":
        want = record_rows(want, cfg.ways)
    assert di.fused.numpy().tobytes() == want.view(np.int32).tobytes()
    form = "records" if layout == "std" else None
    assert di.row_form == form
    if rec is not None:
        assert rec.get("row_form") == form
        assert ("row_form" in rec) == (layout == "std")


@pytest.mark.parametrize("layout", ["std", "q8", "q12"])
@pytest.mark.parametrize("path", ["card", "host", "numpy"])
def test_every_whole_placement_lays_out_records(path, layout):
    index = _index()
    di, rec = _placed(path, index, layout)
    _check(di, rec, index, layout)
    if rec is not None:
        assert rec["layout_on"] == ("card" if path == "card" else "host")


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["sliced", "streamed"])
def test_sharded_placements_lay_out_records(tmp_path_factory, streamed):
    """Each shard of a std table split 2 ways, sliced from a whole index or
    streamed from its own file shard, and the reference's [S, ...] tables
    carried over shard by shard."""
    index = _index(tmp_path_factory, 2) if streamed else _index()
    for s in range(2):
        for path in ("host", "numpy"):
            di, rec = _placed(path, index, "std", 2, s)
            _check(di, rec, index, "std", 2, s)


def test_classifier_keeps_the_placed_rows():
    """The Classifier's index, rebuilt from its buffers, holds the placed
    rows as they are: permuted once, not twice."""
    index = _index()
    di = DeviceIndex.from_index(index, CPU, layout="std")
    model = Classifier(di)
    again = model.index
    assert again.fused.data_ptr() == di.fused.data_ptr()
    assert torch.equal(again.fused, di.fused)
    assert again.row_form == "records"
    assert torch.equal(Classifier(again).index.fused, di.fused)
