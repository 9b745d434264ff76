"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
no jax, so it also runs where jax is absent:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Outputs are integers: the tolerance is exact equality throughout.
"""
import numpy as np
import pytest
import torch

from pangea_tpu.index import build_index as ref_build_index
from pangea_tpu.index.shard import extract_pairs
from pangea_tpu.taxonomy import Taxonomy as RefTaxonomy
from pangea_tpu.utils import datagen as ref_datagen
from pangea_tpu_torch import trace
from pangea_tpu_torch.bench import (K9_EDGE, chain_taxonomy, k1_edge_world,
                                    k9_edge_world, make_bench_world,
                                    route_bin_dirty, score_world)
from pangea_tpu_torch.classify import (Classifier, ClassifyConfig,
                                       DeviceIndex, MultiKClassifier,
                                       classify_multik, classify_reads,
                                       merge_multik_plain, pad_batch)
from pangea_tpu_torch.classify.engine import TAX_KEYS, _host_tables
from pangea_tpu_torch.golden import (GoldenResult, classify_read_golden,
                                     classify_reads_golden,
                                     merge_multik_golden)
from pangea_tpu_torch.index import relayout_q8, relayout_q12
from pangea_tpu_torch.index.build import layout_table
from pangea_tpu_torch.index.quot import Q12_WAYS
from pangea_tpu_torch.kernels import (KERNELS, _build, extract_probes,
                                      extract_probes_plain,
                                      fuse_stash, fuse_table, score_ranked,
                                      score_winners, score_winners_plain,
                                      wire_width,
                                      kernel_launches, lookup_q8,
                                      lookup_q8_plain, lookup_q12,
                                      lookup_q12_plain, lookup_std,
                                      lookup_std_plain,
                                      record_rows, reset_kernel_launches,
                                      score_reads_taxon,
                                      score_reads_taxon_plain,
                                      score_reads_tin, score_reads_tin_plain,
                                      general_reads, score_plan,
                                      score_reads_plain)
from pangea_tpu_torch.kernels.score import (MAX_PROBES, _launch_score,
                                            score_cap)
from pangea_tpu_torch.taxonomy import Taxonomy

from .helpers import small_world

pytestmark = pytest.mark.gpu

# Kernel launches of one paired step, by path.
_NONE = dict.fromkeys(KERNELS, 0)
Q8_STEP = {**_NONE, "extract_probes": 2, "lookup_q8": 1, "score_tin": 1}


def _tax(tax, device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in tax.device_arrays().items()}


@pytest.fixture
def launched(monkeypatch):
    """The launchers that ``_build.launch`` calls, in order: the kernel
    launches themselves (the lifted and merged tails launch none of their
    own)."""
    names = []
    real = _build.launch

    def spy(name, device, *args):
        names.append(name)
        return real(name, device, *args)
    monkeypatch.setattr(_build, "launch", spy)
    return names


def _own_launches(counts: dict) -> int:
    """The launches the wrappers' counts stand for: lca_lift and
    merge_multik count scorer launches, which the scorer counts too."""
    return sum(n for k, n in counts.items()
               if k not in ("lca_lift", "merge_multik"))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def world():
    return small_world(k=21, seed=7, n_reads=300, read_len=120, paired=True,
                       w=8)


def _codes(rng, B, L, n_frac=0.03):
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_frac] = 4
    codes[:3, L // 2:] = 4                          # padded tails
    codes[3, 5] = -1                                # negative = invalid
    return torch.from_numpy(codes)


@pytest.mark.parametrize("k,w,L", [(21, 8, 150), (21, 1, 150), (31, 16, 97),
                                   (3, 2, 40)])
def test_extract_probes_kernel_matches_plain(cuda, k, w, L):
    codes = _codes(np.random.default_rng(k * 100 + w), 257, L)
    NW = (L - k + 1) // w
    R = 2 * NW + 3
    outs = []
    for fn, dev in ((extract_probes_plain, "cpu"), (extract_probes, cuda)):
        out = (torch.full((257, R), 7, dtype=torch.int32, device=dev),
               torch.full((257, R), 7, dtype=torch.int32, device=dev),
               torch.zeros((257, R), dtype=torch.bool, device=dev))
        fn(codes.to(dev), k, w, out, NW + 1)
        outs.append([t.cpu() for t in out])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


_K1_EDGE = [(k, w, L) for k in (1, 21, 31) for w in (1, 3, 8, 32)
            for L in (k, 31 + k, 32 + k, 33 + k, 16384)
            if (L - k + 1) // w > 0]


@pytest.mark.parametrize("k,w,L", _K1_EDGE)
def test_k1_matches_plain_on_edge_worlds(cuda, k, w, L):
    """K1, codes and packed form, against its plain version on K1's edge
    worlds (bench.k1_edge_world: N at positions 31, 32, 63, 64, codes
    below 0, junk under bad flags and past the read), at col0 > 0, the
    wire rows a column slice of a wider batch."""
    from pangea_tpu_torch.kernels import extract_probes_packed
    B = 40 if L < 16384 else 8
    codes, rows = k1_edge_world(B, L, seed=L + k + w)
    NW = (L - k + 1) // w
    W = wire_width(L)
    wide = np.full((B, 2 * W + 3), 0x5A5A5A5A, np.uint32)
    wide[:, W + 2:2 * W + 2] = rows
    outs = []
    for fn, dev in ((extract_probes_plain, "cpu"), (extract_probes, cuda),
                    (extract_probes_packed, cuda)):
        out = (torch.full((B, NW + 9), 7, dtype=torch.int32, device=dev),
               torch.full((B, NW + 9), 7, dtype=torch.int32, device=dev),
               torch.zeros((B, NW + 9), dtype=torch.bool, device=dev))
        if fn is extract_probes_packed:
            part = torch.from_numpy(wide.view(np.int32)).to(dev)[
                :, W + 2:2 * W + 2]
            reset_kernel_launches()
            fn(part, L, k, w, out, 4)
            assert kernel_launches()["extract_packed"] == 1
        else:
            fn(torch.from_numpy(codes).to(dev), k, w, out, 4)
        torch.cuda.synchronize()
        outs.append([t.cpu() for t in out])
    for a, b, c in zip(*outs):
        assert torch.equal(a, b) and torch.equal(a, c)


def _probes(world):
    _, _, idx, rs = world
    canon, _ = extract_pairs(idx)
    rng = np.random.default_rng(3)
    absent = rng.integers(0, 1 << 42, size=500, dtype=np.uint64)
    keys = np.concatenate([canon, absent])
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    valid = rng.random(keys.shape[0]) < 0.9
    return torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid)


@pytest.mark.parametrize("ways,load_factor", [(64, 0.5), (4, 2.0)])
def test_lookup_q8_kernel_matches_plain(cuda, world, ways, load_factor):
    _, _, idx, _ = world
    fused, stash3, _ = relayout_q8(idx, ways, load_factor)
    if ways == 4:
        assert stash3.shape[2] > 0, "stash not exercised"
    tax = idx.taxonomy
    stash = fuse_stash(stash3[0], tax.tin, tax.tout)
    f = torch.from_numpy(fused[0].view(np.int32))
    s = torch.from_numpy(stash.view(np.int32))
    hi, lo, valid = _probes(world)
    want = lookup_q8_plain(hi, lo, valid, f, s, idx.meta.k)
    got = lookup_q8(hi.to(cuda), lo.to(cuda), valid.to(cuda), f.to(cuda),
                    s.to(cuda), idx.meta.k)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    assert int(want[0].sum()) > 0


@pytest.mark.parametrize("thr", [0.0, 0.3, 1.0])
def test_score_tin_kernel_matches_plain(cuda, world, thr):
    tax = world[0]
    rng = np.random.default_rng(5)
    B, R = 400, 32
    taxa = rng.integers(1, tax.num_taxa + 1, size=(B, R))
    hit = (rng.random((B, R)) < 0.4).astype(np.int32)
    hit[:20] = 0                                     # reads with no hit
    t_in = np.where(hit, tax.tin[taxa], 0).astype(np.int32)
    t_out = np.where(hit, tax.tout[taxa], 0).astype(np.int32)
    valid = rng.random((B, R)) < 0.8
    valid[20:30] = False                             # nvalid = 0
    args = [torch.from_numpy(a) for a in (hit, t_in, t_out, valid)]
    tax_t = _tax(tax, "cpu")
    want = score_reads_tin_plain(*args, tax_t, thr)
    got = score_reads_tin(*[a.to(cuda) for a in args], _tax(tax, cuda), thr)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())


def test_classifier_cuda_matches_plain_and_golden(cuda, world):
    _, _, idx, rs = world
    n = len(rs.seqs)
    b = torch.from_numpy(pad_batch(rs.seqs, n, 120))
    m = torch.from_numpy(pad_batch(rs.mates, n, 120))
    model = Classifier(DeviceIndex.from_index(idx, cuda, 0.05))
    reset_kernel_launches()
    got = {k: v.cpu() for k, v in model(b.to(cuda), m.to(cuda)).items()}
    assert kernel_launches() == Q8_STEP
    plain = classify_reads(model.index.tables, b.to(cuda), model.cfg,
                           mate_bases=m.to(cuda), plain=True)
    for key in got:
        assert torch.equal(got[key], plain[key].cpu())
    gold = classify_reads_golden(rs.seqs, idx, 0.05, mates=rs.mates)
    assert got["taxon"].tolist() == [g.taxon for g in gold]
    assert got["best"].tolist() == [g.best for g in gold]
    assert got["nvalid"].tolist() == [g.nvalid for g in gold]


def test_bench_world_on_the_card_matches_golden(cuda):
    """chip_smoke.py's world and shapes: 2048 pairs of 150 bp reads, k=21,
    w=8, the 16384 x 128 q8 table; the kernel path equals the golden model
    pair for pair."""
    n, L = 2048, 150
    bw = make_bench_world(n_reads=n, read_len=L, k=21, w=8)
    rs = bw.reads
    model = Classifier(DeviceIndex.from_index(bw.index, cuda, 0.0))
    assert tuple(model.fused.shape) == (16384, 128)
    got = model(torch.from_numpy(pad_batch(rs.seqs, n, L)).to(cuda),
                torch.from_numpy(pad_batch(rs.mates, n, L)).to(cuda))
    ref = _ref_world_index(21, 8, None, 50_000)
    gold = classify_reads_golden(rs.seqs, ref, 0.0, mates=rs.mates)
    for key in ("taxon", "best", "nvalid"):
        assert got[key].cpu().tolist() == [getattr(g, key) for g in gold]


def test_kernels_launch_on_a_device_that_is_not_current(world):
    """Tensors on the last card while the first is current: each launch
    runs on the tensors' card and stream."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    _, _, idx, rs = world
    n = len(rs.seqs)
    b = torch.from_numpy(pad_batch(rs.seqs, n, 120))
    m = torch.from_numpy(pad_batch(rs.mates, n, 120))
    want = Classifier(DeviceIndex.from_index(idx, "cpu", 0.05))(b, m)
    reset_kernel_launches()
    got = Classifier(DeviceIndex.from_index(idx, dev, 0.05))(b.to(dev),
                                                             m.to(dev))
    assert kernel_launches() == Q8_STEP
    assert torch.cuda.current_device() == 0
    for key in want:
        assert got[key].device == dev
        assert torch.equal(got[key].cpu(), want[key])


def test_wrappers_refuse_bad_inputs(cuda):
    codes = torch.zeros((4, 30), dtype=torch.int32, device=cuda)
    out = (torch.empty((4, 10), dtype=torch.int32, device=cuda),
           torch.empty((4, 10), dtype=torch.int32, device=cuda),
           torch.empty((4, 10), dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError):
        extract_probes(codes, 21, 1, out, 0)
    with pytest.raises(ValueError):
        extract_probes(codes.to(torch.int8).cpu(), 21, 1, out, 0)


# name -> (k, w, tree, launches of one paired step)
STD_WORLDS = {
    "wide": (21, 1, (512, 64), {**_NONE, "extract_probes": 2,
                                "lookup_std": 1, "score_taxon": 1,
                                "lca_lift": 1}),
    "k31_packed": (31, 8, None, {**_NONE, "extract_probes": 2,
                                 "lookup_std": 1, "score_taxon": 1}),
    "q8_lifting": (21, 1, (64, 40), {**Q8_STEP, "lca_lift": 1}),
}


def _ref_world_index(k, w, tree, genome_len):
    """The same world through the reference's jax-free builder, for
    golden."""
    tax = ref_datagen.make_taxonomy(2, *(tree or (8, 3)), seed=0)
    if tree:
        ids = {name: t for t, name in enumerate(tax.names)}
        tax.species_ids = [ids[f"Species_{p}_{g}_{s}"] for p in range(2)
                           for g in range(8) for s in range(3)]
    genomes = ref_datagen.make_genomes(tax, genome_len=genome_len, seed=1)
    return ref_build_index(genomes, tax, k=k, w=w, ways=0)


@pytest.mark.parametrize("thr", [0.0, 0.05])
@pytest.mark.parametrize("name", list(STD_WORLDS))
def test_std_and_lifting_classifier_cuda_matches_plain_and_golden(
        cuda, launched, name, thr):
    """K4, K3's taxon form and K5 (and K2 + K5 on a q8 index beyond 4,096
    taxa) on the card, the lift in the scorer's launch: the step equals the
    plain path and golden."""
    k, w, tree, launches = STD_WORLDS[name]
    n, L = 512, 150
    bw = make_bench_world(n_reads=n, read_len=L, genome_len=4000, k=k, w=w,
                          tree=tree)
    rs = bw.reads
    model = Classifier(DeviceIndex.from_index(bw.index, cuda, thr))
    b = torch.from_numpy(pad_batch(rs.seqs, n, L)).to(cuda)
    m = torch.from_numpy(pad_batch(rs.mates, n, L)).to(cuda)
    reset_kernel_launches()
    got = {key: v.cpu() for key, v in model(b, m).items()}
    assert kernel_launches() == launches
    assert len(launched) == _own_launches(launches)
    assert "lca" not in " ".join(launched)
    plain = classify_reads(model.index.tables, b, model.cfg, mate_bases=m,
                           plain=True)
    for key in got:
        assert torch.equal(got[key], plain[key].cpu())
    ref = _ref_world_index(k, w, tree, 4000)
    gold = classify_reads_golden(rs.seqs, ref, thr, mates=rs.mates)
    for key in ("taxon", "best", "nvalid"):
        assert got[key].tolist() == [getattr(g, key) for g in gold]


@pytest.mark.parametrize("tree,ways,load_factor", [
    (None, 16, 0.5), ((512, 64), 32, 0.5), ((512, 64), 4, 4.0)],
    ids=["packed", "wide", "forced_stash"])
def test_lookup_std_kernel_matches_plain(cuda, tree, ways, load_factor):
    bw = make_bench_world(n_reads=1, read_len=150, genome_len=3000, k=21,
                          w=1, tree=tree)
    tax = bw.taxonomy
    canon, taxa = extract_pairs(bw.index)
    kh, kl, val, st, _ = layout_table(canon, taxa, load_factor, ways=ways)
    f = torch.from_numpy(record_rows(fuse_table(kh, kl, val, tax.tin,
                                                tax.tout), ways)
                         .view(np.int32))
    s = torch.from_numpy(fuse_stash(st, tax.tin, tax.tout).view(np.int32))
    if load_factor > 1:
        assert s.shape[1] > 0, "stash not exercised"
    rng = np.random.default_rng(8)
    keys = np.concatenate([canon, rng.integers(0, 1 << 42, size=500,
                                               dtype=np.uint64)])
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.uint32)
                          .view(np.int32))
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                          .view(np.int32))
    valid = torch.from_numpy(rng.random(keys.shape[0]) < 0.9)
    want = lookup_std_plain(hi, lo, valid, f, s, ways)
    got = lookup_std(hi.to(cuda), lo.to(cuda), valid.to(cuda), f.to(cuda),
                     s.to(cuda), ways)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    assert int((want[0] != 0).sum()) > 0
    # The golden model's lookup of the same keys, and the taxa's stamps.
    gold = bw.index.lookup_np(keys, valid.numpy())
    hit = gold != 0
    for a, b in zip(got, (gold, np.where(hit, tax.tin[gold], 0),
                          np.where(hit, tax.tout[gold], 0))):
        np.testing.assert_array_equal(a.cpu().numpy(), b)


@pytest.mark.parametrize("thr", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("tree", [None, (512, 64)], ids=["direct",
                                                         "lifting"])
def test_score_taxon_kernel_matches_plain(cuda, launched, tree, thr):
    """K3's taxon form, its LCA direct or lifted in the same launch."""
    tax = ref_datagen.make_taxonomy(2, *(tree or (8, 3)), seed=0)
    rng = np.random.default_rng(6)
    B, R = 400, 260
    lineage = rng.integers(1, tax.num_taxa + 1, size=(B, 4))
    taxa = lineage[np.arange(B)[:, None], rng.integers(0, 4, size=(B, R))]
    taxon = np.where(rng.random((B, R)) < 0.5, taxa, 0).astype(np.int32)
    taxon[:20] = 0
    t_in = np.where(taxon != 0, tax.tin[taxon], 0).astype(np.int32)
    t_out = np.where(taxon != 0, tax.tout[taxon], 0).astype(np.int32)
    valid = (rng.random((B, R)) < 0.8) | (taxon != 0)
    valid[20:30] = False
    args = [torch.from_numpy(a) for a in (taxon, t_in, t_out, valid)]
    reset_kernel_launches()
    got = score_reads_taxon(*[a.to(cuda) for a in args], _tax(tax, cuda),
                            thr)
    assert kernel_launches()["lca_lift"] == (1 if tree else 0)
    assert kernel_launches()["score_taxon"] == 1
    assert launched == ["pangea_score"]
    want = score_reads_taxon_plain(*args, _tax(tax, "cpu"), thr)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())


def _chain_reads(tax, B, R, rng):
    """[B, R] scorer inputs on a chain whose winners are two deep chain
    nodes a read: R // 4 hits on each node's unit interval [tin, tin + 1),
    so the two tie; the hits' lanes are random chain nodes (the taxon
    form's u and v), the other probes misses. Read 0 has no hit, read 1
    no valid probe."""
    n = tax.num_taxa
    nodes = rng.integers(1, n + 1, size=(B, 2))
    which = rng.permuted(np.repeat([[0] * (R // 4) + [1] * (R // 4)
                                    + [-1] * (R - 2 * (R // 4))], B, 0),
                         axis=1)
    node = np.where(which >= 0,
                    np.take_along_axis(nodes, np.maximum(which, 0), 1), 0)
    t_in = np.where(which >= 0, tax.tin[node], 0).astype(np.int32)
    t_out = np.where(which >= 0, t_in + 1, 0).astype(np.int32)
    taxon = np.where(which >= 0, rng.integers(1, n + 1, size=(B, R)),
                     0).astype(np.int32)
    taxon[0] = 0
    valid = (rng.random((B, R)) < 0.8) | (taxon != 0)
    valid[1] = False
    return taxon, t_in, t_out, valid


@pytest.mark.parametrize("q8", [False, True], ids=["taxon", "q8"])
def test_lca_lift_kernel_matches_plain_on_a_chain(cuda, launched, q8):
    """K5 in the scorer's launch on a 5,000-node chain: 13 lifting levels,
    the winners two random deep chain nodes a read (taxon form: lanes of
    random chain nodes), every pair a deep walk; one launch a call."""
    n = 5000
    parent = np.arange(-1, n, dtype=np.int32)
    parent[:2] = (0, 1)
    tax = Taxonomy(parent=parent, rank=np.zeros(n + 1, np.int8),
                   names=["unclassified"] + [f"n{i}" for i in range(n)])
    assert tax.lifting_table().shape[0] >= 10
    rng = np.random.default_rng(9)
    taxon, t_in, t_out, valid = _chain_reads(tax, 20000, 32, rng)
    lanes = (taxon != 0).astype(np.int32) if q8 else taxon
    args = [torch.from_numpy(a) for a in (lanes, t_in, t_out, valid)]
    cargs = [a.to(cuda) for a in args]
    fn = score_reads_tin if q8 else score_reads_taxon
    for thr in (0.0, 0.5):
        want = score_reads_plain(*args, _tax(tax, "cpu"), thr, not q8)
        reset_kernel_launches()
        launched.clear()
        got = fn(*cargs, _tax(tax, cuda), thr)
        assert kernel_launches()["lca_lift"] == 1
        assert launched == ["pangea_score"]
        for a, b in zip(want, got):
            assert torch.equal(a, b.cpu())
        if thr == 0.0:             # every read with a hit is classified
            depth = torch.from_numpy(tax.depth)[want[0][2:].long()]
            assert int(depth.max()) > 1000 and (want[0][2:] != 0).all()


def _q12_index(idx, device, thr):
    """The port's q12 placement of an index, whatever pick_layout says."""
    tax = idx.taxonomy
    fused, stash3, _ = relayout_q12(idx)
    tables = {"fused": fused,
              "stash": fuse_stash(stash3[0], tax.tin, tax.tout)[None],
              "tax": tax.device_arrays()}
    cfg = ClassifyConfig(k=idx.meta.k, confidence_threshold=thr,
                         w=idx.meta.w, ways=Q12_WAYS, layout="q12")
    return DeviceIndex.from_numpy_tables(tables, cfg, device)


@pytest.fixture(scope="module")
def world31():
    return small_world(k=31, seed=7, n_reads=300, read_len=120, paired=True)


@pytest.mark.parametrize("name,ways,load_factor", [
    ("world31", Q12_WAYS, 0.5), ("world", Q12_WAYS, 0.5),
    ("world31", 4, 2.0)], ids=["k31", "k21_r_below_32", "forced_stash"])
def test_lookup_q12_kernel_matches_plain(cuda, request, name, ways,
                                         load_factor):
    """K2's q12 form: r >= 32 (k=31), r < 32 (k=21) and a forced stash, on
    every stored key, 500 absent ones and, where r > 32, the near misses of
    500 stored keys (their bucket and rem_lo, another rem_hi)."""
    _, _, idx, _ = request.getfixturevalue(name)
    fused, stash3, nb = relayout_q12(idx, ways, load_factor)
    if ways == 4:
        assert stash3.shape[2] > 0, "stash not exercised"
    tax = idx.taxonomy
    f = torch.from_numpy(fused[0].view(np.int32))
    s = torch.from_numpy(fuse_stash(stash3[0], tax.tin,
                                    tax.tout).view(np.int32))
    canon, _ = extract_pairs(idx)
    rng = np.random.default_rng(4)
    k = idx.meta.k
    keys = [canon, rng.integers(0, 1 << (2 * k), size=500, dtype=np.uint64)]
    if 2 * k - (nb.bit_length() - 1) > 32:
        a = 0x9E3779B1
        mask = np.uint64((1 << (2 * k)) - 1)
        h = (canon[:500] * np.uint64(a)) & mask
        near = ((h ^ np.uint64(1 << 32))
                * np.uint64(pow(a, -1, 1 << (2 * k)))) & mask
        keys.append(near[~np.isin(near, canon)])
    keys = np.concatenate(keys)
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.uint32)
                          .view(np.int32))
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                          .view(np.int32))
    valid = torch.from_numpy(rng.random(keys.shape[0]) < 0.9)
    want = lookup_q12_plain(hi, lo, valid, f, s, k, ways)
    got = lookup_q12(hi.to(cuda), lo.to(cuda), valid.to(cuda), f.to(cuda),
                     s.to(cuda), k, ways)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    assert int(want[0][:canon.shape[0]].sum()) > 0.85 * canon.shape[0]
    assert not want[0][canon.shape[0]:].any()


def _chain_tax(n):
    parent = np.arange(-1, n, dtype=np.int32)
    parent[:2] = (0, 1)
    return RefTaxonomy(parent=parent, rank=np.zeros(n + 1, np.int8),
                       names=["unclassified"] + [f"n{i}" for i in range(n)])


def _prior_calls(own, n_taxa, rng):
    """An earlier call (int32 numpy taxon, best, nvalid) for reads whose
    own call is ``own``: random calls, 30 % of them agreeing, exact
    confidence ties on the first 50 reads, and the int32 extremes of
    tests/test_hardening.py on the last five and on read 0 (no hit, some
    valid probes: the n1 + n2 wrap)."""
    t2, b2, n2 = own
    B = t2.shape[0]
    t1 = rng.integers(0, n_taxa + 1, size=B)
    t1 = np.where(rng.random(B) < 0.3, t2, t1)
    n1 = rng.integers(0, 300, size=B)
    b1 = np.where(t1 == 0, 0, np.minimum(rng.integers(0, 300, size=B), n1))
    b1[:50], n1[:50] = 2 * b2[:50], 2 * n2[:50]
    big = 2**30
    other = (t2[-4:] % n_taxa) + 1
    extremes = [(t2[-1], big, big + 1), (other[0], 2**31 - 1, 2**31 - 1),
                (t2[-3], big + 1, big), (other[1], big - 1, big),
                (0, 0, 2**31 - 1)]
    for j, c in enumerate(extremes):
        t1[B - 1 - j], b1[B - 1 - j], n1[B - 1 - j] = c
    t1[0], b1[0], n1[0] = 0, 0, 2**31 - 1
    return [np.ascontiguousarray(a, dtype=np.int32) for a in (t1, b1, n1)]


@pytest.mark.parametrize("tree", ["bench", "wide", "chain",
                                  "bench_over_wide"])
def test_merge_multik_kernel_matches_plain(cuda, launched, tree):
    """K7 in the scorer's launch: each read's call merged with a random
    earlier one (agreements, conflicts, zeros, ties), on the bench tree
    (the direct LCA), the 66,563-taxon tree and a 5,000-node chain (13
    lifting levels; both lifted), and the bench tree scored but merged over
    the wide tree; the int32 extreme cases in the prior; both forms, one
    launch a call; against the plain scorer + merge and golden."""
    make = {"bench": lambda: ref_datagen.make_taxonomy(2, 8, 3, seed=0),
            "wide": lambda: ref_datagen.make_taxonomy(2, 512, 64, seed=0),
            "chain": lambda: _chain_tax(5000)}
    tax = make[tree.split("_")[0]]()
    mtax = make["wide"]() if tree == "bench_over_wide" else tax
    B, R = 20000, 32
    rng = np.random.default_rng(len(tree))
    taxon, t_in, t_out, valid = _lineage_lanes(tax, B, R, seed=len(tree))
    keys = ("taxon", "best", "nvalid")
    for taxon_lanes in (True, False):
        lanes = taxon if taxon_lanes else (taxon != 0).astype(np.int32)
        args = [torch.from_numpy(a) for a in (lanes, t_in, t_out, valid)]
        own = score_reads_plain(*args, _tax(tax, "cpu"), 0.05, taxon_lanes)
        prior = dict(zip(keys, map(torch.from_numpy, _prior_calls(
            [o.numpy() for o in own], mtax.num_taxa, rng))))
        want = merge_multik_plain(prior, dict(zip(keys, own)),
                                  _tax(mtax, "cpu"))
        fn = score_reads_taxon if taxon_lanes else score_reads_tin
        reset_kernel_launches()
        launched.clear()
        got = fn(*[a.to(cuda) for a in args], _tax(tax, cuda), 0.05,
                 prior=({k: v.to(cuda) for k, v in prior.items()},
                        _tax(mtax, cuda)))
        assert kernel_launches()["merge_multik"] == 1
        assert launched == ["pangea_score"]
        for key, g in zip(keys, got):
            assert torch.equal(want[key], g.cpu())
        t1, t2 = prior["taxon"], own[0]
        assert ((t1 != 0) & (t2 != 0) & (t1 != t2)).sum() > 1000
        assert ((t1 != 0) & (t1 == t2)).sum() > 1000
        # Golden sums two unclassified calls' nvalid unwrapped.
        rows = [i for i in (*range(0, B, 97), *range(B - 5, B))
                if int(t1[i]) != 0 or int(t2[i]) != 0]
        gold = [merge_multik_golden(
            GoldenResult(*(int(prior[k][i]) for k in keys)),
            GoldenResult(*(int(o[i]) for o in own)), mtax) for i in rows]
        for key, g in zip(keys, got):
            assert g.cpu()[rows].tolist() == [getattr(x, key) for x in gold]
        assert int(own[2][0]) > 0 and int(got[2][0]) < 0      # the wrap


@pytest.mark.parametrize("thr", [0.0, 0.05])
def test_multik_classifier_cuda_matches_plain_and_golden(cuda, launched,
                                                         world, thr):
    """Config 4 on a small world: the k=21 q8 index and a k=31 q12 index on
    the same genomes; the step on the card equals the plain path and the
    golden merge of the two golden calls."""
    tax, genomes, _, rs = world
    idx21 = ref_build_index(genomes, tax, k=21, w=8)
    idx31 = ref_build_index(genomes, tax, k=31)
    model = MultiKClassifier([DeviceIndex.from_index(idx21, cuda, thr),
                              _q12_index(idx31, cuda, thr)])
    assert [c.cfg.layout for c in model.classifiers] == ["q8", "q12"]
    n = len(rs.seqs)
    b = torch.from_numpy(pad_batch(rs.seqs, n, 120)).to(cuda)
    m = torch.from_numpy(pad_batch(rs.mates, n, 120)).to(cuda)
    reset_kernel_launches()
    got = {key: v.cpu() for key, v in model(b, m).items()}
    assert kernel_launches() == {**_NONE, "extract_probes": 4,
                                 "lookup_q8": 1, "lookup_q12": 1,
                                 "score_tin": 2, "merge_multik": 1}
    assert launched.count("pangea_score") == 2 and len(launched) == 8
    plain = classify_multik(tuple(c.index.tables for c in model.classifiers),
                            b, tuple(c.cfg for c in model.classifiers),
                            mate_bases=m, plain=True)
    for key in got:
        assert torch.equal(got[key], plain[key].cpu())
    gold = [merge_multik_golden(x, y, tax) for x, y in zip(
        classify_reads_golden(rs.seqs, idx21, thr, mates=rs.mates),
        classify_reads_golden(rs.seqs, idx31, thr, mates=rs.mates))]
    for key in ("taxon", "best", "nvalid"):
        assert got[key].tolist() == [getattr(g, key) for g in gold]


def _lineage_lanes(tax, B, R, seed):
    """[B, R] hit taxa from four taxa a read, half of them misses, and their
    Euler intervals; read 0 has no hit and read 1 no valid probe."""
    rng = np.random.default_rng(seed)
    lineage = rng.integers(1, tax.num_taxa + 1, size=(B, 4))
    taxa = lineage[np.arange(B)[:, None], rng.integers(0, 4, size=(B, R))]
    taxon = np.where(rng.random((B, R)) < 0.5, taxa, 0).astype(np.int32)
    taxon[0] = 0
    t_in = np.where(taxon != 0, tax.tin[taxon], 0).astype(np.int32)
    t_out = np.where(taxon != 0, tax.tout[taxon], 0).astype(np.int32)
    valid = (rng.random((B, R)) < 0.8) | (taxon != 0)
    valid[1] = False
    return taxon, t_in, t_out, valid


@pytest.mark.parametrize("B,R", [(40, 2049), (70, 16364), (6, 32728)],
                         ids=["2049", "16364_shared", "32728_scratch"])
@pytest.mark.parametrize("tree", [None, (64, 40)], ids=["direct",
                                                        "lifting"])
def test_score_ranked_kernel_matches_plain(cuda, tree, B, R):
    """K8 in both forms, with the direct LCA and with K5's lifting, at two
    thresholds, its sort in shared memory and in the device scratch."""
    tax = ref_datagen.make_taxonomy(2, *(tree or (8, 3)), seed=0)
    taxon, t_in, t_out, valid = _lineage_lanes(tax, B, R, seed=R)
    for lanes, taxon_lanes in ((taxon, True),
                               ((taxon != 0).astype(np.int32), False)):
        args = [torch.from_numpy(a) for a in (lanes, t_in, t_out, valid)]
        cargs = [a.to(cuda) for a in args]
        reset_kernel_launches()
        got = score_winners(*cargs, taxon_lanes)
        assert kernel_launches()["score_ranked"] == 1
        for a, b in zip(score_winners_plain(*args, taxon_lanes), got):
            assert torch.equal(a, b.cpu())
        for thr in (0.0, 0.05):
            want = score_ranked(*args, _tax(tax, "cpu"), thr, taxon_lanes)
            got = score_ranked(*cargs, _tax(tax, cuda), thr, taxon_lanes)
            for a, b in zip(want, got):
                assert torch.equal(a, b.cpu())
            assert (want[0] != 0).any()


def _u_cases():
    """(R, B, U, nested) of the scorer worlds: U None is every hit its own
    interval (no misses); U past score_cap(R) sends reads to the general
    branch in every form; R = 2048 is K3's last width and 2049 K8's
    first."""
    for R, B in ((32, 300), (260, 200), (1180, 40), (2048, 12), (2049, 12),
                 (16364, 4)):
        for U in (1, 8, 64, None):
            for nested in (False, True):
                if U is not None and U > R // 2:
                    continue
                yield R, B, U, nested


def _u_tax(R, U, nested):
    if nested:
        return chain_taxonomy(max(R if U is None else U, 64) + 2)
    if U is None and R > 5000:
        return ref_datagen.make_taxonomy(2, 512, 64, seed=0)
    return ref_datagen.make_taxonomy(2, *((8, 3) if U and U <= 8
                                          else (64, 40)), seed=0)


@pytest.mark.parametrize("R,B,U,nested", list(_u_cases()),
                         ids=[f"R{r}-U{'all' if u is None else u}-"
                              f"{'nested' if n else 'unrel'}"
                              for r, _, u, n in _u_cases()])
def test_scorer_kernels_match_plain_on_chosen_u(cuda, R, B, U, nested):
    """K3 (both forms) or K8 on scorer worlds of chosen U against the plain
    scorer: winners, and the direct or lifted LCA at two thresholds; the
    reads past score_cap(R) distinct intervals take the general branch, and
    only they."""
    tax = _u_tax(R, U, nested)
    world = score_world(tax, B, R, U, nested, 0.0 if U is None else 0.5,
                        seed=R + (U or 7))
    tax_c, tax_h = _tax(tax, cuda), _tax(tax, "cpu")
    hits = R if U is None else R - round(0.5 * R)
    distinct = hits if U is None else U
    for taxon_lanes in (True, False):
        lanes = world[0] if taxon_lanes else (world[0] != 0).astype(np.int32)
        args = [torch.from_numpy(a) for a in (lanes, *world[1:])]
        cargs = [a.to(cuda) for a in args]
        reset_kernel_launches()
        got = score_winners(*cargs, taxon_lanes)
        for a, b in zip(score_winners_plain(*args, taxon_lanes), got):
            assert torch.equal(a, b.cpu())
        for thr in (0.0, 0.3):
            want = score_reads_plain(*args, tax_h, thr, taxon_lanes)
            if R > MAX_PROBES:
                got = score_ranked(*cargs, tax_c, thr, taxon_lanes)
            else:
                fn = score_reads_taxon if taxon_lanes else score_reads_tin
                got = fn(*cargs, tax_c, thr)
            for a, b in zip(want, got):
                assert torch.equal(a, b.cpu())
        name = ("score_ranked" if R > MAX_PROBES else
                "score_taxon" if taxon_lanes else "score_tin")
        assert general_reads()[name] == (
            3 * (B - 1) if distinct > score_cap(R) else 0)


@pytest.mark.parametrize("R,B", [(32, 300), (260, 100), (2048, 8),
                                 (2049, 8), (16364, 3)])
@pytest.mark.parametrize("cap", [1, 4])
def test_scorer_general_branch_at_a_small_cap(cuda, R, B, cap):
    """A plan whose table holds 1 or 4 intervals sends the reads of U = 8
    down the general branch, in both forms of K3 and K8."""
    tax = chain_taxonomy(64)
    for nested in (False, True):
        world = score_world(tax, B, R, 8, nested, 0.5, seed=R + cap)
        plan = score_plan(B, R, torch.cuda.get_device_properties(
            cuda).multi_processor_count, cap)
        for taxon_lanes in (True, False):
            lanes = (world[0] if taxon_lanes
                     else (world[0] != 0).astype(np.int32))
            args = [torch.from_numpy(a) for a in (lanes, *world[1:])]
            reset_kernel_launches()
            cargs = [a.to(cuda) for a in args]
            got = _launch_score(cargs[0].device, *cargs, taxon_lanes,
                                plan=plan)
            assert sum(general_reads().values()) == B - 1
            for a, b in zip(score_winners_plain(*args, taxon_lanes), got):
                assert torch.equal(a, b.cpu())


def test_long_reads_on_the_card_match_golden(cuda):
    """Genome slices of 2.5 and 5 kb at k=21, w=1 (R = 2,380 and 4,780 in
    their buckets): the Classifier on the card launches K8 and equals the
    plain path and golden read by read."""
    tax, genomes, idx, _ = small_world(k=21, seed=3, genome_len=6000,
                                       n_reads=1, w=1)
    rng = np.random.default_rng(5)
    model = Classifier(DeviceIndex.from_index(idx, cuda, 0.0))
    for n, Lj in ((2500, 4800), (2300, 2400)):
        seqs = []
        for _ in range(12):
            codes, _ = genomes[rng.integers(0, len(genomes))]
            s = rng.integers(0, len(codes) - n)
            seqs.append(np.asarray(codes[s:s + n], dtype=np.uint8))
        b = torch.from_numpy(pad_batch(seqs, len(seqs), Lj)).to(cuda)
        reset_kernel_launches()
        got = {k: v.cpu() for k, v in model(b).items()}
        assert kernel_launches()["score_ranked"] == 1
        plain = classify_reads(model.index.tables, b, model.cfg, plain=True)
        gold = [classify_read_golden(sq, idx, 0.0) for sq in seqs]
        for key in ("taxon", "best", "nvalid"):
            assert torch.equal(got[key], plain[key].cpu())
            assert got[key].tolist() == [getattr(g, key) for g in gold]


@pytest.mark.parametrize("k,w,L", [(21, 8, 150), (21, 1, 150), (31, 16, 97)])
def test_extract_packed_kernel_matches_code_form(cuda, k, w, L):
    """K1's packed form on wire rows that are column slices of one batch
    (both mates, as the fast path ships them) equals K1 on the codes and
    the plain version on the rows."""
    from pangea_tpu_torch.kernels.encode import wire_codes
    rng = np.random.default_rng(k + w)
    B, W = 257, wire_width(L)
    words = rng.integers(0, 1 << 32, size=(B, 2 * W), dtype=np.uint64)
    # Bad flags on about 3 % of the bases, all of them past the read.
    bad = (rng.random((B, 2, (W - (L + 15) // 16) * 32)) < 0.03)
    bad[:, :, L:] = True
    bits = (bad.reshape(B, 2, -1, 32) << np.arange(32, dtype=np.uint64)) \
        .sum(-1)
    words = words.reshape(B, 2, W)
    words[:, :, (L + 15) // 16:] = bits
    rows = torch.from_numpy(words.reshape(B, 2 * W).astype(np.uint32)
                            .view(np.int32))
    NW = (L - k + 1) // w
    outs = []
    for fn, dev, packed in ((extract_probes_plain, "cpu", True),
                            (extract_probes, cuda, True),
                            (extract_probes, cuda, False)):
        out = (torch.full((B, 2 * NW + 1), 7, dtype=torch.int32, device=dev),
               torch.full((B, 2 * NW + 1), 7, dtype=torch.int32, device=dev),
               torch.zeros((B, 2 * NW + 1), dtype=torch.bool, device=dev))
        r = rows.to(dev)
        reset_kernel_launches()
        for m in range(2):
            part = r[:, m * W:(m + 1) * W]
            if packed:
                fn(part, k, w, out, 1 + m * NW, packed_len=L)
            else:
                fn(wire_codes(part, L), k, w, out, 1 + m * NW)
        if dev != "cpu":
            assert kernel_launches()["extract_packed" if packed
                                     else "extract_probes"] == 2
        outs.append([t.cpu() for t in out])
    for a, b, c in zip(*outs):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_fast_path_cli_on_the_card_equals_the_cpu(cuda, tmp_path, capsys):
    """The CLI's fast path on the card (native reader, K1's packed form)
    writes the same files as on the CPU, and its long-read path too."""
    import json

    from pangea_tpu.utils import datagen as rdg
    from pangea_tpu_torch import cli
    tax, genomes, idx, rs = small_world(k=21, seed=4, genome_len=3000,
                                        n_reads=300, read_len=120,
                                        paired=True, w=8)
    idx.save(str(tmp_path / "idx"))
    rdg.write_fastq(str(tmp_path / "a_1.fq"), rs, mate=1)
    rdg.write_fastq(str(tmp_path / "a_2.fq"), rs, mate=2)
    # Fast path: 3 batches x 2 mates. Long-read path: every 120 bp read is
    # past L = 100, so each batch runs the 200-base bucket, 64 reads a
    # launch: 5 launches x 2 mates.
    for extra, kernel, n in (([], "extract_packed", 6),
                             (["input.long_reads=true"], "extract_probes",
                              10)):
        outs = {}
        for dev in ("cpu", "cuda"):
            outs[dev] = tmp_path / f"out_{dev}_{len(extra)}"
            assert cli.main(["classify", "--index", str(tmp_path / "idx"),
                             "--reads", str(tmp_path / "a_1.fq"),
                             "--mates", str(tmp_path / "a_2.fq"),
                             "--out", str(outs[dev]), "--device", dev,
                             "input.batch_size=128",
                             "input.max_read_len=100", *extra]) == 0
            result = json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])
            assert result["fast_path"] is (not extra)
        assert result["kernel_launches"][kernel] == n
        for f in ("a_1.assign.tsv", "a_1.summary.tsv", "stats.json"):
            assert (outs["cpu"] / f).read_bytes() == \
                (outs["cuda"] / f).read_bytes(), f


@pytest.mark.parametrize("nb,k", [(1 << 10, 21), (1 << 19, 21), (1 << 20, 31),
                                  (1 << 22, None)],
                         ids=["q8_1024", "q8_deep", "q12_k31", "std_deep"])
def test_bucket_sort_kernel_groups_its_keys(cuda, nb, k):
    """K9's output is a permutation whose probes' keys ascend, key for key
    those of the plain version's (a stable torch.sort), each record with
    its probe's lanes, and inv the inverse permutation."""
    from pangea_tpu_torch.kernels import bucket_sort, bucket_sort_plain
    from pangea_tpu_torch.kernels.lookup import bucket_keys, key_shift
    rng = np.random.default_rng(nb)
    n = 200_003
    hi = torch.from_numpy(rng.integers(0, 1 << (2 * (k or 21) - 32), size=n,
                                       dtype=np.int64).astype(np.int32))
    lo = torch.from_numpy(rng.integers(0, 1 << 32, size=n,
                                       dtype=np.int64).astype(np.uint32)
                          .view(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    reset_kernel_launches()
    records, inv = (t.cpu() for t in bucket_sort(
        hi.to(cuda), lo.to(cuda), valid.to(cuda), nb, k))
    assert kernel_launches()["bucket_sort"] == 1
    perm = records[:, 0].long()
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    assert torch.equal(inv[perm], torch.arange(n, dtype=torch.int32))
    for j, lanes in enumerate((hi, lo, valid.to(torch.int32)), 1):
        assert torch.equal(records[:, j], lanes[perm])
    keys = bucket_keys(hi, lo, valid, nb, k)
    want = keys[bucket_sort_plain(hi, lo, valid, nb, k)[0][:, 0].long()]
    assert torch.equal(keys[perm], want)
    assert int(want[-1]) == (nb >> key_shift(nb)) - 1


def _deep_tables(world, world31):
    """(name, wrapper, plain, args) of each sorted form on a small table:
    q8 and q12 (r < 32) of the k=21 world, q12 (r >= 32) of the k=31 world,
    std packed rows and std wide rows (the stamps scaled past 16 bits)."""
    from pangea_tpu_torch.kernels import (lookup_q8_sorted, lookup_q12_sorted,
                                          lookup_std_sorted)
    out = []
    for name, w, layout in (("q8", world, "q8"), ("q12_k21", world, "q12"),
                            ("q12_k31", world31, "q12")):
        idx = w[2]
        fused, stash3, _ = (relayout_q8 if layout == "q8"
                            else relayout_q12)(idx)
        tax = idx.taxonomy
        f = torch.from_numpy(fused[0].view(np.int32))
        s = torch.from_numpy(fuse_stash(stash3[0], tax.tin, tax.tout)
                             .view(np.int32))
        if layout == "q8":
            out.append((name, w, lookup_q8_sorted, lookup_q8_plain,
                        (f, s, idx.meta.k)))
        else:
            out.append((name, w, lookup_q12_sorted, lookup_q12_plain,
                        (f, s, idx.meta.k, Q12_WAYS)))
    idx = world[2]
    tax = idx.taxonomy
    for name, scale in (("std_packed", 1), ("std_wide", 4096)):
        f = torch.from_numpy(record_rows(
            fuse_table(idx.key_hi, idx.key_lo, idx.val, tax.tin * scale,
                       tax.tout * scale), idx.meta.ways).view(np.int32))
        s = torch.from_numpy(fuse_stash(idx.stash, tax.tin * scale,
                                        tax.tout * scale).view(np.int32))
        out.append((name, world, lookup_std_sorted, lookup_std_plain,
                    (f, s, idx.meta.ways)))
    return out


def test_sorted_lookup_kernels_match_plain(cuda, world, world31):
    """K9 then the sorted forms of K2, K2-q12 and K4 equal the unsorted
    plain versions on every stored key, 500 absent ones and invalid
    probes; one launch of K9 and one of the sorted form a call."""
    for name, w, wrapper, plain, args in _deep_tables(world, world31):
        hi, lo, valid = _probes(w)
        want = plain(hi, lo, valid, *args)
        reset_kernel_launches()
        got = wrapper(hi.to(cuda), lo.to(cuda), valid.to(cuda),
                      *(a.to(cuda) if torch.is_tensor(a) else a
                        for a in args))
        launches = kernel_launches()
        assert launches["bucket_sort"] == 1 and launches[
            wrapper.__name__] == 1, (name, launches)
        for a, b in zip(want, got):
            assert torch.equal(a, b.cpu()), name
        assert (want[0] != 0).sum() > 0.85 * hi.numel() // 2, name


@pytest.mark.parametrize("layout", ["q8", "q12", "std"])
def test_sorted_classifier_cuda_matches_plain_and_golden(cuda, world,
                                                         monkeypatch, layout):
    """The deep-table gate lowered (2,048 probes a chunk past 64 rows): the
    step on the card launches K9 and the sorted form, no unsorted lookup,
    and equals the plain path and golden."""
    from pangea_tpu_torch.kernels import lookup as LK
    monkeypatch.setattr(LK, "_DEEP_ROWS", 1 << 6)
    monkeypatch.setattr(LK, "_deep_chunk",
                        lambda n, nb, rb=512, min_chunk=8192:
                        2048 if n > 2048 else None)
    tax, _, idx, rs = world
    di = (_q12_index(idx, cuda, 0.0) if layout == "q12" else
          DeviceIndex.from_index(idx, cuda, 0.0, layout=layout))
    assert di.cfg.layout == layout and di.fused.shape[0] > LK._DEEP_ROWS
    model = Classifier(di)
    n = len(rs.seqs)
    b = torch.from_numpy(pad_batch(rs.seqs, n, 120)).to(cuda)
    m = torch.from_numpy(pad_batch(rs.mates, n, 120)).to(cuda)
    reset_kernel_launches()
    got = {key: v.cpu() for key, v in model(b, m).items()}
    lookup = f"lookup_{layout}_sorted"
    score = "score_taxon" if layout == "std" else "score_tin"
    assert kernel_launches() == {**_NONE, "extract_probes": 2,
                                 "bucket_sort": 1, lookup: 1, score: 1}
    plain = classify_reads(model.index.tables, b, model.cfg, mate_bases=m,
                           plain=True)
    gold = classify_reads_golden(rs.seqs, idx, 0.0, mates=rs.mates)
    for key in ("taxon", "best", "nvalid"):
        assert torch.equal(got[key], plain[key].cpu())
        assert got[key].tolist() == [getattr(g, key) for g in gold]


@pytest.mark.parametrize("n_shards,cap_frac", [(2, 1.25), (4, 1.25),
                                               (8, 1.25), (4, 0.01)],
                         ids=["s2", "s4", "s8", "s4_overflow"])
def test_route_bin_kernel_matches_plain(cuda, n_shards, cap_frac):
    """K10 puts each valid probe in its owner's bin once, with the plain
    version's per-owner counts and overflow; the grid's unused slots are
    zeros; K9's restore on the answers is the plain restore."""
    from pangea_tpu_torch.kernels import (route_bin, route_bin_plain,
                                          route_restore, route_restore_plain)
    from pangea_tpu_torch.kernels.route import owner_of, route_capacity
    rng = np.random.default_rng(n_shards)
    n = 300_007
    hi = torch.from_numpy(rng.integers(0, 1 << 10, n).astype(np.int32))
    lo = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64)
                          .astype(np.uint32).view(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    cap = route_capacity(n, n_shards, cap_frac)
    _, pinv, pcounts = route_bin_plain(hi, lo, valid, n_shards, cap)
    reset_kernel_launches()
    records, inv, counts = (t.cpu() for t in route_bin(
        hi.to(cuda), lo.to(cuda), valid.to(cuda), n_shards, cap))
    assert kernel_launches()["route_bin"] == 1
    assert torch.equal(counts, pcounts)
    assert int((inv >= 0).sum()) == int((pinv >= 0).sum())
    fits = inv >= 0
    assert not fits[~valid].any()
    owner = owner_of(hi, lo, n_shards)
    assert torch.equal((inv[fits] // cap).long(), owner[fits])
    rec = records[inv[fits].long()]
    assert torch.equal(rec[:, 0], torch.arange(n, dtype=torch.int32)[fits])
    assert torch.equal(rec[:, 1], hi[fits]) and torch.equal(rec[:, 2],
                                                            lo[fits])
    assert (rec[:, 3] == 1).all()
    used = torch.zeros(records.shape[0], dtype=torch.bool)
    used[inv[fits].long()] = True
    assert int(used.sum()) == int(fits.sum()) and (records[~used] == 0).all()
    answers = records[:, [1, 2, 0, 3]].contiguous()
    got = route_restore(inv.to(cuda), answers.to(cuda))
    assert kernel_launches()["route_restore"] == 1
    for a, b in zip(got, route_restore_plain(inv, answers)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("name", list(K9_EDGE))
def test_k9_k10_edge_worlds_match_plain(cuda, name):
    """K9 and K10 on their edge cases (bench.k9_edge_world), held to their
    plain versions as the tests above hold them. K10 runs through its
    wrapper and again on a grid filled with -1 and an inv filled with -2
    first (bench.route_bin_dirty), where a slot or an inv the kernel
    leaves unwritten shows."""
    from pangea_tpu_torch.kernels import (bucket_sort, bucket_sort_plain,
                                          route_bin, route_bin_plain)
    from pangea_tpu_torch.kernels.lookup import bucket_keys
    from pangea_tpu_torch.kernels.route import owner_of, route_capacity
    w = k9_edge_world(name)
    hi, lo = (torch.from_numpy(w[key].view(np.int32)) for key in ("hi", "lo"))
    valid = torch.from_numpy(w["valid"])
    n = hi.numel()
    on = [t.to(cuda) for t in (hi, lo, valid)]
    reset_kernel_launches()
    if w["kind"] == "sort":
        nb, k = w["nb"], w["k"]
        records, inv = (t.cpu() for t in bucket_sort(*on, nb, k))
        assert kernel_launches()["bucket_sort"] == 1
        perm = records[:, 0].long()
        assert torch.equal(torch.sort(perm).values, torch.arange(n))
        assert torch.equal(inv[perm], torch.arange(n, dtype=torch.int32))
        for j, lanes in enumerate((hi, lo, valid.to(torch.int32)), 1):
            assert torch.equal(records[:, j], lanes[perm])
        keys = bucket_keys(hi, lo, valid, nb, k)
        want = keys[bucket_sort_plain(hi, lo, valid, nb, k)[0][:, 0].long()]
        assert torch.equal(keys[perm], want)
        return
    S = w["n_shards"]
    cap = w["cap"] or route_capacity(n, S)
    _, pinv, pcounts = route_bin_plain(hi, lo, valid, S, cap)
    for call in (route_bin, route_bin_dirty):
        records, inv, counts = (t.cpu() for t in call(*on, S, cap))
        assert torch.equal(counts, pcounts)
        fits = inv >= 0
        assert int(fits.sum()) == int((pinv >= 0).sum())
        assert not fits[~valid].any() and (inv[~fits] == -1).all()
        assert torch.equal((inv[fits] // cap).long(),
                           owner_of(hi, lo, S)[fits])
        rec = records[inv[fits].long()]
        assert torch.equal(rec[:, 0],
                           torch.arange(n, dtype=torch.int32)[fits])
        assert torch.equal(rec[:, 1], hi[fits])
        assert torch.equal(rec[:, 2], lo[fits])
        assert (rec[:, 3] == 1).all()
        used = torch.zeros(records.shape[0], dtype=torch.bool)
        used[inv[fits].long()] = True
        assert int(used.sum()) == int(fits.sum())
        assert (records[~used] == 0).all()
    assert kernel_launches()["route_bin"] == 1


@pytest.mark.parametrize("n_shards", [2, 4])
def test_lookup_std_owner_mask_matches_plain(cuda, world, n_shards):
    """K4's masked form on every shard of a std table equals the plain
    version's mask, unsorted and sorted; the shards' sums are the unmasked
    probe."""
    from pangea_tpu_torch.kernels import lookup_std_owned, lookup_std_sorted
    idx = world[2]
    tax = idx.taxonomy
    hi, lo, valid = _probes(world)
    f = torch.from_numpy(record_rows(fuse_table(
        idx.key_hi, idx.key_lo, idx.val, tax.tin, tax.tout),
        idx.meta.ways).view(np.int32))
    st = torch.from_numpy(fuse_stash(idx.stash, tax.tin, tax.tout)
                          .view(np.int32))
    args = (f, st, idx.meta.ways)
    total = None
    for s in range(n_shards):
        want = lookup_std_plain(hi, lo, valid, *args, (n_shards, s))
        on = [t.to(cuda) for t in (hi, lo, valid, f, st)]
        reset_kernel_launches()
        got = lookup_std_owned(*on, idx.meta.ways, (n_shards, s))
        assert kernel_launches()["lookup_std_owned"] == 1
        srt = lookup_std_sorted(*on, idx.meta.ways, owner=(n_shards, s))
        for a, b, c in zip(want, got, srt):
            assert torch.equal(a, b.cpu()) and torch.equal(a, c.cpu())
        total = want if total is None else tuple(
            x + y for x, y in zip(total, want))
    for a, b in zip(total, lookup_std_plain(hi, lo, valid, *args)):
        assert torch.equal(a, b)


def _nccl_rank(rank, world, store, idx_dir, bases, q):
    import datetime

    import torch.distributed as dist

    from pangea_tpu_torch.dist import mesh as M
    from pangea_tpu_torch.index import load_index_any
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = M.Mesh(M.MeshConfig(1, world), dev)
    di = M.place_index(load_index_any(idx_dir), mesh, 0.05)
    fn = M.make_sharded_classify_fn(di.cfg, mesh, routing="alltoall")
    out = fn(di.tables, bases.to(dev))
    torch.cuda.synchronize()
    if rank == 0:
        q.put({k: v.cpu() for k, v in out.items()})
    dist.destroy_process_group()


def test_two_card_nccl_routed_step(world, tmp_path):
    """The routed step over NCCL on two cards, one rank a card, equals the
    one-device step."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import torch.multiprocessing as mp
    _, _, idx, rs = world
    idx.save(str(tmp_path / "idx"))
    n = len(rs.seqs) - len(rs.seqs) % 2
    bases = torch.from_numpy(pad_batch(rs.seqs, n, 120))
    want = Classifier(DeviceIndex.from_index(idx, "cpu", 0.05))(bases)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_nccl_rank, args=(
        r, 2, str(tmp_path / "store"), str(tmp_path / "idx"), bases, q))
        for r in range(2)]
    for p in procs:
        p.start()
    got = q.get(timeout=300)
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    for key in want:
        assert torch.equal(got[key], want[key]), key


# The B16 kernels (K11-K13) of the Pallas experiments.


def _probe_world(nb, w, n, device, seed=3):
    from pangea_tpu_torch.experiments.mb_pallas import (make_world,
                                                        world_tensors)
    table, b, rem = world_tensors(make_world(seed, nb, n, w), "cpu")
    b[:7] = torch.tensor([-1, -5, nb, nb + 9, -nb, -nb - 3, 2**31 - 1],
                         dtype=torch.int32)        # counted from the end
    return (table, b, rem), tuple(t.to(device) for t in (table, b, rem))


@pytest.mark.parametrize("nb,w,n", [
    (16384, 64, 100_003),          # N not a multiple of a warp's queries
    (65536, 64, 50_001),           # 256 slices: past one wave of blocks
    (16384, 32, 70_001),           # W = 32
    (256, 64, 5_000),              # a table one slice tall
    (1000, 64, 3_001),             # NB not a power of two
    (40000, 3, 20_000),            # an odd W; 10 slices, the last partial
    (16384, 64, 100),              # fewer queries than a block's threads
])
def test_rowprobe_smem_kernel_matches_plain(cuda, nb, w, n):
    from pangea_tpu_torch.kernels import rowprobe_plain, rowprobe_smem
    cpu, dev = _probe_world(nb, w, n, cuda)
    reset_kernel_launches()
    got = rowprobe_smem(*dev)
    assert kernel_launches()["rowprobe_smem"] == 1
    assert kernel_launches()["rowprobe_route"] == 1
    want = rowprobe_plain(*cpu)
    assert torch.equal(got.cpu(), want)
    assert int((want != 0).sum()) > n // 4            # planted hits


def _routed_case(case, nb, n, device):
    """(table, b, rem) of mb_pallas's world at W = 64, its rows set by
    ``case``: every query in one row or one 32-row tile, or in every other
    tile (half the keys empty)."""
    from pangea_tpu_torch.experiments.mb_pallas import (make_world,
                                                        world_tensors)
    table, b, rem = world_tensors(make_world(5, nb, n, 64), "cpu")
    g = torch.Generator().manual_seed(6)
    if case == "one_row":
        b[:] = nb // 2
    elif case == "one_tile":
        b[:] = torch.randint(32, 64, (n,), generator=g, dtype=torch.int32)
    elif case == "half_empty":
        b[:] = (torch.randint(0, nb // 64, (n,), generator=g) * 64
                + torch.randint(0, 32, (n,), generator=g)).to(torch.int32)
    return (table, b, rem), tuple(t.to(device) for t in (table, b, rem))


@pytest.mark.parametrize("case,nb,n", [
    ("one_row", 16384, 100_003),   # one key holds every record
    ("one_tile", 16384, 70_001),
    ("half_empty", 16384, 100_003),
    ("uniform", 1, 5_000),         # NB = 1: one key
    ("uniform", 257, 9_001),       # NB not a multiple of the k-tile
    ("uniform", 16384, 0),         # no query: nothing launched
])
def test_routed_probes_match_plain(cuda, case, nb, n):
    """The routing pass (by key, count and record multiset), K11 and K12
    on skewed, half-empty and ragged worlds against the plain versions."""
    from pangea_tpu_torch.kernels import (rowprobe_onehot, rowprobe_plain,
                                          rowprobe_route,
                                          rowprobe_route_plain,
                                          rowprobe_smem)
    cpu, dev = _routed_case(case, nb, n, cuda)
    reset_kernel_launches()
    records, totals = rowprobe_route(dev[1], dev[2], nb)
    assert kernel_launches()["rowprobe_route"] == int(n > 0)
    want, want_totals = rowprobe_route_plain(cpu[1], cpu[2], nb)
    records = records.cpu()
    assert torch.equal(totals.cpu(), want_totals)
    keys = records[:, 1].long() >> 5
    assert bool((keys[1:] >= keys[:-1]).all())
    assert torch.equal(records[records[:, 0].long().argsort()],
                       want[want[:, 0].long().argsort()])
    expect = rowprobe_plain(*cpu)
    for fn in (rowprobe_smem, rowprobe_onehot):
        reset_kernel_launches()
        assert torch.equal(fn(*dev).cpu(), expect), fn.__name__
        counts = kernel_launches()
        assert counts[fn.__name__] == counts["rowprobe_route"] == int(n > 0)


@pytest.mark.parametrize("nb,w,n", [
    (16384, 64, 1_000),            # the experiment's table; a ragged tile
    (1024, 64, 70_001),            # every query of a small table
    (100, 32, 333),                # NB not a multiple of the k-step
    (32, 4, 65),                   # 2W = 8, one k-step
])
def test_rowprobe_onehot_kernel_matches_plain(cuda, nb, w, n):
    from pangea_tpu_torch.kernels import (rowprobe_onehot,
                                          rowprobe_onehot_plain,
                                          rowprobe_plain)
    cpu, dev = _probe_world(nb, w, n, cuda)
    reset_kernel_launches()
    got = rowprobe_onehot(*dev)
    assert kernel_launches()["rowprobe_onehot"] == 1
    assert kernel_launches()["rowprobe_route"] == 1
    want = rowprobe_plain(*cpu)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(rowprobe_onehot_plain(*dev).cpu(), want)
    with pytest.raises(ValueError):
        rowprobe_onehot(dev[0][:, :6].contiguous(), *dev[1:])


@pytest.mark.parametrize("direct", [False, True], ids=["staged", "direct"])
@pytest.mark.parametrize("depth,chunk,n", [
    (1, 7, 1_000),                 # depth 1, chunk not dividing n
    (64, 100, 10_001),             # depth past the chunk
    (16, 4096, 70_000),            # an experiment's shape, ragged
    (3, 5, 77),                    # a depth that is not a power of two
    (8, 4096, 3),                  # fewer indices than the depth
    (16, 4096, 20),                # fewer indices than one warp's run
    (16, 512, 202_769),            # past the persistent grid, n % 32 = 17
    (32, 8192, 1 << 19),           # the experiments' longest chunks
    (64, 8192, 1 << 19),
    (200, 4096, 100_003),          # 7 slots a lane: the direct lag ladder
])
def test_row_gather_kernel_matches_plain(cuda, direct, depth, chunk, n):
    from pangea_tpu_torch.kernels import row_gather, row_gather_plain
    g = torch.Generator().manual_seed(n)
    table = torch.randint(-2**31, 2**31 - 1, (5000, 64), dtype=torch.int32,
                          generator=g)
    idx = torch.randint(-6000, 6000, (n,), dtype=torch.int32, generator=g)
    reset_kernel_launches()
    got = row_gather(table.to(cuda), idx.to(cuda), depth=depth, chunk=chunk,
                     direct=direct)
    launches = kernel_launches()
    assert (launches["row_gather_direct"], launches["row_gather"]) == (
        (1, 0) if direct else (0, 1))
    assert torch.equal(got.cpu(), row_gather_plain(table, idx))


@pytest.mark.parametrize("dtype,width,rows", [
    (torch.float64, 6, 1), (torch.int32, 4, 8), (torch.uint8, 48, 3),
    (torch.int32, 128, 8)])                  # 4 KB slots
def test_row_gather_kernel_takes_bytes(cuda, dtype, width, rows):
    """Rows of any dtype that are a multiple of 16 bytes, several a copy."""
    from pangea_tpu_torch.kernels import row_gather, row_gather_plain
    table = torch.arange(700 * width).reshape(700, width).to(dtype)
    idx = torch.tensor([0, 699, 350, -1, 5, 698], dtype=torch.int32)
    for direct in (False, True):
        got = row_gather(table.to(cuda), idx.to(cuda), depth=4, chunk=4,
                         direct=direct, rows=rows)
        assert torch.equal(got.cpu(), row_gather_plain(table, idx, rows))
    with pytest.raises(ValueError):
        row_gather(table[:, :1].contiguous().to(cuda), idx.to(cuda),
                   depth=4, chunk=4)


@pytest.mark.parametrize("start", [0, 4, 12, -3])
def test_block_copy_kernel_matches_the_slice(cuda, start):
    from pangea_tpu_torch.kernels import block_copy, row_gather_plain
    x = torch.arange(16 * 128, dtype=torch.float32).reshape(16, 128)
    s = torch.tensor([start], dtype=torch.int32)
    reset_kernel_launches()
    got = block_copy(x.to(cuda), s.to(cuda), 8)
    assert kernel_launches()["block_copy"] == 1
    assert torch.equal(got.cpu(), row_gather_plain(x, s, 8))
    if start in (0, 4):
        assert torch.equal(got.cpu(), x[start:start + 8])


# K4's specialisations (kernels/lookup.py std_plan): W = 16 and 32 take the
# specialised body, every other W the generic one; packed and wide rows;
# stashes of 0, a few and STASH_MAX columns, staged in shared memory.
def _std_table(ways, wide, stash_cols, seed=11):
    """(hi, lo, valid, fused, stash) of a random std table of W = ways in
    K4's record form, a random payload (so that sums wrap), some rows
    holding a key twice
    and a stash of ``stash_cols`` columns, half of them keys of the rows;
    the probes are every key, the stash's and 500 absent ones."""
    from pangea_tpu_torch.index.build import STASH_MAX
    rng = np.random.default_rng(seed + ways + stash_cols)
    n = 60 * ways
    keys = np.unique(rng.integers(1, 1 << 42, size=n, dtype=np.uint64))
    kh, kl, _, _, nb = layout_table(keys, np.ones(keys.shape, np.int32),
                                    0.25, ways=ways)
    dup = np.flatnonzero(kh[:, -1] == kh.max())[:40]   # empty last slots
    kh[dup, -1], kl[dup, -1] = kh[dup, 0], kl[dup, 0]
    payload = rng.integers(0, 1 << 32, size=(nb, (4 if wide else 2) * ways),
                           dtype=np.uint64).astype(np.uint32)
    fused = record_rows(np.concatenate([kh, kl, payload], axis=1), ways)
    assert stash_cols <= STASH_MAX
    pick = rng.choice(keys.shape[0], stash_cols // 2, replace=False)
    fresh = rng.integers(1, 1 << 42, size=stash_cols - pick.size,
                         dtype=np.uint64)
    skeys = np.concatenate([keys[pick], fresh])
    stash = np.concatenate([
        (skeys >> np.uint64(32)).astype(np.uint32)[None],
        (skeys & np.uint64(0xFFFFFFFF)).astype(np.uint32)[None],
        rng.integers(0, 1 << 32, size=(3, stash_cols),
                     dtype=np.uint64).astype(np.uint32)])
    probes = rng.permutation(np.concatenate([
        keys, skeys, rng.integers(0, 1 << 42, size=500, dtype=np.uint64)]))
    hi = (probes >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (probes & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    valid = rng.random(probes.shape[0]) < 0.9
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        hi, lo, valid, fused.view(np.int32), stash.view(np.int32)))


@pytest.fixture(params=[2, 4], ids=lambda b: f"batch{b}")
def k4_batch(request, monkeypatch):
    """K4's plan with each batch of probes whose key loads a group issues
    together."""
    from pangea_tpu_torch.kernels import lookup as LK
    monkeypatch.setattr(LK, "STD_BATCH", {16: request.param,
                                          32: request.param})
    monkeypatch.setattr(LK, "STD_BATCH_GENERIC", request.param)
    LK.std_plan.cache_clear()
    yield request.param
    LK.std_plan.cache_clear()


@pytest.mark.parametrize("stash_cols", [0, 7, 128])
@pytest.mark.parametrize("wide", [False, True], ids=["packed", "wide"])
@pytest.mark.parametrize("ways", [4, 8, 16, 32, 64])
def test_lookup_std_kernel_every_specialisation(cuda, k4_batch, ways, wide,
                                                stash_cols):
    """K4 and its sorted form equal lookup_std_plain bit for bit on every
    specialisation: the W-specialised and generic bodies, every batch,
    packed and wide rows, duplicate keys in a row, stash hits on keys the
    rows hold."""
    from pangea_tpu_torch.kernels import lookup_std_sorted
    args = _std_table(ways, wide, stash_cols)
    assert args[3].shape[1] == (6 if wide else 4) * ways
    assert args[4].shape == (5, stash_cols)
    want = lookup_std_plain(*args, ways)
    on = [a.to(cuda) for a in args]
    reset_kernel_launches()
    got = lookup_std(*on, ways)
    srt = lookup_std_sorted(*on, ways)
    assert kernel_launches()["lookup_std"] == 1
    assert kernel_launches()["lookup_std_sorted"] == 1
    for a, b, c in zip(want, got, srt):
        assert torch.equal(a, b.cpu()) and torch.equal(a, c.cpu())
    assert int((want[0] != 0).sum()) > (args[0].numel() - 500) // 2


def _step_probes():
    """Three steps of std_plan's persistent grid (32 probes a warp), plus
    17."""
    from pangea_tpu_torch.kernels.lookup import std_plan
    plan = std_plan(1 << 30, 32, 0, False, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return 3 * plan.grid * plan.warps * 32 + 17


@pytest.mark.parametrize("invalid", [False, True], ids=["valid", "invalid"])
@pytest.mark.parametrize("n", [0, 1, 33, "steps"])
def test_lookup_std_kernel_edge_sizes(cuda, k4_batch, n, invalid):
    """N = 0, 1, 33 and past three steps of the persistent grid (not a
    multiple of a step), with the probes valid or all invalid."""
    from pangea_tpu_torch.kernels import lookup_std_sorted
    hi, lo, valid, fused, stash = _std_table(32, True, 0)
    n = _step_probes() if n == "steps" else n
    reps = -(-n // hi.numel()) if n else 0
    hi, lo, valid = (t.repeat(reps)[:n] for t in (hi, lo, valid))
    if invalid:
        valid = torch.zeros_like(valid)
    want = lookup_std_plain(hi, lo, valid, fused, stash, 32)
    on = [a.to(cuda) for a in (hi, lo, valid, fused, stash)]
    got = lookup_std(*on, 32)
    srt = lookup_std_sorted(*on, 32)
    for a, b, c in zip(want, got, srt):
        assert b.shape == (n,) and torch.equal(a, b.cpu())
        assert torch.equal(a, c.cpu())
    if invalid:
        assert not any(bool(o.any()) for o in want)


@pytest.mark.parametrize("wide,ways", [(False, 16), (True, 32)],
                         ids=["packed16", "wide32"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_lookup_std_owner_mask_on_the_specialised_bodies(cuda, k4_batch,
                                                         n_shards, wide,
                                                         ways):
    """K4's masked form, unsorted and sorted, on every shard of 2, 4 and 8
    equals the plain mask; the shards' outputs sum to the unmasked probe."""
    from pangea_tpu_torch.kernels import lookup_std_owned, lookup_std_sorted
    args = _std_table(ways, wide, 7)
    on = [a.to(cuda) for a in args]
    total = None
    for s in range(n_shards):
        want = lookup_std_plain(*args, ways, (n_shards, s))
        got = lookup_std_owned(*on, ways, (n_shards, s))
        srt = lookup_std_sorted(*on, ways, owner=(n_shards, s))
        for a, b, c in zip(want, got, srt):
            assert torch.equal(a, b.cpu()) and torch.equal(a, c.cpu())
        total = want if total is None else tuple(
            (x.long() + y.long()) & 0xFFFFFFFF for x, y in zip(total, want))
    for a, b in zip(total, lookup_std_plain(*args, ways)):
        assert torch.equal(a.long() & 0xFFFFFFFF, b.long() & 0xFFFFFFFF)


def test_lookup_std_kernel_on_a_device_that_is_not_current():
    """K4 on the last card while the first is current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    args = _std_table(32, True, 7)
    got = lookup_std(*(a.to(dev) for a in args), 32)
    assert torch.cuda.current_device() == 0
    for a, b in zip(lookup_std_plain(*args, 32), got):
        assert b.device == dev and torch.equal(a, b.cpu())


def test_kernels_launch_on_the_callers_stream(cuda, monkeypatch):
    """A launch under torch.cuda.stream(s) passes s's handle to the
    launcher and runs there: queued behind a sleep on s, its outputs are
    right once s is synchronised."""
    from pangea_tpu_torch.kernels import _build
    args = _std_table(32, True, 7)
    on = [a.to(cuda) for a in args]
    lookup_std(*on, 32)                       # the launcher, looked up
    real = _build.launcher("pangea_lookup_std")
    seen = []

    def spy(*a):
        seen.append(a[-1])
        return real(*a)
    monkeypatch.setitem(_build._launchers, "pangea_lookup_std", spy)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(10_000_000)
        got = lookup_std(*on, 32)
    assert seen == [s.cuda_stream]
    assert seen[0] != torch.cuda.default_stream().cuda_stream
    s.synchronize()
    for a, b in zip(lookup_std_plain(*args, 32), got):
        assert torch.equal(a, b.cpu())


# K2 (csrc/lookup_q8.cu) on its edge tables (bench.k2_edge_world): q12 at
# r = 0, 20, 32, 54 and 62, q8 at r = 0 and 22-25, rows with a shared
# rem_lo and a repeated key, W = 4 with a forced stash, stashes of 3,000
# columns (60,000 bytes, past the shared-memory cap), both forms, and N =
# 0, 1, 33 and past three steps of the persistent grid.
def _k2_world(name, n=None):
    """(args on the CPU, k, ways, q12) of a K2 edge table, its probes
    repeated to n (all of them for None)."""
    from pangea_tpu_torch.bench import k2_edge_world
    w = k2_edge_world(name)
    hi, lo, valid = (torch.from_numpy(np.ascontiguousarray(
        w[key].view(np.int32) if key != "valid" else w[key]))
        for key in ("hi", "lo", "valid"))
    if n is not None:
        reps = -(-n // hi.numel()) if n else 0
        hi, lo, valid = (t.repeat(reps)[:n] for t in (hi, lo, valid))
    args = (hi, lo, valid, torch.from_numpy(w["fused"].view(np.int32)),
            torch.from_numpy(w["stash"].view(np.int32)))
    return args, w["k"], w["ways"], w["q12"]


def _k2_forms(args, k, ways, q12, cuda, plan=None):
    """(plain, unsorted kernel, sorted kernel) outputs of a K2 table;
    ``plan`` launches both forms past the wrappers."""
    from pangea_tpu_torch.kernels import lookup_q8_sorted, lookup_q12_sorted
    from pangea_tpu_torch.kernels.lookup import (_q8_kernel, _q12_kernel,
                                                 bucket_sort)
    on = [a.to(cuda) for a in args]
    extra = (ways,) if q12 else ()
    want = (lookup_q12_plain if q12 else lookup_q8_plain)(*args, k, *extra)
    if plan is None:
        got = (lookup_q12 if q12 else lookup_q8)(*on, k, *extra)
        srt = (lookup_q12_sorted if q12 else lookup_q8_sorted)(*on, k,
                                                               *extra)
        return want, got, srt
    order = bucket_sort(*on[:3], on[3].shape[0], k)
    dev = on[0].device                  # with its index, as a wrapper's
    if q12:
        return want, *(_q12_kernel(dev, *on, k, ways, o, plan=plan)
                       for o in (None, order))
    return want, *(_q8_kernel(dev, *on, k, o, plan=plan)
                   for o in (None, order))


def _k2_steps():
    """Three steps of quot_plan's persistent grid (32 probes a warp), plus
    17."""
    from pangea_tpu_torch.kernels.lookup import quot_plan
    plan = quot_plan(1 << 30, Q12_WAYS, 0, True, False,
                     torch.cuda.get_device_properties(0).multi_processor_count)
    return 3 * plan.grid * plan.warps * 32 + 17


def _k2_names():
    from pangea_tpu_torch.bench import K2_EDGE
    return list(K2_EDGE)


@pytest.mark.parametrize("n", [None, 0, 1, 33, "steps"],
                         ids=["all", "0", "1", "33", "steps"])
@pytest.mark.parametrize("name", _k2_names())
def test_k2_matches_plain_on_edge_tables(cuda, name, n):
    """K2 and its sorted form equal the plain version bit for bit."""
    if n == "steps":
        n = _k2_steps()
    args, k, ways, q12 = _k2_world(name, n)
    reset_kernel_launches()
    want, got, srt = _k2_forms(args, k, ways, q12, cuda)
    launches = kernel_launches()
    form = "lookup_q12" if q12 else "lookup_q8"
    assert launches[form] == 1 and launches[f"{form}_sorted"] == 1
    for a, b, c in zip(want, got, srt):
        assert b.shape == a.shape and torch.equal(a, b.cpu()), name
        assert torch.equal(a, c.cpu()), name


@pytest.mark.parametrize("name", ["q8_r22", "q12_r54", "q12_w4_stash",
                                  "q8_stash_3000"])
def test_k2_every_swept_plan_matches_plain(cuda, name):
    """Every plan kernels.lookup_sweep sweeps (warps, blocks an SM, L2
    mode), on the specialised and generic bodies, unsorted and sorted."""
    from pangea_tpu_torch.kernels.lookup_sweep import quot_plans
    args, k, ways, q12 = _k2_world(name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [p for _, p in quot_plans(args[0].numel(), ways,
                                      args[4].shape[1], q12, sms)]
    assert len(plans) == 18
    for plan in plans:
        want, got, srt = _k2_forms(args, k, ways, q12, cuda, plan)
        for a, b, c in zip(want, got, srt):
            assert torch.equal(a, b.cpu()), plan
            assert torch.equal(a, c.cpu()), plan


@pytest.mark.parametrize("name", ["q8_r22", "q12_r54"])
def test_k2_generic_body_off_16_bytes(cuda, name):
    """A table that does not start on 16 bytes takes the generic body and
    gives the same outputs; the launcher refuses the specialised one
    there."""
    from pangea_tpu_torch.kernels import _build
    from pangea_tpu_torch.kernels.lookup import quot_plan
    args, k, ways, q12 = _k2_world(name)
    want = _k2_forms(args, k, ways, q12, cuda)[0]
    f = args[3]
    shifted = torch.zeros(f.numel() + 1, dtype=torch.int32,
                          device=cuda)[1:].view(f.shape)
    shifted.copy_(f)
    assert shifted.data_ptr() % 16
    on = [a.to(cuda) for a in args[:3]] + [shifted, args[4].to(cuda)]
    extra = (ways,) if q12 else ()
    got = (lookup_q12 if q12 else lookup_q8)(*on, k, *extra)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    plan = quot_plan(args[0].numel(), ways, args[4].shape[1], q12, False,
                     torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.spec == ways
    launcher = "pangea_lookup_q12" if q12 else "pangea_lookup_q8"
    outs = [torch.empty_like(on[0]) for _ in range(3)]
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch(launcher, on[0].device,
                      *(t.data_ptr() for t in on[:3]),
                      on[0].numel(), shifted.data_ptr(), f.shape[0], ways,
                      *((f.shape[1],) if q12 else ()), on[4].data_ptr(),
                      on[4].shape[1], k, None, None,
                      *(o.data_ptr() for o in outs), *plan)


def test_requested_std_layout_on_the_card_matches_plain_and_golden(cuda):
    """layout="std" on an index the auto policy puts in q8: the Classifier
    launches K4 and equals the plain path and golden."""
    tax, genomes, idx, rs = small_world(k=21, seed=2, genome_len=3000,
                                        n_reads=256, read_len=120,
                                        paired=True, w=8)
    assert DeviceIndex.from_index(idx, cuda, 0.05).cfg.layout == "q8"
    di = DeviceIndex.from_index(idx, cuda, 0.05, layout="std")
    assert di.cfg.layout == "std"
    b1, b2 = (torch.from_numpy(pad_batch(s, 256, 120)).to(cuda)
              for s in (rs.seqs, rs.mates))
    reset_kernel_launches()
    got = Classifier(di)(b1, b2)
    assert kernel_launches()["lookup_std"] == 1
    want = classify_reads(di.tables, b1, di.cfg, mate_bases=b2, plain=True)
    for key in ("taxon", "best", "nvalid"):
        assert torch.equal(want[key], got[key])
    gold = classify_reads_golden(rs.seqs, idx, 0.05, mates=rs.mates)
    assert got["taxon"].cpu().tolist() == [g.taxon for g in gold]
    assert got["nvalid"].cpu().tolist() == [g.nvalid for g in gold]


# name -> (k, w, tree, requested layout) of a bench world placed whole
RELAYOUT_WORLDS = {"std_wide": (21, 1, (512, 64), None),
                   "q8": (21, 8, None, None),
                   "q12": (31, 1, None, "q12"),
                   "std": (21, 8, None, "std")}


@pytest.mark.parametrize("name", list(RELAYOUT_WORLDS))
def test_relayout_on_the_card_equals_the_host(cuda, name):
    """A whole index placed on the card is laid out there (the placement
    record says "card"), to the host path's tables byte for byte: the
    wide std rows of a 66,563-taxon world, q8, q12 (k=31) and packed std
    rows."""
    k, w, tree, layout = RELAYOUT_WORLDS[name]
    idx = make_bench_world(n_reads=8, read_len=100, genome_len=4000, k=k,
                           w=w, tree=tree).index
    before = len(trace.placements())
    got = DeviceIndex.from_index(idx, cuda, 0.05, layout=layout)
    assert trace.placements()[before]["layout_on"] == "card"
    want = DeviceIndex.from_numpy_tables(
        *_host_tables(idx, 0.05, layout, 1, 0, None), "cpu")
    assert got.cfg == want.cfg
    assert got.cfg.layout == name.split("_")[0]
    assert got.fused.shape[1] == {"std_wide": 6 * 16, "q8": 128,
                                  "q12": 128, "std": 4 * 16}[name]
    for a, b in [(got.fused, want.fused), (got.stash, want.stash)] + [
            (got.tax[n], want.tax[n]) for n in TAX_KEYS]:
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b)
