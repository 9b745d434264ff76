"""The scorer's tail on the CPU: the lifted LCA (K5) and the multi-k merge
(K7) that the scorer's launch computes, held to the JAX package.

On the card K3 and K8 lift the winners' LCA past 4,096 taxa and merge the
read's call with an earlier one (``prior=``) in their own launch. Their
plain path here, ``score_reads_taxon`` / ``score_reads_tin`` /
``score_ranked`` on CPU tensors with ``prior=(call, merge_tax)``, must
equal the reference's ``merge_multik_jnp(prior, score_reads_jnp(...))``
(and ``score_reads_tin_jnp``): on the bench tree (the direct LCA), the
66,563-taxon tree (lifted), a 5,000-node chain (13 lifting levels, the
winners deep chain nodes) and the bench tree scored but merged over the
wide tree; at thresholds 0, 0.05 and 1.0; with agreements, conflicts,
ties, both-unclassified reads and the int32 extremes of
``tests/test_hardening.py`` in the prior. The launches' arguments are
checked through the fake library of ``tests/test_torch_launch.py``: one
scorer launch a call, lifted or merged, and two in a two-index multi-k
step, with no launch of a lift or merge of their own. Every output is an
integer: the tolerance is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.classify.merge import merge_multik_jnp
from pangea_tpu.kernels.score import score_reads_jnp, score_reads_tin_jnp
from pangea_tpu_torch.bench import chain_taxonomy
from pangea_tpu_torch.classify import (DeviceIndex, MultiKClassifier,
                                       classify_multik)
from pangea_tpu_torch.kernels import (_build, kernel_launches,
                                      reset_kernel_launches, score_ranked,
                                      score_reads_taxon, score_reads_tin)
from pangea_tpu_torch.kernels.score import SCORE_MAX_CAP
from pangea_tpu_torch.utils import datagen

from .helpers import small_world
from .test_torch_launch import fake  # noqa: F401  (a fixture)

KEYS = ("taxon", "best", "nvalid")
BIG = 2**30
I32_MAX = 2**31 - 1
SMS = 132
_TREES: dict = {}


def _tree(name):
    if name not in _TREES:
        _TREES[name] = {
            "bench": lambda: datagen.make_taxonomy(2, 8, 3, seed=0),
            "wide": lambda: datagen.make_taxonomy(2, 512, 64, seed=0),
            "chain": lambda: chain_taxonomy(5000)}[name]()
    return _TREES[name]


def _reads(tax, name, B, R, rng):
    """(taxon lanes, t_in, t_out, valid) [B, R]. Reads 0-3 have no hit,
    read 1 no valid probe. On the chain, each read's hits are two chain
    nodes' unit intervals [tin, tin + 1), R // 4 hits each, so the two
    tie and the winners' tins are two deep nodes; its lanes are random
    chain nodes (the taxon form's u and v). Elsewhere a read's hits come
    from four random taxa, half its probes misses."""
    n = tax.num_taxa
    if name == "chain":
        nodes = rng.integers(1, n + 1, size=(B, 2))
        which = np.full((B, R), -1)
        which[:, :R // 4] = 0
        which[:, R // 4:R // 2] = 1
        which = rng.permuted(which, axis=1)
        node = np.where(which >= 0,
                        np.take_along_axis(nodes, np.maximum(which, 0), 1), 0)
        t_in = np.where(which >= 0, tax.tin[node], 0)
        t_out = np.where(which >= 0, t_in + 1, 0)
        lanes = np.where(which >= 0, rng.integers(1, n + 1, size=(B, R)), 0)
    else:
        lineage = rng.integers(1, n + 1, size=(B, 4))
        taxa = lineage[np.arange(B)[:, None], rng.integers(0, 4, (B, R))]
        lanes = np.where(rng.random((B, R)) < 0.5, taxa, 0)
        t_in = np.where(lanes != 0, tax.tin[lanes], 0)
        t_out = np.where(lanes != 0, tax.tout[lanes], 0)
    lanes[:4] = 0
    valid = (rng.random((B, R)) < 0.8) | (lanes != 0)
    valid[1] = False
    return [np.ascontiguousarray(a, dtype=a.dtype if a.dtype == bool
                                 else np.int32)
            for a in (lanes, t_in, t_out, valid)]


def _prior(own, n_taxa, rng):
    """An earlier call for the reads whose own call is ``own`` (numpy
    taxon, best, nvalid): agreements, conflicts, unclassified and random
    calls, exact confidence ties ((k b, k n) of the read's own), and the
    int32 extremes in the last rows."""
    t2, b2, n2 = own
    B = t2.shape[0]
    kind = rng.integers(0, 5, size=B)
    other = rng.integers(1, n_taxa + 1, size=B)
    t1 = np.select([kind == 0, kind == 1, kind == 2],
                   [np.where(t2 != 0, t2, other),
                    np.where(other == t2, other % n_taxa + 1, other), 0],
                   rng.integers(0, n_taxa + 1, size=B))
    n1 = rng.integers(0, 300, size=B)
    b1 = np.minimum(rng.integers(0, 300, size=B), n1)
    k = rng.integers(1, 4, size=B)
    tie = kind == 4
    b1 = np.where(tie, k * b2, b1)
    n1 = np.where(tie, k * n2, n1)
    b1 = np.where(t1 == 0, 0, b1)
    # The extremes: products beyond int32, and the n1 + n2 wrap on the
    # reads without a hit (rows 0 and 2 have valid probes, 1 none).
    ext = [(t2[-1], BIG, BIG + 1), (other[-2], I32_MAX, I32_MAX),
           (t2[-3], BIG + 1, BIG), (other[-4], BIG - 1, BIG),
           (t2[-5], I32_MAX - 1, I32_MAX)]
    for j, (t, b, n) in enumerate(ext):
        t1[B - 1 - j], b1[B - 1 - j], n1[B - 1 - j] = t, b, n
    for row, n in ((0, I32_MAX), (1, I32_MAX), (2, BIG)):
        t1[row], b1[row], n1[row] = 0, 0, n
    return [np.ascontiguousarray(a, dtype=np.int32) for a in (t1, b1, n1)]


def _tax(tax, jax=False):
    arrays = tax.device_arrays()
    if jax:
        return {k: jnp.asarray(v) for k, v in arrays.items()}
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _check_cases(prior, own):
    """Every case of the merge is present among the reads."""
    t1, b1, n1 = (p.astype(np.int64) for p in prior)
    t2, b2, n2 = (np.asarray(o, np.int64) for o in own)
    assert ((t1 != 0) & (t1 == t2)).sum() > 5
    assert ((t1 != 0) & (t2 != 0) & (t1 != t2)).sum() > 5
    assert ((t1 == 0) & (t2 == 0)).sum() >= 2
    assert ((t1 == 0) != (t2 == 0)).sum() > 5
    assert ((b1 * n2 == b2 * n1) & (t1 != 0) & (t2 != 0)).sum() > 5


def _jax_call(form, lanes, t_in, t_out, valid, tax_j, thr):
    nvalid = jnp.asarray(valid.sum(1).astype(np.int32))
    if form == "taxon":
        return score_reads_jnp((jnp.asarray(lanes), jnp.asarray(t_in),
                                jnp.asarray(t_out)), nvalid, tax_j, thr)
    hit = (lanes != 0).astype(np.int32)
    return score_reads_tin_jnp((jnp.asarray(hit), jnp.asarray(t_in),
                                jnp.asarray(t_out)), nvalid, tax_j, thr)


def _with_prior(fn_args, form, tree, merge_tree, thr, scorer):
    lanes, t_in, t_out, valid = fn_args
    tax, mtax = _tree(tree), _tree(merge_tree)
    first = lanes if form == "taxon" else (lanes != 0).astype(np.int32)
    args = [torch.from_numpy(a) for a in (first, t_in, t_out, valid)]
    own = scorer(*args, _tax(tax), thr)
    rng = np.random.default_rng(len(tree) * 31 + int(thr * 100))
    prior = _prior([o.numpy() for o in own], mtax.num_taxa, rng)
    call = dict(zip(KEYS, (torch.from_numpy(p) for p in prior)))
    got = scorer(*args, _tax(tax), thr, prior=(call, _tax(mtax)))
    want = merge_multik_jnp(
        dict(zip(KEYS, (jnp.asarray(p) for p in prior))),
        _jax_call(form, lanes, t_in, t_out, valid, _tax(tax, True), thr),
        _tax(mtax, True))
    for g, key in zip(got, KEYS):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[key]),
                                      err_msg=f"{form} {key}")
    return prior, own


@pytest.mark.parametrize("thr", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("form", ["taxon", "q8"])
@pytest.mark.parametrize("tree,merge_tree", [
    ("bench", "bench"), ("wide", "wide"), ("chain", "chain"),
    ("bench", "wide")], ids=["bench_direct", "wide_lifted", "chain_lifted",
                             "bench_merged_over_wide"])
def test_scorer_with_prior_matches_jax(tree, merge_tree, form, thr):
    """The plain scorer with prior= against merge_multik_jnp(prior,
    score_reads_jnp(...)) (score_reads_tin_jnp for the q8 form)."""
    rng = np.random.default_rng(7 + len(tree))
    reads = _reads(_tree(tree), tree, 160, 64, rng)
    scorer = score_reads_taxon if form == "taxon" else score_reads_tin
    prior, own = _with_prior(reads, form, tree, merge_tree, thr, scorer)
    if thr < 1.0:                 # at 1.0 nearly every read is below it
        _check_cases(prior, [o.numpy() for o in own])
    if thr == 0.0:
        assert (own[0].numpy()[4:] != 0).all()
    if tree == "chain" and form == "taxon" and thr == 0.0:
        # The winners are two random chain nodes: their LCA lifts deep.
        depth = _tree("chain").depth[own[0].numpy()[4:]]
        assert depth.max() > 1000 and _tree("chain").lifting_table(
            ).shape[0] == 13


@pytest.mark.parametrize("form", ["taxon", "q8"])
def test_ranked_scorer_with_prior_matches_jax(form):
    """K8's plain path (R = 2,049) lifted on the wide tree and merged."""
    rng = np.random.default_rng(11)
    reads = _reads(_tree("wide"), "wide", 12, 2049, rng)

    def scorer(*args, prior=None):
        return score_ranked(*args, form == "taxon", prior=prior)
    _with_prior(reads, form, "wide", "wide", 0.05, scorer)


def _cpu_dispatch(monkeypatch):
    """Every wrapper takes its launch path on CPU tensors (the fake
    library records the calls)."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "dispatch_device", lambda *t: cpu)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)


# The scorer's launch arguments by name (csrc/common.cuh score_args).
ARGS = ("lanes", "t_in", "t_out", "valid", "B", "R", "taxon_lanes", "tin",
        "tout", "depth", "T1", "parent", "up", "levels", "tin2node", "M",
        "thr", "o0", "o1", "o2", "o3", "o4", "o5", "general", "prior",
        "p_best", "p_nvalid", "m_parent", "m_depth", "m_up", "m_levels",
        "m_T1", "wpr", "rpb", "cap", "per_read", "rpad", "scratch")


def _named(args):
    assert len(args) == len(ARGS) + 1                      # and the stream
    return dict(zip(ARGS, args))


@pytest.mark.parametrize("R", [260, 2049])
@pytest.mark.parametrize("form", ["taxon", "q8"])
def test_lifted_and_merged_calls_launch_the_scorer_once(fake, monkeypatch,
                                                        form, R):
    """A scoring call past 4,096 taxa, plain or merged, is one launch of
    the scorer with the lifting arrays (and the prior's) in its
    arguments, counted on lca_lift (and merge_multik) beside the
    scorer."""
    lib, _ = fake
    _cpu_dispatch(monkeypatch)
    tax, mtax = _tax(_tree("wide")), _tax(_tree("bench"))
    B = 40
    lanes = torch.ones((B, R), dtype=torch.int32)
    valid = torch.ones((B, R), dtype=torch.bool)
    call = {k: torch.zeros(B, dtype=torch.int32) for k in KEYS}
    name = "pangea_score_ranked" if R > 2048 else "pangea_score"
    scorer = (score_ranked if R > 2048 else
              score_reads_taxon if form == "taxon" else score_reads_tin)
    extra = (form == "taxon",) if R > 2048 else ()
    reset_kernel_launches()
    scorer(lanes, lanes, lanes, valid, tax, 0.05, *extra)
    scorer(lanes, lanes, lanes, valid, tax, 0.05, *extra,
           prior=(call, mtax))
    assert [c[0] for c in lib.calls] == [name, name]
    lifted, merged = (_named(c[1]) for c in lib.calls)
    for a in (lifted, merged):
        assert a["levels"] == tax["up"].shape[0] >= 1
        assert (a["parent"], a["up"], a["depth"]) == tuple(
            tax[n].data_ptr() for n in ("parent", "up", "depth"))
        assert a["T1"] == tax["tin"].shape[0] and a["tin"] == a["tout"] == 0
        if form == "taxon":
            assert a["tin2node"] == 0 and a["M"] == 0
        else:
            assert a["tin2node"] == tax["tin2node"].data_ptr()
            assert a["M"] == tax["tin2node"].shape[0]
        assert a["o3"] == a["o4"] == a["o5"] == 0
        assert a["thr"] == pytest.approx(0.05)
        assert a["taxon_lanes"] == int(form == "taxon")
    for key in ("prior", "p_best", "p_nvalid", "m_parent", "m_depth",
                "m_up", "m_levels", "m_T1"):
        assert lifted[key] == 0
    assert (merged["prior"], merged["p_best"], merged["p_nvalid"]) == tuple(
        call[k].data_ptr() for k in KEYS)
    assert (merged["m_parent"], merged["m_depth"], merged["m_up"]) == tuple(
        mtax[n].data_ptr() for n in ("parent", "depth", "up"))
    assert (merged["m_levels"], merged["m_T1"]) == (
        mtax["up"].shape[0], mtax["tin"].shape[0])
    counts = {k: v for k, v in kernel_launches().items() if v}
    key = ("score_ranked" if R > 2048 else
           "score_taxon" if form == "taxon" else "score_tin")
    assert counts == {key: 2, "lca_lift": 2, "merge_multik": 1}


def test_direct_call_merges_in_its_launch(fake, monkeypatch):
    """Up to 4,096 taxa: the direct tail's arrays, and the prior merged in
    the same launch; the winners form refuses a prior."""
    lib, _ = fake
    _cpu_dispatch(monkeypatch)
    tax = _tax(_tree("bench"))
    B, R = 16, 32
    lanes = torch.ones((B, R), dtype=torch.int32)
    valid = torch.ones((B, R), dtype=torch.bool)
    call = {k: torch.zeros(B, dtype=torch.int32) for k in KEYS}
    reset_kernel_launches()
    score_reads_tin(lanes, lanes, lanes, valid, tax, 0.0, prior=(call, tax))
    (name, args), = lib.calls
    a = _named(args)
    assert name == "pangea_score"
    assert (a["tin"], a["tout"], a["depth"], a["T1"]) == (
        tax["tin"].data_ptr(), tax["tout"].data_ptr(),
        tax["depth"].data_ptr(), 68)
    assert a["levels"] == a["parent"] == a["up"] == a["tin2node"] == 0
    assert a["prior"] == call["taxon"].data_ptr() and a["m_T1"] == 68
    assert a["cap"] <= SCORE_MAX_CAP
    assert {k: v for k, v in kernel_launches().items() if v} == {
        "score_tin": 1, "merge_multik": 1}
    from pangea_tpu_torch.kernels.score import _launch_score
    with pytest.raises(ValueError, match="prior"):
        _launch_score(torch.device("cpu"), lanes, lanes, lanes, valid, True,
                      prior=(call, tax))


@pytest.fixture(scope="module")
def multik_world():
    """Two indexes (k=21 and k=31, w=1) on the reference's small world."""
    tax, genomes, idx21, rs = small_world(k=21, n_reads=40, read_len=120,
                                          paired=True)
    from pangea_tpu.index import build_index
    idx31 = build_index(genomes, tax, k=31)
    return [DeviceIndex.from_index(ix, "cpu", 0.05)
            for ix in (idx21, idx31)], rs


def test_multik_step_launches_one_scorer_an_index(fake, monkeypatch,
                                                  multik_world):
    """A two-index multi-k step through the fake library: two scorer
    launches and no other launcher of a score or a merge; the second
    merges the first's outputs over the first index's taxonomy."""
    lib, _ = fake
    _cpu_dispatch(monkeypatch)
    dis, _ = multik_world
    B, L = 8, 120
    bases = torch.full((B, L), 2, dtype=torch.int8)
    reset_kernel_launches()
    classify_multik(tuple(d.tables for d in dis), bases,
                    tuple(d.cfg for d in dis), mate_bases=bases)
    names = [c[0] for c in lib.calls]
    scores = [c for c in lib.calls if "score" in c[0]]
    assert [c[0] for c in scores] == ["pangea_score"] * 2
    assert not [n for n in names if "merge" in n or "lca" in n]
    first, second = (_named(c[1]) for c in scores)
    assert first["prior"] == 0
    assert (second["prior"], second["p_best"], second["p_nvalid"]) == (
        first["o0"], first["o1"], first["o2"])
    tax0 = dis[0].tax
    assert (second["m_parent"], second["m_depth"], second["m_up"]) == tuple(
        tax0[n].data_ptr() for n in ("parent", "depth", "up"))
    counts = kernel_launches()
    assert counts["score_tin"] + counts["score_taxon"] == 2
    assert counts["merge_multik"] == 1 and counts["lca_lift"] == 0


@pytest.mark.parametrize("entry,plain", [
    ("classify_multik", False), ("classify_multik", True),
    ("MultiKClassifier", False)], ids=["wrappers", "plain", "module"])
def test_multik_fold_scores_later_indexes_with_the_running_prior(
        monkeypatch, multik_world, entry, plain):
    """On CPU tensors the multi-k fold calls classify_reads once an index,
    each later one with prior=(the running call, the first index's
    taxonomy arrays), and its result is the pairwise merge's."""
    from pangea_tpu_torch.classify import engine
    from pangea_tpu_torch.kernels import merge_multik_plain
    dis, rs = multik_world
    seen = []
    real = engine.classify_reads

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((kw.get("prior"), out))
        return out
    monkeypatch.setattr(engine, "classify_reads", spy)
    from pangea_tpu_torch.classify import pad_batch
    n = len(rs.seqs)
    b1 = torch.from_numpy(pad_batch(rs.seqs, n, 120))
    b2 = torch.from_numpy(pad_batch(rs.mates, n, 120))
    if entry == "MultiKClassifier":
        model = MultiKClassifier(dis)
        got = model(b1, b2)
        tax0 = model.classifiers[0].index.tax
    else:
        got = classify_multik(tuple(d.tables for d in dis), b1,
                              tuple(d.cfg for d in dis), mate_bases=b2,
                              plain=plain)
        tax0 = dis[0].tables["tax"]
    assert len(seen) == 2 and seen[0][0] is None
    prior, second = seen[1]
    assert prior[0] is seen[0][1]
    assert all(prior[1][k] is tax0[k] for k in ("parent", "depth", "up"))
    assert got is second
    # The fold equals the two calls without a prior, merged pairwise.
    calls = [real(d.tables, b1, d.cfg, mate_bases=b2, plain=True)
             for d in dis]
    want = merge_multik_plain(*calls, dis[0].tables["tax"])
    for key in KEYS:
        assert torch.equal(got[key], want[key])


def test_lift_and_merge_wrappers_run_plain_and_refuse_the_card(monkeypatch):
    """lca_lift and merge_multik run their plain versions on CPU tensors;
    on the card they exist only in the scorer's launch, so CUDA tensors
    raise."""
    from pangea_tpu_torch.kernels import (lca_lift, lca_lift_plain,
                                          merge_multik, merge_multik_plain,
                                          score_winners_plain)
    tax = _tax(_tree("wide"))
    rng = np.random.default_rng(3)
    reads = [torch.from_numpy(a)
             for a in _reads(_tree("wide"), "wide", 20, 32, rng)]
    winners = score_winners_plain(*reads, True)
    lifted = lca_lift(*winners, tax, 0.05, True)
    assert torch.equal(lifted, lca_lift_plain(*winners, tax, 0.05, True))
    calls = [dict(zip(KEYS, (lifted, winners[4], winners[5]))),
             dict(zip(KEYS, (torch.flip(lifted, [0]), winners[4],
                             winners[5])))]
    merged = merge_multik(*calls, tax)
    for key, want in merge_multik_plain(*calls, tax).items():
        assert torch.equal(merged[key], want)
    monkeypatch.setattr(_build, "dispatch_device",
                        lambda *t: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="scorer's launch"):
        lca_lift(*winners, tax, 0.05, True)
    with pytest.raises(ValueError, match="scorer's launch"):
        merge_multik(*calls, tax)
