"""The scorer on the CPU: its launch plan, the scorer worlds of chosen U,
and the port's plain scorer against the JAX package.

``kernels/score.py`` ``score_plan`` is pure Python: its choices (warps a
read, reads a block, the table's cap, shared bytes, K8's sort width and
scratch) and limits are checked here for the main paths' shapes and
around them, and the wrappers hand the K3 and K8 launchers its numbers
(a fake library, as ``tests/test_torch_launch.py`` drives them).
``bench.score_world`` must give each read the number U of distinct
(t_in, t_out) intervals among its hits that it was asked for. The plain
scorer (``score_reads_taxon_plain``, ``score_reads_tin_plain``), the
oracle the kernels are held to on the card, must equal the reference's
``score_reads_jnp`` and ``score_reads_tin_jnp`` on those worlds, at
R = 1, 32, 260, 2,048 and 2,049, U = 0 (no hit), 1, 8 and every hit its
own, nested and unrelated, thresholds 0 and 0.3. Outputs are integers:
exact equality throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.kernels.score import score_reads_jnp, score_reads_tin_jnp
from pangea_tpu_torch.bench import (MISS_NOISE, chain_taxonomy,
                                    distinct_intervals, score_world)
from pangea_tpu_torch.kernels import (_build, general_reads,
                                      reset_kernel_launches,
                                      score_reads_taxon,
                                      score_reads_taxon_plain,
                                      score_reads_tin_plain, score_winners)
from pangea_tpu_torch.kernels.score import (MAX_PROBES, RANKED_WARPS,
                                            SCORE_BLOCK_SMEM, SCORE_CAPS,
                                            SCORE_MAX_CAP, SCORE_READS,
                                            SCORE_SM_WARPS, SCORE_SMEM_MAX,
                                            score_cap, score_plan,
                                            score_slots)
from pangea_tpu_torch.utils import datagen

from .test_torch_launch import fake  # noqa: F401  (a fixture)

SMS = 132                 # an H100 SXM's SMs
# The main paths' (B, R): the q8 headline, the std world, a 1,180-probe
# bucket, K8's checks; then edges.
SHAPES = [(16384, 32), (16384, 260), (16384, 240), (64, 1180), (512, 2048),
          (16384, 2048), (512, 2049), (75, 16364), (75, 32728), (1, 1),
          (0, 5), (3, 33), (131, 64), (2, 2048), (1, 65536)]


def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()


@pytest.mark.parametrize("cap", [1, 8, 64, SCORE_MAX_CAP, None])
@pytest.mark.parametrize("B,R", SHAPES)
def test_score_plan_fits_and_covers_every_read(B, R, cap):
    plan = score_plan(B, R, SMS, cap)
    ranked = R > MAX_PROBES
    if cap is None:
        cap = score_cap(R)
    assert plan.cap == cap
    assert plan.warps in (1, 2, 4, 8, 16, 32)
    assert 1 <= plan.reads <= SCORE_READS
    assert plan.reads == 1 or plan.warps == 1
    assert 32 * plan.warps * plan.reads <= 1024
    assert plan.grid * plan.reads >= B > (plan.grid - 1) * plan.reads
    assert plan.per_read % 16 == 0 and plan.smem == plan.reads * plan.per_read
    assert plan.smem <= SCORE_SMEM_MAX
    slots = score_slots(cap)
    assert slots >= cap + 32 and slots % 32 == 0 and slots & (slots - 1) == 0
    assert plan.per_read >= 16 * (slots + cap)
    if ranked:
        assert plan.warps == RANKED_WARPS and plan.reads == 1
        assert plan.rpad == _pow2(R) >= R
        assert plan.scratch == (12 * plan.rpad > SCORE_SMEM_MAX)
        assert plan.scratch or plan.per_read >= 12 * plan.rpad
    else:
        assert plan.rpad == 0 and not plan.scratch
        assert plan.warps <= _pow2(-(-R // 32))
        # The general branch's 16 bytes a probe, where a table can overflow.
        assert plan.per_read >= (16 * R if R > cap else 0)
        if plan.warps == 1:
            assert (plan.reads == SCORE_READS
                    or plan.reads * plan.per_read <= SCORE_BLOCK_SMEM
                    or plan.reads == 1)


def test_score_plan_at_the_main_paths_shapes():
    """One warp a read and eight reads a block on the q8 and std steps;
    K8's long reads sort in shared memory up to 16,384 probes and in the
    device scratch past it."""
    for R in (32, 260):
        plan = score_plan(16384, R, SMS)
        assert (plan.warps, plan.reads, plan.grid) == (1, 8, 2048)
    assert score_plan(16384, 32, SMS).per_read == 16 * (score_slots(16) + 16)
    assert not score_plan(75, 16364, SMS).scratch
    assert score_plan(75, 16364, SMS).rpad == 16384
    assert score_plan(75, 32728, SMS).scratch


@pytest.mark.parametrize("R", [64, 260, 1180, 2048])
@pytest.mark.parametrize("B", [1, 16, 64, 263, 4096])
def test_score_plan_fills_the_card_where_reads_are_few(B, R):
    """Where B reads of one warp would give the card fewer than
    SCORE_SM_WARPS warps an SM, a read gets more warps, up to one a
    32-probe chunk."""
    plan = score_plan(B, R, SMS)
    chunks = -(-R // 32)
    assert B * plan.warps >= min(SMS * SCORE_SM_WARPS, B * _pow2(chunks),
                                 32 * B)
    assert plan.warps == 1 or B * plan.warps // 2 < SMS * SCORE_SM_WARPS


@pytest.mark.parametrize("R,cap", [(1, 16), (32, 16), (64, 16), (65, 64),
                                   (260, 64), (512, 64), (513, 128),
                                   (1180, 128), (2048, 128), (16364, 128)])
def test_score_cap_follows_the_sweep(R, cap):
    """SCORE_CAPS by R: 16 up to 64 probes, 64 up to 512, 128 beyond."""
    assert score_cap(R) == cap == score_plan(4, R, SMS).cap
    assert all(c <= SCORE_MAX_CAP for _, c in SCORE_CAPS)


def test_score_plan_refuses_bad_shapes():
    for args in ((-1, 32, SMS), (4, 0, SMS), (4, 32, 0), (4, 32, SMS, 0),
                 (4, 32, SMS, SCORE_MAX_CAP + 1)):
        with pytest.raises(ValueError):
            score_plan(*args)


def _taxonomy(name):
    if name == "bench":
        return datagen.make_taxonomy(2, 8, 3, seed=0)        # 67 taxa
    if name == "lift":
        return datagen.make_taxonomy(2, 64, 40, seed=0)      # 5,251 taxa
    return chain_taxonomy(int(name.split("_")[1]))


@pytest.mark.parametrize("R", [32, 260])
@pytest.mark.parametrize("nested", [False, True], ids=["unrelated",
                                                      "nested"])
@pytest.mark.parametrize("U", [0, 1, 3, 8, None])
def test_score_world_gives_the_u_asked_for(U, nested, R):
    tax = _taxonomy("chain_300" if nested else "lift")
    B = 40
    miss = 0.0 if U is None else 0.5
    lanes, t_in, t_out, valid = score_world(tax, B, R, U, nested, miss,
                                            seed=R + (U or 0))
    assert lanes.shape == t_in.shape == t_out.shape == valid.shape == (B, R)
    assert lanes.dtype == t_in.dtype == t_out.dtype == np.int32
    hits = lanes != 0
    want = 0 if U == 0 else R - round(miss * R)
    u = distinct_intervals(lanes, t_in, t_out)
    assert u[0] == 0 and not hits[0].any()
    assert (u[1:] == (want if U is None else U)).all()
    assert (hits[1:].sum(1) == want).all()
    assert not valid[1].any() and valid[2:][hits[2:]].all()
    # Each hit's interval is its taxon's, or another taxon's at one t_in.
    taxa = np.flatnonzero(tax.tin >= 0)
    assert np.isin(t_in[hits], tax.tin[taxa]).all()
    ti = np.searchsorted(tax.tin[taxa], t_in[hits],
                         sorter=np.argsort(tax.tin[taxa]))
    owner = taxa[np.argsort(tax.tin[taxa])][ti]
    assert (tax.tout[owner] == t_out[hits]).all()
    if U and want > 20:
        assert (owner != lanes[hits]).any()          # lanes differ at a tin
    if nested and U:
        # One lineage: every interval of a read holds its deepest t_in.
        for b in range(2, B):
            lo, hi = t_in[b][hits[b]], t_out[b][hits[b]]
            assert ((lo <= lo.max()) & (lo.max() < hi)).all()
    assert (np.abs(t_in[~hits]) <= MISS_NOISE).all()


def test_score_world_refuses_what_it_cannot_draw():
    with pytest.raises(ValueError, match="lineage"):
        score_world(_taxonomy("bench"), 4, 260, 8, True, 0.5, 0)
    with pytest.raises(ValueError, match="hits"):
        score_world(_taxonomy("bench"), 4, 32, 20, False, 0.5, 0)
    with pytest.raises(ValueError, match="distinct taxa"):
        score_world(_taxonomy("bench"), 4, 260, None, False, 0.0, 0)


def _worlds():
    """(R, U, nested) of the plain-vs-JAX cases: U 0 is no hit, None every
    hit its own interval (no misses)."""
    for R in (1, 32, 260, 2048, 2049):
        for U in (0, 1, 8, None):
            for nested in (False, True):
                if R == 1 and U == 8 or U == 0 and nested:
                    continue
                yield R, U, nested


def _world_taxonomy(R, U, nested):
    if nested:
        return _taxonomy(f"chain_{max(R, 8) + 2}")
    return _taxonomy("lift" if U is None or R >= 260 else "bench")


@pytest.mark.parametrize("thr", [0.0, 0.3])
@pytest.mark.parametrize(
    "R,U,nested", list(_worlds()),
    ids=[f"R{r}-U{'all' if u is None else u}-{'nested' if n else 'unrel'}"
         for r, u, n in _worlds()])
def test_plain_scorer_matches_jax(R, U, nested, thr):
    """The port's plain scorer, both forms, against score_reads_jnp and
    score_reads_tin_jnp on the same scorer world (the direct LCA up to
    4,096 taxa, lifting above)."""
    tax = _world_taxonomy(R, U, nested)
    B = 6 if R >= 2048 else 24
    miss = 0.0 if U is None else 0.5
    lanes, t_in, t_out, valid = score_world(tax, B, R, U, nested, miss,
                                            seed=R * 7 + (U or 0))
    arrays = tax.device_arrays()
    tax_t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tax_j = {k: jnp.asarray(v) for k, v in arrays.items()}
    nvalid = jnp.asarray(valid.sum(1).astype(np.int32))
    hit = (lanes != 0).astype(np.int32)
    args = [torch.from_numpy(a) for a in (t_in, t_out, valid)]
    for form, plain, ref, first in (
            ("taxon", score_reads_taxon_plain, score_reads_jnp, lanes),
            ("q8", score_reads_tin_plain, score_reads_tin_jnp, hit)):
        got = plain(torch.from_numpy(first), *args, tax_t, thr)
        want = ref((jnp.asarray(first), jnp.asarray(t_in),
                    jnp.asarray(t_out)), nvalid, tax_j, thr)
        for g, key in zip(got, ("taxon", "best", "nvalid")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(want[key]),
                                          err_msg=f"{form} {key}")
        if U and thr == 0.0:
            assert (got[0][2:].numpy() != 0).any()
        assert got[0][:2].tolist() == [0, 0]     # no hit; no valid probe


@pytest.mark.parametrize("R,B", [(32, 40), (260, 3), (1180, 2), (2049, 2),
                                 (32728, 1)])
def test_score_launch_passes_score_plan(fake, monkeypatch, R, B):  # noqa: F811
    """K3's and K8's launchers get score_plan's numbers, K8's scratch
    where the plan sorts in device memory, and each launch counts on its
    own wrapper, beside its general-branch counter."""
    lib, _ = fake
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "dispatch_device", lambda *t: cpu)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    lanes = torch.ones((B, R), dtype=torch.int32)
    valid = torch.ones((B, R), dtype=torch.bool)
    reset_kernel_launches()
    score_winners(lanes, lanes, lanes, valid, True)
    tax = {k: torch.from_numpy(v) for k, v in
           _taxonomy("bench").device_arrays().items()}
    score_reads_taxon(lanes, lanes, lanes, valid, tax, 0.0)
    plan = score_plan(B, R, SMS)
    name = "pangea_score_ranked" if R > MAX_PROBES else "pangea_score"
    assert [c[0] for c in lib.calls] == [name, name]
    for _, args in lib.calls:
        assert args[4:6] == (B, R)
        assert args[-7:-1] == (plan.warps, plan.reads, plan.cap,
                               plan.per_read, plan.rpad,
                               args[-2] if plan.scratch else 0)
        assert (args[-2] != 0) == plan.scratch
    assert lib.calls[1][1][10] == 68                 # the direct form's T1
    from pangea_tpu_torch.kernels import kernel_launches
    counts = kernel_launches()
    key = "score_ranked" if R > MAX_PROBES else "score_taxon"
    assert counts[key] == 2
    assert general_reads() == {"score_tin": 0, "score_taxon": 0,
                               "score_ranked": 0}
