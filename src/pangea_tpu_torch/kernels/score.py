"""Per-read consensus score and LCA (SEMANTICS.md §6-7), and the multi-k
merge (§9).

Counterpart of ``pangea_tpu/kernels/score.py`` ``_score_impl``, for both
lookups:

- the q8 form (``score_reads_tin_jnp``): the lanes are hit counts, and the
  winners' node ids are recovered from their Euler tins;
- the taxon form (``score_reads_jnp``, the std lookup): the lanes are hit
  taxa, and the winners' node ids are read from them.

The LCA of the winners is the direct scan over the taxonomy
(``_lca_by_tin_direct``) when it has at most :data:`DIRECT_LCA_MAX_TAXA`
entries (T + 1), and binary lifting (``lca_pairs_jnp``) above that. The
pscore is the quadratic count (``_pscore_quadratic``) for reads of up to
:data:`MAX_PROBES` probes and the sort-rank form (``_pscore_ranked``, the
long-read buckets) above; the two agree wherever every hit's t_in < t_out,
as in every sound table. Given ``prior``, an earlier call and the
taxonomy arrays of its merge, the read's call is merged with it as
``pangea_tpu/classify/merge.py`` ``merge_multik_jnp`` merges two calls,
the earlier one as res1 (the multi-k step's fold).

On CUDA tensors :func:`score_reads_tin` and :func:`score_reads_taxon` run
kernel K3 (``csrc/score_tin.cu``) up to MAX_PROBES probes and K8
(``csrc/score_ranked.cu``, counted on :func:`score_ranked`) above, one
launch whatever the tail: the direct scan, the lifted LCA (K5, counted on
:func:`lca_lift`) and the merge (K7, counted on :func:`merge_multik`) run
in the launch's tail (``csrc/common.cuh`` ``score_tail``). On CPU tensors
they run :func:`score_reads_plain`.

K3 and K8 score a read from the distinct (t_in, t_out) intervals among its
hits (``csrc/common.cuh`` ``score_kernel``): a probe's pscore depends on
its t_in alone, so U^2 compares over the U distinct intervals, each
weighted by its multiplicity, give every probe's pscore. A read with more
than the plan's ``cap`` distinct intervals takes its kernel's exact
general branch in the same launch (K3: the quadratic count; K8: the sort),
and the launch counts it (:func:`general_reads`). :func:`score_plan` sets
the launch: warps a read, reads a block, the cap (:func:`score_cap`) and
the shared memory.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .lookup import narrow

_I32_MAX = 2**31 - 1
MAX_PROBES = 2048            # K3 up to here (the reference's _RANKED_MIN_P)
DIRECT_LCA_MAX_TAXA = 4096   # the reference's _DIRECT_LCA_MAX_TAXA
_PLAIN_PSCORE_ELEMS = 1 << 26   # [B, R, R] elements a plain pscore step
# The scorer's launch (score_plan). SCORE_CAPS: the distinct intervals a
# read's table holds before the read takes the general branch, by R (the
# first entry whose bound is at least R): the largest U at which the table
# beat the general branch in kernels.score_sweep on an NVIDIA H100 80GB
# HBM3 at 700 W (16 at R = 32, 64 at R = 260, past 128 at R = 1,180 and
# 16,364): the general branch's R^2 (or sort) work grows faster with R
# than the table's. At most SCORE_MAX_CAP, the kernel's
# kScoreMaxCap. One warp a read and SCORE_READS a block where reads are
# many, more warps a read where B reads would give the card fewer than
# SCORE_SM_WARPS warps an SM; K8 always a block of 32 warps a read.
SCORE_CAPS = ((64, 16), (512, 64), (None, 128))
SCORE_MAX_CAP = 128
SCORE_READS = 8              # the kernel's kScoreMaxReads
SCORE_SM_WARPS = 16
RANKED_WARPS = 32
# Dynamic shared bytes a scoring block may take: the H100's 227 KB opt-in
# less the block's static per-read state (8 x 40 B) and a margin. K8 sorts
# in shared memory when its three [Rpad] arrays fit, else in a device
# scratch.
SCORE_SMEM_MAX = 232448 - 4096
# A block of one-warp reads takes at most this many of them, so that an SM
# holds four such blocks.
SCORE_BLOCK_SMEM = SCORE_SMEM_MAX // 4


class ScorePlan(NamedTuple):
    """The scorer's launch: ``grid`` blocks of ``reads`` reads of
    ``warps`` warps each; a read's table holds ``cap`` distinct intervals;
    ``per_read`` shared bytes a read (its table, or its general branch's
    arrays, which reuse them), ``smem`` a block; K8's sort width
    ``rpad`` (0 for K3) and whether it sorts in a device ``scratch``."""
    grid: int
    warps: int
    reads: int
    cap: int
    per_read: int
    smem: int
    rpad: int
    scratch: bool


def score_slots(cap: int) -> int:
    """Slots of a read's hash table (csrc/common.cuh score_slots): a power
    of two, at least 32, with room for cap entries and one chunk's 32."""
    slots = 32
    while slots < cap + 32:
        slots *= 2
    return slots


def _pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def score_cap(R: int) -> int:
    """The table capacity SCORE_CAPS gives reads of R probes."""
    return next(cap for bound, cap in SCORE_CAPS if bound is None
                or R <= bound)


@functools.lru_cache(maxsize=256)
def score_plan(B: int, R: int, sms: int, cap: int | None = None
               ) -> ScorePlan:
    """The scorer's launch for B reads of R probes on a card of ``sms``
    SMs, with a table of ``cap`` distinct intervals (None: score_cap(R)).
    K3 (R <= MAX_PROBES) gives a read one warp and a block SCORE_READS
    reads where B fills the card with SCORE_SM_WARPS warps an SM, else
    enough warps a read (a power of two, at most one a 32-probe chunk and
    32) and one read a block; K8 gives a read a block of RANKED_WARPS. A
    read's shared bytes hold its hash table of score_slots(cap) slots and
    its cap packed entries, 16 bytes each, or its general branch's
    arrays: K3's 16 bytes a probe where R > cap (no table can overflow
    otherwise), K8's three [Rpad] int32 arrays where they fit
    SCORE_SMEM_MAX (else a device scratch). A block of one-warp reads
    holds no more of them than SCORE_BLOCK_SMEM bytes take."""
    if cap is None and R >= 1:
        cap = score_cap(R)
    if B < 0 or R < 1 or sms < 1 or not 1 <= cap <= SCORE_MAX_CAP:
        raise ValueError(f"B={B}, R={R}, sms={sms}, cap={cap}")
    chunks = -(-R // 32)
    ranked = R > MAX_PROBES
    if ranked:
        warps = RANKED_WARPS
    else:
        want = -(-(sms * SCORE_SM_WARPS) // max(B, 1))
        warps = min(32, _pow2(chunks), _pow2(want))
    tables = 16 * (score_slots(cap) + cap)
    rpad, scratch = 0, False
    if ranked:
        rpad = _pow2(R)
        general = 12 * rpad
        scratch = max(general, tables) > SCORE_SMEM_MAX
        if scratch:
            general = 0
    else:
        general = 16 * R if R > cap else 0
    per_read = -(-max(tables, general) // 16) * 16
    if per_read > SCORE_SMEM_MAX:
        raise ValueError(f"a read of {R} probes needs {per_read} shared "
                         f"bytes, more than {SCORE_SMEM_MAX}")
    reads = 1 if warps > 1 else max(1, min(SCORE_READS,
                                           SCORE_BLOCK_SMEM // per_read))
    return ScorePlan(-(-B // reads), warps, reads, cap, per_read,
                     reads * per_read, rpad, scratch)


def _pscore_plain(t_in, t_out, hit):
    """[B, R] count of hit intervals containing each probe's t_in, over row
    chunks that bound the [Bc, R, R] intermediate."""
    B, R = t_in.shape
    bc = max(_PLAIN_PSCORE_ELEMS // max(R * R, 1), 1)
    parts = []
    for s in range(0, B, bc):
        ti, to, h = t_in[s:s + bc], t_out[s:s + bc], hit[s:s + bc]
        anc = ((ti[:, :, None] <= ti[:, None, :])
               & (ti[:, None, :] < to[:, :, None]) & h[:, :, None])
        parts.append(anc.sum(1, dtype=torch.int32))
    return torch.cat(parts) if parts else torch.zeros_like(t_in)


def pscore_ranked_plain(t_in, t_out, hit):
    """[B, R] sort-rank pscore (the reference's ``_pscore_ranked``): misses
    are masked to INT32_MAX, both arrays sorted, and each probe's pscore is
    #{tin <= t_in} - #{tout <= t_in}. Meaningful at hit positions."""
    big = torch.tensor(_I32_MAX, dtype=t_in.dtype, device=t_in.device)
    tin_s = torch.where(hit, t_in, big).sort(dim=1).values
    tout_s = torch.where(hit, t_out, big).sort(dim=1).values
    rank_in = torch.searchsorted(tin_s, t_in, right=True)
    rank_out = torch.searchsorted(tout_s, t_in, right=True)
    return (rank_in - rank_out).to(torch.int32)


def score_winners_plain(lanes, t_in, t_out, valid, taxon_lanes: bool):
    """The part of :func:`score_reads_plain` before the LCA. lanes int32
    [B, R]: hit counts (q8) or hit taxa (taxon_lanes). Returns (u, v,
    tin_u, tin_v, best, nvalid) int32 [B]: the min-tin and max-tin winners'
    node ids (q8: 1 if the read has a winner, else 0) and tins (INT_MAX and
    -2 without a winner), the best pscore and the valid-probe count."""
    hit = lanes != 0
    pscore_fn = (pscore_ranked_plain if lanes.shape[1] > MAX_PROBES
                 else _pscore_plain)
    pscore = torch.where(hit, pscore_fn(t_in, t_out, hit), 0)
    best = pscore.max(dim=1).values
    winner = hit & (pscore == best[:, None]) & (best[:, None] > 0)
    tin_u = torch.where(winner, t_in, _I32_MAX).min(dim=1).values
    tin_v = torch.where(winner, t_in, -2).max(dim=1).values
    if taxon_lanes:
        u = torch.where(winner & (t_in == tin_u[:, None]), lanes,
                        0).max(dim=1).values
        v = torch.where(winner & (t_in == tin_v[:, None]), lanes,
                        0).max(dim=1).values
    else:
        u = v = (best > 0).to(torch.int32)
    nvalid = valid.sum(dim=1, dtype=torch.int32)
    return (u.to(torch.int32), v.to(torch.int32), tin_u.to(torch.int32),
            tin_v.to(torch.int32), best.to(torch.int32), nvalid)


def _identity(res, u, v):
    """The LCA's identity rules for 0 (the reference's score.py:154)."""
    return torch.where((u == 0) & (v == 0), 0,
                       torch.where(u == 0, v, torch.where(v == 0, u, res)))


def _threshold(assigned, best, nvalid, confidence_threshold: float):
    """taxon = 0 when float32(best) < float32(thr) * float32(nvalid) (one
    rounded multiply) or nvalid == 0."""
    thr = torch.tensor(confidence_threshold, dtype=torch.float32,
                       device=nvalid.device)
    below = best.to(torch.float32) < thr * nvalid.to(torch.float32)
    return torch.where(below | (nvalid == 0), 0, assigned).to(torch.int32)


def lca_direct_plain(u, v, tin_u, tin_v, tin, tout, depth):
    """Pairwise LCA by scanning the taxonomy: the deepest taxon whose
    [tin, tout) holds both tins (first index on a tie), then the identity
    rules for 0."""
    ca = ((tin[None, :] <= tin_u[:, None]) & (tin_u[:, None] < tout[None, :])
          & (tin[None, :] <= tin_v[:, None])
          & (tin_v[:, None] < tout[None, :]))
    res = torch.where(ca, depth[None, :], -1).argmax(dim=1)
    return _identity(res, u, v).to(torch.int32)


def lca_pairs_plain(u, v, parent, depth, up):
    """Pairwise LCA by binary lifting (the reference's ``lca_pairs_jnp``).
    u, v int32 [B]; parent/depth int32 [T+1]; up int32 [levels, T+1].
    0 acts as identity."""
    u, v = u.long(), v.long()
    zu, zv = u == 0, v == 0
    uu = torch.where(zu, 1, u)
    vv = torch.where(zv, 1, v)
    du, dv = depth[uu].long(), depth[vv].long()
    swap = dv > du
    a = torch.where(swap, vv, uu)            # a is the deeper node
    b = torch.where(swap, uu, vv)
    diff = (du - dv).abs()
    for lvl in range(up.shape[0] - 1, -1, -1):
        a = torch.where(((diff >> lvl) & 1) == 1, up[lvl][a].long(), a)
    equal = a == b
    for lvl in range(up.shape[0] - 1, -1, -1):
        ua, ub = up[lvl][a].long(), up[lvl][b].long()
        move = ~equal & (ua != ub)
        a = torch.where(move, ua, a)
        b = torch.where(move, ub, b)
    res = torch.where(equal, a, parent[a].long())
    return _identity(res, u, v).to(torch.int32)


def _recover_nodes(u, v, tin_u, tin_v, tin2node):
    """q8: node ids of the winners from their tins (0 without a winner)."""
    top = tin2node.shape[0] - 1
    has = u != 0
    u = torch.where(has, tin2node[tin_u.clamp(0, top).long()], 0)
    v = torch.where(has, tin2node[tin_v.clamp(0, top).long()], 0)
    return u, v


def lca_lift_plain(u, v, tin_u, tin_v, best, nvalid, tax: dict,
                   confidence_threshold: float, taxon_lanes: bool):
    """Plain K5: the winners' LCA by binary lifting (q8: node ids first
    recovered through ``tin2node``), then the threshold. int32 [B] in,
    taxon int32 [B] out."""
    if not taxon_lanes:
        u, v = _recover_nodes(u, v, tin_u, tin_v, tax["tin2node"])
    assigned = lca_pairs_plain(u, v, tax["parent"], tax["depth"], tax["up"])
    return _threshold(assigned, best, nvalid, confidence_threshold)


_KEYS = ("taxon", "best", "nvalid")


def merge_multik_plain(res1: dict, res2: dict, tax: dict) -> dict:
    """Plain K7, the multi-k merge (the reference's ``merge_multik_jnp``).
    res1/res2: dicts of int32 [B] "taxon", "best", "nvalid"; tax: the
    taxonomy's device arrays (``parent``, ``depth``, ``up`` are read).
    The confidences b1/n1 and b2/n2 compare exactly as the int64 products
    b1·n2 and b2·n1 (best and nvalid are counts, never negative), where
    the reference needs 16-bit limb products. Agreement keeps the more
    confident call, a conflict takes the LCA with the less confident
    call's (best, nvalid), ties go to res1; a one-sided call keeps the
    classified one; two unclassified calls give (0, 0, n1 + n2), the sum
    wrapping in int32."""
    t1, b1, n1 = (res1[k] for k in _KEYS)
    t2, b2, n2 = (res2[k] for k in _KEYS)
    x1 = b1.long() * n2.long()
    x2 = b2.long() * n1.long()
    both0 = (t1 == 0) & (t2 == 0)
    agree = (t1 != 0) & (t1 == t2)
    conflict = (t1 != 0) & (t2 != 0) & (t1 != t2)
    lca = lca_pairs_plain(t1, t2, tax["parent"], tax["depth"], tax["up"])
    taxon = torch.where(conflict, lca, torch.where(t1 != 0, t1, t2))
    keep1 = torch.where(agree, x1 >= x2,
                        torch.where(conflict, x1 <= x2, t1 != 0))
    best = torch.where(both0, 0, torch.where(keep1, b1, b2))
    nvalid = torch.where(both0, narrow(n1.long() + n2.long()),
                         torch.where(keep1, n1, n2))
    return {"taxon": taxon.to(torch.int32), "best": best.to(torch.int32),
            "nvalid": nvalid.to(torch.int32)}


def score_reads_plain(lanes, t_in, t_out, valid, tax: dict,
                      confidence_threshold: float, taxon_lanes: bool,
                      prior=None):
    """Plain PyTorch K3 (+ K5, + K7) on any device. lanes/t_in/t_out int32
    and valid bool [B, R]; tax: the taxonomy's device arrays (tin, tout,
    depth, parent, up, tin2node); prior: None, or (call, merge_tax), an
    earlier call dict(taxon, best, nvalid) int32 [B] that this one merges
    with (:func:`merge_multik_plain`, the earlier call as res1) over the
    taxonomy arrays merge_tax. Returns (taxon, best, nvalid) int32 [B]."""
    u, v, tin_u, tin_v, best, nvalid = score_winners_plain(
        lanes, t_in, t_out, valid, taxon_lanes)
    if tax["tin"].shape[0] <= DIRECT_LCA_MAX_TAXA:
        assigned = lca_direct_plain(u, v, tin_u, tin_v, tax["tin"],
                                    tax["tout"], tax["depth"])
        taxon = _threshold(assigned, best, nvalid, confidence_threshold)
    else:
        taxon = lca_lift_plain(u, v, tin_u, tin_v, best, nvalid, tax,
                               confidence_threshold, taxon_lanes)
    if prior is None:
        return taxon, best, nvalid
    call, merge_tax = prior
    merged = merge_multik_plain(call, dict(zip(_KEYS, (taxon, best,
                                                       nvalid))), merge_tax)
    return tuple(merged[k] for k in _KEYS)


def score_reads_tin_plain(hit, t_in, t_out, valid, tax: dict,
                          confidence_threshold: float, prior=None):
    """:func:`score_reads_plain` of the q8 lookup's hit lanes."""
    return score_reads_plain(hit, t_in, t_out, valid, tax,
                             confidence_threshold, False, prior)


def score_reads_taxon_plain(taxon, t_in, t_out, valid, tax: dict,
                            confidence_threshold: float, prior=None):
    """:func:`score_reads_plain` of the std lookup's taxon lanes."""
    return score_reads_plain(taxon, t_in, t_out, valid, tax,
                             confidence_threshold, True, prior)


def _check_tax(tax: dict, names) -> int:
    """Raise unless the named taxonomy arrays are int32, contiguous and
    sized for T + 1 = len(tin) taxa (``up`` [levels >= 1, T + 1]); return
    T + 1."""
    T1 = tax["tin"].shape[0]
    for name in names:
        _build.check(tax[name], torch.int32,
                     shape=None if name in ("up", "tin2node") else (T1,),
                     ndim=2 if name == "up" else 1, name=name)
    if "up" in names and (tax["up"].shape[1] != T1
                          or tax["up"].shape[0] < 1):
        raise ValueError(f"up {tuple(tax['up'].shape)} is not "
                         f"[levels >= 1, {T1}]")
    return T1


def _check_lanes(lanes, t_in, t_out, valid):
    _build.check(lanes, torch.int32, ndim=2, name="lanes")
    B, R = lanes.shape
    for t, name in ((t_in, "t_in"), (t_out, "t_out")):
        _build.check(t, torch.int32, shape=(B, R), name=name)
    _build.check(valid, torch.bool, shape=(B, R), name="valid")
    if R == 0:
        raise ValueError("the scorer needs at least one probe a read")
    return B, R


def _general_counter(fn, dev) -> torch.Tensor:
    """The int32 [1] on ``dev`` that ``fn``'s launches add their
    general-branch reads to (made, zeroed, at its first launch there)."""
    counter = fn.general.get(dev.index)
    if counter is None:
        counter = fn.general[dev.index] = torch.zeros(1, dtype=torch.int32,
                                                      device=dev)
    return counter


_DIRECT = ("tin", "tout", "depth")
_LIFTED = ("parent", "depth", "up", "tin2node")
_MERGE = ("parent", "depth", "up")


def _tail_tensors(tax: dict | None, prior) -> list:
    """The taxonomy and prior tensors that the launch's tail reads."""
    out = []
    if tax is not None:
        out += [tax[n] for n in (_DIRECT if tax["tin"].shape[0]
                                 <= DIRECT_LCA_MAX_TAXA else _LIFTED)]
    if prior is not None:
        call, merge_tax = prior
        out += [call[k] for k in _KEYS] + [merge_tax[n] for n in _MERGE]
    return out


def _launch_score(dev, lanes, t_in, t_out, valid, taxon_lanes: bool,
                  tax: dict | None = None, thr: float = 0.0, prior=None,
                  plan: ScorePlan | None = None):
    """One launch of K3 (R <= MAX_PROBES) or K8. Without ``tax``, the
    winners form (u, v, tin_u, tin_v, best, nvalid); with it, (taxon, best,
    nvalid) by the direct LCA up to DIRECT_LCA_MAX_TAXA taxa, else by the
    lifted one (K5), merged with ``prior`` where given (K7; as
    :func:`score_reads_plain` takes it). ``plan`` overrides
    :func:`score_plan` (kernels.score_sweep). The launch counts on
    :func:`score_ranked` (K8), else on :func:`score_reads_taxon` or
    :func:`score_reads_tin`, and adds its general-branch reads to the same
    wrapper's counter; a lifted tail counts on :func:`lca_lift` too, a
    merged one on :func:`merge_multik`."""
    B, R = _check_lanes(lanes, t_in, t_out, valid)
    lifted = tax is not None and tax["tin"].shape[0] > DIRECT_LCA_MAX_TAXA
    if tax is None:
        if prior is not None:
            raise ValueError("the winners form takes no prior")
        taxa = (0,) * 9
    elif lifted:
        T1 = _check_tax(tax, _LIFTED[:3] + (() if taxon_lanes
                                             else _LIFTED[3:]))
        t2n = tax["tin2node"]
        taxa = (0, 0, tax["depth"].data_ptr(), T1, tax["parent"].data_ptr(),
                tax["up"].data_ptr(), tax["up"].shape[0],
                *((0, 0) if taxon_lanes else (t2n.data_ptr(),
                                              t2n.shape[0])))
    else:
        T1 = _check_tax(tax, _DIRECT)
        taxa = (*(tax[n].data_ptr() for n in _DIRECT), T1, 0, 0, 0, 0, 0)
    if prior is None:
        merge = (0,) * 8
    else:
        call, merge_tax = prior
        for k in _KEYS:
            _build.check(call[k], torch.int32, shape=(B,), name=f"prior {k}")
        mT1 = _check_tax(merge_tax, _MERGE)
        merge = (*(call[k].data_ptr() for k in _KEYS),
                 *(merge_tax[n].data_ptr() for n in _MERGE),
                 merge_tax["up"].shape[0], mT1)
    if plan is None:
        plan = score_plan(B, R, _build.sm_count(dev.index))
    out = torch.empty((6 if tax is None else 3, B), dtype=torch.int32,
                      device=dev)
    ptrs = [o.data_ptr() for o in out] + [0] * (6 - out.shape[0])
    ranked = R > MAX_PROBES
    fn = score_ranked if ranked else (score_reads_taxon if taxon_lanes
                                      else score_reads_tin)
    scratch = (torch.empty((B, 3, plan.rpad), dtype=torch.int32, device=dev)
               if plan.scratch else None)
    _build.launch("pangea_score_ranked" if ranked else "pangea_score", dev,
                  lanes.data_ptr(), t_in.data_ptr(), t_out.data_ptr(),
                  valid.data_ptr(), B, R, int(taxon_lanes), *taxa, float(thr),
                  *ptrs, _general_counter(fn, dev).data_ptr(),
                  *merge, plan.warps, plan.reads, plan.cap, plan.per_read,
                  plan.rpad, 0 if scratch is None else scratch.data_ptr())
    fn.launches += 1
    if lifted:
        lca_lift.launches += 1
    if prior is not None:
        merge_multik.launches += 1
    return tuple(out)


def score_winners(lanes, t_in, t_out, valid, taxon_lanes: bool):
    """K3's (or, past MAX_PROBES, K8's) winners form on CUDA tensors (the
    plain :func:`score_winners_plain` on CPU tensors): the part of the
    score before the LCA, which the scorer's sweeps and timings read. Same
    contract as :func:`score_winners_plain`."""
    dev = _build.dispatch_device(lanes, t_in, t_out, valid)
    if dev is None:
        return score_winners_plain(lanes, t_in, t_out, valid, taxon_lanes)
    return _launch_score(dev, lanes, t_in, t_out, valid, taxon_lanes)


def _score(lanes, t_in, t_out, valid, tax: dict,
           confidence_threshold: float, taxon_lanes: bool, prior=None):
    """The body of :func:`score_reads_tin`, :func:`score_reads_taxon` and
    :func:`score_ranked`: the plain version on CPU tensors; on CUDA tensors
    K3 or K8 in one launch, its tail the direct scan for up to
    DIRECT_LCA_MAX_TAXA taxa, else the lifted LCA, merged with ``prior``
    where given. Only the taxonomy arrays the tail reads are checked."""
    dev = _build.dispatch_device(lanes, t_in, t_out, valid,
                                 *_tail_tensors(tax, prior))
    if dev is None:
        return score_reads_plain(lanes, t_in, t_out, valid, tax,
                                 confidence_threshold, taxon_lanes, prior)
    return _launch_score(dev, lanes, t_in, t_out, valid, taxon_lanes, tax,
                         confidence_threshold, prior)


def score_reads_tin(hit, t_in, t_out, valid, tax: dict,
                    confidence_threshold: float, prior=None):
    """Score the q8 lookup's hits: the plain version for CPU tensors,
    kernel K3's q8 form (K8's past MAX_PROBES probes) for CUDA tensors, the
    LCA lifted above DIRECT_LCA_MAX_TAXA taxa and the call merged with
    ``prior`` in the same launch. Same contract as
    :func:`score_reads_tin_plain`."""
    return _score(hit, t_in, t_out, valid, tax, confidence_threshold,
                  False, prior)


def score_reads_taxon(taxon, t_in, t_out, valid, tax: dict,
                      confidence_threshold: float, prior=None):
    """Score the std lookup's hit taxa: the plain version for CPU tensors,
    kernel K3's taxon form (K8's past MAX_PROBES probes) for CUDA tensors,
    the LCA lifted above DIRECT_LCA_MAX_TAXA taxa and the call merged with
    ``prior`` in the same launch. Same contract as
    :func:`score_reads_taxon_plain`."""
    return _score(taxon, t_in, t_out, valid, tax, confidence_threshold,
                  True, prior)


def score_ranked(lanes, t_in, t_out, valid, tax: dict,
                 confidence_threshold: float, taxon_lanes: bool,
                 prior=None):
    """Score reads of more than MAX_PROBES probes (the long-read buckets):
    the plain version for CPU tensors, kernel K8 for CUDA tensors, its
    tail as :func:`score_reads_tin`'s. Same contract as
    :func:`score_reads_plain`. Every K8 launch counts here, also those of
    :func:`score_reads_tin`, :func:`score_reads_taxon` and
    :func:`score_winners` past MAX_PROBES."""
    if lanes.dim() != 2 or lanes.shape[1] <= MAX_PROBES:
        raise ValueError(f"lanes {tuple(lanes.shape)}: the ranked scorer "
                         f"takes more than {MAX_PROBES} probes a read")
    return _score(lanes, t_in, t_out, valid, tax, confidence_threshold,
                  taxon_lanes, prior)


def _tail_only(name: str, tensors) -> None:
    """Raise unless every tensor lies on the CPU: on the card K5 and K7
    run only in the scorer's tail."""
    if _build.dispatch_device(*tensors) is not None:
        raise ValueError(f"{name} runs on the card only in the scorer's "
                         "launch (score_reads_tin, score_reads_taxon, "
                         "score_ranked)")


def lca_lift(u, v, tin_u, tin_v, best, nvalid, tax: dict,
             confidence_threshold: float, taxon_lanes: bool):
    """K5's wrapper: :func:`lca_lift_plain` on CPU tensors. On the card
    the lift runs in the scorer's launch past DIRECT_LCA_MAX_TAXA taxa,
    and those launches count here; CUDA tensors raise."""
    _tail_only("lca_lift", (u, v, tin_u, tin_v, best, nvalid,
                            *(tax[n] for n in _LIFTED)))
    return lca_lift_plain(u, v, tin_u, tin_v, best, nvalid, tax,
                          confidence_threshold, taxon_lanes)


def merge_multik(res1: dict, res2: dict, tax: dict) -> dict:
    """K7's wrapper: :func:`merge_multik_plain` on CPU tensors. On the card
    the merge runs in the scorer's launch (``prior=``), and those launches
    count here; CUDA tensors raise."""
    _tail_only("merge_multik", (*(res1[k] for k in _KEYS),
                                *(res2[k] for k in _KEYS),
                                *(tax[n] for n in _MERGE)))
    return merge_multik_plain(res1, res2, tax)


def general_reads() -> dict:
    """Reads that took the general branch in the scorer's launches since
    the counters were last cleared (:func:`reset_general_reads`), by
    kernel name; reading them waits for those launches."""
    return {name: sum(int(c.item()) for c in fn.general.values())
            for name, fn in SCORERS.items()}


def reset_general_reads() -> None:
    for fn in SCORERS.values():
        fn.general = {}


score_reads_tin.launches = 0
score_reads_taxon.launches = 0
score_ranked.launches = 0
lca_lift.launches = 0
merge_multik.launches = 0
# The wrappers whose launches count general-branch reads, by kernel name.
SCORERS = {"score_tin": score_reads_tin, "score_taxon": score_reads_taxon,
           "score_ranked": score_ranked}
reset_general_reads()
