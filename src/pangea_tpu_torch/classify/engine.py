"""The classify step: reads -> probes -> table lookup -> per-read score.

Counterpart of ``pangea_tpu/classify/engine.py`` on one device, with the
q8, q12 and std table layouts, on a whole table or on one shard of a
sharded one (the sharded steps of ``dist/mesh.py`` run it on each
rank). A batch is an int8 [B, L] code tensor (pad =
4), or, with ``packed_len=L``, the native reader's packed wire rows int32
[B, ceil(L/16) + ceil(L/32)] (the CLI's fast path); mates are concatenated
at the probe level, mate 1 first (SEMANTICS.md §8), and ``nvalid`` counts
the valid windows over both mates. On CUDA tensors the step is K1 (or its
packed form) once a mate, then K2 (q8), K2's q12 form (q12) or K4 (std),
then K3 (K8 past 2,048 probes a read), whose launch lifts the LCA (K5)
when the taxonomy has more than 4,096 entries; on CPU tensors it is their
plain versions. A table past
the reference's deep-table gate (``kernels.lookup.takes_sorted``, with N =
B * R probes of the step) takes the sorted lookup instead: K9 sorts the
probes by bucket, then the sorted form of K2 or K4 probes them.

The multi-k step (the one-device counterpart of ``pangea_tpu/dist/mesh.py``
``make_multik_sharded_classify_fn``) classifies the same batch against
several indexes built on one taxonomy and folds their calls left to right
with the SEMANTICS.md §9 merge over the first index's taxonomy arrays: each
index after the first is scored with the running call as its prior, so
that on CUDA tensors its scorer's launch merges (K7).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import trace
from ..index import (ShardedIndex, pick_layout, shard_tables,
                     shard_tables_quot)
from ..index.container import EMPTY_HI
from ..index.quot import Q8_WAYS, Q12_WAYS
from ..index.shard import (QUOT_LAYOUTS, STASH_PAD, extract_pairs_tables,
                           pad_stash)
from ..kernels.lookup import (fuse_stash, fuse_table, lookup_q8,
                              lookup_q8_plain, lookup_q8_sorted,
                              lookup_q8_sorted_plain, lookup_q12,
                              lookup_q12_plain, lookup_q12_sorted,
                              lookup_q12_sorted_plain, lookup_std,
                              lookup_std_owned, lookup_std_plain,
                              lookup_std_sorted, lookup_std_sorted_plain,
                              record_rows, takes_sorted)
from ..kernels.minimize import (extract_probes, extract_probes_plain,
                                probe_width)
from ..kernels.score import (score_reads_taxon, score_reads_taxon_plain,
                             score_reads_tin, score_reads_tin_plain)
from . import relayout

# The taxonomy arrays the scorer reads (Taxonomy.device_arrays).
TAX_KEYS = ("tin", "tout", "depth", "parent", "up", "tin2node")
# (layout, sorted) -> (kernel wrapper, plain version) of the table probe.
LOOKUPS = {("q8", False): (lookup_q8, lookup_q8_plain),
           ("q8", True): (lookup_q8_sorted, lookup_q8_sorted_plain),
           ("q12", False): (lookup_q12, lookup_q12_plain),
           ("q12", True): (lookup_q12_sorted, lookup_q12_sorted_plain),
           ("std", False): (lookup_std, lookup_std_plain),
           ("std", True): (lookup_std_sorted, lookup_std_sorted_plain)}


@dataclass(frozen=True)
class ClassifyConfig:
    """Static classify parameters; the fields of the reference's
    ``ClassifyConfig``."""
    k: int
    n_shards: int = 1
    confidence_threshold: float = 0.0
    w: int = 1                      # minimizer window (SEMANTICS.md §3)
    ways: int = 16                  # bucket width
    n_sub: int = 1
    layout: str = "std"


@dataclass
class DeviceIndex:
    """One index on one device: fused int32 [NB, 2W] (q8), [NB, 128] (q12)
    or [NB, 4W | 6W] (std) rows, the stash int32 [5, S] and the taxonomy's
    arrays (int32 [T+1], ``up`` [levels, T+1], ``tin2node`` [max tin +
    2]). A std table's rows are in K4's record form (``record_rows``),
    which every placement lays out once; the constructor takes the rows as
    they are."""
    fused: torch.Tensor
    stash: torch.Tensor
    tax: dict
    cfg: ClassifyConfig

    @classmethod
    def from_index(cls, index, device, confidence_threshold: float = 0.0,
                   layout: str | None = None, n_shards: int = 1,
                   shard_id: int = 0, agree=None) -> "DeviceIndex":
        """Lay shard ``shard_id`` of an index split ``n_shards`` ways out as
        the device table :func:`~pangea_tpu_torch.index.pick_layout`
        chooses for it (q8, q12 or std; ``layout`` requests one, as the
        reference's ``layout=`` does) and place it on ``device``: the
        slice of the reference's [S, ...] tables that a rank of a mesh
        with S shards holds (``place_index``, ``dist/mesh.py:79``).

        ``index`` is an :class:`~pangea_tpu_torch.index.Index` or a
        :class:`~pangea_tpu_torch.index.ShardedIndex`. A sharded index of
        n_shards file shards is placed as the reference's streaming
        placements do (``mesh.py:124``, ``:228``): only shard
        ``shard_id``'s files are laid out, and a quotient layout's common
        bucket count, with any stash-overflow restart, is agreed by
        ``agree``, a function that returns the largest of the values all
        ranks pass (the mesh's all-reduce MAX; None when this one process
        places every shard, which then reads every shard's count). Any
        other index is laid out whole and sliced. The placement is timed
        (``trace.Placement``: its layout and its copies, each up to a
        synchronize).

        A whole index (one shard, not streamed) placed on a CUDA device is
        laid out there: its stored arrays are copied to the card as they
        are, and :func:`~.relayout.relayout` lays them out by the host's
        rule, to the same bytes. Every other placement lays the table out
        on the host and copies it. Either way a std table's rows are then
        put in the record form, where the table was laid out, inside
        ``place.layout``; the placement's record says so (``row_form``)."""
        device = torch.device(device)
        with trace.Placement(device) as place:
            if (device.type == "cuda" and n_shards == 1
                    and not _streams(index, n_shards)):
                return cls._laid_out_on(index, device, place,
                                        confidence_threshold, layout)
            with place.layout():
                tables, cfg = _host_tables(index, confidence_threshold,
                                           layout, n_shards, shard_id, agree)
                _records(tables["fused"], cfg, place)
            with place.copy():
                return cls._placed(tables["fused"], tables["stash"],
                                   tables["tax"], cfg, device)

    @classmethod
    def _laid_out_on(cls, index, device, place, confidence_threshold: float,
                     layout) -> "DeviceIndex":
        """:meth:`from_index` of a whole index on ``device``: the stored
        arrays and the taxonomy's copied there, then laid out there."""
        layout = _pick_layout(index, layout, 1)
        ways = {"q8": Q8_WAYS, "q12": Q12_WAYS}.get(layout, index.meta.ways)
        with place.copy():
            parts = relayout.upload(index, device)
            tax_d = _tax_tensors(index.taxonomy.device_arrays(), device)
        with place.layout("card"):
            out = relayout.relayout(parts, layout, index.meta.k, ways,
                                    tax_d["tin"], tax_d["tout"])
            if out is None:
                raise NotImplementedError(
                    f"the {layout} relayout is ineligible for this index")
            cfg = ClassifyConfig(k=index.meta.k,
                                 confidence_threshold=confidence_threshold,
                                 w=index.meta.w, ways=ways, layout=layout)
            _records(out[0], cfg, place)
        return cls(fused=out[0], stash=out[1], tax=tax_d, cfg=cfg)

    @classmethod
    def from_numpy_tables(cls, tables: dict, cfg, device,
                          shard_id: int = 0) -> "DeviceIndex":
        """Carry the reference's host tables over: ``tables`` is
        ``pangea_tpu`` ``DeviceIndex.from_index(idx, n_shards=S,
        layout=..., device_put=False).tables`` (or ``place_index``'s) for
        layout "q8", "q12" or "std" (numpy: fused uint32 [S, NB, lanes],
        stash uint32 [S, 5, S_max], the tax dict) and ``cfg`` its ``cfg``;
        the rank of shard ``shard_id`` takes that shard's slice. 2-D
        arrays are one shard's already. A std table's rows are put in the
        record form on a copy, on the host."""
        cfg = ClassifyConfig(**dataclasses.asdict(cfg))
        if cfg.layout not in ("q8", "q12", "std") or cfg.n_sub != 1:
            raise NotImplementedError(
                f"layout {cfg.layout!r} with {cfg.n_sub} sub-tables: the "
                "port runs one q8, q12 or std table a shard (n_sub > 1 is "
                "not ported, ROADMAP A7)")
        if not 0 <= shard_id < cfg.n_shards:
            raise ValueError(f"shard {shard_id} of {cfg.n_shards}")

        def mine(a):
            a = np.asarray(a)
            if a.ndim == 3:
                if a.shape[0] != cfg.n_shards:
                    raise ValueError(f"tables of {a.shape[0]} shards, cfg "
                                     f"says {cfg.n_shards}")
                a = a[shard_id]
            return a

        fused = mine(tables["fused"])
        if cfg.layout == "std":
            fused = record_rows(fused.copy(), cfg.ways)
        return cls._placed(fused, mine(tables["stash"]), tables["tax"], cfg,
                           device)

    @classmethod
    def _placed(cls, fused, stash, tax: dict, cfg, device) -> "DeviceIndex":
        """One shard's numpy rows, stash and taxonomy arrays copied to
        ``device`` as they are."""

        def lanes(a):
            return torch.from_numpy(
                np.ascontiguousarray(a).view(np.int32)).to(device)

        return cls(fused=lanes(fused), stash=lanes(stash),
                   tax=_tax_tensors(tax, device), cfg=cfg)

    @property
    def tables(self) -> dict:
        return {"fused": self.fused, "stash": self.stash, "tax": self.tax}

    @property
    def row_form(self) -> str | None:
        """"records" for a std table, whose rows every placement puts in
        K4's record form; None for q8 and q12, whose rows are the
        reference's."""
        return "records" if self.cfg.layout == "std" else None


def _records(fused, cfg: ClassifyConfig, place) -> None:
    """A std table's rows (numpy, or a tensor on any device) put in K4's
    record form in place (``record_rows``), the placement noting it; q8
    and q12 rows are left as they are."""
    if cfg.layout == "std":
        record_rows(fused, cfg.ways)
        place.row_form = "records"


def _tax_tensors(arrays: dict, device) -> dict:
    """The scorer's taxonomy arrays (``TAX_KEYS`` of ``arrays``) as int32
    tensors on ``device``."""
    return {name: torch.from_numpy(np.ascontiguousarray(
                arrays[name], dtype=np.int32)).to(device)
            for name in TAX_KEYS}


def _streams(index, n_shards: int) -> bool:
    """Whether a placement at n_shards streams the index: a sharded index
    whose file shards are the placement's shards."""
    return (isinstance(index, ShardedIndex)
            and index.meta.n_shards == n_shards)


def _pick_layout(index, layout, n_shards: int) -> str:
    """:func:`~pangea_tpu_torch.index.pick_layout` for an index placed at
    n_shards, ``layout`` the requested one (None: auto)."""
    return pick_layout(index.meta.n_kmers, n_shards, index.meta.k,
                       int(index.taxonomy.tout.max(initial=0)),
                       requested=layout or "auto")


def _host_tables(index, confidence_threshold: float, layout, n_shards: int,
                 shard_id: int, agree):
    """:meth:`DeviceIndex.from_index`'s host work: shard shard_id's table
    laid out, its stash and the taxonomy's arrays (numpy), and the
    config."""
    tax = index.taxonomy
    layout = _pick_layout(index, layout, n_shards)
    streaming = _streams(index, n_shards)
    if layout in ("q8", "q12"):
        ways = Q8_WAYS if layout == "q8" else Q12_WAYS
        if streaming:
            fused, stash3 = _stream_quot(index, shard_id, layout, ways,
                                         agree)
        else:
            out = shard_tables_quot(index, n_shards, ways, layout=layout)
            if out is None:
                raise NotImplementedError(
                    f"the {layout} relayout is ineligible for this index")
            fused, stash3 = out[0][shard_id], out[1][shard_id]
    elif streaming:
        fused, stash3 = _stream_std(index, shard_id)
        ways = index.meta.ways
    else:
        key_hi, key_lo, val, stash3 = (
            a[shard_id] for a in shard_tables(index, n_shards))
        fused = fuse_table(key_hi, key_lo, val, tax.tin, tax.tout)
        ways = key_hi.shape[-1]
    cfg = ClassifyConfig(k=index.meta.k, n_shards=n_shards,
                         confidence_threshold=confidence_threshold,
                         w=index.meta.w, ways=ways, layout=layout)
    tables = {"fused": fused,
              "stash": fuse_stash(stash3, tax.tin, tax.tout),
              "tax": tax.device_arrays()}
    return tables, cfg


def _stream_std(sidx, shard_id: int):
    """The reference's ``_place_sharded_streaming`` for one rank: file
    shard shard_id fused (a smaller shard repeated to the largest's bucket
    count) and its stash padded to the widest, from the metadata alone.
    Returns (fused uint32 [NB_max, 4W | 6W], stash uint32 [3, S_max])."""
    meta, tax = sidx.meta, sidx.taxonomy
    khi, klo, val, st = sidx.open_shard(shard_id)
    fused = fuse_table(khi, klo, val, tax.tin, tax.tout)
    reps = max(meta.shard_buckets) // fused.shape[0]
    if reps > 1:
        fused = np.tile(fused, (reps, 1))
    return fused, pad_stash(np.asarray(st), max(max(meta.shard_stash), 1))


def _stream_quot(sidx, shard_id: int, layout: str, ways: int, agree):
    """The reference's ``_place_sharded_streaming_quot`` for one rank: the
    largest shard's key count sets one bucket count for all shards, file
    shard shard_id is laid out at it, and a shard whose stash overflows
    makes every shard restart at its bigger count. With ``agree`` (the
    all-reduce MAX over every rank) a rank reads only its own shard;
    without it this process reads them all. Returns (fused uint32 [NB, RL],
    stash uint32 [3, STASH_PAD])."""
    layout_fn, nb_fn = QUOT_LAYOUTS[layout]
    meta, tax = sidx.meta, sidx.taxonomy
    mine = [shard_id] if agree else range(meta.n_shards)
    agree = agree or (lambda v: v)

    def n_keys(s):
        khi, _, _, st = sidx.open_shard(s)
        n = int((khi != EMPTY_HI).sum())
        return n + int((st[0] != EMPTY_HI).sum()) if st.shape[1] else n

    nb = nb_fn(agree(max(n_keys(s) for s in mine)), meta.k, ways)
    if nb is None:
        raise NotImplementedError(f"the {layout} relayout is ineligible "
                                  "for this index")
    while True:                                   # restart at a bigger nb
        grew, keep = nb, None
        for s in mine:
            canon, taxa = extract_pairs_tables(*sidx.open_shard(s))
            fused, st3, nb_s = layout_fn(canon, taxa, tax.tin, tax.tout,
                                         meta.k, ways=ways, min_nb=nb)
            if nb_s > nb:
                grew = nb_s
                break
            if s == shard_id:
                keep = (fused, pad_stash(st3, STASH_PAD))
        grew = agree(grew)
        if grew == nb:
            return keep
        nb = grew


def _extract_probes(bases, mate_bases, cfg: ClassifyConfig, plain: bool,
                    packed_len: int = 0):
    """[B, L] codes, or packed wire rows of packed_len bases (and mates) ->
    (hi int32, lo int32, valid bool) [B, R], mate 1's probes in the first
    columns."""
    parts = [bases] if mate_bases is None else [bases, mate_bases]
    widths = [probe_width(packed_len or p.shape[1], cfg.k, cfg.w)
              for p in parts]
    B = bases.shape[0]
    R = sum(widths)
    hi = torch.empty((B, R), dtype=torch.int32, device=bases.device)
    lo = torch.empty_like(hi)
    valid = torch.empty((B, R), dtype=torch.bool, device=bases.device)
    fn = extract_probes_plain if plain else extract_probes
    col = 0
    for part, nw in zip(parts, widths):
        fn(part, cfg.k, cfg.w, (hi, lo, valid), col, packed_len=packed_len)
        col += nw
    return hi, lo, valid


def probe_tables(tables: dict, hi, lo, valid, cfg: ClassifyConfig,
                 shard_id: int = 0, plain: bool = False):
    """The probes (hi, lo, valid), any shape, on one shard's table: (hit or
    taxon, t_in, t_out) int32 like hi, by the layout's lookup, unsorted or
    past the deep-table gate sorted (the reference's ``_probe_tables``).
    A std table of cfg.n_shards > 1 shards masks the probes shard_id does
    not own; the quotient layouts need no mask. Inside a multi-k step's
    ``step.index<i>`` span the index's totals count the lookup."""
    fused = tables["fused"]
    srt = takes_sorted(cfg.layout, hi.numel(), fused)
    if trace.open_index is not None:
        trace.lookup_taken(hi.numel(), srt)
    kernel, plain_fn = LOOKUPS[cfg.layout, srt]
    fn = plain_fn if plain else kernel
    args = {"q8": (cfg.k,), "q12": (cfg.k, cfg.ways),
            "std": (cfg.ways,)}[cfg.layout]
    kw = {}
    if cfg.layout == "std" and cfg.n_shards > 1:
        kw = {"owner": (cfg.n_shards, shard_id)}
        if not srt and not plain:
            fn = lookup_std_owned
    return fn(hi, lo, valid, fused, tables["stash"], *args, **kw)


def score_hits(hits, valid, tax: dict, cfg: ClassifyConfig,
               plain: bool = False, prior=None) -> dict:
    """The per-read score of the hits (hits, valid [B, R]): dict(taxon,
    best, nvalid) int32 [B], merged with ``prior`` where given (the
    scorers' ``prior``: an earlier call and its merge's taxonomy
    arrays)."""
    if cfg.layout == "std":
        score = score_reads_taxon_plain if plain else score_reads_taxon
    else:
        score = score_reads_tin_plain if plain else score_reads_tin
    taxon, best, nvalid = score(*hits, valid, tax, cfg.confidence_threshold,
                                prior)
    return {"taxon": taxon, "best": best, "nvalid": nvalid}


def classify_reads(tables: dict, bases, cfg: ClassifyConfig, *,
                   mate_bases=None, packed_len: int = 0,
                   plain: bool = False, shard_id: int = 0,
                   merge_hits=None, prior=None) -> dict:
    """The read -> assignment step. tables: :attr:`DeviceIndex.tables`;
    packed_len=L: the inputs are packed wire rows of L bases. plain=True
    runs the plain PyTorch versions on any device (the reference the
    kernels are held to). On one shard of a sharded table, shard_id names
    it and merge_hits, applied to the hits triple before scoring, merges
    the shards' hits (the sharded steps' all-reduce). prior: None, or
    (call, merge_tax), an earlier call dict(taxon, best, nvalid) int32 [B]
    that this one merges with (SEMANTICS.md §9, the earlier call as res1)
    over the taxonomy arrays merge_tax. Returns dict(taxon, best, nvalid)
    int32 [B]."""
    with trace.span("step.extract"):
        hi, lo, valid = _extract_probes(bases, mate_bases, cfg, plain,
                                        packed_len)
    with trace.span("step.probe"):
        hits = probe_tables(tables, hi, lo, valid, cfg, shard_id, plain)
    if merge_hits is not None:
        hits = merge_hits(hits)
    with trace.span("step.score"):
        return score_hits(hits, valid, tables["tax"], cfg, plain, prior)


def fold_multik(tables_tuple, cfgs, classify_one) -> dict:
    """The multi-k fold (SEMANTICS.md §9): ``classify_one(tables, cfg,
    prior)`` of the batch against each index in order, each after the
    first with the running call and the first index's taxonomy arrays as
    its prior, so that its scorer merges. Index i's part is its
    ``step.index<i>`` span (``trace.IndexSpan``), which totals its calls
    and host time, and its lookup's probes and path. Returns the last
    call."""
    res = None
    for i, (tables, cfg) in enumerate(zip(tables_tuple, cfgs, strict=True)):
        with trace.IndexSpan(i, cfg.k, cfg.w, cfg.layout):
            res = classify_one(
                tables, cfg,
                None if res is None else (res, tables_tuple[0]["tax"]))
    return res


class Classifier(nn.Module):
    """The classify step as a module over one :class:`DeviceIndex`; the
    tables are buffers, so they live on the index's device."""

    def __init__(self, index: DeviceIndex):
        super().__init__()
        self.cfg = index.cfg
        self.register_buffer("fused", index.fused, persistent=False)
        self.register_buffer("stash", index.stash, persistent=False)
        for name in TAX_KEYS:
            self.register_buffer(name, index.tax[name], persistent=False)

    @property
    def index(self) -> DeviceIndex:
        """The index over the module's buffers, wherever they now live."""
        return DeviceIndex(fused=self.fused, stash=self.stash,
                           tax={name: getattr(self, name)
                                for name in TAX_KEYS},
                           cfg=self.cfg)

    def forward(self, bases, mate_bases=None, packed_len: int = 0) -> dict:
        """bases (and mate_bases) int8 [B, L] codes, or packed wire rows of
        packed_len bases, on the index's device -> {"taxon", "best",
        "nvalid"} int32 [B]."""
        return classify_reads(self.index.tables, bases, self.cfg,
                              mate_bases=mate_bases, packed_len=packed_len)


def make_classify_fn(cfg: ClassifyConfig, paired: bool = False,
                     packed_len: int = 0):
    """fn(tables, bases[, mate_bases]) -> dict(taxon, best, nvalid), with
    tables = :attr:`DeviceIndex.tables`; packed_len=L takes packed wire
    rows of L bases."""

    def fn(tables, bases, mate_bases=None):
        return classify_reads(tables, bases, cfg, mate_bases=mate_bases,
                              packed_len=packed_len)

    if paired:
        return fn
    return lambda tables, bases: fn(tables, bases)


def classify_multik(tables_tuple, bases, cfgs, *, mate_bases=None,
                    packed_len: int = 0, plain: bool = False) -> dict:
    """The multi-k step: :func:`classify_reads` of the same batch against
    each index in order (``tables_tuple`` holds each
    :attr:`DeviceIndex.tables`, ``cfgs`` each config), folded left to right
    by the merge over the first index's taxonomy arrays: each later
    index's call merges with the running one in its scorer (``prior``).
    plain=True runs the plain versions throughout. Returns dict(taxon,
    best, nvalid) int32 [B]."""
    return fold_multik(
        tables_tuple, cfgs,
        lambda tables, cfg, prior: classify_reads(
            tables, bases, cfg, mate_bases=mate_bases, packed_len=packed_len,
            plain=plain, prior=prior))


class MultiKClassifier(nn.Module):
    """The multi-k step as a module: one :class:`Classifier` for each index,
    in the given order. The indexes share one taxonomy, whose buffers the
    classifiers hold in common (the first index's)."""

    def __init__(self, indexes):
        super().__init__()
        if not indexes:
            raise ValueError("the multi-k step needs at least one index")
        tax = indexes[0].tax
        self.classifiers = nn.ModuleList(
            Classifier(dataclasses.replace(di, tax=tax)) for di in indexes)

    def forward(self, bases, mate_bases=None, packed_len: int = 0) -> dict:
        """bases (and mate_bases) int8 [B, L] codes, or packed wire rows of
        packed_len bases, on the indexes' device -> the merged {"taxon",
        "best", "nvalid"} int32 [B]."""
        return classify_multik(
            tuple(c.index.tables for c in self.classifiers), bases,
            tuple(c.cfg for c in self.classifiers), mate_bases=mate_bases,
            packed_len=packed_len)


def make_multik_classify_fn(cfgs, paired: bool = False,
                            packed_len: int = 0):
    """fn(tables_tuple, bases[, mate_bases]) -> dict(taxon, best, nvalid):
    the one-device counterpart of the reference's
    ``make_multik_sharded_classify_fn``; tables_tuple holds each
    :attr:`DeviceIndex.tables` in index order; packed_len=L takes packed
    wire rows of L bases."""
    cfgs = tuple(cfgs)

    def fn(tables_tuple, bases, mate_bases=None):
        return classify_multik(tables_tuple, bases, cfgs,
                               mate_bases=mate_bases, packed_len=packed_len)

    if paired:
        return fn
    return lambda tables_tuple, bases: fn(tables_tuple, bases)


def pad_batch(seqs, batch: int, length: int) -> np.ndarray:
    """Host-side: list of uint8 code arrays -> int8 [batch, length]
    (pad = 4). Reads longer than `length` are truncated."""
    out = np.full((batch, length), 4, dtype=np.int8)
    for i, s in enumerate(seqs[:batch]):
        n = min(len(s), length)
        out[i, :n] = s[:n].astype(np.int8)
    return out
