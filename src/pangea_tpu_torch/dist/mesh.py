"""The sharded classify steps over torch.distributed.

Counterpart of ``pangea_tpu/dist/mesh.py`` in torch idiom: one process a
rank and one device a rank. A mesh is a grid of ranks [n_data, n_shard]:
rank r sits in row r // n_shard (its data index) and column r % n_shard
(its shard index).

- Along a row (the shard axis, the reference's ``"shard"``) the index is
  hash-sharded by the owner rule: each rank of the row holds one shard.
- Along a column (the data axis) the batch rows are split: each row of
  ranks classifies its own rows, and the outputs are gathered over the
  column when every rank needs them.

Each rank keeps two process groups, its row's (``shard_group``) and its
column's (``data_group``). The collectives are those XLA ran inside the
reference's shard_map: the broadcast step merges the shards' disjoint hits
with one all-reduce SUM over the row (``psum``); the routed step moves
probes to their owners and answers back with two all_to_alls over the row;
the outputs gather with an all_gather. NCCL carries them between ranks
with a card each and gloo on the CPU; gloo takes CUDA tensors for every
collective used here, so ranks that share one card run over gloo with
their tensors on the card (PERF.md). Without an initialized process group
the mesh is (1, 1) and runs no collective.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import trace
from ..classify.engine import (_extract_probes, classify_reads,
                               fold_multik, probe_tables, score_hits)
from ..kernels.route import (route_bin, route_bin_plain, route_capacity,
                             route_restore, route_restore_plain)

OUT_KEYS = ("taxon", "best", "nvalid")
# A rank that waits this long in a collective (a peer died or took another
# branch) fails instead of hanging the run.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


@dataclass(frozen=True)
class MeshConfig:
    n_data: int
    n_shard: int

    @property
    def size(self) -> int:
        return self.n_data * self.n_shard


def choose_mesh(n_devices: int, index_bytes: int,
                per_device_hbm_budget: int = 12 << 30) -> MeshConfig:
    """The placement policy: replicate when the index fits the per-device
    budget, else the smallest power-of-two shard axis that makes each shard
    fit; the remaining devices go data-parallel. n_devices is the world
    size."""
    n_shard = 1
    while (n_shard < n_devices
           and index_bytes // n_shard > per_device_hbm_budget):
        n_shard *= 2
    return MeshConfig(n_data=n_devices // n_shard, n_shard=n_shard)


def init_method(coordinator: str) -> str:
    """The rendezvous URL of a coordinator: ``host:port`` as the reference
    names it (TCP), or a ``tcp://`` or ``file://`` URL as it stands."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str = "gloo") -> bool:
    """Join the process group of num_processes ranks as rank process_id
    (-1 or None: the launcher's ``RANK``), through the coordinator's
    rendezvous, over ``backend`` ("nccl" for CUDA ranks with a card each,
    "gloo" otherwise). A collective that waits past COLLECTIVE_TIMEOUT
    fails. No-op for one process or a group already joined; returns whether
    it joined."""
    if not num_processes or num_processes <= 1 or dist.is_initialized():
        return False
    if not coordinator:
        raise ValueError("dist.coordinator must name the rendezvous")
    rank = process_id if process_id is not None and process_id >= 0 \
        else int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method(coordinator),
                            world_size=num_processes, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    return True


class Mesh:
    """This rank's place in a grid of ranks [n_data, n_shard], its device
    and the process groups of its row and column. The mesh must cover the
    whole world."""

    def __init__(self, cfg: MeshConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.distributed = dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        if cfg.size != world:
            raise ValueError(f"mesh {cfg.n_data} x {cfg.n_shard} for a world "
                             f"of {world} ranks")
        self.rank = dist.get_rank() if self.distributed else 0
        self.data_index, self.shard_index = divmod(self.rank, cfg.n_shard)
        self.shard_group = self.data_group = None
        if self.distributed:
            # Every rank creates every group, in one order.
            for d in range(cfg.n_data):
                g = self._group(range(d * cfg.n_shard, (d + 1) * cfg.n_shard))
                if d == self.data_index:
                    self.shard_group = g
            for s in range(cfg.n_shard):
                g = self._group(range(s, world, cfg.n_shard))
                if s == self.shard_index:
                    self.data_group = g

    def _group(self, ranks):
        ranks = list(ranks)
        return dist.group.WORLD if len(ranks) == self.cfg.size \
            else dist.new_group(ranks)

    def __repr__(self) -> str:
        return (f"Mesh({self.cfg.n_data} x {self.cfg.n_shard}, rank "
                f"{self.rank} at ({self.data_index}, {self.shard_index}) on "
                f"{self.device})")

    def allreduce_max(self, value: int) -> int:
        """The largest value any rank of the world passes (the reference's
        ``_allreduce_max_int``): so that every rank takes the same branch."""
        if not self.distributed:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def gather_rows(self, out: dict, group, n: int) -> dict:
        """The [b] outputs of the n ranks of a group, concatenated in group
        rank order: dict of int32 [n * b]."""
        x = torch.stack([out[k] for k in OUT_KEYS])          # [3, b]
        y = torch.empty((n * 3, x.shape[1]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(y, x, group=group)
        y = y.view(n, 3, -1).transpose(0, 1).reshape(3, -1)
        return dict(zip(OUT_KEYS, y.unbind(0)))


def place_index(index, mesh: Mesh, confidence_threshold: float = 0.0,
                layout: str | None = None):
    """This rank's part of an index on a mesh: the shard of its column,
    on its device (the reference's ``place_index``). An
    :class:`~pangea_tpu_torch.index.ShardedIndex` of n_shard file shards
    streams: the rank reads only its own shard's files, and the ranks
    agree on a quotient layout's bucket count by an all-reduce."""
    from ..classify.engine import DeviceIndex
    return DeviceIndex.from_index(
        index, mesh.device, confidence_threshold, layout,
        n_shards=mesh.cfg.n_shard, shard_id=mesh.shard_index,
        agree=mesh.allreduce_max if mesh.distributed else None)


def _merge_over_row(mesh: Mesh):
    """The broadcast step's merge: one all-reduce SUM of the int32 hits
    triple over the row (the shards' hits have disjoint support)."""
    if not mesh.distributed:
        return None

    def merge(hits):
        with trace.span("step.merge"):
            h = torch.stack(hits)
            dist.all_reduce(h, group=mesh.shard_group)
            return tuple(h.unbind(0))
    return merge


def _local_classify_broadcast(tables, bases, mate_bases, cfg, mesh: Mesh,
                              packed_len: int, plain: bool = False,
                              prior=None) -> dict:
    """The broadcast step on one rank (``mesh.py:347``): its row's reads
    probed against its shard, the hits merged over the row, then scored,
    and merged with ``prior`` where given (classify_reads' prior). Returns
    dict of int32 [B] for the row's B reads."""
    return classify_reads(tables, bases, cfg, mate_bases=mate_bases,
                          packed_len=packed_len, plain=plain,
                          shard_id=mesh.shard_index,
                          merge_hits=_merge_over_row(mesh), prior=prior)


def _local_classify_routed(tables, bases, mate_bases, cfg, mesh: Mesh,
                           packed_len: int, plain: bool = False,
                           cap_frac: float = 1.25) -> dict:
    """The routed step on one rank (``mesh.py:371``, B14). The row's B
    reads split S ways: rank s of the row takes reads [s B/S, (s+1) B/S),
    bins their probes by owner (K10) into C = ceil(N/S * cap_frac + 0.5)
    slots an owner, and sends each bin to its owner by one all_to_all. The
    owner probes what it receives with classify_reads' layout dispatch, the
    answers come back by a second all_to_all, K9's restore puts them in
    probe order, and the slice is scored; one all_gather over the row
    gives every rank the B outputs. Each probe is answered once, by its
    owner. If any bin of the row overflows (the flag agreed by an
    all-reduce MAX before the branch, so that all ranks take it) the row
    runs the broadcast step instead. Either way the outputs equal the
    broadcast step's."""
    S = cfg.n_shards
    B = bases.shape[0]
    if B % S:
        raise ValueError(f"{B} reads do not split over {S} shards")
    b = B // S
    rows = slice(mesh.shard_index * b, (mesh.shard_index + 1) * b)
    hi, lo, valid = _extract_probes(
        bases[rows], None if mate_bases is None else mate_bases[rows], cfg,
        plain, packed_len)
    cap = route_capacity(hi.numel(), S, cap_frac)
    records, inv, counts = (route_bin_plain if plain else route_bin)(
        hi, lo, valid, S, max(cap, 1))
    over = (counts.max() > cap).to(torch.int32).reshape(1)
    dist.all_reduce(over, op=dist.ReduceOp.MAX, group=mesh.shard_group)
    if over.item():
        return _local_classify_broadcast(tables, bases, mate_bases, cfg, mesh,
                                         packed_len, plain)
    recv = torch.empty_like(records)
    dist.all_to_all_single(recv, records, group=mesh.shard_group)
    hits = probe_tables(tables, recv[:, 1].contiguous(),
                        recv[:, 2].contiguous(), recv[:, 3] != 0, cfg,
                        mesh.shard_index, plain)
    answers = torch.stack([*hits, torch.zeros_like(hits[0])], dim=1)
    back = torch.empty_like(answers)
    dist.all_to_all_single(back, answers, group=mesh.shard_group)
    restore = route_restore_plain if plain else route_restore
    hits = tuple(h.reshape(hi.shape) for h in restore(inv, back))
    out = score_hits(hits, valid, tables["tax"], cfg, plain)
    return mesh.gather_rows(out, mesh.shard_group, S)


def _replicate_over_data(out: dict, mesh: Mesh) -> dict:
    """The column's outputs on every rank (``mesh.py:464``): all rows'
    reads, in data order."""
    return mesh.gather_rows(out, mesh.data_group, mesh.cfg.n_data)


def make_sharded_classify_fn(cfg, mesh: Mesh, paired: bool = False,
                             packed_len: int = 0,
                             replicate_out: bool = False,
                             routing: str = "broadcast"):
    """The sharded classify step (``mesh.py:530``): fn(tables, bases[,
    mate_bases]) on this rank's table (:attr:`DeviceIndex.tables`) and its
    row's reads (int8 [B, L] codes, or packed wire rows of packed_len
    bases) -> dict(taxon, best, nvalid) int32 [B]; with replicate_out, all
    the rows' reads [n_data * B]. routing "broadcast" or "alltoall" (the
    routed step, where the index has more than one shard);
    ``PANGEA_ROUTE`` overrides it."""
    routing = os.environ.get("PANGEA_ROUTE", routing)
    if routing not in ("broadcast", "alltoall"):
        raise ValueError(f"unknown routing {routing!r}")
    if cfg.n_shards != mesh.cfg.n_shard:
        raise ValueError(f"a table of {cfg.n_shards} shards on a mesh of "
                         f"{mesh.cfg.n_shard}")
    routed = routing == "alltoall" and cfg.n_shards > 1

    def fn(tables, bases, mate_bases=None):
        local = _local_classify_routed if routed \
            else _local_classify_broadcast
        out = local(tables, bases, mate_bases, cfg, mesh, packed_len)
        return _replicate_over_data(out, mesh) if replicate_out else out

    return fn if paired else (lambda tables, bases: fn(tables, bases))


def make_multik_sharded_classify_fn(cfgs, mesh: Mesh, paired: bool = False,
                                    packed_len: int = 0,
                                    replicate_out: bool = False):
    """The multi-k sharded step (``mesh.py:484``): the broadcast step of
    the same reads against each index, merged per read left to right
    (SEMANTICS.md §9) over the first index's taxonomy arrays, each later
    index's call in its scorer (K7 on the card), each index's part in its
    ``step.index<i>`` span (``fold_multik``). fn(tables_tuple, bases[,
    mate_bases]) as make_sharded_classify_fn's fn, with each index's tables
    in order."""
    cfgs = tuple(cfgs)

    def fn(tables_tuple, bases, mate_bases=None):
        res = fold_multik(
            tables_tuple, cfgs,
            lambda tables, cfg, prior: _local_classify_broadcast(
                tables, bases, mate_bases, cfg, mesh, packed_len,
                prior=prior))
        return _replicate_over_data(res, mesh) if replicate_out else res

    return fn if paired else (lambda tables_tuple, bases: fn(tables_tuple,
                                                             bases))


class MeshStep:
    """The driver's step on a mesh: a batch's reads in, every read's
    outputs out, on every rank. The n reads are padded to a multiple of
    the mesh's size (with N bases, whose probes are all invalid); data row
    d takes its share of the rows, the sharded step (one index, routed or
    broadcast) or the multi-k sharded step runs, and the outputs gather
    over the column when the world has more than one rank. Each call is a
    ``step`` span (``trace.py``)."""

    def __init__(self, indexes, mesh: Mesh, routing: str = "broadcast"):
        self.tables = tuple(di.tables for di in indexes)
        self.cfgs = tuple(di.cfg for di in indexes)
        self.mesh = mesh
        self.routing = routing
        self._fns: dict = {}

    def _fn(self, paired: bool, packed_len: int):
        key = (paired, packed_len)
        if key not in self._fns:
            rep = self.mesh.distributed
            if len(self.cfgs) > 1:
                fn = make_multik_sharded_classify_fn(
                    self.cfgs, self.mesh, True, packed_len, rep)
                self._fns[key] = lambda b, m: fn(self.tables, b, m)
            else:
                fn = make_sharded_classify_fn(self.cfgs[0], self.mesh, True,
                                              packed_len, rep, self.routing)
                self._fns[key] = lambda b, m: fn(self.tables[0], b, m)
        return self._fns[key]

    def __call__(self, bases, mate_bases=None, packed_len: int = 0) -> dict:
        with trace.span(trace.STEP):
            m = self.mesh
            n = bases.shape[0]
            per = -(-n // m.cfg.size) * m.cfg.n_shard   # rows a data row takes
            rows = slice(m.data_index * per, (m.data_index + 1) * per)
            fill = -1 if packed_len else 4              # N bases, either form

            def mine(x):
                if x is None:
                    return None
                pad = per * m.cfg.n_data - n
                if pad:
                    x = torch.cat([x, x.new_full((pad, x.shape[1]), fill)])
                return x[rows]

            out = self._fn(mate_bases is not None, packed_len)(
                mine(bases), mine(mate_bases))
            return {k: v[:n] for k, v in out.items()}
