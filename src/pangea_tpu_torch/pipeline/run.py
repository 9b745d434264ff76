"""The offline index build and the streaming classify run.

``run_build`` is the reference's: the genomes of reference FASTAs (the
taxon from a ``taxid=N`` header key or a seqid-to-taxid map) -> canonical
k-mers -> LCA merge -> table -> the index directory, or with ``ooc_shards``
> 0 the out-of-core builder's sharded container, byte-equal to the
reference's on the same inputs.

The classify run is the counterpart of ``pangea_tpu/pipeline/run.py``
``run_classify``, for one or more indexes (q8, q12 or std layout each)
built on one taxonomy, on one device or on a mesh of ranks (one process a
rank, ``dist/mesh.py``): each batch runs one sharded step (several indexes
merge on the device, SEMANTICS.md §9; one index may route its probes to
their owners with ``mesh.routing=alltoall``), and rank 0 writes
``{sample}.assign.tsv``, ``{sample}.summary.tsv`` (plus
``cohort.summary.tsv`` for several samples) and ``stats.json`` exactly as
the reference does. Like ``run_classify`` (its lines 729-734), it takes one
of two loops:

- the fast path, the default: the native reader (``io/native.py``) packs
  each read into wire rows on a producer thread (prefetch depth 2), the
  main thread copies each batch to the device once (the mates as column
  slices of one array) and launches the step with ``packed_len=L``, so K1
  decodes the rows itself, and a drain thread brings the outputs back,
  writes the lines with the native writer and keeps per-taxon counts for
  the summaries. Reads longer than ``input.max_read_len`` are cut to it,
  counted in ``truncated_reads`` and warned about. An error in either
  thread is raised in the main thread.
- the general path, when ``input.long_reads`` is true or
  ``PANGEA_NO_NATIVE`` is set: ``io.fastx.read_batches`` parses in Python
  and keeps whole reads; reads of up to L bases run as one [n, L] batch,
  longer ones exactly, in power-of-two length buckets L * 2^j up to
  max(``input.max_long_read_len``, L), max(64, B * L // Lj) reads a launch
  (reads past that cap are cut to it, counted and warned about), and the
  outputs go back to input order.

Options the port does not run yet raise NotImplementedError naming their
ROADMAP item. The returned metrics carry ``fast_path``,
``truncated_reads`` and ``host_sec``, the host time by phase: on the
general path, of its one loop: ``parse`` (FASTQ records to code arrays),
``pad`` (bucketing and the padded batches), ``step`` (host-to-device
copies, the steps and the copies back, which wait for the device) and
``write`` (assignment lines); on the fast path, of its three threads,
which overlap: ``parse`` (the native reader), ``step`` (the copy to the
device and the launches), ``fetch`` (the copy back, which waits for the
device) and ``write`` (the native writer and the counts).
"""
from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..classify.engine import pad_batch
from ..config import RunConfig, dump_config
from ..dist.mesh import (OUT_KEYS, Mesh, MeshConfig, MeshStep, choose_mesh,
                         initialize_multihost, place_index)
from ..index import build_index, build_index_ooc, load_index_any
from ..io import native
from ..io.fastx import FastxReader, read_batches
from ..io.native import (NativeFastxReader, TaxBlobs,
                         write_assignments_native)
from ..kernels import kernel_launches
from ..kernels.encode import wire_width
from ..report import stats as report_stats
from ..report.writers import (AssignmentRecord, format_assignment,
                              write_cohort_summary_counts,
                              write_summary_counts)
from ..taxonomy import Taxonomy

LONG_BUCKET_ROWS = 64        # the least reads a long-read launch holds
DRAIN_DEPTH = 4              # launched batches that may await the drain
_END = object()


def default_sample_names(files) -> list:
    """Per-file sample names from basenames, de-collided deterministically:
    identical basenames get _2, _3, ... suffixes in input order."""
    seen: dict = {}
    out = []
    for f in files:
        base = os.path.basename(f).split(".")[0]
        k = seen.get(base, 0) + 1
        seen[base] = k
        out.append(base if k == 1 else f"{base}_{k}")
    return out


def load_taxonomy_any(path: str, names_dmp: str | None = None) -> Taxonomy:
    """A taxonomy from NCBI's nodes.dmp (with names_dmp), an .npz or a
    TSV."""
    if names_dmp:
        return Taxonomy.load_ncbi(path, names_dmp)
    if path.endswith(".npz"):
        return Taxonomy.load(path)
    return Taxonomy.load_tsv(path)


def _genomes_from_fasta(paths, taxonomy: Taxonomy, taxid_map: dict | None):
    """Yield (codes, dense taxon) from reference FASTAs. The taxon comes
    from the seqid-to-taxid map or a ``taxid=N`` key in the header; raw
    NCBI ids are translated when the taxonomy carries ``raw_to_dense``."""
    raw_to_dense = getattr(taxonomy, "raw_to_dense", None)
    for path in paths:
        for rid, codes, _ in FastxReader(path):
            taxid = None
            if taxid_map and rid in taxid_map:
                taxid = int(taxid_map[rid])
            elif "taxid=" in rid:
                taxid = int(rid.split("taxid=")[1].split("|")[0].split()[0])
            if taxid is None:
                raise ValueError(f"{path}: no taxid for sequence {rid!r} "
                                 "(use header 'taxid=N' or --taxid-map)")
            if raw_to_dense is not None:
                taxid = raw_to_dense[taxid]
            yield codes, taxid


def run_build(refs: list[str], taxonomy_path: str, k: int, out: str,
              w: int = 1, names_dmp: str | None = None,
              taxid_map_path: str | None = None,
              load_factor: float = 0.5, ways: int = 16,
              ooc_shards: int = 0, parts_per_shard: int = 8,
              spill_dir: str | None = None):
    """Build an index from reference FASTAs into the directory ``out``, as
    the reference's ``run_build`` does: in memory, or with ooc_shards = S >
    0 out of core into a sharded container of S shards (parts_per_shard
    spill partitions a shard, in spill_dir or a temporary directory).
    Returns the Index or ShardedIndex."""
    tax = load_taxonomy_any(taxonomy_path, names_dmp)
    taxid_map = None
    if taxid_map_path:
        taxid_map = {}
        with open(taxid_map_path) as fh:
            for line in fh:
                a, b = line.split()[:2]
                taxid_map[a] = int(b)
    t0 = time.time()
    genomes = _genomes_from_fasta(refs, tax, taxid_map)
    if ooc_shards:
        idx = build_index_ooc(
            genomes, tax, k=k, out=out, w=w, n_shards=ooc_shards,
            parts_per_shard=parts_per_shard, load_factor=load_factor,
            spill_dir=spill_dir, ways=ways,
            progress=lambda m: print(f"[build] {m}", file=sys.stderr))
    else:
        idx = build_index(genomes, tax, k=k, w=w, load_factor=load_factor,
                          ways=ways, progress=lambda n: print(
                              f"[build] {n} genomes scanned",
                              file=sys.stderr))
        idx.save(out)
    print(f"[build] {idx} in {time.time() - t0:.1f}s -> {out}",
          file=sys.stderr)
    return idx


def _check_supported(c: RunConfig) -> None:
    if c.trim.min_qual > 0 or c.trim.min_len or c.trim.max_len \
            or c.demux.barcodes:
        raise NotImplementedError(
            "trim and demux are not ported yet (ROADMAP A3)")
    if c.classify.resume:
        raise NotImplementedError("--resume is not ported yet (ROADMAP A3)")


def bucket_batch(seqs, mate_seqs, B: int, L: int, max_long: int):
    """The launches of one general-path batch, as the reference's
    ``launch_bucketed`` forms them: [(reads, codes int8 [len(reads), Lj],
    mate codes or None)], reads an index array into the batch, and the
    count of reads (pairs) past max_long, which are cut to it. Reads whose
    longer mate has at most L bases make one launch at Lj = L; each longer
    read goes to the bucket Lj = min(L * 2^ceil(log2(len / L)), max_long),
    max(64, B * L // Lj) reads a launch. Each launch holds only its reads'
    rows (the reference pads every launch of a bucket to its full rows)."""
    n = len(seqs)
    lens = np.fromiter(map(len, seqs), np.int64, n)
    if mate_seqs is not None:
        lens = np.maximum(lens, np.fromiter(map(len, mate_seqs), np.int64,
                                            n))
    groups = []
    short = np.flatnonzero(lens <= L)
    if short.size:
        groups.append((short, L))
    longs = np.flatnonzero(lens > L)
    cut = int((lens[longs] > max_long).sum())
    bl = np.minimum(
        L * (1 << np.ceil(np.log2(lens[longs] / L)).astype(np.int64)),
        max_long)
    for Lj in np.unique(bl):
        idxs = longs[bl == Lj]
        rows = max(LONG_BUCKET_ROWS, (B * L) // int(Lj))
        groups += [(idxs[o:o + rows], int(Lj))
                   for o in range(0, idxs.size, rows)]

    def pad(src, sub, Lj):
        return pad_batch([src[i] for i in sub], sub.size, Lj)

    return [(sub, pad(seqs, sub, Lj),
             None if mate_seqs is None else pad(mate_seqs, sub, Lj))
            for sub, Lj in groups], cut


def _prefetch(gen, maxsize: int = 2):
    """Run ``gen`` on a background thread, up to ``maxsize`` items ahead;
    its error is raised here."""
    q: queue.Queue = queue.Queue(maxsize=maxsize)

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 (raised by the consumer)
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _tally(state: dict, sample: str, n: int, taxon: np.ndarray,
           T1: int) -> None:
    """Add one batch's outputs to the run's totals and per-taxon counts."""
    c = np.bincount(taxon, minlength=T1)
    counts = state["counts"]
    counts[sample] = c if sample not in counts else counts[sample] + c
    t = state["totals"]
    t["reads"] += n
    t["classified"] += int((taxon != 0).sum())
    t["batches"] += 1
    if state["write"]:
        print(f"[classify] batch {t['batches']}: {n} reads ({t['reads']} "
              "total)", file=sys.stderr)


def _run_general(cfg: RunConfig, model, tax, device, inputs,
                 state: dict) -> None:
    out_dir = cfg.classify.out_dir
    B, L = state["batch"], cfg.input.max_read_len
    max_long = max(cfg.input.max_long_read_len, L)
    host_sec = state["host_sec"]
    sinks: dict = {}
    mark = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        host_sec[phase] += now - mark[0]
        mark[0] = now

    try:
        for fpath, mpath, sample in inputs:
            for batch in read_batches(fpath, B, mate_path=mpath,
                                      sample=sample):
                lap("parse")
                n = len(batch)
                launches, cut = bucket_batch(batch.seqs, batch.mate_seqs, B,
                                             L, max_long)
                state["truncated"] += cut
                lap("pad")
                res = {k: np.zeros(n, np.int32) for k in OUT_KEYS}
                for sub, bases, mates in launches:
                    out = model(torch.from_numpy(bases).to(device),
                                None if mates is None
                                else torch.from_numpy(mates).to(device))
                    for k in OUT_KEYS:
                        res[k][sub] = out[k].cpu().numpy()
                lap("step")
                if state["write"]:
                    if sample not in sinks:
                        sinks[sample] = open(os.path.join(
                            out_dir, f"{sample}.assign.tsv"), "w")
                    sinks[sample].write("".join(format_assignment(
                        AssignmentRecord(batch.ids[i], int(res["taxon"][i]),
                                         int(res["best"][i]),
                                         int(res["nvalid"][i])), tax)
                        for i in range(n)))
                _tally(state, sample, n, res["taxon"], tax.num_taxa + 1)
                lap("write")
            lap("parse")                  # the read files' last, empty read
    finally:
        for fh in sinks.values():
            fh.close()
    if state["truncated"]:
        print(f"[classify] WARNING: {state['truncated']} reads exceeded "
              f"input.max_long_read_len={max_long} and were truncated.",
              file=sys.stderr)


def _run_fast(cfg: RunConfig, model, tax, device, inputs,
              state: dict) -> None:
    out_dir = cfg.classify.out_dir
    B, L = state["batch"], cfg.input.max_read_len
    stride = wire_width(L)
    host_sec = state["host_sec"]
    blobs = TaxBlobs(tax)
    written: set = set()
    drain_q: queue.Queue = queue.Queue(maxsize=DRAIN_DEPTH)
    drain_err: list = []

    def produce():
        for fpath, mpath, sample in inputs:
            r1 = NativeFastxReader(fpath, B, L)
            r2 = NativeFastxReader(mpath, B, L) if mpath else None
            try:
                while True:
                    t0 = time.perf_counter()
                    b1 = r1.next_batch_packed()
                    if b1 is None:
                        break
                    n, ids, rows, lens = b1
                    rows = rows[:n]
                    state["truncated"] += int((lens[:n] > L).sum())
                    if r2 is not None:
                        b2 = r2.next_batch_packed()
                        if b2 is None or b2[0] != n:
                            raise ValueError(f"{mpath}: record count "
                                             f"mismatch with {fpath}")
                        state["truncated"] += int((b2[3][:n] > L).sum())
                        rows = np.concatenate([rows, b2[2][:n]], axis=1)
                    host_sec["parse"] += time.perf_counter() - t0
                    yield sample, n, ids, rows
            finally:
                r1.close()
                if r2 is not None:
                    r2.close()

    def drain():
        try:
            while (item := drain_q.get()) is not _END:
                sample, n, ids, out = item
                t0 = time.perf_counter()
                res = {k: out[k].cpu().numpy() for k in OUT_KEYS}
                t1 = time.perf_counter()
                path = os.path.join(out_dir, f"{sample}.assign.tsv")
                if state["write"]:
                    write_assignments_native(path, path in written, ids, n,
                                             res["taxon"], res["best"],
                                             res["nvalid"], blobs)
                written.add(path)
                _tally(state, sample, n, res["taxon"], tax.num_taxa + 1)
                host_sec["fetch"] += t1 - t0
                host_sec["write"] += time.perf_counter() - t1
        except BaseException as e:  # noqa: BLE001 (raised by the main thread)
            drain_err.append(e)
            while drain_q.get() is not _END:    # never block the main thread
                pass

    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()
    try:
        for sample, n, ids, rows in _prefetch(produce()):
            if drain_err:
                break
            t0 = time.perf_counter()
            combo = torch.from_numpy(rows.view(np.int32)).to(device)
            out = model(combo[:, :stride],
                        combo[:, stride:] if rows.shape[1] > stride
                        else None, packed_len=L)
            host_sec["step"] += time.perf_counter() - t0
            drain_q.put((sample, n, ids, out))
    finally:
        drain_q.put(_END)
        drainer.join()
    if drain_err:
        raise drain_err[0]
    if state["truncated"]:
        print(f"[classify] WARNING: {state['truncated']} reads exceeded "
              f"input.max_read_len={L} and were truncated on the fast "
              f"path. For exact long-read classification set "
              f"input.long_reads=true (general path, length-bucketed) or "
              f"raise input.max_read_len.", file=sys.stderr)


def _write_reports(out_dir: str, counts: dict, tax) -> None:
    """Summaries, the cohort table and stats.json from per-taxon counts."""
    sample_stats = {}
    for sample in sorted(counts):
        write_summary_counts(os.path.join(out_dir, f"{sample}.summary.tsv"),
                             counts[sample], tax)
        sample_stats[sample] = report_stats.sample_stats(counts[sample][1:])
    if len(counts) > 1:
        write_cohort_summary_counts(
            os.path.join(out_dir, "cohort.summary.tsv"), counts, tax,
            sample_order=sorted(counts))
    with open(os.path.join(out_dir, "stats.json"), "w") as fh:
        json.dump(sample_stats, fh, indent=2, sort_keys=True)


def run_classify_basic(cfg: RunConfig, device) -> dict:
    """Classify cfg.input's read files against the indexes of cfg.classify
    on ``device``; returns run metrics. With cfg.dist.num_processes > 1 the
    process is one rank of that many (each launched with its
    dist.process_id): the ranks join over NCCL for CUDA devices, a card
    each (cuda:{rank % cards} unless the device names one), and over gloo
    on the CPU; the run spans the mesh of cfg.mesh (or choose_mesh's for
    the world and the largest index), as the reference's ``run_classify``
    does: every rank streams the same batches and takes its rows, and rank
    0 alone writes the outputs, stats and run config."""
    _check_supported(cfg)
    if cfg.input.samples and len(cfg.input.samples) != len(cfg.input.reads):
        raise ValueError(f"{len(cfg.input.samples)} sample names for "
                         f"{len(cfg.input.reads)} read files")
    if cfg.input.mates and len(cfg.input.mates) != len(cfg.input.reads):
        raise ValueError(f"{len(cfg.input.mates)} mate files for "
                         f"{len(cfg.input.reads)} read files")
    device = torch.device(device)
    world = max(cfg.dist.num_processes, 1)
    if device.type == "cuda" and world > 1:
        if device.index is None:
            rank = cfg.dist.process_id if cfg.dist.process_id >= 0 \
                else int(os.environ["RANK"])
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    joined = initialize_multihost(
        cfg.dist.coordinator, world, cfg.dist.process_id,
        backend="nccl" if device.type == "cuda" else "gloo")
    try:
        return _classify(cfg, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _classify(cfg: RunConfig, device) -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    out_dir = cfg.classify.out_dir
    if rank0:
        os.makedirs(out_dir, exist_ok=True)
        dump_config(cfg, os.path.join(out_dir, "run_config.json"))

    indexes = [load_index_any(p) for p in cfg.classify.index]
    if not indexes:
        raise ValueError("classify.index must name at least one index")
    for ix in indexes[1:]:
        if ix.meta.taxonomy_hash != indexes[0].meta.taxonomy_hash:
            raise ValueError("multi-k indexes built against different "
                             "taxonomies")
    tax = indexes[0].taxonomy
    if cfg.mesh.n_data and cfg.mesh.n_shard:
        mcfg = MeshConfig(cfg.mesh.n_data, cfg.mesh.n_shard)
    else:
        mcfg = choose_mesh(world, max(ix.nbytes for ix in indexes),
                           int(cfg.mesh.per_device_hbm_budget_gb * (1 << 30)))
    mesh = Mesh(mcfg, device)
    print(f"[classify] {mesh!r}, {mesh.cfg.n_shard}-shard placement of "
          f"{len(indexes)} index(es)", file=sys.stderr)
    model = MeshStep([place_index(ix, mesh,
                                  cfg.classify.confidence_threshold)
                      for ix in indexes], mesh, cfg.mesh.routing)
    files = list(cfg.input.reads)
    mates = list(cfg.input.mates) or [None] * len(files)
    samples = list(cfg.input.samples) or default_sample_names(files)
    inputs = list(zip(files, mates, samples))

    # The reference's choice of loop: fast unless input.long_reads or
    # PANGEA_NO_NATIVE.
    fast = not cfg.input.long_reads and not os.environ.get("PANGEA_NO_NATIVE")
    if fast:
        native.library()     # set-up: built at first use, raises if it fails
    if rank0:
        print(f"[classify] {'fast' if fast else 'general'} path: "
              + ("native reader, packed rows" if fast else
                 "Python reader, long reads in length buckets"),
              file=sys.stderr)
    phases = ("parse", "step", "fetch", "write") if fast else \
        ("parse", "pad", "step", "write")
    # Batch rows split evenly along the data axis (the reference's
    # run_classify, run.py:718-720).
    B = max(cfg.input.batch_size - cfg.input.batch_size % mcfg.n_data,
            mcfg.n_data)
    state = {"counts": {}, "truncated": 0, "batch": B, "write": rank0,
             "totals": {"reads": 0, "classified": 0, "batches": 0},
             "host_sec": dict.fromkeys(phases, 0.0)}
    launches0 = kernel_launches()
    t_start = time.time()
    (_run_fast if fast else _run_general)(cfg, model, tax, device, inputs,
                                          state)
    if rank0:
        _write_reports(out_dir, state["counts"], tax)
    wall = time.time() - t_start
    totals = state["totals"]
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    return {"reads": totals["reads"], "batches": totals["batches"],
            "wall_sec": round(wall, 3),
            "reads_per_sec": round(totals["reads"] / max(wall, 1e-9), 1),
            "pct_classified": round(100.0 * totals["classified"]
                                    / max(totals["reads"], 1), 2),
            "mesh": {"data": mcfg.n_data, "shard": mcfg.n_shard},
            "rank": mesh.rank, "routing": cfg.mesh.routing,
            "samples": sorted(state["counts"]), "device": str(device),
            "fast_path": fast, "truncated_reads": state["truncated"],
            "kernel_launches": launches, "host_sec": state["host_sec"]}
