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
their owners with ``mesh.routing=alltoall``). Reads are quality-trimmed
and length-filtered (``trim.*``) and, with ``demux.barcodes``, binned to
their samples by barcode (``demux.max_mismatch``), the barcode stripped;
the rest go to ``undetermined``. Rank 0 writes ``{sample}.assign.tsv``,
``{sample}.summary.tsv`` (plus ``cohort.summary.tsv`` for several
samples), ``stats.json``, ``metrics.jsonl`` (a line a batch),
``run_summary.json`` (the result) and ``manifest.json`` (the checkpoint of
``classify.resume``, ``checkpoint.py``) exactly as the reference does.
Like ``run_classify`` (its lines 729-734), it takes one of two loops:

- the fast path, the default: the native reader (``io/native.py``) packs
  each read into wire rows on a producer thread (prefetch depth 2), which
  also trims, filters, demultiplexes and strips on the rows
  (``io/packed_ops.py``) and keeps only the rows that remain; the main
  thread copies each batch to the device once (the mates as column slices
  of one array) and launches the step with ``packed_len=L``, so K1
  decodes the rows itself; a drain thread brings the outputs back, writes
  each sample's lines with the native writer and keeps per-taxon counts
  for the summaries; a durability thread fsyncs the files and commits the
  manifest every ``PANGEA_FSYNC_EVERY`` (8) drained batches. Reads longer
  than ``input.max_read_len`` are cut to it, counted in
  ``truncated_reads`` and warned about. An error in any thread is raised
  in the main thread.
- the general path, when ``input.long_reads`` is true, ``PANGEA_NO_NATIVE``
  is set or a barcode is longer than 32 bases: batches of ReadBatches
  (``io.fastx.read_batches``, whole reads; or, for the long barcodes
  alone, the native reader's ``read_batches_native``), trimmed
  (``io/trim.py``) and demultiplexed (``io/demux.py``) read by read, each
  sample's part launched in turn: reads of up to L bases as one [n, L]
  batch, longer ones exactly, in power-of-two length buckets L * 2^j up
  to max(``input.max_long_read_len``, L), max(64, B * L // Lj) reads a
  launch (reads past that cap are cut to it, counted and warned about);
  the outputs go back to input order, and each batch's lines are fsync'd
  before the manifest records it. The reference overlaps this loop (a
  prefetch thread, ``PANGEA_INFLIGHT`` batches' outputs left on the
  device); the port runs it in series and ignores the variable here
  (ROADMAP.md §C).

The fast path's drain queue holds ``PANGEA_INFLIGHT`` launched batches
(by default DRAIN_DEPTH, at least 1), as the reference's does.

A launch holds only the rows that remain: a batch or part left with none
launches nothing, yet still writes its ``metrics.jsonl`` line and its
manifest record. On a mesh every rank reads the same batches, skips the
same resumed reads (rank 0's manifest, broadcast) and launches the same
steps; rank 0 alone cuts the files back, writes and commits.

The returned metrics carry the reference's ``run_summary.json`` keys
(``reads_in``, ``reads_kept``, ``reads_filtered``, ``indexes``,
``device_reads_per_sec``, ``compile_sec`` ...) and ``fast_path``,
``truncated_reads``, ``kernel_launches`` and ``host_sec``, the host time
by phase: ``parse`` (the reader), ``trim`` (trim, filter, demultiplex and
strip), ``step`` (the copy to the device and the launches; on the general
path also the copies back, which wait for the device), ``write`` (the
assignment lines), ``sync`` (the fsyncs and manifest commits) and, on the
general path, ``pad`` (bucketing and the padded batches), all of its one
loop, or, on the fast path, ``fetch`` (the copy back, which waits for the
device), each of its threads, which overlap. Each phase is a span of the
port's tracer (``trace.py``), ``run.parse`` ... ``run.sync``, which totals
its nanoseconds on the one clock (``time.perf_counter_ns``) whether or
not a trace is collected; ``host_sec`` gives those totals in seconds.

``PANGEA_PROFILE=<dir>`` wraps either loop (after the warmup launch) in a
``torch.profiler`` trace, CPU activity and, on a CUDA device, the card's,
written as ``<dir>/trace_rank<r>.json`` (a Chrome trace) on every rank
when the loop ends: the counterpart of the reference's
``jax.profiler.start_trace``. The port's tracer collects over the same
loop, so the Chrome trace carries its spans (the ``run.*`` phases,
``step`` and the spans beneath it) as user annotations, and
``<dir>/spans_rank<r>.json`` holds the collected trace's summary
(``trace.Trace.summary``: self time by span, launch records by launcher,
the card's waits on the host inside each step).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import queue
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..classify.engine import pad_batch
from ..config import RunConfig, dump_config
from ..core import encode_bases
from ..dist.mesh import (OUT_KEYS, Mesh, MeshConfig, MeshStep, choose_mesh,
                         initialize_multihost, place_index)
from ..index import build_index, build_index_ooc, load_index_any
from ..io import (UNDETERMINED, DemuxConfig, TrimConfig, demux_batch,
                  native, read_batches, sniff_format, trim_batch)
from ..io.fastx import FastxReader
from ..io.native import (ID_STRIDE, NativeFastxReader, TaxBlobs,
                         read_batches_native, write_assignments_native)
from ..io.packed_ops import demux_assign, mask_tail, qtrim_cut, strip_rows
from ..kernels import kernel_launches
from ..kernels.encode import wire_width
from ..report import stats as report_stats
from ..report.writers import (AssignmentRecord, count_taxa_tsv,
                              format_assignment, write_cohort_summary_counts,
                              write_summary_counts)
from ..taxonomy import Taxonomy
from .checkpoint import Manifest

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


class _SampleSink:
    """A sample's assignment file on the general path, with its durable
    offset. On resume it appends only to a file the manifest recorded: a
    file written before the first record has no durable part and is
    rewritten."""

    def __init__(self, out_dir: str, sample: str, taxonomy: Taxonomy,
                 resume: bool, manifest: Manifest):
        self.path = os.path.join(out_dir, f"{sample}.assign.tsv")
        self.taxonomy = taxonomy
        recorded = self.path in manifest.state["outputs"]
        self.fh = open(self.path, "a" if resume and recorded
                       and os.path.exists(self.path) else "w")

    def write(self, records) -> None:
        self.fh.write("".join(format_assignment(r, self.taxonomy)
                              for r in records))

    def offset(self) -> int:
        """Flush and fsync; the file's durable size."""
        self.fh.flush()
        os.fsync(self.fh.fileno())
        return self.fh.tell()

    def close(self) -> None:
        self.fh.close()


class _ReadyGauge:
    """The steady rate of the device: the gap between consecutive batches'
    outputs becoming ready on the host. With the launches queued ahead,
    that gap is a batch's cost in the binding stage. The first ``skip``
    gaps (the queue filling, the first launches) are left out; the summary
    is the median of the rest."""

    def __init__(self, skip: int = 2):
        self.last = None
        self.rates: list = []
        self.skip = skip

    def tick(self, n_in: int):
        t = time.time()
        gap = None if self.last is None else t - self.last
        self.last = t
        if gap and gap > 0:
            if self.skip > 0:
                self.skip -= 1
            else:
                self.rates.append(n_in / gap)
        return gap

    def summary(self) -> dict:
        if not self.rates:
            return {}
        return {"device_reads_per_sec": round(float(np.median(self.rates)),
                                              1),
                "device_rate_batches": len(self.rates)}


def _index_info(paths, indexes) -> list:
    """run_summary.json's ``indexes``: each index's path as given and its
    meta (k, w, ways, sizes, hashes)."""
    return [{"path": p, **dataclasses.asdict(ix.meta)}
            for p, ix in zip(paths, indexes)]


class _Launcher:
    """The run's step, with the first launch of each distinct batch shape
    timed up to a device sync (kernel builds and plan choices included).
    A shape is a launch's row widths and packed length, not its row count:
    no kernel is built or specialised for a row count. ``sec`` sums those
    first launches (``compile_sec``); after :meth:`warmup` a new shape is
    counted in ``late`` and warned about."""

    def __init__(self, model):
        self.model = model
        self.seen: set = set()
        self.sec = 0.0
        self.late = 0
        self.warmup_sec = None

    def __call__(self, bases, mates=None, packed_len: int = 0) -> dict:
        key = (bases.shape[1], None if mates is None else mates.shape[1],
               packed_len)
        if key in self.seen:
            return self.model(bases, mates, packed_len=packed_len)
        t = time.perf_counter()
        out = self.model(bases, mates, packed_len=packed_len)
        out["nvalid"][:1].cpu()                # waits for the device
        dt = time.perf_counter() - t
        self.sec += dt
        self.seen.add(key)
        if self.warmup_sec is not None:
            self.late += 1
            print(f"[classify] WARNING: first launch of batch shape {key} "
                  f"({dt:.1f}s) after the warmup; long-read buckets each "
                  "add one shape.", file=sys.stderr)
        return out

    def warmup(self, batch: torch.Tensor, paired: bool,
               packed_len: int) -> None:
        """Launch the steady batch shape once (``classify.warmup``): batch
        holds a batch's rows, both mates' side by side when paired."""
        t = time.perf_counter()
        half = batch.shape[1] // 2
        self(batch[:, :half] if paired else batch,
             batch[:, half:] if paired else None, packed_len)
        self.warmup_sec = round(time.perf_counter() - t, 1)

    def summary(self) -> dict:
        return {"compile_sec": round(self.sec, 1),
                **({"warmup_compile_sec": self.warmup_sec,
                    "late_compiled_shapes": self.late}
                   if self.warmup_sec is not None else {})}


def _metrics_line(item: dict, totals: dict, dt: float, drain_sec: float,
                  gap, fetch_sec=None) -> dict:
    """One ``metrics.jsonl`` line, the reference's keys in its order."""
    line = {"file": item["fpath"], "batch": totals["batches"],
            "reads": item["n_in"], "reads_kept": item["n_kept"],
            "sec": round(dt, 4), "launch_sec": round(item["t_launch"], 4),
            "drain_sec": round(drain_sec, 4)}
    if fetch_sec is not None:
        line["fetch_sec"] = round(fetch_sec, 4)
    line.update({
        "ready_gap_sec": round(gap, 4) if gap is not None else None,
        "reads_per_sec": round(item["n_in"] / max(dt, 1e-9), 1),
        "cum_reads": totals["reads"],
        "pct_classified": round(100.0 * totals["classified"]
                                / max(totals["reads"], 1), 2)})
    return line


def _count(state: dict, sample: str, taxon: np.ndarray) -> int:
    """Add a sample's outputs to its per-taxon counts; its classified
    reads."""
    c = np.bincount(taxon, minlength=state["T1"])
    counts = state["counts"]
    counts[sample] = c if sample not in counts else counts[sample] + c
    return int((taxon != 0).sum())


def _end_batch(state: dict, item: dict, n_cls: int, line_args) -> None:
    """A drained batch's totals and, on rank 0, its metrics line."""
    totals = state["totals"]
    totals["reads"] += item["n_in"]
    totals["kept"] += item["n_kept"]
    totals["classified"] += n_cls
    totals["batches"] += 1
    if state["write"]:
        line = _metrics_line(item, totals, *line_args)
        state["metrics"].write(json.dumps(line) + "\n")
        state["metrics"].flush()
        print(f"[classify] {line}", file=sys.stderr)


def _run_general(cfg: RunConfig, launch, tax, device, inputs,
                 state: dict) -> None:
    out_dir = cfg.classify.out_dir
    B, L = state["batch"], cfg.input.max_read_len
    max_long = max(cfg.input.max_long_read_len, L)
    resume, manifest = cfg.classify.resume, state["manifest"]
    trim_cfg, demux_cfg = state["trim"], state["demux"]
    phase = state["phase"]
    gauge = _ReadyGauge(skip=2)
    state["gauge"] = gauge
    sinks: dict = {}

    def run_part(part) -> dict:
        """A part's outputs in input order, its launches bucketed."""
        with phase("pad"):
            launches, cut = bucket_batch(part.seqs, part.mate_seqs, B, L,
                                         max_long)
            state["truncated"] += cut
            res = {k: np.zeros(len(part), np.int32) for k in OUT_KEYS}
        with phase("step"):
            for sub, bases, mates in launches:
                out = launch(torch.from_numpy(bases).to(device),
                             None if mates is None
                             else torch.from_numpy(mates).to(device))
                for k in OUT_KEYS:
                    res[k][sub] = out[k].cpu().numpy()
        return res

    try:
        for fpath, mpath, fsample in inputs:
            done = manifest.reads_done(fpath)
            skipped = 0
            batches = (read_batches_native(fpath, B, L, mate_path=mpath,
                                           sample=fsample)
                       if state["use_native"] else
                       read_batches(fpath, B, mate_path=mpath,
                                    sample=fsample))
            while True:
                with phase("parse"):
                    batch = next(batches, None)
                if batch is None:
                    break
                n_in = len(batch)
                if skipped + n_in <= done:         # resume: a done batch
                    skipped += n_in
                    continue
                if skipped < done:                 # resume: a part done
                    cut = done - skipped
                    batch.ids = batch.ids[cut:]
                    batch.seqs = batch.seqs[cut:]
                    for f in ("quals", "mate_seqs", "mate_quals"):
                        if getattr(batch, f) is not None:
                            setattr(batch, f, getattr(batch, f)[cut:])
                    skipped = done
                    n_in = len(batch)
                t0 = time.time()
                with phase("trim"):
                    batch = trim_batch(batch, trim_cfg)
                    n_kept = len(batch)
                    parts = (demux_batch(batch, demux_cfg) if demux_cfg
                             else {fsample: batch})
                done_parts = [(sample, part.ids, run_part(part))
                              for sample, part in sorted(parts.items())
                              if len(part)]
                item = {"fpath": fpath, "n_in": n_in, "n_kept": n_kept,
                        "t_launch": time.time() - t0}
                t_drain = time.time()
                gap = gauge.tick(n_in)
                n_cls, offsets = 0, {}
                for sample, ids, res in done_parts:
                    with phase("write"):
                        n_cls += _count(state, sample, res["taxon"])
                        if state["write"]:
                            if sample not in sinks:
                                sinks[sample] = _SampleSink(
                                    out_dir, sample, tax, resume, manifest)
                            sinks[sample].write(
                                AssignmentRecord(ids[i],
                                                 int(res["taxon"][i]),
                                                 int(res["best"][i]),
                                                 int(res["nvalid"][i]))
                                for i in range(len(ids)))
                    if state["write"]:
                        with phase("sync"):
                            offsets[sinks[sample].path] = \
                                sinks[sample].offset()
                if state["write"]:
                    with phase("sync"):
                        manifest.record_batch(fpath, n_in, offsets)
                with phase("write"):
                    _end_batch(state, item, n_cls,
                               (time.time() - t0, time.time() - t_drain, gap))
    finally:
        for fh in sinks.values():
            fh.close()
    if state["write"]:
        # The summaries from the durable files, in the sinks' order.
        state["counts"] = {s: count_taxa_tsv(sk.path, tax.num_taxa)
                           for s, sk in sorted(sinks.items())}
    if state["truncated"]:
        print(f"[classify] WARNING: {state['truncated']} reads exceeded "
              f"input.max_long_read_len={max_long} and were truncated.",
              file=sys.stderr)


def _pack_batch(b1, b2, write_from: int, L: int, state: dict):
    """The fast path's work on one packed batch past its first write_from
    (resumed) reads: trim, max_len, the min_len keep, demux and strip, the
    tail mask, then the kept rows compacted. Returns the rows to launch
    (mates side by side), the (sample, rows or None for all, ids) groups
    of the drain in the reference's order, and the kept count."""
    trim_cfg, demux_cfg = state["trim"], state["demux"]
    n, ids_raw, rows, lens1, quals1 = b1
    sl = slice(write_from, n)
    ids_np = np.frombuffer(ids_raw, np.uint8).reshape(-1, ID_STRIDE)[sl]
    rows = rows[sl]
    mrows = b2[2][sl] if b2 is not None else None
    if not state["processing"]:
        out = rows if mrows is None else np.concatenate([rows, mrows], 1)
        return (out, [(state["sample"], None, ids_np.tobytes())],
                n - write_from)

    def cut(lens, quals):
        lens_eff = np.minimum(lens[sl], L).astype(np.int32)
        if quals is not None:
            lens_eff = qtrim_cut(quals[sl], lens_eff, trim_cfg.min_qual,
                                 trim_cfg.window)
        if trim_cfg.max_len:
            lens_eff = np.minimum(lens_eff, trim_cfg.max_len)
        return lens_eff

    lens_eff = cut(lens1, quals1)
    keep = np.ones(n - write_from, bool)
    if trim_cfg.min_len:
        keep &= lens_eff >= trim_cfg.min_len
    if mrows is not None:
        mlens_eff = cut(b2[3], b2[4])
        if trim_cfg.min_len:
            keep &= mlens_eff >= trim_cfg.min_len
    bins = None
    if demux_cfg is not None:
        bins, strip = demux_assign(rows, L, lens_eff, state["bc_codes"],
                                   demux_cfg.max_mismatch)
        rows = strip_rows(rows, L, strip)
        lens_eff = lens_eff - strip
    kidx = np.flatnonzero(keep)
    out = mask_tail(rows[kidx], L, lens_eff[kidx])
    if mrows is not None:
        out = np.concatenate([out, mask_tail(mrows[kidx], L,
                                             mlens_eff[kidx])], 1)
    groups = []
    if bins is None:
        if kidx.size:
            groups.append((state["sample"], None, ids_np[kidx].tobytes()))
    else:
        bins_k = bins[kidx]
        for bi in np.unique(bins_k):
            ps = np.flatnonzero(bins_k == bi)
            groups.append((state["bc_names"][bi] if bi >= 0
                           else UNDETERMINED, ps, ids_np[kidx[ps]].tobytes()))
    return out, groups, kidx.size


def _run_fast(cfg: RunConfig, launch, tax, device, inputs,
              state: dict) -> None:
    out_dir = cfg.classify.out_dir
    B, L = state["batch"], cfg.input.max_read_len
    stride = wire_width(L)
    phase = state["phase"]
    manifest, write = state["manifest"], state["write"]
    # On resume, only the files the manifest recorded are appended to.
    recorded = set(manifest.state["outputs"]) if cfg.classify.resume \
        else set()
    want_q = state["trim"].min_qual > 0
    blobs = TaxBlobs(tax)
    sample_paths = state["sample_paths"]
    appended: set = set()
    depth = max(int(os.environ.get("PANGEA_INFLIGHT", str(DRAIN_DEPTH))),
                1)
    drain_q: queue.Queue = queue.Queue(maxsize=depth)
    gauge = _ReadyGauge(skip=depth)
    state["gauge"] = gauge
    errors: list = []
    # Durability: the drained files are fsync'd, then the manifest commits
    # them, every fsync_every drained batches, on a thread of its own
    # through a bounded queue (a crash redoes a few groups at most).
    fsync_every = max(int(os.environ.get("PANGEA_FSYNC_EVERY", "8")), 1)
    pend = {"fpath": None, "reads": 0, "offsets": {}, "k": 0}
    dur_q: queue.Queue = queue.Queue(maxsize=2)

    def durability():
        try:
            while (item := dur_q.get()) is not _END:
                with phase("sync"):
                    fpath, reads, offsets = item
                    for path in offsets:
                        fd = os.open(path, os.O_RDONLY)
                        try:
                            os.fsync(fd)
                        finally:
                            os.close(fd)
                    manifest.record_batch(fpath, reads, offsets)
        except BaseException as e:  # noqa: BLE001 (raised by the main thread)
            errors.append(e)
            while dur_q.get() is not _END:  # never block the drain
                pass

    def flush_durability():
        if not pend["reads"] or not write:
            return
        if errors:
            raise errors[0]
        dur_q.put((pend["fpath"], pend["reads"], dict(pend["offsets"])))
        pend.update(fpath=None, reads=0, offsets={}, k=0)

    def produce():
        for fpath, mpath, fsample in inputs:
            if state["demux"] is None:
                sample_paths[fsample] = os.path.join(
                    out_dir, f"{fsample}.assign.tsv")
            state["sample"] = fsample
            done = manifest.reads_done(fpath)
            seen = 0
            r1 = NativeFastxReader(fpath, B, L, want_quals=want_q and
                                   sniff_format(fpath) == "fastq")
            r2 = NativeFastxReader(mpath, B, L, want_quals=want_q and
                                   sniff_format(mpath) == "fastq") \
                if mpath else None
            try:
                while True:
                    with phase("parse"):
                        b1 = r1.next_batch_packed()
                        b2 = None
                        if b1 is not None and r2 is not None:
                            b2 = r2.next_batch_packed()
                    if b1 is None:
                        break
                    n = b1[0]
                    if r2 is not None and (b2 is None or b2[0] != n):
                        raise ValueError(f"{mpath}: record count "
                                         f"mismatch with {fpath}")
                    t_wall = time.time()
                    if seen + n <= done:           # resume: a done batch
                        seen += n
                        continue
                    write_from = max(done - seen, 0)
                    seen += n
                    with phase("trim"):
                        # Truncation counts only the reads this run
                        # processes.
                        for b in (b1, b2):
                            if b is not None:
                                state["truncated"] += int(
                                    (b[3][write_from:n] > L).sum())
                        rows, groups, n_kept = _pack_batch(
                            b1, b2, write_from, L, state)
                    yield {"fpath": fpath, "n_in": n - write_from,
                           "n_kept": n_kept, "groups": groups, "rows": rows,
                           "t0": t_wall}
            finally:
                r1.close()
                if r2 is not None:
                    r2.close()

    def drain():
        try:
            while (item := drain_q.get()) is not _END:
                t0 = time.time()
                with phase("fetch") as fetch:
                    out = item["out"]
                    res = None if out is None else \
                        {k: out[k].cpu().numpy() for k in OUT_KEYS}
                with phase("write"):
                    gap = gauge.tick(item["n_in"])
                    offsets, n_cls = {}, 0
                    for sample, ps, ids in item["groups"]:
                        part = {k: v if ps is None else v[ps]
                                for k, v in res.items()}
                        n_cls += _count(state, sample, part["taxon"])
                        if not write:
                            continue
                        path = sample_paths[sample]
                        offsets[path] = write_assignments_native(
                            path, path in appended or path in recorded, ids,
                            part["taxon"].size, part["taxon"], part["best"],
                            part["nvalid"], blobs, strip_mate_suffix=True)
                        appended.add(path)
                    if write:
                        if pend["fpath"] not in (None, item["fpath"]):
                            flush_durability()
                        pend["fpath"] = item["fpath"]
                        pend["reads"] += item["n_in"]
                        pend["offsets"].update(offsets)
                        pend["k"] += 1
                        if pend["k"] >= fsync_every:
                            flush_durability()
                    _end_batch(state, item, n_cls,
                               (time.time() - item["t0"], time.time() - t0,
                                gap, fetch.ns * 1e-9))
            flush_durability()
        except BaseException as e:  # noqa: BLE001 (raised by the main thread)
            errors.append(e)
            while drain_q.get() is not _END:    # never block the main thread
                pass

    durab = threading.Thread(target=durability, daemon=True)
    drainer = threading.Thread(target=drain, daemon=True)
    durab.start()
    drainer.start()
    try:
        for item in _prefetch(produce()):
            if errors:
                break
            with phase("step"):
                rows = item.pop("rows")
                item["out"] = None
                if rows.shape[0]:     # a batch that kept no read launches
                    combo = torch.from_numpy(rows.view(np.int32)).to(device)
                    item["out"] = launch(combo[:, :stride],
                                         combo[:, stride:] if rows.shape[1]
                                         > stride else None, packed_len=L)
                item["t_launch"] = time.time() - item["t0"]
            drain_q.put(item)
    finally:
        drain_q.put(_END)
        drainer.join()
        dur_q.put(_END)          # after the drain: every flush is queued
        durab.join()
    if errors:
        raise errors[0]
    if write and cfg.classify.resume:
        # The pre-crash batches are in the files, not in the counts.
        state["counts"] = {s: count_taxa_tsv(p, tax.num_taxa)
                           for s, p in sorted(sample_paths.items())
                           if os.path.exists(p)}
    if state["truncated"]:
        print(f"[classify] WARNING: {state['truncated']} reads exceeded "
              f"input.max_read_len={L} and were truncated on the fast "
              f"path. For exact long-read classification set "
              f"input.long_reads=true (general path, length-bucketed) or "
              f"raise input.max_read_len.", file=sys.stderr)


def _write_reports(out_dir: str, counts: dict, tax) -> None:
    """Summaries, the cohort table and stats.json from per-taxon counts
    (samples in sorted order)."""
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
    0 alone writes the outputs, stats, metrics, manifest and run config."""
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


def _profiler(device):
    """PANGEA_PROFILE's profiler: CPU activity on every thread (the
    drain's spans too), and the card's on a CUDA device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))


def _load_manifest(cfg: RunConfig, rank0: bool) -> Manifest:
    """The run's manifest: on resume, rank 0's as it stands on disk, sent
    to every rank, so that all skip the same reads; rank 0 then cuts the
    assignment files back to their durable offsets."""
    manifest = Manifest.load_or_new(
        os.path.join(cfg.classify.out_dir, "manifest.json"),
        cfg.classify.resume and rank0)
    if cfg.classify.resume and dist.is_initialized():
        box = [manifest.state]
        dist.broadcast_object_list(box, src=0)
        manifest.state = box[0]
    if cfg.classify.resume and rank0:
        manifest.truncate_outputs()
    return manifest


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
    launch = _Launcher(MeshStep([place_index(
        ix, mesh, cfg.classify.confidence_threshold) for ix in indexes],
        mesh, cfg.mesh.routing))
    files = list(cfg.input.reads)
    mates = list(cfg.input.mates) or [None] * len(files)
    samples = list(cfg.input.samples) or default_sample_names(files)
    inputs = list(zip(files, mates, samples))
    paired = bool(cfg.input.mates)
    demux = (DemuxConfig(tuple(map(tuple, cfg.demux.barcodes)),
                         cfg.demux.max_mismatch)
             if cfg.demux.barcodes else None)
    trim = TrimConfig(cfg.trim.min_qual, cfg.trim.window, cfg.trim.min_len,
                      cfg.trim.max_len)

    # The reference's choice of loop: fast unless input.long_reads,
    # PANGEA_NO_NATIVE or a barcode past 32 bases; the general path reads
    # natively only for the long barcodes.
    native_ok = not cfg.input.long_reads \
        and not os.environ.get("PANGEA_NO_NATIVE")
    fast = native_ok and (demux is None
                          or max(len(bc) for _, bc in demux.barcodes) <= 32)
    if native_ok:
        native.library()     # set-up: built at first use, raises if it fails
    if rank0:
        print(f"[classify] {'fast' if fast else 'general'} path: "
              + ("native reader, packed rows" if fast else
                 ("native" if native_ok else "Python")
                 + " reader, long reads in length buckets"),
              file=sys.stderr)
    phases = ("parse", "trim", "step", "fetch", "write", "sync") if fast \
        else ("parse", "trim", "pad", "step", "write", "sync")
    # Batch rows split evenly along the data axis (the reference's
    # run_classify, run.py:718-720).
    B = max(cfg.input.batch_size - cfg.input.batch_size % mcfg.n_data,
            mcfg.n_data)
    L = cfg.input.max_read_len
    state = {"counts": {}, "truncated": 0, "batch": B, "write": rank0,
             "T1": tax.num_taxa + 1, "trim": trim, "demux": demux,
             "processing": demux is not None or trim.min_qual > 0
             or bool(trim.min_len) or bool(trim.max_len),
             "bc_codes": demux and [encode_bases(bc)
                                    for _, bc in demux.barcodes],
             "bc_names": demux and [name for name, _ in demux.barcodes],
             "sample_paths": {name: os.path.join(out_dir,
                                                 f"{name}.assign.tsv")
                              for name in ([n for n, _ in demux.barcodes]
                                           + [UNDETERMINED])}
             if demux else {},
             "use_native": native_ok,
             "totals": {"reads": 0, "kept": 0, "classified": 0,
                        "batches": 0}}
    phase_ns: dict = {}
    state["phase"] = lambda name: trace.Span("run." + name, phase_ns)
    launches0 = kernel_launches()
    if cfg.classify.warmup:
        width = wire_width(L) if fast else L
        launch.warmup(
            torch.zeros((B, width * (2 if paired else 1)), dtype=torch.int32,
                        device=device) if fast else
            torch.from_numpy(pad_batch([], B, width * (2 if paired else 1)))
            .to(device), paired, L if fast else 0)
    state["manifest"] = _load_manifest(cfg, rank0)
    metrics_path = os.path.join(out_dir, "metrics.jsonl")
    state["metrics"] = open(metrics_path, "a" if cfg.classify.resume
                            else "w") if rank0 else None
    profile_dir = os.environ.get("PANGEA_PROFILE")
    prof = _profiler(device) if profile_dir else contextlib.nullcontext()
    spans = trace.collect() if profile_dir else contextlib.nullcontext()
    t_start = time.time()
    try:
        with prof, spans as collected:
            (_run_fast if fast else _run_general)(cfg, launch, tax, device,
                                                  inputs, state)
    finally:
        if state["metrics"] is not None:
            state["metrics"].close()
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(profile_dir, f"trace_rank{mesh.rank}.json"))
        with open(os.path.join(profile_dir,
                               f"spans_rank{mesh.rank}.json"), "w") as fh:
            json.dump(collected.summary(), fh, indent=1, sort_keys=True)
    if rank0:
        _write_reports(out_dir, state["counts"], tax)
    wall = time.time() - t_start
    totals = state["totals"]
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    result = {"reads": totals["reads"], "reads_in": totals["reads"],
              "reads_kept": totals["kept"],
              "reads_filtered": totals["reads"] - totals["kept"],
              "batches": totals["batches"],
              "wall_sec": round(wall, 3),
              "reads_per_sec": round(totals["reads"] / max(wall, 1e-9), 1),
              "pct_classified": round(100.0 * totals["classified"]
                                      / max(totals["reads"], 1), 2),
              "mesh": {"data": mcfg.n_data, "shard": mcfg.n_shard},
              "rank": mesh.rank, "routing": cfg.mesh.routing,
              "samples": sorted(state["counts"]), "device": str(device),
              "fast_path": fast, "truncated_reads": state["truncated"],
              "indexes": _index_info(cfg.classify.index, indexes),
              **state["gauge"].summary(), **launch.summary(),
              "kernel_launches": launches,
              "host_sec": {p: phase_ns.get("run." + p, 0) * 1e-9
                           for p in phases}}
    if rank0:
        with open(os.path.join(out_dir, "run_summary.json"), "w") as fh:
            json.dump(result, fh, indent=2, sort_keys=True)
    return result
