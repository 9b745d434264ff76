"""Basic streaming classify run on one device.

Counterpart of the general (non-native) branch of
``pangea_tpu/pipeline/run.py`` ``run_classify`` on one device, for one or
more indexes (q8, q12 or std layout each) built on one taxonomy: read files
(single or paired) stream through ``read_batches`` at ``input.batch_size``,
each batch runs one :class:`MultiKClassifier` step (several indexes merge
on the device, SEMANTICS.md §9), and the run writes
``{sample}.assign.tsv``, ``{sample}.summary.tsv`` (plus
``cohort.summary.tsv`` for several samples) and ``stats.json`` exactly as
the reference does. Options the port does not run yet raise
NotImplementedError naming their ROADMAP item.

The returned metrics split the batch loop's host wall into ``host_sec``:
``parse`` (FASTQ records to code arrays), ``pad`` (the padded [B, L]
batch), ``step`` (host-to-device copy, the classify step and the copy
back, which waits for the device) and ``write`` (assignment lines).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..classify.engine import DeviceIndex, MultiKClassifier, pad_batch
from ..config import RunConfig, dump_config
from ..index import load_index_any
from ..io.fastx import read_batches
from ..kernels import kernel_launches
from ..report import stats as report_stats
from ..report.writers import (AssignmentRecord, format_assignment, summarize,
                              write_cohort_summary, write_summary)


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


def _check_supported(c: RunConfig) -> None:
    if c.mesh.n_data > 1 or c.mesh.n_shard > 1 or c.dist.num_processes > 1:
        raise NotImplementedError(
            "a mesh of more than one device is not ported yet (ROADMAP A6)")
    if c.trim.min_qual > 0 or c.trim.min_len or c.trim.max_len \
            or c.demux.barcodes:
        raise NotImplementedError(
            "trim and demux are not ported yet (ROADMAP A5)")
    if c.classify.resume:
        raise NotImplementedError("--resume is not ported yet (ROADMAP A5)")


def _check_lengths(batch, L: int) -> None:
    seqs = batch.seqs + (batch.mate_seqs or [])
    longest = max((len(s) for s in seqs), default=0)
    if longest > L:
        raise NotImplementedError(
            f"a read of {longest} bases exceeds input.max_read_len={L}: the "
            "reference classifies it exactly through long-read buckets, "
            "which are not ported yet (ROADMAP A3, B11)")


def run_classify_basic(cfg: RunConfig, device) -> dict:
    """Classify cfg.input's read files against the indexes of cfg.classify
    on ``device``; returns run metrics."""
    _check_supported(cfg)
    out_dir = cfg.classify.out_dir
    if cfg.input.samples and len(cfg.input.samples) != len(cfg.input.reads):
        raise ValueError(f"{len(cfg.input.samples)} sample names for "
                         f"{len(cfg.input.reads)} read files")
    if cfg.input.mates and len(cfg.input.mates) != len(cfg.input.reads):
        raise ValueError(f"{len(cfg.input.mates)} mate files for "
                         f"{len(cfg.input.reads)} read files")
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
    model = MultiKClassifier([
        DeviceIndex.from_index(ix, device, cfg.classify.confidence_threshold)
        for ix in indexes])
    paired = bool(cfg.input.mates)
    B, L = cfg.input.batch_size, cfg.input.max_read_len
    files = list(cfg.input.reads)
    mates = list(cfg.input.mates) if paired else [None] * len(files)
    samples = list(cfg.input.samples) or default_sample_names(files)

    sinks: dict = {}
    sample_taxa: dict = {}
    totals = {"reads": 0, "classified": 0, "batches": 0}
    host_sec = dict.fromkeys(("parse", "pad", "step", "write"), 0.0)
    mark = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        host_sec[phase] += now - mark[0]
        mark[0] = now

    launches0 = kernel_launches()
    t_start = time.time()
    try:
        for fpath, mpath, sample in zip(files, mates, samples):
            for batch in read_batches(fpath, B, mate_path=mpath,
                                      sample=sample):
                lap("parse")
                n = len(batch)
                _check_lengths(batch, L)
                bases = torch.from_numpy(pad_batch(batch.seqs, n, L))
                mb = (torch.from_numpy(pad_batch(batch.mate_seqs, n, L))
                      if paired else None)
                lap("pad")
                out = model(bases.to(device),
                            None if mb is None else mb.to(device))
                res = {k: v.cpu().numpy() for k, v in out.items()}
                lap("step")
                if sample not in sinks:
                    sinks[sample] = open(
                        os.path.join(out_dir, f"{sample}.assign.tsv"), "w")
                    sample_taxa[sample] = []
                sinks[sample].write("".join(format_assignment(
                    AssignmentRecord(batch.ids[i], int(res["taxon"][i]),
                                     int(res["best"][i]),
                                     int(res["nvalid"][i])), tax)
                    for i in range(n)))
                sample_taxa[sample].append(res["taxon"].astype(np.int64))
                totals["reads"] += n
                totals["classified"] += int((res["taxon"] != 0).sum())
                totals["batches"] += 1
                print(f"[classify] batch {totals['batches']}: {n} reads "
                      f"({totals['reads']} total)", file=sys.stderr)
                lap("write")
            lap("parse")                  # the read files' last, empty read
    finally:
        for fh in sinks.values():
            fh.close()

    sample_stats = {}
    taxa_by_sample = {}
    for sample in sorted(sample_taxa):
        taxa = np.concatenate(sample_taxa[sample])
        taxa_by_sample[sample] = taxa
        write_summary(os.path.join(out_dir, f"{sample}.summary.tsv"), taxa,
                      tax)
        direct, _ = summarize(taxa, tax)
        sample_stats[sample] = report_stats.sample_stats(direct[1:])
    if len(taxa_by_sample) > 1:
        write_cohort_summary(os.path.join(out_dir, "cohort.summary.tsv"),
                             taxa_by_sample, tax)
    with open(os.path.join(out_dir, "stats.json"), "w") as fh:
        json.dump(sample_stats, fh, indent=2, sort_keys=True)

    wall = time.time() - t_start
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    return {"reads": totals["reads"], "batches": totals["batches"],
            "wall_sec": round(wall, 3),
            "reads_per_sec": round(totals["reads"] / max(wall, 1e-9), 1),
            "pct_classified": round(100.0 * totals["classified"]
                                    / max(totals["reads"], 1), 2),
            "samples": sorted(sample_taxa), "device": str(device),
            "kernel_launches": launches, "host_sec": host_sec}
