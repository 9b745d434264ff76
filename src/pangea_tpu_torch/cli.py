"""CLI of the PyTorch/CUDA port.

    python -m pangea_tpu_torch.cli gen-testdata --out dir/ [--reads N ...]
    python -m pangea_tpu_torch.cli build --refs refs.fasta \\
        --taxonomy taxonomy.tsv --k 21 --out idx/
    python -m pangea_tpu_torch.cli classify --index idx/ [idx2/ ...] \\
        --reads r1.fq [--mates r2.fq] [--samples s] [--out dir] \\
        [--config run.json] [--device cuda] [--resume] [key.dotted=value ...]
    python -m pangea_tpu_torch.cli report --assignments a.assign.tsv ... \
        --taxonomy idx/taxonomy.npz --out-dir dir/ [--samples s ...]

The subcommands and flags are those of ``pangea-tpu``; ``gen-testdata`` and
``build`` (in memory, or out of core into a sharded container with
``--ooc-shards N``) write the same files as the reference's (host code
only). For ``classify``, every argument after
the known ones is a dotted config override (``config.py``), e.g.
``input.batch_size=8192``. Several indexes (built on one taxonomy) are
classified together and merged per read (SEMANTICS.md §9), as config 4
does with k=21 and k=31. ``--device`` names the torch device (default
``cuda``); there is no fallback to another device.

As the reference's CLI, a run takes the fast path (the native reader's
packed rows; reads past ``input.max_read_len`` are cut and counted) unless
``input.long_reads=true``, ``PANGEA_NO_NATIVE`` or a barcode longer than
32 bases, which take the general path (long reads classified whole in
length buckets). Both paths trim (``trim.min_qual``, ``trim.window``,
``trim.min_len``, ``trim.max_len``), demultiplex (``demux.barcodes``,
``demux.max_mismatch``) and resume (``--resume``: the outputs of a run cut
short, by either package's CLI, are completed from its ``manifest.json``).
The run names its path on stderr, and its result line, printed last on
stdout (and written to ``run_summary.json``), carries ``fast_path`` and
``truncated_reads``. ``report`` writes the summaries, the cohort table and
``stats.json`` of existing assignment files, as the reference's does (host
code only).
"""
from __future__ import annotations

import argparse
import json
import re
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pangea-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a k-mer index from references")
    b.add_argument("--refs", nargs="+", required=True,
                   help="reference genome FASTA file(s)")
    b.add_argument("--taxonomy", required=True,
                   help="taxonomy TSV/NPZ, or nodes.dmp with --names-dmp")
    b.add_argument("--names-dmp", default=None)
    b.add_argument("--taxid-map", default=None,
                   help="2-column TSV: seqid taxid")
    b.add_argument("--k", type=int, default=21)
    b.add_argument("--minimizer-w", type=int, default=1)
    b.add_argument("--load-factor", type=float, default=0.5)
    b.add_argument("--ways", type=int, default=16, help="bucket width")
    b.add_argument("--ooc-shards", type=int, default=0,
                   help="out-of-core build into N hash-range shards "
                        "(bounded RAM; RefSeq scale). 0 = in-memory")
    b.add_argument("--parts-per-shard", type=int, default=8)
    b.add_argument("--spill-dir", default=None,
                   help="spill directory for --ooc-shards (default: temp "
                        "dir next to --out)")
    b.add_argument("--out", required=True)

    g = sub.add_parser("gen-testdata",
                       help="synthetic taxonomy/genomes/reads with truth")
    g.add_argument("--out", required=True)
    g.add_argument("--reads", type=int, default=10000)
    g.add_argument("--read-len", type=int, default=150)
    g.add_argument("--genome-len", type=int, default=20000)
    g.add_argument("--paired", action="store_true")
    g.add_argument("--n-prob", type=float, default=0.005)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--bulk", action="store_true",
                   help="vectorized streaming generator; writes truth.npy")
    g.add_argument("--n-samples", type=int, default=0,
                   help="with --bulk: pool N barcoded samples into one "
                        "file; writes barcodes.tsv")
    g.add_argument("--n-phyla", type=int, default=2)
    g.add_argument("--genera-per-phylum", type=int, default=2)
    g.add_argument("--species-per-genus", type=int, default=3)

    c = sub.add_parser("classify", help="classify reads against an index")
    c.add_argument("--config", default=None, help="RunConfig JSON")
    c.add_argument("--index", nargs="+", default=None, help="index dir(s)")
    c.add_argument("--reads", nargs="+", default=None)
    c.add_argument("--mates", nargs="+", default=None,
                   help="mate-2 files (paired-end)")
    c.add_argument("--samples", nargs="+", default=None)
    c.add_argument("--out", default=None)
    c.add_argument("--resume", action="store_true")
    c.add_argument("--device", default="cuda",
                   help="torch device to classify on (default cuda)")
    c.add_argument("overrides", nargs="*",
                   help="dotted config overrides key.path=value")

    r = sub.add_parser("report", help="summaries from assignment TSVs")
    r.add_argument("--assignments", nargs="+", required=True)
    r.add_argument("--samples", nargs="+", default=None)
    r.add_argument("--taxonomy", required=True,
                   help="taxonomy NPZ/TSV, or nodes.dmp with --names-dmp "
                        "(e.g. <index>/taxonomy.npz)")
    r.add_argument("--names-dmp", default=None)
    r.add_argument("--out-dir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "classify":
        _rescue_overrides(args, sys.argv[1:] if argv is None else argv)
    return {"build": _cmd_build, "classify": _cmd_classify,
            "report": _cmd_report, "gen-testdata": _cmd_gen}[args.cmd](args)


# Dotted override shape: section.key=...; every real override has a dot.
_OVERRIDE_RE = re.compile(r"^[A-Za-z_]\w*(\.[A-Za-z_]\w*)+=")


def _rescue_overrides(args, argv) -> None:
    """argparse's greedy nargs='+' options swallow trailing overrides
    (``--samples m input.batch_size=32``): move anything shaped like a
    dotted override back into args.overrides, in original argv order."""
    argv = list(argv or [])
    used: set = set()

    def pos_of(tok):
        for i, a in enumerate(argv):
            if a == tok and i not in used:
                used.add(i)
                return i
        return len(argv) + len(used)

    rescued = []
    for name, val in vars(args).items():
        if name == "overrides" or not isinstance(val, list):
            continue
        keep, moved = [], []
        for v in val:
            (moved if isinstance(v, str) and _OVERRIDE_RE.match(v)
             else keep).append(v)
        if moved:
            setattr(args, name, keep)
            rescued += [(pos_of(v), v) for v in moved]
    rescued.sort(key=lambda t: t[0])
    args.overrides = [v for _, v in rescued] + list(args.overrides)


def _cmd_build(args) -> int:
    from .pipeline import run_build
    run_build(refs=args.refs, taxonomy_path=args.taxonomy, k=args.k,
              out=args.out, w=args.minimizer_w, names_dmp=args.names_dmp,
              taxid_map_path=args.taxid_map, load_factor=args.load_factor,
              ways=args.ways, ooc_shards=args.ooc_shards,
              parts_per_shard=args.parts_per_shard,
              spill_dir=args.spill_dir)
    return 0


def _cmd_gen(args) -> int:
    import os

    import numpy as np

    from .utils import datagen
    os.makedirs(args.out, exist_ok=True)
    tax = datagen.make_taxonomy(
        n_phyla=args.n_phyla, genera_per_phylum=args.genera_per_phylum,
        species_per_genus=args.species_per_genus, seed=args.seed)
    genomes = datagen.make_genomes(tax, genome_len=args.genome_len,
                                   seed=args.seed + 1)
    datagen.write_fasta(os.path.join(args.out, "refs.fasta"), genomes, tax)
    datagen.write_taxonomy_tsv(os.path.join(args.out, "taxonomy.tsv"), tax)
    if args.bulk:
        barcodes = None
        if args.n_samples:
            from .bench import cohort_barcodes
            barcodes = cohort_barcodes(args.n_samples)
            with open(os.path.join(args.out, "barcodes.tsv"), "w") as fh:
                for i, bc in enumerate(barcodes):
                    fh.write(f"sample{i}\t{bc}\n")
        datagen.generate_reads_fastq_bulk(
            os.path.join(args.out, "reads_1.fastq"), genomes, args.reads,
            read_len=args.read_len, paired=args.paired,
            mate_path=os.path.join(args.out, "reads_2.fastq"),
            n_prob=args.n_prob, seed=args.seed + 2, barcodes=barcodes)
    else:
        rs = datagen.sample_reads(genomes, args.reads,
                                  read_len=args.read_len,
                                  paired=args.paired, n_prob=args.n_prob,
                                  seed=args.seed + 2)
        datagen.write_fastq(os.path.join(args.out, "reads_1.fastq"), rs,
                            mate=1)
        if args.paired:
            datagen.write_fastq(os.path.join(args.out, "reads_2.fastq"),
                                rs, mate=2)
        np.savetxt(os.path.join(args.out, "truth.tsv"),
                   np.column_stack([np.arange(len(rs.truth)), rs.truth]),
                   fmt="%d", delimiter="\t", header="read_idx\ttaxid")
    print(f"wrote {args.reads} reads ({'paired' if args.paired else 'single'}"
          f"-end), {len(genomes)} genomes, {tax.num_taxa} taxa -> {args.out}")
    return 0


def _cmd_report(args) -> int:
    """Summaries, the cohort table (several files, in their order) and
    stats.json of existing assignment files."""
    import os

    import numpy as np

    from .pipeline.run import default_sample_names, load_taxonomy_any
    from .report import (read_assignments, summarize, write_cohort_summary,
                         write_summary)
    from .report import stats as report_stats
    tax = load_taxonomy_any(args.taxonomy, names_dmp=args.names_dmp)
    os.makedirs(args.out_dir, exist_ok=True)
    samples = args.samples or default_sample_names(args.assignments)
    sample_taxa = {}
    stats_out = {}
    for sample, path in zip(samples, args.assignments):
        taxa = np.array([r.taxon for r in read_assignments(path)],
                        dtype=np.int64)
        sample_taxa[sample] = taxa
        write_summary(os.path.join(args.out_dir, f"{sample}.summary.tsv"),
                      taxa, tax)
        direct, _ = summarize(taxa, tax)
        stats_out[sample] = report_stats.sample_stats(direct[1:])
    if len(sample_taxa) > 1:
        write_cohort_summary(os.path.join(args.out_dir,
                                          "cohort.summary.tsv"),
                             sample_taxa, tax, sample_order=samples)
    with open(os.path.join(args.out_dir, "stats.json"), "w") as fh:
        json.dump(stats_out, fh, indent=2, sort_keys=True)
    return 0


def _cmd_classify(args) -> int:
    from .config import load_config
    from .pipeline import run_classify_basic
    from .utils import device_from
    device = device_from(args.device)
    cfg = load_config(args.config, args.overrides)
    if args.index:
        cfg.classify.index = args.index
    if args.reads:
        cfg.input.reads = args.reads
    if args.mates:
        cfg.input.mates = args.mates
    if args.samples:
        cfg.input.samples = args.samples
    if args.out:
        cfg.classify.out_dir = args.out
    if args.resume:
        cfg.classify.resume = True
    result = run_classify_basic(cfg, device)
    print(json.dumps(result, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
