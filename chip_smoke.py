#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's classify paths on one GPU.

Run from the root of the repository, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases 1-6 drive the q8 headline (the reference bench's world: k=21,
minimizer w=8, a 16384 x 128 q8 table); phases 7-10 drive the std layout
with binary-lifting LCA on the same genomes hung on a 66,563-taxon tree
(k=21, w=1: 2.0M k-mers in a std table of 131,072 wide 768 B rows); phases
11-14 drive config 4's multi-k consensus on the bench's species at 64 kb
genomes (a k=21, w=8 q8 index of 32,768 rows and a k=31, w=1 q12 index of
2.56M k-mers in 131,072 rows of 512 B, 67.1 MB, merged on the card);
phases 15-18 drive the CLI's two read paths on the std world: long reads
in length buckets with the ranked pscore (K8), and the fast path's packed
rows (K1's packed form); phases 19-23 drive the deep-table path (B15) on the
reference bench's deep world (24 genomes of 700 kb, k=21, w=1: 14.0M
k-mers), built by the port's own `build` CLI, whose q8 table of 524,288
rows (268 MB, five times the L2) takes the sorted lookup: K9 sorts the
probes by bucket, then the sorted form of K2 (or K4) probes them; phases
24-28 drive config 3's sharded index, and phases 29-31 the repository's
Pallas experiments (B16: K11-K13) through the port's `experiments` entry
points. The CLI runs of phases 5, 9, 13, 18 and 22 take the fast path
(the native reader, built with g++ from the checkout), phase 17's the
general path:

  1. device check: torch and CUDA versions, the card's name and power limit;
  2. build: one nvcc a source of src/pangea_tpu_torch/csrc, all at once,
     then one link;
  3. K1-K3 against their plain PyTorch versions, bit for bit, at the bench
     shapes (16384 pairs of 150 bp reads), plus K2 on a table with a forced
     stash and K3 at two thresholds; mismatches and times;
  4. the q8 Classifier on that batch: every kernel's launch count, the
     outputs against the plain path and the reads' planted truth, and the
     step time of both paths by CUDA events;
  5. the q8 main path as a user drives it: `python -m pangea_tpu_torch.cli
     classify` on config 2's file and 24,576 pairs in three batches of
     8192 (the fast path), with its kernel launches, its lines against
     phase 4's outputs, and its host time by phase;
  6. torch.profiler over back-to-back q8 steps: the device time of each
     kernel and the device's busy share of the wall;
  7. K4, K3's taxon form and K5 against their plain versions, bit for bit:
     K4 on the wide table with 16384 pairs x 260 probes, on the k=31
     packed table and on a table with a forced stash; K3-taxon and K5 at
     two thresholds; K5 also on a 5,251-taxon q8 world and on a 5,000-node
     chain (13 lifting levels);
  8. the std Classifier at full width: launch counts of K1, K4, K3 and K5,
     the outputs against the plain path and the planted truth, step times;
  9. the CLI on the std index (written by the port's Index.save) with
     config 2's file and 24,576 pairs, its lines against phase 8's outputs;
 10. torch.profiler over back-to-back std steps;
 11. K2's q12 form and K7 against their plain versions, bit for bit: K2-q12
     on the 67.1 MB table with 16384 pairs x 240 probes, on a table with a
     forced stash, on absent 62-bit keys and on a forced-q12 table at k=21
     (remainder below 32 bits); K7 on the full-width calls at thresholds 0
     and 0.05, on the int32 extreme cases, on conflicting pairs of the
     66,563-taxon tree and of the 5,000-node chain;
 12. the multi-k step at full width: launch counts (K1 four times, K2 and
     its q12 form, K3 twice, K7), the outputs against the plain path and
     the planted truth, step times;
 13. the CLI on the two indexes (written by the port's Index.save) with
     config 4's file and 24,576 pairs, its lines against phase 12's;
 14. torch.profiler over back-to-back multi-k steps;
 15. K8 and K1's packed form against their plain versions, bit for bit: K8
     at R = 2,049 (512 reads), 16,364 (75 reads: one read of the 16,384
     bucket, sorted in shared memory) and 32,728 (75 pairs of that bucket,
     sorted in a device scratch), q8 and taxon forms, with the direct LCA
     (the headline's 67-taxon tree) and K5's lifting (66,563 taxa), at two
     thresholds; K1's packed form on the headline pairs as the native
     reader packs them (w=8 and w=1), held to its plain version and to K1
     on the codes;
 16. the long-read step on the std world: one FASTQ of the bench's first
     8,192 first mates and 2,048 single-end genome slices of 1,000-20,000
     bases (log-uniform), each of the CLI's launches (the bucket shapes)
     through the Classifier: launch counts (K8 at 2,400 bases and more, K3
     below), the outputs against the plain path and the planted lineage,
     each bucket's step time;
 17. the CLI on that FASTQ with input.long_reads=true (the general path):
     its lines against phase 16's, truncated_reads (reads past 16,384
     bases), reads/s and host time by phase;
 18. the CLI on that FASTQ on the fast path: every read past 150 bases cut
     and counted, the 8,192 short reads' lines against phase 17's;
 19. the deep world built with `python -m pangea_tpu_torch.cli build` from
     its FASTA and taxonomy TSV (the process starts after phase 2 and runs
     beside phases 3-18), loaded, and laid out as q8 (its own layout), q12
     (1,048,576 rows of 512 B) and std (4,194,304 packed rows of 256 B);
 20. K9 and the sorted forms against their plain versions, bit for bit: K9
     is a permutation whose keys ascend as the plain sort's; the sorted q8
     and q12 forms on the deep tables with the 2,129,920 probes of 16,384
     reads, the std form with the 8,519,680 probes of 65,536 reads (and the
     unsorted K2, K2-q12 and K4 on the same probes, timed in the same
     call), K4's sorted form on the wide std world's table; K2-q12's sorted
     form also on config 4's k=31 table (phase 11);
 21. the deep steps through the Classifier: q8 and q12 on 16,384 reads, std
     on 65,536 (where the std gate engages): launch counts (K1, K9 and the
     sorted form; no unsorted lookup), the outputs against the plain path
     and the planted lineage, step times; then each with PANGEA_DEEP_SORT=0
     (the unsorted lookup) in the same call;
 22. the CLI on the deep index (the fast path, one batch of 16,384
     single-end reads): its launches, its lines against phase 21's;
 23. torch.profiler over back-to-back q8 deep steps;
 24. config 3's index: the deep FASTA built out of core in 4 shards by
     `cli build --ooc-shards 4` (started beside phases 3-18, with config
     3's reads), its pairs, one-shard table and q8 relayout held to phase
     19's index;
 25. K10 (the routing bin) on the deep probes at 2, 4 and 8 owners and with
     a forced overflow (cap_frac 0.01), K9's restore on its records, and
     K4's owner mask on the wide std table at 4 shards, every shard: each
     against its plain version, timed beside its bound;
 26. the multi-rank steps: four rank processes (this script with `--rank
     R SPEC`) on the one card, joined over gloo with their tensors on the
     card, at meshes (1, 4) and (2, 2): the deep 4-shard index (streamed a
     file shard a rank at (1, 4), merged at (2, 2)) on 65,536 reads,
     broadcast, routed and routed with a forced overflow; the wide std
     world, one shard a rank, on 16,384 pairs, broadcast and routed. Each
     rank's gathered outputs against the one-rank step's; step times;
     torch.profiler on rank 0 over routed deep steps;
 27. a one-rank NCCL world: the (1, 1) sharded step, whose merge is NCCL's
     all-reduce on the card, against phase 21's q8 step;
 28. config 3's CLI: `--config configs/config3_shotgun_sharded.json` on the
     4-shard index (one card: mesh (1, 1), one q8 table) with 1,048,576
     single-end reads in four batches of 262,144, its first 16,384 lines
     against the one-rank step at config 3's threshold, reads/s;
 29. K11 and K12 (the Pallas row probe of experiments/mb_pallas.py)
     against their plain versions, bit for bit: K11 on the experiment's
     world (a 16,384 x 128 table, 524,288 queries, seed 0), on a
     65,536-row table (past one wave of blocks) and at W = 32; K12 on the
     same world and on a 1,024-row table, every query; timed, and K12's
     one-hot product set against the int8 peak;
 30. K13 (the Pallas row gathers of experiments/mb_gather2-5.py) in every
     variant of `experiments.mb_gather` at the scripts' shapes (a [2^19,
     64] uint32 table of 134.2 MB, 2^20 or 2^19 indices, each (depth,
     chunk), staged and direct; mb_gather4's 8-row block copies), against
     row_gather_plain and timed beside torch.index_select, each variant's
     ratio to it on a line of its own and in its kernel's `variants` map;
 31. `python -m pangea_tpu_torch.experiments.mb_pallas` and `... .mb_gather`
     as a user runs them: their lines at 0 mismatches, their launches;
 32. the launch summary.

The plain paths are held to the JAX reference and its golden model by the
CPU tests (tests/test_torch_classify.py, tests/test_torch_std.py,
tests/test_torch_q12.py, tests/test_torch_merge.py, and for the sharded
steps tests/test_torch_dist.py), and the kernels to the
golden model on the card by tests/test_torch_gpu.py. This
script imports nothing but the standard library, torch and
pangea_tpu_torch.

Bounds: a kernel's bound_ms is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its 32-bit integer
operations, counted from this run's inputs, over 67 T/s (the H100 SXM's
non-tensor 32-bit peak, an optimistic rate for integer work). A table
counts only what this run's probes need: the key lanes of the buckets they
reach, the payload lanes of the keys they hit and the stash (K2, K2-q12,
K4; never the pad lanes); for K5 and K7, the depth, parent and lifting
entries of the lineages its pairs (K7: its conflicting pairs) reach, beside
their [B] inputs and outputs. K8's operations are the least a sort
needs: R log2 R compares for each of the read's two sorts, and log2 R steps
for each of a hit's two ranks. K9's bytes are its probes' lanes read once
and its 16-byte records and inverse permutation written once, its
operations a key a probe; a sorted form reads the records and the inverse
in place of the probes' lanes and writes the outputs. K10 reads a
probe's 9 bytes and writes its slot (4 bytes) and the [S, C] grid of
16-byte records once; its restore reads a slot and a 16-byte answer and
writes 12 bytes a probe; K4's masked form reads every probe's lanes and
writes its outputs, and touches the table only for the probes it owns.
K11 and K12 read the table once and 8 B and write 4 B a query, with 2W
operations a query; K12's one-hot product is also logged against the
1,979 T/s dense int8 tensor-core peak. K13 reads and writes each row once
and reads 4 B an index. library_ms is one PyTorch call of the same
function, timed and used nowhere in the port: torch.index_select for K13's
gathers, narrow().clone() for its block copy, and null for the kernels
that no one PyTorch call computes.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Any failed phase raises and the exit
code is non-zero; so it is without a CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
BATCH, READ_LEN = 16384, 150
# The worlds (make_bench_world arguments): the q8 headline, the std main
# path on the 66,563-taxon tree, the k=31 packed std table and q8 beyond
# 4,096 taxa.
HEADLINE = {"k": 21, "w": 8}
WIDE = {"k": 21, "w": 1, "tree": (512, 64)}
PACKED = {"k": 31, "w": 8}
Q8_LIFT = {"k": 21, "w": 1, "tree": (64, 40)}
# Config 4's world (make_multik_world arguments) and its threshold.
MULTIK = {"genome_len": 64_000, "indexes": ((21, 8), (31, 1))}
C4_THRESHOLD = 0.05
CHAIN_NODES = 5000
CLI_PAIRS, CLI_BATCH = 24576, 8192
WARMUP, REPS = 3, 20
PLAIN_REPS = 5           # samples of a plain version at the std shapes
PIPELINED = 10           # back-to-back calls a timing sample
PROFILE_STEPS = {"q8": 100, "std": 20, "multik": 20, "deep": 20, "mesh": 5}
MAX_OFF_LINEAGE = 0.001  # share of reads assigned off their truth's lineage
# K8's checks: (probes a read, reads): a read just past K3's 2,048, one
# read and one pair of the 16,384-base bucket (75 reads a launch).
RANKED_SHAPES = ((2049, 512), (16364, 75), (32728, 75))
# The long-read FASTQ: the bench's first LONG_SHORT first mates, then
# LONG_READS genome slices of log-uniform length; reads past MAX_LONG
# bases (input.max_long_read_len, its default) are cut.
LONG_SHORT, LONG_READS, LONG_MIN, LONG_MAX, LONG_SEED = (8192, 2048, 1_000,
                                                         20_000, 16)
MAX_LONG = 16384
# The deep world (bench.deep_genomes, bench.deep_reads): its q8 and q12
# steps take DEEP_READS single-end reads, its std step DEEP_STD_READS, where
# the std gate engages (a chunk of 32,768).
DEEP_GENOME_LEN, DEEP_K = 700_000, 21
DEEP_READS, DEEP_STD_READS = 16384, 65536
# Config 3 (phases 24-28): the deep index built out of core in OOC_SHARDS
# shards; K10 at ROUTE_SHARDS owners; MESH_RANKS rank processes on the one
# card over gloo, at each of MESH_SHAPES; config 3's CLI on C3_READS reads
# (its file's batches of 262,144), the deep reads' seed.
OOC_SHARDS = 4
ROUTE_SHARDS = (2, 4, 8)
MESH_RANKS = 4
MESH_SHAPES = ((1, 4), (2, 2))
MESH_REPS = 5            # timed steps of each multi-rank case
C3_READS = 1_048_576
THRESHOLDS = (0.0, 0.05)
# The Pallas experiments (phases 29-31): K11 on mb_pallas's world and on a
# table of PROBE_TALL_NB rows (past one wave of blocks); K12 on the same
# world and on a table of ONEH_SMALL_NB rows, every query. K13's variants
# are the entry point's own (experiments.mb_gather.VARIANTS);
# PRIMARY_GATHERS name the variant whose numbers each K13 wrapper's entry
# of the kernels line carries; its `variants` map carries every variant's.
PROBE_TALL_NB = 65536
ONEH_SMALL_NB = 1024
PRIMARY_GATHERS = ("gather2_d16_c512", "gather5_hbm2hbm_d16_c4096",
                   "gather4_dynamic")
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12   # dense int8 tensor cores: K12's product line
# name -> (kernel source, the reference function it replaces)
KERNELS = {
    "extract_probes": ("src/pangea_tpu_torch/csrc/extract_probes.cu",
                       "src/pangea_tpu/kernels/encode.py:100"),
    "lookup_q8": ("src/pangea_tpu_torch/csrc/lookup_q8.cu",
                  "src/pangea_tpu/kernels/lookup.py:710"),
    "score_tin": ("src/pangea_tpu_torch/csrc/score_tin.cu",
                  "src/pangea_tpu/kernels/score.py:237"),
    "lookup_std": ("src/pangea_tpu_torch/csrc/lookup_std.cu",
                   "src/pangea_tpu/kernels/lookup.py:94"),
    "score_taxon": ("src/pangea_tpu_torch/csrc/score_tin.cu",
                    "src/pangea_tpu/kernels/score.py:221"),
    "lca_lift": ("src/pangea_tpu_torch/csrc/lca_lift.cu",
                 "src/pangea_tpu/kernels/score.py:127"),
    "lookup_q12": ("src/pangea_tpu_torch/csrc/lookup_q8.cu",
                   "src/pangea_tpu/kernels/lookup.py:629"),
    "merge_multik": ("src/pangea_tpu_torch/csrc/merge_multik.cu",
                     "src/pangea_tpu/classify/merge.py:39"),
    "score_ranked": ("src/pangea_tpu_torch/csrc/score_ranked.cu",
                     "src/pangea_tpu/kernels/score.py:71"),
    "extract_packed": ("src/pangea_tpu_torch/csrc/extract_probes.cu",
                       "src/pangea_tpu/kernels/encode.py:129"),
    "bucket_sort": ("src/pangea_tpu_torch/csrc/bucket_sort.cu",
                    "src/pangea_tpu/kernels/lookup.py:300"),
    "lookup_q8_sorted": ("src/pangea_tpu_torch/csrc/lookup_q8.cu",
                         "src/pangea_tpu/kernels/lookup.py:354"),
    "lookup_q12_sorted": ("src/pangea_tpu_torch/csrc/lookup_q8.cu",
                          "src/pangea_tpu/kernels/lookup.py:354"),
    "lookup_std_sorted": ("src/pangea_tpu_torch/csrc/lookup_std.cu",
                          "src/pangea_tpu/kernels/lookup.py:389"),
    "lookup_std_owned": ("src/pangea_tpu_torch/csrc/lookup_std.cu",
                         "src/pangea_tpu/kernels/lookup.py:117"),
    "route_bin": ("src/pangea_tpu_torch/csrc/bucket_sort.cu",
                  "src/pangea_tpu/dist/mesh.py:371"),
    "route_restore": ("src/pangea_tpu_torch/csrc/bucket_sort.cu",
                      "src/pangea_tpu/dist/mesh.py:450"),
    "rowprobe_smem": ("src/pangea_tpu_torch/csrc/rowprobe_smem.cu",
                      "experiments/mb_pallas.py:83"),
    "rowprobe_onehot": ("src/pangea_tpu_torch/csrc/rowprobe_onehot.cu",
                        "experiments/mb_pallas.py:118"),
    "row_gather": ("src/pangea_tpu_torch/csrc/row_gather.cu",
                   "experiments/mb_gather2.py:119, experiments/mb_gather3.py"
                   ":93, experiments/mb_gather5.py:88"),
    "row_gather_direct": ("src/pangea_tpu_torch/csrc/row_gather.cu",
                          "experiments/mb_gather5.py:36"),
    "block_copy": ("src/pangea_tpu_torch/csrc/row_gather.cu",
                   "experiments/mb_gather4.py:86, experiments/mb_gather4.py"
                   ":106"),
}
# The int32 extreme cases of tests/test_hardening.py:28-38: (taxon, best,
# nvalid) of the two calls, products beyond int32.
BIG = 2**30
MERGE_EXTREMES = [
    ((3, BIG, BIG + 1), (3, BIG + 1, BIG)),
    ((3, BIG + 1, BIG), (3, BIG, BIG + 1)),
    ((3, BIG, BIG), (5, BIG - 1, BIG)),
    ((5, BIG - 1, BIG), (3, BIG, BIG)),
    ((3, 70000, 70001), (3, 70000, 70001)),
    ((0, 0, 40000), (7, 123, 70000)),
    ((0, 0, 50000), (0, 0, 60000)),
    ((3, 2**31 - 1, 2**31 - 1), (5, 2**31 - 2, 2**31 - 1)),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, calls: int = 1, reps: int = REPS) -> float:
    """ms per call of fn: the median over `reps` samples, after WARMUP
    calls, of the CUDA-event time of `calls` back-to-back calls, divided by
    `calls`. calls=1 is the latency of one call, host launch overhead
    included; calls=PIPELINED keeps the card fed, so a call that the host
    enqueues faster than the card runs it reads as device time."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def compare(want, got) -> tuple[int, int]:
    """(mismatching elements, max |difference|) over tensor tuples."""
    mism, err = 0, 0
    for a, b in zip(want, got):
        a, b = a.long(), b.long()
        if a.shape != b.shape:
            raise AssertionError(
                f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
        mism += int((a != b).sum())
        if a.numel():
            err = max(err, int((a - b).abs().max()))
    return mism, err


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for the bytes a
    function must move and the integer operations it must do."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


class Results:
    """Per-kernel mismatches, errors, times and bounds of this run."""

    def __init__(self):
        self.k = {name: {"mismatches": 0, "max_abs_err": 0,
                         "library_ms": None} for name in KERNELS}

    def check(self, name: str, what: str, want, got) -> None:
        mism, err = compare(want, got)
        r = self.k[name]
        r["mismatches"] += mism
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"[{what}] {name}: mismatches {mism}, max abs error {err}")

    def time(self, torch, name: str, what: str, kernel, plain, nbytes,
             ops, plain_calls: int = PIPELINED, plain_reps: int = REPS,
             library=None, primary: bool = True,
             variant: str | None = None) -> float:
        """Kernel ms (PIPELINED calls a sample), plain ms and the bound,
        and the ms of ``library``, one PyTorch call of the same function
        (timed, never used). ``primary`` False only logs them; a
        ``variant`` also goes into the kernel's ``variants`` map. Returns
        the kernel ms."""
        ms = time_ms(torch, kernel, PIPELINED)
        plain_ms = time_ms(torch, plain, plain_calls, plain_reps)
        library_ms = (None if library is None
                      else time_ms(torch, library, PIPELINED))
        bound_ms, by = bound(nbytes, ops)
        if primary:
            self.k[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=by, library_ms=library_ms)
        if variant is not None:
            self.k[name].setdefault("variants", {})[variant] = {
                "ms": ms, "library_ms": library_ms, "bound_ms": bound_ms}
        log(f"[{what}] {name}: kernel {ms} ms, plain {plain_ms} ms, "
            f"library {library_ms} ms, bound {bound_ms} ms ({by}: "
            f"{nbytes:.0f} B, {ops:.0f} ops)")
        return ms

    def assert_clean(self, names) -> None:
        bad = [n for n in names if self.k[n]["mismatches"]]
        if bad:
            raise AssertionError(f"kernels disagree with their plain "
                                 f"versions: {bad}")


def phase_device(torch) -> str:
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)                         # name, power limit: as nvidia-smi says
    return card


def phase_build() -> None:
    from pangea_tpu_torch.kernels import _build
    t0 = time.time()
    _build.library()
    log(f"[2] built {_build.build()} in {time.time() - t0:.1f} s")


def _batches(torch, cuda, reads, n_reads: int) -> dict:
    from pangea_tpu_torch.classify import pad_batch
    n = min(BATCH, n_reads)
    return {"b1": torch.from_numpy(pad_batch(reads.seqs[:n], n,
                                             READ_LEN)).to(cuda),
            "b2": torch.from_numpy(pad_batch(reads.mates[:n], n,
                                             READ_LEN)).to(cuda)}


def make_world(torch, cuda, name: str, n_reads: int, **kw) -> dict:
    """A bench world with one index: its Classifier (model), the plain path
    (plain) and config 2's file for the CLI."""
    from pangea_tpu_torch.bench import make_bench_world
    from pangea_tpu_torch.classify import (Classifier, DeviceIndex,
                                           classify_reads)
    t0 = time.time()
    bw = make_bench_world(n_reads=n_reads, read_len=READ_LEN, **kw)
    di = DeviceIndex.from_index(bw.index, cuda, 0.0)
    model = Classifier(di)
    world = {"name": name, "idx": bw.index, "idxs": [bw.index],
             "reads": bw.reads, "genomes": bw.genomes, "di": di,
             "tax": di.tax, "model": model,
             "plain": lambda b1, b2: classify_reads(
                 model.index.tables, b1, model.cfg, mate_bases=b2,
                 plain=True),
             "config": "config2_16s_paired.json",
             **_batches(torch, cuda, bw.reads, n_reads)}
    log(f"[3] world {name} in {time.time() - t0:.1f} s: {bw.index!r}, "
        f"{bw.taxonomy.num_taxa} taxa, {di.cfg.layout} table "
        f"{tuple(di.fused.shape)} ({di.fused.numel() * 4} B), stash "
        f"{di.stash.shape[1]}")
    return world


def make_multik(torch, cuda, n_reads: int) -> dict:
    """Config 4's world: both indexes at config 4's threshold, the
    MultiKClassifier (model), its plain path and config 4's file."""
    from pangea_tpu_torch.bench import make_multik_world
    from pangea_tpu_torch.classify import (DeviceIndex, MultiKClassifier,
                                           classify_multik)
    t0 = time.time()
    mw = make_multik_world(n_reads=n_reads, read_len=READ_LEN, **MULTIK)
    dis = [DeviceIndex.from_index(ix, cuda, C4_THRESHOLD)
           for ix in mw.indexes]
    if [d.cfg.layout for d in dis] != ["q8", "q12"]:
        raise AssertionError(f"layouts {[d.cfg.layout for d in dis]}, want "
                             "q8 and q12")
    model = MultiKClassifier(dis)
    tables = tuple(c.index.tables for c in model.classifiers)
    cfgs = tuple(c.cfg for c in model.classifiers)
    world = {"name": "config4", "idxs": mw.indexes, "reads": mw.reads,
             "dis": dis, "tax": dis[0].tax, "model": model,
             "plain": lambda b1, b2: classify_multik(
                 tables, b1, cfgs, mate_bases=b2, plain=True),
             "config": "config4_multik.json",
             **_batches(torch, cuda, mw.reads, n_reads)}
    for ix, di in zip(mw.indexes, dis):
        log(f"[11] world config4 index {ix!r}: {di.cfg.layout} table "
            f"{tuple(di.fused.shape)} ({di.fused.numel() * 4} B), stash "
            f"{di.stash.shape[1]}")
    log(f"[11] world config4 in {time.time() - t0:.1f} s, "
        f"{mw.taxonomy.num_taxa} taxa")
    return world


def probes(torch, world, k: int, w: int, fn=None):
    """The probes (hi, lo, valid) [B, R] of a world's batch, both mates (or
    b1 alone where b2 is None), by K1 or by ``fn`` (its plain version)."""
    from pangea_tpu_torch.kernels import extract_probes
    from pangea_tpu_torch.kernels.minimize import probe_width
    nw = probe_width(READ_LEN, k, w)
    mates = [b for b in (world["b1"], world["b2"]) if b is not None]
    shape = (mates[0].shape[0], len(mates) * nw)
    dev = mates[0].device
    out = (torch.empty(shape, dtype=torch.int32, device=dev),
           torch.empty(shape, dtype=torch.int32, device=dev),
           torch.empty(shape, dtype=torch.bool, device=dev))
    for m, b in enumerate(mates):
        (fn or extract_probes)(b, k, w, out, m * nw)
    return out


def table_bytes(di) -> int:
    return (di.fused.numel() + di.stash.numel()) * 4


def touched_bytes(torch, bucket, valid, hit, hi, lo, key_lanes: int,
                  payload_lanes: int, stash) -> int:
    """Bytes of a hash table that these probes need: the key lanes of every
    bucket a valid probe reaches, the payload lanes of every distinct key
    that hits, and the whole stash (every valid probe scans it)."""
    rows = torch.unique(bucket[valid]).numel()
    keys = (hi[hit].long() << 32) | (lo[hit].long() & 0xFFFFFFFF)
    return 4 * (rows * key_lanes + torch.unique(keys).numel() * payload_lanes
                + stash.numel())


def lineage_bytes(torch, u, v, tax: dict) -> int:
    """Bytes of the taxonomy that LCA lifting of (u, v) needs: the depth,
    parent and lifting-table entries of every node on the lineages of the
    nonzero u and v."""
    parent = tax["parent"].long()
    nodes = torch.unique(torch.cat([u, v]).long())
    nodes = nodes[nodes != 0]
    while True:
        grown = torch.unique(torch.cat([nodes, parent[nodes]]))
        if grown.numel() == nodes.numel():
            break
        nodes = grown
    return 4 * nodes.numel() * (tax["up"].shape[0] + 2)


def phase_q8_kernels(torch, world, cuda, res: Results) -> None:
    from pangea_tpu_torch.index import relayout_q8
    from pangea_tpu_torch.kernels import (extract_probes_plain, fuse_stash,
                                          lookup_q8, lookup_q8_plain,
                                          score_reads_tin,
                                          score_reads_tin_plain)
    from pangea_tpu_torch.kernels.lookup import _q8_geometry, _q8_split, widen
    k, w = HEADLINE["k"], HEADLINE["w"]
    idx, di = world["idx"], world["di"]
    hi, lo, valid = probes(torch, world, k, w)
    R = hi.shape[1]
    res.check("extract_probes", "3",
              probes(torch, world, k, w, extract_probes_plain),
              (hi, lo, valid))
    windows = BATCH * R
    res.time(torch, "extract_probes", "3",
             lambda: probes(torch, world, k, w),
             lambda: probes(torch, world, k, w, extract_probes_plain),
             nbytes=2 * BATCH * READ_LEN + windows * 9,
             ops=windows * ((w + k - 1) * 8 + w * 18))

    hi, lo, valid = (t.reshape(-1) for t in (hi, lo, valid))
    fused, stash = di.fused, di.stash
    want = lookup_q8_plain(hi, lo, valid, fused, stash, k)
    res.check("lookup_q8", "3", want, lookup_q8(hi, lo, valid, fused,
                                                 stash, k))
    log(f"[3] lookup_q8: {hi.numel()} probes on {tuple(fused.shape)}, "
        f"stash {stash.shape[1]}, hits {int((want[0] != 0).sum())}")
    # A table with a forced stash, probed by the batch and by every key of
    # its stash, so that both the rows and the stash hit.
    tax = idx.taxonomy
    f4, s4, _ = relayout_q8(idx, ways=4, load_factor=2.0)
    f4 = torch.from_numpy(f4[0].view("int32")).to(cuda)
    s4 = torch.from_numpy(fuse_stash(s4[0], tax.tin, tax.tout)
                          .view("int32")).to(cuda)
    if s4.shape[1] == 0:
        raise AssertionError("the forced-stash table has an empty stash")
    hi4, lo4 = torch.cat([hi, s4[0]]), torch.cat([lo, s4[1]])
    v4 = torch.cat([valid, torch.ones(s4.shape[1], dtype=torch.bool,
                                      device=cuda)])
    want4 = lookup_q8_plain(hi4, lo4, v4, f4, s4, k)
    res.check("lookup_q8", "3 forced stash", want4,
              lookup_q8(hi4, lo4, v4, f4, s4, k))
    stash_hits = int((want4[0][hi.numel():] != 0).sum())
    log(f"[3] lookup_q8 forced stash: {tuple(f4.shape)}, stash "
        f"{s4.shape[1]}, {stash_hits} stash keys hit")
    if stash_hits != s4.shape[1]:
        raise AssertionError("a stash key missed its own stash")
    N = hi.numel()
    log2nb, W = _q8_geometry(fused, k)
    bucket, _ = _q8_split(widen(hi), widen(lo), k, log2nb)
    need = touched_bytes(torch, bucket, valid, want[0] != 0, hi, lo, W, 1,
                         stash)
    log(f"[3] lookup_q8 touches {need} B of its {table_bytes(di)} B table")
    res.time(torch, "lookup_q8", "3",
             lambda: lookup_q8(hi, lo, valid, fused, stash, k),
             lambda: lookup_q8_plain(hi, lo, valid, fused, stash, k),
             nbytes=N * 21 + need, ops=N * (2 * W + 10))

    hit, t_in, t_out = (t.reshape(BATCH, R) for t in want)
    valid2 = valid.reshape(BATCH, R)
    for thr in THRESHOLDS:
        res.check("score_tin", f"3 threshold {thr}",
                  score_reads_tin_plain(hit, t_in, t_out, valid2, di.tax,
                                        thr),
                  score_reads_tin(hit, t_in, t_out, valid2, di.tax, thr))
    T1 = di.tax["tin"].numel()
    res.time(torch, "score_tin", "3",
             lambda: score_reads_tin(hit, t_in, t_out, valid2, di.tax, 0.0),
             lambda: score_reads_tin_plain(hit, t_in, t_out, valid2,
                                           di.tax, 0.0),
             nbytes=BATCH * R * 13 + 12 * T1 + 12 * BATCH,
             ops=int((hit != 0).sum()) * R * 4 + BATCH * T1 * 6)
    res.assert_clean(("extract_probes", "lookup_q8", "score_tin"))


def phase_step(torch, world, card: str, tag: str, want_launches: dict,
               plain_calls: int, plain_reps: int) -> dict:
    """A world's step (its model) on its batch: launch counts, the plain
    path, the planted truth and step times. Returns the outputs on the
    host."""
    from pangea_tpu_torch.kernels import (kernel_launches,
                                          reset_kernel_launches)
    b1, b2 = world["b1"], world["b2"]
    model = world["model"]
    reset_kernel_launches()
    out = model(b1, b2)
    torch.cuda.synchronize()
    launches = kernel_launches()
    log(f"[{tag}] kernel launches in one {world['name']} step: {launches}")
    if launches != want_launches:
        raise AssertionError(f"launches {launches}, want {want_launches}")
    out = {k: v.cpu() for k, v in out.items()}
    for k, v in out.items():
        if v.dtype != torch.int32 or tuple(v.shape) != (BATCH,):
            raise AssertionError(f"{k}: {v.dtype} {tuple(v.shape)}")

    def plain_step():
        return world["plain"](b1, b2)

    plain = plain_step()
    mism, _ = compare([plain[k].cpu() for k in out], list(out.values()))
    log(f"[{tag}] kernel path vs plain path on {BATCH} pairs: mismatches "
        f"{mism}")
    # Planted truth: a classified pair's taxon is its source species or an
    # ancestor of it (genus mates share a core, whose k-mers LCA-merge).
    tin, tout = (world["tax"][n].cpu().long() for n in ("tin", "tout"))
    taxon = out["taxon"].long()
    truth = torch.from_numpy(world["reads"].truth[:BATCH]).long()
    classified = taxon != 0
    on_lineage = (tin[taxon] <= tin[truth]) & (tin[truth] < tout[taxon])
    off = int((classified & ~on_lineage).sum())
    log(f"[{tag}] planted truth: {int(classified.sum())} of {BATCH} pairs "
        f"classified, {off} off their truth's lineage "
        f"({off / BATCH} of the pairs; limit {MAX_OFF_LINEAGE})")
    if mism or off > MAX_OFF_LINEAGE * BATCH or not classified.any():
        raise AssertionError("the classify step disagrees with its references")

    for calls, what in ((1, "one step"), (PIPELINED, "back-to-back steps")):
        step = time_ms(torch, lambda: model(b1, b2), calls)
        plain_ms = time_ms(torch, plain_step, min(calls, plain_calls),
                           plain_reps)
        log(f"[{tag}] {world['name']}, {what}, {BATCH} pairs, on {card}: "
            f"kernel path {step} ms ({BATCH / step * 1e3} reads/s), plain "
            f"path {plain_ms} ms ({BATCH / plain_ms * 1e3} reads/s); median "
            f"of CUDA-event samples of {calls} call(s) (plain: "
            f"{min(calls, plain_calls)})")
    return out


def run_cli(world, tag: str, reads: list, mates: list | None = None,
            extra=(), batch: int = CLI_BATCH) -> tuple[dict, list]:
    """`python -m pangea_tpu_torch.cli classify` on the world's config
    file and indexes (written by the port's Index.save, once a world);
    returns the run's result line and its assignment lines, split."""
    work = ROOT / "build" / "chip_smoke" / world["name"]
    if "idx_dirs" not in world:
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        world["idx_dirs"] = [str(work / f"idx{i}")
                             for i in range(len(world["idxs"]))]
        for ix, d in zip(world["idxs"], world["idx_dirs"]):
            ix.save(d)
    out_dir = work / f"out{tag}"
    cmd = [sys.executable, "-m", "pangea_tpu_torch.cli", "classify",
           "--config", str(ROOT / "configs" / world["config"]),
           "--index", *world["idx_dirs"], "--reads", *reads,
           *(["--mates", *mates] if mates else []), "--samples", "smoke",
           "--out", str(out_dir), "--device", "cuda",
           f"input.batch_size={batch}", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI returned {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[{tag}] CLI process in {time.time() - t0:.1f} s: "
        f"{json.dumps(result)}")
    how = ("threads of the fast path, overlapping" if result["fast_path"]
           else "the general path's one loop")
    log(f"[{tag}] CLI host time by phase ({how}): " + ", ".join(
        f"{k} {v} s ({100 * v / result['wall_sec']} % of the wall)"
        for k, v in result["host_sec"].items()))
    if not (out_dir / "smoke.summary.tsv").exists():
        raise AssertionError("the CLI wrote no summary")
    # Each line: flag, read id, taxon, rank, name, best/nvalid, confidence.
    rows = [line.split("\t") for line in
            (out_dir / "smoke.assign.tsv").read_text().splitlines()]
    return result, rows


def phase_cli(world, out: dict, tag: str, fastq: tuple) -> dict:
    """The CLI on the world's config file, its indexes and 24,576 pairs,
    on the fast path; returns the kernel launches of that run (the CLI's
    own counts, which start at 0 in its process)."""
    result, rows = run_cli(world, tag, [fastq[0]], [fastq[1]])
    launches = result["kernel_launches"]
    if not result["fast_path"] or result["truncated_reads"] \
            or launches["extract_packed"] < 1 or launches["extract_probes"]:
        raise AssertionError("the CLI did not take the fast path with K1's "
                             f"packed form: {json.dumps(result)}")
    reads = world["reads"]
    ids_bad = sum(r[1] != rid for r, rid in zip(rows, reads.ids))
    step_bad = sum(
        (int(r[2]), r[5]) != (int(out["taxon"][i]),
                              f"{int(out['best'][i])}/{int(out['nvalid'][i])}")
        for i, r in enumerate(rows[:BATCH]))
    log(f"[{tag}] {len(rows)} assignment lines; read ids out of order "
        f"{ids_bad}; first {BATCH} vs the step: mismatches {step_bad}")
    if len(rows) != CLI_PAIRS or ids_bad or step_bad:
        raise AssertionError("the CLI's assignments are wrong")
    return launches


def phase_profile(torch, world, card: str, tag: str, steps: int) -> None:
    """Device time of each kernel over back-to-back steps, and the device's
    busy share of their wall (one stream: kernels never overlap, so their
    summed time is the busy time)."""
    from torch.profiler import ProfilerActivity, profile
    model = world["model"]
    b1, b2 = world["b1"], world["b2"]
    for _ in range(WARMUP):
        model(b1, b2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            model(b1, b2)
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    kernels = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = (us / 1e3 / steps, e.count, us / 1e3 / e.count)
    busy = sum(ms for ms, _, _ in kernels.values())
    what = f"{b1.shape[0]} {'reads' if b2 is None else 'pairs'}"
    log(f"[{tag}] torch.profiler, {steps} back-to-back {world['name']} "
        f"steps of {what} on {card}: wall {wall_ms / steps} ms a "
        f"step, device busy {busy} ms a step "
        f"({100 * busy * steps / wall_ms} %)")
    for name, (ms, n, per) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0]):
        log(f"[{tag}]   {ms} ms a step ({100 * ms / busy if busy else 0} % "
            f"of busy), {n} launches recorded in {steps} steps, {per} ms a "
            f"launch: {name[:100]}")
    if not kernels:
        log(f"[{tag}] the profiler recorded no device time")


def chain_tax(torch, cuda) -> dict:
    from pangea_tpu_torch.taxonomy import Taxonomy
    parent = list(range(-1, CHAIN_NODES))
    parent[:2] = [0, 1]
    tax = Taxonomy(parent=parent, rank=[0] * (CHAIN_NODES + 1),
                   names=["unclassified"] + [f"n{i}"
                                             for i in range(CHAIN_NODES)])
    return {k: torch.from_numpy(v).to(cuda)
            for k, v in tax.device_arrays().items()}


def phase_std_kernels(torch, worlds, cuda, res: Results) -> None:
    from pangea_tpu_torch.index import extract_pairs
    from pangea_tpu_torch.index.build import layout_table
    from pangea_tpu_torch.kernels import (fuse_stash, fuse_table, hash32,
                                          lca_lift,
                                          lca_lift_plain, lookup_q8,
                                          lookup_std, lookup_std_plain,
                                          score_reads_taxon,
                                          score_reads_taxon_plain,
                                          score_reads_tin,
                                          score_reads_tin_plain,
                                          score_winners,
                                          score_winners_plain)
    wide, packed, q8l = worlds["wide"], worlds["packed"], worlds["q8_lift"]
    di = wide["di"]
    hi, lo, valid = probes(torch, wide, WIDE["k"], WIDE["w"])
    B, R = hi.shape
    k1_ms = time_ms(torch, lambda: probes(torch, wide, WIDE["k"], WIDE["w"]),
                    PIPELINED)
    log(f"[7] extract_probes at k={WIDE['k']}, w={WIDE['w']}, both mates -> "
        f"[{B}, {R}]: kernel {k1_ms} ms a call")
    flat = [t.reshape(-1) for t in (hi, lo, valid)]
    N = flat[0].numel()
    ways = di.cfg.ways
    want = lookup_std_plain(*flat, di.fused, di.stash, ways)
    res.check("lookup_std", "7 wide", want,
              lookup_std(*flat, di.fused, di.stash, ways))
    log(f"[7] lookup_std wide: {N} probes ([{B}, {R}]) on "
        f"{tuple(di.fused.shape)} ({table_bytes(di)} B), hits "
        f"{int((want[0] != 0).sum())}")

    # The k=31 packed table, probed by the same batch at k=31, w=8.
    pdi = packed["di"]
    phi, plo, pvalid = probes(torch, packed, PACKED["k"], PACKED["w"])
    pflat = [t.reshape(-1) for t in (phi, plo, pvalid)]
    pwant = lookup_std_plain(*pflat, pdi.fused, pdi.stash, pdi.cfg.ways)
    res.check("lookup_std", "7 packed", pwant,
              lookup_std(*pflat, pdi.fused, pdi.stash, pdi.cfg.ways))
    log(f"[7] lookup_std packed: {pflat[0].numel()} probes on "
        f"{tuple(pdi.fused.shape)}, hits {int((pwant[0] != 0).sum())}")

    # A forced stash: every 30th pair of the wide index at 4 ways, wide rows.
    tax = wide["idx"].taxonomy
    canon, taxa = extract_pairs(wide["idx"])
    kh, kl, val, st, _ = layout_table(canon[::30], taxa[::30], 4.0, ways=4)
    f4 = torch.from_numpy(fuse_table(kh, kl, val, tax.tin, tax.tout)
                          .view("int32")).to(cuda)
    s4 = torch.from_numpy(fuse_stash(st, tax.tin, tax.tout)
                          .view("int32")).to(cuda)
    if s4.shape[1] == 0:
        raise AssertionError("the forced-stash table has an empty stash")
    hi4, lo4 = torch.cat([flat[0], s4[0]]), torch.cat([flat[1], s4[1]])
    v4 = torch.cat([flat[2], torch.ones(s4.shape[1], dtype=torch.bool,
                                        device=cuda)])
    want4 = lookup_std_plain(hi4, lo4, v4, f4, s4, 4)
    res.check("lookup_std", "7 forced stash", want4,
              lookup_std(hi4, lo4, v4, f4, s4, 4))
    stash_hits = int((want4[0][N:] != 0).sum())
    log(f"[7] lookup_std forced stash: {tuple(f4.shape)}, stash "
        f"{s4.shape[1]}, {stash_hits} stash keys hit")
    if stash_hits != s4.shape[1]:
        raise AssertionError("a stash key missed its own stash")
    bucket = hash32(flat[0], flat[1]) & (di.fused.shape[0] - 1)
    need = touched_bytes(torch, bucket, flat[2], want[0] != 0, flat[0],
                         flat[1], 2 * ways, 3, di.stash)
    log(f"[7] lookup_std wide touches {need} B of its {table_bytes(di)} B "
        "table (hi and lo lanes of the rows reached; val, tin and tout of "
        "the keys hit)")
    res.time(torch, "lookup_std", "7 wide",
             lambda: lookup_std(*flat, di.fused, di.stash, ways),
             lambda: lookup_std_plain(*flat, di.fused, di.stash, ways),
             nbytes=N * 21 + need, ops=N * (4 * ways + 16),
             plain_calls=1, plain_reps=PLAIN_REPS)
    log(f"[7] lookup_std packed: kernel "
        f"{time_ms(torch, lambda: lookup_std(*pflat, pdi.fused, pdi.stash, pdi.cfg.ways), PIPELINED)}"
        f" ms a call for {pflat[0].numel()} probes")

    # K3's taxon form and K5 on the wide lookups (lifting), at thresholds.
    taxon, t_in, t_out = (t.reshape(B, R) for t in want)
    args = (taxon, t_in, t_out, valid)
    winners = score_winners_plain(*args, True)
    res.check("score_taxon", "7 wide winners", winners,
              score_winners(*args, True))
    for thr in THRESHOLDS:
        res.check("score_taxon", f"7 wide, threshold {thr}",
                  score_reads_taxon_plain(*args, di.tax, thr),
                  score_reads_taxon(*args, di.tax, thr))
        res.check("lca_lift", f"7 wide, threshold {thr}",
                  lca_lift_plain(*winners, di.tax, thr, True),
                  lca_lift(*winners, di.tax, thr, True))
    # The direct form, on the k=31 packed lookups (68 taxa).
    ptaxon, pt_in, pt_out = (t.reshape(phi.shape) for t in pwant)
    for thr in THRESHOLDS:
        res.check("score_taxon", f"7 packed direct, threshold {thr}",
                  score_reads_taxon_plain(ptaxon, pt_in, pt_out, pvalid,
                                          pdi.tax, thr),
                  score_reads_taxon(ptaxon, pt_in, pt_out, pvalid, pdi.tax,
                                    thr))
    n_hits = int((taxon != 0).sum())
    levels = di.tax["up"].shape[0]
    need = lineage_bytes(torch, winners[0], winners[1], di.tax)
    log(f"[7] lca_lift reaches {need} B of the taxonomy's lifting, parent "
        "and depth tables")
    res.time(torch, "score_taxon", "7 wide winners",
             lambda: score_winners(*args, True),
             lambda: score_winners_plain(*args, True),
             nbytes=B * R * 13 + B * 24, ops=n_hits * R * 4 + B * R,
             plain_calls=1, plain_reps=PLAIN_REPS)
    res.time(torch, "lca_lift", "7 wide",
             lambda: lca_lift(*winners, di.tax, 0.0, True),
             lambda: lca_lift_plain(*winners, di.tax, 0.0, True),
             nbytes=B * 20 + need, ops=B * (levels * 8 + 24),
             plain_calls=1, plain_reps=PLAIN_REPS)

    # K5 behind K3's q8 form on the 5,251-taxon q8 world.
    qdi = q8l["di"]
    qhi, qlo, qvalid = probes(torch, q8l, Q8_LIFT["k"], Q8_LIFT["w"])
    hits = [t.reshape(qhi.shape) for t in lookup_q8(
        qhi.reshape(-1), qlo.reshape(-1), qvalid.reshape(-1), qdi.fused,
        qdi.stash, Q8_LIFT["k"])]
    qwin = score_winners_plain(*hits, qvalid, False)
    for thr in THRESHOLDS:
        res.check("score_tin", f"7 q8 lifting, threshold {thr}",
                  score_reads_tin_plain(*hits, qvalid, qdi.tax, thr),
                  score_reads_tin(*hits, qvalid, qdi.tax, thr))
        res.check("lca_lift", f"7 q8 lifting, threshold {thr}",
                  lca_lift_plain(*qwin, qdi.tax, thr, False),
                  lca_lift(*qwin, qdi.tax, thr, False))
    # K5 on a chain deep enough for 13 lifting levels: random pairs.
    ctax = chain_tax(torch, cuda)
    g = torch.Generator(device="cpu").manual_seed(5)
    u, v = (torch.randint(0, CHAIN_NODES + 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda) for _ in range(2))
    best = torch.randint(0, 4, (B,), generator=g, dtype=torch.int32).to(cuda)
    nvalid = best + torch.randint(0, 4, (B,), generator=g,
                                  dtype=torch.int32).to(cuda)
    cargs = (u, v, ctax["tin"][u.long()], ctax["tin"][v.long()], best,
             nvalid)
    log(f"[7] chain: {CHAIN_NODES} nodes, {ctax['up'].shape[0]} lifting "
        "levels")
    for thr in THRESHOLDS:
        res.check("lca_lift", f"7 chain, threshold {thr}",
                  lca_lift_plain(*cargs, ctax, thr, True),
                  lca_lift(*cargs, ctax, thr, True))
    res.assert_clean(("lookup_std", "score_taxon", "lca_lift", "score_tin"))


def _check_q12(res: Results, what: str, args, k: int, ways: int):
    from pangea_tpu_torch.kernels import lookup_q12, lookup_q12_plain
    want = lookup_q12_plain(*args, k, ways)
    res.check("lookup_q12", what, want, lookup_q12(*args, k, ways))
    return want


def phase_multik_kernels(torch, world, cuda, res: Results) -> None:
    import dataclasses

    from pangea_tpu_torch.classify import (classify_reads, merge_multik,
                                           merge_multik_plain)
    from pangea_tpu_torch.index import extract_pairs, relayout_q12
    from pangea_tpu_torch.index.quot import Q12_WAYS, q12_layout
    from pangea_tpu_torch.kernels import (fuse_stash, lookup_q12,
                                          lookup_q12_plain, lookup_q12_sorted)
    from pangea_tpu_torch.kernels.lookup import (_q8_split, _q12_geometry,
                                                 narrow, widen)
    from pangea_tpu_torch.utils import datagen
    (k21, w21), (k31, w31) = MULTIK["indexes"]
    di21, di31 = world["dis"]
    idx21, idx31 = world["idxs"]
    tax = idx31.taxonomy
    W = Q12_WAYS

    def to_cuda(a):
        return torch.from_numpy(a.view("int32")).to(cuda)

    # K2-q12 at full width: both mates' k=31, w=1 probes.
    hi, lo, valid = probes(torch, world, k31, w31)
    B, R = hi.shape
    flat = [t.reshape(-1) for t in (hi, lo, valid)]
    N = flat[0].numel()
    fused, stash = di31.fused, di31.stash
    want = _check_q12(res, "11 full width", (*flat, fused, stash), k31, W)
    log(f"[11] lookup_q12: {N} probes ([{B}, {R}]) on {tuple(fused.shape)} "
        f"({table_bytes(di31)} B), stash {stash.shape[1]}, hits "
        f"{int((want[0] != 0).sum())}")
    # A forced stash: every 30th pair of the k=31 index at 4 ways.
    canon, taxa = extract_pairs(idx31)
    f4, s4, _ = q12_layout(canon[::30], taxa[::30], tax.tin, tax.tout, k31,
                           ways=4, load_factor=2.0)
    f4, s4 = to_cuda(f4), to_cuda(fuse_stash(s4, tax.tin, tax.tout))
    if s4.shape[1] == 0:
        raise AssertionError("the forced-stash table has an empty stash")
    v4 = torch.cat([flat[2], torch.ones(s4.shape[1], dtype=torch.bool,
                                        device=cuda)])
    want4 = _check_q12(res, "11 forced stash",
                       (torch.cat([flat[0], s4[0]]),
                        torch.cat([flat[1], s4[1]]), v4, f4, s4), k31, 4)
    stash_hits = int((want4[0][N:] != 0).sum())
    log(f"[11] lookup_q12 forced stash: {tuple(f4.shape)}, stash "
        f"{s4.shape[1]}, {stash_hits} stash keys hit")
    if stash_hits != s4.shape[1]:
        raise AssertionError("a stash key missed its own stash")
    # Absent 62-bit keys: random ones, and the near misses of stored keys
    # (bit 32 of the mix flipped and mixed back: the stored key's bucket
    # and rem_lo, another rem_hi). Every one misses.
    g = torch.Generator(device="cpu").manual_seed(11)
    u64 = canon.dtype.type
    mask = u64((1 << (2 * k31)) - 1)
    mix = (canon * u64(0x9E3779B1)) & mask
    near = ((mix ^ u64(1 << 32)) * u64(pow(0x9E3779B1, -1, 1 << (2 * k31)))
            ) & mask
    keys = torch.cat([torch.randint(0, 1 << (2 * k31), (1 << 20,),
                                    generator=g, dtype=torch.int64),
                      torch.from_numpy(near.view("int64"))])
    keys = keys[~torch.isin(keys, torch.from_numpy(canon.view("int64")))]
    keys = keys.to(cuda)
    ahi, alo = (keys >> 32).to(torch.int32), narrow(keys)
    awant = _check_q12(res, "11 absent keys",
                       (ahi, alo, torch.ones_like(ahi, dtype=torch.bool),
                        fused, stash), k31, W)
    log(f"[11] lookup_q12 on {keys.numel()} absent keys ({near.size} near "
        f"misses): hits {int((awant[0] != 0).sum())}")
    if (awant[0] != 0).any():
        raise AssertionError("an absent key hit")
    # The k=21 index forced to q12: a remainder below 32 bits.
    f21, s21, nb21 = relayout_q12(idx21)
    r21 = 2 * k21 - (nb21.bit_length() - 1)
    if r21 >= 32:
        raise AssertionError(f"the k=21 q12 remainder is {r21} bits")
    f21 = to_cuda(f21[0])
    s21 = to_cuda(fuse_stash(s21[0], tax.tin, tax.tout))
    h21 = [t.reshape(-1) for t in probes(torch, world, k21, w21)]
    want21 = _check_q12(res, f"11 k={k21} (r={r21})",
                        (*h21, f21, s21), k21, W)
    log(f"[11] lookup_q12 at k={k21}: {tuple(f21.shape)}, r={r21}, "
        f"{h21[0].numel()} probes, hits {int((want21[0] != 0).sum())}")
    # K9 and K2-q12's sorted form on the same probes (r >= 32), called
    # directly: the table has 131,072 rows, at the deep-table gate.
    res.check("lookup_q12_sorted", "11 full width (r >= 32)", want,
              lookup_q12_sorted(*flat, fused, stash, k31, W))
    log2nb = _q12_geometry(fused, k31, W)
    bucket, _ = _q8_split(widen(flat[0]), widen(flat[1]), k31, log2nb)
    need = touched_bytes(torch, bucket, flat[2], want[0] != 0, flat[0],
                         flat[1], 2 * W, 1, stash)
    log(f"[11] lookup_q12 touches {need} B of its {table_bytes(di31)} B "
        "table (rem_lo and rem_hi lanes of the rows reached; the payload "
        "lane of the keys hit)")
    res.time(torch, "lookup_q12", "11",
             lambda: lookup_q12(*flat, fused, stash, k31, W),
             lambda: lookup_q12_plain(*flat, fused, stash, k31, W),
             nbytes=N * 21 + need, ops=N * (3 * W + 10),
             plain_calls=1, plain_reps=PLAIN_REPS)

    # K7 on the full-width calls of both indexes, at two thresholds.
    b1, b2 = world["b1"], world["b2"]
    for thr in THRESHOLDS:
        calls = [classify_reads(di.tables, b1, dataclasses.replace(
                     di.cfg, confidence_threshold=thr), mate_bases=b2)
                 for di in (di21, di31)]
        res.check("merge_multik", f"11 full width, threshold {thr}",
                  merge_multik_plain(*calls, di21.tax).values(),
                  merge_multik(*calls, di21.tax).values())
    t1, t2 = calls[0]["taxon"], calls[1]["taxon"]
    conflict = (t1 != 0) & (t2 != 0) & (t1 != t2)
    agree = (t1 != 0) & (t1 == t2)
    log(f"[11] merge_multik on {B} pairs: {int(agree.sum())} agree, "
        f"{int(conflict.sum())} conflict, "
        f"{int(((t1 == 0) != (t2 == 0)).sum())} one-sided")
    # The int32 extreme cases, on config 4's taxonomy.
    ext = [{key: torch.tensor([c[j][i] for c in MERGE_EXTREMES],
                              dtype=torch.int32, device=cuda)
            for i, key in enumerate(("taxon", "best", "nvalid"))}
           for j in (0, 1)]
    res.check("merge_multik", "11 int32 extremes",
              merge_multik_plain(*ext, di21.tax).values(),
              merge_multik(*ext, di21.tax).values())
    # Conflicting pairs across the 66,563-taxon tree and the chain.
    wide = datagen.make_taxonomy(2, *WIDE["tree"], seed=0)
    for name, deep in (("66,563-taxon tree", {
            k: torch.from_numpy(v).to(cuda)
            for k, v in wide.device_arrays().items()}),
            (f"{CHAIN_NODES}-node chain", chain_tax(torch, cuda))):
        T = deep["tin"].numel() - 1
        u, v = (torch.randint(1, T + 1, (B,), generator=g,
                              dtype=torch.int32).to(cuda) for _ in range(2))
        n = torch.randint(1, 300, (2, B), generator=g,
                          dtype=torch.int32).to(cuda)
        calls = [{"taxon": t, "best": (n[j] * 3) // 4, "nvalid": n[j]}
                 for j, t in enumerate((u, v))]
        res.check("merge_multik", f"11 {name}, levels "
                  f"{deep['up'].shape[0]}",
                  merge_multik_plain(*calls, deep).values(),
                  merge_multik(*calls, deep).values())
    # Timing on the full-width calls at config 4's threshold.
    calls = [classify_reads(di.tables, b1, di.cfg, mate_bases=b2)
             for di in (di21, di31)]
    t1, t2 = calls[0]["taxon"], calls[1]["taxon"]
    conflict = (t1 != 0) & (t2 != 0) & (t1 != t2)
    need = lineage_bytes(torch, t1[conflict], t2[conflict], di21.tax)
    levels = di21.tax["up"].shape[0]
    log(f"[11] merge_multik's {int(conflict.sum())} conflicts reach {need} B "
        "of the lifting, parent and depth tables")
    res.time(torch, "merge_multik", "11",
             lambda: merge_multik(*calls, di21.tax),
             lambda: merge_multik_plain(*calls, di21.tax),
             nbytes=B * 36 + need,
             ops=B * 20 + int(conflict.sum()) * levels * 8)
    res.assert_clean(("lookup_q12", "lookup_q12_sorted", "merge_multik"))


def phase_packed_kernels(torch, wide, fastq: tuple, cuda,
                         res: Results) -> None:
    """K1's packed form on the headline pairs as the native reader packs
    them (both mates column slices of one batch on the card), against its
    plain version and against K1 on the same reads' codes."""
    from pangea_tpu_torch.io.native import NativeFastxReader
    from pangea_tpu_torch.kernels import (extract_probes,
                                          extract_probes_plain, wire_width)
    from pangea_tpu_torch.kernels.minimize import probe_width
    rows = []
    for path in fastq:
        reader = NativeFastxReader(path, BATCH, READ_LEN)
        n, _, words, _ = reader.next_batch_packed()
        reader.close()
        if n != BATCH:
            raise AssertionError(f"{path}: {n} records in the first batch")
        rows.append(torch.from_numpy(words.view("int32")))
    combo = torch.cat(rows, dim=1).to(cuda)
    W = wire_width(READ_LEN)
    mates = (combo[:, :W], combo[:, W:])
    for k, w in ((HEADLINE["k"], HEADLINE["w"]), (WIDE["k"], WIDE["w"])):
        nw = probe_width(READ_LEN, k, w)

        def run(fn, k=k, w=w, nw=nw):
            out = (torch.empty((BATCH, 2 * nw), dtype=torch.int32,
                               device=cuda),
                   torch.empty((BATCH, 2 * nw), dtype=torch.int32,
                               device=cuda),
                   torch.empty((BATCH, 2 * nw), dtype=torch.bool,
                               device=cuda))
            for m, part in enumerate(mates):
                fn(part, k, w, out, m * nw, packed_len=READ_LEN)
            return out

        packed = run(extract_probes)
        res.check("extract_packed", f"15 w={w} vs its plain version",
                  run(extract_probes_plain), packed)
        res.check("extract_packed", f"15 w={w} vs K1 on the codes",
                  probes(torch, wide, k, w), packed)
        if w == HEADLINE["w"]:
            windows = BATCH * 2 * nw
            res.time(torch, "extract_packed", "15 w=8",
                     lambda: run(extract_probes),
                     lambda: run(extract_probes_plain),
                     nbytes=BATCH * 2 * W * 4 + windows * 9,
                     ops=windows * ((w + k - 1) * 8 + w * 18))
        else:
            log(f"[15] extract_packed w={w}: kernel "
                f"{time_ms(torch, lambda: run(extract_probes), PIPELINED)} "
                f"ms a call for both mates of {BATCH} pairs")
    res.assert_clean(("extract_packed",))


def lineage_lanes(torch, tax: dict, B: int, R: int, g):
    """[B, R] int32 hit taxa drawn from four taxa a read (half of them
    misses), their Euler intervals and valid bools, on the taxonomy's
    device; read 0 has no hit and read 1 no valid probe."""
    dev = tax["tin"].device
    T = tax["tin"].numel() - 1
    lineage = torch.randint(1, T + 1, (B, 4), generator=g)
    taxa = lineage.gather(1, torch.randint(0, 4, (B, R), generator=g))
    taxon = torch.where(torch.rand((B, R), generator=g) < 0.5, taxa,
                        0).to(torch.int32)
    taxon[0] = 0
    valid = (torch.rand((B, R), generator=g) < 0.8) | (taxon != 0)
    valid[1] = False
    taxon, valid = taxon.to(dev), valid.to(dev)
    hit = taxon != 0
    return (taxon, torch.where(hit, tax["tin"][taxon.long()], 0),
            torch.where(hit, tax["tout"][taxon.long()], 0), valid)


def phase_ranked_kernels(torch, wide, cuda, res: Results) -> None:
    """K8 against its plain version at RANKED_SHAPES: both forms, the
    direct LCA and K5's lifting, two thresholds; times of its winners
    form on the taxon lanes of the 66,563-taxon tree."""
    import math

    from pangea_tpu_torch.kernels import (score_ranked, score_reads_plain,
                                          score_winners,
                                          score_winners_plain)
    from pangea_tpu_torch.utils import datagen
    bench_tax = datagen.make_taxonomy(2, 8, 3, seed=0).device_arrays()
    trees = {"direct LCA, 67 taxa": {
                 k: torch.from_numpy(v).to(cuda)
                 for k, v in bench_tax.items()},
             "lifted LCA, 66,563 taxa": wide["tax"]}
    g = torch.Generator().manual_seed(15)
    for R, B in RANKED_SHAPES:
        for name, tax in trees.items():
            taxon, t_in, t_out, valid = lineage_lanes(torch, tax, B, R, g)
            for taxon_lanes in (True, False):
                lanes = taxon if taxon_lanes else (taxon != 0).to(torch.int32)
                args = (lanes, t_in, t_out, valid)
                what = (f"15 R={R} x {B}, "
                        f"{'taxon' if taxon_lanes else 'q8'} form")
                res.check("score_ranked", f"{what}, winners",
                          score_winners_plain(*args, taxon_lanes),
                          score_winners(*args, taxon_lanes))
                for thr in THRESHOLDS:
                    res.check("score_ranked",
                              f"{what}, {name}, threshold {thr}",
                              score_reads_plain(*args, tax, thr,
                                                taxon_lanes),
                              score_ranked(*args, tax, thr, taxon_lanes))
        # The last draw: taxon lanes on the big tree, as on the std path.
        args = (taxon, t_in, t_out, valid)
        hits = int((taxon != 0).sum())
        lg = math.log2(R)
        nbytes = B * R * 13 + B * 24
        ops = 2 * B * R * lg + 2 * hits * lg
        if R == RANKED_SHAPES[1][0]:
            res.time(torch, "score_ranked", f"15 R={R} x {B}",
                     lambda: score_winners(*args, True),
                     lambda: score_winners_plain(*args, True),
                     nbytes=nbytes, ops=ops, plain_calls=1,
                     plain_reps=PLAIN_REPS)
        else:
            ms = time_ms(torch, lambda: score_winners(*args, True),
                         PIPELINED)
            plain_ms = time_ms(torch, lambda: score_winners_plain(*args,
                                                                  True),
                               1, PLAIN_REPS)
            bound_ms, by = bound(nbytes, ops)
            log(f"[15] score_ranked R={R} x {B}: kernel {ms} ms, plain "
                f"{plain_ms} ms, bound {bound_ms} ms ({by})")
    res.assert_clean(("score_ranked",))


def phase_long_step(torch, wide, cuda, card: str, mix) -> dict:
    """Each launch the CLI's general path makes of the long-read FASTQ
    (its batches of CLI_BATCH reads, bucketed as run_classify_basic
    does) through the std Classifier: launch counts, the plain path, the
    planted lineage, and a step time for each bucket shape. Returns the
    outputs in read order."""
    from pangea_tpu_torch.kernels import kernel_launches, reset_kernel_launches
    from pangea_tpu_torch.kernels.minimize import probe_width
    from pangea_tpu_torch.kernels.score import MAX_PROBES
    from pangea_tpu_torch.pipeline.run import bucket_batch
    model = wide["model"]
    none = dict.fromkeys(KERNELS, 0)
    n = len(mix.ids)
    outs = {key: torch.zeros(n, dtype=torch.int32)
            for key in ("taxon", "best", "nvalid")}
    shapes: dict = {}
    for start in range(0, n, CLI_BATCH):
        launches, _ = bucket_batch(mix.seqs[start:start + CLI_BATCH], None,
                                   CLI_BATCH, READ_LEN, MAX_LONG)
        for sub, bases, _ in launches:
            b = torch.from_numpy(bases).to(cuda)
            R = probe_width(b.shape[1], WIDE["k"], WIDE["w"])
            reset_kernel_launches()
            out = model(b)
            torch.cuda.synchronize()
            want = {**none, "extract_probes": 1, "lookup_std": 1,
                    "lca_lift": 1,
                    "score_ranked" if R > MAX_PROBES else "score_taxon": 1}
            if kernel_launches() != want:
                raise AssertionError(f"launches at {tuple(b.shape)}: "
                                     f"{kernel_launches()}, want {want}")
            mism, _ = compare([v for v in wide["plain"](b, None).values()],
                              list(out.values()))
            if mism:
                raise AssertionError(f"{mism} mismatches against the plain "
                                     f"path at {tuple(b.shape)}")
            idx = torch.from_numpy(sub + start)
            for key in outs:
                outs[key][idx] = out[key].cpu()
            entry = shapes.setdefault(b.shape[1], {"b": b, "reads": 0,
                                                   "launches": 0, "R": R})
            entry["reads"] += sub.size
            entry["launches"] += 1
    tin, tout = (wide["tax"][k].cpu().long() for k in ("tin", "tout"))
    taxon = outs["taxon"].long()
    truth = torch.from_numpy(mix.truth).long()
    classified = taxon != 0
    off = int((classified & ~((tin[taxon] <= tin[truth])
                              & (tin[truth] < tout[taxon]))).sum())
    log(f"[16] long-read step: {n} reads, 0 mismatches against the plain "
        f"path; {int(classified.sum())} classified, {off} off their "
        f"truth's lineage ({off / n} of the reads; limit "
        f"{MAX_OFF_LINEAGE})")
    if off > MAX_OFF_LINEAGE * n or not classified.any():
        raise AssertionError("the long-read step disagrees with the truth")
    for Lj, e in sorted(shapes.items()):
        b = e["b"]
        ms = time_ms(torch, lambda: model(b), PIPELINED)
        log(f"[16] bucket {Lj} bases: {e['reads']} reads in {e['launches']} "
            f"launch(es), R = {e['R']} probes a read, "
            f"{'K8' if e['R'] > MAX_PROBES else 'K3'}; a step of "
            f"{b.shape[0]} reads {ms} ms back to back "
            f"({b.shape[0] / ms * 1e3} reads/s) on {card}")
    return outs


def phase_long_cli(wide, mix, outs: dict, long_fastq: str):
    """The CLI's general path (input.long_reads=true) on the long-read
    FASTQ: its lines against phase 16's outputs, truncated_reads against
    the reads past MAX_LONG bases. Returns its launches and lines."""
    result, rows = run_cli(wide, "17", [long_fastq],
                           extra=["input.long_reads=true",
                                  f"input.max_long_read_len={MAX_LONG}"])
    launches = result["kernel_launches"]
    cut = sum(len(s) > MAX_LONG for s in mix.seqs)
    if result["fast_path"] or result["truncated_reads"] != cut \
            or launches["score_ranked"] < 1 or launches["extract_packed"]:
        raise AssertionError(f"the long-read CLI run is wrong (want "
                             f"{cut} truncated): {json.dumps(result)}")
    bad = sum(
        (r[1], int(r[2]), r[5]) != (
            rid, int(outs["taxon"][i]),
            f"{int(outs['best'][i])}/{int(outs['nvalid'][i])}")
        for i, (r, rid) in enumerate(zip(rows, mix.ids)))
    log(f"[17] {len(rows)} lines, {result['truncated_reads']} reads cut at "
        f"{MAX_LONG} bases; lines vs phase 16: mismatches {bad}; "
        f"{result['reads_per_sec']} reads/s")
    if len(rows) != len(mix.ids) or bad:
        raise AssertionError("the long-read CLI's assignments are wrong")
    return launches, rows


def phase_fast_long_cli(wide, mix, rows17: list, long_fastq: str) -> dict:
    """The same FASTQ on the fast path: every read past READ_LEN bases is
    cut and counted, and the short reads' lines equal phase 17's."""
    result, rows = run_cli(wide, "18", [long_fastq])
    launches = result["kernel_launches"]
    cut = sum(len(s) > READ_LEN for s in mix.seqs)
    bad = sum(a != b for a, b in zip(rows[:LONG_SHORT], rows17))
    log(f"[18] {len(rows)} lines, {result['truncated_reads']} reads cut at "
        f"{READ_LEN} bases (want {cut}); the {LONG_SHORT} short reads' "
        f"lines vs phase 17: mismatches {bad}; "
        f"{result['reads_per_sec']} reads/s")
    if not result["fast_path"] or result["truncated_reads"] != cut \
            or launches["extract_packed"] < 1 or launches["extract_probes"] \
            or len(rows) != len(mix.ids) or bad:
        raise AssertionError(f"the fast path on long reads is wrong: "
                             f"{json.dumps(result)}")
    return launches


def start_process(argv: list) -> subprocess.Popen:
    """A host process of the port, its output piped."""
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def start_deep_build() -> dict:
    """Phase 19's build, started before phase 3 so that it runs beside the
    earlier phases on a spare host core: the deep world's genomes as FASTA
    and its taxonomy as TSV, then `python -m pangea_tpu_torch.cli build` in
    a subprocess (k=21, w=1, 16 ways: the reference bench's deep index)."""
    from pangea_tpu_torch.bench import deep_genomes
    from pangea_tpu_torch.utils import datagen
    work = ROOT / "build" / "chip_smoke" / "deep"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.time()
    tax, genomes = deep_genomes(DEEP_GENOME_LEN)
    datagen.write_fasta(str(work / "refs.fasta"), genomes, tax)
    datagen.write_taxonomy_tsv(str(work / "taxonomy.tsv"), tax)
    cmd = [sys.executable, "-m", "pangea_tpu_torch.cli", "build",
           "--refs", str(work / "refs.fasta"),
           "--taxonomy", str(work / "taxonomy.tsv"), "--k", str(DEEP_K),
           "--out", str(work / "idx")]
    log(f"[19] deep world: {len(genomes)} genomes of {DEEP_GENOME_LEN} "
        f"bases and {tax.num_taxa} taxa written in {time.time() - t0:.1f} "
        f"s; started {' '.join(cmd[1:])}")
    return {"name": "deep", "tax": tax, "genomes": genomes, "dir": work,
            "cmd": cmd, "proc": start_process(cmd), "t0": time.time(),
            "config": "config2_16s_paired.json", "ooc": None, "gen": None,
            "c3_fastq": work / "config3.fastq"}


def start_sharded_build(deep: dict) -> None:
    """Phase 24's out-of-core build of the deep genomes and config 3's
    FASTQ, two processes started when phase 19's build has ended, so that
    they run beside phases 19-23 and not beside the earlier phases' host
    work."""
    cmd = deep["cmd"]
    ooc = cmd[:-1] + [str(deep["dir"] / "sidx"), "--ooc-shards",
                      str(OOC_SHARDS)]
    gen = [sys.executable, "-c",
           "from pangea_tpu_torch.bench import deep_genomes, deep_reads\n"
           "from pangea_tpu_torch.utils import datagen\n"
           f"_, g = deep_genomes({DEEP_GENOME_LEN})\n"
           f"datagen.write_fastq({str(deep['c3_fastq'])!r}, "
           f"deep_reads(g, {C3_READS}, {READ_LEN}), mate=1)\n"]
    log(f"[24] started {' '.join(ooc[1:])}, and config 3's {C3_READS} reads")
    deep.update(ooc=start_process(ooc), gen=start_process(gen),
                t0_ooc=time.time())


def phase_deep_build(torch, cuda, deep: dict) -> None:
    """Phase 19: wait for the build, load the index, lay it out as q8 (what
    pick_layout gives it), q12 and std on the card, and make the reads."""
    import resource

    from pangea_tpu_torch.bench import deep_reads
    from pangea_tpu_torch.classify import Classifier, DeviceIndex, pad_batch
    from pangea_tpu_torch.index import load_index_any
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    _, err = deep["proc"].communicate(timeout=900)
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    if deep["proc"].returncode != 0:
        raise AssertionError(f"the build returned {deep['proc'].returncode}"
                             f":\n{err[-4000:]}")
    cpu = (cpu1.ru_utime - cpu0.ru_utime) + (cpu1.ru_stime - cpu0.ru_stime)
    log(f"[19] the build process: {err.strip().splitlines()[-1]} (its own "
        f"clock); {cpu:.1f} s of CPU; done {time.time() - deep['t0']:.1f} s "
        "after it started, beside phases 3-18")
    start_sharded_build(deep)
    idx_dir = str(deep["dir"] / "idx")
    idx = load_index_any(idx_dir)
    deep.update(idx=idx, idx_dirs=[idx_dir], dis={}, models={},
                launches={})
    log(f"[19] loaded {idx!r}: {idx.meta.n_kmers} k-mers, "
        f"{idx.meta.n_buckets} std rows of {idx.meta.ways} ways")
    for layout in ("q8", "q12", "std"):
        t0 = time.time()
        di = DeviceIndex.from_index(idx, cuda, 0.0,
                                    layout=None if layout == "q8" else layout)
        if di.cfg.layout != layout:
            raise AssertionError(f"layout {di.cfg.layout}, want {layout}")
        deep["dis"][layout] = di
        deep["models"][layout] = Classifier(di)
        log(f"[19] deep {layout} table {tuple(di.fused.shape)} "
            f"({di.fused.numel() * 4} B), stash {di.stash.shape[1]}, laid "
            f"out and placed in {time.time() - t0:.1f} s")
    deep["tax"] = deep["dis"]["q8"].tax
    reads = deep_reads(deep["genomes"], DEEP_STD_READS, READ_LEN)
    deep["reads"] = reads
    deep["b64"] = torch.from_numpy(pad_batch(reads.seqs, DEEP_STD_READS,
                                             READ_LEN)).to(cuda)
    deep["b16"] = deep["b64"][:DEEP_READS]


def check_sort(torch, res: Results, what: str, flat, nb: int, k):
    """K9 against its plain version (a stable torch.sort of the keys): a
    permutation whose probes' keys ascend as the plain order's, each record
    with its probe's lanes, and its inverse. Returns (K9's output, the
    plain one)."""
    from pangea_tpu_torch.kernels import bucket_sort, bucket_sort_plain
    from pangea_tpu_torch.kernels.lookup import bucket_keys
    order = bucket_sort(*flat, nb, k)
    want = bucket_sort_plain(*flat, nb, k)
    records, inv = order
    perm = records[:, 0].long()
    n = flat[0].numel()
    every = torch.arange(n, device=perm.device)
    if not torch.equal(torch.sort(perm).values, every):
        raise AssertionError(f"[{what}] K9's output is not a permutation")
    keys = bucket_keys(*flat, nb, k)
    res.check("bucket_sort", what,
              [keys[want[0][:, 0].long()], *(x[perm] for x in flat), every],
              [keys[perm], *records[:, 1:].unbind(1), inv[perm]])
    return order, want


def phase_deep_kernels(torch, deep, wide, res: Results, card: str) -> None:
    """Phase 20: K9 and the sorted forms against their plain versions at
    the deep steps' shapes, and timed against the unsorted kernels on the
    same probes."""
    from pangea_tpu_torch.index.quot import Q12_WAYS
    from pangea_tpu_torch.kernels import (bucket_sort, bucket_sort_plain,
                                          hash32, lookup_q8, lookup_q8_plain,
                                          lookup_q8_sorted,
                                          lookup_q8_sorted_plain, lookup_q12,
                                          lookup_q12_plain, lookup_q12_sorted,
                                          lookup_q12_sorted_plain, lookup_std,
                                          lookup_std_plain, lookup_std_sorted,
                                          lookup_std_sorted_plain)
    from pangea_tpu_torch.kernels.lookup import _q8_split, key_shift, widen
    k = DEEP_K
    flat16, flat64 = ([t.reshape(-1) for t in probes(
        torch, {"b1": deep[b], "b2": None}, k, 1)] for b in ("b16", "b64"))
    forms = {  # layout: (sorted, its plain, unsorted, plain, args, probes)
        "q8": (lookup_q8_sorted, lookup_q8_sorted_plain, lookup_q8,
               lookup_q8_plain, (k,), flat16),
        "q12": (lookup_q12_sorted, lookup_q12_sorted_plain, lookup_q12,
                lookup_q12_plain, (k, Q12_WAYS), flat16),
        "std": (lookup_std_sorted, lookup_std_sorted_plain, lookup_std,
                lookup_std_plain, (deep["dis"]["std"].cfg.ways,), flat64)}
    for layout, (srt, srt_plain, unsorted, plain, args, flat) in \
            forms.items():
        di = deep["dis"][layout]
        tab = (di.fused, di.stash, *args)
        nb, lanes = di.fused.shape
        N = flat[0].numel()
        qk = None if layout == "std" else k
        what = f"20 deep {layout}"
        order, order_plain = check_sort(torch, res, what, flat, nb, qk)
        want = plain(*flat, *tab)
        name = f"lookup_{layout}_sorted"
        res.check(name, what, want, srt(*flat, *tab))
        res.check(f"lookup_{layout}", what, want, unsorted(*flat, *tab))
        hit = want[0] != 0
        if layout == "std":
            W = args[0]
            bucket = hash32(flat[0], flat[1]) & (nb - 1)
            need = touched_bytes(torch, bucket, flat[2], hit, flat[0],
                                 flat[1], 2 * W, 2, di.stash)
            ops = N * (4 * W + 16)
        else:
            W = args[1] if layout == "q12" else lanes // 2
            bucket, _ = _q8_split(widen(flat[0]), widen(flat[1]), k,
                                  nb.bit_length() - 1)
            need = touched_bytes(torch, bucket, flat[2], hit, flat[0],
                                 flat[1], (2 if layout == "q12" else 1) * W,
                                 1, di.stash)
            ops = N * ((3 if layout == "q12" else 2) * W + 10)
        rows = int(torch.unique(bucket[flat[2]]).numel())
        log(f"[20] deep {layout}: {N} probes on {tuple(di.fused.shape)} "
            f"({di.fused.numel() * 4} B), {int(hit.sum())} hits, {rows} rows "
            f"reached; K9 key shift {key_shift(nb)}; touches {need} B")
        res.time(torch, name, what,
                 lambda: srt(*flat, *tab, order=order),
                 lambda: srt_plain(*flat, *tab, order=order_plain),
                 nbytes=N * 32 + need, ops=ops, plain_calls=1,
                 plain_reps=PLAIN_REPS)
        sort_args = (*flat, nb, qk)
        if layout == "q8":
            res.time(torch, "bucket_sort", what,
                     lambda: bucket_sort(*sort_args),
                     lambda: bucket_sort_plain(*sort_args),
                     nbytes=N * 29 + 8 * (nb >> key_shift(nb)),
                     ops=N * 16, plain_calls=1, plain_reps=PLAIN_REPS)
            k9_ms = res.k["bucket_sort"]["ms"]
        else:
            k9_ms = time_ms(torch, lambda: bucket_sort(*sort_args),
                            PIPELINED)
        unsorted_ms = time_ms(torch, lambda: unsorted(*flat, *tab),
                              PIPELINED)
        both_ms = time_ms(torch, lambda: srt(*flat, *tab), PIPELINED)
        log(f"[20] deep {layout}, {N} probes, on {card}: unsorted "
            f"{unsorted_ms} ms; K9 {k9_ms} ms + sorted form "
            f"{res.k[name]['ms']} ms; K9 and the sorted form in one call "
            f"{both_ms} ms ({unsorted_ms / both_ms} x the unsorted speed)")

    # K4's sorted form on the wide std world's table (wide rows): the
    # phase-7 probes, 16384 pairs x 260.
    wdi = wide["di"]
    wflat = [t.reshape(-1) for t in probes(torch, wide, WIDE["k"],
                                           WIDE["w"])]
    wtab = (wdi.fused, wdi.stash, wdi.cfg.ways)
    check_sort(torch, res, "20 wide std", wflat, wdi.fused.shape[0], None)
    res.check("lookup_std_sorted", "20 wide std", lookup_std_plain(
        *wflat, *wtab), lookup_std_sorted(*wflat, *wtab))
    unsorted_ms, both_ms = (time_ms(torch, lambda fn=fn: fn(*wflat, *wtab),
                                    PIPELINED)
                            for fn in (lookup_std, lookup_std_sorted))
    log(f"[20] wide std table {tuple(wdi.fused.shape)}, "
        f"{wflat[0].numel()} probes, on {card}: unsorted K4 {unsorted_ms} "
        f"ms, K9 and the sorted form {both_ms} ms")
    res.assert_clean(("bucket_sort", "lookup_q8_sorted", "lookup_q12_sorted",
                      "lookup_std_sorted", "lookup_q8", "lookup_q12",
                      "lookup_std"))


def phase_deep_steps(torch, deep, card: str) -> dict:
    """Phase 21: the q8, q12 and std deep steps through the Classifier:
    launches, the plain path, the planted lineage and step times; then the
    same steps on the unsorted lookup. Returns the q8 step's outputs."""
    from pangea_tpu_torch.classify import classify_reads
    from pangea_tpu_torch.kernels import (kernel_launches,
                                          reset_kernel_launches)
    none = dict.fromkeys(KERNELS, 0)
    tin, tout = (deep["tax"][n].cpu().long() for n in ("tin", "tout"))
    truth_all = torch.from_numpy(deep["reads"].truth).long()
    outs = {}
    for layout, n in (("q8", DEEP_READS), ("q12", DEEP_READS),
                      ("std", DEEP_STD_READS)):
        model = deep["models"][layout]
        b = deep["b64"][:n]
        score = "score_taxon" if layout == "std" else "score_tin"
        reset_kernel_launches()
        out = model(b)
        torch.cuda.synchronize()
        launches = kernel_launches()
        want = {**none, "extract_probes": 1, "bucket_sort": 1,
                f"lookup_{layout}_sorted": 1, score: 1}
        log(f"[21] kernel launches in one deep {layout} step: {launches}")
        if launches != want:
            raise AssertionError(f"launches {launches}, want {want}")
        deep["launches"][layout] = launches
        out = {key: v.cpu() for key, v in out.items()}
        plain = classify_reads(model.index.tables, b, model.cfg, plain=True)
        mism, _ = compare([plain[key].cpu() for key in out],
                          list(out.values()))
        taxon = out["taxon"].long()
        truth = truth_all[:n]
        classified = taxon != 0
        off = int((classified & ~((tin[taxon] <= tin[truth])
                                  & (tin[truth] < tout[taxon]))).sum())
        log(f"[21] deep {layout} step on {n} reads: mismatches against the "
            f"plain path {mism}; {int(classified.sum())} classified, {off} "
            f"off their truth's lineage ({off / n} of the reads; limit "
            f"{MAX_OFF_LINEAGE})")
        if mism or off > MAX_OFF_LINEAGE * n or not classified.any():
            raise AssertionError(f"the deep {layout} step disagrees with its "
                                 "references")
        for calls, what in ((1, "one step"), (PIPELINED,
                                              "back-to-back steps")):
            ms = time_ms(torch, lambda: model(b), calls)
            log(f"[21] deep {layout}, {what}, {n} reads, on {card}: sorted "
                f"lookup {ms} ms ({n / ms * 1e3} reads/s)")
        with mock.patch.dict(os.environ, {"PANGEA_DEEP_SORT": "0"}):
            reset_kernel_launches()
            unsorted = model(b)
            torch.cuda.synchronize()
            if kernel_launches() != {**none, "extract_probes": 1,
                                     f"lookup_{layout}": 1, score: 1}:
                raise AssertionError(f"PANGEA_DEEP_SORT=0 launches "
                                     f"{kernel_launches()}")
            mism, _ = compare([unsorted[key].cpu() for key in out],
                              list(out.values()))
            ms = time_ms(torch, lambda: model(b), PIPELINED)
        log(f"[21] deep {layout} with PANGEA_DEEP_SORT=0, back-to-back "
            f"steps, {n} reads, on {card}: unsorted lookup {ms} ms "
            f"({n / ms * 1e3} reads/s); mismatches against the sorted step "
            f"{mism}")
        if mism:
            raise AssertionError("the unsorted deep step disagrees")
        outs[layout] = out
    return outs["q8"]


def phase_deep_cli(deep, out: dict) -> dict:
    """Phase 22: the CLI on the deep index (the port-built directory), one
    batch of the 16,384 reads on the fast path: K9 and the sorted form, no
    unsorted K2; its lines against phase 21's q8 step."""
    from pangea_tpu_torch.utils import datagen
    reads = deep["reads"]
    fastq = str(deep["dir"] / "deep.fastq")
    datagen.write_fastq(fastq, datagen.ReadSet(
        ids=reads.ids[:DEEP_READS], seqs=reads.seqs[:DEEP_READS], mates=None,
        truth=reads.truth[:DEEP_READS]), mate=1)
    result, rows = run_cli(deep, "22", [fastq], batch=DEEP_READS)
    launches = result["kernel_launches"]
    if not result["fast_path"] or result["truncated_reads"] \
            or launches["extract_packed"] < 1 or launches["bucket_sort"] < 1 \
            or launches["lookup_q8_sorted"] < 1 or launches["lookup_q8"] \
            or launches["extract_probes"]:
        raise AssertionError("the deep CLI did not take the fast path and "
                             f"the sorted lookup: {json.dumps(result)}")
    bad = sum((r[1], int(r[2]), r[5]) != (
        rid, int(out["taxon"][i]),
        f"{int(out['best'][i])}/{int(out['nvalid'][i])}")
        for i, (r, rid) in enumerate(zip(rows, reads.ids)))
    log(f"[22] {len(rows)} lines; vs phase 21's q8 step: mismatches {bad}; "
        f"{result['reads_per_sec']} reads/s")
    if len(rows) != DEEP_READS or bad:
        raise AssertionError("the deep CLI's assignments are wrong")
    return launches


def phase_sharded_build(torch, deep) -> None:
    """Phase 24: wait for the out-of-core build, load its container and
    hold it to phase 19's monolithic index: the same k-mer/taxon pairs, the
    same table at one shard (ShardedIndex.shard_tables(1) against the
    index's own arrays) and the same q8 relayout on the card, byte for
    byte."""
    import resource

    from pangea_tpu_torch.classify import DeviceIndex
    from pangea_tpu_torch.index import (ShardedIndex, extract_pairs,
                                        load_index_any, shard_tables)
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    _, err = deep["ooc"].communicate(timeout=900)
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    if deep["ooc"].returncode != 0:
        raise AssertionError(f"the sharded build returned "
                             f"{deep['ooc'].returncode}:\n{err[-4000:]}")
    cpu = (cpu1.ru_utime - cpu0.ru_utime) + (cpu1.ru_stime - cpu0.ru_stime)
    log(f"[24] the sharded build process: {err.strip().splitlines()[-1]} "
        f"(its own clock); {cpu:.1f} s of CPU; done "
        f"{time.time() - deep['t0_ooc']:.1f} s after it started, beside "
        "phases 19-23")
    t0 = time.time()
    sidx = load_index_any(str(deep["dir"] / "sidx"))
    idx = deep["idx"]
    if not isinstance(sidx, ShardedIndex) or \
            sidx.meta.n_shards != OOC_SHARDS:
        raise AssertionError(f"{sidx!r} is not a {OOC_SHARDS}-shard index")
    bad = 0
    for a, b in zip(extract_pairs(sidx), extract_pairs(idx)):
        bad += int(a.shape != b.shape) or int((a != b).sum())
    one = shard_tables(sidx, 1)
    for a, b in zip(one, (idx.key_hi, idx.key_lo, idx.val)):
        bad += int(a[0].shape != b.shape or a[0].tobytes() != b.tobytes())
    st = one[3][0, :, :idx.stash.shape[1]]
    bad += int(st.shape != idx.stash.shape
               or st.tobytes() != idx.stash.tobytes())
    di = DeviceIndex.from_index(sidx, deep["dis"]["q8"].fused.device, 0.0)
    want = deep["dis"]["q8"]
    bad += int(di.cfg != want.cfg or not torch.equal(di.fused, want.fused)
               or not torch.equal(di.stash, want.stash))
    deep["sidx"] = sidx
    log(f"[24] {sidx!r}: shard buckets {sidx.meta.shard_buckets}, stashes "
        f"{sidx.meta.shard_stash}; pairs, one-shard table and q8 relayout "
        f"against phase 19's index: mismatches {bad} "
        f"({time.time() - t0:.1f} s)")
    if bad or sidx.meta.n_kmers != idx.meta.n_kmers:
        raise AssertionError("the sharded index differs from phase 19's")


def check_route(torch, res: Results, what: str, flat, n_shards: int,
                cap: int):
    """K10 against its plain version: every valid probe in its owner's
    bin once with its own record, the plain version's per-owner counts and
    count of overflowing probes, zeros in the unused slots; then K9's
    restore on the records against the plain restore. Returns K10's
    output."""
    from pangea_tpu_torch.kernels import (route_bin, route_bin_plain,
                                          route_restore, route_restore_plain)
    from pangea_tpu_torch.kernels.route import owner_of
    hi, lo, valid = flat
    records, inv, counts = route_bin(hi, lo, valid, n_shards, cap)
    _, pinv, pcounts = route_bin_plain(hi, lo, valid, n_shards, cap)
    fits = inv >= 0
    n = hi.numel()
    slots = inv[fits].long()
    rec = records[slots]
    used = torch.zeros(records.shape[0], dtype=torch.bool,
                       device=records.device)
    used[slots] = True
    every = torch.arange(n, dtype=torch.int32, device=hi.device)
    res.check("route_bin", what,
              [pcounts, (pinv >= 0).sum().reshape(1),
               owner_of(hi, lo, n_shards)[fits], every[fits], hi[fits],
               lo[fits], torch.ones_like(rec[:, 3]),
               torch.zeros(1, dtype=torch.int64, device=hi.device),
               torch.zeros(1, dtype=torch.int64, device=hi.device)],
              [counts, fits.sum().reshape(1), slots // cap, rec[:, 0],
               rec[:, 1], rec[:, 2], rec[:, 3],
               (fits & ~valid).sum().reshape(1),
               records[~used].abs().sum().reshape(1)])
    answers = records[:, [1, 2, 0, 3]].contiguous()
    res.check("route_restore", what, route_restore_plain(inv, answers),
              route_restore(inv, answers))
    return records, inv, counts


def phase_route_kernels(torch, deep, wide, res: Results, card: str) -> None:
    """Phase 25: K10 on the deep probes at 2, 4 and 8 owners and with a
    forced overflow, K9's restore on its records, and K4's owner mask on
    the wide std table at 4 shards, every shard; each against its plain
    version, and timed beside its bound."""
    from pangea_tpu_torch.kernels import (hash32, lookup_std_owned,
                                          lookup_std_plain, route_bin,
                                          route_bin_plain, route_restore,
                                          route_restore_plain)
    from pangea_tpu_torch.kernels.route import owner_of, route_capacity
    flat = [t.reshape(-1) for t in probes(
        torch, {"b1": deep["b16"], "b2": None}, DEEP_K, 1)]
    N = flat[0].numel()
    for S in ROUTE_SHARDS:
        cap = route_capacity(N, S)
        records, inv, counts = check_route(torch, res, f"25 K10 S={S}", flat,
                                           S, cap)
        home = int((~flat[2]).sum())
        log(f"[25] K10 on {N} deep probes, {S} owners of {cap} slots: "
            f"counts {counts.tolist()}, past their bins "
            f"{int((inv < 0).sum()) - home}, invalid (at home) {home}")
        if S == 4:
            nbytes = N * 9 + S * cap * 16 + N * 4 + S * 4
            res.time(torch, "route_bin", "25 K10 S=4",
                     lambda: route_bin(*flat, S, cap),
                     lambda: route_bin_plain(*flat, S, cap), nbytes=nbytes,
                     ops=N * 16, plain_calls=1, plain_reps=PLAIN_REPS)
            answers = records[:, [1, 2, 0, 3]].contiguous()
            res.time(torch, "route_restore", "25 restore S=4",
                     lambda: route_restore(inv, answers),
                     lambda: route_restore_plain(inv, answers),
                     nbytes=N * (4 + 16 + 12), ops=N, plain_calls=1,
                     plain_reps=PLAIN_REPS)
    cap = route_capacity(N, 4, 0.01)
    _, inv, counts = check_route(torch, res, "25 K10 overflow", flat, 4, cap)
    log(f"[25] K10 forced overflow (cap_frac 0.01: {cap} slots an owner): "
        f"{int((inv < 0).sum() - (~flat[2]).sum())} of {N} probes past "
        "their bins")
    if int(counts.max()) <= cap:
        raise AssertionError("the forced overflow did not overflow")

    wdi = wide["di"]
    wflat = [t.reshape(-1) for t in probes(torch, wide, WIDE["k"],
                                           WIDE["w"])]
    wtab = (wdi.fused, wdi.stash, wdi.cfg.ways)
    W = wdi.cfg.ways
    owner = owner_of(wflat[0], wflat[1], 4)
    hit = None
    for s in range(4):
        want = lookup_std_plain(*wflat, *wtab, (4, s))
        res.check("lookup_std_owned", f"25 K4 mask 4 shards, shard {s}",
                  want, lookup_std_owned(*wflat, *wtab, (4, s)))
        hit = want[0] != 0 if hit is None else hit
    mine = wflat[2] & (owner == 0)
    bucket = hash32(wflat[0], wflat[1]) & (wdi.fused.shape[0] - 1)
    need = touched_bytes(torch, bucket, mine, hit, wflat[0], wflat[1], 2 * W,
                         2, wdi.stash)
    n = wflat[0].numel()
    res.time(torch, "lookup_std_owned", "25 K4 mask shard 0",
             lambda: lookup_std_owned(*wflat, *wtab, (4, 0)),
             lambda: lookup_std_plain(*wflat, *wtab, (4, 0)),
             nbytes=n * 21 + need,
             ops=n * 12 + int(mine.sum()) * (4 * W + 16), plain_calls=1,
             plain_reps=PLAIN_REPS)
    log(f"[25] K4's mask on the wide table {tuple(wdi.fused.shape)}, {n} "
        f"probes, {int(mine.sum())} owned by shard 0 of 4, on {card}")
    res.assert_clean(("route_bin", "route_restore", "lookup_std_owned"))


def save_mesh_inputs(torch, deep, wide, card: str) -> dict:
    """The multi-rank phase's inputs on disk for its rank processes: the
    wide std index, the deep reads and the wide pairs, and the one-rank
    steps' outputs they are held to (phase 8's on the pairs, the deep q8
    step's on the 65,536 reads)."""
    work = ROOT / "build" / "chip_smoke" / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    wide["idx"].save(str(work / "wide_idx"))
    deep_out = deep["models"]["q8"](deep["b64"])
    arrays = {"deep_reads": deep["b64"], "wide_b1": wide["b1"],
              "wide_b2": wide["b2"],
              **{f"deep_{k}": v for k, v in deep_out.items()},
              **{f"wide_{k}": v for k, v in wide["out8"].items()}}
    torch.save({k: t.cpu() for k, t in arrays.items()}, work / "inputs.pt")
    return {"work": str(work), "store": str(work / "store"), "card": card,
            "device": str(deep["b64"].device),
            "world": MESH_RANKS, "shapes": [list(s) for s in MESH_SHAPES],
            "deep_sidx": str(deep["dir"] / "sidx"),
            "wide_idx": str(work / "wide_idx")}


def phase_mesh(spec: dict, card: str) -> dict:
    """Phase 26: MESH_RANKS rank processes (this script with --rank) on the
    one card, joined over gloo, at meshes (1, 4) and (2, 2): the deep q8
    index (its 4 file shards streamed at (1, 4), merged two to a shard at
    (2, 2)) on 65,536 reads, broadcast, routed and routed with a forced
    overflow; the wide std world (66,563 taxa, placed with one shard a
    rank of the row) on 16,384 pairs, broadcast and routed. Every rank's
    gathered outputs are held to the one-rank step's. Returns the kernel
    launches summed over the ranks and the cases."""
    Path(spec["work"], "spec.json").write_text(json.dumps(spec))
    t0 = time.time()
    procs = [start_process([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--rank", str(r),
                            str(Path(spec["work"], "spec.json"))])
             for r in range(spec["world"])]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} returned {p.returncode}:\n"
                                 f"{err[-4000:]}")
    for line in outs[0][0].splitlines():
        log(line)
    results = [json.loads(Path(spec["work"], f"rank{r}.json").read_text())
               for r in range(spec["world"])]
    launches = dict.fromkeys(KERNELS, 0)
    bad = 0
    for res in results:
        for case in res["cases"]:
            bad += case["mismatches"]
            for k, v in case["launches"].items():
                launches[k] += v
    for i, case in enumerate(results[0]["cases"]):
        ms = max(r["cases"][i]["ms"] for r in results)
        mism = sum(r["cases"][i]["mismatches"] for r in results)
        log(f"[26] mesh {case['name']}: {case['reads']} {case['unit']}, "
            f"{'routed' if case['routed'] else 'broadcast'} branch, step "
            f"{ms} ms (slowest rank; median of {MESH_REPS}, host clock to a "
            f"synchronize), {case['reads'] / ms * 1e3} reads/s; transport "
            f"gloo, tensors on {card}, {spec['world']} ranks on the one "
            f"card; mismatches over the ranks {mism}")
    log(f"[26] {spec['world']} ranks in {time.time() - t0:.1f} s; kernel "
        f"launches summed over the ranks and cases: {json.dumps(launches)}")
    if bad:
        raise AssertionError(f"the multi-rank steps disagree: {bad}")
    return launches


def rank_main(rank: int, spec_path: str) -> int:
    """One rank of phase 26 (``chip_smoke.py --rank R SPEC``)."""
    import datetime
    import functools

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from pangea_tpu_torch.dist import mesh as M
    from pangea_tpu_torch.index import load_index_any
    from pangea_tpu_torch.kernels import (kernel_launches,
                                          reset_kernel_launches)
    spec = json.loads(Path(spec_path).read_text())
    work = Path(spec["work"])
    cuda = torch.device(spec["device"])
    torch.cuda.set_device(cuda)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=300))

    arrays = torch.load(work / "inputs.pt")

    def load(name):
        return arrays[name].to(cuda)

    sidx = load_index_any(spec["deep_sidx"])
    wide = load_index_any(spec["wide_idx"])
    deep_b, wide_b1, wide_b2 = (load(n) for n in ("deep_reads", "wide_b1",
                                                  "wide_b2"))
    want = {w: [load(f"{w}_{k}") for k in ("taxon", "best", "nvalid")]
            for w in ("deep", "wide")}
    routed = M._local_classify_routed
    cases = []
    for shape in spec["shapes"]:
        mesh = M.Mesh(M.MeshConfig(*shape), cuda)
        t0 = time.time()
        dis = {"deep": M.place_index(sidx, mesh, 0.0),
               "wide": M.place_index(wide, mesh, 0.0)}
        log(f"[26] {mesh!r}: placed the deep shard "
            f"{tuple(dis['deep'].fused.shape)} ({dis['deep'].cfg.layout}) "
            f"and the wide shard {tuple(dis['wide'].fused.shape)} "
            f"({dis['wide'].cfg.layout}) in {time.time() - t0:.1f} s")
        for name, world, routing, cap_frac in (
                ("deep q8", "deep", "broadcast", 1.25),
                ("deep q8 routed", "deep", "alltoall", 1.25),
                ("deep q8 routed, forced overflow", "deep", "alltoall", 0.01),
                ("wide std", "wide", "broadcast", 1.25),
                ("wide std routed", "wide", "alltoall", 1.25)):
            di = dis[world]
            M._local_classify_routed = functools.partial(routed,
                                                         cap_frac=cap_frac)
            fn = M.make_sharded_classify_fn(di.cfg, mesh, paired=True,
                                            replicate_out=True,
                                            routing=routing)
            b1, b2 = (deep_b, None) if world == "deep" else (wide_b1,
                                                             wide_b2)
            b = b1.shape[0] // mesh.cfg.n_data
            rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)

            def step():
                return fn(di.tables, b1[rows], None if b2 is None
                          else b2[rows])

            dist.barrier()
            reset_kernel_launches()
            out = step()
            torch.cuda.synchronize()
            launches = kernel_launches()
            mism = sum(int((out[k] != w).sum()) for k, w in zip(
                ("taxon", "best", "nvalid"), want[world]))
            times = []
            for _ in range(MESH_REPS):
                dist.barrier()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            tag = f"{name} {shape[0]}x{shape[1]}"
            cases.append({"name": tag, "mismatches": mism,
                          "launches": launches,
                          "routed": launches["route_restore"] > 0,
                          "ms": statistics.median(times),
                          "reads": b1.shape[0],
                          "unit": "reads" if b2 is None else "pairs"})
            if cuda.type == "cuda" and (
                    (routing == "alltoall") != (launches["route_bin"] > 0)
                    or (cap_frac < 1) == (launches["route_restore"] > 0)
                    and routing == "alltoall"):
                raise AssertionError(f"{tag}: launches {launches}")
            if name == "deep q8 routed" and tuple(shape) == (1, 4):
                # The profiler phase (f) on rank 0; every rank runs the
                # same steps.
                if rank == 0:
                    phase_profile(torch, {"name": tag + " (rank 0)",
                                          "model": lambda *_: step(),
                                          "b1": b1[rows], "b2": None},
                                  spec["card"] + ", gloo", "26",
                                  PROFILE_STEPS["mesh"])
                else:
                    for _ in range(WARMUP + PROFILE_STEPS["mesh"]):
                        step()
                    torch.cuda.synchronize()
    M._local_classify_routed = routed
    (work / f"rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "cases": cases}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_nccl_one_rank(torch, deep, q8_out: dict, card: str) -> None:
    """Phase 27: a one-rank NCCL world on the card, and the (1, 1) sharded
    step through make_sharded_classify_fn, whose merge is NCCL's
    all-reduce on the hits: its outputs against phase 21's q8 step."""
    import torch.distributed as dist

    from pangea_tpu_torch.dist import mesh as M
    store = ROOT / "build" / "chip_smoke" / "nccl_store"
    store.unlink(missing_ok=True)
    di = deep["dis"]["q8"]
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = M.Mesh(M.MeshConfig(1, 1), di.fused.device)
        fn = M.make_sharded_classify_fn(di.cfg, mesh)
        out = fn(di.tables, deep["b16"])
        torch.cuda.synchronize()
        mism, _ = compare([q8_out[k] for k in ("taxon", "best", "nvalid")],
                          [out[k].cpu() for k in ("taxon", "best",
                                                  "nvalid")])
        ms = time_ms(torch, lambda: fn(di.tables, deep["b16"]), PIPELINED)
        log(f"[27] one-rank NCCL world ({dist.get_backend()}, "
            f"{mesh!r}): the (1, 1) step with NCCL's all-reduce of the hits "
            f"on {card}: {ms} ms back to back for {DEEP_READS} reads; "
            f"mismatches against phase 21's q8 step {mism}")
    finally:
        dist.destroy_process_group()
    if mism:
        raise AssertionError("the NCCL step disagrees")


def phase_config3_cli(torch, deep) -> dict:
    """Phase 28: config 3's CLI (its file, the deep 4-shard index, C3_READS
    single-end reads of the deep reads' seed, batches of 262,144): the mesh
    of one card is (1, 1), so the four file shards lay out as one q8
    table; the first 16,384 lines against the one-rank step at config 3's
    threshold."""
    import dataclasses

    from pangea_tpu_torch.classify import classify_reads
    _, err = deep["gen"].communicate(timeout=900)
    if deep["gen"].returncode != 0:
        raise AssertionError(f"config 3's reads: {err[-4000:]}")
    with open(ROOT / "configs" / "config3_shotgun_sharded.json") as fh:
        thr = json.load(fh)["classify"]["confidence_threshold"]
    world = {"name": "config3", "idx_dirs": [str(deep["dir"] / "sidx")],
             "config": "config3_shotgun_sharded.json"}
    result, rows = run_cli(world, "28", [str(deep["c3_fastq"])],
                           batch=262_144)
    launches = result["kernel_launches"]
    di = deep["dis"]["q8"]
    cfg = dataclasses.replace(di.cfg, confidence_threshold=thr)
    out = classify_reads(di.tables, deep["b16"], cfg)
    ids = deep["reads"].ids
    bad = sum((r[1], int(r[2]), r[5]) != (
        ids[i], int(out["taxon"][i]),
        f"{int(out['best'][i])}/{int(out['nvalid'][i])}")
        for i, r in enumerate(rows[:DEEP_READS]))
    log(f"[28] config 3: {len(rows)} lines, mesh {result['mesh']}, "
        f"{result['batches']} batches, {result['reads_per_sec']} reads/s; "
        f"first {DEEP_READS} lines vs the one-rank step at threshold {thr}: "
        f"mismatches {bad}")
    if len(rows) != C3_READS or bad or result["mesh"] != {"data": 1,
                                                          "shard": 1} \
            or not result["fast_path"] or launches["lookup_q8_sorted"] < 1:
        raise AssertionError(f"config 3's CLI is wrong: {json.dumps(result)}")
    return launches


def phase_rowprobe_kernels(torch, cuda, res: Results, card: str) -> None:
    """Phase 29: K11 and K12 at mb_pallas's shapes against their plain
    versions, bit for bit: K11 on the experiment's world (16,384 x 128,
    524,288 queries, seed 0), on a table of PROBE_TALL_NB rows and at W =
    32; K12 on the same world and on an ONEH_SMALL_NB-row table, every
    query. Bounds: the table read once, 8 B in and 4 B out a query; K12's
    one-hot product is also set against the int8 tensor-core peak."""
    from pangea_tpu_torch.experiments import mb_pallas as MP
    from pangea_tpu_torch.kernels import (rowprobe_onehot,
                                          rowprobe_onehot_plain,
                                          rowprobe_plain, rowprobe_smem)

    def world(**kw):
        return MP.world_tensors(MP.make_world(0, **kw), cuda)

    def probe_bytes(table, n: int) -> int:
        return table.numel() * 4 + n * 12

    t0 = time.time()
    full = world()
    for what, args in (("full", full), ("tall", world(nb=PROBE_TALL_NB)),
                       ("W=32", world(w=32))):
        res.check("rowprobe_smem", f"29 K11 {what} {tuple(args[0].shape)}",
                  [rowprobe_plain(*args)], [rowprobe_smem(*args)])
    table, b, rem = full
    n = b.numel()
    res.time(torch, "rowprobe_smem", "29 K11 full",
             lambda: rowprobe_smem(*full), lambda: rowprobe_plain(*full),
             nbytes=probe_bytes(table, n), ops=n * table.shape[1])

    small = world(nb=ONEH_SMALL_NB)
    for what, args in (("full", full), ("small table", small)):
        res.check("rowprobe_onehot",
                  f"29 K12 {what} {tuple(args[0].shape)}, "
                  f"{args[1].numel()} queries",
                  [rowprobe_onehot_plain(*args)], [rowprobe_onehot(*args)])
    ms = res.time(torch, "rowprobe_onehot", "29 K12 full",
                  lambda: rowprobe_onehot(*full),
                  lambda: rowprobe_onehot_plain(*full),
                  nbytes=probe_bytes(table, n), ops=n * table.shape[1],
                  plain_calls=1, plain_reps=PLAIN_REPS)
    ops = 2 * n * table.shape[0] * 4 * table.shape[1]
    peak_ms = ops / INT8_TC_OPS_PER_S * 1e3
    log(f"[29] K12's one-hot product on {card}: {ops} int8 operations, "
        f"{peak_ms} ms at the {INT8_TC_OPS_PER_S:.4g} op/s int8 peak; the "
        f"kernel's {ms} ms is {100 * peak_ms / ms} % of it; phase 29 in "
        f"{time.time() - t0:.1f} s")
    res.assert_clean(("rowprobe_smem", "rowprobe_onehot"))


def phase_gather_kernels(torch, cuda, res: Results, card: str) -> None:
    """Phase 30: K13 in every variant of experiments.mb_gather at its own
    shapes (the 134.2 MB table, 2^20 or 2^19 indices, each (depth, chunk);
    mb_gather4's block copies), each against row_gather_plain (and
    gather4's against the slice), timed beside torch.index_select (gather4:
    narrow().clone()). Bound: rows read and written once plus the
    indices."""
    from pangea_tpu_torch.experiments import mb_gather as MG
    from pangea_tpu_torch.kernels import (block_copy, row_gather,
                                          row_gather_plain)
    t0 = time.time()
    table, idx = MG.world_tensors(MG.make_world(0), cuda)
    x = torch.from_numpy(MG.block_world()).to(cuda)
    row_bytes = table.shape[1] * 4
    for variant, (n, depth, chunk, direct) in MG.VARIANTS.items():
        if variant.startswith("gather4"):
            name = "block_copy"
            start = torch.tensor([n], dtype=torch.int32, device=cuda)
            got = block_copy(x, start, MG.BLOCK_ROWS)
            bits = got.view(torch.int32)
            res.check(name, f"30 {variant} (the slice)",
                      [x[n:n + MG.BLOCK_ROWS].view(torch.int32)], [bits])
            res.check(name, f"30 {variant}", [row_gather_plain(
                x, start, MG.BLOCK_ROWS).view(torch.int32)], [bits])
            res.time(torch, name, f"30 {variant}",
                     lambda: block_copy(x, start, MG.BLOCK_ROWS),
                     lambda: row_gather_plain(x, start, MG.BLOCK_ROWS),
                     nbytes=2 * MG.BLOCK_ROWS * x.shape[1] * 4 + 4, ops=0,
                     library=lambda: x.narrow(0, n, MG.BLOCK_ROWS).clone(),
                     primary=variant in PRIMARY_GATHERS, variant=variant)
            log_ratio(res, name, variant, "narrow().clone()")
            continue
        name = "row_gather_direct" if direct else "row_gather"
        ix = idx[:n]

        def kernel(ix=ix, depth=depth, chunk=chunk, direct=direct):
            return row_gather(table, ix, depth=depth, chunk=chunk,
                              direct=direct)
        res.check(name, f"30 {variant} ({n} rows of {row_bytes} B, depth "
                  f"{depth}, chunk {chunk})", [row_gather_plain(table, ix)],
                  [kernel()])
        ms = res.time(torch, name, f"30 {variant}", kernel,
                      lambda ix=ix: row_gather_plain(table, ix),
                      nbytes=2 * n * row_bytes + 4 * n, ops=0,
                      library=lambda ix=ix: torch.index_select(table, 0, ix),
                      primary=variant in PRIMARY_GATHERS, variant=variant)
        log(f"[30] {variant} on {card}: {n / ms * 1e3} rows/s")
        log_ratio(res, name, variant, "torch.index_select")
    log(f"[30] phase 30 in {time.time() - t0:.1f} s")
    res.assert_clean(("row_gather", "row_gather_direct", "block_copy"))


def log_ratio(res: Results, name: str, variant: str, library: str) -> None:
    """One line: a K13 variant's time over its library call's, and over its
    bound."""
    v = res.k[name]["variants"][variant]
    log(f"[30] {variant}: {v['ms'] / v['library_ms']} x {library} "
        f"({v['ms']} / {v['library_ms']} ms), {v['ms'] / v['bound_ms']} x "
        f"its bound ({v['bound_ms']} ms)")


def phase_experiment_clis() -> dict:
    """Phase 31: `python -m pangea_tpu_torch.experiments.mb_pallas` and
    `... .mb_gather` as a user runs them, with their defaults: every line
    at 0 mismatches; returns each process's kernel launches."""
    clis = {}
    for mod in ("mb_pallas", "mb_gather"):
        t0 = time.time()
        proc = start_process([sys.executable, "-m",
                              f"pangea_tpu_torch.experiments.{mod}"])
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{mod} returned {proc.returncode}:\n"
                                 f"{err[-4000:]}")
        lines = [json.loads(line) for line in out.splitlines()
                 if line.startswith("{")]
        for line in lines[:-1]:
            log(f"[31] {mod}: {json.dumps(line)}")
        if any(line["mismatches"] for line in lines[:-1]):
            raise AssertionError(f"{mod} disagrees with its plain version")
        clis[mod] = lines[-1]["kernel_launches"]
        log(f"[31] {mod} in {time.time() - t0:.1f} s: {len(lines) - 1} "
            f"variants, kernel launches {json.dumps(clis[mod])}")
    return clis


def write_fastq(world, name: str = "bench") -> tuple:
    from pangea_tpu_torch.bench import write_fastq_pair
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    paths = (str(work / f"{name}_1.fastq"), str(work / f"{name}_2.fastq"))
    write_fastq_pair(world["reads"], *paths)
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "pangea_tpu_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/pangea_tpu_torch",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank"]:             # a rank of phase 26
        return rank_main(int(sys.argv[2]), sys.argv[3])
    sys.path.insert(0, str(ROOT / "src"))
    from pangea_tpu_torch.kernels import KERNELS as WRAPPERS
    if set(WRAPPERS) != set(KERNELS):
        raise AssertionError(f"kernels {sorted(WRAPPERS)} != "
                             f"{sorted(KERNELS)}")
    cuda = torch.device("cuda", 0)
    t_start = time.time()
    card = phase_device(torch)
    phase_build()
    deep = start_deep_build()
    try:
        return run_phases(torch, cuda, card, deep, t_start)
    finally:
        for name in ("proc", "ooc", "gen"):
            if deep[name] is not None and deep[name].poll() is None:
                deep[name].kill()
                deep[name].wait()


def run_phases(torch, cuda, card: str, deep: dict, t_start: float) -> int:
    res = Results()
    none = dict.fromkeys(KERNELS, 0)

    # Phases 3-6: the q8 headline.
    q8 = make_world(torch, cuda, "headline", CLI_PAIRS, **HEADLINE)
    fastq = write_fastq(q8)
    phase_q8_kernels(torch, q8, cuda, res)
    out = phase_step(torch, q8, card, "4", {**none, "extract_probes": 2,
                                            "lookup_q8": 1, "score_tin": 1},
                     plain_calls=PIPELINED, plain_reps=REPS)
    q8_cli = phase_cli(q8, out, "5", fastq)
    phase_profile(torch, q8, card, "6", PROFILE_STEPS["q8"])
    del q8

    # Phases 7-10: the std layout and the big-taxonomy LCA.
    worlds = {"wide": make_world(torch, cuda, "wide", CLI_PAIRS, **WIDE),
              "packed": make_world(torch, cuda, "packed", 1, **PACKED),
              "q8_lift": make_world(torch, cuda, "q8_lift", 1, **Q8_LIFT)}
    # The worlds share genomes and seeds, so their reads are the bench's.
    for name in ("packed", "q8_lift"):
        worlds[name]["b1"], worlds[name]["b2"] = (worlds["wide"]["b1"],
                                                  worlds["wide"]["b2"])
    phase_std_kernels(torch, worlds, cuda, res)
    wide = worlds["wide"]
    out = wide["out8"] = phase_step(torch, wide, card, "8", {
        **none, "extract_probes": 2, "lookup_std": 1, "score_taxon": 1,
        "lca_lift": 1}, plain_calls=1, plain_reps=PLAIN_REPS)
    std_cli = phase_cli(wide, out, "9", fastq)
    phase_profile(torch, wide, card, "10", PROFILE_STEPS["std"])
    del worlds                      # the wide world serves phases 15-18

    # Phases 11-14: config 4's multi-k consensus.
    c4 = make_multik(torch, cuda, CLI_PAIRS)
    c4_fastq = write_fastq(c4, "config4")
    phase_multik_kernels(torch, c4, cuda, res)
    out = phase_step(torch, c4, card, "12", {
        **none, "extract_probes": 4, "lookup_q8": 1, "lookup_q12": 1,
        "score_tin": 2, "merge_multik": 1}, plain_calls=1,
        plain_reps=PLAIN_REPS)
    c4_cli = phase_cli(c4, out, "13", c4_fastq)
    phase_profile(torch, c4, card, "14", PROFILE_STEPS["multik"])
    del c4

    # Phases 15-18: the CLI's two read paths on the std world.
    from pangea_tpu_torch.bench import long_read_mix
    from pangea_tpu_torch.utils import datagen
    phase_packed_kernels(torch, wide, fastq, cuda, res)
    phase_ranked_kernels(torch, wide, cuda, res)
    mix = long_read_mix(wide["reads"], LONG_SHORT, wide["genomes"],
                        LONG_READS, LONG_MIN, LONG_MAX, LONG_SEED)
    long_fastq = str(ROOT / "build" / "chip_smoke" / "long.fastq")
    datagen.write_fastq(long_fastq, mix, mate=1)
    outs = phase_long_step(torch, wide, cuda, card, mix)
    long_cli, rows17 = phase_long_cli(wide, mix, outs, long_fastq)
    fast_long_cli = phase_fast_long_cli(wide, mix, rows17, long_fastq)

    # Phases 19-23: the deep-table path on the deep world.
    phase_deep_build(torch, cuda, deep)
    phase_deep_kernels(torch, deep, wide, res, card)
    q8_out = phase_deep_steps(torch, deep, card)
    deep_cli = phase_deep_cli(deep, q8_out)
    phase_profile(torch, {"name": "deep q8", "model": deep["models"]["q8"],
                          "b1": deep["b16"], "b2": None}, card, "23",
                  PROFILE_STEPS["deep"])

    # Phases 24-28: config 3's sharded index.
    phase_sharded_build(torch, deep)
    phase_route_kernels(torch, deep, wide, res, card)
    spec = save_mesh_inputs(torch, deep, wide, card)
    del wide
    mesh = phase_mesh(spec, card)
    phase_nccl_one_rank(torch, deep, q8_out, card)
    c3_cli = phase_config3_cli(torch, deep)

    # Phases 29-31: the Pallas experiments' kernels and entry points.
    phase_rowprobe_kernels(torch, cuda, res, card)
    phase_gather_kernels(torch, cuda, res, card)
    experiments = phase_experiment_clis()

    # The main paths' launches: each CLI run's own counts, the q12 and std
    # deep steps' (phase 21), the multi-rank steps' (phase 26) and the
    # experiment entry points' (phase 31).
    clis = {"q8": q8_cli, "std": std_cli, "multik": c4_cli,
            "long": long_cli, "fast_long": fast_long_cli, "deep": deep_cli,
            "deep_q12_step": deep["launches"]["q12"],
            "deep_std_step": deep["launches"]["std"], "mesh": mesh,
            "config3": c3_cli, **experiments}
    for path, kernels in (
            ("q8", ("extract_packed", "lookup_q8", "score_tin")),
            ("std", ("extract_packed", "lookup_std", "score_taxon",
                     "lca_lift")),
            ("multik", ("extract_packed", "lookup_q8", "lookup_q12",
                        "score_tin", "merge_multik")),
            ("long", ("extract_probes", "lookup_std", "score_taxon",
                      "score_ranked", "lca_lift")),
            ("fast_long", ("extract_packed", "lookup_std", "score_taxon",
                           "lca_lift")),
            ("deep", ("extract_packed", "bucket_sort", "lookup_q8_sorted",
                      "score_tin")),
            ("deep_q12_step", ("extract_probes", "bucket_sort",
                               "lookup_q12_sorted", "score_tin")),
            ("deep_std_step", ("extract_probes", "bucket_sort",
                               "lookup_std_sorted", "score_taxon")),
            ("mesh", ("extract_probes", "route_bin", "route_restore",
                      "lookup_std_owned", "score_tin", "score_taxon")),
            ("config3", ("extract_packed", "bucket_sort", "lookup_q8_sorted",
                         "score_tin")),
            ("mb_pallas", ("rowprobe_smem", "rowprobe_onehot")),
            ("mb_gather", ("row_gather", "row_gather_direct", "block_copy"))):
        if min(clis[path][k] for k in kernels) < 1:
            raise AssertionError(f"the {path} path bypassed a kernel: "
                                 f"{clis[path]}")
    launches = {k: sum(c[k] for c in clis.values()) for k in KERNELS}
    log(f"[32] kernel launches of the seven CLI runs, the two deep steps, "
        f"the multi-rank steps and the two experiment entry points: "
        f"{json.dumps(clis)}; whole run {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": ref,
         "launches": launches[name],
         "max_abs_err": res.k[name]["max_abs_err"],
         "ms": res.k[name]["ms"], "plain_ms": res.k[name]["plain_ms"],
         "bound_ms": res.k[name]["bound_ms"],
         "bound_by": res.k[name]["bound_by"],
         "library_ms": res.k[name]["library_ms"],
         **({"variants": res.k[name]["variants"]}
            if "variants" in res.k[name] else {})}
        for name, (src, ref) in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
