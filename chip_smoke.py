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
24-28 drive config 3's sharded index, phases 29-31 the repository's
Pallas experiments (B16: K11-K13) through the port's `experiments` entry
points, and phases 32-35 config 5's cohort run (trim, demux, resume and
report) on the deep index. The CLI runs of phases 5, 5b, 5c, 9, 13, 18,
22, 28, 32 and 33 take the fast path (the native reader, built with g++
from the checkout), phases 17's and 34's the general path. Each main
step (phases 4, 8, 12 and 21) is held on its first GOLDEN_READS reads to
the port's golden model (pangea_tpu_torch.golden, the reference bench's
parity check):

  1. device check: torch and CUDA versions, the card's name and power limit;
  2. build: one nvcc a source of src/pangea_tpu_torch/csrc, all at once,
     then one link;
  3. K1-K3 against their plain PyTorch versions, bit for bit, at the bench
     shapes (16384 pairs of 150 bp reads), plus K1 and its packed form on
     their edge worlds (bench.k1_edge_world: k in {1, 21, 31}, w in {1, 3,
     8, 32}, reads of k, 31 + k, 32 + k, 33 + k and 16,384 bases, N and bad
     flags at positions 31, 32, 63 and 64, codes below 0, col0 > 0, the wire
     rows a column slice of a wider batch), K2 on a table with a forced
     stash, on K2's q8 edge tables (bench.k2_edge_world: r = 0 and 22-25,
     a repeated key in a row, W = 4 with a forced stash, a 3,000-column
     stash past the shared-memory cap; every probe, N = 0, 1, 33 and past
     three steps of the persistent grid) and on the headline's probes at
     every plan kernels.lookup_sweep sweeps, timed with its plan
     (kernels.lookup.quot_plan) in its `variants` map, K9 and K10 on their
     edge cases (bench.k9_edge_world: 0, 1, 33 probes, a tile and one
     either side, past three tiles, every valid probe on one key or owner,
     every probe invalid, K9 at NB = 2^9 and 2^22 and the k = 31 q12 and
     std rules, K10 at 1-4,096 owners and one slot an owner; each K10 case
     again on a grid filled with -1 first, bench.route_bin_dirty, so that
     an unused slot left unwritten shows), and K3 at two
     thresholds, on the lookups and on scorer worlds
     of chosen U (bench.score_world: U = 1, 8 and R, nested along a
     lineage and from unrelated taxa), each world's mean and largest U and
     its reads that took the general branch logged; mismatches and times;
  4. the q8 Classifier on that batch: every kernel's launch count, the
     outputs against the plain path, the golden model and the reads'
     planted truth, and the step time of both paths by CUDA events;
  5. the q8 main path as a user drives it: `python -m pangea_tpu_torch.cli
     classify` on config 2's file and 24,576 pairs in three batches of
     8192 (the fast path), with its kernel launches, its lines against
     phase 4's outputs, and its host time by phase;
 5b. the same CLI at PANGEA_INFLIGHT 1 and 8 (the fast path's drain queue;
     phase 5 ran its default, 4): files byte for byte phase 5's, reads/s
     at each depth;
 5c. PANGEA_PROFILE on the same CLI: its lines equal to phase 5's, the
     Chrome trace written, naming K1's, K2's and K3's kernels;
  6. torch.profiler over back-to-back q8 steps: the device time of each
     kernel (and a JSON line of it by kernel) and the device's busy share
     of the wall;
  7. K1 at w=1 on the std world's pairs, timed beside its bound (its
     `variants` entry w1_std); K4, K3's taxon form and K5 against their
     plain versions, bit for bit: K4 on the wide table with 16384 pairs x
     260 probes, on the k=31 packed table and on a table with a forced stash, the wide and packed
     tables timed beside their bounds, each with its launch plan
     (kernels.lookup.std_plan) in K4's `variants` map; K3-taxon at two
     thresholds, also on scorer worlds of U = 1, 8, 64 and R at 16,384 x
     260, 64 x 1,180 and 16 x 2,048 (past score_cap(R) distinct
     intervals, the general branch); K5, the scorer's lifted launch, one
     launch a call, against the plain winners and K5 at two thresholds,
     timed beside its bound, also on a 5,251-taxon q8 world and on a
     5,000-node chain (13 lifting levels, the winners deep chain nodes);
  8. the std Classifier at full width: launch counts of K1, K4, K3 and K5
     (in K3's launch: four launches of their own), the outputs against
     the plain path, golden and the planted truth, step times;
  9. the CLI on the std index (written by the port's Index.save) with
     config 2's file and 24,576 pairs, its lines against phase 8's outputs;
 10. torch.profiler over back-to-back std steps;
 11. K2's q12 form and K7 against their plain versions, bit for bit: K2-q12
     on the 67.1 MB table with 16384 pairs x 240 probes, on a table with a
     forced stash, on absent 62-bit keys and on a forced-q12 table at k=21
     (remainder below 32 bits), on K2's q12 edge tables (r = 0, 20, 32, 54
     and 62, slots sharing a rem_lo, W = 4 with a forced stash, a
     3,000-column stash; the sizes of phase 3) and on the full-width
     probes at every swept plan, timed with its plan; K7, the scorer's
     merged launch (the k=31 index's K3 with the k=21 index's call as its
     prior), one launch a call, against the plain scorer and K7 on the
     full-width calls at thresholds 0 and 0.05, on the int32 extreme cases
     in the prior, and on reads of the 66,563-taxon tree and of the
     5,000-node chain merged with conflicting calls, timed beside its
     bound;
 12. the multi-k step at full width: launch counts (K1 four times, K2 and
     its q12 form, K3 twice, K7 in the second: eight launches of their
     own), the outputs against the plain path, golden (each index's calls
     merged) and the planted truth, step times;
 13. the CLI on the two indexes (written by the port's Index.save) with
     config 4's file and 24,576 pairs, its lines against phase 12's;
 14. torch.profiler over back-to-back multi-k steps;
 15. K8 and K1's packed form against their plain versions, bit for bit: K8
     at R = 2,049 (512 reads), 16,364 (75 reads: one read of the 16,384
     bucket, sorted in shared memory) and 32,728 (75 pairs of that bucket,
     sorted in a device scratch), q8 and taxon forms, with the direct LCA
     (the headline's 67-taxon tree) and K5's lifting (66,563 taxa), at two
     thresholds, and on scorer worlds of U = 1, 8, 64 and R at each shape;
     K1's packed form on the headline pairs as the native
     reader packs them (w=8 and w=1), held to its plain version and to K1
     on the codes, and timed at both w beside its bound;
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
     form also on config 4's k=31 table (phase 11); both forms of K2 on the
     deep probes at every swept plan, and the sorted forms on K2's edge
     tables at the sizes of phase 3; each sorted form timed with its plan;
     the unsorted and sorted
     K4 on the deep std table and the sorted K4 on the wide one logged with
     their plans, bounds and ratios in the kernels' `variants` maps;
 21. the deep steps through the Classifier: q8 and q12 on 16,384 reads, std
     on 65,536 (where the std gate engages): launch counts (K1, K9 and the
     sorted form; no unsorted lookup), the outputs against the plain path
     and the planted lineage, step times; then each with PANGEA_DEEP_SORT=0
     (the unsorted lookup) in the same call; the q8 step against golden;
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
     against its plain version, timed beside its bound (K4's mask with
     its plan and ratio in its `variants` map);
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
 29. K11 and K12 (the Pallas row probe of experiments/mb_pallas.py) and
     the routing pass that orders their queries by table tile, against
     their plain versions, bit for bit (the routing pass by key, count and
     record multiset): on the experiment's world (a 16,384 x 128 table,
     524,288 queries, seed 0), on a 65,536-row table, at W = 32 (with row
     numbers past the table and below 0), on a 1,024-row table, with
     every query in one row, and with the queries in every other 32-row
     tile; timed (each call's routing pass in), and K12's one-hot product,
     dense and over the k-tiles it visits, set against the int8 peak;
 30. K13 (the Pallas row gathers of experiments/mb_gather2-5.py) in every
     variant of `experiments.mb_gather` at the scripts' shapes (a [2^19,
     64] uint32 table of 134.2 MB, 2^20 or 2^19 indices, each (depth,
     chunk), staged and direct; mb_gather4's 8-row block copies), against
     row_gather_plain and timed beside torch.index_select, each variant's
     ratio to it on a line of its own and in its kernel's `variants` map;
 31. `python -m pangea_tpu_torch.experiments.mb_pallas` and `... .mb_gather`
     as a user runs them: their lines at 0 mismatches, their launches;
 32. config 5's CLI: `--config configs/config5_cohort.json` (batch
     262,144, L 300, threshold 0.05, resume on, one card) on the deep
     index with C5_READS single-end reads of a pooled cohort of 4 barcoded
     samples (bench.cohort_fastq: 150 bp behind 8 bp barcodes, qualities
     falling toward the 3' end, one-base barcode errors and unmatched
     barcodes planted; made by a process started at phase 24), trimmed
     (min_qual 20, window 4, min_len 60) and demultiplexed (one
     mismatch) on the fast path: K1's packed form, K9, sorted K2 and K3
     launched; the trimmed, dropped, undetermined and per-sample shares,
     each above 0; the classified reads on their planted truth's lineage;
     reads/s and host time by phase;
 33. the same run killed by SIGKILL once metrics.jsonl has 2 lines (the
     manifest committed every batch), then resumed with --resume: its
     files byte for byte the whole run's, the manifest's paths aside; the
     resume's wall and reads/s;
 34. the general path (PANGEA_NO_NATIVE) on the cohort's first 65,536
     reads: each sample's lines equal to phase 32's for those reads;
 35. `cli report` on phase 32's assignment files: its summaries, cohort
     table and stats.json byte for byte the run's;
 36. the launch summary.

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
non-tensor 32-bit peak, an optimistic rate for integer work). K1 reads its
codes (1 B a base) or wire rows (4 B a word) once and writes 9 B a
probe; its least operations are, at each of the NW x w positions its
windows cover, one k-mer and its validity test (12: five 64-bit
operations, the shift out of the stream, its mask, the complement, the
pair reversal and the min, and a 64-bit mask test, two 32-bit operations
each) and, where w > 1, one hash32 (18: two fmix32 and two xors), plus w
- 1 compares a window (kernels.minimize.k1_cost). A table
counts only what this run's probes need: the key lanes of the buckets they
reach, the payload lanes of the keys they hit and the stash (K2, K2-q12,
K4; never the pad lanes); for K5 and K7, the scorer's bytes and
operations plus the depth, parent and lifting entries of the lineages its
pairs (K7: its conflicting pairs) reach and, for K7, the prior's three [B]
inputs. K3 and K8 (the scorer) read each probe's
13 bytes once and write their [B] outputs once; their operations are the
least of the exact form they run: one key a probe and U^2 compares a read
over its U distinct (t_in, t_out) intervals (U counted from this run's
data), plus (T + 1) x 6 a read for the direct LCA scan. K9's bytes are
its probes' lanes read once and its 16-byte records and inverse
permutation written once, its operations a key a probe; a sorted form
reads the records and the inverse in place of the probes' lanes and
writes the outputs. K10 reads a probe's 9 bytes and writes its slot (4
bytes) and the [S, C] grid of 16-byte records once; its restore reads a
slot and a 16-byte answer and writes 12 bytes a probe; K4's masked form
reads every probe's lanes and writes its outputs, and touches the table
only for the probes it owns.
K11 and K12 read the table once and 8 B and write 4 B a query, with 2W
operations a query; K12's one-hot product is also logged against the
1,979 T/s dense int8 tensor-core peak. K13 reads and writes each row once
and reads 4 B an index. library_ms is one PyTorch call of the same
function, timed and used nowhere in the port: torch.index_select for K13's
gathers, narrow().clone() for its block copy, index_select of the 16-byte
records by inv for K9's restore (out[i] = record[inv[i]], the three
outputs left interleaved; on the routed answers the -1 slots of invalid
probes are clamped to row 0 outside the timed call, so that call reads
row 0 where the restore writes zeros), and null for the kernels that no
one PyTorch call computes.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Any failed phase raises and the exit
code is non-zero; so it is without a CUDA device.
"""
from __future__ import annotations

import json
import os
import re
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
# The golden model holds each main step on its first GOLDEN_READS reads.
GOLDEN_READS = 2048
# The CUDA kernels of K1, K2 and K3 by name, as a trace shows them.
TRACE_KERNELS = ("extract_probes_kernel", "lookup_quot_kernel",
                 "score_kernel")
# Config 5 (phases 32-35): its file on the deep index, C5_READS single-end
# reads of a pooled cohort of C5_SAMPLES barcoded samples (bench.cohort_fastq
# on the deep genomes: qualities falling toward the 3' end, barcode errors
# planted), trimmed and demultiplexed as C5_OPTIONS set; the general path
# on its first C5_GENERAL reads.
C5_READS, C5_SAMPLES, C5_GENERAL = 1_048_576, 4, 65_536
C5_OPTIONS = ("trim.min_qual=20", "trim.window=4", "trim.min_len=60",
              "demux.max_mismatch=1")
# The scorer's worlds of chosen U (bench.score_world) in phases 3, 7 and
# 15: U = 1, 8, 64 and R (None: every probe a hit of its own), nested
# along a chain's lineage and from unrelated taxa of the 66,563-taxon tree,
# with U_MISS of the probes misses; the K3 shapes of phase 7 beside the
# wide world's.
U_WORLDS = (1, 8, 64, None)
U_MISS = 0.5
K3_SHAPES = ((1180, 64), (2048, 16))
# The Pallas experiments (phases 29-31): the routing pass, K11 and K12 on
# mb_pallas's world and on tables of PROBE_TALL_NB (2,048 routing keys) and
# ONEH_SMALL_NB rows, every query. K13's variants
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
# name -> (kernel source, the reference function it replaces). lca_lift
# (K5) and merge_multik (K7) are the scorer's lifted and merged tails
# (csrc/common.cuh score_tail): their counts are scorer launches that the
# scorer's own count holds too (TAIL_KERNELS).
TAIL_KERNELS = ("lca_lift", "merge_multik")
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
    "lca_lift": ("src/pangea_tpu_torch/csrc/common.cuh",
                 "src/pangea_tpu/kernels/score.py:127"),
    "lookup_q12": ("src/pangea_tpu_torch/csrc/lookup_q8.cu",
                   "src/pangea_tpu/kernels/lookup.py:629"),
    "merge_multik": ("src/pangea_tpu_torch/csrc/common.cuh",
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
    "rowprobe_route": ("src/pangea_tpu_torch/csrc/bucket_sort.cu",
                       "experiments/mb_pallas.py:83, experiments/"
                       "mb_pallas.py:118"),
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
             variant: str | None = None, plan: dict | None = None) -> float:
        """Kernel ms (PIPELINED calls a sample), plain ms and the bound,
        and the ms of ``library``, one PyTorch call of the same function
        (timed, never used). ``primary`` False only logs them; a
        ``variant`` also goes into the kernel's ``variants`` map, with its
        ratio to the bound and the launch ``plan``. Returns the kernel
        ms."""
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
                "ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "vs_bound": ms / bound_ms,
                **({"plan": plan} if plan is not None else {})}
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


def check_k1_edges(torch, cuda, res: Results) -> None:
    """K1 and its packed form against their plain versions on K1's edge
    worlds, bit for bit (see phase 3)."""
    from pangea_tpu_torch.bench import k1_edge_world
    from pangea_tpu_torch.kernels import (extract_probes,
                                          extract_probes_plain, wire_width)
    n = 0
    for k in (1, 21, 31):
        for w in (1, 3, 8, 32):
            for L in (k, 31 + k, 32 + k, 33 + k, MAX_LONG):
                nw = (L - k + 1) // w
                if nw == 0:
                    continue
                B = 40 if L < MAX_LONG else 8
                codes, rows = k1_edge_world(B, L, seed=L + k + w)
                W = wire_width(L)
                wide = torch.full((B, 2 * W + 3), 0x5A5A5A5A,
                                  dtype=torch.int32, device=cuda)
                part = wide[:, W + 2:2 * W + 2]
                part.copy_(torch.from_numpy(rows.view("int32")))
                c = torch.from_numpy(codes).to(cuda)

                def run(fn, src, packed):
                    out = (torch.full((B, nw + 9), 7, dtype=torch.int32,
                                      device=cuda),
                           torch.full((B, nw + 9), 7, dtype=torch.int32,
                                      device=cuda),
                           torch.zeros((B, nw + 9), dtype=torch.bool,
                                       device=cuda))
                    if packed:
                        fn(src, k, w, out, 4, packed_len=L)
                    else:
                        fn(src, k, w, out, 4)
                    return out
                want = run(extract_probes_plain, c, False)
                for name, fn, src, packed in (
                        ("extract_probes", extract_probes, c, False),
                        ("extract_packed", extract_probes, part, True)):
                    mism, err = compare(want, run(fn, src, packed))
                    r = res.k[name]
                    r["mismatches"] += mism
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    if mism:
                        log(f"[3 K1 edge k={k} w={w} L={L}] {name}: "
                            f"mismatches {mism}")
                n += 1
    log(f"[3] K1 and its packed form on {n} edge worlds (k, w, L): "
        f"mismatches {res.k['extract_probes']['mismatches']} / "
        f"{res.k['extract_packed']['mismatches']}")


def table_bytes(di) -> int:
    return (di.fused.numel() + di.stash.numel()) * 4


def touched_bytes(torch, bucket, valid, hit, hi, lo, key_lanes: int,
                  payload_lanes: int, stash) -> int:
    """Bytes of a hash table that these probes need: the key lanes of every
    bucket a valid probe reaches, the lanes past them that every distinct
    key that hits reads (its payload; q12's rem_hi too), and the whole
    stash (every valid probe scans it)."""
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


def distinct_per_read(lanes, t_in, t_out):
    """[B] distinct (t_in, t_out) intervals among each read's hits, of
    [B, R] tensors."""
    from pangea_tpu_torch.bench import distinct_intervals
    return distinct_intervals(*(t.cpu().numpy() for t in (lanes, t_in,
                                                          t_out)))


def score_ops(lanes, t_in, t_out) -> int:
    """The scorer's least operations on these inputs: a key a probe and
    U^2 compares a read over its U distinct intervals."""
    u = distinct_per_read(lanes, t_in, t_out).astype("int64")
    return lanes.numel() + int((u * u).sum())


def check_score(torch, res: Results, name: str, what: str, args, tax,
                taxon_lanes: bool, want_general=None) -> None:
    """A scorer (K3 ``name`` or K8) against its plain version on one
    input: winners, and the direct or lifted LCA at THRESHOLDS; logs the
    reads that took the general branch (and holds them to
    ``want_general`` over the three launches where it is given)."""
    from pangea_tpu_torch.kernels import (general_reads, reset_general_reads,
                                          score_ranked, score_reads_plain,
                                          score_reads_taxon, score_reads_tin,
                                          score_winners, score_winners_plain)
    from pangea_tpu_torch.kernels.score import MAX_PROBES
    R = args[0].shape[1]
    form = "taxon" if taxon_lanes else "q8"
    reset_general_reads()
    res.check(name, f"{what}, {form} winners",
              score_winners_plain(*args, taxon_lanes),
              score_winners(*args, taxon_lanes))
    for thr in THRESHOLDS:
        if R > MAX_PROBES:
            got = score_ranked(*args, tax, thr, taxon_lanes)
        elif taxon_lanes:
            got = score_reads_taxon(*args, tax, thr)
        else:
            got = score_reads_tin(*args, tax, thr)
        res.check(name, f"{what}, {form}, threshold {thr}",
                  score_reads_plain(*args, tax, thr, taxon_lanes), got)
    general = general_reads()[name]
    log(f"[{what}] {name} {form}: {general} reads took the general branch "
        "in 3 launches")
    if want_general is not None and general != want_general:
        raise AssertionError(f"{general} general-branch reads, want "
                             f"{want_general}")


_TAXA: dict = {}


def check_u_worlds(torch, res: Results, name: str, tag: str, B: int,
                   R: int, forms, cuda) -> None:
    """The scorer ``name`` against its plain version on score_world inputs
    of B reads of R probes at each U of U_WORLDS, nested and unrelated, in
    ``forms`` (True: taxon lanes, False: q8 hit counts); each world's mean
    and largest U, and the reads past score_cap(R) distinct intervals (all
    but read 0, which has no hit) held to the general branch."""
    from pangea_tpu_torch.bench import chain_taxonomy, score_world
    from pangea_tpu_torch.kernels.score import score_cap
    from pangea_tpu_torch.utils import datagen
    if "wide" not in _TAXA:
        _TAXA["wide"] = datagen.make_taxonomy(2, *WIDE["tree"], seed=0)
    for U in U_WORLDS:
        for nested in (False, True):
            miss = 0.0 if U is None else U_MISS
            hits = R - round(miss * R)
            if U is not None and U > hits:
                continue
            distinct = hits if U is None else U
            if nested:
                n = max(distinct, 64) + 2
                if n not in _TAXA:
                    _TAXA[n] = chain_taxonomy(n)
                tax = _TAXA[n]
            else:
                tax = _TAXA["wide"]
            world = score_world(tax, B, R, U, nested, miss,
                                seed=R + distinct)
            lanes, t_in, t_out, valid = (torch.from_numpy(a).to(cuda)
                                         for a in world)
            u = distinct_per_read(lanes, t_in, t_out)
            what = (f"{tag} U={'R' if U is None else U} "
                    f"{'nested' if nested else 'unrelated'}, {R} x {B}")
            log(f"[{what}] {tax.num_taxa} taxa; distinct intervals a "
                f"read: mean {float(u.mean())}, largest {int(u.max())}")
            dev_tax = {k: torch.from_numpy(v).to(cuda)
                       for k, v in tax.device_arrays().items()}
            for taxon_lanes in forms:
                lanes_f = lanes if taxon_lanes else (lanes != 0).to(
                    torch.int32)
                check_score(torch, res, name, what,
                            (lanes_f, t_in, t_out, valid), dev_tax,
                            taxon_lanes,
                            3 * (B - 1) if distinct > score_cap(R) else 0)


def k2_plan(n: int, fused, stash, q12: bool,
            sorted_form: bool = False) -> dict:
    """K2's launch plan (kernels.lookup.quot_plan) for n probes of a q8 or
    q12 table, as its wrapper takes it."""
    from pangea_tpu_torch.index.quot import Q12_WAYS
    from pangea_tpu_torch.kernels import _build
    from pangea_tpu_torch.kernels.lookup import quot_plan
    ways = Q12_WAYS if q12 else fused.shape[1] // 2
    return quot_plan(n, ways, stash.shape[1], q12, sorted_form,
                     _build.sm_count(fused.device.index))._asdict()


def check_k2_edges(torch, cuda, res: Results, q12: bool, sorted_form: bool,
                   tag: str) -> None:
    """K2's q8 or q12 form, unsorted or sorted, against its plain version
    on each of K2's edge tables of that form (bench.k2_edge_world: q12 at
    r = 0, 20, 32, 54 and 62, q8 at r = 0 and 22-25, rows with a shared
    rem_lo and a repeated key, W = 4 with a forced stash, 3,000-column
    stashes past the shared-memory cap): every probe, N = 0, 1, 33 and
    past three steps of the persistent grid, not a multiple of 32."""
    from pangea_tpu_torch.bench import K2_EDGE, k2_edge_world
    from pangea_tpu_torch.kernels import (_build, lookup_q8, lookup_q8_plain,
                                          lookup_q8_sorted, lookup_q12,
                                          lookup_q12_plain, lookup_q12_sorted)
    from pangea_tpu_torch.kernels.lookup import quot_plan
    fn = {(False, False): lookup_q8, (False, True): lookup_q8_sorted,
          (True, False): lookup_q12, (True, True): lookup_q12_sorted}[
              q12, sorted_form]
    plain = lookup_q12_plain if q12 else lookup_q8_plain
    name = fn.__name__
    full = quot_plan(1 << 30, 42, 0, True, False, _build.sm_count(cuda.index))
    steps = 3 * full.grid * full.warps * 32 + 17
    worlds = 0
    for world, spec in K2_EDGE.items():
        if spec[0] != q12:
            continue
        worlds += 1
        w = k2_edge_world(world)
        probes = [torch.from_numpy(w[key] if key == "valid"
                                   else w[key].view("int32")).to(cuda)
                  for key in ("hi", "lo", "valid")]
        tab = [torch.from_numpy(w[key].view("int32")).to(cuda)
               for key in ("fused", "stash")]
        extra = (w["k"], w["ways"]) if q12 else (w["k"],)
        want, got = [], []
        for n in (probes[0].numel(), 0, 1, 33, steps):
            reps = -(-n // probes[0].numel()) if n else 0
            flat = [t.repeat(reps)[:n] for t in probes]
            want += plain(*flat, *tab, *extra)
            got += fn(*flat, *tab, *extra)
        res.check(name, f"{tag} K2 edge {world}, N = {probes[0].numel()}, "
                  f"0, 1, 33, {steps}", want, got)
    log(f"[{tag}] {name} on {worlds} K2 edge tables")


def check_bin_edges(torch, cuda, res: Results) -> None:
    """K9 and K10 against their plain versions on their edge cases
    (bench.k9_edge_world, see phase 3), as check_sort and check_route hold
    them; K10 through its wrapper and again on a grid filled with -1 first
    (bench.route_bin_dirty), where a slot left unwritten shows."""
    from pangea_tpu_torch.bench import (K9_EDGE, k9_edge_world,
                                        route_bin_dirty)
    from pangea_tpu_torch.kernels.route import route_capacity
    for name in K9_EDGE:
        w = k9_edge_world(name)
        flat = [torch.from_numpy(w[key] if key == "valid"
                                 else w[key].view("int32")).to(cuda)
                for key in ("hi", "lo", "valid")]
        what = f"3 K9/K10 edge {name}"
        if w["kind"] == "sort":
            check_sort(torch, res, what, flat, w["nb"], w["k"])
            continue
        S = w["n_shards"]
        cap = w["cap"] or route_capacity(flat[0].numel(), S)
        check_route(torch, res, what, flat, S, cap)
        check_route(torch, res, what + " dirty", flat, S, cap,
                    route_bin_dirty)
    log(f"[3] K9 and K10 on {len(K9_EDGE)} edge cases")


def check_k2_plans(torch, res: Results, name: str, tag: str, flat, fused,
                   stash, k: int, q12: bool, order=None, want=None) -> None:
    """K2 (the sorted form given K9's ``order``) at every plan
    kernels.lookup_sweep sweeps (batch, warps, blocks an SM, L2 mode)
    against the plain version on the same probes."""
    from pangea_tpu_torch.index.quot import Q12_WAYS
    from pangea_tpu_torch.kernels import (_build, lookup_q8_plain,
                                          lookup_q12_plain)
    from pangea_tpu_torch.kernels.lookup import _q8_kernel, _q12_kernel
    from pangea_tpu_torch.kernels.lookup_sweep import quot_plans
    ways = Q12_WAYS if q12 else fused.shape[1] // 2
    if want is None:
        want = (lookup_q12_plain(*flat, fused, stash, k, ways) if q12 else
                lookup_q8_plain(*flat, fused, stash, k))
    plans = [p for _, p in quot_plans(flat[0].numel(), ways, stash.shape[1],
                                      q12, _build.sm_count(
                                          fused.device.index))]
    got = []
    for plan in plans:
        got += (_q12_kernel(fused.device, *flat, fused, stash, k, ways,
                            order, plan=plan) if q12 else
                _q8_kernel(fused.device, *flat, fused, stash, k, order,
                           plan=plan))
    res.check(name, f"{tag} {len(plans)} swept plans", list(want) *
              len(plans), got)


def phase_q8_kernels(torch, world, cuda, res: Results) -> None:
    from pangea_tpu_torch.index import relayout_q8
    from pangea_tpu_torch.kernels import (extract_probes_plain, fuse_stash,
                                          lookup_q8, lookup_q8_plain,
                                          score_reads_tin,
                                          score_reads_tin_plain)
    from pangea_tpu_torch.kernels.lookup import _q8_geometry, _q8_split, widen
    from pangea_tpu_torch.kernels.minimize import k1_cost
    k, w = HEADLINE["k"], HEADLINE["w"]
    idx, di = world["idx"], world["di"]
    hi, lo, valid = probes(torch, world, k, w)
    R = hi.shape[1]
    res.check("extract_probes", "3",
              probes(torch, world, k, w, extract_probes_plain),
              (hi, lo, valid))
    nbytes, ops = k1_cost(2 * BATCH, READ_LEN, k, w, READ_LEN)
    res.time(torch, "extract_probes", "3",
             lambda: probes(torch, world, k, w),
             lambda: probes(torch, world, k, w, extract_probes_plain),
             nbytes=nbytes, ops=ops, variant="w8_headline")
    check_k1_edges(torch, cuda, res)

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
    check_k2_edges(torch, cuda, res, False, False, "3")
    check_bin_edges(torch, cuda, res)
    check_k2_plans(torch, res, "lookup_q8", "3 headline", (hi, lo, valid),
                   fused, stash, k, False, want=want)
    N = hi.numel()
    log2nb, W = _q8_geometry(fused, k)
    bucket, _ = _q8_split(widen(hi), widen(lo), k, log2nb)
    need = touched_bytes(torch, bucket, valid, want[0] != 0, hi, lo, W, 1,
                         stash)
    log(f"[3] lookup_q8 touches {need} B of its {table_bytes(di)} B table")
    res.time(torch, "lookup_q8", "3",
             lambda: lookup_q8(hi, lo, valid, fused, stash, k),
             lambda: lookup_q8_plain(hi, lo, valid, fused, stash, k),
             nbytes=N * 21 + need, ops=N * (2 * W + 10),
             variant="headline", plan=k2_plan(N, fused, stash, False))
    log_bound(res, "lookup_q8", "headline", "3")

    hit, t_in, t_out = (t.reshape(BATCH, R) for t in want)
    valid2 = valid.reshape(BATCH, R)
    check_score(torch, res, "score_tin", "3", (hit, t_in, t_out, valid2),
                di.tax, False)
    u = distinct_per_read(hit, t_in, t_out)
    log(f"[3] the headline's lookups: distinct intervals a read: mean "
        f"{float(u.mean())}, largest {int(u.max())}")
    check_u_worlds(torch, res, "score_tin", "3", BATCH, R, (False,), cuda)
    T1 = di.tax["tin"].numel()
    res.time(torch, "score_tin", "3",
             lambda: score_reads_tin(hit, t_in, t_out, valid2, di.tax, 0.0),
             lambda: score_reads_tin_plain(hit, t_in, t_out, valid2,
                                           di.tax, 0.0),
             nbytes=BATCH * R * 13 + 12 * T1 + 12 * BATCH,
             ops=score_ops(hit, t_in, t_out) + BATCH * T1 * 6)
    res.assert_clean(("extract_probes", "extract_packed", "lookup_q8",
                      "score_tin", "bucket_sort", "route_bin",
                      "route_restore"))


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
    out, names = count_launches(lambda: model(b1, b2))
    torch.cuda.synchronize()
    launches = kernel_launches()
    log(f"[{tag}] kernel launches in one {world['name']} step: {launches}; "
        f"{len(names)} launches of their own: {names}")
    if launches != want_launches or len(names) != own_launches(launches):
        raise AssertionError(f"launches {launches} ({len(names)} of their "
                             f"own), want {want_launches}")
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
            extra=(), batch: int = CLI_BATCH, env=None) -> tuple[dict, list]:
    """`python -m pangea_tpu_torch.cli classify` on the world's config
    file and indexes (written by the port's Index.save, once a world),
    with ``env`` added to the environment; returns the run's result line
    and its assignment lines, split."""
    work = ROOT / "build" / "chip_smoke" / world["name"]
    if "idx_dirs" not in world:
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        world["idx_dirs"] = [str(work / f"idx{i}")
                             for i in range(len(world["idxs"]))]
        for ix, d in zip(world["idxs"], world["idx_dirs"]):
            ix.save(d)
    out_dir = work / f"out{tag}"
    shutil.rmtree(out_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "pangea_tpu_torch.cli", "classify",
           "--config", str(ROOT / "configs" / world["config"]),
           "--index", *world["idx_dirs"], "--reads", *reads,
           *(["--mates", *mates] if mates else []), "--samples", "smoke",
           "--out", str(out_dir), "--device", "cuda",
           f"input.batch_size={batch}", *extra]
    full_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=full_env,
                          cwd=ROOT, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI ({tag}) returned {proc.returncode}:"
                             f"\n{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    with_env = f" with {json.dumps(env)}" if env else ""
    log(f"[{tag}] CLI process{with_env} in {time.time() - t0:.1f} s: "
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


def same_files(a: Path, b: Path) -> list:
    """The output files of two CLI runs that differ: every .tsv and
    stats.json byte for byte, manifest.json with the run's directory
    named alike."""
    bad = [f.name for f in sorted(a.iterdir())
           if f.name.endswith((".tsv", "stats.json"))
           and f.read_bytes() != (b / f.name).read_bytes()]
    man = (a / "manifest.json").read_text().replace(str(a), str(b))
    if json.loads(man) != json.loads((b / "manifest.json").read_text()):
        bad.append("manifest.json")
    return bad


def phase_cli(world, out: dict, tag: str, fastq: tuple) -> dict:
    """The CLI on the world's config file, its indexes and 24,576 pairs,
    on the fast path; returns the kernel launches of that run (the CLI's
    own counts, which start at 0 in its process)."""
    result, rows = run_cli(world, tag, [fastq[0]], [fastq[1]])
    world["cli"] = (result, rows)
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


def check_golden(tag: str, out: dict, idxs: list, reads, thr: float,
                 paired: bool = True) -> None:
    """The step's outputs on its first GOLDEN_READS reads against the
    port's golden model (the reference bench's parity check): each
    index's golden calls, merged left to right over the first index's
    taxonomy where there are several (config 4); 0 mismatches in taxon,
    best and nvalid."""
    from pangea_tpu_torch.golden import (classify_reads_golden,
                                         merge_multik_golden)
    n = GOLDEN_READS
    t0 = time.time()
    mates = reads.mates[:n] if paired else None
    golds = [classify_reads_golden(reads.seqs[:n], ix, thr, mates=mates)
             for ix in idxs]
    gold = golds[0]
    for more in golds[1:]:
        gold = [merge_multik_golden(a, b, idxs[0].taxonomy)
                for a, b in zip(gold, more)]
    got = list(zip(*(out[k][:n].tolist() for k in ("taxon", "best",
                                                    "nvalid"))))
    bad = sum(g != (x.taxon, x.best, x.nvalid) for g, x in zip(got, gold))
    log(f"[{tag}] golden model on the first {n} reads ({len(idxs)} "
        f"index(es), threshold {thr}): mismatches {bad} in taxon, best and "
        f"nvalid; {time.time() - t0:.1f} s on the host")
    if bad or len(got) != n:
        raise AssertionError(f"the {tag} step disagrees with golden")


def phase_inflight_clis(world, fastq: tuple, card: str) -> dict:
    """Phase 5b: the headline CLI at PANGEA_INFLIGHT 1 and 8 (phase 5 ran
    the fast path's default, 4), one after another: files byte for byte
    phase 5's; reads/s at each depth. Returns the runs' launches."""
    result5, _ = world["cli"]
    out5 = ROOT / "build" / "chip_smoke" / world["name"] / "out5"
    rates, launches = {4: result5["reads_per_sec"]}, {}
    for depth in (1, 8):
        tag = f"5b-inflight{depth}"
        result, _ = run_cli(world, tag, [fastq[0]], [fastq[1]],
                            env={"PANGEA_INFLIGHT": str(depth)})
        bad = same_files(out5, out5.parent / f"out{tag}")
        rates[depth] = result["reads_per_sec"]
        log(f"[5b] PANGEA_INFLIGHT={depth}: files unlike phase 5's: {bad}")
        if bad or not result["fast_path"]:
            raise AssertionError(f"the fast path at depth {depth} differs")
        launches[f"fast_inflight{depth}"] = result["kernel_launches"]
    log(f"[5b] the fast path's reads/s by PANGEA_INFLIGHT on {card}: "
        f"{json.dumps(dict(sorted(rates.items())))}")
    return launches


def phase_profile_cli(world, fastq: tuple) -> dict:
    """Phase 5c: the headline CLI under PANGEA_PROFILE: its lines equal
    phase 5's, and the profiler's trace written and naming K1's, K2's and
    K3's kernels. Returns the run's launches."""
    _, rows5 = world["cli"]
    trace_dir = ROOT / "build" / "chip_smoke" / "profile5c"
    shutil.rmtree(trace_dir, ignore_errors=True)
    result, rows = run_cli(world, "5c-profile", [fastq[0]], [fastq[1]],
                           env={"PANGEA_PROFILE": str(trace_dir)})
    kl = result["kernel_launches"]
    log(f"[5c] lines unlike phase 5's: "
        f"{sum(a != b for a, b in zip(rows, rows5))} of {len(rows)}")
    if rows != rows5:
        raise AssertionError("the headline CLI under PANGEA_PROFILE is "
                             "wrong")
    trace = trace_dir / "trace_rank0.json"
    text = trace.read_text() if trace.exists() else ""
    named = {k: text.count(k) for k in TRACE_KERNELS}
    log(f"[5c] PANGEA_PROFILE: {trace} ({len(text)} B) names "
        f"{json.dumps(named)}")
    if not json.loads(text or "{}").get("traceEvents") \
            or min(named.values()) < 1:
        raise AssertionError("the profiler's trace lacks a kernel")
    return {"profile": kl}


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
    # acc_events keeps every step's events: without it the profiler may
    # clear them at the end of a cycle and record fewer launches than ran.
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        prof = profile(activities=activities, acc_events=True)
    except TypeError:                # a torch without acc_events
        prof = profile(activities=activities)
    with prof:
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
    split = {}
    for name, (ms, _, _) in kernels.items():
        m = re.search(r"(\w+(?:<[^>]*>)?)\(", name)
        key = m.group(1) if m else name[:60]
        split[key] = split.get(key, 0.0) + ms
    log(f"[{tag}] device ms a step by kernel on {card}: {json.dumps(split)}")


def chain_tax(torch, cuda) -> dict:
    from pangea_tpu_torch.bench import chain_taxonomy
    return {k: torch.from_numpy(v).to(cuda)
            for k, v in chain_taxonomy(CHAIN_NODES).device_arrays().items()}


def phase_std_kernels(torch, worlds, cuda, res: Results) -> None:
    from pangea_tpu_torch.index import extract_pairs
    from pangea_tpu_torch.index.build import layout_table
    from pangea_tpu_torch.kernels import (extract_probes_plain, fuse_stash,
                                          fuse_table, hash32,
                                          lca_lift_plain, lookup_q8,
                                          lookup_std, lookup_std_plain,
                                          score_reads_taxon,
                                          score_reads_taxon_plain,
                                          score_reads_tin,
                                          score_reads_tin_plain,
                                          score_winners,
                                          score_winners_plain)
    from pangea_tpu_torch.kernels.minimize import k1_cost
    wide, packed, q8l = worlds["wide"], worlds["packed"], worlds["q8_lift"]
    di = wide["di"]
    hi, lo, valid = probes(torch, wide, WIDE["k"], WIDE["w"])
    B, R = hi.shape
    res.check("extract_probes", "7 w=1",
              probes(torch, wide, WIDE["k"], WIDE["w"], extract_probes_plain),
              (hi, lo, valid))
    nbytes, ops = k1_cost(2 * B, READ_LEN, WIDE["k"], WIDE["w"], READ_LEN)
    res.time(torch, "extract_probes", "7 w=1",
             lambda: probes(torch, wide, WIDE["k"], WIDE["w"]),
             lambda: probes(torch, wide, WIDE["k"], WIDE["w"],
                            extract_probes_plain),
             nbytes=nbytes, ops=ops, plain_calls=1, plain_reps=PLAIN_REPS,
             primary=False, variant="w1_std")
    log(f"[7] extract_probes at k={WIDE['k']}, w={WIDE['w']}, both mates -> "
        f"[{B}, {R}]")
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
             plain_calls=1, plain_reps=PLAIN_REPS, variant="wide",
             plan=k4_plan(N, di))
    log_bound(res, "lookup_std", "wide", "7")
    pN, pways = pflat[0].numel(), pdi.cfg.ways
    pbucket = hash32(pflat[0], pflat[1]) & (pdi.fused.shape[0] - 1)
    pneed = touched_bytes(torch, pbucket, pflat[2], pwant[0] != 0, pflat[0],
                          pflat[1], 2 * pways, 2, pdi.stash)
    res.time(torch, "lookup_std", "7 packed",
             lambda: lookup_std(*pflat, pdi.fused, pdi.stash, pways),
             lambda: lookup_std_plain(*pflat, pdi.fused, pdi.stash, pways),
             nbytes=pN * 21 + pneed, ops=pN * (4 * pways + 16),
             plain_calls=1, plain_reps=PLAIN_REPS, primary=False,
             variant="packed_k31", plan=k4_plan(pN, pdi))
    log_bound(res, "lookup_std", "packed_k31", "7")

    # K3's taxon form and K5 on the wide lookups (lifting), at thresholds.
    taxon, t_in, t_out = (t.reshape(B, R) for t in want)
    args = (taxon, t_in, t_out, valid)
    winners = score_winners_plain(*args, True)
    check_score(torch, res, "score_taxon", "7 wide", args, di.tax, True)
    u = distinct_per_read(taxon, t_in, t_out)
    log(f"[7] the wide lookups: distinct intervals a read: mean "
        f"{float(u.mean())}, largest {int(u.max())}")
    check_u_worlds(torch, res, "score_taxon", "7", B, R, (True,), cuda)
    for R3, B3 in K3_SHAPES:
        check_u_worlds(torch, res, "score_taxon", "7", B3, R3, (True,), cuda)
    for thr in THRESHOLDS:
        check_lifted(res, f"7 wide, threshold {thr}", args, di.tax, thr,
                     True, winners)
    # The direct form, on the k=31 packed lookups (68 taxa).
    ptaxon, pt_in, pt_out = (t.reshape(phi.shape) for t in pwant)
    for thr in THRESHOLDS:
        res.check("score_taxon", f"7 packed direct, threshold {thr}",
                  score_reads_taxon_plain(ptaxon, pt_in, pt_out, pvalid,
                                          pdi.tax, thr),
                  score_reads_taxon(ptaxon, pt_in, pt_out, pvalid, pdi.tax,
                                    thr))
    levels = di.tax["up"].shape[0]
    need = lineage_bytes(torch, winners[0], winners[1], di.tax)
    log(f"[7] the lift reaches {need} B of the taxonomy's lifting, parent "
        "and depth tables")
    ops = score_ops(taxon, t_in, t_out)
    res.time(torch, "score_taxon", "7 wide winners",
             lambda: score_winners(*args, True),
             lambda: score_winners_plain(*args, True),
             nbytes=B * R * 13 + B * 24, ops=ops,
             plain_calls=1, plain_reps=PLAIN_REPS)
    # The lifted launch: the scorer's bytes, the lifting entries the lift
    # reaches and three [B] outputs.
    res.time(torch, "lca_lift", "7 wide, the scorer's lifted launch",
             lambda: score_reads_taxon(*args, di.tax, 0.0),
             lambda: lca_lift_plain(*score_winners_plain(*args, True),
                                    di.tax, 0.0, True),
             nbytes=B * R * 13 + need + B * 12,
             ops=ops + B * (levels * 8 + 24),
             plain_calls=1, plain_reps=PLAIN_REPS)

    # K5 in K3's q8 form on the 5,251-taxon q8 world.
    qdi = q8l["di"]
    qhi, qlo, qvalid = probes(torch, q8l, Q8_LIFT["k"], Q8_LIFT["w"])
    hits = [t.reshape(qhi.shape) for t in lookup_q8(
        qhi.reshape(-1), qlo.reshape(-1), qvalid.reshape(-1), qdi.fused,
        qdi.stash, Q8_LIFT["k"])]
    for thr in THRESHOLDS:
        res.check("score_tin", f"7 q8 lifting, threshold {thr}",
                  score_reads_tin_plain(*hits, qvalid, qdi.tax, thr),
                  score_reads_tin(*hits, qvalid, qdi.tax, thr))
        check_lifted(res, f"7 q8 lifting, threshold {thr}",
                     (*hits, qvalid), qdi.tax, thr, False)
    # K5 on a chain deep enough for 13 lifting levels, its winners two
    # random deep chain nodes a read.
    ctax = chain_tax(torch, cuda)
    g = torch.Generator(device="cpu").manual_seed(5)
    cargs = chain_reads(torch, ctax, B, 32, g)
    log(f"[7] chain: {CHAIN_NODES} nodes, {ctax['up'].shape[0]} lifting "
        f"levels, {B} reads of 32 probes")
    for thr in THRESHOLDS:
        for taxon_lanes in (True, False):
            lanes = cargs[0] if taxon_lanes else (cargs[0] != 0).to(
                torch.int32)
            check_lifted(res, f"7 chain, threshold {thr}",
                         (lanes, *cargs[1:]), ctax, thr, taxon_lanes)
    res.assert_clean(("lookup_std", "score_taxon", "lca_lift", "score_tin"))


def check_lifted(res: Results, what: str, args, tax: dict, thr: float,
                 taxon_lanes: bool, winners=None) -> None:
    """The scorer's lifted launch (past 4,096 taxa) against the plain
    winners and K5: (taxon, best, nvalid), one launch."""
    from pangea_tpu_torch.kernels import (lca_lift_plain, score_reads_taxon,
                                          score_reads_tin,
                                          score_winners_plain)
    if winners is None:
        winners = score_winners_plain(*args, taxon_lanes)
    want = (lca_lift_plain(*winners, tax, thr, taxon_lanes), winners[4],
            winners[5])
    fn = score_reads_taxon if taxon_lanes else score_reads_tin
    got, names = count_launches(lambda: fn(*args, tax, thr))
    if len(names) != 1:
        raise AssertionError(f"{what}: launches {names}, want one scorer")
    res.check("lca_lift", f"{what}, {'taxon' if taxon_lanes else 'q8'}",
              want, got)


def chain_reads(torch, tax: dict, B: int, R: int, g):
    """[B, R] scorer inputs on a chain taxonomy whose winners are two
    random deep chain nodes a read: R // 4 hits on each node's unit
    interval [tin, tin + 1), so that the two tie; the hits' lanes random
    chain nodes (the taxon form's u and v), the rest misses. Read 0 has
    no hit and read 1 no valid probe."""
    n = tax["tin"].numel() - 1
    nodes = torch.randint(1, n + 1, (B, 2), generator=g)
    which = torch.full((B, R), -1)
    which[:, :R // 4] = 0
    which[:, R // 4:R // 2] = 1
    which = which.gather(1, torch.rand((B, R), generator=g).argsort(1))
    node = torch.where(which >= 0, nodes.gather(1, which.clamp(min=0)), 0)
    t_in = torch.where(which >= 0, tax["tin"].cpu()[node], 0)
    t_out = torch.where(which >= 0, t_in + 1, 0)
    lanes = torch.where(which >= 0, torch.randint(1, n + 1, (B, R),
                                                  generator=g), 0)
    lanes[0] = 0
    valid = (torch.rand((B, R), generator=g) < 0.8) | (lanes != 0)
    valid[1] = False
    dev = tax["tin"].device
    return tuple(t.to(torch.int32).to(dev) for t in (lanes, t_in, t_out)) \
        + (valid.to(dev),)


def count_launches(fn):
    """fn's result and the names of the launchers it called through
    ``kernels._build.launch``: the kernel launches themselves."""
    from pangea_tpu_torch.kernels import _build
    real, names = _build.launch, []

    def spy(name, *args):
        names.append(name)
        return real(name, *args)
    _build.launch = spy
    try:
        return fn(), names
    finally:
        _build.launch = real


def own_launches(counts: dict) -> int:
    """The launches the wrappers' counts stand for: the tails' counts are
    scorer launches, which the scorer counts too."""
    return sum(n for k, n in counts.items() if k not in TAIL_KERNELS)


def _check_q12(res: Results, what: str, args, k: int, ways: int):
    from pangea_tpu_torch.kernels import lookup_q12, lookup_q12_plain
    want = lookup_q12_plain(*args, k, ways)
    res.check("lookup_q12", what, want, lookup_q12(*args, k, ways))
    return want


def phase_multik_kernels(torch, world, cuda, res: Results) -> None:
    import dataclasses

    from pangea_tpu_torch.classify import classify_reads, merge_multik_plain
    from pangea_tpu_torch.index import extract_pairs, relayout_q12
    from pangea_tpu_torch.index.quot import Q12_WAYS, q12_layout
    from pangea_tpu_torch.kernels import (fuse_stash, lookup_q12,
                                          lookup_q12_plain, lookup_q12_sorted,
                                          score_reads_plain, score_reads_tin)
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
    check_k2_edges(torch, cuda, res, True, False, "11")
    check_k2_plans(torch, res, "lookup_q12", "11 full width", flat, fused,
                   stash, k31, True, want=want)
    # K9 and K2-q12's sorted form on the same probes (r >= 32), called
    # directly: the table has 131,072 rows, at the deep-table gate.
    res.check("lookup_q12_sorted", "11 full width (r >= 32)", want,
              lookup_q12_sorted(*flat, fused, stash, k31, W))
    log2nb = _q12_geometry(fused, k31, W)
    bucket, _ = _q8_split(widen(flat[0]), widen(flat[1]), k31, log2nb)
    need = touched_bytes(torch, bucket, flat[2], want[0] != 0, flat[0],
                         flat[1], W, 2, stash)
    log(f"[11] lookup_q12 touches {need} B of its {table_bytes(di31)} B "
        "table (rem_lo lanes of the rows reached; the rem_hi and payload "
        "lanes of the keys hit)")
    res.time(torch, "lookup_q12", "11",
             lambda: lookup_q12(*flat, fused, stash, k31, W),
             lambda: lookup_q12_plain(*flat, fused, stash, k31, W),
             nbytes=N * 21 + need, ops=N * (3 * W + 10),
             plain_calls=1, plain_reps=PLAIN_REPS, variant="c4_full_width",
             plan=k2_plan(N, fused, stash, True))
    log_bound(res, "lookup_q12", "c4_full_width", "11")

    # K7 in the scorer's launch: the k=31 index's call merged with the
    # k=21 index's over its taxonomy, at full width and two thresholds.
    b1, b2 = world["b1"], world["b2"]
    v31 = valid
    hits31 = tuple(t.reshape(B, R) for t in want)
    keys = ("taxon", "best", "nvalid")
    for thr in THRESHOLDS:
        first = classify_reads(di21.tables, b1, dataclasses.replace(
            di21.cfg, confidence_threshold=thr), mate_bases=b2)
        check_merged(res, f"11 full width, threshold {thr}",
                     (*hits31, v31), di31.tax, thr, first, di21.tax)
    own = dict(zip(keys, score_reads_plain(*hits31, v31, di31.tax,
                                           di31.cfg.confidence_threshold,
                                           False)))
    t1, t2 = first["taxon"], own["taxon"]
    conflict = (t1 != 0) & (t2 != 0) & (t1 != t2)
    agree = (t1 != 0) & (t1 == t2)
    log(f"[11] merge_multik on {B} pairs: {int(agree.sum())} agree, "
        f"{int(conflict.sum())} conflict, "
        f"{int(((t1 == 0) != (t2 == 0)).sum())} one-sided")
    # The int32 extreme cases in the prior, on config 4's taxonomy; the
    # n1 + n2 wrap on reads the k=31 call leaves unclassified.
    n = len(MERGE_EXTREMES)
    none = torch.nonzero((t2 == 0) & (own["nvalid"] > 0)).flatten()[:2]
    rows = torch.cat([torch.arange(n, device=cuda), none])
    ext = {key: torch.tensor([c[0][i] for c in MERGE_EXTREMES]
                             + [0] * none.numel(), dtype=torch.int32,
                             device=cuda)
           for i, key in enumerate(keys)}
    ext["nvalid"][n:] = 2**31 - 1
    log(f"[11] the int32 extremes: {n} prior calls, and the n1 + n2 wrap on "
        f"{none.numel()} reads the k=31 call leaves unclassified")
    check_merged(res, "11 int32 extremes",
                 tuple(t[rows] for t in (*hits31, v31)), di31.tax,
                 di31.cfg.confidence_threshold, ext, di21.tax)
    # Conflicting calls across the 66,563-taxon tree and the chain, both
    # scored (lifted) and merged over the same tree.
    wide = datagen.make_taxonomy(2, *WIDE["tree"], seed=0)
    for name, deep in (("66,563-taxon tree", {
            k: torch.from_numpy(v).to(cuda)
            for k, v in wide.device_arrays().items()}),
            (f"{CHAIN_NODES}-node chain", chain_tax(torch, cuda))):
        T = deep["tin"].numel() - 1
        reads = (lineage_lanes(torch, deep, B, 32, g) if T > CHAIN_NODES
                 else chain_reads(torch, deep, B, 32, g))
        u = torch.randint(1, T + 1, (B,), generator=g,
                          dtype=torch.int32).to(cuda)
        nv = torch.randint(1, 300, (B,), generator=g,
                           dtype=torch.int32).to(cuda)
        prior = {"taxon": u, "best": (nv * 3) // 4, "nvalid": nv}
        # Reads 0 and 1 have no hit: both calls unclassified, the n1 + n2
        # wrap on read 0 (which has valid probes).
        for key, vals in (("taxon", (0, 0)), ("best", (0, 0)),
                          ("nvalid", (2**31 - 1, 50000))):
            prior[key][:2] = torch.tensor(vals, dtype=torch.int32)
        check_merged(res, f"11 {name}, levels {deep['up'].shape[0]}",
                     reads, deep, 0.05, prior, deep)
    # Timing on the full-width calls at config 4's threshold.
    thr = di31.cfg.confidence_threshold
    first = classify_reads(di21.tables, b1, di21.cfg, mate_bases=b2)
    t1 = first["taxon"]
    conflict = (t1 != 0) & (t2 != 0) & (t1 != t2)
    need = lineage_bytes(torch, t1[conflict], t2[conflict], di21.tax)
    levels = di21.tax["up"].shape[0]
    T1 = di31.tax["tin"].numel()
    log(f"[11] the merge's {int(conflict.sum())} conflicts reach {need} B "
        "of the lifting, parent and depth tables")
    # The merged launch: K3's direct launch, the prior's three [B] inputs
    # and the lifting entries its conflicts reach.
    res.time(torch, "merge_multik", "11, the scorer's merged launch",
             lambda: score_reads_tin(*hits31, v31, di31.tax, thr,
                                     prior=(first, di21.tax)),
             lambda: merge_multik_plain(first, dict(zip(keys, (
                 score_reads_plain(*hits31, v31, di31.tax, thr, False)))),
                 di21.tax),
             nbytes=B * R * 13 + 12 * T1 + 24 * B + need,
             ops=score_ops(*hits31) + B * T1 * 6 + B * 20
             + int(conflict.sum()) * levels * 8,
             plain_calls=1, plain_reps=PLAIN_REPS)
    res.assert_clean(("lookup_q12", "lookup_q12_sorted", "merge_multik"))


def check_merged(res: Results, what: str, args, tax: dict, thr: float,
                 prior: dict, merge_tax: dict) -> None:
    """The scorer's merged launch (K3's q8 form, prior given) against the
    plain scorer and K7: (taxon, best, nvalid), one launch."""
    from pangea_tpu_torch.classify import merge_multik_plain
    from pangea_tpu_torch.kernels import score_reads_plain, score_reads_tin
    own = score_reads_plain(*args, tax, thr, False)
    want = merge_multik_plain(prior, dict(zip(("taxon", "best", "nvalid"),
                                              own)), merge_tax)
    got, names = count_launches(lambda: score_reads_tin(
        *args, tax, thr, prior=(prior, merge_tax)))
    if len(names) != 1:
        raise AssertionError(f"{what}: launches {names}, want one scorer")
    res.check("merge_multik", what, want.values(), got)


def phase_packed_kernels(torch, wide, fastq: tuple, cuda,
                         res: Results) -> None:
    """K1's packed form on the headline pairs as the native reader packs
    them (both mates column slices of one batch on the card), against its
    plain version and against K1 on the same reads' codes."""
    from pangea_tpu_torch.io.native import NativeFastxReader
    from pangea_tpu_torch.kernels import (extract_probes,
                                          extract_probes_plain, wire_width)
    from pangea_tpu_torch.kernels.minimize import k1_cost, probe_width
    rows = []
    for path in fastq:
        reader = NativeFastxReader(path, BATCH, READ_LEN)
        n, _, words = reader.next_batch_packed()[:3]
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
        nbytes, ops = k1_cost(2 * BATCH, READ_LEN, k, w, 4 * W)
        head = w == HEADLINE["w"]
        res.time(torch, "extract_packed", f"15 w={w}",
                 lambda: run(extract_probes),
                 lambda: run(extract_probes_plain), nbytes=nbytes, ops=ops,
                 plain_calls=PIPELINED if head else 1,
                 plain_reps=REPS if head else PLAIN_REPS, primary=head,
                 variant="w8_headline" if head else "w1_std")
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
    direct LCA and K5's lifting, two thresholds, on reads of four taxa and
    on score_world inputs of chosen U; times of its winners form on the
    taxon lanes of the 66,563-taxon tree."""
    from pangea_tpu_torch.kernels import score_winners, score_winners_plain
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
                check_score(torch, res, "score_ranked",
                            f"15 R={R} x {B}, {name}",
                            (lanes, t_in, t_out, valid), tax, taxon_lanes)
        check_u_worlds(torch, res, "score_ranked", "15", B, R, (True, False),
                       cuda)
        # The last draw: taxon lanes on the big tree, as on the std path.
        args = (taxon, t_in, t_out, valid)
        nbytes = B * R * 13 + B * 24
        ops = score_ops(taxon, t_in, t_out)
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
            out, names = count_launches(lambda: model(b))
            torch.cuda.synchronize()
            # K5 in the scorer's launch: three launches a bucket.
            want = {**none, "extract_probes": 1, "lookup_std": 1,
                    "lca_lift": 1,
                    "score_ranked" if R > MAX_PROBES else "score_taxon": 1}
            if kernel_launches() != want or len(names) != 3:
                raise AssertionError(f"launches at {tuple(b.shape)}: "
                                     f"{kernel_launches()} ({names}), want "
                                     f"{want}")
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
            "cgen": None, "c3_fastq": work / "config3.fastq",
            "c5_fastq": work / "cohort.fastq"}


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
    cgen = [sys.executable, "-c",
            "from pangea_tpu_torch.bench import cohort_fastq, deep_genomes\n"
            f"_, g = deep_genomes({DEEP_GENOME_LEN})\n"
            f"cohort_fastq({str(deep['c5_fastq'])!r}, g, {C5_READS}, "
            f"{C5_SAMPLES})\n"]
    log(f"[24] started {' '.join(ooc[1:])}, config 3's {C3_READS} reads "
        f"and config 5's cohort of {C5_READS}")
    deep.update(ooc=start_process(ooc), gen=start_process(gen),
                cgen=start_process(cgen), t0_ooc=time.time())


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
                                          lookup_std_sorted_plain,
                                          route_restore, route_restore_plain)
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
        if layout != "std":
            for o, n in ((None, f"lookup_{layout}"), (order, name)):
                check_k2_plans(torch, res, n, what, flat, di.fused,
                               di.stash, k, layout == "q12", order=o,
                               want=want)
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
                                 flat[1], W, 2 if layout == "q12" else 1,
                                 di.stash)
            ops = N * ((3 if layout == "q12" else 2) * W + 10)
        rows = int(torch.unique(bucket[flat[2]]).numel())
        log(f"[20] deep {layout}: {N} probes on {tuple(di.fused.shape)} "
            f"({di.fused.numel() * 4} B), {int(hit.sum())} hits, {rows} rows "
            f"reached; K9 key shift {key_shift(nb)}; touches {need} B")
        k4 = layout == "std"
        res.time(torch, name, what,
                 lambda: srt(*flat, *tab, order=order),
                 lambda: srt_plain(*flat, *tab, order=order_plain),
                 nbytes=N * 32 + need, ops=ops, plain_calls=1,
                 plain_reps=PLAIN_REPS, variant=f"deep_{layout}",
                 plan=k4_plan(N, di, True) if k4 else k2_plan(
                     N, di.fused, di.stash, layout == "q12", True))
        log_bound(res, name, f"deep_{layout}", "20")
        sort_args = (*flat, nb, qk)
        if layout == "q8":
            # K9's restore alone on the deep q8 probes' records (a
            # permutation), beside one index_select of the records.
            records, inv = order
            res.check("route_restore", f"{what} restore",
                      route_restore_plain(inv, records),
                      route_restore(inv, records))
            res.time(torch, "route_restore", f"{what} restore",
                     lambda: route_restore(inv, records),
                     lambda: route_restore_plain(inv, records),
                     nbytes=N * (4 + 16 + 12), ops=N, plain_calls=1,
                     plain_reps=PLAIN_REPS, primary=False,
                     library=lambda: records.index_select(0, inv),
                     variant="deep_q8")
            log_ratio(res, "route_restore", "deep_q8",
                      "index_select of the records", "20")
            res.time(torch, "bucket_sort", what,
                     lambda: bucket_sort(*sort_args),
                     lambda: bucket_sort_plain(*sort_args),
                     nbytes=N * 29 + 8 * (nb >> key_shift(nb)),
                     ops=N * 16, plain_calls=1, plain_reps=PLAIN_REPS)
            k9_ms = res.k["bucket_sort"]["ms"]
        else:
            k9_ms = time_ms(torch, lambda: bucket_sort(*sort_args),
                            PIPELINED)
        if k4:
            unsorted_ms = res.time(
                torch, "lookup_std", what, lambda: unsorted(*flat, *tab),
                lambda: plain(*flat, *tab), nbytes=N * 21 + need, ops=ops,
                plain_calls=1, plain_reps=1, primary=False,
                variant="deep_std", plan=k4_plan(N, di))
            log_bound(res, "lookup_std", "deep_std", "20")
        else:
            unsorted_ms = time_ms(torch, lambda: unsorted(*flat, *tab),
                                  PIPELINED)
        both_ms = time_ms(torch, lambda: srt(*flat, *tab), PIPELINED)
        log(f"[20] deep {layout}, {N} probes, on {card}: unsorted "
            f"{unsorted_ms} ms; K9 {k9_ms} ms + sorted form "
            f"{res.k[name]['ms']} ms; K9 and the sorted form in one call "
            f"{both_ms} ms ({unsorted_ms / both_ms} x the unsorted speed)")

    for q12 in (False, True):
        check_k2_edges(torch, wide["di"].fused.device, res, q12, True, "20")

    # K4's sorted form on the wide std world's table (wide rows): the
    # phase-7 probes, 16384 pairs x 260.
    wdi = wide["di"]
    wflat = [t.reshape(-1) for t in probes(torch, wide, WIDE["k"],
                                           WIDE["w"])]
    wtab = (wdi.fused, wdi.stash, wdi.cfg.ways)
    worder, worder_plain = check_sort(torch, res, "20 wide std", wflat,
                                      wdi.fused.shape[0], None)
    wwant = lookup_std_plain(*wflat, *wtab)
    res.check("lookup_std_sorted", "20 wide std", wwant,
              lookup_std_sorted(*wflat, *wtab))
    wN, W = wflat[0].numel(), wdi.cfg.ways
    wbucket = hash32(wflat[0], wflat[1]) & (wdi.fused.shape[0] - 1)
    wneed = touched_bytes(torch, wbucket, wflat[2], wwant[0] != 0, wflat[0],
                          wflat[1], 2 * W, 3, wdi.stash)
    res.time(torch, "lookup_std_sorted", "20 wide std",
             lambda: lookup_std_sorted(*wflat, *wtab, order=worder),
             lambda: lookup_std_sorted_plain(*wflat, *wtab,
                                             order=worder_plain),
             nbytes=wN * 32 + wneed, ops=wN * (4 * W + 16), plain_calls=1,
             plain_reps=1, primary=False, variant="wide",
             plan=k4_plan(wN, wdi, True))
    log_bound(res, "lookup_std_sorted", "wide", "20")
    unsorted_ms, both_ms = (time_ms(torch, lambda fn=fn: fn(*wflat, *wtab),
                                    PIPELINED)
                            for fn in (lookup_std, lookup_std_sorted))
    log(f"[20] wide std table {tuple(wdi.fused.shape)}, "
        f"{wflat[0].numel()} probes, on {card}: unsorted K4 {unsorted_ms} "
        f"ms, K9 and the sorted form {both_ms} ms")
    res.assert_clean(("bucket_sort", "lookup_q8_sorted", "lookup_q12_sorted",
                      "lookup_std_sorted", "lookup_q8", "lookup_q12",
                      "lookup_std", "route_restore"))


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
                cap: int, binned=None):
    """K10 (``route_bin``, or ``binned`` called as it) against its plain
    version: every valid probe in its owner's bin once with its own
    record, the plain version's per-owner counts and count of overflowing
    probes, -1 in every other inv, zeros in the unused slots; then K9's
    restore on the records against the plain restore. Returns K10's
    output."""
    from pangea_tpu_torch.kernels import (route_bin, route_bin_plain,
                                          route_restore, route_restore_plain)
    from pangea_tpu_torch.kernels.route import owner_of
    hi, lo, valid = flat
    records, inv, counts = (binned or route_bin)(hi, lo, valid, n_shards,
                                                 cap)
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
               torch.zeros(1, dtype=torch.int64, device=hi.device),
               torch.zeros(1, dtype=torch.int64, device=hi.device)],
              [counts, fits.sum().reshape(1), slots // cap, rec[:, 0],
               rec[:, 1], rec[:, 2], rec[:, 3],
               (fits & ~valid).sum().reshape(1),
               (inv < -1).sum().reshape(1),
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
            # The library call gathers whole records, interleaved, and
            # reads row 0 where inv is -1 (clamped here, outside the call).
            inv0 = inv.clamp(min=0)
            res.time(torch, "route_restore", "25 restore S=4",
                     lambda: route_restore(inv, answers),
                     lambda: route_restore_plain(inv, answers),
                     nbytes=N * (4 + 16 + 12), ops=N, plain_calls=1,
                     plain_reps=PLAIN_REPS,
                     library=lambda: answers.index_select(0, inv0),
                     variant="routed_S4")
            log_ratio(res, "route_restore", "routed_S4",
                      "index_select of the records", "25")
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
             plain_reps=PLAIN_REPS, variant="wide_4_shards",
             plan=k4_plan(n, wdi))
    log_bound(res, "lookup_std_owned", "wide_4_shards", "25")
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


def check_row_route(torch, res: Results, what: str, b, rem,
                    nb: int) -> None:
    """The routing pass against its plain version by key, count and record
    multiset: the totals equal, the keys ascend, and the records (query
    index, row, rem, 1) are the plain version's up to order within a
    key."""
    from pangea_tpu_torch.kernels import rowprobe_route, rowprobe_route_plain
    from pangea_tpu_torch.kernels.rowprobe import rowprobe_plan
    records, totals = rowprobe_route(b, rem, nb)
    want, want_totals = rowprobe_route_plain(b, rem, nb)
    shift = rowprobe_plan(nb, 1).shift
    keys = records[:, 1].long() >> shift
    if bool((keys[1:] < keys[:-1]).any()):
        raise AssertionError(f"29 routing pass {what}: keys out of order")
    res.check("rowprobe_route", f"29 routing pass {what}",
              [want_totals, want[want[:, 0].long().argsort()]],
              [totals, records[records[:, 0].long().argsort()]])


def phase_rowprobe_kernels(torch, cuda, res: Results, card: str) -> None:
    """Phase 29: the routing pass, K11 and K12 at mb_pallas's shapes
    against their plain versions, bit for bit: the experiment's world
    (16,384 x 128, 524,288 queries, seed 0), a table of PROBE_TALL_NB rows,
    W = 32 (with the row numbers that count from the end or pass it), an
    ONEH_SMALL_NB-row table, every query in one row, and queries in every
    other 32-row tile. Bounds: the table read once, 8 B in and 4 B out a
    query (the routing pass: 8 B in, a 16-byte record out); K12's one-hot
    product, dense as the TPU experiment ran it and over the k-tiles it
    visits, is set against the int8 tensor-core peak."""
    from pangea_tpu_torch.experiments import mb_pallas as MP
    from pangea_tpu_torch.kernels import (rowprobe_onehot,
                                          rowprobe_onehot_plain,
                                          rowprobe_plain, rowprobe_route,
                                          rowprobe_route_plain,
                                          rowprobe_smem)
    from pangea_tpu_torch.kernels.rowprobe import (TILE_ROWS, onehot_visits,
                                                   rowprobe_plan)

    def world(**kw):
        return MP.world_tensors(MP.make_world(0, **kw), cuda)

    def probe_bytes(table, n: int) -> int:
        return table.numel() * 4 + n * 12

    t0 = time.time()
    full = world()
    table, b, rem = full
    n, nb = b.numel(), table.shape[0]
    w32 = world(w=32)
    w32[1][:8] = torch.tensor([-1, -7, nb, nb + 5, -nb, -nb - 9, 2**31 - 1,
                               -2**31], dtype=torch.int32, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(29)
    tiles = torch.randint(0, nb // TILE_ROWS // 2, (n,), generator=g) * 2
    half = (table, (tiles * TILE_ROWS + torch.randint(
        0, TILE_ROWS, (n,), generator=g)).to(torch.int32).to(cuda), rem)
    worlds = {"full": full, "tall": world(nb=PROBE_TALL_NB), "W=32": w32,
              "small": world(nb=ONEH_SMALL_NB),
              "skewed (one row)": (table, torch.full_like(b, 12345), rem),
              "half-empty (every other tile)": half}
    for what, (tab, bb, rr) in worlds.items():
        check_row_route(torch, res, f"{what} {tuple(tab.shape)}", bb, rr,
                        tab.shape[0])
        want = [rowprobe_plain(tab, bb, rr)]
        res.check("rowprobe_smem", f"29 K11 {what} {tuple(tab.shape)}",
                  want, [rowprobe_smem(tab, bb, rr)])
        res.check("rowprobe_onehot", f"29 K12 {what} {tuple(tab.shape)}",
                  want, [rowprobe_onehot(tab, bb, rr)])
    res.time(torch, "rowprobe_route", "29 routing pass full",
             lambda: rowprobe_route(b, rem, nb),
             lambda: rowprobe_route_plain(b, rem, nb), nbytes=n * 24, ops=0)
    res.time(torch, "rowprobe_smem", "29 K11 full, the routing pass in",
             lambda: rowprobe_smem(*full), lambda: rowprobe_plain(*full),
             nbytes=probe_bytes(table, n), ops=n * table.shape[1])
    ms = res.time(torch, "rowprobe_onehot",
                  "29 K12 full, the routing pass in",
                  lambda: rowprobe_onehot(*full),
                  lambda: rowprobe_onehot_plain(*full),
                  nbytes=probe_bytes(table, n), ops=n * table.shape[1],
                  plain_calls=1, plain_reps=PLAIN_REPS)
    dense = 2 * n * nb * 4 * table.shape[1]
    rows = rowprobe_route(b, rem, nb)[0][:, 1].cpu().long().numpy()
    visits = onehot_visits(rows, nb, rowprobe_plan(nb, table.shape[1] // 2))
    ops = visits * 2 * 16 * TILE_ROWS * 4 * table.shape[1]
    dense_ms = dense / INT8_TC_OPS_PER_S * 1e3
    peak_ms = ops / INT8_TC_OPS_PER_S * 1e3
    log(f"[29] K12's one-hot product on {card}: dense, as the TPU "
        f"experiment ran it, {dense} int8 operations, {dense_ms} ms at the "
        f"{INT8_TC_OPS_PER_S:.4g} op/s int8 peak; run, {visits} (m-tile, "
        f"k-tile) visits, {ops} operations, {peak_ms} ms at the peak, "
        f"{100 * peak_ms / ms} % of the call's {ms} ms")
    log(f"[29] phase 29 in {time.time() - t0:.1f} s")
    res.assert_clean(("rowprobe_route", "rowprobe_smem", "rowprobe_onehot"))


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


def k4_plan(n: int, di, sorted_form: bool = False) -> dict:
    """K4's launch plan (kernels.lookup.std_plan) for n probes of di's
    std table, as its wrapper takes it."""
    from pangea_tpu_torch.kernels import _build
    from pangea_tpu_torch.kernels.lookup import std_plan
    return std_plan(n, di.cfg.ways, di.stash.shape[1], sorted_form,
                    _build.sm_count(di.fused.device.index))._asdict()


def log_bound(res: Results, name: str, variant: str, tag: str) -> None:
    """One line: a kernel variant's time, its plan and its ratio to its
    bound."""
    v = res.k[name]["variants"][variant]
    log(f"[{tag}] {name} {variant}: {v['ms']} ms, {v['vs_bound']} x its "
        f"bound ({v['bound_ms']} ms); plan {v.get('plan')}")


def log_ratio(res: Results, name: str, variant: str, library: str,
              tag: str = "30") -> None:
    """One line: a kernel variant's time over its library call's, and over
    its bound."""
    v = res.k[name]["variants"][variant]
    log(f"[{tag}] {name} {variant}: {v['ms'] / v['library_ms']} x {library} "
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


def cohort_cmd(deep: dict, out_dir: Path, fastq: str) -> list:
    """Config 5's CLI as a user runs it on the cohort: its file (batch
    262,144, L 300, threshold 0.05, resume on; the mesh choose_mesh gives
    one card), the deep index, trim and demux as C5_OPTIONS set, the
    barcodes of gen-testdata --n-samples."""
    from pangea_tpu_torch.bench import cohort_barcodes
    barcodes = [[f"sample{i}", bc]
                for i, bc in enumerate(cohort_barcodes(C5_SAMPLES))]
    return [sys.executable, "-m", "pangea_tpu_torch.cli", "classify",
            "--config", str(ROOT / "configs" / "config5_cohort.json"),
            "--index", *deep["idx_dirs"], "--reads", fastq,
            "--out", str(out_dir), "--device", "cuda", "--resume",
            *C5_OPTIONS, "demux.barcodes=" + json.dumps(barcodes)]


def cohort_env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)


def run_cohort(tag: str, cmd: list, env: dict) -> tuple[dict, float]:
    """One cohort CLI process to its end: its result line and its wall."""
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the cohort CLI returned {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[{tag}] CLI process in {wall:.1f} s: {json.dumps(result)}")
    how = ("threads of the fast path, overlapping" if result["fast_path"]
           else "the general path's one loop")
    log(f"[{tag}] host time by phase ({how}): " + ", ".join(
        f"{k} {v} s ({100 * v / result['wall_sec']} % of the wall)"
        for k, v in result["host_sec"].items()))
    return result, wall


def assign_files(out: Path) -> dict:
    """sample -> its assignment lines, split."""
    return {f.name[:-len(".assign.tsv")]:
            [ln.split("\t") for ln in f.read_text().splitlines()]
            for f in sorted(out.glob("*.assign.tsv"))}


def read_index(rid: str) -> int:
    """The read's number in the bulk generator's ids (S0.read0001234)."""
    return int(rid[rid.index(".read") + 5:])


def load_int32_npy(path: str):
    """An int32 vector saved by numpy.save, as a torch tensor."""
    import torch
    data = Path(path).read_bytes()
    head = 10 + int.from_bytes(data[8:10], "little")
    if data[:6] != b"\x93NUMPY" or b"'<i4'" not in data[10:head]:
        raise AssertionError(f"{path}: not an int32 .npy file")
    return torch.frombuffer(bytearray(data[head:]), dtype=torch.int32)


def phase_cohort_cli(deep: dict) -> dict:
    """Phase 32: config 5's CLI on the whole cohort (the fast path): K1's
    packed form, K9, sorted K2 and K3 launched; every read counted; the
    trimmed, dropped, undetermined and per-sample shares above 0; the
    classified reads on their planted truth's lineage, and in the sample
    their barcode was drawn for."""
    import torch
    _, err = deep["cgen"].communicate(timeout=900)
    if deep["cgen"].returncode != 0:
        raise AssertionError(f"config 5's reads: {err[-4000:]}")
    fastq = str(deep["c5_fastq"])
    out = deep["dir"] / "out32"
    result, _ = run_cohort("32", cohort_cmd(deep, out, fastq), cohort_env())
    launches = result["kernel_launches"]
    if not result["fast_path"] or result["reads_in"] != C5_READS \
            or result["mesh"] != {"data": 1, "shard": 1} \
            or min(launches[k] for k in ("extract_packed", "bucket_sort",
                                         "lookup_q8_sorted",
                                         "score_tin")) < 1:
        raise AssertionError(f"config 5's CLI did not take the fast path "
                             f"with the sorted lookup: {json.dumps(result)}")
    # The trimmed share, recounted from the FASTQ's qualities: a read is
    # cut where the mean phred of a window of 4 first falls below 20.
    with open(fastq, "rb") as fh:
        head, seq = fh.readline(), fh.readline()
    h, n = len(head), len(seq) - 1
    width = h + 2 * n + 4
    rec = torch.from_file(fastq, size=C5_READS * width,
                          dtype=torch.uint8).view(C5_READS, width)
    trimmed = 0
    for lo in range(0, C5_READS, 1 << 17):
        q = rec[lo:lo + (1 << 17), h + n + 3:h + 2 * n + 3].int() - 33
        sums = q.unfold(1, 4, 1).sum(2)
        trimmed += int((sums < 4 * 20).any(1).sum())
    del rec
    files = assign_files(out)
    kept = result["reads_kept"]
    shares = {"trimmed": trimmed / C5_READS,
              "dropped": result["reads_filtered"] / C5_READS,
              **{s: len(rows) / kept for s, rows in files.items()}}
    truth = load_int32_npy(fastq + ".truth.npy").long()
    planted = load_int32_npy(fastq + ".samples.npy").long()
    tin, tout = (deep["tax"][k].cpu().long() for k in ("tin", "tout"))
    off = classified = own = 0
    for sample, rows in files.items():
        idx = torch.tensor([read_index(r[1]) for r in rows],
                           dtype=torch.long)
        taxon = torch.tensor([int(r[2]) for r in rows], dtype=torch.long)
        t = truth[idx]
        on = (tin[taxon] <= tin[t]) & (tin[t] < tout[taxon])
        classified += int((taxon != 0).sum())
        off += int(((taxon != 0) & ~on).sum())
        if sample != "undetermined":
            own += int((planted[idx] == int(sample[6:])).sum())
    log(f"[32] config 5: {result['reads_in']} reads, {kept} kept, "
        f"{result['batches']} batches, {result['reads_per_sec']} reads/s; "
        f"shares of the reads (trimmed, dropped) and of the kept reads (each "
        f"sample): {json.dumps(shares)}; {classified} classified, {off} off "
        f"their truth's lineage (limit {MAX_OFF_LINEAGE} of the kept); "
        f"{own} of {kept - len(files.get('undetermined', []))} "
        f"demultiplexed reads in the sample of their drawn barcode")
    if min(shares.values()) <= 0 or set(files) != {
            *(f"sample{i}" for i in range(C5_SAMPLES)), "undetermined"} \
            or off > MAX_OFF_LINEAGE * kept or not classified:
        raise AssertionError("config 5's outputs are wrong")
    return {"out": out, "result": result, "launches": launches,
            "rows": files}


def phase_cohort_resume(deep: dict, whole: dict) -> dict:
    """Phase 33: the same run, killed by SIGKILL once metrics.jsonl holds 2
    lines (the durable manifest committed every batch,
    PANGEA_FSYNC_EVERY=1), then run again with --resume: its files byte
    for byte the whole run's (the manifest's paths aside)."""
    import signal
    out = deep["dir"] / "out33"
    shutil.rmtree(out, ignore_errors=True)
    cmd = cohort_cmd(deep, out, str(deep["c5_fastq"]))
    env = cohort_env(PANGEA_FSYNC_EVERY="1")
    t0 = time.time()
    with open(deep["dir"] / "killed.err", "w") as err:
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err,
                                env=env, cwd=ROOT)
        metrics = out / "metrics.jsonl"
        while proc.poll() is None and time.time() - t0 < 600:
            if metrics.exists() and metrics.read_text().count("\n") >= 2:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.01)
        proc.wait(timeout=60)
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"the run to kill ended with {proc.returncode}"
                             " before its second batch was drained")
    man = out / "manifest.json"
    done = (json.loads(man.read_text())["files"][str(deep["c5_fastq"])]
            if man.exists() else 0)
    log(f"[33] killed after {time.time() - t0:.1f} s, 2 metrics lines; the "
        f"manifest records {done} reads")
    result, wall = run_cohort("33", cmd, env)
    bad = [f.name for f in sorted(whole["out"].iterdir())
           if f.name.endswith((".tsv", "stats.json"))
           and f.read_bytes() != (out / f.name).read_bytes()]
    want = json.loads((whole["out"] / "manifest.json").read_text())
    got = json.loads((out / "manifest.json").read_text())
    same_manifest = got == json.loads(json.dumps(want).replace(
        str(whole["out"]), str(out)))
    log(f"[33] resumed: {result['reads_in']} reads in {wall:.1f} s of wall "
        f"({result['reads_per_sec']} reads/s; the whole run "
        f"{whole['result']['reads_per_sec']}); files unlike the whole "
        f"run's: {bad}; manifest the same: {same_manifest}")
    if bad or not same_manifest or result["reads_in"] != C5_READS - done:
        raise AssertionError("the resumed cohort differs from the whole run")
    return result["kernel_launches"]


def phase_cohort_general(deep: dict, whole: dict) -> dict:
    """Phase 34: the general path (PANGEA_NO_NATIVE: the Python reader,
    per-read trim and demux, K1 on codes) on the cohort's first C5_GENERAL
    reads: each sample's lines equal the fast path's for those reads."""
    src = deep["c5_fastq"]
    with open(src, "rb") as fh:
        width = sum(len(fh.readline()) for _ in range(4))
        fh.seek(0)
        head = fh.read(width * C5_GENERAL)
    fastq = deep["dir"] / "cohort_head.fastq"
    fastq.write_bytes(head)
    out = deep["dir"] / "out34"
    result, _ = run_cohort("34", cohort_cmd(deep, out, str(fastq)),
                           cohort_env(PANGEA_NO_NATIVE="1"))
    files = assign_files(out)
    want = {s: [r for r in rows if read_index(r[1]) < C5_GENERAL]
            for s, rows in whole["rows"].items()}
    bad = sum(files.get(s, []) != rows for s, rows in want.items())
    log(f"[34] general path: {result['reads_in']} reads, "
        f"{result['reads_kept']} kept, {result['reads_per_sec']} reads/s; "
        f"samples whose lines differ from the fast path's: {bad}")
    if result["fast_path"] or bad or set(files) != {
            s for s, rows in want.items() if rows}:
        raise AssertionError("the general path differs from the fast path")
    return result["kernel_launches"]


def phase_cohort_report(deep: dict, whole: dict) -> None:
    """Phase 35: `cli report` on the whole run's assignment files gives
    back its summaries, cohort table and stats.json."""
    files = sorted(whole["out"].glob("*.assign.tsv"))
    rep = deep["dir"] / "report35"
    t0 = time.time()
    proc = start_process([
        sys.executable, "-m", "pangea_tpu_torch.cli", "report",
        "--assignments", *map(str, files),
        "--samples", *(f.name[:-len(".assign.tsv")] for f in files),
        "--taxonomy", str(deep["dir"] / "idx" / "taxonomy.npz"),
        "--out-dir", str(rep)])
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"report returned {proc.returncode}:\n"
                             f"{err[-4000:]}")
    names = sorted(f.name for f in rep.iterdir())
    bad = [n for n in names
           if (rep / n).read_bytes() != (whole["out"] / n).read_bytes()]
    log(f"[35] report on {len(files)} files in {time.time() - t0:.1f} s: "
        f"{names}; unlike the run's: {bad}")
    if bad or "cohort.summary.tsv" not in names or "stats.json" not in names:
        raise AssertionError("report differs from the run's summaries")


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
        for name in ("proc", "ooc", "gen", "cgen"):
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
    check_golden("4", out, q8["idxs"], q8["reads"], 0.0)
    q8_cli = phase_cli(q8, out, "5", fastq)
    knob_clis = {**phase_inflight_clis(q8, fastq, card),
                 **phase_profile_cli(q8, fastq)}
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
    check_golden("8", out, wide["idxs"], wide["reads"], 0.0)
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
    check_golden("12", out, c4["idxs"], c4["reads"], C4_THRESHOLD)
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
    check_golden("21", q8_out, [deep["idx"]], deep["reads"], 0.0,
                 paired=False)
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

    # Phases 32-35: config 5's cohort run on the deep index.
    c5 = phase_cohort_cli(deep)
    c5_resumed = phase_cohort_resume(deep, c5)
    c5_general = phase_cohort_general(deep, c5)
    phase_cohort_report(deep, c5)

    # The main paths' launches: each CLI run's own counts, the q12 and std
    # deep steps' (phase 21), the multi-rank steps' (phase 26), the
    # experiment entry points' (phase 31) and the cohort runs' (32-34).
    clis = {"q8": q8_cli, **knob_clis, "std": std_cli, "multik": c4_cli,
            "long": long_cli,
            "fast_long": fast_long_cli, "deep": deep_cli,
            "deep_q12_step": deep["launches"]["q12"],
            "deep_std_step": deep["launches"]["std"], "mesh": mesh,
            "config3": c3_cli, **experiments, "cohort": c5["launches"],
            "cohort_resumed": c5_resumed, "cohort_general": c5_general}
    for path, kernels in (
            ("q8", ("extract_packed", "lookup_q8", "score_tin")),
            ("fast_inflight1", ("extract_packed", "lookup_q8", "score_tin")),
            ("fast_inflight8", ("extract_packed", "lookup_q8", "score_tin")),
            ("profile", ("extract_packed", "lookup_q8", "score_tin")),
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
            ("mb_pallas", ("rowprobe_route", "rowprobe_smem",
                           "rowprobe_onehot")),
            ("mb_gather", ("row_gather", "row_gather_direct", "block_copy")),
            ("cohort", ("extract_packed", "bucket_sort", "lookup_q8_sorted",
                        "score_tin")),
            ("cohort_resumed", ("extract_packed", "bucket_sort",
                                "lookup_q8_sorted", "score_tin")),
            ("cohort_general", ("extract_probes", "score_tin"))):
        if min(clis[path][k] for k in kernels) < 1:
            raise AssertionError(f"the {path} path bypassed a kernel: "
                                 f"{clis[path]}")
    launches = {k: sum(c[k] for c in clis.values()) for k in KERNELS}
    log(f"[36] kernel launches of the ten CLI runs, the two deep steps, "
        f"the multi-rank steps, the two experiment entry points and the "
        f"three cohort runs: {json.dumps(clis)}; whole run "
        f"{time.time() - t_start:.1f} s")
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
