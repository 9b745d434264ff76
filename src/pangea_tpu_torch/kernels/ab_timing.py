"""Time K1, K2's and K4's forms, K9 and K10, K11 and K12, K13's block copy,
the scorer (K3, K8) and its tail (K5, K7) and the q8, std and config-4
steps through the port's public entry points, so that one file times any
checkout of it.

    PYTHONPATH=<checkout>/src python \\
        src/pangea_tpu_torch/kernels/ab_timing.py [--deep DIR] [--split] \\
        [--cli DIR] \\
        [--sections k1,block_copy,k2,k4,sort,rowprobe,score,tail,steps,cli]

The file imports ``pangea_tpu_torch`` by its absolute name, from whichever
checkout ``PYTHONPATH`` names: run it on two checkouts in turns (A, B, B,
A) in one call to compare them on one card. Each run prints one JSON line
with the sections asked for (all by default):

- ``k1``: K1 (``extract_probes``) and its packed form, one launch a call
  (one mate's batch), each held to its plain version first, timed by CUDA
  events (``ms``) and by the profiler's device time a call
  (``device_ms``): the bench's first mates (16,384 reads of 150 bases,
  ``bench._bench_reads``) at k=21, w=1 (the std world) and w=8 (the q8
  headline), both as codes and as wire rows (packed here by ``_pack``, as
  the native reader packs them), at k=31, w=1 (config 4's q12 index), and
  a long-read bucket of 75 reads of 16,384 bases (genome slices, seed
  K1_SEED) at k=21, w=1;
- ``k2``: K2 (``lookup_q8``, ``lookup_q12``), each held to its plain
  version first, timed by CUDA events (``ms``) and by the profiler's
  device time a call (``device_ms``): the q8 probe on the headline (16,384
  pairs x 32, 524,288 probes, on the 16,384 x 128 table); config 4's q12
  probe (its 3,932,160 k=31, w=1 probes on the 131,072 x 128 table) and
  its k=21 q8 index (524,288 probes); with ``--deep DIR``, on the deep
  world's q8 and q12 tables (2,129,920 probes of its first 16,384 reads),
  unsorted and, given K9's order, the sorted forms with K9's restore
  (``lookup_q8_sorted``, ``lookup_q12_sorted``);
- ``k4``: K4 (``lookup_std``), CUDA-event and profiler device ms, on the
  wide std world of ``chip_smoke.py`` phase 7 (16,384 pairs x 260
  probes, 4,259,840, on the 131,072 x 192 table, W = 32) and on the k=31
  packed world (the same pairs at k=31, w=8, W = 16); its owner mask (``lookup_std_owned``) at 4 shards, shard
  0; its sorted form (``lookup_std_sorted``) on the wide world given K9's
  order; with ``--deep DIR``, unsorted and sorted on the deep world's std
  table (4,194,304 packed rows, 1.07 GB) with the 8,519,680 probes of
  65,536 reads, the deep index built once into DIR and loaded after;
- ``sort``: with ``--deep DIR``, K9 (``bucket_sort``) on the deep world's
  probes at its q8, q12 and std tables (2,129,920, 2,129,920 and 8,519,680
  probes; 1,024 keys each), K10 (``route_bin``) on the q8 probes at 1, 2,
  4 and 8 owners of ``route_capacity`` slots, and each deep layout's sorted
  pair in one call (K9, the sorted form and K9's restore), each held to
  its plain version first (K9 by its keys, records and inverse; K10 by its
  counts, slots and records), timed by CUDA events (``ms``) and by the
  profiler's device time a call (``device_ms``), summed over every launch
  and memset of the call;
- ``rowprobe``: K11 (``rowprobe_smem``) and K12 (``rowprobe_onehot``) on
  mb_pallas's world (a 16,384 x 128 table, 524,288 queries, seed 0), each
  held to ``rowprobe_plain`` first, timed by CUDA events (``ms``) and by
  the profiler's device time a call (``device_ms``, ``split`` by kernel),
  every launch of the call summed (a checkout that routes the queries
  first has its routing pass's launches in); where the checkout has it,
  the routing pass (``rowprobe_route``) alone, held to its plain version
  by key, count and record multiset;
- ``block_copy``: K13's block copy and ``narrow().clone()`` on mb_gather4's
  array, static and dynamic (``experiments.mb_gather``'s gather4 starts);
- ``score``: the scorer through ``score_reads_tin``, ``score_winners``,
  ``score_reads_taxon`` and ``score_ranked``, each held to its plain
  version first, timed by CUDA events (``ms``) and by the profiler's
  device time a call (``device_ms``): K3-q8 on the q8 headline's lookups
  (16,384 pairs x 32, the direct LCA); K3's taxon form on the wide
  world's lookups (16,384 x 260), winners, and direct over the bench's
  67-taxon tree; K3 at the 1,180-probe bucket (64 reads) and K8 at 16,364
  x 75 and 32,728 x 75, each read's hits from four taxa of the wide tree
  (half of the probes misses, as ``chip_smoke.py`` phase 15 draws them);
  and K3 (16,384 x 260, 64 x 1,180) and K8 (75 x 16,364, 75 x 32,728) at
  U = R, every probe a hit of its own taxon (``distinct_lanes``, seeded
  numpy);
- ``tail``: the scoring calls whose LCA is lifted (K5) or whose call is
  merged with an earlier one (K7), as the checkout runs them (a scorer
  launch and then K5's or K7's own, or the scorer's one launch), each held
  to the plain scorer (and merge) first, timed by CUDA events (``ms``), by
  the profiler's device time a call summed over every launch of the call
  (``device_ms``, and ``split`` by kernel), with ``launches``, the
  ``_build.launch`` calls of one call: the std world's scoring (the wide
  lookups' 16,384 pairs x 260 on the 66,563-taxon tree), the q8 lifting
  world's (the headline's pairs at k=21, w=1 on 5,251 taxa), config 4's
  second scoring (the k=31 q12 lookups merged with the k=21 index's call
  over its taxonomy, at config 4's threshold), the 1,180-probe bucket and
  K8 at 16,364 x 75 on the wide tree (``lineage_lanes``); and beside each
  the scorer's launch alone as the parent ran it before K5 or K7
  (``*_alone``: the winners form, or K3 without a prior);
- ``steps``: the q8 headline, the std world, the q8 lifting world and
  config 4's multi-k Classifier steps on 16,384 pairs, one step and back
  to back, each with the least and largest of its samples, the
  ``_build.launch`` calls of one step (``launches``) and the profiler's
  device ms a step, by kernel (``split``); with ``--deep DIR``,
  also the deep
  q8 and q12 steps on 16,384 single-end reads and the std step on 65,536,
  sorted (the reference's gate) and with ``PANGEA_DEEP_SORT=0``;
- ``cli``: with ``--cli DIR``, the ``classify`` CLI as a user runs it
  (``python -m pangea_tpu_torch.cli`` processes on the card, the
  checkout's own), CLI_REPS runs of each workload: on the general path,
  the long-read FASTQ (the headline world's first CLI_LONG[0] first
  mates and CLI_LONG[1] genome slices of 1-20 kb,
  ``input.long_reads=true``, batches of 8,192) on the headline q8 index
  and config 5's file with its trim and demux on CLI_COHORT reads of
  ``bench.cohort_fastq`` on the headline genomes (``PANGEA_NO_NATIVE``,
  batches of CLI_COHORT_BATCH); on the fast path, CLI_STD pairs of the
  std world (``WIDE``) in batches of BATCH, and CLI_DEEP single-end reads
  of the deep world (its k=21, w=1 index built into DIR, the q8 layout
  and the sorted lookup) in batches of BATCH; each run's
  ``reads_per_sec``, ``wall_sec`` and ``host_sec``. The inputs and the
  indexes are written into DIR by the first run and read by later ones,
  so that every checkout classifies the same files;
- with ``--split``, ``split``: the block copy's host time a call in parts,
  by ``time.perf_counter_ns`` over SPLIT_CALLS calls: the whole call; the
  wrapper's checks, plan and ``torch.empty``; the device guard and stream
  lookup; the ``ctypes`` call of a launcher that returns before launching;
  the same call that launches. Each part is timed as the earlier launch
  path ran it (``parent``: a ``torch.cuda.device`` context, a ``Stream``
  object and the 14-argument row gather launcher, as at commit
  ``c2855ad``) and as this file's checkout runs it (``current``; its
  dispatch, checks and allocation apart where it has the raw-stream
  path); and ``graph``: the block copy captured in a CUDA graph, a
  replay's host ns and ms beside the block copy's and
  ``narrow().clone()``'s.

Kernel times are CUDA events over PIPELINED back-to-back calls, the median
of REPS samples after WARMUP calls (``chip_smoke.py``'s ``time_ms``). A
card is needed; it exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

WARMUP, REPS, PIPELINED = 3, 20, 10
BATCH, READ_LEN = 16384, 150
WIDE = {"k": 21, "w": 1, "tree": (512, 64)}
PACKED = {"k": 31, "w": 8}
HEADLINE = {"k": 21, "w": 8}
MULTIK = {"genome_len": 64_000, "indexes": ((21, 8), (31, 1))}
C4_THRESHOLD = 0.05
# The scorer's inputs: (probes a read, reads) of the long-read shapes, the
# taxa a read's hits come from there, and the seed of every draw.
BUCKET, RANKED = (1180, 64), ((16364, 75), (32728, 75))
LINEAGE_TAXA, SCORE_SEED = 4, 15
PROFILED = 20            # calls the profiler's device time is taken over
SECTIONS = ("k1", "block_copy", "k2", "k4", "sort", "rowprobe", "score",
            "tail", "steps", "cli")
# The cli section: runs of each workload; the long-read FASTQ's short and
# long reads; the cohort's reads and its batch; the std pairs; the deep
# reads.
CLI_REPS = 2
CLI_LONG = (32768, 2048)
CLI_COHORT, CLI_COHORT_BATCH = 262144, 65536
CLI_STD, CLI_DEEP = 131072, 65536
Q8_LIFT = {"k": 21, "w": 1, "tree": (64, 40)}
# K1's shapes: (name, k, w, packed) on the bench's 16,384 first mates, and
# the long-read bucket's reads, length and seed.
K1_CASES = (("w1_std", 21, 1, False), ("w8_headline", 21, 8, False),
            ("w1_std_packed", 21, 1, True),
            ("w8_headline_packed", 21, 8, True), ("k31_w1", 31, 1, False))
K1_BUCKET, K1_LONG, K1_SEED = 75, 16384, 12
DEEP_READS, DEEP_QUOT_READS = 65536, 16384
ROUTE_SHARDS = (1, 2, 4, 8)
SPLIT_CALLS = 10_000


def time_ms(torch, fn, calls: int = PIPELINED, reps: int = REPS) -> float:
    return time_stats(torch, fn, calls, reps)["median"]


def time_stats(torch, fn, calls: int = PIPELINED, reps: int = REPS) -> dict:
    """The median CUDA-event ms a call over ``reps`` samples of ``calls``
    back-to-back calls, after WARMUP calls, and the least and largest."""
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
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def device_ms(torch, fn, calls: int = PROFILED, tries: int = 3) -> float:
    """Device ms a call of fn: the profiler's device time of every kernel
    over ``calls`` calls, divided by ``calls``; taken again, up to
    ``tries`` times, where the profiler recorded no device time at all."""
    return sum(device_split(torch, fn, calls, tries).values())


def device_split(torch, fn, calls: int = PROFILED,
                 tries: int = 3) -> dict:
    """Device ms a call of fn by kernel (and memset) name, as
    :func:`device_ms` takes them."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    split = {}
    for _ in range(tries):
        try:
            prof = profile(activities=[ProfilerActivity.CUDA],
                           acc_events=True)
        except TypeError:           # a torch without acc_events
            prof = profile(activities=[ProfilerActivity.CUDA])
        with prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", None)
                us = e.self_cuda_time_total if us is None else us
                if us:
                    split[e.key] = split.get(e.key, 0.0) + us / 1e3 / calls
        if split:
            break
    return split


def host_ns(torch, fn, calls: int = SPLIT_CALLS) -> float:
    """Host ns a call of fn, over ``calls`` calls, then a synchronize."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter_ns() - t0) / calls


def probes(torch, b1, b2, k: int, w: int):
    """Flat (hi, lo, valid) of both mates' probes, by K1."""
    from pangea_tpu_torch.kernels import extract_probes
    from pangea_tpu_torch.kernels.minimize import probe_width
    nw = probe_width(READ_LEN, k, w)
    mates = [b for b in (b1, b2) if b is not None]
    shape = (mates[0].shape[0], len(mates) * nw)
    out = (torch.empty(shape, dtype=torch.int32, device=b1.device),
           torch.empty(shape, dtype=torch.int32, device=b1.device),
           torch.empty(shape, dtype=torch.bool, device=b1.device))
    for m, b in enumerate(mates):
        extract_probes(b, k, w, out, m * nw)
    return [t.reshape(-1) for t in out]


def bench_world(torch, dev, n_reads: int, **kw):
    """(device index, b1, b2) of a bench world."""
    from pangea_tpu_torch.bench import make_bench_world
    from pangea_tpu_torch.classify import DeviceIndex, pad_batch
    bw = make_bench_world(n_reads=n_reads, read_len=READ_LEN, **kw)
    di = DeviceIndex.from_index(bw.index, dev, 0.0)
    n = min(BATCH, n_reads)
    return di, *(torch.from_numpy(pad_batch(r[:n], n, READ_LEN)).to(dev)
                 for r in (bw.reads.seqs, bw.reads.mates))


_deep: dict = {}


def deep_index(torch, dev, cache: Path, layout: str):
    """(device index, flat probes, reads) of the deep world at ``layout``:
    its index built into ``cache`` once and laid out once a run; the
    probes at k=21, w=1 of its first DEEP_QUOT_READS reads (q8, q12) or
    all DEEP_READS (std), as ``chip_smoke.py`` phase 20 takes them, and
    those reads' int8 codes on the card."""
    from pangea_tpu_torch.bench import deep_genomes, deep_reads
    from pangea_tpu_torch.classify import DeviceIndex, pad_batch
    from pangea_tpu_torch.index import build_index, load_index_any
    if layout in _deep:
        return _deep[layout]
    tax, genomes = deep_genomes()
    if not (cache / "taxonomy.npz").exists():     # written last
        cache.mkdir(parents=True, exist_ok=True)
        build_index(genomes, tax, k=21, w=1).save(str(cache))
    di = DeviceIndex.from_index(load_index_any(str(cache)), dev, 0.0,
                                layout=layout)
    n = DEEP_READS if layout == "std" else DEEP_QUOT_READS
    reads = deep_reads(genomes, DEEP_READS, READ_LEN).seqs[:n]
    b = torch.from_numpy(pad_batch(reads, n, READ_LEN)).to(dev)
    _deep[layout] = di, probes(torch, b, None, 21, 1), b
    return _deep[layout]


def multik_world(torch, dev):
    """((k=21 q8, k=31 q12 device indexes), b1, b2): config 4's world."""
    from pangea_tpu_torch.bench import make_multik_world
    from pangea_tpu_torch.classify import DeviceIndex, pad_batch
    mw = make_multik_world(n_reads=BATCH, read_len=READ_LEN, **MULTIK)
    dis = [DeviceIndex.from_index(ix, dev, C4_THRESHOLD)
           for ix in mw.indexes]
    return dis, *(torch.from_numpy(pad_batch(r, BATCH, READ_LEN)).to(dev)
                  for r in (mw.reads.seqs, mw.reads.mates))


def _pack(np, codes):
    """Wire rows (uint32 [B, ceil(L/16) + ceil(L/32)]) of int8 codes
    [B, L], as the native reader packs them: 2-bit codes, bad flags for
    codes above 3 and past the read. A copy of ``bench.pack_wire`` without
    its junk, so that checkouts that lack it can be timed too."""
    B, L = codes.shape
    w16, w32 = (L + 15) // 16, (L + 31) // 32
    c2 = np.zeros((B, w16 * 16), np.uint64)
    c2[:, :L] = codes.astype(np.uint8) & 3
    bad = np.ones((B, w32 * 32), np.uint64)
    bad[:, :L] = codes.astype(np.uint8) > 3
    words = (c2.reshape(B, w16, 16)
             << (2 * np.arange(16, dtype=np.uint64))).sum(axis=2)
    bwords = (bad.reshape(B, w32, 32)
              << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return np.concatenate([words, bwords], axis=1).astype(np.uint32)


def k1_reads():
    """(int8 codes [BATCH, READ_LEN], [K1_BUCKET, K1_LONG]): the bench's
    first mates, and genome slices of the bench's genomes (seed
    K1_SEED)."""
    import numpy as np
    from pangea_tpu_torch.bench import _bench_genomes, _bench_reads
    from pangea_tpu_torch.classify import pad_batch
    _, genomes = _bench_genomes(48, 50_000, 0, None)
    mates = pad_batch(_bench_reads(genomes, BATCH, READ_LEN, 0).seqs, BATCH,
                      READ_LEN)
    rng = np.random.default_rng(K1_SEED)
    long = np.empty((K1_BUCKET, K1_LONG), np.int8)
    for i in range(K1_BUCKET):
        codes = genomes[rng.integers(0, len(genomes))][0]
        s = int(rng.integers(0, len(codes) - K1_LONG + 1))
        long[i] = codes[s:s + K1_LONG]
    return mates, long


def time_k1(torch, dev) -> dict:
    import numpy as np
    from pangea_tpu_torch.kernels import (extract_probes,
                                          extract_probes_plain)
    from pangea_tpu_torch.kernels.minimize import probe_width
    mates, long = k1_reads()
    cases = [(*c, mates) for c in K1_CASES]
    cases.append((f"bucket_{K1_BUCKET}x{K1_LONG}", 21, 1, False, long))
    out = {}
    for name, k, w, packed, codes in cases:
        B, L = codes.shape
        src = torch.from_numpy(_pack(np, codes).view(np.int32) if packed
                               else codes).to(dev)
        nw = probe_width(L, k, w)
        res = [(torch.empty((B, nw), dtype=torch.int32, device=dev),
                torch.empty((B, nw), dtype=torch.int32, device=dev),
                torch.empty((B, nw), dtype=torch.bool, device=dev))
               for _ in range(2)]
        kw = {"packed_len": L} if packed else {}
        extract_probes_plain(src, k, w, res[0], 0, **kw)

        def run():
            extract_probes(src, k, w, res[1], 0, **kw)
        run()
        mism = sum(int((a != b).sum()) for a, b in zip(*res))
        if mism:
            raise AssertionError(f"k1 {name}: {mism} mismatches")
        out[name] = {"probes": B * nw, "ms": time_ms(torch, run),
                     "device_ms": device_ms(torch, run)}
    return out


def time_k2(torch, dev, deep: Path | None) -> dict:
    """K2's forms, each held to its plain version first: CUDA-event ms and
    profiler device ms a call, and the probes."""
    from pangea_tpu_torch.kernels import (bucket_sort, lookup_q8,
                                          lookup_q8_plain, lookup_q8_sorted,
                                          lookup_q12, lookup_q12_plain,
                                          lookup_q12_sorted)
    out = {}

    def entry(name, flat, di, order=None):
        q12 = di.cfg.layout == "q12"
        args = (*flat, di.fused, di.stash, di.cfg.k,
                *((di.cfg.ways,) if q12 else ()))
        plain = lookup_q12_plain if q12 else lookup_q8_plain
        if order is None:
            fn = lookup_q12 if q12 else lookup_q8
            kw = {}
        else:
            fn = lookup_q12_sorted if q12 else lookup_q8_sorted
            kw = {"order": order}
        mism = sum(int((a != b).sum())
                   for a, b in zip(plain(*args), fn(*args, **kw)))
        if mism:
            raise AssertionError(f"k2 {name}: {mism} mismatches")
        out[name] = {"probes": flat[0].numel(),
                     "ms": time_ms(torch, lambda: fn(*args, **kw)),
                     "device_ms": device_ms(torch, lambda: fn(*args, **kw))}

    hdi, b1, b2 = bench_world(torch, dev, BATCH, **HEADLINE)
    entry("q8_headline", probes(torch, b1, b2, HEADLINE["k"], HEADLINE["w"]),
          hdi)
    (di21, di31), c1, c2 = multik_world(torch, dev)
    entry("c4_q12", probes(torch, c1, c2, 31, 1), di31)
    entry("c4_q8", probes(torch, c1, c2, 21, 8), di21)
    if deep is not None:
        for layout in ("q8", "q12"):
            ddi, dflat, _ = deep_index(torch, dev, deep, layout)
            entry(f"deep_{layout}", dflat, ddi)
            order = bucket_sort(*dflat, ddi.fused.shape[0], ddi.cfg.k)
            entry(f"deep_{layout}_sorted", dflat, ddi, order)
    return out


def time_k4(torch, dev, deep: Path | None) -> dict:
    """K4's forms, each held to its plain version first: CUDA-event ms and
    profiler device ms a call."""
    from pangea_tpu_torch.kernels import (bucket_sort, lookup_std,
                                          lookup_std_owned, lookup_std_plain,
                                          lookup_std_sorted)
    out = {}

    def check(name, want, got):
        mism = sum(int((a != b).sum()) for a, b in zip(want, got))
        if mism:
            raise AssertionError(f"{name}: {mism} mismatches")

    def timed(name, fn):
        out[name] = {"ms": time_ms(torch, fn),
                     "device_ms": device_ms(torch, fn)}

    di, b1, b2 = bench_world(torch, dev, BATCH, **WIDE)
    flat = probes(torch, b1, b2, WIDE["k"], WIDE["w"])
    tab = (di.fused, di.stash, di.cfg.ways)
    check("wide", lookup_std_plain(*flat, *tab), lookup_std(*flat, *tab))
    timed("wide", lambda: lookup_std(*flat, *tab))
    check("owned", lookup_std_plain(*flat, *tab, (4, 0)),
          lookup_std_owned(*flat, *tab, (4, 0)))
    timed("owned_4_0", lambda: lookup_std_owned(*flat, *tab, (4, 0)))
    order = bucket_sort(*flat, di.fused.shape[0])
    check("sorted wide", lookup_std_plain(*flat, *tab),
          lookup_std_sorted(*flat, *tab, order=order))
    timed("sorted_wide", lambda: lookup_std_sorted(*flat, *tab, order=order))
    out["n_wide"] = flat[0].numel()
    pdi, _, _ = bench_world(torch, dev, 1, **PACKED)
    pflat = probes(torch, b1, b2, PACKED["k"], PACKED["w"])
    ptab = (pdi.fused, pdi.stash, pdi.cfg.ways)
    check("packed", lookup_std_plain(*pflat, *ptab),
          lookup_std(*pflat, *ptab))
    timed("packed", lambda: lookup_std(*pflat, *ptab))
    if deep is not None:
        ddi, dflat, _ = deep_index(torch, dev, deep, "std")
        dtab = (ddi.fused, ddi.stash, ddi.cfg.ways)
        want = lookup_std_plain(*dflat, *dtab)
        check("deep", want, lookup_std(*dflat, *dtab))
        timed("deep", lambda: lookup_std(*dflat, *dtab))
        dorder = bucket_sort(*dflat, ddi.fused.shape[0])
        check("sorted deep", want,
              lookup_std_sorted(*dflat, *dtab, order=dorder))
        timed("sorted_deep",
              lambda: lookup_std_sorted(*dflat, *dtab, order=dorder))
        out["n_deep"] = dflat[0].numel()
    return out


def time_sort(torch, dev, deep: Path) -> dict:
    """K9, K10 and the sorted pairs on the deep world, each held to its
    plain version first: CUDA-event ms and profiler device ms a call."""
    from pangea_tpu_torch.kernels import (bucket_sort, bucket_sort_plain,
                                          lookup_q8_sorted, lookup_q12_sorted,
                                          lookup_std_sorted, route_bin,
                                          route_bin_plain)
    from pangea_tpu_torch.kernels.lookup import bucket_keys
    from pangea_tpu_torch.kernels.route import owner_of, route_capacity
    out = {}

    def timed(name, fn, n):
        split = device_split(torch, fn)
        out[name] = {"probes": n, "ms": time_ms(torch, fn),
                     "device_ms": sum(split.values()), "split": split}

    for layout in ("q8", "q12", "std"):
        di, flat, _ = deep_index(torch, dev, deep, layout)
        nb, n = di.fused.shape[0], flat[0].numel()
        k = None if layout == "std" else di.cfg.k
        records, inv = bucket_sort(*flat, nb, k)
        want = bucket_sort_plain(*flat, nb, k)
        keys = bucket_keys(*flat, nb, k)
        perm = records[:, 0].long()
        every = torch.arange(n, device=dev)
        lanes = torch.stack([flat[0], flat[1], flat[2].to(torch.int32)], 1)
        if not (torch.equal(torch.sort(perm).values, every)
                and torch.equal(keys[perm], keys[want[0][:, 0].long()])
                and torch.equal(records[:, 1:], lanes[perm])
                and torch.equal(inv[perm], every.to(torch.int32))):
            raise AssertionError(f"sort: K9 on deep {layout} disagrees")
        timed(f"k9_deep_{layout}", lambda: bucket_sort(*flat, nb, k), n)
        fn = {"q8": lookup_q8_sorted, "q12": lookup_q12_sorted,
              "std": lookup_std_sorted}[layout]
        tab = (di.fused, di.stash,
               *((di.cfg.ways,) if layout == "std" else
                 (di.cfg.k, di.cfg.ways) if layout == "q12" else
                 (di.cfg.k,)))
        timed(f"pair_deep_{layout}", lambda: fn(*flat, *tab), n)
    _, flat, _ = deep_index(torch, dev, deep, "q8")
    n = flat[0].numel()
    for S in ROUTE_SHARDS:
        cap = route_capacity(n, S)
        records, inv, counts = route_bin(*flat, S, cap)
        _, pinv, pcounts = route_bin_plain(*flat, S, cap)
        fits = inv >= 0
        slots = inv[fits].long()
        used = torch.zeros(records.shape[0], dtype=torch.bool, device=dev)
        used[slots] = True
        mine = torch.stack([torch.nonzero(fits)[:, 0].to(torch.int32),
                            flat[0][fits], flat[1][fits],
                            torch.ones_like(slots, dtype=torch.int32)], 1)
        if not (torch.equal(counts, pcounts)
                and int(fits.sum()) == int((pinv >= 0).sum())
                and not (fits & ~flat[2]).any()
                and torch.equal(slots // cap, owner_of(*flat[:2], S)[fits])
                and torch.equal(records[slots], mine)
                and not records[~used].any()):
            raise AssertionError(f"sort: K10 at {S} owners disagrees")
        timed(f"k10_s{S}", lambda: route_bin(*flat, S, cap), n)
    return out


def time_rowprobe(torch, dev) -> dict:
    """K11, K12 and, where the checkout has it, the routing pass on
    mb_pallas's world, each held to its plain version first: CUDA-event ms
    and profiler device ms a call."""
    from pangea_tpu_torch import kernels
    from pangea_tpu_torch.experiments import mb_pallas as MP
    table, b, rem = MP.world_tensors(MP.make_world(0), dev)
    nb = table.shape[0]
    want = kernels.rowprobe_plain(table, b, rem)
    out = {}

    def timed(name, fn):
        split = device_split(torch, fn)
        out[name] = {"queries": b.numel(), "ms": time_ms(torch, fn),
                     "device_ms": sum(split.values()), "split": split}

    if hasattr(kernels, "rowprobe_route"):
        records, totals = kernels.rowprobe_route(b, rem, nb)
        plain, plain_totals = kernels.rowprobe_route_plain(b, rem, nb)
        keys = records[:, 1].long() >> 5
        if not (torch.equal(totals, plain_totals)
                and not bool((keys[1:] < keys[:-1]).any())
                and torch.equal(records[records[:, 0].long().argsort()],
                                plain[plain[:, 0].long().argsort()])):
            raise AssertionError("rowprobe: the routing pass disagrees")
        timed("route", lambda: kernels.rowprobe_route(b, rem, nb))
    for name, fn in (("k11", kernels.rowprobe_smem),
                     ("k12", kernels.rowprobe_onehot)):
        if not torch.equal(fn(table, b, rem), want):
            raise AssertionError(f"rowprobe: {name} disagrees")
        timed(name, lambda fn=fn: fn(table, b, rem))
    return out


def time_block_copy(torch, dev) -> dict:
    from pangea_tpu_torch.experiments import mb_gather as MG
    from pangea_tpu_torch.kernels import block_copy
    x = torch.from_numpy(MG.block_world()).to(dev)
    out = {}
    for name, (n, _, _, _) in MG.VARIANTS.items():
        if not name.startswith("gather4"):
            continue
        start = torch.tensor([n], dtype=torch.int32, device=dev)
        if not torch.equal(block_copy(x, start, MG.BLOCK_ROWS),
                           x[n:n + MG.BLOCK_ROWS]):
            raise AssertionError(f"{name}: the block copy is not the slice")
        ms = time_ms(torch, lambda: block_copy(x, start, MG.BLOCK_ROWS))
        lib = time_ms(torch, lambda: x.narrow(0, n, MG.BLOCK_ROWS).clone())
        out[name] = {"ms": ms, "library_ms": lib, "ratio": ms / lib}
    return out


def lineage_lanes(np, torch, dev, tin, tout, B: int, R: int, seed: int):
    """(taxon, t_in, t_out, valid) [B, R] on dev: each read's hits drawn
    from LINEAGE_TAXA taxa of the taxonomy (tin, tout numpy [T + 1]), half
    of the probes misses; read 0 has no hit and read 1 no valid probe."""
    rng = np.random.default_rng(seed)
    T = tin.shape[0] - 1
    lineage = rng.integers(1, T + 1, (B, LINEAGE_TAXA))
    taxa = np.take_along_axis(lineage,
                              rng.integers(0, LINEAGE_TAXA, (B, R)), axis=1)
    taxon = np.where(rng.random((B, R)) < 0.5, taxa, 0).astype(np.int32)
    taxon[0] = 0
    valid = (rng.random((B, R)) < 0.8) | (taxon != 0)
    valid[1] = False
    return _on(torch, dev, taxon, tin, tout, valid)


def distinct_lanes(np, torch, dev, tin, tout, B: int, R: int, seed: int):
    """(taxon, t_in, t_out, valid) [B, R] on dev at U = R: every probe a
    valid hit, read b's taxa (o_b + j * s_b) mod T + 1 for j < R, with a
    stride s_b prime to T, so that they are R distinct taxa."""
    import math
    rng = np.random.default_rng(seed)
    T = tin.shape[0] - 1
    if R > T:
        raise ValueError(f"{R} distinct taxa of {T}")
    strides = np.array([s for s in range(1, 4096) if math.gcd(s, T) == 1])
    s = strides[rng.integers(0, strides.size, B)]
    o = rng.integers(0, T, B)
    j = rng.permutation(R)
    taxon = ((o[:, None] + j[None, :] * s[:, None]) % T + 1).astype(np.int32)
    return _on(torch, dev, taxon, tin, tout, np.ones((B, R), bool))


def _on(torch, dev, taxon, tin, tout, valid):
    import numpy as np
    hit = taxon != 0
    t_in = np.where(hit, tin[taxon], 0).astype(np.int32)
    t_out = np.where(hit, tout[taxon], 0).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (taxon, t_in, t_out, valid))


def time_score(torch, dev) -> dict:
    import numpy as np
    from pangea_tpu_torch.kernels import (lookup_q8, lookup_std,
                                          score_ranked, score_reads_plain,
                                          score_reads_taxon,
                                          score_reads_tin, score_winners,
                                          score_winners_plain)
    out = {}

    def check(name, want, got):
        mism = sum(int((a != b).sum()) for a, b in zip(want, got))
        if mism:
            raise AssertionError(f"{name}: {mism} mismatches")

    def entry(name, fn, want_fn):
        check(name, want_fn(), fn())
        out[name] = {"ms": time_ms(torch, fn),
                     "device_ms": device_ms(torch, fn)}

    qdi, b1, b2 = bench_world(torch, dev, BATCH, **HEADLINE)
    hi, lo, valid = probes(torch, b1, b2, HEADLINE["k"], HEADLINE["w"])
    B = b1.shape[0]
    hits = [t.reshape(B, -1) for t in lookup_q8(hi, lo, valid, qdi.fused,
                                                 qdi.stash, HEADLINE["k"])]
    qargs = (*hits, valid.reshape(B, -1))
    entry("k3_q8_headline",
          lambda: score_reads_tin(*qargs, qdi.tax, 0.0),
          lambda: score_reads_plain(*qargs, qdi.tax, 0.0, False))
    di, _, _ = bench_world(torch, dev, 1, **WIDE)
    hi, lo, valid = probes(torch, b1, b2, WIDE["k"], WIDE["w"])
    lanes = [t.reshape(B, -1) for t in lookup_std(hi, lo, valid, di.fused,
                                                  di.stash, di.cfg.ways)]
    wargs = (*lanes, valid.reshape(B, -1))
    entry("k3_taxon_wide_winners", lambda: score_winners(*wargs, True),
          lambda: score_winners_plain(*wargs, True))
    entry("k3_taxon_wide_direct",
          lambda: score_reads_taxon(*wargs, qdi.tax, 0.0),
          lambda: score_reads_plain(*wargs, qdi.tax, 0.0, True))
    tin, tout = (di.tax[n].cpu().numpy() for n in ("tin", "tout"))
    R, Bb = BUCKET
    args = lineage_lanes(np, torch, dev, tin, tout, Bb, R, SCORE_SEED)
    entry(f"k3_bucket_{R}x{Bb}", lambda: score_winners(*args, True),
          lambda: score_winners_plain(*args, True))
    for R, Bb in RANKED:
        args = lineage_lanes(np, torch, dev, tin, tout, Bb, R, SCORE_SEED)
        entry(f"k8_{R}x{Bb}",
              lambda: score_ranked(*args, di.tax, 0.0, True),
              lambda: score_reads_plain(*args, di.tax, 0.0, True))
        entry(f"k8_{R}x{Bb}_winners", lambda: score_winners(*args, True),
              lambda: score_winners_plain(*args, True))
    for R, Bb in ((wargs[0].shape[1], B), BUCKET, *RANKED):
        args = distinct_lanes(np, torch, dev, tin, tout, Bb, R, SCORE_SEED)
        entry(f"{'k8' if R > 2048 else 'k3'}_{R}x{Bb}_u_r",
              lambda: score_winners(*args, True),
              lambda: score_winners_plain(*args, True))
    return out


def launch_count(fn) -> int:
    """The ``_build.launch`` calls of one call of fn."""
    from pangea_tpu_torch.kernels import _build
    real, calls = _build.launch, []

    def spy(name, *args):
        calls.append(name)
        return real(name, *args)
    _build.launch = spy
    try:
        fn()
    finally:
        _build.launch = real
    return len(calls)


def time_tail(torch, dev) -> dict:
    import inspect
    import numpy as np
    from pangea_tpu_torch.classify import (classify_reads, merge_multik,
                                           merge_multik_plain)
    from pangea_tpu_torch.classify.engine import (_extract_probes,
                                                  probe_tables)
    from pangea_tpu_torch.kernels import (score_ranked, score_reads_plain,
                                          score_reads_taxon,
                                          score_reads_tin, score_winners,
                                          score_winners_plain)
    # Whether the checkout's scorer merges in its own launch.
    in_launch = "prior" in inspect.signature(score_reads_tin).parameters
    out = {"merge_in_scorer": in_launch}

    def entry(name, fn, want_fn):
        got, want = fn(), want_fn()
        mism = sum(int((a != b).sum()) for a, b in zip(want, got))
        if mism:
            raise AssertionError(f"{name}: {mism} mismatches")
        split = device_split(torch, fn)
        out[name] = {"ms": time_ms(torch, fn),
                     "device_ms": sum(split.values()),
                     "split": {k[:60]: v for k, v in split.items()},
                     "launches": launch_count(fn)}

    def hits_of(di, b1, b2):
        hi, lo, valid = _extract_probes(b1, b2, di.cfg, False)
        return (*probe_tables(di.tables, hi, lo, valid, di.cfg), valid)

    for name, kw, taxon_lanes in (("std", WIDE, True),
                                  ("q8_lift", Q8_LIFT, False)):
        di, b1, b2 = bench_world(torch, dev, BATCH, **kw)
        args = hits_of(di, b1, b2)
        fn = score_reads_taxon if taxon_lanes else score_reads_tin
        entry(f"{name}_scoring", lambda: fn(*args, di.tax, 0.0),
              lambda: score_reads_plain(*args, di.tax, 0.0, taxon_lanes))
        entry(f"{name}_winners_alone",
              lambda: score_winners(*args, taxon_lanes),
              lambda: score_winners_plain(*args, taxon_lanes))
        if name == "std":
            wide = di
    dis, b1, b2 = multik_world(torch, dev)
    first = classify_reads(dis[0].tables, b1, dis[0].cfg, mate_bases=b2)
    args = hits_of(dis[1], b1, b2)
    thr = dis[1].cfg.confidence_threshold
    tax0, tax1 = dis[0].tax, dis[1].tax
    keys = ("taxon", "best", "nvalid")

    def merged():
        if in_launch:
            return score_reads_tin(*args, tax1, thr, prior=(first, tax0))
        own = dict(zip(keys, score_reads_tin(*args, tax1, thr)))
        return tuple(merge_multik(first, own, tax0).values())

    def merged_plain():
        own = dict(zip(keys, score_reads_plain(*args, tax1, thr, False)))
        return tuple(merge_multik_plain(first, own, tax0).values())
    entry("config4_second_scoring", merged, merged_plain)
    entry("config4_k3_alone", lambda: score_reads_tin(*args, tax1, thr),
          lambda: score_reads_plain(*args, tax1, thr, False))
    tin, tout = (wide.tax[n].cpu().numpy() for n in ("tin", "tout"))
    for R, Bb in (BUCKET, RANKED[0]):
        args = lineage_lanes(np, torch, dev, tin, tout, Bb, R, SCORE_SEED)
        ranked = R > 2048
        tag = f"{'k8' if ranked else 'k3'}_{R}x{Bb}"
        entry(f"{tag}_scoring",
              (lambda: score_ranked(*args, wide.tax, 0.0, True)) if ranked
              else (lambda: score_reads_taxon(*args, wide.tax, 0.0)),
              lambda: score_reads_plain(*args, wide.tax, 0.0, True))
        entry(f"{tag}_winners_alone", lambda: score_winners(*args, True),
              lambda: score_winners_plain(*args, True))
    return out


def time_steps(torch, dev, deep: Path | None) -> dict:
    import os
    from pangea_tpu_torch.classify import Classifier, MultiKClassifier
    out = {}

    def step(model, b1, b2):
        split = device_split(torch, lambda: model(b1, b2))
        return {"one": time_stats(torch, lambda: model(b1, b2), 1),
                "back_to_back": time_stats(torch, lambda: model(b1, b2)),
                "launches": launch_count(lambda: model(b1, b2)),
                "device_ms": sum(split.values()),
                "split": {k[:60]: v for k, v in split.items()}}
    for name, kw in (("q8", HEADLINE), ("std", WIDE), ("q8_lift", Q8_LIFT)):
        di, b1, b2 = bench_world(torch, dev, BATCH, **kw)
        out[name] = step(Classifier(di), b1, b2)
    dis, b1, b2 = multik_world(torch, dev)
    out["config4"] = step(MultiKClassifier(dis), b1, b2)
    if deep is not None:
        for layout in ("q8", "q12", "std"):
            di, _, b = deep_index(torch, dev, deep, layout)
            model = Classifier(di)
            for path, env in (("sorted", "1"), ("unsorted", "0")):
                os.environ["PANGEA_DEEP_SORT"] = env
                try:
                    out[f"deep_{layout}_{path}"] = {
                        "one": time_stats(torch, lambda: model(b), 1),
                        "back_to_back": time_stats(torch,
                                                   lambda: model(b))}
                finally:
                    os.environ.pop("PANGEA_DEEP_SORT")
    return out


def cli_inputs(cache: Path) -> dict:
    """The cli section's indexes and FASTQs in ``cache``, written once."""
    from pangea_tpu_torch.bench import (cohort_barcodes, cohort_fastq,
                                        deep_genomes, deep_reads,
                                        long_read_mix, make_bench_world)
    from pangea_tpu_torch.index import build_index
    from pangea_tpu_torch.utils import datagen
    paths = {"idx": cache / "idx", "long": cache / "long.fastq",
             "cohort": cache / "cohort.fastq", "std_idx": cache / "std_idx",
             "std": (cache / "std_1.fastq", cache / "std_2.fastq"),
             "deep_idx": cache / "deep_idx", "deep": cache / "deep.fastq"}
    if not (cache / "done").exists():
        cache.mkdir(parents=True, exist_ok=True)
        bw = make_bench_world(n_reads=CLI_LONG[0], read_len=READ_LEN,
                              **HEADLINE)
        bw.index.save(str(paths["idx"]))
        mix = long_read_mix(bw.reads, CLI_LONG[0], bw.genomes, CLI_LONG[1],
                            1_000, 20_000, 16)
        datagen.write_fastq(str(paths["long"]), mix, mate=1)
        cohort_fastq(str(paths["cohort"]), bw.genomes, CLI_COHORT, 4)
        sw = make_bench_world(n_reads=CLI_STD, read_len=READ_LEN, **WIDE)
        sw.index.save(str(paths["std_idx"]))
        for mate, path in enumerate(paths["std"], 1):
            datagen.write_fastq(str(path), sw.reads, mate=mate)
        tax, genomes = deep_genomes()
        build_index(genomes, tax, k=21, w=1).save(str(paths["deep_idx"]))
        datagen.write_fastq(str(paths["deep"]),
                            deep_reads(genomes, CLI_DEEP, READ_LEN), mate=1)
        (cache / "done").write_text("")
    paths["barcodes"] = [[f"sample{i}", bc]
                         for i, bc in enumerate(cohort_barcodes(4))]
    return paths


def time_cli(cache: Path) -> dict:
    """The CLI runs of the ``cli`` section: reads/s, wall and host time by
    phase of each run, by workload."""
    import os
    import shutil
    import subprocess
    paths = cli_inputs(cache)
    root = Path(__file__).resolve().parents[3]
    runs = {
        "long": ["--index", str(paths["idx"]), "--reads", str(paths["long"]),
                 "input.long_reads=true", "input.max_long_read_len=16384",
                 "input.batch_size=8192"],
        "cohort": ["--config", str(root / "configs" / "config5_cohort.json"),
                   "--index", str(paths["idx"]), "--reads",
                   str(paths["cohort"]),
                   f"input.batch_size={CLI_COHORT_BATCH}", "trim.min_qual=20",
                   "trim.window=4", "trim.min_len=60", "demux.max_mismatch=1",
                   "demux.barcodes=" + json.dumps(paths["barcodes"])],
        "std": ["--index", str(paths["std_idx"]), "--reads",
                str(paths["std"][0]), "--mates", str(paths["std"][1]),
                f"input.batch_size={BATCH}"],
        "deep": ["--index", str(paths["deep_idx"]), "--reads",
                 str(paths["deep"]), f"input.batch_size={BATCH}"]}
    general = {"long", "cohort"}
    out = {}
    for name, args in runs.items():
        rows = []
        for rep in range(CLI_REPS):
            out_dir = cache / f"out_{name}_{rep}"
            shutil.rmtree(out_dir, ignore_errors=True)      # no resume
            env = dict(os.environ, **({"PANGEA_NO_NATIVE": "1"}
                                      if name == "cohort" else {}))
            proc = subprocess.run(
                [sys.executable, "-m", "pangea_tpu_torch.cli", "classify",
                 *args, "--out", str(out_dir), "--device", "cuda"],
                capture_output=True, text=True, env=env, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"cli {name}:\n{proc.stderr[-3000:]}")
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            if r["fast_path"] == (name in general):
                raise RuntimeError(f"cli {name}: fast_path {r['fast_path']}")
            rows.append({"reads_per_sec": r["reads_per_sec"],
                         "wall_sec": r["wall_sec"], "reads": r["reads_in"],
                         "host_sec": r["host_sec"]})
        out[name] = rows
    return out


def split(torch, dev) -> dict:
    """The block copy's host time a call, in parts (see the docstring)."""
    from pangea_tpu_torch.experiments import mb_gather as MG
    from pangea_tpu_torch.kernels import _build, block_copy
    from pangea_tpu_torch.kernels.gather import SMEM_OPTIN, gather_plan
    lib = _build.library()
    x = torch.from_numpy(MG.block_world()).to(dev)
    start = torch.tensor([4], dtype=torch.int32, device=dev)
    rows = MG.BLOCK_ROWS
    row_bytes = x.shape[1] * 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out_t = torch.empty((rows, x.shape[1]), dtype=x.dtype, device=dev)
    gather = lib.pangea_row_gather

    def parent_wrapper():
        d = _build.dispatch_device(x, start)
        _build.check(start, torch.int32, shape=(1,), name="start")
        _build.check(start, torch.int32, ndim=1, name="idx")
        if not x.is_contiguous() or x.dim() < 1:
            raise ValueError
        rb = math.prod(x.shape[1:]) * x.element_size()
        if rb == 0 or rb % 16 or x.data_ptr() % 16:
            raise ValueError
        if not 1 <= rows <= x.shape[0]:
            raise ValueError
        plan = gather_plan(start.numel(), 1, 1, rows * rb, sms, SMEM_OPTIN)
        torch.empty((start.numel() * rows, *x.shape[1:]), dtype=x.dtype,
                    device=d)
        return plan

    plan = parent_wrapper()

    def parent_guard():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    def current_guard():
        if torch._C._cuda_getDevice() == dev.index:
            return torch._C._cuda_getCurrentRawStream(dev.index)
        raise AssertionError("the card is not current")

    stream = parent_guard()

    def gather_call(n):
        return lambda: gather(x.data_ptr(), x.shape[0], row_bytes, rows,
                              start.data_ptr(), n, 1, 0, plan.grid,
                              plan.warps, plan.lanes, plan.slots,
                              out_t.data_ptr(), stream)

    parts = {"loop": host_ns(torch, lambda: None),
             "library": host_ns(
                 torch, lambda: x.narrow(0, 4, rows).clone())}
    parts["parent"] = {
        "wrapper": host_ns(torch, parent_wrapper),
        "guard": host_ns(torch, parent_guard),
        "ctypes": host_ns(torch, gather_call(0)),
        "ctypes_launch": host_ns(torch, gather_call(1))}
    current = {"whole": host_ns(torch, lambda: block_copy(x, start, rows)),
               "guard": host_ns(torch, current_guard)}
    if hasattr(lib, "pangea_block_copy"):
        from pangea_tpu_torch.kernels.gather import _block_geometry
        shape = _block_geometry(x.shape, x.dtype, rows)[1]

        def checks():
            _build.check(start, torch.int32, shape=(1,), name="start")
            if not x.is_contiguous() or x.data_ptr() % 16:
                raise ValueError
            return _block_geometry(x.shape, x.dtype, rows)
        current.update(
            dispatch=host_ns(torch, lambda: _build.dispatch_device(x,
                                                                   start)),
            checks=host_ns(torch, checks),
            empty=host_ns(torch, lambda: torch.empty(
                shape, dtype=x.dtype, device=dev)))
        copy = lib.pangea_block_copy
        # rows 0: the launcher refuses the copy before launching.
        current["ctypes"] = host_ns(torch, lambda: copy(
            x.data_ptr(), x.shape[0], row_bytes, 0, start.data_ptr(),
            out_t.data_ptr(), stream))
        current["ctypes_launch"] = host_ns(torch, lambda: copy(
            x.data_ptr(), x.shape[0], row_bytes, rows, start.data_ptr(),
            out_t.data_ptr(), stream))
    parts["current"] = current
    # The block copy captured in a CUDA graph (its output is the graph's
    # own): host ns a replay, and CUDA-event ms as for the kernels.
    graph = torch.cuda.CUDAGraph()
    block_copy(x, start, rows)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        static = block_copy(x, start, rows)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(static, x[4:4 + rows]):
        raise AssertionError("the captured block copy is not the slice")
    parts["graph"] = {"replay": host_ns(torch, graph.replay),
                      "replay_ms": time_ms(torch, graph.replay),
                      "block_copy_ms": time_ms(
                          torch, lambda: block_copy(x, start, rows)),
                      "library_ms": time_ms(
                          torch, lambda: x.narrow(0, 4, rows).clone())}
    return parts


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deep", type=Path, default=None,
                    help="time K2, K4, K9, K10 and the deep steps on the "
                         "deep world, its index in DIR")
    ap.add_argument("--cli", type=Path, default=None,
                    help="time the classify CLI's runs, their inputs in "
                         "DIR")
    ap.add_argument("--split", action="store_true",
                    help="split the block copy's host time into parts")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="the sections to run, comma-separated, of "
                         f"{', '.join(SECTIONS)}")
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    if not set(sections) <= set(SECTIONS):
        ap.error(f"sections {sections}: not all of {SECTIONS}")
    if not torch.cuda.is_available():
        print("ab_timing: no CUDA device", file=sys.stderr)
        return 1
    import pangea_tpu_torch
    dev = torch.device("cuda", 0)
    line = {"checkout": str(Path(pangea_tpu_torch.__file__).parent),
            "device": torch.cuda.get_device_name(dev)}
    if "k1" in sections:
        line["k1"] = time_k1(torch, dev)
    if "block_copy" in sections:
        line["block_copy"] = time_block_copy(torch, dev)
    if args.split:
        line["split"] = split(torch, dev)
    if "k2" in sections:
        line["k2"] = time_k2(torch, dev, args.deep)
    if "k4" in sections:
        line["k4"] = time_k4(torch, dev, args.deep)
    if "sort" in sections and args.deep is not None:
        line["sort"] = time_sort(torch, dev, args.deep)
    if "rowprobe" in sections:
        line["rowprobe"] = time_rowprobe(torch, dev)
    if "score" in sections:
        line["score"] = time_score(torch, dev)
    if "tail" in sections:
        line["tail"] = time_tail(torch, dev)
    if "steps" in sections:
        line["steps"] = time_steps(torch, dev, args.deep)
    if "cli" in sections and args.cli is not None:
        line["cli"] = time_cli(args.cli)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
