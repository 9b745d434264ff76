#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paired-end q8 classify path on one GPU.

Run from the root of the repository, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases:
  1. device check: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc compiles the kernels of src/pangea_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version, bit for bit, at the
     bench shapes (16384 pairs of 150 bp reads, k=21, w=8, the 16384 x 128
     q8 table), plus the lookup on a table with a forced stash and the
     scorer at two thresholds; prints mismatch counts and times;
  4. the Classifier on that batch: every kernel's launch count, the outputs
     against the plain path and the reads' planted truth, and the step time
     of both paths by CUDA events;
  5. the main path as a user drives it: the classify CLI, on 24,576 pairs
     in three batches of 8192, with every kernel's launch count in that
     run, its lines against phase 4's outputs, and the host time of its
     loop by phase;
  6. torch.profiler over back-to-back steps: the device time of each
     kernel and the device's busy share of the wall.

The plain path is held to the JAX reference and its golden model by the
CPU tests (tests/test_torch_classify.py), and the kernels to the golden
model on the card by tests/test_torch_gpu.py. This script imports nothing
but the standard library, torch and pangea_tpu_torch.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Any failed phase raises and the exit
code is non-zero; so it is without a CUDA device.
"""
from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, READ_LEN, K, W = 16384, 150, 21, 8
CLI_PAIRS, CLI_BATCH = 24576, 8192
WARMUP, REPS = 3, 20
PIPELINED = 10           # back-to-back calls a timing sample
PROFILE_STEPS = 100
MAX_OFF_LINEAGE = 0.001  # share of pairs assigned off their truth's lineage
THRESHOLDS = (0.0, 0.3)
# name -> (kernel source, the reference function it replaces)
KERNELS = {
    "extract_probes": ("src/pangea_tpu_torch/csrc/extract_probes.cu",
                       "src/pangea_tpu/kernels/encode.py:100"),
    "lookup_q8": ("src/pangea_tpu_torch/csrc/lookup_q8.cu",
                  "src/pangea_tpu/kernels/lookup.py:710"),
    "score_tin": ("src/pangea_tpu_torch/csrc/score_tin.cu",
                  "src/pangea_tpu/kernels/score.py:237"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, calls: int = 1) -> float:
    """ms per call of fn: the median over REPS samples, after WARMUP calls,
    of the CUDA-event time of `calls` back-to-back calls, divided by
    `calls`. calls=1 is the latency of one call, host launch overhead
    included; calls=PIPELINED keeps the card fed, so a call that the host
    enqueues faster than the card runs it reads as device time."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
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
    path = _build.build()
    _build.library()
    log(f"[2] built {path} in {time.time() - t0:.1f} s")


def phase_kernels(torch, world, cuda) -> dict:
    from pangea_tpu_torch.index import relayout_q8
    from pangea_tpu_torch.kernels import (extract_probes, extract_probes_plain,
                                          lookup_q8, lookup_q8_plain,
                                          score_reads_tin,
                                          score_reads_tin_plain)
    from pangea_tpu_torch.kernels.minimize import probe_width
    idx, di, b1, b2 = world["idx"], world["di"], world["b1"], world["b2"]
    nw = probe_width(READ_LEN, K, W)
    R = 2 * nw
    results = {}

    def probes(fn):
        out = (torch.empty((BATCH, R), dtype=torch.int32, device=cuda),
               torch.empty((BATCH, R), dtype=torch.int32, device=cuda),
               torch.empty((BATCH, R), dtype=torch.bool, device=cuda))
        fn(b1, K, W, out, 0)
        fn(b2, K, W, out, nw)
        return out

    mism, err = compare(probes(extract_probes_plain), probes(extract_probes))
    log(f"[3] extract_probes [{BATCH} x {READ_LEN}] x 2 mates -> "
        f"[{BATCH}, {R}]: mismatches {mism}")
    results["extract_probes"] = {
        "mismatches": mism, "max_abs_err": err,
        "ms": time_ms(torch, lambda: probes(extract_probes), PIPELINED),
        "plain_ms": time_ms(torch, lambda: probes(extract_probes_plain),
                            PIPELINED)}

    hi, lo, valid = (t.reshape(-1) for t in probes(extract_probes))
    fused, stash = di.fused, di.stash
    want = lookup_q8_plain(hi, lo, valid, fused, stash, K)
    mism, err = compare(want, lookup_q8(hi, lo, valid, fused, stash, K))
    log(f"[3] lookup_q8 {hi.numel()} probes on [{fused.shape[0]}, "
        f"{fused.shape[1]}], stash {stash.shape[1]}: mismatches {mism}, "
        f"hits {int((want[0] != 0).sum())}")
    # A table with a forced stash, probed by the batch and by every key of
    # its stash, so that both the rows and the stash hit.
    f4, s4, _ = relayout_q8(idx, ways=4, load_factor=2.0)
    f4 = torch.from_numpy(f4[0].view("int32")).to(cuda)
    s4 = torch.from_numpy(s4[0].view("int32")).to(cuda)
    if s4.shape[1] == 0:
        raise AssertionError("the forced-stash table has an empty stash")
    hi4 = torch.cat([hi, s4[0]])
    lo4 = torch.cat([lo, s4[1]])
    v4 = torch.cat([valid, torch.ones(s4.shape[1], dtype=torch.bool,
                                      device=cuda)])
    want4 = lookup_q8_plain(hi4, lo4, v4, f4, s4, K)
    mism4, err4 = compare(want4, lookup_q8(hi4, lo4, v4, f4, s4, K))
    stash_hits = int((want4[0][hi.numel():] != 0).sum())
    log(f"[3] lookup_q8 forced stash: {hi4.numel()} probes on "
        f"[{f4.shape[0]}, {f4.shape[1]}], stash {s4.shape[1]} "
        f"({stash_hits} stash keys hit): mismatches {mism4}")
    if stash_hits != s4.shape[1]:
        raise AssertionError("a stash key missed its own stash")
    results["lookup_q8"] = {
        "mismatches": mism + mism4, "max_abs_err": max(err, err4),
        "ms": time_ms(torch, lambda: lookup_q8(hi, lo, valid, fused, stash,
                                               K), PIPELINED),
        "plain_ms": time_ms(torch, lambda: lookup_q8_plain(
            hi, lo, valid, fused, stash, K), PIPELINED)}

    hit, t_in, t_out = (t.reshape(BATCH, R) for t in want)
    valid2 = valid.reshape(BATCH, R)
    tax = (di.tax["tin"], di.tax["tout"], di.tax["depth"])
    mism, err = 0, 0
    for thr in THRESHOLDS:
        m, e = compare(
            score_reads_tin_plain(hit, t_in, t_out, valid2, *tax, thr),
            score_reads_tin(hit, t_in, t_out, valid2, *tax, thr))
        log(f"[3] score_tin [{BATCH}, {R}], {tax[0].numel()} taxa, "
            f"threshold {thr}: mismatches {m}")
        mism, err = mism + m, max(err, e)
    results["score_tin"] = {
        "mismatches": mism, "max_abs_err": err,
        "ms": time_ms(torch, lambda: score_reads_tin(
            hit, t_in, t_out, valid2, *tax, 0.0), PIPELINED),
        "plain_ms": time_ms(torch, lambda: score_reads_tin_plain(
            hit, t_in, t_out, valid2, *tax, 0.0), PIPELINED)}
    for name, r in results.items():
        log(f"[3] {name}: kernel {r['ms']} ms, plain {r['plain_ms']} ms a "
            f"call ({PIPELINED} back-to-back calls a sample, median of "
            f"{REPS} CUDA-event samples)")
    bad = [n for n, r in results.items() if r["mismatches"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return results




def phase_slice(torch, world, cuda, card: str) -> dict:
    from pangea_tpu_torch.classify import Classifier, classify_reads
    from pangea_tpu_torch.kernels import (kernel_launches,
                                          reset_kernel_launches)
    b1, b2 = world["b1"], world["b2"]
    model = Classifier(world["di"])
    reset_kernel_launches()
    out = model(b1, b2)
    torch.cuda.synchronize()
    launches = kernel_launches()
    log(f"[4] kernel launches in one Classifier step: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not launch: "
                             f"{launches}")
    out = {k: v.cpu() for k, v in out.items()}
    for k, v in out.items():
        if v.dtype != torch.int32 or tuple(v.shape) != (BATCH,):
            raise AssertionError(f"{k}: {v.dtype} {tuple(v.shape)}")

    def plain_step():
        return classify_reads(model.index.tables, b1, model.cfg,
                              mate_bases=b2, plain=True)

    plain = plain_step()
    mism, _ = compare([plain[k].cpu() for k in out], list(out.values()))
    log(f"[4] kernel path vs plain path on {BATCH} pairs: mismatches {mism}")
    # Planted truth: a classified pair's taxon is its source species or an
    # ancestor of it (genus mates share a core, whose k-mers LCA-merge).
    tin, tout = (world["di"].tax[n].cpu().long() for n in ("tin", "tout"))
    taxon = out["taxon"].long()
    truth = torch.from_numpy(world["truth"][:BATCH]).long()
    classified = taxon != 0
    on_lineage = (tin[taxon] <= tin[truth]) & (tin[truth] < tout[taxon])
    off = int((classified & ~on_lineage).sum())
    log(f"[4] planted truth: {int(classified.sum())} of {BATCH} pairs "
        f"classified, {off} off their truth's lineage")
    if mism or off > MAX_OFF_LINEAGE * BATCH or not classified.any():
        raise AssertionError("the classify step disagrees with its references")

    for calls, what in ((1, "one step"), (PIPELINED, "back-to-back steps")):
        step = time_ms(torch, lambda: model(b1, b2), calls)
        plain = time_ms(torch, plain_step, calls)
        log(f"[4] {what}, {BATCH} pairs, on {card}: kernel path {step} ms "
            f"({BATCH / step * 1e3} reads/s), plain path {plain} ms "
            f"({BATCH / plain * 1e3} reads/s); median of {REPS} CUDA-event "
            f"samples of {calls} call(s)")
    return out


def phase_cli(world, out: dict, device: str) -> dict:
    """The classify CLI, in this process, on config 2's settings; returns
    the kernel launches of that run."""
    from pangea_tpu_torch import cli
    from pangea_tpu_torch.bench import write_fastq_pair
    from pangea_tpu_torch.kernels import (kernel_launches,
                                          reset_kernel_launches)
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    reads = world["reads"]
    write_fastq_pair(reads, str(work / "reads_1.fastq"),
                     str(work / "reads_2.fastq"))
    world["idx"].save(str(work / "idx"))
    out_dir = work / "out"
    argv = ["classify",
            "--config", str(ROOT / "configs" / "config2_16s_paired.json"),
            "--index", str(work / "idx"),
            "--reads", str(work / "reads_1.fastq"),
            "--mates", str(work / "reads_2.fastq"),
            "--samples", "smoke", "--out", str(out_dir), "--device", device,
            f"input.batch_size={CLI_BATCH}"]
    stdout = io.StringIO()
    t0 = time.time()
    reset_kernel_launches()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(argv)
    launches = kernel_launches()
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    result = json.loads(stdout.getvalue().strip().splitlines()[-1])
    log(f"[5] CLI in {time.time() - t0:.1f} s: {json.dumps(result)}")
    log(f"[5] kernel launches in the CLI run: {launches}")
    host = result["host_sec"]
    loop = sum(host.values())
    log("[5] CLI loop host time by phase: " + ", ".join(
        f"{k} {v} s ({100 * v / loop} %)" for k, v in host.items()))
    # Each line: flag, read id, taxon, rank, name, best/nvalid, confidence.
    rows = [line.split("\t") for line in
            (out_dir / "smoke.assign.tsv").read_text().splitlines()]
    ids_bad = sum(r[1] != rid for r, rid in zip(rows, reads.ids))
    step_bad = sum(
        (int(r[2]), r[5]) != (int(out["taxon"][i]),
                              f"{int(out['best'][i])}/{int(out['nvalid'][i])}")
        for i, r in enumerate(rows[:BATCH]))
    log(f"[5] {len(rows)} assignment lines; read ids out of order {ids_bad}; "
        f"first {BATCH} vs phase 4's step: mismatches {step_bad}")
    if len(rows) != CLI_PAIRS or ids_bad or step_bad:
        raise AssertionError("the CLI's assignments are wrong")
    if not (out_dir / "smoke.summary.tsv").exists():
        raise AssertionError("the CLI wrote no summary")
    if min(launches.values()) < 1:
        raise AssertionError(f"the CLI bypassed a kernel: {launches}")
    return launches


def phase_profile(torch, world, card: str) -> None:
    """Device time of each kernel over PROFILE_STEPS back-to-back steps,
    and the device's busy share of their wall (one stream: kernels never
    overlap, so their summed time is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    from pangea_tpu_torch.classify import Classifier
    model = Classifier(world["di"])
    b1, b2 = world["b1"], world["b2"]
    for _ in range(WARMUP):
        model(b1, b2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(PROFILE_STEPS):
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
        kernels[e.key] = (us / 1e3 / PROFILE_STEPS, e.count // PROFILE_STEPS)
    busy = sum(ms for ms, _ in kernels.values())
    log(f"[6] torch.profiler, {PROFILE_STEPS} back-to-back steps of {BATCH} "
        f"pairs on {card}: wall {wall_ms / PROFILE_STEPS} ms a step, device "
        f"busy {busy} ms a step ({100 * busy * PROFILE_STEPS / wall_ms} %)")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        log(f"[6]   {ms} ms a step ({100 * ms / busy if busy else 0} % of "
            f"busy), {n} launch(es) a step: {name[:100]}")
    if not kernels:
        log("[6] the profiler recorded no device time")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "pangea_tpu_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/pangea_tpu_torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    cuda = torch.device("cuda", 0)
    card = phase_device(torch)
    phase_build()

    from pangea_tpu_torch.bench import make_bench_world
    from pangea_tpu_torch.classify import DeviceIndex, pad_batch
    t0 = time.time()
    bw = make_bench_world(n_reads=CLI_PAIRS, read_len=READ_LEN, k=K, w=W)
    rs = bw.reads
    world = {"idx": bw.index, "reads": rs, "truth": rs.truth,
             "di": DeviceIndex.from_index(bw.index, cuda, 0.0),
             "b1": torch.from_numpy(pad_batch(rs.seqs[:BATCH], BATCH,
                                              READ_LEN)).to(cuda),
             "b2": torch.from_numpy(pad_batch(rs.mates[:BATCH], BATCH,
                                              READ_LEN)).to(cuda)}
    log(f"[3] bench world in {time.time() - t0:.1f} s: {bw.index!r}, "
        f"{bw.taxonomy.num_taxa} taxa, q8 table "
        f"{tuple(world['di'].fused.shape)}")
    results = phase_kernels(torch, world, cuda)
    out = phase_slice(torch, world, cuda, card)
    launches = phase_cli(world, out, "cuda")
    phase_profile(torch, world, card)

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": ref,
         "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (src, ref) in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
