"""Trim, demux and the native reader of the port against the reference, and
the port's classify CLI against the JAX CLI on trimmed and demultiplexed
runs, on both read paths, byte for byte (CPU)."""
import gzip
import json
import os
import shutil

import numpy as np
import pytest

from pangea_tpu import cli as ref_cli
from pangea_tpu.core import encode_bases as ref_encode_bases
from pangea_tpu.io import demux as ref_demux
from pangea_tpu.io import native as ref_native
from pangea_tpu.io import packed_ops as ref_ops
from pangea_tpu.io import trim as ref_trim
from pangea_tpu.io.fastx import ReadBatch as RefBatch
from pangea_tpu_torch import cli
from pangea_tpu_torch.core import encode_bases
from pangea_tpu_torch.dist import mesh as port_mesh
from pangea_tpu_torch.io import demux, native, packed_ops, trim
from pangea_tpu_torch.io.fastx import ReadBatch

from .helpers import small_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARCODES = [["s0", "ACGTACGT"], ["s1", "TTGGCCAA"], ["s2", "GATCGATC"]]
DEMUX = "demux.barcodes=" + json.dumps(BARCODES)
OUTPUTS = (".tsv", "stats.json", "manifest.json")


def write_cohort_fastq(path, seqs, ids, rng, barcodes=None, mate=1,
                       qual_slope=(0.1, 0.5)):
    """FASTQ of the reads with qualities that fall toward the 3' end (a
    seeded slope a read, with noise). With barcodes (sequences), mate 1
    gets one before each read: 20 % with one base changed (an N a third of
    the time), 15 % a random one, the rest exact."""
    with open(path, "w") as fh:
        for rid, seq in zip(ids, seqs):
            s = "".join("ACGTN"[c] for c in seq)
            if barcodes:
                bc = barcodes[int(rng.integers(len(barcodes)))]
                r = rng.random()
                if r < 0.15:
                    bc = "".join(rng.choice(list("ACGT"), len(bc)))
                elif r < 0.35:
                    j = int(rng.integers(len(bc)))
                    b = "N" if rng.random() < 0.3 else \
                        "ACGT"[("ACGT".index(bc[j]) + 1) % 4]
                    bc = bc[:j] + b + bc[j + 1:]
                s = bc + s
            q = np.clip(40 - np.arange(len(s)) * rng.uniform(*qual_slope)
                        + rng.normal(0, 4, len(s)), 2, 41).astype(int)
            fh.write(f"@{rid}/{mate}\n{s}\n+\n"
                     + "".join(chr(33 + x) for x in q) + "\n")


def make_cohort(d, n_reads=300, seed=4):
    """The index and the cohort's files in d: c_1/c_2.fastq (barcoded
    mate 1, falling qualities), c.fasta (the same mate-1 records, no
    qualities) and l_1.fastq (36-base barcodes, past the fast path's 32).
    Returns the long barcodes."""
    tax, genomes, idx, rs = small_world(k=21, seed=seed, genome_len=3000,
                                        n_reads=n_reads, read_len=120,
                                        paired=True, w=8)
    idx.save(str(d / "idx"))
    rng = np.random.default_rng(seed)
    write_cohort_fastq(str(d / "c_1.fastq"), rs.seqs, rs.ids, rng,
                       [bc for _, bc in BARCODES])
    write_cohort_fastq(str(d / "c_2.fastq"), rs.mates, rs.ids, rng, mate=2)
    with open(d / "c.fasta", "w") as fh:
        lines = open(d / "c_1.fastq").read().splitlines()
        for i in range(0, len(lines), 4):
            fh.write(f">{lines[i][1:]}\n{lines[i + 1][:50]}\n"
                     f"{lines[i + 1][50:]}\n")
    long_bcs = ["".join(rng.choice(list("ACGT"), 36)) for _ in range(2)]
    write_cohort_fastq(str(d / "l_1.fastq"), rs.seqs, rs.ids, rng, long_bcs)
    return long_bcs


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cohort")
    long_bcs = make_cohort(d)
    return d, long_bcs


def run_both(args, work, monkeypatch=None, env=None):
    """The JAX CLI, then the port's (``--device cpu``), each into
    work/out; returns (the reference's outputs moved to work/ref, the
    port's work/out), so that the paths in manifest.json are the same."""
    out, ref = work / "out", work / "ref"
    args = args + ["mesh.n_data=1", "mesh.n_shard=1"]
    if monkeypatch is not None and env:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    assert ref_cli.main(args + ["--out", str(out)]) == 0
    shutil.move(str(out), str(ref))
    assert cli.main(args + ["--out", str(out), "--device", "cpu"]) == 0
    return ref, out


def assert_same_outputs(ref, out):
    names = sorted(f for f in os.listdir(ref) if f.endswith(OUTPUTS))
    assert sorted(f for f in os.listdir(out) if f.endswith(OUTPUTS)) == names
    for f in names:
        assert (out / f).read_bytes() == (ref / f).read_bytes(), f
    return names


def assert_same_records(ref, out):
    """run_summary.json: every reference key, the time-free values equal;
    metrics.jsonl: a line a batch, the reference's keys in its order, the
    counts equal."""
    rs = json.loads((ref / "run_summary.json").read_text())
    ps = json.loads((out / "run_summary.json").read_text())
    assert set(rs) <= set(ps)
    for k in ("reads", "reads_in", "reads_kept", "reads_filtered",
              "truncated_reads", "samples", "indexes", "pct_classified",
              "mesh", "late_compiled_shapes"):
        assert ps[k] == rs[k], k
    rm = [json.loads(x) for x in (ref / "metrics.jsonl").read_text()
          .splitlines()]
    pm = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
          .splitlines()]
    assert len(pm) == len(rm)
    for a, b in zip(rm, pm):
        assert list(b) == list(a)
        for k in ("file", "batch", "reads", "reads_kept", "cum_reads",
                  "pct_classified"):
            assert b[k] == a[k], k
    return ps


# ------------------------------------------------------------ host modules
@pytest.mark.parametrize("seq", ["ACGTacgtUu", "NNNRYacg", "", "A" * 40,
                                 b"GATTACA"])
def test_encode_bases_as_reference(seq):
    np.testing.assert_array_equal(encode_bases(seq), ref_encode_bases(seq))


def _random_read(rng, n, all_n_head=0):
    seq = rng.integers(0, 5, n).astype(np.uint8)
    seq[:all_n_head] = 4
    q = rng.integers(0, 42, n).astype(np.uint8)
    return seq, q


@pytest.mark.parametrize("min_qual,window,max_len", [
    (0, 4, 0), (20, 4, 0), (20, 1, 0), (20.5, 10, 60), (30, 4, 50),
    (15, 200, 0), (12, 64, 90), (0, 4, 30)],
    ids=["noop", "q20w4", "w1", "frac_q_w10_max", "q30_max",
         "window_past_read", "w64", "max_len_only"])
def test_trim_one_as_reference(min_qual, window, max_len):
    """Every read length 0-150 (windows longer than the read pass it
    through), all-N heads, with and without qualities."""
    rng = np.random.default_rng(window)
    cfg = trim.TrimConfig(min_qual, window, 0, max_len)
    rcfg = ref_trim.TrimConfig(min_qual, window, 0, max_len)
    for n in range(151):
        seq, q = _random_read(rng, n, all_n_head=n // 3 if n % 2 else 0)
        for qual in (q, None):
            got = trim._trim_one(seq, qual, cfg)
            want = ref_trim._trim_one(seq, qual, rcfg)
            np.testing.assert_array_equal(got[0], want[0])
            if want[1] is None:
                assert got[1] is None
            else:
                np.testing.assert_array_equal(got[1], want[1])


def _batches(rng, n, paired, quals=True):
    seqs, qs, ms, mq = [], [], [], []
    for i in range(n):
        s, q = _random_read(rng, int(rng.integers(0, 160)),
                            all_n_head=int(rng.integers(0, 12)) * (i % 3 == 0))
        seqs.append(s)
        qs.append(q)
        s2, q2 = _random_read(rng, int(rng.integers(0, 160)))
        ms.append(s2)
        mq.append(q2)
    kw = dict(ids=[f"r{i}" for i in range(n)], seqs=seqs,
              quals=qs if quals else None,
              mate_seqs=ms if paired else None,
              mate_quals=mq if paired and quals else None, sample="x")
    return ReadBatch(**kw), RefBatch(**kw)


def _assert_batch_equal(got, want):
    assert got.ids == want.ids and got.sample == want.sample
    for f in ("seqs", "quals", "mate_seqs", "mate_quals"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("quals", [True, False], ids=["fastq", "fasta"])
@pytest.mark.parametrize("cfg", [(20, 4, 60, 0), (25, 8, 30, 100),
                                 (0, 4, 0, 0), (0, 4, 80, 0)],
                         ids=["trim_min", "trim_max", "noop", "min_len"])
def test_trim_batch_as_reference(paired, quals, cfg):
    got_in, want_in = _batches(np.random.default_rng(7), 200, paired, quals)
    got = trim.trim_batch(got_in, trim.TrimConfig(*cfg))
    want = ref_trim.trim_batch(want_in, ref_trim.TrimConfig(*cfg))
    _assert_batch_equal(got, want)


@pytest.mark.parametrize("barcodes,max_mismatch", [
    (BARCODES, 0), (BARCODES, 1), (BARCODES, 2),
    ([["a", "ACG"], ["b", "ACGTTT"], ["c", "NNN"]], 1),
    ([["a", "A" * 40]], 3)],
    ids=["exact", "mm1", "mm2", "mixed_lengths", "long"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_demux_batch_as_reference(barcodes, max_mismatch, paired):
    """Barcodes planted with errors and N, reads shorter than a barcode,
    ties to the first barcode, a barcode longer than 32 bases."""
    rng = np.random.default_rng(max_mismatch)
    got_in, want_in = _batches(rng, 300, paired)
    codes = [encode_bases(bc) for _, bc in barcodes]
    for i, s in enumerate(got_in.seqs):
        bc = codes[i % len(codes)].copy()
        bc[rng.random(bc.size) < 0.1] = rng.integers(0, 5)
        if i % 4:
            s = np.concatenate([bc, s])
        got_in.seqs[i] = want_in.seqs[i] = s
        got_in.quals[i] = want_in.quals[i] = rng.integers(
            0, 42, s.size).astype(np.uint8)
    cfg = tuple(map(tuple, barcodes))
    got = demux.demux_batch(got_in, demux.DemuxConfig(cfg, max_mismatch))
    want = ref_demux.demux_batch(want_in,
                                 ref_demux.DemuxConfig(cfg, max_mismatch))
    assert list(got) == list(want) and demux.UNDETERMINED == \
        ref_demux.UNDETERMINED
    for name in want:
        _assert_batch_equal(got[name], want[name])


def pack_rows(codes, lens, L):
    """Wire rows of padded codes (the native reader's packed layout)."""
    w16, w32 = packed_ops.wire_widths(L)
    B = codes.shape[0]
    rows = np.zeros((B, w16 + w32), np.uint32)
    pos = np.arange(L)
    bad = (codes > 3) | (pos[None, :] >= lens[:, None])
    c = np.where(bad, 0, codes).astype(np.uint32)
    for j in range(L):
        rows[:, j // 16] |= c[:, j] << np.uint32(2 * (j % 16))
        rows[:, w16 + j // 32] |= bad[:, j].astype(np.uint32) \
            << np.uint32(j % 32)
    for t in range(w32):                     # pad bits past L stay set
        hi = 32 * t + 32 - L
        if hi > 0:
            rows[:, w16 + t] |= np.uint32((0xFFFFFFFF << (32 - hi))
                                          & 0xFFFFFFFF)
    return rows


def _packed_world(seed, B=257, L=150):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, B)
    lens[:5] = [0, 1, L, 31, 33]
    codes = rng.integers(0, 5, (B, L)).astype(np.uint8)
    codes[::7, :12] = 4                               # all-N heads
    quals = rng.integers(0, 42, (B, L)).astype(np.uint8)
    quals[np.arange(L)[None, :] >= lens[:, None]] = 0
    return codes, lens.astype(np.int32), quals, pack_rows(codes, lens, L)


@pytest.mark.parametrize("L", [1, 31, 32, 150, 300])
def test_wire_widths_as_reference(L):
    assert packed_ops.wire_widths(L) == ref_ops.wire_widths(L)


@pytest.mark.parametrize("min_qual,window", [
    (20, 4), (20.5, 3), (0, 4), (30, 1), (10, 151), (25, 300), (41, 16),
    (2, 8)], ids=["q20w4", "frac_q", "off", "w1", "window_past_L",
                  "int32_sums", "q_past_max", "low_q"])
def test_qtrim_cut_as_reference_and_per_read(min_qual, window):
    """The batch rule against the reference's and against the per-read
    rule of trim._trim_one, windows longer than reads and than L."""
    codes, lens, quals, _ = _packed_world(window)
    got = packed_ops.qtrim_cut(quals, lens, min_qual, window)
    np.testing.assert_array_equal(
        got, ref_ops.qtrim_cut(quals, lens, min_qual, window))
    cfg = trim.TrimConfig(min_qual, window)
    per_read = [trim._trim_one(codes[i, :n], quals[i, :n], cfg)[0].size
                for i, n in enumerate(lens)]
    np.testing.assert_array_equal(got, per_read)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 33])
def test_unpack_head_as_reference(m):
    codes, lens, _, rows = _packed_world(m)
    if m > 32:
        with pytest.raises(ValueError, match="m <= 32"):
            packed_ops.unpack_head(rows, 150, m)
        return
    got, want = (f(rows, 150, m) for f in (packed_ops.unpack_head,
                                          ref_ops.unpack_head))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], (codes[:, :m] > 3)
                                  | (np.arange(m) >= lens[:, None]))


@pytest.mark.parametrize("barcodes,max_mismatch", [
    (BARCODES, 0), (BARCODES, 1), ([["a", "ACG"], ["b", "ACGTTTGA"]], 1),
    ([["a", "ACGT" * 8]], 2)], ids=["exact", "mm1", "mixed", "bc32"])
def test_demux_assign_as_reference_and_per_read(barcodes, max_mismatch):
    codes, lens, quals, rows = _packed_world(max_mismatch)
    bc_codes = [encode_bases(bc) for _, bc in barcodes]
    for i in range(0, codes.shape[0], 2):    # plant barcodes, some broken
        bc = bc_codes[i % len(bc_codes)]
        codes[i, :bc.size] = bc
        codes[i, int(i % bc.size)] = (i // 2) % 5
    rows = pack_rows(codes, lens, 150)
    got = packed_ops.demux_assign(rows, 150, lens, bc_codes, max_mismatch)
    want = ref_ops.demux_assign(rows, 150, lens, bc_codes, max_mismatch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    batch = ReadBatch(ids=[str(i) for i in range(len(lens))],
                      seqs=[codes[i, :n] for i, n in enumerate(lens)])
    parts = demux.demux_batch(batch, demux.DemuxConfig(
        tuple(map(tuple, barcodes)), max_mismatch))
    names = [n for n, _ in barcodes]
    for name, part in parts.items():
        want_bin = names.index(name) if name in names else -1
        assert all(got[0][int(i)] == want_bin for i in part.ids)


@pytest.mark.parametrize("units", [16, 32])
@pytest.mark.parametrize("s", [0, 1, 8, 15, 16, 17, 31, 32, 33, 70])
def test_shift_unit_stream_as_reference(units, s):
    words = np.random.default_rng(s).integers(
        0, 2**32, (9, 10), dtype=np.uint64).astype(np.uint32)
    for fill in (np.uint32(0), np.uint32(0xFFFFFFFF)):
        np.testing.assert_array_equal(
            packed_ops._shift_unit_stream(words, units, s, fill),
            ref_ops._shift_unit_stream(words, units, s, fill))


@pytest.mark.parametrize("L", [40, 150, 300])
def test_strip_rows_and_mask_tail_as_reference_and_per_read(L):
    """Stripping s bases then masking from the new length equals packing
    the read without its first s bases."""
    codes, lens, _, _ = _packed_world(L, L=L)
    rows = pack_rows(codes, lens, L)
    strip = np.random.default_rng(L).choice([0, 3, 8, 16, 33], len(lens))
    strip = np.minimum(strip, lens)
    got = packed_ops.strip_rows(rows, L, strip)
    np.testing.assert_array_equal(got, ref_ops.strip_rows(rows, L, strip))
    cut = np.maximum(lens - strip - 5, 0)
    masked = packed_ops.mask_tail(got.copy(), L, cut)
    np.testing.assert_array_equal(masked, ref_ops.mask_tail(got.copy(), L,
                                                            cut))
    shifted = np.full_like(codes, 4)
    for i, s in enumerate(strip):
        shifted[i, :L - s] = codes[i, s:]
    got_codes, got_bad = unpack_rows(masked, L)
    bad = (shifted > 3) | (np.arange(L)[None, :] >= cut[:, None])
    np.testing.assert_array_equal(got_bad, bad)
    np.testing.assert_array_equal(np.where(bad, 0, got_codes),
                                  np.where(bad, 0, shifted))


def unpack_rows(rows, L):
    """(codes, bad) [B, L] of wire rows."""
    w16, _ = packed_ops.wire_widths(L)
    pos = np.arange(L)
    codes = (rows[:, pos // 16] >> (2 * (pos % 16)).astype(np.uint32)) & 3
    bad = (rows[:, w16 + pos // 32] >> (pos % 32).astype(np.uint32)) & 1
    return codes.astype(np.uint8), bad.astype(bool)


# ------------------------------------------------------------ native reader
FASTQ = ("@r1/1 desc\nACGTNacgtu\n+\nIIII#####I\n@r2\nAC\n+\n#I\n"
         "@r3\n" + "G" * 40 + "\n+\n" + "5" * 40 + "\n")
FASTA = ">r1 x\nACGT\nNNac\n>r2\n\n>r3\n" + "T" * 40 + "\n"


@pytest.mark.parametrize("text,gz", [(FASTQ, False), (FASTQ, True),
                                     (FASTA, False), (FASTA, True)],
                         ids=["fastq", "fastq_gz", "fasta", "fasta_gz"])
@pytest.mark.parametrize("want_quals", [True, False])
@pytest.mark.parametrize("max_len", [4, 32, 64])
def test_reader_unpacked_and_qualities_as_reference(tmp_path, text, gz,
                                                     want_quals, max_len):
    path = str(tmp_path / ("r.fq.gz" if gz else "r.fq"))
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(text.encode())
    for method in ("next_batch_raw", "next_batch_packed"):
        ours = native.NativeFastxReader(path, 2, max_len, want_quals)
        ref = ref_native.NativeFastxReader(path, 2, max_len, want_quals)
        while True:
            got, want = (getattr(r, method)() for r in (ours, ref))
            if want is None:
                assert got is None
                break
            n = want[0]
            assert got[0] == n and got[1] == want[1]
            for a, b in zip(got[2:4], want[2:4]):
                np.testing.assert_array_equal(a[:n], b[:n])
            assert (got[4] is None) == (want[4] is None)
            if want[4] is not None:
                np.testing.assert_array_equal(got[4][:n], want[4][:n])
    ours = native.NativeFastxReader(path, 2, max_len, want_quals)
    ref = ref_native.NativeFastxReader(path, 2, max_len, want_quals)
    while True:
        got, want = ours.next_batch(), ref.next_batch()
        if want is None:
            assert got is None
            break
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mates", [None, "same", "short", "long"])
def test_read_batches_native_as_reference(tmp_path, mates):
    """ReadBatches of the port's native reader against the reference's, and
    the same errors on mate files of other lengths."""
    p1 = tmp_path / "a.fastq"
    p1.write_text(FASTQ * 3)
    p2 = None
    if mates:
        p2 = tmp_path / "b.fastq"
        p2.write_text({"same": FASTQ * 3, "short": FASTQ * 2,
                       "long": FASTQ * 4}[mates])
        p2 = str(p2)

    def collect(fn):
        try:
            return list(fn(str(p1), 4, 16, mate_path=p2, sample="s")), None
        except ValueError as e:
            return None, str(e)

    got, got_err = collect(native.read_batches_native)
    want, want_err = collect(ref_native.read_batches_native)
    assert got_err == want_err
    if want is not None:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_batch_equal(a, b)


def test_write_assignments_fsync_offsets(tmp_path):
    """do_fsync leaves the lines and the returned offset as they were."""
    from pangea_tpu_torch.utils import datagen
    tax = datagen.make_taxonomy(seed=0)
    blobs = native.TaxBlobs(tax)
    raw = b"".join(f"q{i}".encode().ljust(native.ID_STRIDE, b"\0")
                   for i in range(6))
    t = np.arange(6, dtype=np.int32) % (tax.num_taxa + 1)
    offs = [native.write_assignments_native(str(tmp_path / f"{s}.tsv"),
                                            False, raw, 6, t, t, t + 1,
                                            blobs, do_fsync=s)
            for s in (False, True)]
    assert offs[0] == offs[1] == os.path.getsize(tmp_path / "True.tsv")
    assert (tmp_path / "False.tsv").read_bytes() == \
        (tmp_path / "True.tsv").read_bytes()


# ------------------------------------------------------------------- CLI
CASES = {
    "trim": (["--reads", "c_1.fastq", "--samples", "s"],
             ["trim.min_qual=20", "trim.window=4", "trim.min_len=60"]),
    "max_len": (["--reads", "c_1.fastq"], ["trim.max_len=100"]),
    "demux": (["--reads", "c_1.fastq"], [DEMUX, "demux.max_mismatch=1"]),
    "trim_demux_pairs": (["--reads", "c_1.fastq", "--mates", "c_2.fastq"],
                         ["trim.min_qual=20", "trim.min_len=60",
                          "trim.max_len=110", DEMUX, "demux.max_mismatch=1"]),
    "fasta_demux_min_len": (["--reads", "c.fasta"],
                            ["trim.min_qual=20", "trim.min_len=100", DEMUX]),
    "two_files_trim": (["--reads", "c_1.fastq", "c.fasta"],
                       ["trim.min_qual=25", "trim.window=8",
                        "trim.min_len=40"]),
}


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
@pytest.mark.parametrize("case", list(CASES))
def test_cli_cohort_byte_identical_to_jax(cohort, tmp_path, monkeypatch,
                                          case, general):
    """Every output file, manifest.json included, byte for byte, and the
    run records' counts, on the fast path and on the general path."""
    d, _ = cohort
    reads, extra = CASES[case]
    args = ["classify", "--index", str(d / "idx"),
            *[str(d / a) if "." in a and "=" not in a else a for a in reads],
            "input.batch_size=64", "input.max_read_len=140",
            "classify.confidence_threshold=0.05", *extra]
    ref, out = run_both(args, tmp_path, monkeypatch, general)
    names = assert_same_outputs(ref, out)
    assert "manifest.json" in names
    ps = assert_same_records(ref, out)
    assert ps["fast_path"] is not general
    assert 0 < ps["reads_kept"] <= ps["reads_in"]
    if case == "demux" or case == "trim_demux_pairs":
        assert "undetermined.assign.tsv" in names
        assert "cohort.summary.tsv" in names


@pytest.mark.parametrize("no_native", [False, True],
                         ids=["native_reader", "python_reader"])
def test_cli_long_barcodes_take_general_path(cohort, tmp_path, monkeypatch,
                                             no_native):
    """Barcodes of 36 bases take the general path, read by the native
    reader (the Python reader under PANGEA_NO_NATIVE), trimmed and
    demultiplexed with one mismatch."""
    d, long_bcs = cohort
    args = ["classify", "--index", str(d / "idx"),
            "--reads", str(d / "l_1.fastq"), "input.batch_size=64",
            "input.max_read_len=180", "trim.min_qual=20", "trim.min_len=80",
            "demux.barcodes=" + json.dumps([["a", long_bcs[0]],
                                            ["b", long_bcs[1]]]),
            "demux.max_mismatch=1"]
    ref, out = run_both(args, tmp_path, monkeypatch, no_native)
    names = assert_same_outputs(ref, out)
    assert {"a.assign.tsv", "b.assign.tsv",
            "undetermined.assign.tsv"} <= set(names)
    ps = assert_same_records(ref, out)
    assert ps["fast_path"] is False


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_cli_config1_file(cohort, tmp_path, monkeypatch, general):
    """Config 1's file (its trim block, batch 4,096, L 256, mesh 1 x 1)."""
    d, _ = cohort
    args = ["classify", "--config",
            os.path.join(REPO, "configs", "config1_16s_mock.json"),
            "--index", str(d / "idx"), "--reads", str(d / "c_1.fastq"),
            "--samples", "mock"]
    ref, out = run_both(args, tmp_path, monkeypatch, general)
    assert "mock.assign.tsv" in assert_same_outputs(ref, out)
    assert_same_records(ref, out)


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
@pytest.mark.parametrize("min_qual,min_len,batch", [(30, 1000, 32),
                                                    (20, 110, 8)],
                         ids=["every_read_dropped", "some_batches_empty"])
def test_cli_empty_batches_launch_nothing(cohort, tmp_path, monkeypatch,
                                          general, min_qual, min_len, batch):
    """A batch (or a sample's part) that keeps no read launches nothing,
    and still writes its metrics line and its manifest record."""
    d, _ = cohort
    calls = []
    step = port_mesh.MeshStep.__call__

    def counted(self, bases, mate_bases=None, packed_len=0):
        assert bases.shape[0] > 0, "a launch of no rows"
        calls.append(bases.shape[0])
        return step(self, bases, mate_bases, packed_len)

    monkeypatch.setattr(port_mesh.MeshStep, "__call__", counted)
    args = ["classify", "--index", str(d / "idx"),
            "--reads", str(d / "c_1.fastq"), f"input.batch_size={batch}",
            "input.max_read_len=140", f"trim.min_qual={min_qual}",
            f"trim.min_len={min_len}", DEMUX]
    ref, out = run_both(args, tmp_path, monkeypatch, general)
    assert_same_outputs(ref, out)
    ps = assert_same_records(ref, out)
    assert len((out / "metrics.jsonl").read_text().splitlines()) == \
        -(-300 // batch)
    man = json.loads((out / "manifest.json").read_text())
    assert man["files"][str(d / "c_1.fastq")] == 300
    if min_len == 1000:
        assert ps["reads_kept"] == 0 and len(calls) == 1  # the warmup alone
    else:
        kept = [json.loads(x)["reads_kept"] for x in
                (out / "metrics.jsonl").read_text().splitlines()]
        assert 0 < ps["reads_kept"] < 300 and 0 in kept


def test_cohort_fastq_world_byte_identical_to_jax(tmp_path, monkeypatch):
    """bench.cohort_fastq (config 5's pooled cohort at a small size): fixed
    records, qualities falling toward the 3' end, the planted barcode
    errors; config 5's file with its trim and demux options, run by both
    CLIs on it, gives the same files, and trimmed, dropped, undetermined
    and every sample's reads each a share above 0."""
    from pangea_tpu.index import build_index
    from pangea_tpu.utils import datagen
    from pangea_tpu_torch.bench import cohort_barcodes, cohort_fastq
    tax = datagen.make_taxonomy(seed=5)
    genomes = datagen.make_genomes(tax, genome_len=4000, seed=6)
    build_index(genomes, tax, k=21).save(str(tmp_path / "idx"))
    path = str(tmp_path / "cohort.fastq")
    n = 3000
    barcodes = cohort_fastq(path, genomes, n, n_samples=4)
    assert barcodes == cohort_barcodes(4)
    lines = open(path).read().splitlines()
    assert len(lines) == 4 * n and len({len(x) for x in lines[1::4]}) == 1
    quals = np.array([np.frombuffer(q.encode(), np.uint8) - 33
                      for q in lines[3::4]])
    assert quals.min() >= 2 and quals.max() <= 41
    assert quals[:, :10].mean() > quals[:, -10:].mean() + 20
    heads = [s[:8] for s in lines[1::4]]
    dist = np.array([min(sum(a != b for a, b in zip(h, bc))
                         for bc in barcodes) for h in heads])
    planted = np.load(path + ".samples.npy")
    assert planted.shape == (n,) and set(planted) == {0, 1, 2, 3}
    assert 0.08 < (dist == 1).mean() < 0.13 and (dist >= 2).mean() > 0.02
    args = ["classify", "--config",
            os.path.join(REPO, "configs", "config5_cohort.json"),
            "--index", str(tmp_path / "idx"), "--reads", path,
            "input.batch_size=512", "trim.min_qual=20", "trim.window=4",
            "trim.min_len=60", "demux.max_mismatch=1", "demux.barcodes="
            + json.dumps([[f"sample{i}", bc]
                          for i, bc in enumerate(barcodes)])]
    ref, out = run_both(args, tmp_path)
    names = assert_same_outputs(ref, out)
    ps = assert_same_records(ref, out)
    assert {f"sample{i}.assign.tsv" for i in range(4)} | \
        {"undetermined.assign.tsv"} <= set(names)
    assert 0 < ps["reads_filtered"] < n
    trimmed = packed_ops.qtrim_cut(quals.astype(np.uint8),
                                   np.full(n, quals.shape[1]), 20, 4)
    assert 0 < (trimmed < quals.shape[1]).sum() < n
