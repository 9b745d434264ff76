"""The port's fast path against the JAX package (CPU): packed wire rows
(B7), the native reader and writer, and the fast-path CLI.

Exact equality throughout: rows, ids and lines byte for byte, every output
an integer.
"""
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu import cli as ref_cli
from pangea_tpu.classify.engine import DeviceIndex as RefDeviceIndex
from pangea_tpu.classify.engine import make_classify_fn as ref_classify_fn
from pangea_tpu.index import build_index
from pangea_tpu.io.native import NativeFastxReader as RefReader
from pangea_tpu.kernels.encode import extract_kmers_packed_jnp
from pangea_tpu.kernels.encode import unpack_wire as ref_unpack_wire
from pangea_tpu.kernels.minimize import select_minimizers_jnp
from pangea_tpu.utils import datagen as ref_datagen
from pangea_tpu_torch import cli
from pangea_tpu_torch.classify import Classifier, DeviceIndex, pad_batch
from pangea_tpu_torch.io.native import (ID_STRIDE, NativeFastxReader,
                                        TaxBlobs, write_assignments_native)
from pangea_tpu_torch.kernels import (extract_kmers_packed,
                                      extract_probes_plain, unpack_wire,
                                      wire_width)
from pangea_tpu_torch.report.writers import (AssignmentRecord,
                                             format_assignment)
from pangea_tpu_torch.utils import datagen

from .helpers import small_world


def _pack(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The reader's wire rows of int8 [B, L] codes (pad = 4) whose reads
    have ``lens`` bases: 2-bit codes (pad as 0), bad flags set for every
    code > 3 and every position past the read."""
    B, L = codes.shape
    w16, w32 = (L + 15) // 16, (L + 31) // 32
    c2 = np.zeros((B, w16 * 16), np.uint64)
    c2[:, :L] = codes.astype(np.uint64) & 3
    shifts = np.uint64(2) * (np.arange(16, dtype=np.uint64))
    words = (c2.reshape(B, w16, 16) << shifts).sum(axis=2)
    bad = np.ones((B, w32 * 32), np.uint64)
    pos = np.arange(L)
    bad[:, :L] = (codes > 3) | (pos[None, :] >= lens[:, None])
    bwords = (bad.reshape(B, w32, 32) << np.arange(32, dtype=np.uint64)) \
        .sum(axis=2)
    return np.concatenate([words, bwords], axis=1).astype(np.uint32)


def _reads(B, L, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 2, L + 1, size=B)
    lens[0] = 0
    codes = np.full((B, L), 4, np.int8)
    for i, n in enumerate(lens):
        codes[i, :n] = rng.integers(0, 4, size=n)
    codes[rng.random((B, L)) < 0.03] = 4
    return codes, lens


@pytest.mark.parametrize("L", [150, 97])
def test_unpack_wire_matches_reference(L):
    codes, lens = _reads(40, L, seed=L)
    rows = _pack(codes, lens)
    c2, bad = unpack_wire(torch.from_numpy(rows.view(np.int32)), L)
    rc2, rbad = ref_unpack_wire(jnp.asarray(rows), L)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(rc2))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(rbad))
    assert wire_width(L) == rows.shape[1]


@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("k", [21, 31])
def test_packed_extraction_matches_reference(k, w):
    L = 150
    codes, lens = _reads(64, L, seed=k + w)
    rows = _pack(codes, lens)
    t_rows = torch.from_numpy(rows.view(np.int32))
    hi, lo, valid = extract_kmers_packed_jnp(jnp.asarray(rows), L, k)
    got = extract_kmers_packed(t_rows, L, k)
    for g, want in zip(got, (hi, lo, valid)):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(want).view(np.int32) if g.dtype ==
            torch.int32 else np.asarray(want))
    if w > 1:
        hi, lo, valid = select_minimizers_jnp(hi, lo, valid, w)
    NW = (L - k + 1) // w
    outs = []
    for src, packed_len in ((t_rows, L), (torch.from_numpy(codes), 0)):
        out = (torch.zeros((64, NW + 3), dtype=torch.int32),
               torch.zeros((64, NW + 3), dtype=torch.int32),
               torch.zeros((64, NW + 3), dtype=torch.bool))
        extract_probes_plain(src, k, w, out, 2, packed_len=packed_len)
        outs.append(out)
    for a, b, want in zip(*outs, (hi, lo, valid)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(
            a[:, 2:2 + NW].numpy(), np.asarray(want).view(np.int32)
            if a.dtype == torch.int32 else np.asarray(want))
    assert outs[0][2].any()


FASTQ = "".join(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n" for rid, seq in (
    ("r1 some comment",
     "ACGTNacgtuACGTACGTACGTAAAAACCCCCGGGGGTTTTTNNNNNACGTACGTAC"),
    ("r2/1", "TTTTGGGGCCCCAAAA"), ("r3\tx", "NNNN"),
    ("r4/2", "ACGTTGCA" * 6), ("r5", "ACGT")))[:-1]   # no final newline

FASTA = """>g1 desc words
ACGTACGTACGT
ACGTNNNN
ACGTACGTACGTACGTACGTACGTACGTACGT
>g2
tttt

>g3_final_no_newline
ACGTRYKMACGT"""


def _big_fastq(n):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        m = int(rng.integers(50, 400))
        seq = "".join("ACGTN"[c] for c in rng.integers(0, 5, size=m))
        recs.append(f"@read{i}\n{seq}\n+\n{'I' * m}\n")
    return "".join(recs)


@pytest.mark.parametrize("name,text,gz,max_len", [
    ("a.fastq", FASTQ, False, 40), ("a.fastq.gz", FASTQ, True, 40),
    ("a.fasta", FASTA, False, 30), ("a.fasta.gz", FASTA, True, 64),
    ("overlong.fastq", FASTQ, False, 4), ("big.fastq", None, False, 300),
], ids=["fastq", "fastq_gz", "fasta", "fasta_gz", "overlong", "big"])
def test_reader_byte_equal_to_reference(tmp_path, name, text, gz, max_len):
    """Every batch: the record count, the id buffer, the rows of the read
    records and the true lengths, on plain and gzipped FASTQ and
    multi-line FASTA, overlong reads and 5,000 records across the reader's
    1 MiB chunks."""
    data = (_big_fastq(5000) if text is None else text).encode()
    path = str(tmp_path / name)
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(data)
    B = 512 if text is None else 2
    ours = NativeFastxReader(path, B, max_len)
    ref = RefReader(path, B, max_len, want_quals=False)
    total = 0
    while True:
        got, want = ours.next_batch_packed(), ref.next_batch_packed()
        if want is None:
            assert got is None
            break
        n = want[0]
        assert got[0] == n and got[1] == want[1]
        np.testing.assert_array_equal(got[2][:n], want[2][:n])
        np.testing.assert_array_equal(got[3][:n], want[3][:n])
        total += n
    assert total == data.count(b"\n@" if b"@" in data[:1] else b"\n>") + 1


@pytest.mark.parametrize("text", ["@r1\nACGT\n+\nII\n", "@r1\nACGT\nII\n",
                                  "ACGT\n", "@r1\nACGT\n+\n"],
                         ids=["qual_length", "separator", "format",
                              "truncated"])
def test_reader_refuses_malformed_input_as_reference(tmp_path, text):
    path = str(tmp_path / "bad.fastq")
    open(path, "w").write(text)
    with pytest.raises(ValueError) as ours:
        NativeFastxReader(path, 4, 10).next_batch_packed()
    with pytest.raises(ValueError) as ref:
        RefReader(path, 4, 10, want_quals=False).next_batch_packed()
    assert str(ours.value) == str(ref.value)


def test_writer_byte_equal_to_format_assignment(tmp_path):
    tax = datagen.make_taxonomy(2, 8, 3, seed=0)
    rng = np.random.default_rng(1)
    n = 300
    ids = [f"read{i}" + ("/1", "/2", "", "/3")[i % 4] for i in range(n)]
    ids[5] = "x" * (ID_STRIDE - 1)
    raw = b"".join(i.encode().ljust(ID_STRIDE, b"\0") for i in ids)
    taxon = rng.integers(0, tax.num_taxa + 1, size=n).astype(np.int32)
    nvalid = rng.integers(0, 300, size=n).astype(np.int32)
    best = np.minimum(rng.integers(0, 300, size=n), nvalid).astype(np.int32)
    path = str(tmp_path / "a.tsv")
    blobs = TaxBlobs(tax)
    half = n // 2
    write_assignments_native(path, False, raw[:half * ID_STRIDE], half,
                             taxon[:half], best[:half], nvalid[:half], blobs)
    size = write_assignments_native(path, True, raw[half * ID_STRIDE:],
                                    n - half, taxon[half:], best[half:],
                                    nvalid[half:], blobs)
    want = "".join(format_assignment(AssignmentRecord(
        rid[:-2] if rid.endswith(("/1", "/2")) else rid, int(taxon[i]),
        int(best[i]), int(nvalid[i])), tax) for i, rid in enumerate(ids))
    assert open(path).read() == want
    assert size == len(want.encode())


@pytest.fixture(scope="module", params=[21, 31], ids=["q8", "std"])
def world(request):
    k = request.param
    return small_world(k=k, seed=9, genome_len=3000, n_reads=96,
                       read_len=120, paired=True, w=8)


def test_classifier_on_packed_rows_matches_codes_and_reference(world):
    """The Classifier on packed rows (the mates as column slices of one
    batch) equals its code input and the reference's make_classify_fn(cfg,
    paired=True, packed_len=L)."""
    _, _, idx, rs = world
    n, L = len(rs.seqs), 150
    codes = [pad_batch(s, n, L) for s in (rs.seqs, rs.mates)]
    lens = [np.fromiter(map(len, s), np.int64, n) for s in (rs.seqs,
                                                            rs.mates)]
    rows = [_pack(c, m) for c, m in zip(codes, lens)]
    combo = torch.from_numpy(np.concatenate(rows, axis=1).view(np.int32))
    stride = wire_width(L)
    model = Classifier(DeviceIndex.from_index(idx, "cpu", 0.05))
    got = model(combo[:, :stride], combo[:, stride:], packed_len=L)
    by_codes = model(*(torch.from_numpy(c) for c in codes))
    layout = model.cfg.layout
    ref = RefDeviceIndex.from_index(idx, confidence_threshold=0.05,
                                    layout=layout)
    want = ref_classify_fn(ref.cfg, paired=True, packed_len=L)(
        ref.tables, *(jnp.asarray(r) for r in rows))
    for key in ("taxon", "best", "nvalid"):
        assert torch.equal(got[key], by_codes[key])
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    assert (got["taxon"] != 0).any()


@pytest.fixture(scope="module")
def fastdata(tmp_path_factory):
    """A q8 (k=21, w=8), a std (k=31, w=8) and a k=31 (w=1) index on one
    world, and paired FASTQ files of 150 pairs of 120 bp and 30 of 200 bp
    (overlong at input.max_read_len=150)."""
    d = tmp_path_factory.mktemp("torch_fast")
    tax, genomes, idx, rs = small_world(k=21, seed=4, genome_len=3000,
                                        n_reads=150, read_len=120,
                                        paired=True, w=8)
    idx.save(str(d / "q8"))
    build_index(genomes, tax, k=31, w=8).save(str(d / "std"))
    build_index(genomes, tax, k=31).save(str(d / "k31"))
    long = ref_datagen.sample_reads(genomes, 30, read_len=200, paired=True,
                                    seed=8)
    reads = ref_datagen.ReadSet(
        ids=list(rs.ids) + [f"L{i}" for i in range(30)],
        seqs=list(rs.seqs) + list(long.seqs),
        mates=list(rs.mates) + list(long.mates),
        truth=np.concatenate([rs.truth, long.truth]))
    ref_datagen.write_fastq(str(d / "p_1.fastq"), reads, mate=1)
    ref_datagen.write_fastq(str(d / "p_2.fastq"), reads, mate=2)
    return d


@pytest.mark.parametrize("indexes,layouts", [
    (["q8"], ["q8"]), (["std"], ["std"]), (["q8", "k31"], ["q8", "std"]),
], ids=["q8", "std", "config4"])
def test_fast_path_cli_byte_identical_to_jax(fastdata, tmp_path, capsys,
                                             indexes, layouts):
    d = fastdata
    from pangea_tpu_torch.index import load_index_any, pick_layout
    for name, layout in zip(indexes, layouts):
        ix = load_index_any(str(d / name))
        assert pick_layout(ix.meta.n_kmers, 1, ix.meta.k,
                           int(ix.taxonomy.tout.max())) == layout
    args = ["classify", "--index", *[str(d / i) for i in indexes],
            "--reads", str(d / "p_1.fastq"), "--mates", str(d / "p_2.fastq"),
            "--samples", "s", "input.batch_size=64", "input.max_read_len=150",
            "mesh.n_data=1", "mesh.n_shard=1",
            "classify.confidence_threshold=0.05"]
    ref_out, out = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(args + ["--out", str(ref_out)]) == 0
    ref_summary = json.load(open(ref_out / "run_summary.json"))
    assert ref_summary["fast_path"] is True
    capsys.readouterr()
    assert cli.main(args + ["--out", str(out), "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert result["fast_path"] is True and result["batches"] == 3
    assert result["truncated_reads"] == ref_summary["truncated_reads"] == 60
    assert "truncated on the fast path" in captured.err
    for f in ("s.assign.tsv", "s.summary.tsv", "stats.json"):
        assert (out / f).read_bytes() == (ref_out / f).read_bytes(), f
    assert len((out / "s.assign.tsv").read_text().splitlines()) == 180
    assert os.path.exists(out / "run_config.json")


def test_fast_path_raises_reader_errors_in_the_caller(fastdata, tmp_path):
    """A mate file with fewer records, and a malformed record, fail the run
    with the reader's error, raised from the producer thread."""
    d = fastdata
    short = tmp_path / "short_2.fastq"
    short.write_text("".join(open(d / "p_2.fastq").readlines()[:40]))
    bad = tmp_path / "bad_1.fastq"
    bad.write_text(open(d / "p_1.fastq").read() + "@x\nACGT\n+\nII\n")
    for reads, mates, match in ((d / "p_1.fastq", short, "record count"),
                                (bad, None, "qual/seq length")):
        args = ["classify", "--index", str(d / "q8"), "--reads", str(reads),
                "--out", str(tmp_path / "out"), "--device", "cpu",
                "input.batch_size=64", "input.max_read_len=150"]
        if mates:
            args += ["--mates", str(mates)]
        with pytest.raises(ValueError, match=match):
            cli.main(args)
