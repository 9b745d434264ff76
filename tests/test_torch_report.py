"""The port's report writers and ``report`` subcommand against the
reference's (CPU): reading assignment files back, the streaming taxon
counter, summaries and cohort tables from assigned taxa, and the CLI's
files byte for byte."""
import json
import os

import numpy as np
import pytest

from pangea_tpu import cli as ref_cli
from pangea_tpu.report import writers as ref_writers
from pangea_tpu.taxonomy import Taxonomy as RefTaxonomy
from pangea_tpu.utils import datagen as ref_datagen
from pangea_tpu_torch import cli
from pangea_tpu_torch.report import writers
from pangea_tpu_torch.taxonomy import Taxonomy

from .test_torch_cohort import DEMUX, make_cohort


def _taxonomies(seed, **kw):
    ref = ref_datagen.make_taxonomy(seed=seed, **kw)
    port = Taxonomy(parent=ref.parent, rank=ref.rank, names=list(ref.names))
    assert isinstance(ref, RefTaxonomy)
    return ref, port


@pytest.fixture(scope="module")
def cohort_run(tmp_path_factory):
    """A demultiplexed run of the JAX CLI: four assignment files."""
    d = tmp_path_factory.mktemp("torch_report")
    make_cohort(d)
    ref_datagen.write_taxonomy_tsv(
        str(d / "taxonomy.tsv"),
        RefTaxonomy.load(str(d / "idx" / "taxonomy.npz")))
    (d / "taxonomy.npz").write_bytes((d / "idx" / "taxonomy.npz")
                                     .read_bytes())
    out = d / "run"
    assert ref_cli.main([
        "classify", "--index", str(d / "idx"), "--reads",
        str(d / "c_1.fastq"), "--out", str(out), "input.batch_size=64",
        "input.max_read_len=140", "mesh.n_data=1", "mesh.n_shard=1",
        "trim.min_qual=20", "trim.min_len=60", DEMUX,
        "demux.max_mismatch=1"]) == 0
    return d, out


def _lines(rng, tax, n):
    """n assignment records of random taxa (every fifth unclassified) and
    random counts, and their taxa."""
    taxa = rng.integers(0, tax.num_taxa + 1, n)
    taxa[::5] = 0
    nvalid = rng.integers(0, 300, n)
    best = np.minimum(rng.integers(0, 300, n), nvalid)
    recs = [writers.AssignmentRecord(f"read{i}.x", int(t), int(b), int(v))
            for i, (t, b, v) in enumerate(zip(taxa, best, nvalid))]
    return recs, taxa


@pytest.mark.parametrize("n", [0, 1, 257, 5000])
def test_read_assignments_and_count_taxa_as_reference(tmp_path, n):
    """Both readers on the same file; count_taxa_tsv in chunks smaller than
    the file."""
    ref_tax, tax = _taxonomies(1)
    recs, taxa = _lines(np.random.default_rng(n), tax, n)
    path = tmp_path / "a.tsv"
    path.write_text("".join(writers.format_assignment(r, tax)
                            for r in recs))
    got, want = (m.read_assignments(str(path))
                 for m in (writers, ref_writers))
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert [r.taxon for r in got] == list(taxa)
    for chunk in (1, 7, 1 << 20):
        np.testing.assert_array_equal(
            writers.count_taxa_tsv(str(path), tax.num_taxa, chunk),
            ref_writers.count_taxa_tsv(str(path), ref_tax.num_taxa, chunk))


@pytest.mark.parametrize("seed,kw", [(0, {}), (3, {"n_phyla": 4,
                                                    "genera_per_phylum": 5,
                                                    "species_per_genus": 6})])
def test_summaries_and_cohort_as_reference(tmp_path, seed, kw):
    """summarize, write_summary, merge_cohort and write_cohort_summary (in
    insertion order and in a given order) from assigned taxa."""
    ref_tax, tax = _taxonomies(seed, **kw)
    rng = np.random.default_rng(seed)
    sample_taxa = {name: rng.integers(0, tax.num_taxa + 1, size)
                   for name, size in (("z", 40), ("a", 0), ("m", 900))}
    for name, taxa in sample_taxa.items():
        for a, b in zip(writers.summarize(taxa, tax),
                        ref_writers.summarize(taxa, ref_tax)):
            np.testing.assert_array_equal(a, b)
        writers.write_summary(str(tmp_path / f"p_{name}.tsv"), taxa, tax)
        ref_writers.write_summary(str(tmp_path / f"r_{name}.tsv"), taxa,
                                  ref_tax)
        assert (tmp_path / f"p_{name}.tsv").read_bytes() == \
            (tmp_path / f"r_{name}.tsv").read_bytes()
    got = writers.merge_cohort(sample_taxa, tax)
    want = ref_writers.merge_cohort(sample_taxa, ref_tax)
    assert list(got) == list(want)
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)
    for order in (None, ["m", "z", "a"]):
        writers.write_cohort_summary(str(tmp_path / "p.tsv"), sample_taxa,
                                     tax, sample_order=order)
        ref_writers.write_cohort_summary(str(tmp_path / "r.tsv"),
                                         sample_taxa, ref_tax,
                                         sample_order=order)
        assert (tmp_path / "p.tsv").read_bytes() == \
            (tmp_path / "r.tsv").read_bytes()


@pytest.mark.parametrize("files,samples,taxonomy", [
    (["s0"], None, "taxonomy.npz"),
    (["s0", "undetermined", "s2", "s1"], None, "taxonomy.npz"),
    (["s1", "s0"], ["beta", "alpha"], "taxonomy.npz"),
    (["s2", "s2"], None, "taxonomy.npz"),
    (["s1", "s2"], None, "taxonomy.tsv"),
], ids=["one", "four_default_names", "named", "same_basename", "tsv"])
def test_report_cli_byte_identical_to_jax(cohort_run, tmp_path, files,
                                          samples, taxonomy):
    d, run = cohort_run
    args = ["report", "--assignments",
            *[str(run / f"{f}.assign.tsv") for f in files],
            "--taxonomy", str(d / taxonomy)]
    if samples:
        args += ["--samples", *samples]
    assert ref_cli.main(args + ["--out-dir", str(tmp_path / "ref")]) == 0
    assert cli.main(args + ["--out-dir", str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "stats.json" in names
    assert ("cohort.summary.tsv" in names) is (len(files) > 1)
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f


def test_report_gives_back_a_runs_summaries(cohort_run, tmp_path):
    """report on a run's own assignment files (sorted, as the run sorts its
    samples) writes the run's summaries, cohort table and stats.json."""
    d, run = cohort_run
    files = sorted(f for f in os.listdir(run) if f.endswith(".assign.tsv"))
    samples = [f.removesuffix(".assign.tsv") for f in files]
    assert cli.main(["report", "--assignments",
                     *[str(run / f) for f in files], "--samples", *samples,
                     "--taxonomy", str(d / "idx" / "taxonomy.npz"),
                     "--out-dir", str(tmp_path / "rep")]) == 0
    for f in os.listdir(tmp_path / "rep"):
        assert (tmp_path / "rep" / f).read_bytes() == \
            (run / f).read_bytes(), f
    assert set(json.loads((tmp_path / "rep" / "stats.json").read_text())) \
        == set(samples)
