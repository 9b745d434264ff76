"""CPU tests of the benchmark's harness: files found by name, the result
line, the check failing on a broken step, the index cache's key, the
frozen generators against the port's, and the imports."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench_testkit import BENCH, ROOT, load, run, save, tiny_checkout

FORBIDDEN = {"jax", "jaxlib", "flax", "pangea_tpu"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


def _top_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = "") -> list:
    out = []
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_jax_or_jax_package_imported():
    for path in _sources():
        bad = _top_imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    allowed = {"numpy", "__future__"} | set(sys.stdlib_module_names)
    for path in _sources("reference"):
        names = _top_imports(path)
        assert "pangea_tpu_torch" not in names, path
        assert names <= allowed, f"{path} imports {names - allowed}"


@pytest.mark.parametrize("cell", ["tiny_std.tiny_pe", "tiny_deep.tiny_se",
                                  "tiny_w8.tiny_se"])
def test_tiny_cells_correct(checkout, cell):
    result, lines = run(checkout, cell)
    assert result["correct"], lines
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "build_s", "limits"]
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["limits"]["wrong_answers"] == {"value": 0, "max": 0}
    assert result["limits"]["answers_judged"]["value"] > 0
    assert lines[-len(result["limits"]):] == [
        ln for ln in lines if ln.startswith("check: ")]
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(checkout):
    result, _ = run(checkout, "tiny_std.tiny_pe", trace=True)
    assert result["correct"]
    # Without a card, the event and profiler readings are not measured.
    assert set(result["metrics"]) == {"batch_p95_ms", "place_s",
                                      "enqueue_ms"}
    assert all(m["unit"] for m in result["metrics"].values())


def _half_batch(step):
    """Half of each batch left out: its answers stay zero."""
    def broken(bases, mates=None, packed_len=0):
        import torch
        n = bases.shape[0] // 2
        out = step(bases[:n], None if mates is None else mates[:n],
                   packed_len=packed_len)
        return {k: torch.cat([v, torch.zeros_like(v)[:bases.shape[0] - n]])
                for k, v in out.items()}
    return broken


def _altered(step):
    """An answer altered where it is produced: every 16th read's taxon."""
    def broken(bases, mates=None, packed_len=0):
        out = dict(step(bases, mates, packed_len=packed_len))
        taxon = out["taxon"].clone()
        taxon[::16] += 1
        out["taxon"] = taxon
        return out
    return broken


@pytest.mark.parametrize("fault", [_half_batch, _altered],
                         ids=["half_batch_left_out", "answer_altered"])
def test_broken_step_is_not_correct(checkout, fault):
    result, lines = run(checkout, "tiny_std.tiny_pe", step_filter=fault)
    assert not result["correct"]
    assert result["limits"]["wrong_answers"]["value"] > 0
    assert any(ln.startswith("check: wrong_answers") for ln in lines)


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmarks")
    cfg = load(os.path.join(bench, "configs", "tiny_deep.json"))
    cfg["world"]["genome_seed"] = 99
    save(os.path.join(bench, "configs", "later_cfg.json"), cfg)
    tr = load(os.path.join(bench, "traffic", "tiny_pe.json"))
    tr["batch"] = 48
    save(os.path.join(bench, "traffic", "later_mix.json"), tr)
    with open(os.path.join(bench, "metrics", "batches_done.py"), "w") as fh:
        fh.write("def read(run):\n"
                 "    return sum(b.t_done is not None"
                 " for b in run.window.batches)\n")
    doc = load(os.path.join(root, "BENCHMARK.json"))
    doc["configs"].append({"name": "later_cfg", "source": "a test",
                           "file": "benchmarks/configs/later_cfg.json",
                           "reduced": [], "why": "added as files"})
    doc["workloads"].append({"name": "later_cfg.later_mix",
                             "config": "later_cfg", "traffic": "later_mix",
                             "chips": 1, "why": "added as files"})
    doc["end_to_end"].append({"name": "batches_done", "unit": "batches",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["later_cfg.later_mix"]})
    save(os.path.join(root, "BENCHMARK.json"), doc)
    save(os.path.join(bench, "cells", "later_cfg.later_mix.json"),
         {"launches": ["extract_packed"]})
    from harness.spec import Spec
    assert Spec(root, bench).cell("later_cfg.later_mix", False).launches \
        == ["extract_packed"]
    result, _ = run(root, "later_cfg.later_mix")
    assert result["correct"]
    assert result["metrics"]["batches_done"]["value"] > 0
    assert result["attempted"] % 48 == 0
    other, _ = run(root, "tiny_std.tiny_pe")
    assert "batches_done" not in other["metrics"]


def test_index_cache_rebuilds_when_an_index_source_changes(tmp_path,
                                                         monkeypatch):
    from harness import sut
    port = tmp_path / "pangea_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "src", "pangea_tpu_torch"), port,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(sut, "_port_root", lambda: port)
    cfg = os.path.join(BENCH, "configs", "amplicon16s_std.json")
    key = sut.index_key(cfg, 0)
    assert sut.index_key(cfg, 0) == key
    with open(port / "kernels" / "score.py", "a") as fh:
        fh.write("\n# a kernel's change leaves the index alone\n")
    assert sut.index_key(cfg, 0) == key
    with open(port / "index" / "build.py", "a") as fh:
        fh.write("\n# a change to the build\n")
    assert sut.index_key(cfg, 0) != key


def test_index_and_reference_map_are_built_once(tmp_path):
    root = tiny_checkout(str(tmp_path))
    _, first = run(root, "tiny_deep.tiny_se")
    maps = os.path.join(root, "benchmarks", "cache", "reference")
    (kept,) = os.listdir(maps)
    stamp = os.stat(os.path.join(maps, kept)).st_mtime_ns
    _, second = run(root, "tiny_deep.tiny_se")
    assert any(ln.startswith("built index 0") for ln in first)
    assert not any(ln.startswith("built index 0") for ln in second)
    assert "index build 0.000 s" in next(ln for ln in second
                                         if ln.startswith("set-up"))
    assert os.listdir(maps) == [kept]
    assert os.stat(os.path.join(maps, kept)).st_mtime_ns == stamp


def test_placed_geometry_must_be_the_configurations(tmp_path):
    root = tiny_checkout(str(tmp_path))
    path = os.path.join(root, "benchmarks", "configs", "tiny_std.json")
    cfg = load(path)
    cfg["indexes"][0]["geometry"]["rows"] *= 2
    save(path, cfg)
    with pytest.raises(RuntimeError, match="placed as"):
        run(root, "tiny_std.tiny_pe")


@pytest.mark.parametrize("counts, ok", [
    ({"lookup_std": 8, "lca_lift": 9}, True),
    ({"lookup_std": 8, "lca_lift": 7}, False),
    ({"lookup_std": 8}, False),
], ids=["every_step", "one_step_short", "never_launched"])
def test_cell_kernels_launch_every_step(counts, ok):
    from harness import sut
    args = (["lookup_std", "lca_lift"], {"lookup_std": 2},
            {k: v + (2 if k == "lookup_std" else 0)
             for k, v in counts.items()}, 8)
    if ok:
        sut.check_launches(*args)
    else:
        with pytest.raises(RuntimeError, match="launched"):
            sut.check_launches(*args)


def test_cells_name_their_kernels():
    from pangea_tpu_torch.kernels import KERNELS
    doc = load(os.path.join(ROOT, "BENCHMARK.json"))
    for w in doc["workloads"]:
        names = load(os.path.join(BENCH, "cells", w["name"] + ".json"))[
            "launches"]
        assert names and set(names) <= set(KERNELS), w["name"]


def test_same_seed_same_inputs():
    from harness import worlds
    from harness.cell import draw_inputs
    cfg = load(os.path.join(BENCH, "configs", "shotgun_deep_q8.json"))
    cfg["world"]["genome_len"] = 3000
    world = worlds.make_world(cfg["world"])
    tr = dict(load(os.path.join(BENCH, "traffic", "pe150_b65536.json")),
              batch=32, pool=3)
    a, sa = draw_inputs(world, tr, 2**32 + 11)
    b, sb = draw_inputs(world, tr, 2**32 + 11)
    c, _ = draw_inputs(world, tr, 2**32 + 12)
    assert all((x[0] == y[0]).all() and (x[1] == y[1]).all()
               for x, y in zip(a, b))
    assert all((i == j).all() for i, j in zip(sa.idx, sb.idx))
    assert not (a[0][0] == c[0][0]).all()


def test_generators_match_the_ports(tmp_path):
    from harness import worlds
    from pangea_tpu_torch import bench
    from pangea_tpu_torch.utils import datagen
    cfg = load(os.path.join(BENCH, "configs", "amplicon16s_std.json"))
    spec = dict(cfg["world"], genome_len=2000)
    mine = worlds.make_world(spec)
    n = spec["n_genomes"]
    tax, genomes = bench._bench_genomes(n, 2000, 0, (512, 64))
    assert (mine.parent == tax.parent).all() and mine.names == tax.names
    assert (mine.rank == tax.rank).all()
    assert len(mine.genomes) == len(genomes) == n
    for (a, ta), (b, tb) in zip(mine.genomes, genomes):
        assert ta == tb and (a == b).all()
    deep = load(os.path.join(BENCH, "configs", "shotgun_deep_q8.json"))
    mine = worlds.make_world(dict(deep["world"], genome_len=3000))
    _, genomes = bench.deep_genomes(3000)
    assert [t for _, t in mine.genomes] == [t for _, t in genomes]
    assert all((a == b).all() for (a, _), (b, _) in zip(mine.genomes,
                                                         genomes))
    # The vectorised sampler draws what the port's bulk generator writes.
    tr = load(os.path.join(BENCH, "traffic", "pe150_b65536.json"))
    r1, r2, truth = worlds.sample_reads(
        genomes, 500, tr, np.random.default_rng(5))
    p1, p2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    want = datagen.generate_reads_fastq_bulk(
        p1, genomes, 500, read_len=150, paired=True, mate_path=p2,
        n_prob=tr["n_prob"], insert=tr["insert"], seed=5)
    lut = np.full(256, 9, np.uint8)
    lut[np.frombuffer(b"ACGTN", np.uint8)] = np.arange(5)
    for path, got in ((p1, r1), (p2, r2)):
        seqs = open(path, "rb").read().split(b"\n")[1::4]
        assert (lut[np.frombuffer(b"".join(seqs), np.uint8)].reshape(
            500, 150) == got).all()
    assert (truth == want).all()
    codes = r1[:40]
    for L in (150, 300):
        ref = bench.pack_wire(np.concatenate(
            [codes.astype(np.int8), np.full((40, L - 150), 4, np.int8)],
            axis=1))
        assert (worlds.pack_wire(codes, L) == ref.view(np.int32)).all()


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "amplicon16s_std.pe150_b65536", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
