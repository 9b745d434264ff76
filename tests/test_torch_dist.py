"""The port's sharded steps over torch.distributed against the JAX package's
on its 8 forced CPU devices (CPU).

One gloo world of 8 rank processes a mesh shape, each rank importing
neither jax nor ``pangea_tpu``, joined through a file store in tmp_path and
with a timeout of its own, so that a mismatched collective fails the test.
Every rank takes its data row's reads, and the outputs gather over the
data axis; rank 0 saves them. Inside one world run all its cases: the
broadcast step (q8, single-end and paired; std with the owner mask; q12),
the routed step (q8, std, q12; with a forced overflow at cap_frac 0.01),
and the multi-k sharded step. They must equal the reference's
``make_sharded_classify_fn`` and ``make_multik_sharded_classify_fn`` on a
mesh of the same shape, and the golden model, bit for bit. The routed
steps also report what each owner received: about 1.25 N/S records for a
row of N probes, since each sender routes only its own 1/S of the reads.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from pangea_tpu.classify.engine import pad_batch
from pangea_tpu.dist import (MeshConfig, choose_mesh, make_mesh,
                             make_sharded_classify_fn, place_index)
from pangea_tpu.dist.mesh import (batch_sharding,
                                  make_multik_sharded_classify_fn)
from pangea_tpu.golden import classify_reads_golden, merge_multik_golden
from pangea_tpu.index import build_index
from pangea_tpu.utils import datagen
from pangea_tpu_torch.dist import MeshConfig as PortMeshConfig
from pangea_tpu_torch.dist import choose_mesh as port_choose_mesh

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
N_READS, READ_LEN = 128, 120
N_PAIRS, PAIR_LEN = 64, 110
THR = 0.1

WORKER = r'''
import datetime, json, sys
for name in ("jax", "jaxlib", "pangea_tpu"):
    sys.modules[name] = None       # `import <name>` now raises ImportError
import functools
import numpy as np
import torch
import torch.distributed as dist
from pangea_tpu_torch.dist import mesh as M
from pangea_tpu_torch.index import load_index_any

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + spec["store"],
                        rank=rank, world_size=spec["world"],
                        timeout=datetime.timedelta(seconds=60))
mesh = M.Mesh(M.MeshConfig(*spec["shape"]), "cpu")
routed_steps, received = [0], []
a2a = dist.all_to_all_single
def counting_a2a(out, inp, group=None):
    received.append(int(out.shape[0]))       # records an owner receives
    return a2a(out, inp, group=group)
dist.all_to_all_single = counting_a2a
restore = M.route_restore
def counting_restore(*a):
    routed_steps[0] += 1
    return restore(*a)
M.route_restore = counting_restore
routed = M._local_classify_routed

placed = {}
def index(path, layout, thr):
    key = (path, layout, thr)
    if key not in placed:
        placed[key] = M.place_index(load_index_any(path), mesh, thr, layout)
    return placed[key]

def rows(x):
    b = x.shape[0] // mesh.cfg.n_data
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]

out = {}
for case in spec["cases"]:
    bases = torch.from_numpy(np.load(case["reads"]))
    mates = torch.from_numpy(np.load(case["mates"])) if case["mates"] \
        else None
    dis = [index(p, case["layout"], case["thr"]) for p in case["indexes"]]
    M._local_classify_routed = functools.partial(
        routed, cap_frac=case["cap_frac"])
    before = (routed_steps[0], len(received))
    if len(dis) > 1:
        fn = M.make_multik_sharded_classify_fn(
            [d.cfg for d in dis], mesh, paired=True, replicate_out=True)
        res = fn(tuple(d.tables for d in dis), rows(bases), None)
    else:
        fn = M.make_sharded_classify_fn(dis[0].cfg, mesh, paired=True,
                                        replicate_out=True,
                                        routing=case["routing"])
        res = fn(dis[0].tables, rows(bases),
                 None if mates is None else rows(mates))
    out[case["name"]] = {
        "outs": {k: v.tolist() for k, v in res.items()},
        "layout": dis[0].cfg.layout,
        "routed_steps": routed_steps[0] - before[0],
        "received": received[before[1]:]}
if rank == 0:
    json.dump(out, open(spec["out"], "w"))
dist.barrier()
dist.destroy_process_group()
'''


def run_world(tmp, shape, cases, timeout=180):
    """The cases in one gloo world of WORLD rank processes on a mesh of
    ``shape``; returns rank 0's results by case name."""
    tmp.mkdir(parents=True, exist_ok=True)
    spec = {"store": str(tmp / "store"), "world": WORLD, "shape": shape,
            "cases": cases, "out": str(tmp / "out.json")}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp / "spec.json"), str(r)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    return json.loads((tmp / "out.json").read_text())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The indexes (k=21 and k=31 on one taxonomy) and the batches, on
    disk for the ranks."""
    d = tmp_path_factory.mktemp("dist")
    tax = datagen.make_taxonomy(seed=0)
    genomes = datagen.make_genomes(tax, genome_len=3000, seed=1)
    idx = build_index(genomes, tax, k=21)
    idx31 = build_index(genomes, tax, k=31)
    idx.save(str(d / "idx21"))
    idx31.save(str(d / "idx31"))
    rs = datagen.sample_reads(genomes, N_READS, read_len=READ_LEN,
                              n_prob=0.02, seed=2)
    prs = datagen.sample_reads(genomes, N_PAIRS, read_len=PAIR_LEN,
                               paired=True, n_prob=0.02, seed=13)
    batches = {"b": pad_batch(rs.seqs, N_READS, READ_LEN),
               "p1": pad_batch(prs.seqs, N_PAIRS, PAIR_LEN),
               "p2": pad_batch(prs.mates, N_PAIRS, PAIR_LEN)}
    for name, arr in batches.items():
        np.save(d / f"{name}.npy", arr)
    return {"dir": d, "tax": tax, "idx": idx, "idx31": idx31, "rs": rs,
            "prs": prs, **batches}


def _cases(data, shape):
    d = data["dir"]

    def case(name, index=("idx21",), layout=None, routing="broadcast",
             reads="b", mates=None, thr=THR, cap_frac=1.25):
        return {"name": name, "indexes": [str(d / i) for i in index],
                "layout": layout, "routing": routing,
                "reads": str(d / f"{reads}.npy"),
                "mates": mates and str(d / f"{mates}.npy"), "thr": thr,
                "cap_frac": cap_frac}

    cases = [case("q8"), case("paired", reads="p1", mates="p2", thr=0.05),
             case("std", layout="std"),
             case("q12", index=("idx31",), layout="q12"),
             case("multik", index=("idx21", "idx31"))]
    if shape[1] > 1:
        cases += [case("q8_routed", routing="alltoall"),
                  case("q8_overflow", routing="alltoall", cap_frac=0.01),
                  case("std_routed", layout="std", routing="alltoall"),
                  case("q12_routed", index=("idx31",), layout="q12",
                       routing="alltoall"),
                  case("paired_routed", reads="p1", mates="p2", thr=0.05,
                       routing="alltoall")]
    return cases


def _reference(data, shape, name):
    """The JAX package's sharded step on a mesh of the same shape."""
    mesh = make_mesh(MeshConfig(*shape))
    sh = batch_sharding(mesh)
    layout = {"std": "std", "q12": "q12"}.get(name.split("_")[0])
    if layout:
        os.environ["PANGEA_LAYOUT"] = layout
    try:
        if name == "multik":
            dis = [place_index(ix, mesh, THR)
                   for ix in (data["idx"], data["idx31"])]
            fn = make_multik_sharded_classify_fn([d.cfg for d in dis], mesh)
            res = fn(tuple(d.tables for d in dis),
                     jax.device_put(data["b"], sh))
        else:
            ix = data["idx31"] if name.startswith("q12") else data["idx"]
            paired = name.startswith("paired")
            di = place_index(ix, mesh, 0.05 if paired else THR)
            routing = "alltoall" if name.endswith(("routed", "overflow")) \
                else "broadcast"
            fn = make_sharded_classify_fn(di.cfg, mesh, paired=paired,
                                          routing=routing)
            args = ((data["p1"], data["p2"]) if paired else (data["b"],))
            res = fn(di.tables, *(jax.device_put(a, sh) for a in args))
    finally:
        os.environ.pop("PANGEA_LAYOUT", None)
    return {k: np.asarray(v).tolist() for k, v in res.items()}


def _golden(data, name):
    if name.startswith("paired"):
        prs = data["prs"]
        return classify_reads_golden(prs.seqs, data["idx"], 0.05,
                                     mates=prs.mates)
    seqs = data["rs"].seqs
    if name == "multik":
        return [merge_multik_golden(a, b, data["tax"]) for a, b in zip(
            classify_reads_golden(seqs, data["idx"], THR),
            classify_reads_golden(seqs, data["idx31"], THR))]
    ix = data["idx31"] if name.startswith("q12") else data["idx"]
    return classify_reads_golden(seqs, ix, THR)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_steps_bit_identical(data, tmp_path, shape):
    cases = _cases(data, shape)
    got = run_world(tmp_path / "w", list(shape), cases)
    assert sorted(got) == sorted(c["name"] for c in cases)
    # The reference's step on this mesh for the headline q8 case and, at
    # (2, 4), for every case; the golden model for all.
    compare = [c["name"] for c in cases] if shape == (2, 4) else ["q8"]
    if shape[1] > 1 and shape != (2, 4):
        compare.append("q8_routed")
    for name in compare:
        assert got[name]["outs"] == _reference(data, shape, name), name
    for name, res in got.items():
        gold = _golden(data, name)
        for key in ("taxon", "best", "nvalid"):
            assert res["outs"][key] == [getattr(g, key) for g in gold], \
                (name, key)
        assert any(res["outs"]["taxon"]), name
    assert got["std"]["layout"] == "std" and got["q12"]["layout"] == "q12"
    assert got["q8"]["layout"] == "q8"
    if shape[1] == 1:
        return
    S = shape[1]
    for name in ("q8_routed", "std_routed", "q12_routed", "paired_routed"):
        res = got[name]
        assert res["routed_steps"] == 1, name       # no fallback needed
        # Rank 0's row holds B / n_data reads of R probes, N = B R / n_data;
        # each owner receives S bins of C = ceil(N / S^2) * 1.25 + 0.5
        # slots, once with the probes and once with the answers.
        B = N_PAIRS if name.startswith("paired") else N_READS
        k = 31 if name.startswith("q12") else 21
        L = PAIR_LEN if name.startswith("paired") else READ_LEN
        R = (L - k + 1) * (2 if name.startswith("paired") else 1)
        N = B // shape[0] * R
        C = int(-(-(N // S) // S) * 1.25 + 0.5)
        assert res["received"] == [S * C] * 2, (name, res["received"])
        assert S * C <= 1.25 * N / S + 2 * S < 1.25 * N
    assert got["q8_overflow"]["routed_steps"] == 0   # the broadcast branch


def test_choose_mesh_policy():
    """The port's placement policy is the reference's over a grid of world
    sizes, index sizes and budgets."""
    for n in (1, 2, 4, 8, 16):
        for index_bytes in (1 << 20, 3 << 30, 4 << 30, 100 << 30):
            for budget in (1 << 30, 12 << 30):
                want = choose_mesh(n, index_bytes, budget)
                got = port_choose_mesh(n, index_bytes, budget)
                assert got == PortMeshConfig(want.n_data, want.n_shard)
    assert port_choose_mesh(8, 4 << 30, 1 << 30) == PortMeshConfig(2, 4)
