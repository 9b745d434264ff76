"""The port stands alone: it imports neither jax nor the JAX package.

The GPU machine has no jax, and the port keeps its own copy of every piece
of the reference's host code it needs. No source of ``pangea_tpu_torch``
and not ``chip_smoke.py`` imports ``jax`` or any ``pangea_tpu`` module;
with both blocked, every port module and ``chip_smoke.py`` load and a tiny
world built by the port alone classifies on the CPU, against each index and
through the multi-k step over both, and through run_classify_basic's fast path
(the port's native reader) and long-read path, equal to the reference's
golden model; the port's own ``gen-testdata`` and ``build`` then make an
index that classifies through the sorted deep-table lookup (its gate
lowered) as golden does, and ``build --ooc-shards 2`` a sharded index that
classifies as golden does on one device and through the routed step of a
2-rank gloo world.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from pangea_tpu.golden import (classify_read_golden, classify_reads_golden,
                               merge_multik_golden)
from pangea_tpu.index import build_index
from pangea_tpu.utils import datagen

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "pangea_tpu_torch"
BLOCKED = ("jax", "jaxlib", "pangea_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> set:
    """Absolute module names a file imports (relative imports excluded)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_source_imports_jax():
    """Neither jax nor any module of the JAX package, by top-level name."""
    for path in _sources():
        bad = sorted(n for n in _imports(path)
                     if n.split(".")[0] in BLOCKED)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_imports_only_torch_and_the_port():
    allowed = {"torch", "pangea_tpu_torch", "__future__"}
    for name in _imports(ROOT / "chip_smoke.py"):
        top = name.split(".")[0]
        assert top in allowed or top in sys.stdlib_module_names, name


# (k, w) of the worlds: q8 at k=21, std (packed rows) at k=31.
WORLDS = ((21, 8), (31, 8))

_SCRIPT = """
import json
import sys
for name in ("jax", "jaxlib", "pangea_tpu"):
    sys.modules[name] = None       # `import <name>` now raises ImportError
import importlib
for name in sys.argv[2:]:
    importlib.import_module(name)
import torch
from pangea_tpu_torch.classify import (Classifier, DeviceIndex,
                                       MultiKClassifier, pad_batch)
from pangea_tpu_torch.index import build_index
from pangea_tpu_torch.utils import datagen
out = []
tax = datagen.make_taxonomy(seed=1)
genomes = datagen.make_genomes(tax, genome_len=2000, seed=2)
rs = datagen.sample_reads(genomes, 40, read_len=100, paired=True, seed=3)
batch = [torch.from_numpy(pad_batch(s, 40, 100)) for s in (rs.seqs, rs.mates)]
dis = []
for k, w in json.loads(sys.argv[1]):
    idx = build_index(genomes, tax, k=k, w=w)
    dis.append(DeviceIndex.from_index(idx, torch.device("cpu"), 0.0))
    res = Classifier(dis[-1])(*batch)
    out.append({"layout": dis[-1].cfg.layout,
                **{key: v.tolist() for key, v in res.items()}})
res = MultiKClassifier(dis)(*batch)
out.append({"layout": "multi-k",
            **{key: v.tolist() for key, v in res.items()}})
# run_classify_basic: the pairs on the fast path against the q8 index,
# and a 1 kb genome slice on the long-read path.
import os
import tempfile
from pangea_tpu_torch.config import load_config
from pangea_tpu_torch.pipeline import run_classify_basic
d = tempfile.mkdtemp()
build_index(genomes, tax, k=21, w=8).save(os.path.join(d, "idx"))
datagen.write_fastq(os.path.join(d, "r_1.fq"), rs, mate=1)
datagen.write_fastq(os.path.join(d, "r_2.fq"), rs, mate=2)
long = datagen.ReadSet(ids=["long0"], seqs=[genomes[0][0][:1000]],
                       mates=None, truth=rs.truth[:1])
datagen.write_fastq(os.path.join(d, "long.fq"), long, mate=1)
for name, reads, extra in (
        ("fast", ["r_1.fq", "r_2.fq"], []),
        ("long", ["long.fq"], ["input.long_reads=true"])):
    cfg = load_config(None, ["input.batch_size=16", "input.max_read_len=100",
                             *extra])
    cfg.classify.index = [os.path.join(d, "idx")]
    cfg.input.reads = [os.path.join(d, reads[0])]
    cfg.input.mates = [os.path.join(d, r) for r in reads[1:]]
    cfg.input.samples = ["s"]
    cfg.classify.out_dir = os.path.join(d, name)
    res = run_classify_basic(cfg, torch.device("cpu"))
    lines = open(os.path.join(d, name, "s.assign.tsv")).read().splitlines()
    out.append({"layout": name, "fast_path": res["fast_path"],
                "taxon": [int(x.split("\t")[2]) for x in lines]})
# gen-testdata -> build -> the sorted lookup, the deep-table gate lowered.
from pangea_tpu_torch import cli
from pangea_tpu_torch.index import load_index_any
from pangea_tpu_torch.kernels import lookup as LK
g = os.path.join(d, "gen")
assert cli.main(["gen-testdata", "--out", g, "--reads", "40", "--read-len",
                 "100", "--genome-len", "2000", "--seed", "1"]) == 0
assert cli.main(["build", "--refs", os.path.join(g, "refs.fasta"),
                 "--taxonomy", os.path.join(g, "taxonomy.tsv"), "--k", "21",
                 "--out", os.path.join(g, "idx")]) == 0
LK._DEEP_ROWS = 1 << 9
LK._deep_chunk = lambda n, nb, rb=512, min_chunk=8192: (
    2048 if n > 2048 else None)
sorts = []
plain_sort = LK.bucket_sort_plain
LK.bucket_sort_plain = lambda *a: sorts.append(1) or plain_sort(*a)
di = DeviceIndex.from_index(load_index_any(os.path.join(g, "idx")),
                            torch.device("cpu"), 0.0)
single = datagen.sample_reads(genomes, 40, read_len=100, n_prob=0.005, seed=3)
res = Classifier(di)(torch.from_numpy(pad_batch(single.seqs, 40, 100)))
assert sorts == [1], sorts
out.append({"layout": "sorted " + di.cfg.layout,
            **{key: v.tolist() for key, v in res.items()}})
LK._DEEP_ROWS = 1 << 17
# build --ooc-shards 2 -> one device (the shards merged into one table),
# and a 2-rank gloo world (the streaming placement, the routed step).
import subprocess
assert cli.main(["build", "--refs", os.path.join(g, "refs.fasta"),
                 "--taxonomy", os.path.join(g, "taxonomy.tsv"), "--k", "21",
                 "--ooc-shards", "2", "--out", os.path.join(g, "sidx")]) == 0
sidx = load_index_any(os.path.join(g, "sidx"))
di = DeviceIndex.from_index(sidx, torch.device("cpu"), 0.0)
res = Classifier(di)(torch.from_numpy(pad_batch(single.seqs, 40, 100)))
out.append({"layout": f"{type(sidx).__name__} {di.cfg.layout}",
            **{key: v.tolist() for key, v in res.items()}})
import numpy as np
np.save(os.path.join(g, "single.npy"), pad_batch(single.seqs, 40, 100))
procs = [subprocess.Popen([sys.executable, "-c", RANK, g, str(r)])
         for r in range(2)]
assert [p.wait(timeout=120) for p in procs] == [0, 0]
out.append(json.load(open(os.path.join(g, "routed.json"))))
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v}
assert not loaded & {"jax", "jaxlib", "pangea_tpu"}, loaded
print("NOJAX " + json.dumps(out))
"""


# One rank of a 2-rank gloo world: the routed step on the 2-shard index.
_RANK = """
import datetime, json, os, sys
for name in ("jax", "jaxlib", "pangea_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
import torch.distributed as dist
from pangea_tpu_torch.dist import mesh as M
from pangea_tpu_torch.index import load_index_any
g, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + g + "/store",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
mesh = M.Mesh(M.MeshConfig(1, 2), "cpu")
di = M.place_index(load_index_any(os.path.join(g, "sidx")), mesh, 0.0)
fn = M.make_sharded_classify_fn(di.cfg, mesh, routing="alltoall")
res = fn(di.tables, torch.from_numpy(np.load(os.path.join(g, "single.npy"))))
if rank == 0:
    json.dump({"layout": "routed " + di.cfg.layout,
               **{k: v.tolist() for k, v in res.items()}},
              open(os.path.join(g, "routed.json"), "w"))
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v}
assert not loaded & {"jax", "jaxlib", "pangea_tpu"}, loaded
dist.destroy_process_group()
"""


def test_port_imports_and_classifies_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    modules.append("chip_smoke")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", "RANK = " + repr(_RANK) + "\n" + _SCRIPT,
         json.dumps(WORLDS), *modules],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("NOJAX ")]
    got = json.loads(line[-1][len("NOJAX "):])
    assert [g["layout"] for g in got] == ["q8", "std", "multi-k", "fast",
                                          "long", "sorted q8",
                                          "ShardedIndex q8", "routed q8"]
    assert got[3]["fast_path"] is True and got[4]["fast_path"] is False
    tax = datagen.make_taxonomy(seed=1)
    genomes = datagen.make_genomes(tax, genome_len=2000, seed=2)
    rs = datagen.sample_reads(genomes, 40, read_len=100, paired=True, seed=3)
    golds = [classify_reads_golden(rs.seqs, build_index(genomes, tax, k=k,
                                                        w=w),
                                   0.0, mates=rs.mates) for k, w in WORLDS]
    golds.append([merge_multik_golden(a, b, tax) for a, b in zip(*golds)])
    for name, g, gold in zip(("k=21", "k=31", "multi-k"), got, golds):
        for key in ("taxon", "best", "nvalid"):
            assert g[key] == [getattr(x, key) for x in gold], (name, key)
        assert any(g["taxon"])
    assert got[3]["taxon"] == [x.taxon for x in golds[0]]
    long = classify_read_golden(genomes[0][0][:1000], build_index(
        genomes, tax, k=21, w=8), 0.0)
    assert got[4]["taxon"] == [long.taxon] != [0]
    single = datagen.sample_reads(genomes, 40, read_len=100, n_prob=0.005,
                                  seed=3)
    gold = classify_reads_golden(single.seqs, build_index(genomes, tax, k=21),
                                 0.0)
    for res in got[5:]:
        for key in ("taxon", "best", "nvalid"):
            assert res[key] == [getattr(x, key) for x in gold], \
                (res["layout"], key)
        assert any(res["taxon"])
