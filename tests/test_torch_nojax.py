"""The port stands alone: it imports neither jax nor the JAX package.

The GPU machine has no jax, and the port keeps its own copy of every piece
of the reference's host code it needs. No source of ``pangea_tpu_torch``
and not ``chip_smoke.py`` imports ``jax`` or any ``pangea_tpu`` module.
With both blocked, in a process of its own a step (each with its own time
limit, so that a slow one fails alone and names itself): every port module
and ``chip_smoke.py`` load; a tiny world built by the port alone
classifies on the CPU, against each index and through the multi-k step
over both, equal to the reference's golden model; run_classify_basic's
fast path (the port's native reader) and long-read path do too; the port's
own ``gen-testdata`` and ``build`` make an index that classifies through
the sorted deep-table lookup (its gate lowered) as golden does, and
``build --ooc-shards 2`` a sharded index that does on one device and
through the routed step of a 2-rank gloo world (a rank that fails ends its
peer at once and its output is shown); the port's own golden model loads
and equals the Classifier and the reference's golden.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

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
# Each step's subprocess gets this long; the ranks of the routed step
# RANK_TIMEOUT, and a rank that fails ends its peer at once.
STEP_TIMEOUT = 240
RANK_TIMEOUT = 150

# Every step starts here: jax and the JAX package blocked, the tiny world
# (taxonomy, genomes, pairs) and a work directory.
_PRELUDE = """
import json
import os
import sys
for name in ("jax", "jaxlib", "pangea_tpu"):
    sys.modules[name] = None       # `import <name>` now raises ImportError
import numpy as np
import torch
from pangea_tpu_torch.classify import (Classifier, DeviceIndex,
                                       MultiKClassifier, pad_batch)
from pangea_tpu_torch.index import build_index, load_index_any
from pangea_tpu_torch.utils import datagen
d = sys.argv[1]
out = []
tax = datagen.make_taxonomy(seed=1)
genomes = datagen.make_genomes(tax, genome_len=2000, seed=2)
rs = datagen.sample_reads(genomes, 40, read_len=100, paired=True, seed=3)
batch = [torch.from_numpy(pad_batch(s, 40, 100)) for s in (rs.seqs, rs.mates)]
single = datagen.sample_reads(genomes, 40, read_len=100, n_prob=0.005, seed=3)
cpu = torch.device("cpu")


def record(layout, res):
    out.append({"layout": layout,
                **{key: v.tolist() for key, v in res.items()}})


def gen_index(*extra):
    # gen-testdata's world (the genomes above) built by the port's CLI.
    from pangea_tpu_torch import cli
    g = os.path.join(d, "gen")
    if not os.path.exists(g):
        assert cli.main(["gen-testdata", "--out", g, "--reads", "40",
                         "--read-len", "100", "--genome-len", "2000",
                         "--seed", "1"]) == 0
    path = os.path.join(g, "idx" + "".join(extra).replace("-", ""))
    assert cli.main(["build", "--refs", os.path.join(g, "refs.fasta"),
                     "--taxonomy", os.path.join(g, "taxonomy.tsv"), "--k",
                     "21", *extra, "--out", path]) == 0
    return path
"""

_END = """
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v}
assert not loaded & {"jax", "jaxlib", "pangea_tpu"}, loaded
print("NOJAX " + json.dumps(out))
"""

STEPS = {
    # Every port module and chip_smoke load.
    "imports": """
import importlib
for name in sys.argv[2:]:
    importlib.import_module(name)
out.append({"layout": "imports", "n": len(sys.argv[2:])})
""",
    # The Classifier against each index, and the multi-k step over both.
    "classifier": """
dis = []
for k, w in json.loads(sys.argv[2]):
    dis.append(DeviceIndex.from_index(build_index(genomes, tax, k=k, w=w),
                                      cpu, 0.0))
    record(dis[-1].cfg.layout, Classifier(dis[-1])(*batch))
record("multi-k", MultiKClassifier(dis)(*batch))
""",
    # run_classify_basic: the pairs on the fast path (the native reader,
    # built with g++ at first use) and a 1 kb genome slice on the
    # long-read path.
    "run_classify": """
from pangea_tpu_torch.config import load_config
from pangea_tpu_torch.pipeline import run_classify_basic
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
    res = run_classify_basic(cfg, cpu)
    lines = open(os.path.join(d, name, "s.assign.tsv")).read().splitlines()
    out.append({"layout": name, "fast_path": res["fast_path"],
                "taxon": [int(x.split("\\t")[2]) for x in lines]})
""",
    # gen-testdata -> build -> the sorted lookup, the deep-table gate
    # lowered.
    "sorted": """
from pangea_tpu_torch.kernels import lookup as LK
LK._DEEP_ROWS = 1 << 9
LK._deep_chunk = lambda n, nb, rb=512, min_chunk=8192: (
    2048 if n > 2048 else None)
sorts = []
plain_sort = LK.bucket_sort_plain
LK.bucket_sort_plain = lambda *a: sorts.append(1) or plain_sort(*a)
di = DeviceIndex.from_index(load_index_any(gen_index()), cpu, 0.0)
res = Classifier(di)(torch.from_numpy(pad_batch(single.seqs, 40, 100)))
assert sorts == [1], sorts
record("sorted " + di.cfg.layout, res)
""",
    # build --ooc-shards 2 -> one device (the shards merged into one table).
    "sharded": """
sidx = load_index_any(gen_index("--ooc-shards", "2"))
di = DeviceIndex.from_index(sidx, cpu, 0.0)
record(f"{type(sidx).__name__} {di.cfg.layout}",
       Classifier(di)(torch.from_numpy(pad_batch(single.seqs, 40, 100))))
""",
    # The 2-shard index on a 2-rank gloo world (the streaming placement,
    # the routed step); a rank that fails ends the other at once, and its
    # stderr is printed.
    "routed": """
import subprocess
import time
sidx = gen_index("--ooc-shards", "2")
np.save(os.path.join(d, "single.npy"), pad_batch(single.seqs, 40, 100))
errs = [open(os.path.join(d, f"rank{r}.err"), "w") for r in range(2)]
procs = [subprocess.Popen([sys.executable, "-c", RANK, d, sidx, str(r)],
                          stdout=errs[r], stderr=subprocess.STDOUT)
         for r in range(2)]
t0 = time.time()
while True:
    codes = [p.poll() for p in procs]
    if codes == [0, 0]:
        break
    failed = any(c not in (None, 0) for c in codes)
    if failed or time.time() - t0 > RANK_TIMEOUT:
        for p in procs:
            p.kill()
            p.wait()
        for f in errs:
            f.close()
        logs = [open(f.name).read()[-3000:] for f in errs]
        raise SystemExit(f"ranks ended {codes} after "
                         f"{time.time() - t0:.1f} s (limit {RANK_TIMEOUT}):\\n"
                         + "\\n".join(f"--- rank {r}:\\n{log}"
                                      for r, log in enumerate(logs)))
    time.sleep(0.05)
for f in errs:
    f.close()
out.append(json.load(open(os.path.join(d, "routed.json"))))
""",
    # The port's golden model with jax blocked: the Classifier on the q8
    # and std worlds and the multi-k step equal it read by read.
    "golden": """
from pangea_tpu_torch.golden import (classify_reads_golden,
                                     merge_multik_golden)
dis, golds = [], []
for k, w in json.loads(sys.argv[2]):
    idx = build_index(genomes, tax, k=k, w=w)
    dis.append(DeviceIndex.from_index(idx, cpu, 0.0))
    golds.append(classify_reads_golden(rs.seqs, idx, 0.0, mates=rs.mates))
    got = Classifier(dis[-1])(*batch)
    out.append({"layout": "golden " + dis[-1].cfg.layout,
                "equal": [[int(got[key][i]) for key in ("taxon", "best",
                                                        "nvalid")]
                          == [g.taxon, g.best, g.nvalid]
                          for i, g in enumerate(golds[-1])],
                **{key: [getattr(g, key) for g in golds[-1]]
                   for key in ("taxon", "best", "nvalid")}})
merged = [merge_multik_golden(a, b, tax) for a, b in zip(*golds)]
got = MultiKClassifier(dis)(*batch)
out.append({"layout": "golden multi-k",
            "equal": [[int(got[key][i]) for key in ("taxon", "best", "nvalid")]
                      == [g.taxon, g.best, g.nvalid]
                      for i, g in enumerate(merged)],
            **{key: [getattr(g, key) for g in merged]
               for key in ("taxon", "best", "nvalid")}})
""",
}


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
d, sidx, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + d + "/store",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
mesh = M.Mesh(M.MeshConfig(1, 2), "cpu")
di = M.place_index(load_index_any(sidx), mesh, 0.0)
fn = M.make_sharded_classify_fn(di.cfg, mesh, routing="alltoall")
res = fn(di.tables, torch.from_numpy(np.load(os.path.join(d, "single.npy"))))
if rank == 0:
    json.dump({"layout": "routed " + di.cfg.layout,
               **{k: v.tolist() for k, v in res.items()}},
              open(os.path.join(d, "routed.json"), "w"))
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v}
assert not loaded & {"jax", "jaxlib", "pangea_tpu"}, loaded
dist.destroy_process_group()
"""


def _modules() -> list:
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    return modules + ["chip_smoke"]


def _run_step(step: str, work: Path) -> list:
    """The step's script in a process of its own, with jax and the JAX
    package blocked; its records. A step that fails or runs past
    STEP_TIMEOUT fails this case alone, with its stderr."""
    args = _modules() if step == "imports" else [json.dumps(WORLDS)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    script = (f"RANK = {_RANK!r}\nRANK_TIMEOUT = {RANK_TIMEOUT}\n"
              + _PRELUDE + STEPS[step] + _END)
    try:
        proc = subprocess.run([sys.executable, "-c", script, str(work),
                               *args], capture_output=True, text=True,
                              env=env, cwd=ROOT, timeout=STEP_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else e.stderr
        pytest.fail(f"step {step!r} ran past {STEP_TIMEOUT} s:\n"
                    f"{(err or '')[-3000:]}")
    assert proc.returncode == 0, f"step {step!r}:\n{proc.stderr[-4000:]}"
    line = [s for s in proc.stdout.splitlines() if s.startswith("NOJAX ")]
    return json.loads(line[-1][len("NOJAX "):])


def _world():
    tax = datagen.make_taxonomy(seed=1)
    genomes = datagen.make_genomes(tax, genome_len=2000, seed=2)
    rs = datagen.sample_reads(genomes, 40, read_len=100, paired=True, seed=3)
    return tax, genomes, rs


def _pair_golds():
    """The reference's golden calls of the pairs on each world, and merged."""
    tax, genomes, rs = _world()
    golds = [classify_reads_golden(rs.seqs, build_index(genomes, tax, k=k,
                                                        w=w),
                                   0.0, mates=rs.mates) for k, w in WORLDS]
    golds.append([merge_multik_golden(a, b, tax) for a, b in zip(*golds)])
    return golds


def _single_gold():
    tax, genomes, _ = _world()
    single = datagen.sample_reads(genomes, 40, read_len=100, n_prob=0.005,
                                  seed=3)
    return classify_reads_golden(single.seqs, build_index(genomes, tax,
                                                          k=21), 0.0)


def _check_golden(got: dict, gold: list, name: str) -> None:
    for key in ("taxon", "best", "nvalid"):
        assert got[key] == [getattr(x, key) for x in gold], (name, key)
    assert any(got["taxon"])


def _check_imports(got):
    assert got == [{"layout": "imports", "n": len(_modules())}]


def _check_classifier(got):
    assert [g["layout"] for g in got] == ["q8", "std", "multi-k"]
    for g, gold in zip(got, _pair_golds()):
        _check_golden(g, gold, g["layout"])


def _check_run_classify(got):
    assert [g["layout"] for g in got] == ["fast", "long"]
    assert got[0]["fast_path"] is True and got[1]["fast_path"] is False
    assert got[0]["taxon"] == [x.taxon for x in _pair_golds()[0]]
    tax, genomes, _ = _world()
    long = classify_read_golden(genomes[0][0][:1000], build_index(
        genomes, tax, k=21, w=8), 0.0)
    assert got[1]["taxon"] == [long.taxon] != [0]


def _check_single(layout):
    def check(got):
        assert [g["layout"] for g in got] == [layout]
        _check_golden(got[0], _single_gold(), layout)
    return check


def _check_port_golden(got):
    """The port's golden equals the Classifier (in the subprocess) and the
    reference's golden (here)."""
    assert [g["layout"] for g in got] == ["golden q8", "golden std",
                                          "golden multi-k"]
    for g, gold in zip(got, _pair_golds()):
        assert all(g["equal"]), g["layout"]
        _check_golden(g, gold, g["layout"])


CHECKS = {"imports": _check_imports, "classifier": _check_classifier,
          "run_classify": _check_run_classify,
          "sorted": _check_single("sorted q8"),
          "sharded": _check_single("ShardedIndex q8"),
          "routed": _check_single("routed q8"),
          "golden": _check_port_golden}


@pytest.mark.parametrize("step", list(STEPS))
def test_port_imports_and_classifies_without_jax(step, tmp_path):
    """Each step in a process of its own with jax and pangea_tpu blocked,
    its records held to the reference's golden model here."""
    CHECKS[step](_run_step(step, tmp_path))
