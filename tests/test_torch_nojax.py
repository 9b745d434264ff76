"""The port runs where jax is absent: the GPU machine has no jax.

Every module of ``pangea_tpu_torch``, ``chip_smoke.py`` and every
``pangea_tpu`` module they import must load with ``jax`` blocked, and a
tiny world must classify on the CPU there.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "pangea_tpu_torch"


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
    for path in _sources():
        bad = sorted(n for n in _imports(path)
                     if n == "jax" or n.startswith(("jax.", "jaxlib")))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_imports_only_torch_and_the_port():
    """chip_smoke.py reaches the reference package only through the port."""
    allowed = {"torch", "pangea_tpu_torch", "__future__"}
    for name in _imports(ROOT / "chip_smoke.py"):
        top = name.split(".")[0]
        assert top in allowed or top in sys.stdlib_module_names, name


_SCRIPT = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
import numpy as np
import torch
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu.index import build_index
from pangea_tpu.utils import datagen
from pangea_tpu_torch.classify import Classifier, DeviceIndex, pad_batch
tax = datagen.make_taxonomy(seed=1)
genomes = datagen.make_genomes(tax, genome_len=2000, seed=2)
idx = build_index(genomes, tax, k=21, w=8)
rs = datagen.sample_reads(genomes, 40, read_len=100, paired=True, seed=3)
model = Classifier(DeviceIndex.from_index(idx, torch.device("cpu"), 0.0))
out = model(torch.from_numpy(pad_batch(rs.seqs, 40, 100)),
            torch.from_numpy(pad_batch(rs.mates, 40, 100)))
gold = classify_reads_golden(rs.seqs, idx, 0.0, mates=rs.mates)
assert out["taxon"].tolist() == [g.taxon for g in gold]
assert out["best"].tolist() == [g.best for g in gold]
assert out["nvalid"].tolist() == [g.nvalid for g in gold]
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
print("NOJAX-OK")
"""


def test_port_imports_and_classifies_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    modules += sorted({n for p in _sources() for n in _imports(p)
                       if n.startswith("pangea_tpu.")})
    modules.append("chip_smoke")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, *modules],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout
