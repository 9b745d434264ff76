"""The system under test: the port's driver step on one rank.

Built as ``pangea_tpu_torch/pipeline/run.py`` ``_classify`` builds it: the
index loaded by ``load_index_any``, placed by ``place_index`` on a
one-rank ``Mesh(MeshConfig(1, 1), device)`` at the configuration's
confidence threshold, and driven through ``MeshStep(..., "broadcast")``
with packed wire rows (``packed_len`` = the traffic's ``max_read_len``).

Each index is built once by the port's own ``build_index`` (as ``cli
build`` does) and kept under ``cache/index/`` of the benchmark's folder,
named by a hash of the configuration file, the world generator and the
port's ``index/``, ``core/`` and ``taxonomy.py`` sources: a change to any
of them builds anew.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import time
from pathlib import Path

HARNESS = Path(__file__).resolve().parent


def _port_root() -> Path:
    import pangea_tpu_torch
    return Path(pangea_tpu_torch.__file__).resolve().parent


def index_key(config_path: str, position: int) -> str:
    """The hash that names index ``position`` of a configuration's
    cache entry."""
    h = hashlib.sha256(f"index {position}".encode())
    port = _port_root()
    files = [Path(config_path), HARNESS / "worlds.py", port / "taxonomy.py"]
    for sub in ("index", "core"):
        files += sorted((port / sub).glob("*.py"))
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def ensure_index(cache_root: str, config: dict, config_path: str,
                 position: int, world, log) -> tuple[str, float]:
    """The directory of index ``position`` of the configuration, built
    (and saved) when the cache lacks it. Returns (path, seconds spent
    building, 0 when cached)."""
    from pangea_tpu_torch.index import build_index
    from pangea_tpu_torch.taxonomy import Taxonomy
    spec = config["indexes"][position]
    path = os.path.join(cache_root, "index",
                        f"{config['name']}-{position}-"
                        f"{index_key(config_path, position)}")
    if os.path.exists(os.path.join(path, "meta.json")):
        return path, 0.0
    t = time.perf_counter()
    tax = Taxonomy(parent=world.parent, rank=world.rank, names=world.names)
    ix = build_index(world.genomes, tax, k=spec["k"], w=spec["w"],
                     ways=spec["ways"])
    part = path + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    ix.save(part)
    os.replace(part, path)
    dt = time.perf_counter() - t
    log(f"built index {position} of {config['name']} in {dt:.3f} s: {ix!r}")
    return path, dt


def open_step(paths: list, config: dict, device):
    """The step over the indexes at ``paths``: (MeshStep, the placed
    DeviceIndex list)."""
    from pangea_tpu_torch.dist.mesh import (Mesh, MeshConfig, MeshStep,
                                            place_index)
    from pangea_tpu_torch.index import load_index_any
    indexes = [load_index_any(p) for p in paths]
    mesh = Mesh(MeshConfig(1, 1), device)
    placed = [place_index(ix, mesh, config["confidence_threshold"])
              for ix in indexes]
    return MeshStep(placed, mesh, "broadcast"), placed


def check_geometry(placed: list, config: dict) -> None:
    """Raise unless each placed index has the layout, rows and row bytes
    that the configuration's ``indexes[i].geometry`` states, which the
    roofline counts."""
    for i, (ix, spec) in enumerate(zip(placed, config["indexes"])):
        want = spec["geometry"]
        got = {"layout": ix.cfg.layout, "rows": int(ix.fused.shape[0]),
               "row_bytes": int(ix.fused.shape[1]) * ix.fused.element_size()}
        if any(got[k] != want[k] for k in got):
            raise RuntimeError(
                f"index {i} of {config['name']} is placed as {got}; the "
                f"configuration states {want}")


def check_launches(expected: list, before: dict, after: dict,
                   steps: int) -> None:
    """Raise unless each kernel in ``expected`` launched at least once a
    step over ``steps`` steps (launch counts ``before`` and ``after``)."""
    short = {k: after.get(k, 0) - before.get(k, 0) for k in expected
             if after.get(k, 0) - before.get(k, 0) < steps}
    if short:
        raise RuntimeError(
            f"{steps} steps launched {short}: the cell's step no longer "
            f"runs the kernels its cells/<cell>.json names")


def launches() -> dict:
    """The port's kernel launch counts by kernel name."""
    from pangea_tpu_torch.kernels import kernel_launches
    return kernel_launches()
