"""Run configuration: a dataclass tree loaded from JSON with dotted
``key.path=value`` overrides; every run dumps its resolved config next to
its outputs.

The port's copy of ``pangea_tpu/config.py``: the same fields, defaults and
JSON, so one config file drives either package.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class TrimCfg:
    min_qual: float = 0.0
    window: int = 4
    min_len: int = 0
    max_len: int = 0


@dataclass
class DemuxCfg:
    barcodes: list = field(default_factory=list)  # [[sample, barcode], ...]
    max_mismatch: int = 0


@dataclass
class InputCfg:
    reads: list = field(default_factory=list)        # mate-1 / single files
    mates: list = field(default_factory=list)        # mate-2 files (optional)
    samples: list = field(default_factory=list)      # per-file sample names
    batch_size: int = 4096
    max_read_len: int = 256
    long_reads: bool = False
    max_long_read_len: int = 16384


@dataclass
class ClassifyCfg:
    index: list = field(default_factory=list)  # 1 path, or 2+ for multi-k
    confidence_threshold: float = 0.0
    out_dir: str = "out"
    resume: bool = False
    warmup: bool = True


@dataclass
class MeshCfg:
    n_data: int = 0    # 0 = auto
    n_shard: int = 0   # 0 = auto placement policy
    per_device_hbm_budget_gb: float = 12.0
    routing: str = "broadcast"


@dataclass
class DistCfg:
    """Multi-process bring-up: the coordinator's address, the process
    count and this process's id (-1 = from the launcher)."""
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = -1


@dataclass
class RunConfig:
    input: InputCfg = field(default_factory=InputCfg)
    classify: ClassifyCfg = field(default_factory=ClassifyCfg)
    mesh: MeshCfg = field(default_factory=MeshCfg)
    trim: TrimCfg = field(default_factory=TrimCfg)
    demux: DemuxCfg = field(default_factory=DemuxCfg)
    dist: DistCfg = field(default_factory=DistCfg)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED:
            v = _from_dict(_NESTED[f.name], v)
        kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {"input": InputCfg, "classify": ClassifyCfg, "mesh": MeshCfg,
           "trim": TrimCfg, "demux": DemuxCfg, "dist": DistCfg}


def load_config(path: str | None = None, overrides=()) -> RunConfig:
    """Load RunConfig from a JSON file, then apply dotted overrides like
    ``classify.confidence_threshold=0.1`` (values parsed as JSON when
    possible, else kept as strings; lists accept JSON syntax)."""
    data = {}
    if path:
        with open(path) as fh:
            data = json.load(fh)
    cfg = _from_dict(RunConfig, data)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override {ov!r} must be key.path=value")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise ValueError(f"unknown config key {key!r}")
        setattr(obj, parts[-1], val)
    return cfg


def dump_config(cfg: RunConfig, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2, sort_keys=True)
