"""The classify step: reads -> probes -> q8 lookup -> per-read score.

Counterpart of ``pangea_tpu/classify/engine.py`` for one device and the q8
layout. A batch is an int8 [B, L] code tensor (pad = 4); mates are
concatenated at the probe level, mate 1 first (SEMANTICS.md §8), and
``nvalid`` counts the valid windows over both mates. On CUDA tensors the
step is four kernel launches (K1 per mate, K2, K3); on CPU tensors it is
their plain versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..index.quot import Q8_WAYS, q8_gate, relayout_q8
from ..kernels.lookup import lookup_q8, lookup_q8_plain
from ..kernels.minimize import (extract_probes, extract_probes_plain,
                                probe_width)
from ..kernels.score import score_reads_tin, score_reads_tin_plain


@dataclass(frozen=True)
class ClassifyConfig:
    """Static classify parameters; the fields of the reference's
    ``ClassifyConfig``."""
    k: int
    n_shards: int = 1
    confidence_threshold: float = 0.0
    w: int = 1                      # minimizer window (SEMANTICS.md §3)
    ways: int = 16                  # bucket width
    n_sub: int = 1
    layout: str = "std"


@dataclass
class DeviceIndex:
    """One q8 index on one device: fused int32 [NB, 2W], stash int32
    [5, S] and the taxonomy's tin/tout/depth int32 [T+1]."""
    fused: torch.Tensor
    stash: torch.Tensor
    tax: dict
    cfg: ClassifyConfig

    @classmethod
    def from_index(cls, index, device, confidence_threshold: float = 0.0
                   ) -> "DeviceIndex":
        """Relay a host :class:`pangea_tpu.index.Index` out as the q8
        table and place it on ``device``."""
        tax = index.taxonomy
        q8_gate(index.meta.n_kmers, index.meta.k,
                int(tax.tout.max(initial=0)))
        out = relayout_q8(index, Q8_WAYS)
        if out is None:
            raise NotImplementedError(
                "the q8 relayout is ineligible for this index; the std and "
                "q12 layouts are not ported yet (ROADMAP B8/B9, B10)")
        fused, stash, _nb = out
        cfg = ClassifyConfig(k=index.meta.k,
                             confidence_threshold=confidence_threshold,
                             w=index.meta.w, ways=Q8_WAYS, layout="q8")
        tables = {"fused": fused, "stash": stash,
                  "tax": tax.device_arrays()}
        return cls.from_numpy_tables(tables, cfg, device)

    @classmethod
    def from_numpy_tables(cls, tables: dict, cfg, device) -> "DeviceIndex":
        """Carry the reference's host tables over: ``tables`` is
        ``pangea_tpu`` ``DeviceIndex.from_index(idx, layout="q8",
        device_put=False).tables`` (numpy: fused uint32 [1, NB, 2W], stash
        uint32 [1, 5, S], tax dict) and ``cfg`` its ``cfg``."""
        cfg = ClassifyConfig(**dataclasses.asdict(cfg))
        if cfg.layout != "q8" or cfg.n_shards != 1 or cfg.n_sub != 1:
            raise NotImplementedError(
                f"layout {cfg.layout!r} on {cfg.n_shards} shards x "
                f"{cfg.n_sub} sub-tables: the port runs one q8 table "
                "(ROADMAP B8-B10, A6)")

        def lanes(a, ndim):
            a = np.asarray(a)
            if a.ndim == ndim + 1:
                if a.shape[0] != 1:
                    raise NotImplementedError("sharded tables (ROADMAP A6)")
                a = a[0]
            return torch.from_numpy(
                np.ascontiguousarray(a).view(np.int32)).to(device)

        tax = {name: torch.from_numpy(np.ascontiguousarray(
                   tables["tax"][name], dtype=np.int32)).to(device)
               for name in ("tin", "tout", "depth")}
        return cls(fused=lanes(tables["fused"], 2),
                   stash=lanes(tables["stash"], 2), tax=tax, cfg=cfg)

    @property
    def tables(self) -> dict:
        return {"fused": self.fused, "stash": self.stash, "tax": self.tax}


def _extract_probes(bases, mate_bases, cfg: ClassifyConfig, plain: bool):
    """[B, L] codes (and mates) -> (hi int32, lo int32, valid bool) [B, R],
    mate 1's probes in the first columns."""
    parts = [bases] if mate_bases is None else [bases, mate_bases]
    widths = [probe_width(p.shape[1], cfg.k, cfg.w) for p in parts]
    B = bases.shape[0]
    R = sum(widths)
    hi = torch.empty((B, R), dtype=torch.int32, device=bases.device)
    lo = torch.empty_like(hi)
    valid = torch.empty((B, R), dtype=torch.bool, device=bases.device)
    fn = extract_probes_plain if plain else extract_probes
    col = 0
    for part, nw in zip(parts, widths):
        fn(part, cfg.k, cfg.w, (hi, lo, valid), col)
        col += nw
    return hi, lo, valid


def classify_reads(tables: dict, bases, cfg: ClassifyConfig, *,
                   mate_bases=None, plain: bool = False) -> dict:
    """The read -> assignment step. tables: :attr:`DeviceIndex.tables`.
    plain=True runs the plain PyTorch versions on any device (the
    reference the kernels are held to). Returns dict(taxon, best, nvalid)
    int32 [B]."""
    hi, lo, valid = _extract_probes(bases, mate_bases, cfg, plain)
    lookup = lookup_q8_plain if plain else lookup_q8
    hit, t_in, t_out = lookup(hi, lo, valid, tables["fused"],
                              tables["stash"], cfg.k)
    score = score_reads_tin_plain if plain else score_reads_tin
    tax = tables["tax"]
    taxon, best, nvalid = score(hit, t_in, t_out, valid, tax["tin"],
                                tax["tout"], tax["depth"],
                                cfg.confidence_threshold)
    return {"taxon": taxon, "best": best, "nvalid": nvalid}


class Classifier(nn.Module):
    """The classify step as a module over one :class:`DeviceIndex`; the
    tables are buffers, so they live on the index's device."""

    def __init__(self, index: DeviceIndex):
        super().__init__()
        self.cfg = index.cfg
        self.register_buffer("fused", index.fused, persistent=False)
        self.register_buffer("stash", index.stash, persistent=False)
        for name, t in index.tax.items():
            self.register_buffer(name, t, persistent=False)

    @property
    def index(self) -> DeviceIndex:
        """The index over the module's buffers, wherever they now live."""
        return DeviceIndex(fused=self.fused, stash=self.stash,
                           tax={name: getattr(self, name)
                                for name in ("tin", "tout", "depth")},
                           cfg=self.cfg)

    def forward(self, bases, mate_bases=None) -> dict:
        """bases (and mate_bases) int8 [B, L] codes on the index's device
        -> {"taxon", "best", "nvalid"} int32 [B]."""
        return classify_reads(self.index.tables, bases, self.cfg,
                              mate_bases=mate_bases)


def make_classify_fn(cfg: ClassifyConfig, paired: bool = False):
    """fn(tables, bases[, mate_bases]) -> dict(taxon, best, nvalid), with
    tables = :attr:`DeviceIndex.tables`."""

    def fn(tables, bases, mate_bases=None):
        return classify_reads(tables, bases, cfg, mate_bases=mate_bases)

    if paired:
        return fn
    return lambda tables, bases: fn(tables, bases)


def pad_batch(seqs, batch: int, length: int) -> np.ndarray:
    """Host-side: list of uint8 code arrays -> int8 [batch, length]
    (pad = 4). Reads longer than `length` are truncated."""
    out = np.full((batch, length), 4, dtype=np.int8)
    for i, s in enumerate(seqs[:batch]):
        n = min(len(s), length)
        out[i, :n] = s[:n].astype(np.int8)
    return out
