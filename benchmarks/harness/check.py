"""The check that decides ``correct``: the timed path's own answers
against the plain reference (``reference/``).

Before the window a sample of each pool batch's reads is drawn from the
seed (``check_reads`` in all, spread evenly over the batches). In the
drain thread every completed batch's answers at those reads (taxon, best,
nvalid) are kept, each distinct set of them once with the number of
batches that gave it, so that every answer sampled from every batch of
the window is judged without holding them all. Once the window has closed,
the reference works the k-mer-to-taxon map out from the genomes and
classifies the sampled reads; an answer that differs from it in any of
the three numbers is a wrong answer. The limit is 0: the semantics are
exact (docs/SEMANTICS.md). The reference keeps its map under the
benchmark's ``cache/reference/``, named by a hash of what it was made
from, so that only a checkout's first run builds it.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import time

import numpy as np

import reference
from reference import KmerMap, Tree, classify_reads

from .drive import OUT_KEYS

MAX_VARIANTS = 8              # distinct answer sets kept a batch
HARNESS = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.dirname(os.path.abspath(reference.__file__))


class Sampler:
    """The sampled reads of each pool batch, and the answers the window
    gave for them."""

    def __init__(self, sizes: list, check_reads: int, rng):
        per = max(check_reads // len(sizes), 1)
        self.idx = [np.sort(rng.choice(n, min(per, n), replace=False))
                    for n in sizes]
        self.variants: dict = {}      # slot -> [[answers [3, m], batches]]
        self.overflow = 0             # batches past MAX_VARIANTS sets

    def watch(self, slot: int, res: dict) -> None:
        got = np.stack([res[k][self.idx[slot]] for k in OUT_KEYS])
        seen = self.variants.setdefault(slot, [])
        for v in seen:
            if np.array_equal(v[0], got):
                v[1] += 1
                return
        if len(seen) < MAX_VARIANTS:
            seen.append([got, 1])
        else:
            self.overflow += 1


def reference_maps(world, config: dict, cache: str | None = None):
    """The reference's tree, its k-mer map an index, and each index's
    settings, worked out from the world. With ``cache``, a directory,
    each map is kept there, named by a hash of the world and index
    settings, the generator and the reference's sources, and read back by
    later runs."""
    tree = Tree(world.parent)
    specs = [{**ix, "confidence_threshold": config["confidence_threshold"]}
             for ix in config["indexes"]]
    maps = []
    for i, ix in enumerate(specs):
        path = None
        if cache is not None:
            path = os.path.join(cache, f"{config['name']}-{i}-"
                                f"{_map_key(config['world'], ix)}.npz")
            if os.path.exists(path):
                maps.append(KmerMap.load(path))
                continue
        kmap = KmerMap.build(world.genomes, tree, ix["k"], ix["w"])
        if path is not None:
            os.makedirs(cache, exist_ok=True)
            kmap.save(path)
        maps.append(kmap)
    return tree, maps, specs


def _map_key(world_spec: dict, ix: dict) -> str:
    h = hashlib.sha256(json.dumps([world_spec, ix["k"], ix["w"]],
                                  sort_keys=True).encode())
    files = [os.path.join(HARNESS, "worlds.py")] + sorted(
        glob.glob(os.path.join(REFERENCE, "*.py")))
    for f in files:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    return h.hexdigest()[:16]


def sampled_reads(pool_codes: list, sampler: Sampler, slots: list):
    """The sampled reads of those pool batches, in order, and their
    mates (or None)."""
    reads = np.concatenate([pool_codes[s][0][sampler.idx[s]]
                            for s in slots])
    mates = None
    if pool_codes[0][1] is not None:
        mates = np.concatenate([pool_codes[s][1][sampler.idx[s]]
                                for s in slots])
    return reads, mates


def judge(world, config: dict, pool_codes: list, sampler: Sampler,
          launched: int, drained: int, refs=None, cache: str | None = None):
    """The numbers compared, each with its limit, and the seconds the
    reference took. pool_codes: (codes, mate codes or None) a pool batch;
    refs: :func:`reference_maps`' result, made here (with ``cache``) when
    None."""
    t = time.perf_counter()
    slots = sorted(sampler.variants)
    wrong = compared = 0
    if slots:
        tree, maps, specs = refs or reference_maps(world, config, cache)
        want = np.stack(classify_reads(
            maps, *sampled_reads(pool_codes, sampler, slots), tree, specs))
        at = 0
        for s in slots:
            m = sampler.idx[s].size
            for got, batches in sampler.variants[s]:
                bad = (got != want[:, at:at + m]).any(axis=0)
                wrong += int(bad.sum()) * batches
                compared += m * batches
            at += m
    numbers = {"wrong_answers": {"value": wrong, "max": 0},
               "unjudged_batches": {"value": sampler.overflow, "max": 0},
               "missing_batches": {"value": launched - drained, "max": 0},
               "answers_judged": {"value": compared, "min": 1}}
    return numbers, time.perf_counter() - t


def passes(numbers: dict) -> bool:
    """Every number within its limit (``max`` or ``min``)."""
    return all(n["value"] <= n["max"] if "max" in n else
               n["value"] >= n["min"] for n in numbers.values())


def describe(numbers: dict) -> list:
    """One line a number, beside its limit."""
    return [f"check: {name} {n['value']} "
            + (f"(at most {n['max']})" if "max" in n
               else f"(at least {n['min']})")
            for name, n in numbers.items()]
