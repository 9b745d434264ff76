"""An index laid out as its device table on the device itself.

:meth:`~.engine.DeviceIndex.from_index` places a whole index (one shard,
not streamed) on a CUDA device this way: :func:`upload` copies the stored
arrays (``key_hi``, ``key_lo``, ``val``, ``stash``) to the device as they
are, and :func:`relayout` lays them out there by the host relayout's rule:
``index/shard.py`` ``extract_pairs``, then ``index/build.py``
``layout_table`` (std) or ``index/quot.py`` ``q8_layout`` / ``q12_layout``,
then ``kernels/lookup.py`` ``fuse_table`` and ``fuse_stash``. The bucket
counts come from the host's own sizing functions (``_capacity_nb``,
``q8_nb_for``, ``q12_nb_for``). Every step is a torch operation on any
device, and the tables equal the host path's byte for byte
(``tests/test_torch_relayout.py`` holds them to it on CPU tensors).

Lanes follow ``kernels/lookup.py``'s rule: uint32 bit patterns in int32
tensors, widened to int64 where they are computed with.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..index.build import STASH_MAX
from ..index.quot import (_capacity_nb, _q12_row_lanes, q8_nb_for,
                          q8_rem_bits, q12_nb_for)
from ..kernels.lookup import M32, _hash32, _q8_hash, narrow, widen

EMPTY = -1                       # EMPTY_HI as an int32 bit pattern


def _upload(a, device) -> torch.Tensor:
    """A stored 32-bit array as an int32 tensor on ``device``; the pages of
    a mapped file are read here."""
    a = np.asarray(a)
    with warnings.catch_warnings():
        # A mapped index is read-only; the tensor is only read.
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a.reshape(-1).view(np.int32))
    return t.to(device).reshape(a.shape)


def upload(index, device) -> list:
    """The stored (key_hi, key_lo, val, stash) arrays of an index as int32
    tensors on ``device``: one tuple for a monolithic index, one a file
    shard for a sharded one."""
    parts = ([(index.key_hi, index.key_lo, index.val, index.stash)]
             if hasattr(index, "key_hi") else index.shards)
    return [tuple(_upload(a, device) for a in part) for part in parts]


def _pairs_of(part) -> list:
    """(canon int64, taxon int32) of one part's occupied slots, then of
    its stash's real columns."""
    khi, klo, val, st = part
    cols = [(khi.reshape(-1), klo.reshape(-1), val.reshape(-1))]
    if st.shape[1]:
        cols.append((st[0], st[1], st[2]))
    out = []
    for hi, lo, v in cols:
        occ = hi != EMPTY
        out.append(((hi[occ].to(torch.int64) << 32) | widen(lo[occ]),
                    v[occ]))
    return out


def extract_pairs(parts: list):
    """``extract_pairs``' rule on uploaded parts: (canon int64 [N]
    ascending, taxon int32 [N]) of the occupied slots and the stash's real
    columns. Empties ``parts``, releasing each part once it is read."""
    pairs = []
    while parts:
        pairs += _pairs_of(parts.pop(0))
    canon, order = torch.sort(torch.cat([c for c, _ in pairs]), stable=True)
    return canon, torch.cat([t for _, t in pairs])[order]


def _place(bucket: torch.Tensor, ways: int):
    """``_bucket_rank``'s rule: the keys (indices, in ascending canonical
    order) stable-sorted by bucket, ranked within their bucket. Returns
    (keys placed, their bucket, their rank, the overflow keys
    ascending)."""
    order = torch.sort(bucket, stable=True).indices
    bs = bucket[order]
    rank = (torch.arange(bs.numel(), device=bs.device)
            - torch.searchsorted(bs, bs))
    place = rank < ways
    return (order[place], bs[place], rank[place],
            torch.sort(order[~place]).values)


def _pk(tin, tout, v):
    """tin << 16 | tout of taxa v, as uint32 bit patterns."""
    return narrow((widen(tin[v]) << 16) | widen(tout[v]))


def _scatter(fused, rows, ranks, lanes):
    """Write each lane value of ``lanes`` ((first lane, values) pairs) at
    [row, first lane + rank]."""
    flat = fused.view(-1)
    at = rows * fused.shape[1] + ranks
    for first, values in lanes:
        flat[at + first] = values


def _stash(canon, taxa, over, tin, tout, width: int = 0):
    """``fuse_stash`` of the overflow keys ``over`` (ascending canonical):
    int32 [5, max(S, width)], padded with EMPTY_HI keys of taxon 0."""
    s = over.numel()
    st = torch.zeros((5, max(s, width)), dtype=torch.int32,
                     device=canon.device)
    st[0] = EMPTY
    st[0, :s] = narrow(canon[over] >> 32)
    st[1, :s] = narrow(canon[over])
    st[2, :s] = taxa[over]
    st[3] = tin[st[2].long()]
    st[4] = tout[st[2].long()]
    return st


def layout_std(canon, taxa, tin, tout, ways: int):
    """``layout_table`` at its load factor 0.5, then ``fuse_table`` and
    ``fuse_stash`` as ``_host_tables`` applies them: (fused int32
    [NB, 4W] packed or [NB, 6W] wide, stash int32 [5, max(S, 1)])."""
    dev = canon.device
    n = canon.numel()
    h = _hash32(canon >> 32, canon & M32)
    nb = _capacity_nb(n, ways, 0.5)
    while True:                     # SEMANTICS.md §5 step 3
        keys, rows, ranks, over = _place(h & (nb - 1), ways)
        if over.numel() <= STASH_MAX:
            break
        nb *= 2
    del h
    wide = int(tout.max()) > 0xFFFF
    W = ways
    fused = torch.zeros((nb, (6 if wide else 4) * W), dtype=torch.int32,
                        device=dev)
    fused[:, :W] = EMPTY
    if wide:
        fused[:, 3 * W:4 * W] = tin[0]
        fused[:, 4 * W:5 * W] = tout[0]
    else:
        fused[:, 3 * W:] = _pk(tin, tout, torch.zeros(1, dtype=torch.long,
                                                     device=dev))
    v = taxa[keys]
    key = canon[keys]
    lanes = [(0, narrow(key >> 32)), (W, narrow(key)), (2 * W, v)]
    lanes += ([(3 * W, tin[v.long()]), (4 * W, tout[v.long()])] if wide
              else [(3 * W, _pk(tin, tout, v.long()))])
    _scatter(fused, rows, ranks, lanes)
    return fused, _stash(canon, taxa, over, tin, tout, width=1)


def layout_quot(canon, taxa, tin, tout, k: int, layout: str, ways: int):
    """``q8_layout`` or ``q12_layout`` (``layout``) at their load factor 0.5
    and stash cap, then ``fuse_stash``: (fused int32 [NB, 2W] (q8) or
    [NB, 128] (q12), stash int32 [5, S], NB), or None where the host's layout is ineligible (q8: a remainder
    past 31 bits; Euler stamps past 16 bits)."""
    if int(tout.max()) > 0xFFFF:
        return None
    q8 = layout == "q8"
    n = canon.numel()
    nb = (q8_nb_for if q8 else q12_nb_for)(n, k, ways)
    if nb is None:
        return None
    h = _q8_hash(canon >> 32, canon & M32, k)
    while True:
        r = q8_rem_bits(k, nb)
        if q8 and r > 31:
            return None
        if r < 0:
            nb = 1 << (2 * k)       # more buckets than k-mer values: clamp
            r = 0
        keys, rows, ranks, over = _place(h >> r, ways)
        if over.numel() > STASH_MAX and r > 0:
            nb *= 2
            continue
        break
    W = ways
    lanes_n = 2 * W if q8 else _q12_row_lanes(W)
    fused = torch.zeros((nb, lanes_n), dtype=torch.int32, device=canon.device)
    fused[:, slice(0, W) if q8 else slice(W, 2 * W)] = EMPTY
    hk = h[keys]
    del h
    pk = _pk(tin, tout, taxa[keys].long())
    if q8:
        lanes = [(0, narrow(hk & ((1 << r) - 1))), (W, pk)]
    else:
        rem_hi = ((hk >> 32) & ((1 << (r - 32)) - 1) if r > 32
                  else torch.zeros_like(hk))
        lanes = [(0, narrow(hk & ((1 << min(r, 32)) - 1))),
                 (W, narrow(rem_hi)), (2 * W, pk)]
    _scatter(fused, rows, ranks, lanes)
    return fused, _stash(canon, taxa, over, tin, tout), nb


def relayout(parts: list, layout: str, k: int, ways: int, tin, tout):
    """The uploaded parts of a whole index laid out as its ``layout``
    table ("q8", "q12" or "std" at ``ways``) on their device: (fused int32,
    stash int32 [5, S]), equal to ``_host_tables``' arrays, or None where
    the quotient layout is ineligible. tin, tout: the taxonomy's int32
    Euler stamps on the same device. Empties ``parts``."""
    canon, taxa = extract_pairs(parts)
    if layout == "std":
        return layout_std(canon, taxa, tin, tout, ways)
    out = layout_quot(canon, taxa, tin, tout, k, layout, ways)
    return None if out is None else out[:2]
