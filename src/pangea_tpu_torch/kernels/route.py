"""The routing bin of the routed sharded step and its way back (B14).

Counterpart of the slot assignment and the un-route of
``pangea_tpu/dist/mesh.py`` ``_local_classify_routed`` (:410-430 and
:450-453). :func:`route_bin` (kernel K10, ``csrc/bucket_sort.cu``
``pangea_route_bin``) puts each probe of a rank's slice into an [S, C] slot
grid, S owner shards of C slots, at owner * C + its rank among its owner's
probes; the owner is the top log2 S bits of hash32. An invalid probe stays
home with a zero answer (the reference sends it to owner 0 as padding,
where it fills owner 0's bin: ROADMAP §C). The records (index, hi, lo,
valid) go to the owners by one all_to_all; the
owners' answers come back in slot order, and :func:`route_restore` (K9's
restore on routed records) puts them in probe order. K10 runs K9's tile
body (tiles of ``lookup.BIN_TILE`` probes): a tile ranks its probes by
owner in shared memory, claims each owner's run of slots with one global
atomic, and writes its records as runs; a tail launch zeroes each owner's
unused slots, so every slot is written once. Within an owner's run
K10's order is unspecified (each probe's answer depends on it alone); the
plain versions rank stably, as the reference's sort does.
"""
from __future__ import annotations

import torch

from . import _build
from .lookup import _hash32, widen


def owner_of(hi, lo, n_shards: int) -> torch.Tensor:
    """int64 [N] owner shard of each flattened probe: the top log2 n_shards
    bits of hash32."""
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    log2s = n_shards.bit_length() - 1
    if n_shards != 1 << log2s:
        raise ValueError(f"{n_shards} shards: not a power of two")
    if log2s == 0:
        return torch.zeros(hi.numel(), dtype=torch.int64, device=hi.device)
    return _hash32(widen(hi), widen(lo)) >> (32 - log2s)


def route_capacity(n_probes: int, n_shards: int,
                   cap_frac: float = 1.25) -> int:
    """Slots an owner's bin holds: ceil(N / S) * cap_frac, rounded half up
    (mesh.py:407-408)."""
    return int(-(-n_probes // n_shards) * cap_frac + 0.5)


def route_bin_plain(hi, lo, valid, n_shards: int, cap: int):
    """Plain version of K10: (records, inv, counts) for the flattened
    probes. records: int32 [S * cap, 4], at slot owner * cap + rank the
    record (index, hi, lo, valid) of the valid probe of that rank (a stable
    rank in probe order) among its owner's, zeros in unused slots; inv:
    int32 [N], each probe's slot, -1 for an invalid probe and past its
    owner's cap; counts: int32 [S], each owner's valid probes."""
    hi, lo, valid = (x.reshape(-1) for x in (hi, lo, valid))
    key = torch.where(valid, owner_of(hi, lo, n_shards), n_shards)
    n, dev = key.numel(), key.device
    so, perm = torch.sort(key, stable=True)
    start = torch.searchsorted(so, torch.arange(n_shards + 1, device=dev))
    rank = torch.arange(n, device=dev) - start[so]
    fits = (so < n_shards) & (rank < cap)
    slot = so * cap + rank
    records = torch.zeros((n_shards * cap, 4), dtype=torch.int32, device=dev)
    records[slot[fits]] = torch.stack(
        [perm.to(torch.int32), hi[perm], lo[perm],
         valid[perm].to(torch.int32)], dim=1)[fits]
    inv = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inv[perm[fits]] = slot[fits].to(torch.int32)
    counts = torch.bincount(key, minlength=n_shards + 1)[:n_shards]
    counts = counts.to(torch.int32)
    return records, inv, counts


def route_bin(hi, lo, valid, n_shards: int, cap: int):
    """The probes' routing bin, (records, inv, counts) as
    :func:`route_bin_plain` returns them: the plain version for CPU
    tensors, kernel K10 for CUDA tensors."""
    dev = _build.dispatch_device(hi, lo, valid)
    if dev is None:
        return route_bin_plain(hi, lo, valid, n_shards, cap)
    _build.check(hi, torch.int32, name="hi")
    _build.check(lo, torch.int32, shape=hi.shape, name="lo")
    _build.check(valid, torch.bool, shape=hi.shape, name="valid")
    log2s = n_shards.bit_length() - 1
    if n_shards != 1 << log2s or log2s > 12 or cap < 1:
        raise ValueError(f"route_bin: {n_shards} shards of {cap} slots")
    counts = torch.empty(n_shards, dtype=torch.int32, device=dev)
    records = torch.empty((n_shards * cap, 4), dtype=torch.int32, device=dev)
    inv = torch.empty(hi.numel(), dtype=torch.int32, device=dev)
    _build.launch("pangea_route_bin", dev, hi.data_ptr(), lo.data_ptr(),
                  valid.data_ptr(), hi.numel(), log2s, cap,
                  counts.data_ptr(), records.data_ptr(), inv.data_ptr())
    route_bin.launches += 1
    return records, inv, counts


route_bin.launches = 0


def route_restore_plain(inv, answers):
    """Plain version of the way back: (o0, o1, o2) int32 [N], lanes 0-2 of
    answers [M, 4] at each probe's slot inv[i], zeros where inv is -1."""
    rec = answers[inv.long().clamp(min=0)]
    rec = torch.where((inv >= 0)[:, None], rec, 0)
    return rec[:, 0], rec[:, 1], rec[:, 2]


def route_restore(inv, answers):
    """The owners' answers in probe order, as :func:`route_restore_plain`
    returns them: the plain version for CPU tensors, K9's restore
    (``csrc/bucket_sort.cu``) for CUDA tensors."""
    dev = _build.dispatch_device(inv, answers)
    if dev is None:
        return route_restore_plain(inv, answers)
    _build.check(inv, torch.int32, ndim=1, name="inv")
    _build.check(answers, torch.int32, ndim=2, name="answers")
    if answers.shape[1] != 4:
        raise ValueError(f"answers {tuple(answers.shape)} is not [M, 4]")
    outs = [torch.empty(inv.numel(), dtype=torch.int32, device=dev)
            for _ in range(3)]
    _build.launch("pangea_bucket_restore", dev, inv.data_ptr(),
                  answers.data_ptr(), inv.numel(),
                  *(o.data_ptr() for o in outs))
    route_restore.launches += 1
    return tuple(outs)


route_restore.launches = 0
