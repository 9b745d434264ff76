"""K9 and K10 (``csrc/bucket_sort.cu``): K9's scratch, their edge
cases and the places their tile body computes, on the CPU.

``kernels/lookup.py`` ``k9_scratch`` is pure Python: K9's scratch holds
a row of key counts for each tile the kernel launches and the keys'
totals, with ``BIN_TILE`` the C source's tile (``kThreads`` x
``kItems``). The edge cases of ``bench.k9_edge_world`` go through the
plain versions and are held to the reference's sort on the same keys
(``jax.lax.sort`` of the keys the reference's ``q8_hash_np`` and
``bucket_of_np`` give, with the carried index, as ``_sorted_apply`` sorts)
and to the reference's routing (``_local_classify_routed``'s owner rule,
sort and slots). The places the kernels write are emulated in numpy, pass
by pass and tile by tile, with the ranks within a tile in an arbitrary
order, as the kernels' atomics give them. Outputs are integers: the
tolerance is exact equality throughout.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.index.build import bucket_of_np
from pangea_tpu.kernels.lookup import hash32_jnp, q8_hash_np, q8_rem_bits
from pangea_tpu_torch.bench import K9_EDGE, k9_edge_world
from pangea_tpu_torch.kernels import _build
from pangea_tpu_torch.kernels import (bucket_sort, bucket_sort_plain,
                                      route_bin, route_bin_plain)
from pangea_tpu_torch.kernels.lookup import (BIN_TILE, KEY_BITS,
                                             bucket_keys, k9_scratch,
                                             key_shift)
from pangea_tpu_torch.kernels.route import owner_of, route_capacity

SMEM_SM = 227 * 1024          # an H100's shared memory a block can opt into
SORTS = [n for n, spec in K9_EDGE.items() if spec[1] == "sort"]
ROUTES = [n for n, spec in K9_EDGE.items() if spec[1] == "route"]


def _constant(name: str) -> int:
    src = (_build.CSRC / "bucket_sort.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("n_keys", [1, 4, 512, 1024, 4096])
@pytest.mark.parametrize("n", [0, 1, 33, BIN_TILE - 1, BIN_TILE,
                               BIN_TILE + 1, 2_129_920, 8_519_680,
                               2**31 - 1])
def test_k9_scratch_covers_every_tile(n, n_keys):
    """The scratch holds the rows of the tiles the C launcher runs
    (blocks_for(N, kThreads * kItems)) and the totals after them, and no
    more."""
    tile = _constant("kThreads") * _constant("kItems")
    tiles = -(-n // tile)
    assert tiles * tile >= n > (tiles - 1) * tile
    assert k9_scratch(n, n_keys) == (tiles + 1) * n_keys
    assert tiles < 2**31                 # a grid's x dimension


def test_bin_tile_is_the_kernels_tile():
    """BIN_TILE is the C source's tile, and a scatter block's shared
    memory (hi, lo and a slot, 4 bytes each, a probe; two ints a key)
    lets two blocks share an SM at the wrapper's 2^KEY_BITS keys and one
    fit at the 2^kMaxKeyBits keys the launchers take."""
    assert BIN_TILE == _constant("kThreads") * _constant("kItems")
    assert _constant("kThreads") % 32 == 0
    assert BIN_TILE <= 1 << _constant("kLocalBits")
    assert 2 * (12 * BIN_TILE + 8 * (1 << KEY_BITS)) <= SMEM_SM
    assert 12 * BIN_TILE + 8 * (1 << _constant("kMaxKeyBits")) <= SMEM_SM


def _torch_probes(w):
    return (torch.from_numpy(w["hi"].view(np.int32)),
            torch.from_numpy(w["lo"].view(np.int32)),
            torch.from_numpy(w["valid"]))


def _reference_keys(w) -> np.ndarray:
    """The reference's bucket of each valid probe (q8_hash_np >> r, or
    bucket_of_np for the std rule) >> key_shift, and i mod the key count
    for invalid probe i."""
    nb, k = w["nb"], w["k"]
    kmers = (w["hi"].astype(np.uint64) << np.uint64(32)) | w["lo"]
    if k is None:
        bucket = bucket_of_np(kmers, nb)
    else:
        bucket = (q8_hash_np(kmers, k) >> np.uint64(q8_rem_bits(k, nb))
                  ).astype(np.int64)
    shift = key_shift(nb)
    spread = np.arange(kmers.size) & ((nb >> shift) - 1)
    return np.where(w["valid"], bucket >> shift, spread).astype(np.int64)


@pytest.mark.parametrize("name", SORTS)
def test_k9_edge_world_plain_is_the_reference_sort(name):
    """The plain K9 on each edge case: its keys are the reference's, its
    order is jax.lax.sort's of (key, index) (stable), its records carry
    each probe's lanes and inv is the inverse; the wrapper takes it on CPU
    tensors."""
    w = k9_edge_world(name)
    hi, lo, valid = _torch_probes(w)
    keys = _reference_keys(w)
    np.testing.assert_array_equal(
        bucket_keys(hi, lo, valid, w["nb"], w["k"]).numpy(), keys)
    n = keys.size
    _, order = jax.lax.sort((jnp.asarray(keys, jnp.int32),
                             jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    records, inv = bucket_sort_plain(hi, lo, valid, w["nb"], w["k"])
    np.testing.assert_array_equal(records[:, 0].numpy(), np.asarray(order))
    perm = records[:, 0].long()
    for j, lanes in enumerate((hi, lo, valid.to(torch.int32)), 1):
        assert torch.equal(records[:, j], lanes[perm])
    assert torch.equal(inv[perm], torch.arange(n, dtype=torch.int32))
    for a, b in zip(bucket_sort(hi, lo, valid, w["nb"], w["k"]),
                    (records, inv)):
        assert torch.equal(a, b)


def _reference_route(w, S: int, C: int):
    """Lines 410-430 of the reference's ``_local_classify_routed`` on the
    valid probes: each one's owner, and its slot (owner * C + its stable
    rank among its owner's probes) or -1 past C."""
    v = w["valid"]
    hi, lo = jnp.asarray(w["hi"][v]), jnp.asarray(w["lo"][v])
    n = int(v.sum())
    log2s = S.bit_length() - 1
    owner = (jnp.zeros(n, jnp.int32) if log2s == 0 else
             (hash32_jnp(hi, lo) >> jnp.uint32(32 - log2s)).astype(jnp.int32))
    idx = jnp.arange(n, dtype=jnp.int32)
    so, sidx = jax.lax.sort((owner, idx), num_keys=1)
    start = jnp.searchsorted(so, jnp.arange(S, dtype=jnp.int32), side="left")
    rank = np.empty(n, np.int64)
    rank[np.asarray(sidx)] = np.asarray(idx - start[so])
    owner = np.asarray(owner).astype(np.int64)
    return owner, np.where(rank < C, owner * C + rank, -1)


@pytest.mark.parametrize("name", ROUTES)
def test_k10_edge_world_plain_is_the_reference_routing(name):
    """The plain K10 on each edge case: the reference's per-owner counts
    and slots for the valid probes, -1 for the invalid ones, each used
    slot the record (index, hi, lo, 1) of its probe and zeros in every
    other; the wrapper takes it on CPU tensors."""
    w = k9_edge_world(name)
    hi, lo, valid = _torch_probes(w)
    S = w["n_shards"]
    C = w["cap"] or route_capacity(hi.numel(), S)
    records, inv, counts = route_bin_plain(hi, lo, valid, S, C)
    owner, slots = _reference_route(w, S, C)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(owner, minlength=S))
    v = w["valid"]
    np.testing.assert_array_equal(inv.numpy()[v], slots)
    assert (inv.numpy()[~v] == -1).all()
    used = slots[slots >= 0]
    want = np.zeros((S * C, 4), np.int32)
    want[used] = np.stack([np.flatnonzero(v)[slots >= 0],
                           w["hi"][v][slots >= 0].view(np.int32),
                           w["lo"][v][slots >= 0].view(np.int32),
                           np.ones(used.size, np.int32)], 1)
    np.testing.assert_array_equal(records.numpy(), want)
    for a, b in zip(route_bin(hi, lo, valid, S, C), (records, inv, counts)):
        assert torch.equal(a, b)


def _tile_ranks(keys: np.ndarray, rng) -> np.ndarray:
    """Each probe's rank among its tile's probes of its key, in an
    arbitrary order (the kernels' shared atomics)."""
    rank = np.empty(keys.size, np.int64)
    for t in range(0, keys.size, BIN_TILE):
        tk = keys[t:t + BIN_TILE]
        order = rng.permutation(tk.size)
        first = {}
        for j in order:
            rank[t + j] = first.get(tk[j], 0)
            first[tk[j]] = rank[t + j] + 1
    return rank


@pytest.mark.parametrize("name", ["sort_n1", "sort_tile_plus_1",
                                  "sort_past_3_tiles", "sort_one_key",
                                  "sort_invalid", "sort_nb_2_9"])
def test_k9_places_emulated_pass_by_pass(name):
    """K9's three passes in numpy: the tiles' key counts as rows, each
    key's column scanned into its earlier tiles' probes and its total,
    the totals scanned into each key's first place, and a probe's place
    that plus its column prefix plus its rank in its tile. The places are
    a permutation that orders the probes by key, with each key's probes
    in tile order."""
    w = k9_edge_world(name)
    nb = w["nb"]
    n_keys = nb >> key_shift(nb)
    keys = bucket_keys(*_torch_probes(w), nb, w["k"]).numpy()
    n = keys.size
    tiles = -(-n // BIN_TILE)
    tile_of = np.arange(n) // BIN_TILE
    counts = np.zeros((tiles + 1, n_keys), np.int64)
    assert counts.size == k9_scratch(n, n_keys)
    np.add.at(counts, (tile_of, keys), 1)
    totals = counts[:tiles].sum(0)
    counts[:tiles] = np.cumsum(counts[:tiles], 0) - counts[:tiles]
    counts[tiles] = totals
    first = np.cumsum(totals) - totals
    rank = _tile_ranks(keys, np.random.default_rng(n))
    place = first[keys] + counts[tile_of, keys] + rank
    assert (np.sort(place) == np.arange(n)).all()
    by_place = np.empty(n, np.int64)
    by_place[place] = np.arange(n)
    assert (np.diff(keys[by_place]) >= 0).all()
    same = keys[by_place][1:] == keys[by_place][:-1]
    assert (np.diff(tile_of[by_place])[same] >= 0).all()


@pytest.mark.parametrize("name", ["route_s1", "route_s4", "route_s4096",
                                  "route_c1", "route_one_owner",
                                  "route_invalid"])
def test_k10_places_emulated_tile_by_tile(name):
    """K10's scatter in numpy: the tiles claim each owner's run of places
    in an arbitrary order (one global atomic a tile and owner), a probe
    lands at owner * C + its run's first place + its rank below C, and the
    tail zeroes each owner's slots from min(count, C): every slot is
    written once, and the slots and counts are the plain version's up to
    the order within an owner."""
    w = k9_edge_world(name)
    hi, lo, valid = _torch_probes(w)
    S = w["n_shards"]
    C = w["cap"] or route_capacity(hi.numel(), S)
    _, pinv, pcounts = route_bin_plain(hi, lo, valid, S, C)
    owner = np.where(w["valid"], owner_of(hi, lo, S).numpy(), -1)
    n = owner.size
    rng = np.random.default_rng(S + n)
    counts = np.zeros(S, np.int64)
    slot = np.full(n, -1, np.int64)
    keys = np.where(owner >= 0, owner, S)
    rank = _tile_ranks(keys, rng)
    writes = np.zeros(S * C, np.int64)
    for t in rng.permutation(-(-n // BIN_TILE)):
        tile = slice(t * BIN_TILE, (t + 1) * BIN_TILE)
        tk, tr = keys[tile], rank[tile]
        start = counts.copy()
        counts += np.bincount(tk[tk < S], minlength=S)
        pos = start[np.minimum(tk, S - 1)] + tr
        fits = (tk < S) & (pos < C)
        slot[tile] = np.where(fits, tk * C + pos, -1)
        np.add.at(writes, (tk * C + pos)[fits], 1)
    for o in range(S):
        writes[o * C + min(counts[o], C):(o + 1) * C] += 1
    assert (writes == 1).all()
    np.testing.assert_array_equal(counts, pcounts.numpy())
    assert (slot >= 0).sum() == (pinv.numpy() >= 0).sum()
    np.testing.assert_array_equal(np.where(slot >= 0, slot // C, -1),
                                  np.where(slot >= 0, owner, -1))
