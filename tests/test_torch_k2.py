"""K2 (``csrc/lookup_q8.cu``, the q8 and q12 probes) on the CPU: its
launch plan, its load schedule, its launch arguments and the plain
versions against the JAX package, on K2's edge tables
(``bench.k2_edge_world``).

- ``quot_plan``: its choice of body, batch, L2 mode and shared bytes, a
  grid that fits the card and a walk (as the kernel steps through the
  probes) that writes every probe once, from 0 probes to 2^31 - 1;
- the group's load schedule, as ``KeyWords`` lays it out: every key lane of
  a row read once, every 16-byte load aligned and inside the row, q12's
  shared last word never compared as a key, and the match bits naming the
  slots they were read from; the C source's specialised W against the
  layouts';
- the kernel's compare and hit logic emulated lane by lane (a lane's
  first match in a row read with the other rows', the rest one by one, the
  group's sum) against the plain version;
- the wrappers hand the launcher ``quot_plan``'s arguments (a fake
  library), the generic body where the table is not 16-byte aligned;
- ``lookup_q8_plain`` and ``lookup_q12_plain`` (and their sorted forms)
  against ``lookup_q8_jnp`` and ``lookup_q12_jnp`` on every edge table,
  at every probe and at N = 0, 1 and 33.

Every comparison is exact: all outputs are integers.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.kernels.lookup import lookup_q8_jnp, lookup_q12_jnp
from pangea_tpu_torch.bench import K2_EDGE, k2_edge_world
from pangea_tpu_torch.index.quot import Q8_WAYS, Q12_WAYS
from pangea_tpu_torch.kernels import _build
from pangea_tpu_torch.kernels.lookup import (LOOKUP_BLOCKS_PER_SM, LOOKUP_L2,
                                             QUOT_SPECS, STASH_ROWS,
                                             STASH_SMEM_MAX, lookup_q8_plain,
                                             lookup_q8_sorted_plain,
                                             lookup_q12_plain,
                                             lookup_q12_sorted_plain,
                                             quot_plan)

from .test_torch_launch import MAX_WARPS, SMS, fake  # noqa: F401

LANES = 8                 # csrc/common.cuh kProbeLanes
K2_BATCH = 2              # csrc/lookup_q8.cu kBatch
WALK_MAX = 10_000_000     # past this the walk is counted, not listed


@functools.lru_cache(maxsize=None)
def _writes(grid: int, warps: int, n: int) -> np.ndarray | None:
    """How often the kernel writes each probe (None past WALK_MAX): warp v
    takes the 32 probes from base = v * 32 + s * 32 * warps while base < n,
    lane i the probe base + i."""
    total = grid * warps
    if n > WALK_MAX:
        return None
    steps = -(-n // (32 * total)) if total else 0
    w = (np.arange(total)[:, None, None] * 32
         + np.arange(steps)[None, :, None] * 32 * total
         + np.arange(32)[None, None, :]).ravel()
    return np.bincount(w[w < n], minlength=n)


def _written(grid: int, warps: int, n: int) -> int:
    """Probes the kernel writes, counted warp by warp: a warp's lanes are
    distinct residues mod 32 * grid * warps, so none is written twice, and
    the count must be n."""
    step = 32 * grid * warps
    full, rest = divmod(n, step)
    first = 32 * np.arange(grid * warps, dtype=np.int64)
    return int((full * 32 + np.clip(rest - first, 0, 32)).sum())


@pytest.mark.parametrize("sorted_form", [False, True],
                         ids=["unsorted", "sorted"])
@pytest.mark.parametrize("q12", [False, True], ids=["q8", "q12"])
@pytest.mark.parametrize("stash_cols", [0, 7, 3000])
@pytest.mark.parametrize("ways", [4, 8, 42, 64])
@pytest.mark.parametrize("n", [0, 1, 33, 524_288, 3_932_160, 8_519_680,
                               2**31 - 1])
def test_quot_plan_fits_and_covers_every_probe(n, ways, stash_cols, q12,
                                               sorted_form):
    plan = quot_plan(n, ways, stash_cols, q12, sorted_form, SMS)
    spec = QUOT_SPECS[q12]
    assert plan.spec == (ways if ways == spec else 0)
    assert plan.batch == K2_BATCH
    assert 1 <= plan.warps <= MAX_WARPS
    assert plan.l2 == LOOKUP_L2[sorted_form] and 0 <= plan.l2 <= 2
    assert plan.grid <= min(SMS * LOOKUP_BLOCKS_PER_SM,
                            -(-n // (plan.warps * 32)))
    assert (plan.grid >= 1) == (n > 0)
    stash_bytes = STASH_ROWS * 4 * stash_cols
    assert plan.smem == (stash_bytes if stash_bytes <= STASH_SMEM_MAX
                         else 0)
    if n:
        assert _written(plan.grid, plan.warps, n) == n
        assert plan.grid * plan.warps * 32 * 2 + n < 2**63
    writes = _writes(plan.grid, plan.warps, n)
    if writes is not None:
        assert (writes == 1).all()


def test_quot_plan_fills_the_card_at_the_main_paths_shapes():
    """At the headline's, config 4's and the deep steps' probes every SM
    gets its blocks, with the specialised bodies."""
    for n, ways, q12 in ((524_288, Q8_WAYS, False),
                         (3_932_160, Q12_WAYS, True),
                         (2_129_920, Q8_WAYS, False),
                         (2_129_920, Q12_WAYS, True)):
        for sorted_form in (False, True):
            plan = quot_plan(n, ways, 3, q12, sorted_form, SMS)
            assert plan.grid == SMS * LOOKUP_BLOCKS_PER_SM
            assert plan.spec == ways


def test_quot_plan_refuses_bad_shapes():
    for args in ((-1, 64, 0, False, False, SMS), (5, 0, 0, True, False, SMS),
                 (5, 64, -1, False, True, SMS), (5, 42, 0, True, False, 0)):
        with pytest.raises(ValueError):
            quot_plan(*args)


def test_specialised_w_is_the_layouts():
    """The C source's specialised W are the layouts' ways."""
    src = (_build.CSRC / "lookup_q8.cu").read_text()
    assert int(re.search(r"kQ8Spec = (\d+);", src)[1]) == Q8_WAYS
    assert int(re.search(r"kQ12Spec = (\d+);", src)[1]) == Q12_WAYS


def test_k2_batch_is_the_kernels():
    """The one batch the C source takes (it refuses any other) is the
    one quot_plan gives."""
    src = (_build.CSRC / "lookup_q8.cu").read_text()
    assert int(re.search(r"kBatch = (\d+);", src)[1]) == K2_BATCH
    assert "batch != kBatch" in src
    assert QUOT_SPECS == {False: Q8_WAYS, True: Q12_WAYS}


def _row_lanes(ways: int, q12: bool) -> int:
    return 1 << (3 * ways - 1).bit_length() if q12 else 2 * ways


def _key_loads(ways: int, spec: int):
    """The loads of a row's key lanes, as the kernel issues them: (lane g,
    first key lane, words, the match bits and the key slots they count).
    Specialised (spec == ways): KeyWords, word i of 4 lanes read by lane
    i % 8 as its load i // 8, element e of load t at bit 4t + e, a key
    where its lane is below W. Generic: slot j = g + 8t, one lane a load,
    at bit t."""
    loads = []
    for g in range(LANES):
        if spec:
            words = -(-spec // 4)
            for t in range(-(-words // LANES)):
                word = g + LANES * t
                if word < words:
                    counted = [(4 * t + e, 4 * word + e) for e in range(4)
                               if 4 * word + e < spec]
                    loads.append((g, 4 * word, 4, counted))
        else:
            for t, j in enumerate(range(g, ways, LANES)):
                loads.append((g, j, 1, [(t, j)]))
    return loads


def _slot(g: int, bit: int) -> int:
    """csrc/lookup_q8.cu KeyWords::slot."""
    return 4 * (g + LANES * (bit >> 2)) + (bit & 3)


@pytest.mark.parametrize("q12", [False, True], ids=["q8", "q12"])
@pytest.mark.parametrize("ways", [4, 8, 42, 64])
def test_key_loads_read_every_key_lane_once(ways, q12):
    spec = ways if ways == QUOT_SPECS[q12] else 0
    lanes = _row_lanes(ways, q12)
    loads = _key_loads(ways, spec)
    counted = [slot for *_, c in loads for _, slot in c]
    assert sorted(counted) == list(range(ways))
    read = np.zeros(lanes, int)
    for g, first, width, c in loads:
        assert 0 <= first and first + width <= lanes
        read[first:first + width] += 1
        if width == 4:
            assert first % 4 == 0 and lanes % 4 == 0    # 16-byte aligned
        bits = [b for b, _ in c]
        assert len(set(bits)) == len(bits)
        if spec:
            # A row's match bits share a 64-bit word with 7 others: a byte.
            assert max(bits, default=0) < 8
            assert all(_slot(g, b) == s for b, s in c)
    assert (read <= 1).all()
    # Only key lanes are compared: q12's rem_hi lanes [W, 2W) never.
    assert all(s < ways for s in counted)
    if spec == Q12_WAYS and q12:
        shared = [ld for ld in loads if ld[1] == 40]
        assert len(shared) == 1 and shared[0][0] == 2
        assert [s for _, s in shared[0][3]] == [40, 41]
        assert read[Q12_WAYS:Q12_WAYS + 2].tolist() == [1, 1]
    if spec:
        per_lane = np.bincount([ld[0] for ld in loads], minlength=LANES)
        assert per_lane.max() <= 2 and per_lane.min() >= 1


def _mix(hi, lo, k: int, log2nb: int):
    K = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    h = (K * np.uint64(0x9E3779B1)) & np.uint64((1 << 2 * k) - 1)
    r = 2 * k - log2nb
    rem = h & np.uint64((1 << r) - 1)
    return ((h >> np.uint64(r)).astype(np.int64),
            (rem & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (rem >> np.uint64(32)).astype(np.uint32))


def _emulate(w: dict, n: int):
    """K2's row sums lane by lane, as the kernel computes them: each lane's
    match bits over its key loads, the first match's rem_hi and payload
    read with the group's other rows', the rest one by one, the group's sum
    wrapping in 32 bits; then the stash, by the probe's own lane."""
    ways, q12, fused, stash = w["ways"], w["q12"], w["fused"], w["stash"]
    spec = ways if ways == QUOT_SPECS[q12] else 0
    loads = _key_loads(ways, spec)
    pay = (2 if q12 else 1) * ways
    hi, lo, valid = w["hi"][:n], w["lo"][:n], w["valid"][:n]
    rows, rlo, rhi = _mix(hi, lo, w["k"], fused.shape[0].bit_length() - 1)
    out = np.zeros((3, n), np.uint32)
    S = stash.shape[1]
    for i in range(n):
        if not valid[i]:
            continue
        row = fused[rows[i]]
        pk = np.uint32(0)
        for g in range(LANES):
            match = 0
            for _, _, _, c in (ld for ld in loads if ld[0] == g):
                for bit, slot in c:
                    if row[slot] == rlo[i]:
                        match |= 1 << bit
            while match:
                bit = (match & -match).bit_length() - 1
                j = _slot(g, bit) if spec else g + LANES * bit
                if not q12 or row[ways + j] == rhi[i]:
                    pk = np.uint32((int(pk) + int(row[pay + j])) & 0xFFFFFFFF)
                match &= match - 1
        o = [int(pk != 0), int(pk) >> 16, int(pk) & 0xFFFF]
        for s in range(S):
            if stash[0, s] == hi[i] and stash[1, s] == lo[i]:
                o = [o[0] + 1, o[1] + int(stash[3, s]),
                     o[2] + int(stash[4, s])]
        out[:, i] = [x & 0xFFFFFFFF for x in o]
    return out.view(np.int32)


def _torch(w: dict, n: int | None = None):
    sl = slice(None) if n is None else slice(0, n)
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                 for a in (w["hi"][sl], w["lo"][sl])) + (
        torch.from_numpy(np.ascontiguousarray(w["valid"][sl])),
        torch.from_numpy(w["fused"].view(np.int32)),
        torch.from_numpy(w["stash"].view(np.int32)))


def _plain(w: dict, n: int | None = None, sorted_form: bool = False):
    args = _torch(w, n)
    if w["q12"]:
        fn = lookup_q12_sorted_plain if sorted_form else lookup_q12_plain
        return fn(*args, w["k"], w["ways"])
    fn = lookup_q8_sorted_plain if sorted_form else lookup_q8_plain
    return fn(*args, w["k"])


@functools.lru_cache(maxsize=None)
def _world(name: str) -> dict:
    return k2_edge_world(name)


EMULATED = 700            # probes a world the lane-by-lane emulation takes


@pytest.mark.parametrize("name", list(K2_EDGE))
def test_kernel_logic_emulated_matches_plain(name):
    w = _world(name)
    n = min(EMULATED, w["hi"].size)
    got = _emulate(w, n)
    for a, b in zip(got, _plain(w, n)):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("n", [None, 0, 1, 33], ids=["all", "0", "1", "33"])
@pytest.mark.parametrize("name", list(K2_EDGE))
def test_plain_matches_jax_on_edge_tables(name, n):
    w = _world(name)
    sl = slice(None) if n is None else slice(0, n)
    fn = lookup_q12_jnp if w["q12"] else lookup_q8_jnp
    want = fn(*(jnp.asarray(w[key][sl]) for key in ("hi", "lo", "valid")),
              jnp.asarray(w["fused"]), jnp.asarray(w["stash"]), k=w["k"],
              ways=w["ways"])
    got = _plain(w, n)
    srt = _plain(w, n, sorted_form=True)
    for g, s, x in zip(got, srt, want):
        assert g.dtype == torch.int32 and g.shape == (w["hi"][sl].size,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(s.numpy(), np.asarray(x))


def test_edge_tables_reach_their_edges():
    """Each table has the remainder width it is named for, and the probes
    hit rows, repeated keys (wrapping sums) and stashes as intended."""
    for name, (q12, k, log2nb, ways, n_keys, extra) in K2_EDGE.items():
        w = _world(name)
        assert w["fused"].shape == (1 << log2nb, _row_lanes(ways, q12))
        r = 2 * k - log2nb
        assert r == int(re.search(r"r(\d+)", name)[1]) if "_r" in name \
            else 0 <= r <= (62 if q12 else 31)
        hit = _plain(w)[0].numpy()
        assert (hit > 0).sum() >= 0.8 * n_keys, name
        if ways == 4 or extra:
            assert w["stash"].shape[1] >= max(extra, 1)
            assert (hit > 1).any() or ways == 4, name
    # Stashes past the kernel's shared-memory cap.
    assert STASH_ROWS * 4 * 3000 > STASH_SMEM_MAX
    # A q12 row whose slots share a rem_lo with another rem_hi, and a row
    # with a key twice.
    f = _world("q12_r62")["fused"][0]
    assert f[40] == f[41] == f[0] and f[Q12_WAYS + 41] == f[Q12_WAYS] ^ 1
    assert f[Q12_WAYS + 40] == f[Q12_WAYS]


class _Args:
    """Tensors for a wrapper call that reaches the fake launcher."""

    @staticmethod
    def q8(shift: int = 0):
        w = _world("q8_r22")
        args = list(_torch(w, 333))
        if shift:
            f = args[3]
            args[3] = torch.zeros(f.numel() + shift,
                                  dtype=torch.int32)[shift:].view(f.shape)
        return args, w["k"]

    @staticmethod
    def q12():
        w = _world("q12_r54")
        return list(_torch(w, 333)), w["k"]


@pytest.fixture
def on_fake(fake, monkeypatch):  # noqa: F811
    lib, _ = fake
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "dispatch_device", lambda *t: cpu)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    return lib


@pytest.mark.parametrize("sorted_form", [False, True],
                         ids=["unsorted", "sorted"])
@pytest.mark.parametrize("q12", [False, True], ids=["q8", "q12"])
def test_k2_launch_passes_quot_plan(on_fake, q12, sorted_form):
    """K2's tail arguments are quot_plan's, through every wrapper: the
    launchers each wrapper reaches, their signatures (FakeLauncher), and
    the plan's six arguments before the stream."""
    from pangea_tpu_torch.kernels import (lookup_q8, lookup_q8_sorted,
                                          lookup_q12, lookup_q12_sorted)
    lib = on_fake
    args, k = _Args.q12() if q12 else _Args.q8()
    ways = Q12_WAYS if q12 else Q8_WAYS
    if q12:
        fn = lookup_q12_sorted if sorted_form else lookup_q12
        fn(*args, k, ways)
    else:
        fn = lookup_q8_sorted if sorted_form else lookup_q8
        fn(*args, k)
    name = "pangea_lookup_q12" if q12 else "pangea_lookup_q8"
    want = ([name] if not sorted_form else
            ["pangea_bucket_sort", name, "pangea_bucket_restore"])
    assert [c[0] for c in lib.calls] == want
    plan = quot_plan(333, ways, args[4].shape[1], q12, sorted_form, SMS)
    call = [c for c in lib.calls if c[0] == name][0][1]
    assert call[-7:-1] == tuple(plan)
    assert plan.spec == ways


def test_k2_launch_takes_the_generic_body_off_16_bytes(on_fake):
    """A table that does not start on 16 bytes gets spec 0."""
    from pangea_tpu_torch.kernels import lookup_q8
    lib = on_fake
    args, k = _Args.q8(shift=1)
    assert args[3].data_ptr() % 16
    lookup_q8(*args, k)
    plan = quot_plan(333, Q8_WAYS, args[4].shape[1], False, False, SMS)
    assert lib.calls[-1][1][-7:-1] == (*plan[:3], 0, *plan[4:])


def test_k2_launch_passes_a_given_plan(on_fake):
    """The sweep's plan= reaches the launcher as given."""
    from pangea_tpu_torch.kernels.lookup import LookupPlan, _q12_kernel
    lib = on_fake
    args, k = _Args.q12()
    plan = LookupPlan(7, 4, 2, 0, 0, 0)
    _q12_kernel(torch.device("cpu"), *args, k, Q12_WAYS, None, plan=plan)
    assert lib.calls[-1][1][-7:-1] == tuple(plan)
