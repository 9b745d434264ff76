"""The routed row probes (K11, K12 and their routing pass) on the CPU.

The routing pass's plain version is held to its definition by key, count
and record multiset (as K9's tests hold K9): the totals are a bincount of
``row_in(b) >> 5``, the records a permutation of the queries in ascending
key order. The probe of the routed records, and the kernels' walk of them
emulated pass by pass in numpy (K11 from the staged rows, K12 from the
one-hot product over only the k-tiles an m-tile's rows lie in), equal
``xla_lookup`` and the Pallas kernels ``take_lookup`` and ``oneh_lookup``
of ``experiments/mb_pallas.py`` under ``pltpu.force_tpu_interpret_mode()``
bit for bit, on mb_pallas's world cut to NB 256 and N 4,096, at W = 32 and
64, and on the worlds that stress the routing: row numbers past the table
and below 0, every query in one row, every query in one tile, half the
keys empty, NB = 1 and NB = 257. The plan is checked against the CUDA
sources' constants, and the wrappers' launch path against a fake library.
Outputs are integers and copied bits: the tolerance is exact equality.
"""
import ctypes
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pangea_tpu_torch.experiments import mb_pallas as port_pallas
from pangea_tpu_torch.kernels import (_build, kernel_launches,
                                      reset_kernel_launches, rowprobe_onehot,
                                      rowprobe_onehot_plain, rowprobe_plain,
                                      rowprobe_route, rowprobe_route_plain,
                                      rowprobe_routed_plain, rowprobe_smem)
from pangea_tpu_torch.kernels import rowprobe as RP

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
NB, N, QT = 256, 4096, 512           # mb_pallas's globals, cut
# The row numbers of test_torch_experiments.py's
# test_rowprobe_row_numbers_as_xla_takes_them, past the table and below 0.
FAR_ROWS = (-1, -7, NB, NB + 5, -NB, -NB - 9, 2**31 - 1, -2**31)
CASES = ("seed0", "seed1", "far_rows", "one_row", "one_tile", "half_empty",
         "nb1", "nb257")


@pytest.fixture(scope="module")
def ref_pallas():
    """experiments/mb_pallas.py as a module (its shapes set by _set)."""
    path = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "0")
        spec = importlib.util.spec_from_file_location(
            "ref_mb_pallas_routed", EXPERIMENTS / "mb_pallas.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    sys.path[:] = path                   # the script prepends src/ paths
    return mod


def _set(mod, nb, w):
    mod.NB, mod.N, mod.QT, mod.W, mod.LANES = nb, N, QT, w, 2 * w


def _world(case: str, w: int):
    """(nb, table uint32 [nb, 2w], b int32 [N], rem uint32 [N]) of a
    case."""
    seed = 1 if case == "seed1" else 0
    nb = {"nb1": 1, "nb257": 257}.get(case, NB)
    table, b, rem = port_pallas.make_world(seed, nb, N, w)
    g = np.random.default_rng(7)
    if case == "far_rows":
        b[:len(FAR_ROWS)] = FAR_ROWS
    elif case == "one_row":
        b[:] = 77
    elif case == "one_tile":
        b[:] = g.integers(64, 96, N)
    elif case == "half_empty":               # queries in every other tile
        b[:] = g.integers(0, nb // 64, N) * 64 + g.integers(0, 32, N)
    return nb, table, b, rem


def _reference(mod, name, world):
    args = tuple(jnp.asarray(a) for a in world)
    if name == "xla_lookup":
        return np.asarray(jax.jit(mod.xla_lookup)(*args))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(getattr(mod, name)(*args))


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                 for a in arrays)


def _match_sum(rows, rem):
    """uint32 wrapping payload sum of rows [n, 2W] where rem lanes equal
    rem [n] (numpy, uint32)."""
    w = rows.shape[1] // 2
    hit = rows[:, :w] == rem[:, None]
    return np.where(hit, rows[:, w:], 0).sum(axis=1, dtype=np.uint64) \
        .astype(np.uint32)


def _emulate_k11(table, records, plan, run=RP.RUN):
    """K11's walk: pass by pass, each record probed from the rows staged
    for its pass."""
    nb = table.shape[0]
    out = np.zeros(records.shape[0], dtype=np.uint32)
    rec = records.view(np.uint32)
    for i, end, row0, rows in RP.rowprobe_passes(
            records[:, 1].astype(np.int64), nb, plan, run):
        staged = table[row0:row0 + rows]
        local = records[i:end, 1].astype(np.int64) - row0
        assert rows >= 1 and (local >= 0).all() and (local < rows).all()
        out[records[i:end, 0]] = _match_sum(staged[local], rec[i:end, 2])
    return out


def _emulate_k12(table, records, plan, run=RP.RUN):
    """K12's walk: m-tiles of 16 records a pass, each product summed over
    only the k-tiles its rows lie in, from the staged rows' byte planes
    (rows past the pass's staged rows read as 0), then joined and
    probed."""
    nb, lanes = table.shape
    out = np.zeros(records.shape[0], dtype=np.uint32)
    rec = records.view(np.uint32)
    for i, end, row0, rows in RP.rowprobe_passes(
            records[:, 1].astype(np.int64), nb, plan, run):
        staged = table[row0:row0 + rows]
        for m in range(i, end, 16):
            local = records[m:min(end, m + 16), 1].astype(np.int64) - row0
            acc = np.zeros((4, local.size, lanes), dtype=np.int64)
            for kt in np.unique(local // RP.TILE_ROWS):
                onehot = np.zeros((local.size, RP.TILE_ROWS), dtype=np.int64)
                mine = np.nonzero(local // RP.TILE_ROWS == kt)[0]
                onehot[mine, local[mine] - kt * RP.TILE_ROWS] = 1
                tile = np.zeros((RP.TILE_ROWS, lanes), dtype=np.int64)
                part = staged[kt * RP.TILE_ROWS:(kt + 1) * RP.TILE_ROWS]
                tile[:part.shape[0]] = part
                for p in range(4):
                    acc[p] += onehot @ ((tile >> (8 * p)) & 0xFF)
            assert acc.max() <= 255
            joined = sum(acc[p] << (8 * p) for p in range(4)).astype(
                np.uint32)
            out[records[m:m + local.size, 0]] = _match_sum(
                joined, rec[m:m + local.size, 2])
    return out


@pytest.mark.parametrize("w", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_route_plain_keys_counts_and_records(case, w):
    """The plain routing pass: totals a bincount of row_in(b) >> 5, the
    records (query index, row, rem, 1) a permutation of the queries in
    ascending key order."""
    nb, _, b, rem = _world(case, w)
    bt, remt = _tensors(b, rem)
    records, totals = rowprobe_route_plain(bt, remt, nb)
    rows = RP.row_in(bt, nb)
    keys = rows >> 5
    assert RP.rowprobe_plan(nb, w).shift == 5
    assert torch.equal(totals, torch.bincount(
        keys, minlength=(nb + 31) // 32).to(torch.int32))
    q = records[:, 0].long()
    assert torch.equal(torch.sort(q).values, torch.arange(N))
    assert bool((keys[q][1:] >= keys[q][:-1]).all())
    assert torch.equal(records[:, 1].long(), rows[q])
    assert torch.equal(records[:, 2], remt[q])
    assert bool((records[:, 3] == 1).all())
    reset_kernel_launches()
    assert all(torch.equal(x, y) for x, y in zip(
        rowprobe_route(bt, remt, nb), (records, totals)))
    assert not any(kernel_launches().values())


@pytest.mark.parametrize("w", [32, 64])
@pytest.mark.parametrize("case", CASES)
def test_routed_probe_equals_the_pallas_kernels(ref_pallas, case, w):
    """The routed plain probe, the emulated K11 and K12 walks, and the
    wrappers on CPU tensors equal xla_lookup, take_lookup and oneh_lookup
    (interpret mode) bit for bit."""
    nb, table, b, rem = _world(case, w)
    _set(ref_pallas, nb, w)
    want = _reference(ref_pallas, "xla_lookup", (table, b, rem))
    for name in ("take_lookup", "oneh_lookup"):
        assert np.array_equal(_reference(ref_pallas, name, (table, b, rem)),
                              want), name
    if case in ("seed0", "seed1", "far_rows"):
        assert np.count_nonzero(want) > N // 4            # planted hits
    tt, bt, remt = _tensors(table, b, rem)
    records, _ = rowprobe_route_plain(bt, remt, nb)
    want32 = want.view(np.int32)
    assert np.array_equal(rowprobe_routed_plain(tt, records).numpy(), want32)
    recs = records.numpy()
    plan = RP.rowprobe_plan(nb, w)
    assert np.array_equal(_emulate_k11(table, recs, plan), want)
    assert np.array_equal(_emulate_k12(table, recs, plan), want)
    reset_kernel_launches()
    for fn in (rowprobe_smem, rowprobe_onehot):
        assert np.array_equal(fn(tt, bt, remt).numpy(), want32), fn.__name__
    assert not any(kernel_launches().values())


@pytest.mark.parametrize("window_keys", [1, 2, 3])
@pytest.mark.parametrize("case", ["seed0", "half_empty", "one_row", "nb257"])
def test_passes_cover_each_record_once_within_a_window(case, window_keys):
    """rowprobe_passes (the kernels' row_pass): every record in one pass of
    its run, a pass's rows a run of whole keys from its first record's,
    within window_keys keys and NB; and the emulated walks stay exact when
    the window forces several passes a run."""
    nb, table, b, rem = _world(case, 64)
    records, _ = rowprobe_route_plain(*_tensors(b, rem), nb)
    plan = RP.rowprobe_plan(nb, 64)._replace(window_keys=window_keys)
    rows = records[:, 1].numpy().astype(np.int64)
    seen = np.zeros(N, dtype=int)
    for i, end, row0, nrows in RP.rowprobe_passes(rows, nb, plan,
                                                  run=1024):
        assert i // 1024 == (end - 1) // 1024 and i < end
        seen[i:end] += 1
        assert row0 == (rows[i] >> plan.shift) << plan.shift
        assert 1 <= nrows <= window_keys << plan.shift
        assert row0 + nrows <= nb
        assert ((rows[i:end] >= row0) & (rows[i:end] < row0 + nrows)).all()
    assert (seen == 1).all()
    want = _match_sum(table[RP.row_in(torch.from_numpy(b), nb).numpy()],
                      rem)
    recs = records.numpy()
    assert np.array_equal(_emulate_k11(table, recs, plan, 1024), want)
    assert np.array_equal(_emulate_k12(table, recs, plan, 1024), want)


def test_onehot_visits_skip_every_empty_tile():
    """On mb_pallas's full world an m-tile of routed records visits about
    one k-tile, not the table's 512: the product K12 runs is about 1.7e10
    operations, not the dense 8.8e12."""
    table, b, rem = port_pallas.world_tensors(port_pallas.make_world(0),
                                              "cpu")
    nb, lanes = table.shape
    records, _ = rowprobe_route_plain(b, rem, nb)
    plan = RP.rowprobe_plan(nb, lanes // 2)
    visits = RP.onehot_visits(records[:, 1].numpy().astype(np.int64), nb,
                              plan)
    m_tiles = b.numel() // 16
    assert m_tiles <= visits < 1.1 * m_tiles
    assert len(RP.rowprobe_passes(records[:, 1].numpy(), nb, plan)) == \
        b.numel() // RP.RUN                   # one pass a run


def _constant(src: str, name: str) -> int:
    text = (_build.CSRC / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_plan_matches_the_cuda_sources():
    assert RP.ROUTE_TILE == _constant("bucket_sort.cu", "kThreads") * \
        _constant("bucket_sort.cu", "kRouteItems")
    assert RP.ROUTE_KEY_BITS == _constant("bucket_sort.cu", "kRouteKeyBits")
    assert 1 << RP.ROUTE_KEY_BITS <= RP.ROUTE_TILE
    assert RP.RUN == _constant("common.cuh", "kRun")
    assert RP.TILE_ROWS == _constant("rowprobe_onehot.cu", "kK")
    assert RP.STEP == 16 * _constant("rowprobe_onehot.cu", "kMTiles")


@pytest.mark.parametrize("w", [3, 4, 32, 64])
@pytest.mark.parametrize("nb", [1, 31, 32, 33, 257, 16384, 65536, 65537,
                                524_288, 1 << 20])
def test_plan_keys_shift_and_window(nb, w):
    """The least shift >= 5 that leaves at most 2^ROUTE_KEY_BITS keys; a
    window of whole keys within WINDOW_BYTES, or one key; shared memory
    within a block's up to 524,288 rows at W = 64."""
    plan = RP.rowprobe_plan(nb, w)
    assert plan.shift >= 5 and plan.keys == -(-nb >> plan.shift)
    assert plan.keys <= 1 << RP.ROUTE_KEY_BITS
    assert plan.shift == 5 or -(-nb >> (plan.shift - 1)) > \
        1 << RP.ROUTE_KEY_BITS
    key_bytes = (8 * w) << plan.shift
    assert plan.window_keys == max(1, RP.WINDOW_BYTES // key_bytes)
    if nb <= 524_288 and 2 * w % 8 == 0:
        assert RP.rowprobe_smem_bytes(plan, w, True) <= RP.SMEM_BLOCK
        assert RP.rowprobe_smem_bytes(plan, w, False) <= RP.SMEM_BLOCK
    assert RP.route_scratch(N, plan.keys) == \
        (-(-N // RP.ROUTE_TILE) + 1) * plan.keys


class _Fake:
    """A kernel library that records each launcher's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        argtypes = _build.SIGNATURES[name]

        def call(*args):
            assert len(args) == len(argtypes), name
            for a, t in zip(args, argtypes):
                assert isinstance(a, int) or (a is None and
                                              t is ctypes.c_void_p), name
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake(monkeypatch):
    lib = _Fake()
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "_launchers", {})
    monkeypatch.setattr(_build, "dispatch_device", lambda *t: cpu)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000, raising=False)
    yield lib
    reset_kernel_launches()


@pytest.mark.parametrize("fn", [rowprobe_smem, rowprobe_onehot])
def test_wrappers_route_then_probe_with_the_plan(fake, fn):
    """Each wrapper launches the routing pass, then its probe on the
    records, with rowprobe_plan's shift and window; each counts one launch
    a call; no query launches nothing."""
    nb, table, b, rem = _world("seed0", 64)
    tt, bt, remt = _tensors(table, b, rem)
    reset_kernel_launches()
    fn(tt, bt, remt)
    plan = RP.rowprobe_plan(nb, 64)
    (route, rargs), (probe, pargs) = fake.calls
    assert route == "pangea_rowprobe_route"
    assert rargs[2:5] == (N, nb, plan.shift)
    assert probe == f"pangea_{fn.__name__}"
    assert pargs[1:5] == (nb, 64, plan.shift, plan.window_keys)
    assert pargs[6] == N and pargs[5] == rargs[6]     # the records
    counts = kernel_launches()
    assert counts[fn.__name__] == counts["rowprobe_route"] == 1
    fake.calls.clear()
    fn(tt, bt[:0], remt[:0])
    assert fake.calls == [] and kernel_launches()[fn.__name__] == 1


def test_onehot_refuses_widths_before_launching(fake):
    _, table, b, rem = _world("seed0", 3)
    with pytest.raises(ValueError):
        rowprobe_onehot(*_tensors(table, b, rem))
    assert fake.calls == []


def test_onehot_plain_equals_routed_plain_on_edge_rows():
    """The one-hot product's plain version on the routed worlds' rows."""
    for case in ("far_rows", "nb1", "nb257"):
        nb, table, b, rem = _world(case, 32)
        args = _tensors(table, b, rem)
        records, _ = rowprobe_route_plain(args[1], args[2], nb)
        assert torch.equal(rowprobe_onehot_plain(*args),
                           rowprobe_routed_plain(args[0], records)), case
        assert torch.equal(rowprobe_plain(*args),
                           rowprobe_routed_plain(args[0], records)), case
