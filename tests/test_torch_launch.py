"""K4's launch plan and the shared launch path, on the CPU.

``kernels/lookup.py`` ``std_plan`` is pure Python: its choice of body for
each W, its grid and its shared memory are checked here, and the kernel's
walk of the probes (as ``csrc/lookup_std.cu`` steps through them) covers
every probe once. ``kernels/_build.py`` ``launch`` is driven against a
fake library and patched ``torch`` CUDA hooks: each launcher is looked up
once, the device is made current only where another one is, the stream
is the device's current one, a nonzero return raises, and the wrappers'
call sites pass each launcher the arguments ``SIGNATURES`` (and the C
sources) give it.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from pangea_tpu_torch.kernels import _build
from pangea_tpu_torch.kernels.gather import SMEM_OPTIN, gather_plan
from pangea_tpu_torch.kernels.lookup import (LOOKUP_BLOCKS_PER_SM, LOOKUP_L2,
                                             STASH_ROWS, STASH_SMEM_MAX,
                                             STD_BATCH, STD_BATCH_GENERIC,
                                             std_plan)

SMS = 132                 # an H100 SXM's SMs
MAX_WARPS = 8             # csrc/lookup_std.cu kMaxWarps


def _walk(plan, n: int) -> np.ndarray:
    """How often the kernel writes each probe: warp v takes the 32 probes
    from base = v * 32 + k * 32 * warps while base < n, lane i the probe
    base + i."""
    warps = plan.grid * plan.warps
    steps = -(-n // (32 * warps)) if warps else 0
    w = (np.arange(warps)[:, None, None] * 32
         + np.arange(steps)[None, :, None] * 32 * warps
         + np.arange(32)[None, None, :]).ravel()
    return np.bincount(w[w < n], minlength=n)


@pytest.mark.parametrize("sorted_form", [False, True],
                         ids=["unsorted", "sorted"])
@pytest.mark.parametrize("stash_cols", [0, 7, 128, 3000])
@pytest.mark.parametrize("ways", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("n", [0, 1, 33, 491_520, 4_259_840, 8_519_680,
                               1_000_003])
def test_std_plan_fits_and_covers_every_probe(n, ways, stash_cols,
                                              sorted_form):
    plan = std_plan(n, ways, stash_cols, sorted_form, SMS)
    assert plan.spec == (ways if ways in (16, 32) else 0)
    assert plan.batch == STD_BATCH.get(plan.spec, STD_BATCH_GENERIC)
    assert 1 <= plan.warps <= MAX_WARPS and plan.batch in (2, 4)
    assert plan.l2 == LOOKUP_L2[sorted_form] and 0 <= plan.l2 <= 2
    assert plan.grid <= min(SMS * LOOKUP_BLOCKS_PER_SM,
                            -(-n // (plan.warps * 32)))
    assert (plan.grid >= 1) == (n > 0)
    stash_bytes = STASH_ROWS * 4 * stash_cols
    assert plan.smem == (stash_bytes if stash_bytes <= STASH_SMEM_MAX
                         else 0)
    assert plan.smem <= SMEM_OPTIN
    assert (_walk(plan, n) == 1).all()


def test_std_plan_fills_the_card_at_the_main_paths_shapes():
    """At the wide and deep std steps' probes every SM gets its blocks."""
    for n in (4_259_840, 8_519_680):
        assert std_plan(n, 32, 3, False, SMS).grid == \
            SMS * LOOKUP_BLOCKS_PER_SM


def test_std_plan_refuses_bad_shapes():
    for args in ((-1, 32, 0, False, SMS), (5, 0, 0, False, SMS),
                 (5, 32, -1, False, SMS), (5, 32, 0, False, 0)):
        with pytest.raises(ValueError):
            std_plan(*args)


def test_block_copy_takes_the_plan_of_one_index():
    """pangea_block_copy launches K13 as gather_plan plans one index: one
    block of one warp, one issuing lane, one slot."""
    plan = gather_plan(1, 1, 1, 8 * 512, SMS, SMEM_OPTIN)
    assert (plan.grid, plan.warps, plan.lanes, plan.slots) == (1, 1, 1, 1)


def _exports() -> dict:
    """Launcher name -> its parameter count, from csrc/*.cu."""
    out = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            out[name] = len(params.split(","))
    return out


def test_signatures_match_the_c_sources():
    exports = _exports()
    assert set(exports) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert exports[name] == len(argtypes), name


class FakeLauncher:
    """A launcher that takes what ctypes would pass it, records the call
    and returns ``rc``."""

    def __init__(self, name, calls):
        self.name, self.calls, self.rc = name, calls, 0

    def __call__(self, *args):
        argtypes = _build.SIGNATURES[self.name]
        assert len(args) == len(argtypes), (self.name, len(args))
        for a, t in zip(args, argtypes):
            if t is ctypes.c_void_p:
                assert a is None or isinstance(a, int), (self.name, a)
            elif t is ctypes.c_float:
                assert isinstance(a, float), (self.name, a)
            else:
                bits = 64 if t is ctypes.c_int64 else 32
                assert isinstance(a, int) and not isinstance(a, float)
                assert -(1 << bits - 1) <= a < 1 << bits - 1, (self.name, a)
        self.calls.append((self.name, args))
        return self.rc


class FakeLibrary:
    def __init__(self):
        self.lookups, self.calls, self.fns = [], [], {}

    def __getattr__(self, name):
        if name not in _build.SIGNATURES:
            raise AttributeError(name)
        self.lookups.append(name)
        return self.fns.setdefault(name, FakeLauncher(name, self.calls))


@pytest.fixture
def fake(monkeypatch):
    """A fake kernel library behind _build.launch, with device 0 current,
    a raw stream 1000 + index a device and a recording device guard."""
    lib = FakeLibrary()
    state = {"current": 0, "entered": []}

    class Guard:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            state["entered"].append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "_launchers", {})
    monkeypatch.setattr(torch._C, "_cuda_getDevice",
                        lambda: state["current"], raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + (index or 0), raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    return lib, state


def test_launch_looks_each_launcher_up_once(fake):
    lib, state = fake
    args = (0, 16384, 512, 8, 0, 0)
    for _ in range(3):
        _build.launch("pangea_block_copy", torch.device("cuda", 0), *args)
    assert lib.lookups == ["pangea_block_copy"]
    assert [c[1] for c in lib.calls] == [(*args, 1000)] * 3
    assert state["entered"] == []


def test_launch_makes_another_device_current_for_the_call(fake):
    lib, state = fake
    _build.launch("pangea_block_copy", torch.device("cuda", 3),
                  0, 16, 512, 8, 0, 0)
    assert state["entered"] == [3]
    assert lib.calls[0][1][-1] == 1003
    state["current"] = 3
    _build.launch("pangea_block_copy", torch.device("cuda", 3),
                  0, 16, 512, 8, 0, 0)
    assert state["entered"] == [3] and lib.calls[1][1][-1] == 1003


def test_launch_raises_on_a_cuda_error(fake):
    lib, _ = fake
    _build.launch("pangea_row_gather", torch.device("cuda", 0),
                  *([0] * 13))
    lib.fns["pangea_row_gather"].rc = 700
    with pytest.raises(RuntimeError, match="pangea_row_gather: CUDA error "
                                           "700"):
        _build.launch("pangea_row_gather", torch.device("cuda", 0),
                      *([0] * 13))


def _std_inputs():
    g = torch.Generator().manual_seed(4)
    n = 333
    hi, lo = (torch.randint(0, 1 << 20, (n,), dtype=torch.int32,
                            generator=g) for _ in range(2))
    valid = torch.ones(n, dtype=torch.bool)
    fused = torch.zeros((64, 6 * 32), dtype=torch.int32)
    stash = torch.zeros((5, 7), dtype=torch.int32)
    return hi, lo, valid, fused, stash


def _call_sites():
    """name -> (a wrapper call on CPU tensors, the launchers it reaches)."""
    from pangea_tpu_torch.kernels import (block_copy, extract_probes,
                                          extract_probes_packed, lookup_std,
                                          lookup_std_owned, lookup_std_sorted,
                                          row_gather)
    x = torch.zeros((16, 128), dtype=torch.float32)
    out = (torch.zeros((3, 300), dtype=torch.int32),
           torch.zeros((3, 300), dtype=torch.int32),
           torch.zeros((3, 300), dtype=torch.bool))
    rows = torch.zeros((3, 40), dtype=torch.int32)
    idx = torch.tensor([0, 5, -1], dtype=torch.int32)
    start = torch.tensor([4], dtype=torch.int32)
    return {
        "lookup_std": (lambda: lookup_std(*_std_inputs(), 32),
                       ["pangea_lookup_std"]),
        "lookup_std_owned": (
            lambda: lookup_std_owned(*_std_inputs(), 32, (4, 1)),
            ["pangea_lookup_std"]),
        "lookup_std_sorted": (
            lambda: lookup_std_sorted(*_std_inputs(), 32),
            ["pangea_bucket_sort", "pangea_lookup_std",
             "pangea_bucket_restore"]),
        "extract_probes": (
            lambda: extract_probes(torch.zeros((3, 150), dtype=torch.int8),
                                   21, 1, out, 130),
            ["pangea_extract_probes"]),
        "extract_packed": (
            lambda: extract_probes_packed(rows[:, 5:20], 150, 21, 8, out, 7),
            ["pangea_extract_probes"]),
        "block_copy": (lambda: block_copy(x, start, 8),
                       ["pangea_block_copy"]),
        "row_gather": (lambda: row_gather(x, idx, depth=4, chunk=8),
                       ["pangea_row_gather"]),
        "row_gather_direct": (
            lambda: row_gather(x, idx, depth=4, chunk=8, direct=True),
            ["pangea_row_gather"]),
    }


@pytest.mark.parametrize("site", list(_call_sites()))
def test_wrappers_pass_each_launcher_its_signature(fake, monkeypatch, site):
    """Each wrapper's launch path, taken on CPU tensors with the device
    dispatch patched, hands every launcher it reaches the arguments its
    signature names (FakeLauncher checks count and types)."""
    lib, _ = fake
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "dispatch_device", lambda *t: cpu)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    call, names = _call_sites()[site]
    call()
    assert [c[0] for c in lib.calls] == names


def test_k4_launch_passes_std_plan(fake, monkeypatch):
    """K4's tail arguments are std_plan's, with the specialised body only
    on a 16-byte-aligned table."""
    from pangea_tpu_torch.kernels import lookup_std
    lib, _ = fake
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "dispatch_device", lambda *t: cpu)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    hi, lo, valid, fused, stash = _std_inputs()
    lookup_std(hi, lo, valid, fused, stash, 32)
    plan = std_plan(hi.numel(), 32, 7, False, SMS)
    assert lib.calls[-1][1][-7:-1] == (plan.grid, plan.warps, plan.batch,
                                       32, plan.l2, plan.smem)
    shifted = torch.zeros(fused.numel() + 1, dtype=torch.int32)[1:].view(
        fused.shape)
    assert shifted.data_ptr() % 16
    lookup_std(hi, lo, valid, shifted, stash, 32)
    assert lib.calls[-1][1][-7:-1] == (plan.grid, plan.warps, plan.batch,
                                       0, plan.l2, plan.smem)


def test_k1_launch_passes_k1_plan(fake, monkeypatch):
    """K1's tail arguments are k1_plan's; the packed form passes its rows'
    pitch in words, the codes form its row length."""
    from pangea_tpu_torch.kernels import extract_probes, extract_probes_packed
    from pangea_tpu_torch.kernels.minimize import k1_plan
    lib, _ = fake
    cpu = torch.device("cpu")
    monkeypatch.setattr(_build, "dispatch_device", lambda *t: cpu)
    monkeypatch.setattr(_build, "sm_count", lambda index: SMS)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: None,
                        raising=False)
    out = tuple(torch.zeros((75, 16364), dtype=dt)
                for dt in (torch.int32, torch.int32, torch.bool))
    extract_probes(torch.zeros((75, 16384), dtype=torch.int8), 21, 1, out, 0)
    args = lib.calls[-1][1]
    assert args[11] == 16384
    assert args[12:16] == tuple(k1_plan(75, 16384, 21, 1, SMS))
    rows = torch.zeros((75, 2 * 1536 + 3), dtype=torch.int32)
    extract_probes_packed(rows[:, 1536:], 16384, 21, 8, out, 3)
    args = lib.calls[-1][1]
    assert args[10:12] == (1, 2 * 1536 + 3)
    assert args[12:16] == tuple(k1_plan(75, 16384, 21, 8, SMS))
