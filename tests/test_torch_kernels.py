"""Each plain PyTorch version of the port against its JAX twin (CPU).

Inputs come from numpy seeds and go through both sides as numpy arrays.
Every output is an integer, so the tolerance is exact equality; the one
float op, the threshold compare, is float32 on both sides.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.index.shard import extract_pairs
from pangea_tpu.kernels import (extract_kmers_jnp, hash32_jnp, lookup_q8_jnp,
                                mix32_jnp, score_reads_tin_jnp,
                                select_minimizers_jnp)
from pangea_tpu_torch.index import relayout_q8
from pangea_tpu_torch.kernels import (extract_kmers, extract_probes,
                                      fuse_stash, hash32, lookup_q8, mix32,
                                      score_reads_tin, select_minimizers)

from .helpers import small_world


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _codes(seed, B, L, n_frac=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_frac] = 4
    codes[:4, L // 3:] = 4                          # padded (short) reads
    codes[4, :] = 4                                 # an all-N read
    codes[5, 7] = -1                                # a negative code
    return codes


@pytest.mark.parametrize("k", [3, 15, 21, 31])
def test_extract_kmers_matches_jax(k):
    codes = _codes(k, 64, 90)
    hi, lo, valid = extract_kmers(torch.from_numpy(codes), k)
    jhi, jlo, jvalid = map(np.asarray, extract_kmers_jnp(jnp.asarray(codes),
                                                         k))
    np.testing.assert_array_equal(_u32(hi), jhi)
    np.testing.assert_array_equal(_u32(lo), jlo)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert not valid[4].any()


def test_extract_kmers_read_shorter_than_k():
    codes = torch.full((2, 20), 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="shorter than k"):
        extract_kmers(codes, 21)
    with pytest.raises(ValueError, match="shorter than k"):
        extract_kmers_jnp(jnp.asarray(codes.numpy()), 21)


@pytest.mark.parametrize("w", [1, 2, 8, 16])
def test_select_minimizers_matches_jax(w):
    codes = _codes(100 + w, 48, 150)
    hi, lo, valid = extract_kmers(torch.from_numpy(codes), 21)
    got = select_minimizers(hi, lo, valid, w)
    want = map(np.asarray, select_minimizers_jnp(
        jnp.asarray(_u32(hi)), jnp.asarray(_u32(lo)),
        jnp.asarray(valid.numpy()), w))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32) if g.dtype == torch.int32
            else g.numpy(), x)


@pytest.mark.parametrize("w", [1, 8])
def test_extract_probes_writes_its_columns(w):
    """The fused wrapper's plain route = extract (+ minimize) into columns
    [col0, col0 + NW), leaving the rest untouched."""
    codes = torch.from_numpy(_codes(7, 16, 120))
    hi, lo, valid = extract_kmers(codes, 21)
    if w > 1:
        hi, lo, valid = select_minimizers(hi, lo, valid, w)
    nw = hi.shape[1]
    out = (torch.full((16, nw + 5), 9, dtype=torch.int32),
           torch.full((16, nw + 5), 9, dtype=torch.int32),
           torch.ones((16, nw + 5), dtype=torch.bool))
    extract_probes(codes, 21, w, out, 3)
    for o, want in zip(out, (hi, lo, valid)):
        assert torch.equal(o[:, 3:3 + nw], want)
    assert (out[0][:, :3] == 9).all() and (out[0][:, 3 + nw:] == 9).all()


def test_hash32_and_mix32_match_jax():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 0xFFFFFFFF, 0x80000000]
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    np.testing.assert_array_equal(_u32(hash32(ta, tb)),
                                  np.asarray(hash32_jnp(jnp.asarray(a),
                                                        jnp.asarray(b))))
    np.testing.assert_array_equal(_u32(mix32(ta)),
                                  np.asarray(mix32_jnp(jnp.asarray(a))))


@pytest.fixture(scope="module")
def world():
    return small_world(k=21, seed=5, genome_len=3000, w=1)


@pytest.mark.parametrize("ways,load_factor", [(64, 0.5), (4, 2.0)],
                         ids=["q8", "forced_stash"])
def test_lookup_q8_matches_jax(world, ways, load_factor):
    """Hits (every stored key), absent keys and invalid probes, on the bench
    layout and on a table whose stash is non-empty."""
    idx = world[2]
    fused, stash3, _ = relayout_q8(idx, ways, load_factor)
    if ways == 4:
        assert stash3.shape[2] > 0, "stash not exercised"
    tax = idx.taxonomy
    stash = fuse_stash(stash3[0], tax.tin, tax.tout)[None]
    canon, _ = extract_pairs(idx)
    rng = np.random.default_rng(2)
    absent = rng.integers(0, 1 << 42, size=3000, dtype=np.uint64)
    keys = np.concatenate([canon, absent])
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    valid = rng.random(keys.shape[0]) < 0.85
    got = lookup_q8(torch.from_numpy(hi.view(np.int32)),
                    torch.from_numpy(lo.view(np.int32)),
                    torch.from_numpy(valid),
                    torch.from_numpy(fused[0].view(np.int32)),
                    torch.from_numpy(stash[0].view(np.int32)), idx.meta.k)
    want = lookup_q8_jnp(jnp.asarray(hi), jnp.asarray(lo),
                         jnp.asarray(valid), jnp.asarray(fused[0]),
                         jnp.asarray(stash[0]), k=idx.meta.k, ways=ways)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    n = canon.shape[0]
    assert int(got[0][:n][torch.from_numpy(valid[:n])].min()) == 1


@pytest.mark.parametrize("thr", [0.0, 0.3, 1.0])
def test_score_reads_tin_matches_jax(world, thr):
    tax = world[0]
    rng = np.random.default_rng(int(thr * 10))
    B, R = 256, 30
    taxa = rng.integers(1, tax.num_taxa + 1, size=(B, R))
    hit = (rng.random((B, R)) < 0.4).astype(np.int32)
    hit[:10] = 0                                     # reads with no hit
    t_in = np.where(hit, tax.tin[taxa], 0).astype(np.int32)
    t_out = np.where(hit, tax.tout[taxa], 0).astype(np.int32)
    valid = rng.random((B, R)) < 0.8
    valid[10:20] = False                             # nvalid = 0
    valid[20:, :3] |= hit[20:, :3] != 0
    tax_t = {k: torch.from_numpy(v) for k, v in tax.device_arrays().items()}
    got = score_reads_tin(*(torch.from_numpy(a) for a in
                            (hit, t_in, t_out, valid)), tax_t, thr)
    want = score_reads_tin_jnp(
        (jnp.asarray(hit), jnp.asarray(t_in), jnp.asarray(t_out)),
        jnp.asarray(valid.sum(1).astype(np.int32)),
        {k: jnp.asarray(v) for k, v in tax.device_arrays().items()}, thr)
    for g, key in zip(got, ("taxon", "best", "nvalid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[key]))
    assert (got[0][:20].numpy() == 0).all()
    assert thr == 1.0 or (got[0].numpy() != 0).any()


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: off the CPU a wrapper launches its kernel or
    raises; tensors on a device with no kernel (here `meta`) raise."""
    meta = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=meta)
    codes = torch.empty((2, 40), dtype=torch.int8, device=meta)
    out = (torch.empty((2, 20), **i32), torch.empty((2, 20), **i32),
           torch.empty((2, 20), dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        extract_probes(codes, 21, 1, out, 0)
    hi = torch.empty(8, **i32)
    valid = torch.empty(8, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        lookup_q8(hi, hi, valid, torch.empty((1024, 128), **i32),
                  torch.empty((5, 0), **i32), 21)
    h2 = torch.empty((2, 4), **i32)
    tax = {name: hi for name in ("tin", "tout", "depth", "parent",
                                 "tin2node")}
    tax["up"] = torch.empty((1, 8), **i32)
    with pytest.raises(ValueError, match="no kernel"):
        score_reads_tin(h2, h2, h2, out[2][:, :4], tax, 0.0)
    with pytest.raises(ValueError, match="several devices"):
        extract_probes(torch.zeros((2, 40), dtype=torch.int8), 21, 1, out,
                       0)


def _outside_copy(tmp_path, monkeypatch, _build):
    """Point the builder at a copy of csrc/ outside any checkout."""
    csrc = tmp_path / "pkg" / "csrc"
    csrc.mkdir(parents=True)
    for p in _build._sources():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from pangea_tpu_torch.kernels import _build
    _outside_copy(tmp_path, monkeypatch, _build)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not _build.build_dir().exists()


def test_kernel_build_dir_is_per_user_and_per_source(tmp_path, monkeypatch):
    """From a checkout the library lives in its ignored build/kernels/;
    outside one, in the user's cache; either way in a directory named by
    the hash of the sources, so other sources never overwrite them."""
    from pangea_tpu_torch.kernels import _build
    root = Path(__file__).resolve().parents[1]
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == root / "build" / "kernels" / \
        _build._source_hash()
    csrc = _outside_copy(tmp_path, monkeypatch, _build)
    first = _build.build_dir()
    assert first.parent == tmp_path / "cache" / "pangea_tpu_torch"
    assert first.name == _build._source_hash()
    (csrc / "common.cuh").write_text("// edited\n")
    assert _build.build_dir() != first
    lib = _build.build_dir() / _build.LIB_NAME
    _build.build_dir().mkdir(parents=True)
    lib.write_bytes(b"")
    assert _build.build() == lib          # a built library is reused
