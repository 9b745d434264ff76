"""K1 (``csrc/extract_probes.cu``) on the CPU: the design's arithmetic,
its launch plan and its walk, and the plain versions against the JAX
package, on K1's edge worlds (``bench.k1_edge_world``).

- The stream identities: a k-mer read from the 2-bit stream (base j at
  bits [2j, 2j + 2)) as the kernel reads it, its reverse complement x ^
  mask and its forward k-mer by pair reversal, against the rolling
  definition and against ``extract_kmers_jnp``;
- ``k1_plan``: every (read, window) in one tile, tiles of whole rounds of
  32 windows, and the main paths' shapes filling an H100's 132 SMs;
- the kernel's walk, emulated lane by lane in numpy (passes of 32
  positions, the shuffle reduction and the owners' merge), against
  ``extract_probes_plain``, both front ends;
- ``extract_probes_plain`` (codes, and packed wire rows as a column slice
  of a wider batch) against ``extract_kmers_jnp`` +
  ``select_minimizers_jnp`` at k in {1, 21, 31}, w in {1, 3, 8, 32} and
  reads of k, 31 + k, 32 + k, 33 + k and 16,384 bases, at col0 > 0.

Every comparison is exact: all outputs are integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.kernels.encode import extract_kmers_jnp
from pangea_tpu.kernels.minimize import select_minimizers_jnp
from pangea_tpu_torch.bench import EDGE_POSITIONS, k1_edge_world
from pangea_tpu_torch.kernels import extract_probes_plain, wire_width
from pangea_tpu_torch.kernels.minimize import (K1_SM_WARPS, k1_cost,
                                               k1_plan, probe_width)

SMS = 132                 # an H100 SXM's SMs
U64 = np.uint64
EVEN = U64(0x5555555555555555)


def _brev64(x):
    """__brevll on uint64 arrays."""
    for shift, mask in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                        (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                        (16, 0x0000FFFF0000FFFF)):
        s, m = U64(shift), U64(mask)
        x = ((x >> s) & m) | ((x & m) << s)
    return (x >> U64(32)) | (x << U64(32))


def _kmer64(b0, b1, lane, k: int):
    """The design's k-mer at lane ``lane`` of a pass whose blocks hold the
    64-bit code words b0, b1: (rc, fwd) = (x ^ mask, pair-reversed x >>
    (64 - 2k)), x the 2k stream bits at 2 * lane."""
    s = (2 * lane).astype(np.uint64)
    kmask = U64((1 << 2 * k) - 1)
    x = ((b0 >> s) | ((b1 << U64(1)) << (U64(63) - s))) & kmask
    y = _brev64(x)
    y = ((y >> U64(1)) & EVEN) | ((y & EVEN) << U64(1))
    return x ^ kmask, y >> U64(64 - 2 * k)


M32 = 0xFFFFFFFF


def _funnel_r(lo, hi, r):
    """__funnelshift_r on uint32 arrays (r in 0..31)."""
    v = (hi.astype(np.uint64) << U64(32)) | lo.astype(np.uint64)
    return ((v >> np.asarray(r, np.uint64)) & U64(M32)).astype(np.uint32)


def _reverse_pairs(v):
    r = _brev64(v.astype(np.uint64)) >> U64(32)
    return (((r >> U64(1)) & U64(0x55555555)) | ((r << U64(1))
                                              & U64(0xAAAAAAAA))
            ).astype(np.uint32)


def _kmer_at(b0, b1, lane, k: int):
    """csrc/extract_probes.cu kmer_at, lane by lane: (ok, chi, clo) of the
    blocks b0, b1 = (lo, hi, bad) uint32 words."""
    mlo = np.uint32(M32 if k >= 16 else (1 << 2 * k) - 1)
    mhi = np.uint32((1 << (2 * k - 32)) - 1 if k > 16 else 0)
    upper = lane >= 16
    r = 2 * (lane & 15)
    a = np.where(upper, b0[1], b0[0]).astype(np.uint32)
    m = np.where(upper, b1[0], b0[1]).astype(np.uint32)
    c = np.where(upper, b1[1], b1[0]).astype(np.uint32)
    xlo = _funnel_r(a, m, r) & mlo
    xhi = _funnel_r(m, c, r) & mhi
    rlo, rhi = xlo ^ mlo, xhi ^ mhi
    ylo, yhi = _reverse_pairs(xhi), _reverse_pairs(xlo)
    down = 64 - 2 * k
    if down >= 32:
        flo, fhi = yhi >> np.uint32(down - 32), np.zeros(32, np.uint32)
    else:
        flo, fhi = _funnel_r(ylo, yhi, down), yhi >> np.uint32(down)
    bad = _funnel_r(np.full(32, b0[2], np.uint32),
                    np.full(32, b1[2], np.uint32), lane)
    ok = (bad & np.uint32((1 << k) - 1)) == 0
    f = (fhi < rhi) | ((fhi == rhi) & (flo < rlo))
    chi = np.where(ok, np.where(f, fhi, rhi), 0).astype(np.uint32)
    clo = np.where(ok, np.where(f, flo, rlo), 0).astype(np.uint32)
    return ok, chi, clo


def _codes_blocks(row, L: int, n: int):
    """The codes front end's blocks 0..n-1 of an int8 row: [n, 3] uint32
    (lo, hi, bad); bases past the read read as 0."""
    c = np.zeros(32 * n, np.uint8)
    c[:min(L, 32 * n)] = row[:32 * n].astype(np.uint8)
    c = c.reshape(n, 32).astype(np.uint64)
    j = np.arange(32, dtype=np.uint64)
    codes = ((c & U64(3)) << (U64(2) * j)).sum(1).astype(np.uint64)
    bad = ((c > U64(3)).astype(np.uint64) << j).sum(1)
    return np.stack([codes & U64(M32), codes >> U64(32), bad],
                    axis=1).astype(np.uint32)


def _packed_blocks(words, L: int, n: int):
    """The packed front end's blocks 0..n-1 of a wire row (uint32)."""
    w16, w32 = (L + 15) // 16, (L + 31) // 32
    out = np.zeros((n, 3), np.uint32)
    codes = np.zeros(2 * n, np.uint32)
    m = min(w16, 2 * n)
    codes[:m] = words[:m]
    out[:, 0], out[:, 1] = codes[0::2], codes[1::2]
    m = min(w32, n)
    out[:m, 2] = words[w16:w16 + m]
    return out


def _mix32(v):
    v = v ^ (v >> np.uint32(16))
    v = v * np.uint32(0x85EBCA6B)
    v = v ^ (v >> np.uint32(13))
    v = v * np.uint32(0xC2B2AE35)
    return v ^ (v >> np.uint32(16))


def _hash32(hi, lo):
    return _mix32(_mix32(lo ^ np.uint32(0x9E3779B9)) ^ hi)


def _rolling(codes_row, k: int, P: int):
    """(fwd, rc, ok) of every position by the rolling definition."""
    fwd, rc, ok = [], [], []
    for p in range(P):
        f = r = 0
        good = True
        for j in range(k):
            c = int(codes_row[p + j]) & 0xFF
            good &= c <= 3
            f = (f << 2) | (c & 3)
            r |= (3 - (c & 3)) << (2 * j)
        fwd.append(f)
        rc.append(r)
        ok.append(good)
    return fwd, rc, ok


def _ref(codes, k: int, w: int):
    """extract_kmers_jnp (+ select_minimizers_jnp) as int32 / bool."""
    hi, lo, valid = extract_kmers_jnp(jnp.asarray(codes), k)
    if w > 1:
        hi, lo, valid = select_minimizers_jnp(hi, lo, valid, w)
    return (np.asarray(hi).view(np.int32), np.asarray(lo).view(np.int32),
            np.asarray(valid))


@pytest.mark.parametrize("packed", [False, True], ids=["codes", "packed"])
@pytest.mark.parametrize("k", [1, 2, 16, 21, 31])
def test_stream_identities(k, packed):
    """Every position's k-mer from two stream words, as the kernel takes
    it (x, x ^ mask, pair reversal, the bad word), equals the rolling
    forward and reverse-complement registers, and its canonical value the
    reference's."""
    L = 150
    codes, rows = k1_edge_world(8, L, seed=k)
    P = L - k + 1
    n = -(-L // 32) + 2
    want_hi, want_lo, want_valid = _ref(codes, k, 1)
    lane = np.arange(32)
    kbits = U64((1 << k) - 1)
    for b in range(8):
        blocks = (_packed_blocks(rows[b], L, n) if packed
                  else _codes_blocks(codes[b], L, n))
        fwd, rc, ok = _rolling(codes[b], k, P)
        for p0 in range(0, P, 32):
            i = p0 // 32
            words = blocks[:, 0].astype(np.uint64) | (
                blocks[:, 1].astype(np.uint64) << U64(32))
            got_rc, got_fwd = _kmer64(words[i], words[i + 1], lane, k)
            bad = blocks[:, 2].astype(np.uint64)
            bad = bad[i] | (bad[i + 1] << U64(32))
            got_ok = ((bad >> lane.astype(np.uint64)) & kbits) == 0
            m = min(32, P - p0)
            for j in range(m):
                if ok[p0 + j]:
                    assert int(got_fwd[j]) == fwd[p0 + j]
                    assert int(got_rc[j]) == rc[p0 + j]
            assert got_ok[:m].tolist() == ok[p0:p0 + m]
            canon = np.where(got_ok, np.minimum(got_fwd, got_rc), U64(0))[:m]
            chi = (canon >> U64(32)).astype(np.uint32)
            clo = (canon & U64(M32)).astype(np.uint32)
            assert (chi.view(np.int32) == want_hi[b, p0:p0 + m]).all()
            assert (clo.view(np.int32) == want_lo[b, p0:p0 + m]).all()
            assert (got_ok[:m] == want_valid[b, p0:p0 + m]).all()
            # The kernel's 32-bit form of the same k-mer.
            ok32, chi32, clo32 = _kmer_at(blocks[i], blocks[i + 1], lane, k)
            assert (ok32[:m] == got_ok[:m]).all()
            assert (chi32[:m] == chi).all() and (clo32[:m] == clo).all()


def _walk(plan, B: int, NW: int) -> np.ndarray:
    """How often the kernel writes each (read, window): warp item v takes
    read v // tiles and windows [t * tile_windows, min(+tile_windows, NW))
    of tile t = v % tiles."""
    hits = np.zeros((B, NW), np.int64)
    for item in range(min(plan.grid * plan.warps, B * plan.tiles)):
        b, t = divmod(item, plan.tiles)
        w0 = t * plan.tile_windows
        assert w0 < NW
        hits[b, w0:min(w0 + plan.tile_windows, NW)] += 1
    return hits


@pytest.mark.parametrize("warps,sm_warps", [(8, 32), (2, 8), (4, 64)])
@pytest.mark.parametrize("B,L,k,w", [
    (1, 21, 21, 1), (3, 150, 21, 8), (5, 150, 31, 1), (7, 53, 21, 3),
    (2, 2000, 21, 32), (16384, 150, 21, 1), (16384, 150, 21, 8),
    (75, 16384, 21, 1), (64, 16384, 21, 1), (75, 16384, 21, 8),
    (4, 16384, 31, 3), (1, 16384, 1, 1)])
def test_k1_plan_covers_every_window_once(B, L, k, w, warps, sm_warps):
    """Every plan the sweep (kernels.extract_sweep) may take, too."""
    plan = k1_plan(B, L, k, w, SMS, warps, sm_warps)
    NW = probe_width(L, k, w)
    assert plan.tile_windows % 32 == 0 and plan.tile_windows >= 32
    assert (plan.tile_windows * w) % 32 == 0     # a tile starts a block
    assert 1 <= plan.warps <= warps
    assert plan.grid * plan.warps >= B * plan.tiles
    assert (plan.grid - 1) * plan.warps < B * plan.tiles
    assert (plan.tiles - 1) * plan.tile_windows < NW
    assert plan.tiles * plan.tile_windows >= NW
    if B * NW <= 3_000_000:
        assert (_walk(plan, B, NW) == 1).all()


@pytest.mark.parametrize("B,L,k,w", [(16384, 150, 21, 1),
                                     (16384, 150, 21, 8),
                                     (16384, 150, 31, 1),
                                     (75, 16384, 21, 1), (64, 16384, 21, 1),
                                     (64, 16384, 21, 8)])
def test_k1_plan_fills_the_card_at_the_main_paths_shapes(B, L, k, w):
    """The std world's and the headline's 16,384 reads of 150 bases, and
    a long-read bucket of 64-75 reads of 16,384 bases, give every SM
    blocks and at least half of K1_SM_WARPS warps, or tiles of one round
    (32 windows) where the reads hold fewer."""
    plan = k1_plan(B, L, k, w, SMS)
    assert plan.grid >= SMS
    assert (B * plan.tiles >= SMS * K1_SM_WARPS // 2
            or plan.tile_windows == 32)


def test_k1_cost_counts_the_function_not_the_design():
    """The std world's launch reads 16,384 x 150 B and writes 2,129,920 x
    9 B (21.6 MB); the headline's hashes 128 positions a read."""
    assert k1_cost(16384, 150, 21, 1, 150) == (21_626_880, 16384 * 130 * 12)
    assert k1_cost(16384, 150, 21, 8, 60) == (
        16384 * (60 + 9 * 16), 16384 * 16 * (8 * 30 + 7))


def test_k1_plan_refuses_bad_shapes():
    for args in ((4, 20, 21, 1), (4, 150, 0, 1), (4, 150, 32, 1),
                 (4, 150, 21, 0), (4, 30, 21, 16)):
        with pytest.raises(ValueError):
            k1_plan(*args, SMS)
    for warps, sm_warps in ((0, 32), (9, 32), (8, 0)):
        with pytest.raises(ValueError):
            k1_plan(4, 150, 21, 1, SMS, warps, sm_warps)
    assert k1_plan(0, 150, 21, 1, SMS).grid == 0


def _emulate(codes, rows, L: int, k: int, w: int, packed: bool, R: int,
             col0: int):
    """The kernel's walk (csrc/extract_probes.cu) in numpy, a warp's 32
    lanes as arrays: (hi, lo, valid) [B, R], 7 where unwritten."""
    B = codes.shape[0]
    NW = probe_width(L, k, w)
    plan = k1_plan(B, L, k, w, SMS)
    out = (np.full((B, R), 7, np.uint32), np.full((B, R), 7, np.uint32),
           np.zeros((B, R), bool))
    lane = np.arange(32)
    span = min(w, 32)
    aligned = w <= 32 and w & (w - 1) == 0
    n_blocks = -(-L // 32) + 4
    for item in range(B * plan.tiles):
        b, t = divmod(item, plan.tiles)
        win0 = t * plan.tile_windows
        win_end = min(win0 + plan.tile_windows, NW)
        blocks = (_packed_blocks(rows[b], L, n_blocks) if packed
                  else _codes_blocks(codes[b], L, n_blocks))
        p = win0 * w
        rem = lane % w
        for r0 in range(win0, win_end, 32):
            nwin = min(32, win_end - r0)
            end = (r0 + nwin) * w
            head = lane * w
            best_h = np.zeros(32, np.uint32)
            best_hi = np.zeros(32, np.uint32)
            best_lo = np.zeros(32, np.uint32)
            best_ok = np.ones(32, bool)
            while p < end:
                i = p // 32
                ok, chi, clo = _kmer_at(blocks[i], blocks[i + 1], lane, k)
                if aligned:
                    win = p // w + lane // w
                    store = win < win_end
                    wok = ok
                    if w > 1:
                        h = _hash32(chi, clo).reshape(-1, w)
                        g = h.min(axis=1, keepdims=True)
                        first = np.argmax(h == g, axis=1)
                        store &= (lane % w) == np.repeat(first, w)
                        wok = np.repeat(ok.reshape(-1, w).all(axis=1), w)
                    cols = col0 + win[store]
                    out[0][b, cols] = chi[store]
                    out[1][b, cols] = clo[store]
                    out[2][b, cols] = wok[store]
                else:
                    h = _hash32(chi, clo)
                    d = 1
                    while d < span:
                        src = np.minimum(lane + d, 31)   # shfl_down
                        oh, ohi, olo = h[src], chi[src], clo[src]
                        take = (lane + d < 32) & (rem + d < w) & (oh < h)
                        h = np.where(take, oh, h)
                        chi = np.where(take, ohi, chi)
                        clo = np.where(take, olo, clo)
                        d *= 2
                    mine = (head < 32) & (head + w > 0)
                    frm = np.where(mine, np.maximum(head, 0), lane)
                    oh, ohi, olo = h[frm], chi[frm], clo[frm]
                    n = np.minimum(head + w, 32) - frm
                    for j in np.flatnonzero(mine):
                        first = head[j] >= 0 or oh[j] < best_h[j]
                        if first:
                            best_h[j], best_hi[j], best_lo[j] = (
                                oh[j], ohi[j], olo[j])
                        best_ok[j] &= bool(ok[frm[j]:frm[j] + n[j]].all())
                    head = head - 32
                    rem = (rem + 32 % w) % w
                p += 32
            if not aligned:
                cols = col0 + r0 + np.arange(nwin)
                out[0][b, cols] = best_hi[:nwin]
                out[1][b, cols] = best_lo[:nwin]
                out[2][b, cols] = best_ok[:nwin]
    return out[0].view(np.int32), out[1].view(np.int32), out[2]


def _plain(src, L: int, k: int, w: int, R: int, col0: int, packed: bool):
    B = src.shape[0]
    out = (torch.full((B, R), 7, dtype=torch.int32),
           torch.full((B, R), 7, dtype=torch.int32),
           torch.zeros((B, R), dtype=torch.bool))
    extract_probes_plain(src, k, w, out, col0, packed_len=L if packed else 0)
    return [t.numpy() for t in out]


def _lengths(k: int):
    return (k, 31 + k, 32 + k, 33 + k)


_EMULATED = [(k, w, L) for k in (1, 21, 31) for w in (1, 3, 8, 32, 40, 64)
             for L in (*_lengths(k), 150) if (L - k + 1) // w > 0]


@pytest.mark.parametrize("packed", [False, True], ids=["codes", "packed"])
@pytest.mark.parametrize("k,w,L", _EMULATED)
def test_emulated_walk_matches_plain(k, w, L, packed):
    codes, rows = k1_edge_world(9, L, seed=k * 7 + w + L)
    NW = probe_width(L, k, w)
    R, col0 = NW + 5, 3
    want = _plain(torch.from_numpy(rows.view(np.int32)) if packed
                  else torch.from_numpy(codes), L, k, w, R, col0, packed)
    got = _emulate(codes, rows, L, k, w, packed, R, col0)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", [1, 8, 32])
def test_emulated_walk_matches_plain_on_a_long_read(w):
    """One read of 16,384 bases in tiles (the plan's cut at few reads)."""
    L, k = 16384, 21
    codes, rows = k1_edge_world(2, L, seed=w)
    NW = probe_width(L, k, w)
    assert k1_plan(2, L, k, w, SMS).tiles > 1
    for packed in (False, True):
        want = _plain(torch.from_numpy(rows.view(np.int32)) if packed
                      else torch.from_numpy(codes), L, k, w, NW + 1, 1,
                      packed)
        got = _emulate(codes, rows, L, k, w, packed, NW + 1, 1)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


_EDGE = [(k, w, L) for k in (1, 21, 31) for w in (1, 3, 8, 32)
         for L in (*_lengths(k), 16384) if (L - k + 1) // w > 0]


@pytest.mark.parametrize("k,w,L", _EDGE)
def test_plain_matches_reference_on_edge_worlds(k, w, L):
    """extract_probes_plain on the codes and on wire rows taken as a
    column slice of a wider batch, written at col0 > 0, equals the JAX
    package's extraction and minimizers of the same codes."""
    B = 9 if L < 16384 else 3
    codes, rows = k1_edge_world(B, L, seed=L + k + w)
    assert (codes < 0).any() and (L <= 31 or (codes[1:6] == 4).any())
    want = _ref(codes, k, w)
    NW = want[0].shape[1]
    assert NW == probe_width(L, k, w)
    R, col0 = NW + 7, 5
    W = wire_width(L)
    wide = np.zeros((B, 2 * W + 3), np.uint32)
    wide[:, W + 2:2 * W + 2] = rows
    wide[:, :W + 2] = 0xDEADBEEF
    part = torch.from_numpy(wide.view(np.int32))[:, W + 2:2 * W + 2]
    for src, packed in ((torch.from_numpy(codes), False), (part, True)):
        got = _plain(src, L, k, w, R, col0, packed)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g[:, col0:col0 + NW], x)
        assert (got[0][:, :col0] == 7).all() and (got[0][:, col0 + NW:]
                                                  == 7).all()


def test_edge_world_plants_its_edges():
    codes, rows = k1_edge_world(9, 150, seed=1)
    for i, p in enumerate(EDGE_POSITIONS):
        assert codes[1 + i, p] == 4 and codes[5, p] == 4
    assert codes[6, 0] == -1 and codes[7, 149] == -128
    bad = rows[:, (150 + 15) // 16:]
    for p in EDGE_POSITIONS:
        assert (bad[5, p // 32] >> np.uint32(p % 32)) & 1
