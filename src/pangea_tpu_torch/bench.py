"""The synthetic bench worlds of the classify path.

Counterpart of ``pangea_tpu/bench.py`` ``make_bench_world``: the config-2
scale world (two phyla of 8 genera of 3 species, 50 kb genomes whose genus
mates share a core, paired 150 bp reads with planted truth), drawn from the
same seeds, so its first ``n_reads`` pairs are the reference bench's and
its index (auto bucket width) is the reference's at the same window. It
differs in three ways: the index is built at the minimizer window ``w`` the
port classifies with, no world is cached on disk, and only as many pairs
are drawn as asked for.

``tree=(genera_per_phylum, species_per_genus)`` hangs the same genomes on a
larger two-phylum tree: the first 3 species of the first 8 genera of each
phylum carry them, so the sequences, reads and k-mers are the bench's and
only the taxon ids and the tree around them change. ``tree=(512, 64)`` is a
66,563-taxon tree, whose Euler stamps exceed 16 bits (the std layout with
wide rows and binary-lifting LCA); ``tree=(64, 40)`` has 5,251 taxa (q8
with lifting).

``long_read_mix`` adds single-end genome slices of log-uniform length to
a world's short reads, for the long-read path.

``make_multik_world`` is config 4's world: one genome set and one taxonomy
(the bench's species and seeds, at 64 kb genomes) indexed at several (k, w),
k=21, w=8 and k=31, w=1 by default. At that size the k=31, w=1 index has
2,559,507 k-mers, past the 2,097,152 that a std table in the reference's
fast regime holds, so ``pick_layout`` gives it q12; the k=21 index is q8.

``score_world`` makes scorer inputs with a chosen number U of distinct
(t_in, t_out) intervals among each read's hits, along one lineage or from
unrelated taxa; ``chain_taxonomy`` is a lineage deep enough for nested
worlds of any U.

``k1_edge_world`` makes K1's edge reads: codes with N at the stream's
block edges (positions 31, 32, 63, 64), codes below 0, and the same reads
as wire rows (``pack_wire``) whose bad bases and tails carry junk.

``k2_edge_world`` makes K2's edge tables, q8 and q12, laid out by hand
at chosen remainder widths (q12 at r = 0, 20, 32, 54 and 62, q8 at r = 0
and 22-25), with rows where several slots share a rem_lo or a whole key,
forced stashes (W = 4) and stashes past the kernel's shared-memory cap,
and the probes that reach them: every key, near misses and absent keys.

``k9_edge_world`` makes K9's and K10's edge cases: probe counts around
their tiles (0, 1, 33, a tile and one either side, past three tiles), every
valid probe on one key or one owner, every probe invalid, K9's keys at
NB = 2^9 (shift 0) and 2^22 (shift 12) and the k = 31 q12 and std rules,
K10 at 1 to 4,096 owners and at one slot an owner; ``route_bin_dirty``
runs K10 on a grid filled with -1 first, so that a slot it leaves
unwritten shows.

``cohort_fastq`` writes config 5's pooled cohort: the bulk generator's
barcoded single-end reads (``gen-testdata --bulk --n-samples``'s barcodes
and N rate), with phred qualities that fall toward the 3' end and planted
barcode errors, for trimming and demultiplexing.

``make_deep_world`` is the reference bench's deep cell
(``pangea_tpu/bench.py`` ``run_bench_extras``, lines 415-455): the first 24
genomes of 700 kb on a 2 x 8 x 3 tree (seeds 31 and 32), single-end 150 bp
reads (seed 33) and a k=21, w=1 index at 16 ways: 13,999,769 k-mers, whose
q8 table has 524,288 rows, past the deep-table gate. ``deep_genomes`` and
``deep_reads`` give its genomes and reads without the index.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .index import Index, build_index
from .index.container import EMPTY_HI
from .core.semantics import hash32_np
from .index.quot import Q8_A, Q8_WAYS, Q12_WAYS
from .kernels.lookup import BIN_TILE, KEY_BITS
from .taxonomy import Taxonomy
from .utils import datagen


@dataclass
class BenchWorld:
    taxonomy: Taxonomy
    index: Index
    reads: datagen.ReadSet        # paired worlds: reads.mates holds mate 2
    genomes: list                 # (codes uint8, species taxon) a genome


@dataclass
class MultiKWorld:
    taxonomy: Taxonomy
    indexes: list                 # one Index a (k, w), in the given order
    reads: datagen.ReadSet        # paired: reads.mates holds mate 2


def _bench_genomes(n_species: int, genome_len: int, seed: int,
                   tree: tuple[int, int] | None):
    """The bench's taxonomy (or ``tree``) and genomes."""
    per_genus = 3
    genera = max(n_species // per_genus // 2, 1)
    if tree is None:
        tax = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=genera,
                                    species_per_genus=per_genus, seed=seed)
    else:
        if tree[0] < genera or tree[1] < per_genus:
            raise ValueError(f"tree {tree} is smaller than the bench's "
                             f"{genera} genera x {per_genus} species")
        tax = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=tree[0],
                                    species_per_genus=tree[1], seed=seed)
        ids = {name: t for t, name in enumerate(tax.names)}
        tax.species_ids = [ids[f"Species_{p}_{g}_{s}"] for p in range(2)
                           for g in range(genera) for s in range(per_genus)]
    return tax, datagen.make_genomes(tax, genome_len=genome_len,
                                     seed=seed + 1)


def _bench_reads(genomes, n_reads: int, read_len: int, seed: int):
    return datagen.sample_reads(genomes, n_reads, read_len=read_len,
                                paired=True, n_prob=0.005, seed=seed + 2)


def make_bench_world(n_reads: int = 100_000, read_len: int = 150,
                     n_species: int = 48, genome_len: int = 50_000,
                     k: int = 21, w: int = 8, seed: int = 0,
                     tree: tuple[int, int] | None = None) -> BenchWorld:
    """The bench world with its index at (k, w) and n_reads read pairs, on
    the bench's own tree or on ``tree`` (see the module docstring)."""
    tax, genomes = _bench_genomes(n_species, genome_len, seed, tree)
    idx = build_index(genomes, tax, k=k, w=w, ways=0)
    return BenchWorld(tax, idx, _bench_reads(genomes, n_reads, read_len,
                                             seed), genomes)


def make_multik_world(n_reads: int = 100_000, read_len: int = 150,
                      n_species: int = 48, genome_len: int = 64_000,
                      indexes=((21, 8), (31, 1)),
                      seed: int = 0) -> MultiKWorld:
    """Config 4's world: the bench's genomes (at ``genome_len``) and
    n_reads read pairs, indexed once for each (k, w) of ``indexes``."""
    tax, genomes = _bench_genomes(n_species, genome_len, seed, None)
    idxs = [build_index(genomes, tax, k=k, w=w, ways=0) for k, w in indexes]
    return MultiKWorld(tax, idxs, _bench_reads(genomes, n_reads, read_len,
                                               seed))


def long_read_mix(reads: datagen.ReadSet, n_short: int, genomes,
                  n_long: int, min_len: int, max_len: int,
                  seed: int) -> datagen.ReadSet:
    """Single-end reads for the long-read path: the first ``n_short``
    first mates of ``reads``, then ``n_long`` slices of the genomes (a
    genome and an offset uniform, the length log-uniform over [min_len,
    max_len] bases, capped at the genome's) with their genome's taxon as
    truth and ids long0, long1, ..."""
    rng = np.random.default_rng(seed)
    seqs, truth = list(reads.seqs[:n_short]), list(reads.truth[:n_short])
    for _ in range(n_long):
        codes, taxon = genomes[rng.integers(0, len(genomes))]
        n = min(int(np.exp(rng.uniform(np.log(min_len), np.log(max_len)))),
                len(codes))
        s = int(rng.integers(0, len(codes) - n + 1))
        seqs.append(np.asarray(codes[s:s + n], dtype=np.uint8))
        truth.append(taxon)
    return datagen.ReadSet(
        ids=list(reads.ids[:n_short]) + [f"long{i}" for i in range(n_long)],
        seqs=seqs, mates=None, truth=np.asarray(truth, np.int32))


def write_fastq_pair(reads: datagen.ReadSet, path1: str, path2: str) -> None:
    """Mate 1 and mate 2 of a paired read set as two FASTQ files."""
    datagen.write_fastq(path1, reads, mate=1)
    datagen.write_fastq(path2, reads, mate=2)


def deep_genomes(genome_len: int = 700_000):
    """The deep cell's taxonomy and its first 24 genomes."""
    tax = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=8,
                                species_per_genus=3, seed=31)
    return tax, datagen.make_genomes(tax, genome_len=genome_len, seed=32)[:24]


def deep_reads(genomes, n_reads: int, read_len: int = 150):
    """The deep cell's single-end reads."""
    return datagen.sample_reads(genomes, n_reads, read_len=read_len,
                                paired=False, n_prob=0.005, seed=33)


def cohort_barcodes(n_samples: int) -> list:
    """The 8-base barcodes ``gen-testdata --n-samples`` gives sample0,
    sample1, ... (distinct, Hamming-separated by construction)."""
    return ["".join("ACGT"[(i >> (2 * j)) & 3] for j in range(4)) * 2
            for i in range(n_samples)]


def cohort_fastq(path: str, genomes, n_reads: int, n_samples: int = 4,
                 read_len: int = 150, seed: int = 51,
                 slope=(0.05, 0.35), noise: float = 3.0,
                 bc_errors: float = 0.1, bc_unmatched: float = 0.05,
                 chunk: int = 1 << 17) -> list:
    """A pooled cohort of n_reads single-end reads of the genomes (the bulk
    generator, seed ``seed``, N at 0.005), each behind one of
    ``cohort_barcodes(n_samples)`` (``path``.samples.npy, and the source
    taxa in ``path``.truth.npy), then changed in place from the generator
    of seed + 1: each read's phred qualities fall from 40 by a slope drawn
    from ``slope`` a base, with normal noise, clipped to 2-41; a share
    bc_errors of the reads has one barcode base changed to another base, a
    further bc_unmatched a barcode of random bases. Returns the barcodes."""
    barcodes = cohort_barcodes(n_samples)
    datagen.generate_reads_fastq_bulk(path, genomes, n_reads,
                                      read_len=read_len, n_prob=0.005,
                                      seed=seed, barcodes=barcodes)
    with open(path, "rb") as fh:             # fixed-width records
        head, seq = fh.readline(), fh.readline()
    h, n = len(head), len(seq) - 1
    rec = np.memmap(path, np.uint8, "r+", shape=(n_reads, h + 2 * n + 4))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    code = np.zeros(256, np.int64)
    code[acgt] = np.arange(4)
    m = len(barcodes[0])
    rng = np.random.default_rng(seed + 1)
    for lo in range(0, n_reads, chunk):
        r = rec[lo:lo + chunk]
        B = r.shape[0]
        q = 40 - rng.uniform(*slope, (B, 1)) * np.arange(n) \
            + rng.normal(0, noise, (B, n))
        r[:, h + n + 3:h + 2 * n + 3] = np.clip(q, 2, 41).astype(np.uint8) \
            + 33
        u = rng.random(B)
        bc = r[:, h:h + m]
        err = np.flatnonzero(u < bc_errors)
        pos = rng.integers(0, m, err.size)
        bc[err, pos] = acgt[(code[bc[err, pos]]
                             + rng.integers(1, 4, err.size)) % 4]
        unm = (u >= bc_errors) & (u < bc_errors + bc_unmatched)
        bc[unm] = acgt[rng.integers(0, 4, (int(unm.sum()), m))]
        r[:, h:h + m] = bc
    rec.flush()
    del rec
    return barcodes


def make_deep_world(n_reads: int = 16_384, read_len: int = 150,
                    genome_len: int = 700_000) -> BenchWorld:
    """The deep cell (single-end reads) with its k=21, w=1 index at the
    default 16 ways, as the reference bench builds it (and as ``pangea-tpu
    build --k 21`` does)."""
    tax, genomes = deep_genomes(genome_len)
    idx = build_index(genomes, tax, k=21, w=1)
    return BenchWorld(tax, idx, deep_reads(genomes, n_reads, read_len),
                      genomes)


def chain_taxonomy(n: int) -> Taxonomy:
    """A chain of n taxa (1 the root, t + 1 the child of t): one lineage
    of depth n - 1, for nested scorer worlds of large U."""
    parent = [0, 1] + list(range(1, n))
    return Taxonomy(parent=parent, rank=[0] * (n + 1),
                    names=["unclassified"] + [f"n{i}" for i in range(n)])


# score_world: the share of hits whose lane names another taxon than their
# interval's (lanes that differ at one t_in), and the range of the t_in and
# t_out that misses carry (never read by a scorer).
RELABEL_SHARE = 1 / 8
MISS_NOISE = 1 << 20


def score_world(tax: Taxonomy, B: int, R: int, U: int | None, nested: bool,
                miss_share: float = 0.5, seed: int = 0):
    """Scorer inputs of B reads of R probes, as a lookup hands them over:
    (lanes, t_in, t_out) int32 [B, R], hit taxa and their Euler intervals,
    and valid bool [B, R]. Each read's hits, R - round(miss_share * R) of
    them at random positions, carry exactly U distinct (t_in, t_out)
    intervals, every one at least once (U None: every hit its own; U 0: no
    hit at all). The intervals are those of U taxa: a taxon and its U - 1
    nearest ancestors when ``nested`` (a lineage, as real reads hit a leaf
    and its ancestors; needs a taxon of depth U - 1, see
    :func:`chain_taxonomy`), else U distinct taxa drawn uniformly. A share
    RELABEL_SHARE of the hits keeps its interval but names another taxon
    in its lane, so that lanes differ at one t_in (the winners' ties at
    tin_u and tin_v). Misses have lane 0 and random t_in and t_out; hits
    are valid, misses valid at random. Read 0 has no hit and read 1 no
    valid probe."""
    rng = np.random.default_rng(seed)
    T = tax.num_taxa
    hits = R - int(round(miss_share * R))
    if U is None:
        U = hits
    if not 0 <= hits <= R or not 0 <= U <= hits:
        raise ValueError(f"R={R}, miss_share={miss_share}, U={U}: a read "
                         f"has {hits} hits")
    if U == 0:
        hits = 0
    lanes = np.zeros((B, R), np.int32)
    t_in = rng.integers(-MISS_NOISE, MISS_NOISE, (B, R)).astype(np.int32)
    t_out = rng.integers(-MISS_NOISE, MISS_NOISE, (B, R)).astype(np.int32)
    if hits:
        if nested:
            cands = np.flatnonzero(tax.depth[1:] >= U - 1) + 1
            if cands.size == 0:
                raise ValueError(f"no lineage of {U} taxa: the deepest "
                                 f"taxon has depth {tax.depth.max()}")
            taxa = np.empty((B, U), np.int64)
            taxa[:, 0] = cands[rng.integers(0, cands.size, B)]
            for j in range(1, U):
                taxa[:, j] = tax.parent[taxa[:, j - 1]]
        else:
            if U > T:
                raise ValueError(f"U={U} distinct taxa of {T}")
            taxa = rng.integers(1, T + 1, (B, U))
            for b in range(B):
                if np.unique(taxa[b]).size < U:
                    taxa[b] = rng.choice(np.arange(1, T + 1), U,
                                         replace=False)
        pos = np.argsort(rng.random((B, R)), axis=1)[:, :hits]
        which = np.concatenate(
            [np.argsort(rng.random((B, U)), axis=1),
             rng.integers(0, U, (B, hits - U))], axis=1)
        hit_taxa = np.take_along_axis(taxa, which, axis=1)
        rows = np.arange(B)[:, None]
        lanes[rows, pos] = hit_taxa
        t_in[rows, pos] = tax.tin[hit_taxa]
        t_out[rows, pos] = tax.tout[hit_taxa]
        relabel = rng.random((B, hits)) < RELABEL_SHARE
        lanes[rows, pos] = np.where(relabel,
                                    rng.integers(1, T + 1, (B, hits)),
                                    hit_taxa)
        lanes[0] = 0
    valid = (lanes != 0) | (rng.random((B, R)) < 0.5)
    if B > 1:
        valid[1] = False
    return lanes, t_in, t_out, valid


# K1's edge worlds: the positions where a pass's blocks of 32 bases meet.
EDGE_POSITIONS = (31, 32, 63, 64)


def pack_wire(codes: np.ndarray, junk_seed: int | None = None) -> np.ndarray:
    """The native reader's wire rows (uint32 [B, ceil(L/16) + ceil(L/32)])
    of int8 codes [B, L]: base j's 2-bit code at bits [2(j%16), +2) of word
    j//16, its bad flag (code < 0 or > 3) at bit j%32 of word ceil(L/16) +
    j//32, bases past L bad. With ``junk_seed``, the 2-bit codes of the bad
    bases and of the tail, and the tail's bad flags, are random: every
    k-mer over them is invalid or past the read either way."""
    B, L = codes.shape
    w16, w32 = (L + 15) // 16, (L + 31) // 32
    bad = np.ones((B, w32 * 32), bool)
    bad[:, :L] = (codes < 0) | (codes > 3)
    c2 = np.zeros((B, w16 * 16), np.uint64)
    c2[:, :L] = codes.astype(np.uint8) & 3
    if junk_seed is not None:
        rng = np.random.default_rng(junk_seed)
        junk = rng.integers(0, 4, c2.shape).astype(np.uint64)
        c2 = np.where(bad[:, :w16 * 16], junk, c2)
        bad[:, L:] = rng.random((B, w32 * 32 - L)) < 0.5
    words = (c2.reshape(B, w16, 16)
             << (2 * np.arange(16, dtype=np.uint64))).sum(axis=2)
    bwords = (bad.reshape(B, w32, 32).astype(np.uint64)
              << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return np.concatenate([words, bwords], axis=1).astype(np.uint32)


def k1_edge_world(B: int, L: int, seed: int = 0):
    """K1's edge reads: (codes int8 [B, L], wire rows uint32 [B, W]).
    Random bases with 1 % N; read 1 + i has N at EDGE_POSITIONS[i] (where
    it lies in the read) and read 5 at all four; read 6 has code -1 at 0
    and L // 2, read 7 code -128 at L - 1 (the last read where B is
    smaller); read 0 is clean. The rows are
    ``pack_wire`` of the codes, with junk where it cannot matter."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[1:][rng.random((B - 1, L)) < 0.01] = 4
    for i, p in enumerate(EDGE_POSITIONS):
        if p < L:
            codes[min(1 + i, B - 1), p] = 4
            codes[min(5, B - 1), p] = 4
    codes[min(6, B - 1), [0, L // 2]] = -1
    codes[min(7, B - 1), L - 1] = -128
    return codes, pack_wire(codes, junk_seed=seed + 1)


# K2's edge tables: name -> (q12, k, log2 NB, ways, keys, stash columns
# added past the overflow). r = 2k - log2 NB.
K2_EDGE = {
    "q12_r0": (True, 5, 10, Q12_WAYS, 300, 0),
    "q12_r20": (True, 13, 6, Q12_WAYS, 1500, 0),
    "q12_r32": (True, 17, 2, Q12_WAYS, 120, 0),
    "q12_r54": (True, 31, 8, Q12_WAYS, 5000, 0),
    "q12_r62": (True, 31, 0, Q12_WAYS, 40, 0),
    "q12_w4_stash": (True, 21, 6, 4, 400, 0),
    "q12_stash_3000": (True, 31, 6, Q12_WAYS, 1500, 3000),
    "q8_r0": (False, 5, 10, Q8_WAYS, 300, 0),
    "q8_r22": (False, 15, 8, Q8_WAYS, 6000, 0),
    "q8_w4_stash": (False, 15, 5, 4, 300, 0),
    "q8_stash_3000": (False, 15, 6, Q8_WAYS, 2000, 3000),
}
NEAR_ROWS = 40            # rows given a shared rem_lo and a repeated key


def k2_edge_world(name: str, seed: int = 0) -> dict:
    """K2's edge table ``name`` of K2_EDGE, all uint32 arrays but valid:
    ``hi``, ``lo`` and ``valid`` (bool) of the probes, ``fused`` [NB, 2W]
    (q8) or [NB, 3W padded to a power of two] (q12) and ``stash`` [5, S],
    with ``k``, ``ways`` and ``q12``.

    The keys are placed in their buckets' slots in order, the overflow
    going to the stash; empty slots hold the layouts' sentinels (q8 rem
    EMPTY_HI; q12 rem_lo 0, rem_hi EMPTY_HI). In NEAR_ROWS rows with free
    slots, one free slot repeats slot 0's whole key with another payload
    (two slots match: the payload sum wraps) and, q12, another repeats its
    rem_lo with another rem_hi. Payloads and the stash's rows 2-4 are
    random 32-bit words. The extra stash columns are half keys of the
    rows, half fresh keys. The probes are every key, the fresh stash keys,
    a near miss of each of the first 2,000 keys (the mix's bit 32 flipped
    where r > 32, else bit 0) and 500 random keys, shuffled, 9 in 10
    valid."""
    q12, k, log2nb, ways, n_keys, extra = K2_EDGE[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    m, nb = 2 * k, 1 << log2nb
    r = m - log2nb
    mask = np.uint64((1 << m) - 1)
    inv = np.uint64(pow(int(Q8_A), -1, 1 << m))

    def unmix(h):
        return (h * inv) & mask

    keys = rng.choice(1 << m, n_keys, replace=False).astype(np.uint64)
    h = (keys * Q8_A) & mask
    bucket = (h >> np.uint64(r)).astype(np.int64)
    rem = h & np.uint64((1 << r) - 1)
    order = np.argsort(bucket, kind="stable")
    b = bucket[order]
    rank = np.arange(n_keys) - np.searchsorted(b, b)
    placed = rank < ways
    lanes = 1 << (3 * ways - 1).bit_length() if q12 else 2 * ways
    fused = np.zeros((nb, lanes), np.uint32)
    if q12:
        fused[:, ways:2 * ways] = EMPTY_HI
    else:
        fused[:, :ways] = EMPTY_HI
    pay = (2 if q12 else 1) * ways
    rows, slots = b[placed], rank[placed]
    prem = rem[order][placed]
    fused[rows, slots] = (prem & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if q12:
        fused[rows, ways + slots] = (prem >> np.uint64(32)).astype(np.uint32)
    fused[rows, pay + slots] = rng.integers(0, 1 << 32, rows.size,
                                            dtype=np.uint64)
    count = np.bincount(rows, minlength=nb)
    for row in np.flatnonzero((count > 0) & (count <= ways - 2))[:NEAR_ROWS]:
        free = count[row]
        fused[row, free] = fused[row, 0]
        if q12:
            fused[row, ways + free] = fused[row, ways]
            fused[row, free + 1] = fused[row, 0]
            fused[row, ways + free + 1] = fused[row, ways] ^ np.uint32(1)
        fused[row, pay + free] = rng.integers(0, 1 << 32, dtype=np.uint64)
    over = keys[order][~placed]
    take = rng.choice(n_keys, extra // 2, replace=False)
    fresh = rng.choice(1 << m, extra - take.size).astype(np.uint64)
    skeys = np.concatenate([over, keys[take], fresh])
    stash = np.concatenate([
        (skeys >> np.uint64(32)).astype(np.uint32)[None],
        (skeys & np.uint64(0xFFFFFFFF)).astype(np.uint32)[None],
        rng.integers(0, 1 << 32, (3, skeys.size), dtype=np.uint64)
        .astype(np.uint32)])
    flip = np.uint64(1 << 32) if r > 32 else np.uint64(1)
    probes = rng.permutation(np.concatenate([
        keys, fresh, unmix(h[:2000] ^ flip),
        rng.integers(0, 1 << m, 500, dtype=np.uint64)]))
    return {"hi": (probes >> np.uint64(32)).astype(np.uint32),
            "lo": (probes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            "valid": rng.random(probes.size) < 0.9, "fused": fused,
            "stash": stash, "k": k, "ways": ways, "q12": q12}


# K9's and K10's edge cases: name -> (probes, rule, size, valid share,
# skew). K9 ("sort"): size (NB, k), k None for the std rule; K10
# ("route"): size (S, C), C None for route_capacity's. skew: every valid
# probe on one key (K9, the q8/q12 rule) or one owner (K10).
_DEEP = (1 << 19, 21)
_PAST = 3 * BIN_TILE + 33
K9_EDGE = {
    "sort_n0": (0, "sort", _DEEP, 0.9, False),
    "sort_n1": (1, "sort", _DEEP, 0.9, False),
    "sort_n33": (33, "sort", _DEEP, 0.9, False),
    "sort_tile_less_1": (BIN_TILE - 1, "sort", _DEEP, 0.9, False),
    "sort_tile": (BIN_TILE, "sort", _DEEP, 0.9, False),
    "sort_tile_plus_1": (BIN_TILE + 1, "sort", _DEEP, 0.9, False),
    "sort_past_3_tiles": (_PAST, "sort", _DEEP, 0.9, False),
    "sort_one_key": (_PAST, "sort", _DEEP, 1.0, True),
    "sort_invalid": (_PAST, "sort", _DEEP, 0.0, False),
    "sort_nb_2_9": (_PAST, "sort", (1 << 9, 21), 0.9, False),
    "sort_nb_2_22": (_PAST, "sort", (1 << 22, 21), 0.9, False),
    "sort_q12_k31": (_PAST, "sort", (1 << 20, 31), 0.9, False),
    "sort_std": (_PAST, "sort", (1 << 20, None), 0.9, False),
    "route_n0": (0, "route", (4, 16), 0.9, False),
    "route_s1": (_PAST, "route", (1, None), 0.9, False),
    "route_s2": (_PAST, "route", (2, None), 0.9, False),
    "route_s4": (_PAST, "route", (4, None), 0.9, False),
    "route_s8": (_PAST, "route", (8, None), 0.9, False),
    "route_s4096": (_PAST, "route", (4096, None), 0.9, False),
    "route_c1": (_PAST, "route", (4, 1), 0.9, False),
    "route_one_owner": (_PAST, "route", (4, None), 0.9, True),
    "route_invalid": (_PAST, "route", (4, None), 0.0, False),
}


def k9_edge_world(name: str, seed: int = 0) -> dict:
    """K9's or K10's edge case ``name`` of K9_EDGE: ``hi``, ``lo`` (uint32)
    and ``valid`` (bool) of the probes, with ``kind`` ("sort" or
    "route"), and ``nb`` and ``k`` (K9) or ``n_shards`` and ``cap`` (K10;
    cap None: the caller's route_capacity). The probes are random 2k-bit
    k-mers (k = 21 for K10), each valid at the case's share. K9's skew
    draws the mixes h of one key's buckets and unmixes them (K = h / A mod
    2^2k); K10's keeps the random k-mers that hash32 sends to owner 1."""
    n, kind, (size, arg), share, skew = K9_EDGE[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    k = arg if kind == "sort" and arg is not None else 21
    m = 2 * k
    if kind == "sort" and skew:
        log2nb = size.bit_length() - 1
        low = m - min(log2nb, KEY_BITS)      # bits below the key
        h = ((np.uint64((1 << min(log2nb, KEY_BITS)) // 3) << np.uint64(low))
             | rng.integers(0, 1 << low, n, dtype=np.uint64))
        kmers = (h * np.uint64(pow(int(Q8_A), -1, 1 << m))) & np.uint64(
            (1 << m) - 1)
    elif kind == "route" and skew:
        log2s = size.bit_length() - 1
        cand = rng.integers(0, 1 << m, 8 * n + 64, dtype=np.uint64)
        owner = hash32_np(cand) >> np.uint32(32 - log2s)
        kmers = cand[owner == 1][:n]
    else:
        kmers = rng.integers(0, 1 << m, n, dtype=np.uint64)
    out = {"hi": (kmers >> np.uint64(32)).astype(np.uint32),
           "lo": (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32),
           "valid": rng.random(n) < share, "kind": kind}
    if kind == "sort":
        out.update(nb=size, k=arg)
    else:
        out.update(n_shards=size, cap=arg)
    return out


def route_bin_dirty(hi, lo, valid, n_shards: int, cap: int):
    """K10 on CUDA tensors through its C entry, as ``route_bin`` launches
    it, on outputs filled first with -1 (every slot of the grid) and -2
    (inv): a slot or an inv the kernel leaves unwritten shows. Returns
    (records, inv, counts) as ``route_bin`` does; the launch is not
    counted."""
    import torch
    from .kernels import _build
    dev = hi.device
    counts = torch.empty(n_shards, dtype=torch.int32, device=dev)
    records = torch.full((n_shards * cap, 4), -1, dtype=torch.int32,
                         device=dev)
    inv = torch.full((hi.numel(),), -2, dtype=torch.int32, device=dev)
    _build.launch("pangea_route_bin", dev, hi.data_ptr(), lo.data_ptr(),
                  valid.data_ptr(), hi.numel(), n_shards.bit_length() - 1,
                  cap, counts.data_ptr(), records.data_ptr(), inv.data_ptr())
    return records, inv, counts


def distinct_intervals(lanes, t_in, t_out) -> np.ndarray:
    """[B] number of distinct (t_in, t_out) pairs among each read's hits
    (lane != 0)."""
    key = (t_in.astype(np.int64) << 32) | (t_out.astype(np.int64)
                                           & 0xFFFFFFFF)
    key = np.where(lanes != 0, key, np.iinfo(np.int64).min)
    key = np.sort(key, axis=1)
    fresh = np.diff(key, axis=1, prepend=np.iinfo(np.int64).min) != 0
    return ((key != np.iinfo(np.int64).min) & fresh).sum(1)
