"""Taxonomy store, numpy only.

The port's copy of ``pangea_tpu/taxonomy/taxonomy.py``: the tree as dense
int32/int8 arrays (``parent``, ``rank``, ``depth``, Euler-tour ``tin`` and
``tout``), so that ancestor queries are two comparisons (SEMANTICS.md §6).
Taxon ids are dense 1..T; 0 is "unclassified". Loadable from a 4-column
TSV (``taxid  parent  rank  name``) or NCBI ``nodes.dmp``/``names.dmp``
(remapped to dense ids), and saved as the ``taxonomy.npz`` an index
directory carries. ``content_hash`` binds an index to its taxonomy, so it
must come out equal to the reference's; ``tests/test_torch_host.py`` checks
that and every array.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

# SEMANTICS.md §6 rank codes (frozen).
RANK_NAMES = [
    "no_rank", "root", "superkingdom", "phylum", "class",
    "order", "family", "genus", "species", "strain",
]
RANK_CODES = {name: i for i, name in enumerate(RANK_NAMES)}
# Common NCBI aliases → frozen codes.
_RANK_ALIASES = {
    "domain": "superkingdom", "kingdom": "superkingdom",
    "subspecies": "strain", "serotype": "strain", "no rank": "no_rank",
}


@dataclass
class Taxonomy:
    """Dense-array taxonomy. Index 0 is the unclassified sentinel."""

    parent: np.ndarray   # int32[T+1]; parent[1] == 1 (root), parent[0] == 0
    rank: np.ndarray     # int8[T+1], codes into RANK_NAMES
    names: list[str]     # len T+1; names[0] == "unclassified"
    depth: np.ndarray = field(init=False)   # int32[T+1]; depth[1] == 0
    tin: np.ndarray = field(init=False)     # int32[T+1] Euler entry
    tout: np.ndarray = field(init=False)    # int32[T+1] Euler exit

    def __post_init__(self):
        self.parent = np.asarray(self.parent, dtype=np.int32)
        self.rank = np.asarray(self.rank, dtype=np.int8)
        T = self.parent.shape[0] - 1
        if T < 1 or self.parent[1] != 1:
            raise ValueError("taxonomy must have root id 1 with parent[1]==1")
        self._build_euler(T)

    def _build_euler(self, T: int) -> None:
        # Children in ascending id order (SEMANTICS.md §6): bucket by parent.
        kids: list[list[int]] = [[] for _ in range(T + 1)]
        for t in range(2, T + 1):
            p = int(self.parent[t])
            if not (1 <= p <= T):
                raise ValueError(f"taxon {t} has invalid parent {p}")
            kids[p].append(t)  # ascending because t iterates ascending
        tin = np.zeros(T + 1, dtype=np.int32)
        tout = np.zeros(T + 1, dtype=np.int32)
        depth = np.zeros(T + 1, dtype=np.int32)
        # Iterative DFS from root; timestamps over real nodes only.
        timer = 0
        stack: list[tuple[int, int]] = [(1, 0)]  # (node, child cursor)
        depth[1] = 0
        tin[1] = timer
        timer += 1
        while stack:
            node, cursor = stack[-1]
            if cursor < len(kids[node]):
                stack[-1] = (node, cursor + 1)
                child = kids[node][cursor]
                depth[child] = depth[node] + 1
                tin[child] = timer
                timer += 1
                stack.append((child, 0))
            else:
                tout[node] = timer
                stack.pop()
        if timer != T:
            unreach = [t for t in range(1, T + 1) if tout[t] == 0 and t != 1]
            raise ValueError(
                f"taxonomy has {T - timer} nodes unreachable from root, "
                f"e.g. {unreach[:5]}"
            )
        # Sentinel 0: empty interval so it is never an ancestor of anything.
        tin[0], tout[0] = np.int32(-1), np.int32(-1)
        self.depth, self.tin, self.tout = depth, tin, tout

    @property
    def num_taxa(self) -> int:
        return self.parent.shape[0] - 1

    def is_ancestor_or_self(self, a, t):
        """Vectorized ancestor-or-self test per SEMANTICS.md §6."""
        a = np.asarray(a)
        t = np.asarray(t)
        return (self.tin[a] <= self.tin[t]) & (self.tin[t] < self.tout[a])

    def lca(self, a: int, b: int) -> int:
        """LCA of two taxa by walking up; 0 acts as identity (SEMANTICS.md
        §6)."""
        if a == 0:
            return int(b)
        if b == 0:
            return int(a)
        da, db = int(self.depth[a]), int(self.depth[b])
        while da > db:
            a = int(self.parent[a])
            da -= 1
        while db > da:
            b = int(self.parent[b])
            db -= 1
        while a != b:
            a = int(self.parent[a])
            b = int(self.parent[b])
        return int(a)

    def lca_many(self, taxa) -> int:
        out = 0
        for t in taxa:
            out = self.lca(out, int(t))
        return out

    def lca_pairs_np(self, u, v) -> np.ndarray:
        """Vectorized pairwise LCA by binary lifting (SEMANTICS.md §6); 0
        acts as identity. Used by the index builder to LCA-fold duplicate
        k-mer groups."""
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        up = self._lifting_cached()
        levels = up.shape[0]
        zu = u == 0
        zv = v == 0
        uu = np.where(zu, 1, u)
        vv = np.where(zv, 1, v)
        du = self.depth[uu].astype(np.int64)
        dv = self.depth[vv].astype(np.int64)
        swap = dv > du
        a = np.where(swap, vv, uu)      # a is the deeper node
        b = np.where(swap, uu, vv)
        diff = np.abs(du - dv)
        for l in range(levels - 1, -1, -1):
            lift = ((diff >> l) & 1) == 1
            a = np.where(lift, up[l][a], a)
        equal = a == b
        for l in range(levels - 1, -1, -1):
            move = (~equal) & (up[l][a] != up[l][b])
            a = np.where(move, up[l][a], a)
            b = np.where(move, up[l][b], b)
        res = np.where(equal, a, self.parent[a])
        res = np.where(zu & zv, 0, np.where(zu, v, np.where(zv, u, res)))
        return res.astype(np.int32)

    def lca_segments(self, taxa: np.ndarray, starts: np.ndarray,
                     ends: np.ndarray) -> np.ndarray:
        """LCA of each segment taxa[starts[i]:ends[i]]. Requires every
        segment's taxa to be sorted by Euler ``tin``: LCA(set) = LCA(min-tin
        member, max-tin member)."""
        return self.lca_pairs_np(taxa[starts], taxa[ends - 1])

    def _lifting_cached(self) -> np.ndarray:
        up = getattr(self, "_up_cache", None)
        if up is None:
            up = self.lifting_table()
            self._up_cache = up
        return up

    def ancestors(self, t: int) -> list[int]:
        """Root→t path, inclusive."""
        path = []
        while True:
            path.append(t)
            if t == 1:
                break
            t = int(self.parent[t])
        return path[::-1]

    def rank_name(self, t: int) -> str:
        return RANK_NAMES[int(self.rank[t])]

    def name(self, t: int) -> str:
        return self.names[t]

    @classmethod
    def from_tables(cls, parent, rank, names) -> "Taxonomy":
        return cls(parent=parent, rank=rank, names=list(names))

    # ------------------------------------------------------------- loaders
    @classmethod
    def load_tsv(cls, path: str) -> "Taxonomy":
        """4-column TSV: taxid, parent_taxid, rank, name. Ids must be dense
        1..T with id 1 the root. Lines starting with '#' skipped."""
        rows: dict[int, tuple[int, str, str]] = {}
        with open(path, "rt") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                tid, par, rk, name = line.split("\t")[:4]
                rows[int(tid)] = (int(par), rk, name)
        T = max(rows)
        if set(rows) != set(range(1, T + 1)):
            raise ValueError(f"{path}: taxon ids must be dense 1..{T}")
        parent = np.zeros(T + 1, dtype=np.int32)
        rank = np.zeros(T + 1, dtype=np.int8)
        names = ["unclassified"] + [""] * T
        for t in range(1, T + 1):
            par, rk, name = rows[t]
            parent[t] = par
            rk = _RANK_ALIASES.get(rk, rk)
            rank[t] = RANK_CODES.get(rk, RANK_CODES["no_rank"])
            names[t] = name
        return cls(parent=parent, rank=rank, names=names)

    @classmethod
    def load_ncbi(cls, nodes_dmp: str, names_dmp: str) -> "Taxonomy":
        """NCBI taxdump loader. Raw NCBI taxids are sparse; they are remapped
        to dense ids preserving ascending raw-id order (so dense-id DFS child
        order == raw-id order). The raw↔dense map is kept in ``.raw_ids`` /
        ``.raw_to_dense``."""
        raw_parent: dict[int, int] = {}
        raw_rank: dict[int, str] = {}
        with open(nodes_dmp, "rt") as fh:
            for line in fh:
                parts = [p.strip() for p in line.split("|")]
                tid, par, rk = int(parts[0]), int(parts[1]), parts[2]
                raw_parent[tid] = par
                raw_rank[tid] = rk
        raw_names: dict[int, str] = {}
        with open(names_dmp, "rt") as fh:
            for line in fh:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) >= 4 and parts[3] == "scientific name":
                    raw_names[int(parts[0])] = parts[1]
        raw_ids = sorted(raw_parent)
        if not raw_ids:
            raise ValueError(f"{nodes_dmp}: empty nodes.dmp")
        if raw_parent.get(1) != 1:
            raise ValueError(
                f"{nodes_dmp}: NCBI taxdump must contain root taxid 1 "
                f"with parent 1 (got parent {raw_parent.get(1)!r})")
        raw_to_dense = {r: i + 1 for i, r in enumerate(raw_ids)}
        T = len(raw_ids)
        parent = np.zeros(T + 1, dtype=np.int32)
        rank = np.zeros(T + 1, dtype=np.int8)
        names = ["unclassified"] + [""] * T
        for r in raw_ids:
            d = raw_to_dense[r]
            parent[d] = raw_to_dense[raw_parent[r]]
            rk = _RANK_ALIASES.get(raw_rank[r], raw_rank[r])
            rank[d] = RANK_CODES.get(rk, RANK_CODES["no_rank"])
            names[d] = raw_names.get(r, f"taxid_{r}")
        tax = cls(parent=parent, rank=rank, names=names)
        tax.raw_ids = np.array(raw_ids, dtype=np.int64)      # type: ignore[attr-defined]
        tax.raw_to_dense = raw_to_dense                      # type: ignore[attr-defined]
        return tax

    # --------------------------------------------------------------- save
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            parent=self.parent, rank=self.rank,
            names=np.array(self.names, dtype=object),
        )

    @classmethod
    def load(cls, path: str) -> "Taxonomy":
        z = np.load(path, allow_pickle=True)
        return cls(parent=z["parent"], rank=z["rank"],
                   names=[str(n) for n in z["names"]])

    def lifting_table(self) -> np.ndarray:
        """Binary-lifting ancestor table: up[l][t] = 2^l-th ancestor of t
        (clamped at root), int32 [levels, T+1]."""
        max_depth = int(self.depth.max())
        levels = max(1, max_depth.bit_length())
        up = np.zeros((levels, self.parent.shape[0]), dtype=np.int32)
        up[0] = self.parent
        up[0, 0] = 0
        for l in range(1, levels):
            up[l] = up[l - 1][up[l - 1]]
        return up

    def device_arrays(self) -> dict:
        """Dense arrays the device scorer needs (numpy; the caller moves
        them to the device)."""
        return {
            "tin": self.tin.astype(np.int32),
            "tout": self.tout.astype(np.int32),
            "parent": self.parent.astype(np.int32),
            "depth": self.depth.astype(np.int32),
            "up": self.lifting_table(),
            # tin -> node id: the q8 scorer recovers winner node ids from
            # their tins at the [B] level.
            "tin2node": self._tin2node(),
        }

    def _tin2node(self) -> np.ndarray:
        inv = np.zeros(int(self.tin.max(initial=0)) + 2, dtype=np.int32)
        ids = np.arange(1, self.tin.shape[0], dtype=np.int32)
        inv[self.tin[1:]] = ids
        return inv

    def content_hash(self) -> str:
        """Stable hash binding indexes to the taxonomy they were built with."""
        h = hashlib.sha256()
        h.update(self.parent.tobytes())
        h.update(self.rank.tobytes())
        h.update("\x00".join(self.names).encode())
        return h.hexdigest()[:16]
