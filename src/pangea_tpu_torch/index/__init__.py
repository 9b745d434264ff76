"""The index: containers, builders, layout policy and device relayouts."""
import json
import os

from .build import build_index, pick_layout
from .build_ooc import build_index_ooc
from .container import EMPTY_HI, Index, IndexMeta
from .quot import q8_nb_for
from .shard import (extract_pairs, owner_of, relayout_q8, relayout_q12,
                    relayout_std, shard_tables, shard_tables_quot)
from .sharded import ShardedIndex, ShardedIndexMeta


def load_index_any(path: str, mmap: bool = True):
    """Load a monolithic or sharded index directory, told apart by its
    meta.json (the reference's ``load_index_any``)."""
    with open(os.path.join(path, "meta.json")) as fh:
        sharded = json.load(fh).get("sharded", False)
    return (ShardedIndex.load(path, mmap=mmap) if sharded
            else Index.load(path, mmap=mmap))


__all__ = ["EMPTY_HI", "Index", "IndexMeta", "ShardedIndex",
           "ShardedIndexMeta", "build_index", "build_index_ooc",
           "extract_pairs", "load_index_any", "owner_of", "pick_layout",
           "q8_nb_for", "relayout_q8", "relayout_q12", "relayout_std",
           "shard_tables", "shard_tables_quot"]
