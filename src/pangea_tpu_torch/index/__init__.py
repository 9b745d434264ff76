"""The index: container, builder, layout policy and device relayouts."""
import json
import os

from .build import build_index, pick_layout
from .container import EMPTY_HI, Index, IndexMeta
from .quot import (extract_pairs, q8_nb_for, relayout_q8, relayout_q12,
                   relayout_std)


def load_index_any(path: str, mmap: bool = True) -> Index:
    """Load an index directory (the reference's ``load_index_any``). A
    sharded directory, which the reference's out-of-core builder writes,
    raises NotImplementedError: the port places one table on one device."""
    with open(os.path.join(path, "meta.json")) as fh:
        sharded = json.load(fh).get("sharded", False)
    if sharded:
        raise NotImplementedError(
            f"{path} is a sharded index: sharded placement is not ported "
            "yet (ROADMAP A6)")
    return Index.load(path, mmap=mmap)


__all__ = ["EMPTY_HI", "Index", "IndexMeta", "build_index", "extract_pairs",
           "load_index_any", "pick_layout", "q8_nb_for", "relayout_q8",
           "relayout_q12", "relayout_std"]
