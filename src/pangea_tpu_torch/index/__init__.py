from .quot import fuse_stash, q8_gate, q8_layout, q8_nb_for, relayout_q8

__all__ = ["fuse_stash", "q8_gate", "q8_layout", "q8_nb_for", "relayout_q8"]
