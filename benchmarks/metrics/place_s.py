"""place_s: host seconds to load the index, lay it out and place it on
the card (``load_index_any``, ``place_index``, ``MeshStep``)."""


def read(run):
    return run.place_s
