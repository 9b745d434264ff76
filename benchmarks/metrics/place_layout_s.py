"""place_layout_s: host seconds of the port's ``place.layout`` spans
(``pangea_tpu_torch/trace.py`` ``Placement``: the index laid out as the
device table, its stash and the taxonomy's arrays on the host, page faults
of the mapped index included), over the run's placements on a card. None
where the program keeps no placement record or placed nothing on a
card."""


def read(run):
    try:
        from pangea_tpu_torch.trace import placements
    except ImportError:
        return None
    secs = [p["place.layout"] for p in placements() if p["device"] == "cuda"]
    return sum(secs) if secs else None
