"""place_copy_s: host seconds of the port's ``place.copy`` spans
(``pangea_tpu_torch/trace.py`` ``Placement``: the laid-out tables copied
to the card, up to a synchronize), over the run's placements on a card.
None where the program keeps no placement record or placed nothing on a
card."""


def read(run):
    try:
        from pangea_tpu_torch.trace import placements
    except ImportError:
        return None
    secs = [p["place.copy"] for p in placements() if p["device"] == "cuda"]
    return sum(secs) if secs else None
