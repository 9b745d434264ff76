"""step_roofline_pct: the step's least time (``harness/roofline.py``:
bytes over the card's bandwidth, or operations over its integer rate if
larger) over its time between events, in percent."""


def read(run):
    ms = [b.step_ms for b in run.window.batches if b.step_ms is not None]
    if not ms or run.least_ms is None:
        return None
    return 100.0 * run.least_ms / (sum(ms) / len(ms))
