"""device_idle_pct: the share of the window, on the stream's own clock
from the event before the first launch to the event after the last, in
which no batch's work lay between its step's events."""


def read(run):
    w = run.window
    ms = [b.step_ms for b in w.batches if b.step_ms is not None]
    if not ms or not w.device_ms:
        return None
    return 100.0 * (1.0 - sum(ms) / w.device_ms)
