"""batch_p95_ms: the 95th percentile (nearest rank) over every batch
completed within the window of the time from its launch to its
assignments on the host."""
import math


def read(run):
    w = run.window
    lat = sorted(b.t_done - b.t_disp for b in w.batches
                 if b.t_done is not None and b.t_done <= w.t_close)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
