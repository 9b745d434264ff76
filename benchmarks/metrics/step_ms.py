"""step_ms: device milliseconds between the CUDA events recorded on the
stream before and after each batch's step, a batch, over the window's
batches (None without events)."""


def read(run):
    ms = [b.step_ms for b in run.window.batches if b.step_ms is not None]
    return sum(ms) / len(ms) if ms else None
