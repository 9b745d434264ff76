"""enqueue_ms: host milliseconds inside the call to the step, which
returns before the card is done, a batch, over the window's batches."""


def read(run):
    b = run.window.batches
    return sum(x.t_enq for x in b) / len(b) * 1e3 if b else None
