"""reads_per_s: reads (a pair counts once) whose assignments reached the
host within the window, over the window's seconds."""


def read(run):
    w = run.window
    done = sum(b.n_reads for b in w.batches
               if b.t_done is not None and b.t_done <= w.t_close)
    return done / run.seconds if done else None
