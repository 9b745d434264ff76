"""setup_s: process start to the first timed launch (imports, the kernel
library, the index's load or build, layout and placement, the read pool,
the warm-up)."""


def read(run):
    return run.setup_s
