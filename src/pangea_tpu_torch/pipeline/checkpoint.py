"""The classify run's checkpoint manifest, for ``--resume``.

The port's copy of ``pangea_tpu/pipeline/checkpoint.py``, writing the same
JSON, so that a run either CLI started resumes under the other. After each
durably written batch (or group of batches) the manifest records, for each
input file (by its path as given), how many reads are done, and for each
assignment file its byte offset. A resumed run cuts the assignment files
back to those offsets (dropping the tail of a batch written after the
last record) and skips the recorded reads; the outputs are deterministic,
so the resumed files equal an uninterrupted run's byte for byte.
"""
from __future__ import annotations

import json
import os
import tempfile


class Manifest:
    def __init__(self, path: str):
        self.path = path
        self.state: dict = {"files": {}, "outputs": {}}

    @classmethod
    def load_or_new(cls, path: str, resume: bool) -> "Manifest":
        m = cls(path)
        if resume and os.path.exists(path):
            with open(path) as fh:
                m.state = json.load(fh)
        return m

    def reads_done(self, input_key: str) -> int:
        return self.state["files"].get(input_key, 0)

    def record_batch(self, input_key: str, n_reads: int,
                     output_offsets: dict[str, int]) -> None:
        self.state["files"][input_key] = \
            self.state["files"].get(input_key, 0) + n_reads
        self.state["outputs"].update(output_offsets)
        self._write()

    def truncate_outputs(self) -> None:
        """On resume: cut the assignment files back to their durable
        offsets."""
        for path, off in self.state["outputs"].items():
            if os.path.exists(path):
                with open(path, "r+b") as fh:
                    fh.truncate(off)

    def _write(self) -> None:
        # A temporary file, fsync'd, then renamed over the manifest: a crash
        # leaves the old manifest or the new one, never a torn one.
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".manifest.")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(self.state, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
