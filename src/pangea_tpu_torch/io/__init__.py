from .fastx import ReadBatch, read_batches

__all__ = ["ReadBatch", "read_batches"]
