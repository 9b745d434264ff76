from .demux import UNDETERMINED, DemuxConfig, demux_batch
from .fastx import ReadBatch, read_batches, sniff_format
from .trim import TrimConfig, trim_batch

__all__ = ["UNDETERMINED", "DemuxConfig", "ReadBatch", "TrimConfig",
           "demux_batch", "read_batches", "sniff_format", "trim_batch"]
