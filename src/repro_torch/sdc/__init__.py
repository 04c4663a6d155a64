"""SDC detection: the rotating state scrubber (tier 2, over the block
hash), the loss sentinel (tier 3 of training) and the decode sentinel
(tier 3 of serving).  Tier 1, the ABFT projection matmuls, is opted into
per model with ``impl="abft"`` (``kernels/abft_matmul``)."""
from repro_torch.sdc.checksum import checksums, leaf_checksum, named_leaves
from repro_torch.sdc.decode_sentinel import DecodeSentinel
from repro_torch.sdc.scrubber import StateScrubber
from repro_torch.sdc.sentinel import LossSentinel

__all__ = ["DecodeSentinel", "LossSentinel", "StateScrubber", "checksums",
           "leaf_checksum", "named_leaves"]
