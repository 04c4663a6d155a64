"""SDC detection the port carries so far: the loss sentinel (tier 3 of
training) and the decode sentinel (tier 3 of serving).  The scrubber and
ABFT tiers wait for their slices."""
from repro_torch.sdc.decode_sentinel import DecodeSentinel
from repro_torch.sdc.sentinel import LossSentinel

__all__ = ["DecodeSentinel", "LossSentinel"]
