"""Decode-path SDC detection (tier 3 for serving)."""
from repro_torch.sdc.decode_sentinel import DecodeSentinel

__all__ = ["DecodeSentinel"]
