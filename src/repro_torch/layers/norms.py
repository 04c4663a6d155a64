"""Normalization layers: RMSNorm (standard convention, weights init to
one) runs the CUDA kernel on the card and its plain version on the CPU
(``kernels/rmsnorm``)."""
from repro_torch.kernels.rmsnorm.ops import rms_norm

__all__ = ["rms_norm"]
