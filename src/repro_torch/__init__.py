"""repro_torch — the PyTorch + CUDA port of the dependability library.

The JAX package (``repro``) is the reference this package is held
against; nothing here imports ``jax`` or ``repro``.  Host-side logic the
port needs is carried as its own adapted copy.

Slice 1 is the dependable serving path: ``serve.ServeEngine`` over a
block-paged KV cache with replica failover, serving the dense decoder
(``models.transformer``) through three hand-written Hopper kernels
(``kernels.rmsnorm``, ``kernels.flash_attention``,
``kernels.paged_attention``; CUDA sources under ``csrc/``).

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``); on the CPU every kernel wrapper takes its
plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
