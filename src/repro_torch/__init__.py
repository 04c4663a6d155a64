"""repro_torch — the PyTorch + CUDA port of the dependability library.

The JAX package (``repro``) is the reference this package is held
against; nothing here imports ``jax`` or ``repro``.  Host-side logic the
port needs is carried as its own adapted copy.

Slice 1 is the dependable serving path: ``serve.ServeEngine`` over a
block-paged KV cache with replica failover, serving the dense decoder
(``models.transformer``) through three hand-written Hopper kernels
(``kernels.rmsnorm``, ``kernels.flash_attention``,
``kernels.paged_attention``; CUDA sources under ``csrc/``).  Slice 2 is
the dependable training loop: the ``core.Dependability`` facade,
``core.run_with_recovery`` and the checkpoint manager (the reference's
on-disk format, with the int8 codec on the card, ``kernels.ckpt_codec``)
around ``train.make_train_step``, whose RMSNorm and attention run the
slice-1 kernels with hand-written backward passes.

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``); on the CPU every kernel wrapper takes its
plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
