"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel
it replaces:

  <name>/kernel.py — host wrapper of the CUDA kernel in ``csrc/`` (checks,
                     output allocation, launch, ``launches`` counter)
  <name>/ops.py    — public entry: the plain PyTorch version for a CPU
                     tensor, the kernel for a CUDA tensor (or it raises)
  <name>/ref.py    — the plain PyTorch version, held against the JAX
                     package on the CPU and against the kernel on the card

Kernels on the serving path (slice 1): rmsnorm, flash_attention,
paged_attention.  On the training path (slice 2): rmsnorm and
flash_attention with their backward kernels (run as autograd Functions
when a gradient is needed), and ckpt_codec (int8 checkpoint quantize and
dequantize).  On the SDC-protected training path (slice 3): block_hash
(scrub checksums and delta dirty blocks, every leaf in one launch) and
abft_matmul (checksum-extended float32 matmul, SDC tier 1).  On the
Mamba serving path (slice 4): selective_scan (the prefill scan) and
rmsnorm.  ``build`` compiles and loads the CUDA sources.
"""
