"""Plain PyTorch version of the flash-attention kernel: the reference
engine's off-TPU path, ``mha_einsum`` (exact softmax attention with the
same causal / window / softcap / GQA semantics).

Note: ``mha_einsum`` scales q in the compute dtype, where the kernel (like
the TPU kernel) scales in fp32; in bf16 the difference is inside the
2e-2 tolerance the tests state."""
from __future__ import annotations

from repro_torch.layers.attention import mha_einsum

flash_attention_ref = mha_einsum

__all__ = ["flash_attention_ref"]
