"""Architecture configs.  Importing this package registers every
architecture the reference registers, under the same names."""
from repro_torch.configs import (  # noqa: F401
    falcon_mamba_7b,
    gemma2_27b,
    gemma_7b,
    granite_3_8b,
    hubert_xlarge,
    mixtral_8x7b,
    phi35_moe,
    qwen15_110b,
    qwen2_vl_2b,
    recurrentgemma_2b,
)

ALL_ARCHS = (
    "qwen2-vl-2b",
    "granite-3-8b",
    "qwen1.5-110b",
    "gemma-7b",
    "gemma2-27b",
    "mixtral-8x7b",
    "phi3.5-moe-42b-a6.6b",
    "falcon-mamba-7b",
    "recurrentgemma-2b",
    "hubert-xlarge",
)
