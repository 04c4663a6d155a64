"""qwen2-vl-2b [vlm] — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]
Backbone only: the vision frontend is a stub — inputs are precomputed patch
embeddings plus (3, B, S) M-RoPE position ids."""
from repro_torch.models.base import FULL, ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    pattern=(FULL,),
    mlp_act="silu",
    embedding_inputs=True,
    tie_embeddings=False,
    pad_heads_to=16,   # 12 q-heads -> 16 for even tp=16 sharding (masked pad)
)

TINY = ModelConfig(
    name="qwen2-vl-2b-tiny",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    mrope_sections=(2, 3, 3),
    pattern=(FULL,),
    embedding_inputs=True,
    tie_embeddings=False,
)

register("qwen2-vl-2b", CONFIG, TINY)
