"""gemma-7b [dense] — 28L d=3072 16H (kv=16) d_ff=24576 vocab=256000.
GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
from repro_torch.models.base import FULL, ModelConfig, register

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    rope_theta=10000.0,
    pattern=(FULL,),
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)

TINY = ModelConfig(
    name="gemma-7b-tiny",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    pattern=(FULL,),
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)

register("gemma-7b", CONFIG, TINY)
