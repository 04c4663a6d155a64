"""gemma2-27b [dense] — 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local+global alternating attention, logit softcaps, sandwich norms.
[arXiv:2408.00118; hf]"""
from repro_torch.models.base import FULL, LOCAL, ModelConfig, register

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    rope_theta=10000.0,
    window=4096,
    pattern=(LOCAL, FULL),
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    mlp_act="gelu",
    embed_scale=True,
    sandwich_norm=True,
    tie_embeddings=True,
)

TINY = ModelConfig(
    name="gemma2-27b-tiny",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    window=8,
    pattern=(LOCAL, FULL),
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu",
    embed_scale=True,
    sandwich_norm=True,
    tie_embeddings=True,
)

register("gemma2-27b", CONFIG, TINY)
