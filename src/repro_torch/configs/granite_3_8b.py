"""granite-3-8b [dense] — 40L d=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base scaled family; hf]"""
from repro_torch.models.base import FULL, ModelConfig, register

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
    pattern=(FULL,),
    mlp_act="silu",
    tie_embeddings=True,
    seq_shard=True,
)

TINY = ModelConfig(
    name="granite-3-8b-tiny",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=(FULL,),
    tie_embeddings=True,
)

register("granite-3-8b", CONFIG, TINY)
