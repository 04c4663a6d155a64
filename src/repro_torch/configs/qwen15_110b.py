"""qwen1.5-110b [dense] — 80L d=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
QKV bias.  [hf:Qwen/Qwen1.5 family; hf]"""
from repro_torch.models.base import FULL, ModelConfig, register

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    pattern=(FULL,),
    mlp_act="silu",
    tie_embeddings=False,
    seq_shard=True,
)

TINY = ModelConfig(
    name="qwen1.5-110b-tiny",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    pattern=(FULL,),
    tie_embeddings=False,
)

register("qwen1.5-110b", CONFIG, TINY)
