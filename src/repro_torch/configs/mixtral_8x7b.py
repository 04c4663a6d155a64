"""mixtral-8x7b [moe] — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from repro_torch.models.base import LOCAL, ModelConfig, register

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e6,
    window=4096,
    pattern=(LOCAL,),
    mlp_act="silu",
    num_experts=8,
    experts_per_token=2,
    tie_embeddings=False,
    seq_shard=True,
)

TINY = ModelConfig(
    name="mixtral-8x7b-tiny",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    window=8,
    pattern=(LOCAL,),
    num_experts=4,
    experts_per_token=2,
    tie_embeddings=False,
)

register("mixtral-8x7b", CONFIG, TINY)
