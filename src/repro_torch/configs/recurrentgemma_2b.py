"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1) d_ff=7680
vocab=256000.  RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; hf]

26 % 3 != 0, so the reference stacks a 13-layer pattern block (2 x 13 =
26): ((rec,rec,local) x 4, rec) repeated twice.  Same composition as the
published arch (8 local-attention + 18 recurrent layers); attention
positions in the second half shift by one against the strict 1:2
interleave.  The port keeps the reference's pattern, so weights carry
across layer for layer.  The tiny config's 5 layers over a pattern of 3
do not stack: the reference keeps them unstacked (``layers``).
"""
from repro_torch.models.base import LOCAL, REC, ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    rope_theta=10000.0,
    window=2048,
    pattern=(REC, REC, LOCAL) * 4 + (REC,),
    mlp_act="gelu",
    lru_width=2560,
    conv_width=4,
    embed_scale=True,
    tie_embeddings=True,
    pad_heads_to=16,   # 10 q-heads -> 16 for even tp=16 sharding (masked pad)
)

TINY = ModelConfig(
    name="recurrentgemma-2b-tiny",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    window=8,
    pattern=(REC, REC, LOCAL),
    mlp_act="gelu",
    lru_width=64,
    embed_scale=True,
    tie_embeddings=True,
)

register("recurrentgemma-2b", CONFIG, TINY)
