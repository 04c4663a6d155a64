"""falcon-mamba-7b [ssm] — 64L d=4096 (attention-free) vocab=65024,
ssm_state=16, Mamba-1 architecture.  [arXiv:2410.05355]"""
from repro_torch.models.base import SSM, ModelConfig, register

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    pattern=(SSM,),
    ssm_state=16,
    conv_width=4,
    expand=2,
    tie_embeddings=True,
    seq_shard=True,
)

TINY = ModelConfig(
    name="falcon-mamba-7b-tiny",
    family="ssm",
    num_layers=2,
    d_model=64,
    d_ff=0,
    vocab_size=256,
    pattern=(SSM,),
    ssm_state=4,
    conv_width=4,
    expand=2,
    tie_embeddings=True,
)

register("falcon-mamba-7b", CONFIG, TINY)
