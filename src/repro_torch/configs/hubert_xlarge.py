"""hubert-xlarge [audio] — 48L d=1280 16H d_ff=5120 vocab=504 (cluster
codebook).  Encoder-only bidirectional transformer (w2v2 arch).
[arXiv:2106.07447]

Backbone only: the waveform conv frontend is a stub — inputs are precomputed
frame embeddings (B, S, d_model).  Plain-GELU (non-gated) FFN.  No decode.
"""
from repro_torch.models.base import BIDIR, ModelConfig, register

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pattern=(BIDIR,),
    mlp_act="gelu_plain",
    embedding_inputs=True,
    tie_embeddings=False,
)

TINY = ModelConfig(
    name="hubert-xlarge-tiny",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    pattern=(BIDIR,),
    mlp_act="gelu_plain",
    embedding_inputs=True,
    tie_embeddings=False,
)

register("hubert-xlarge", CONFIG, TINY)
